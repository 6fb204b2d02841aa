"""Batched HTTP inference server on the GPU.

Port of ``psla_tpu/tools/serve.py``. It serves trained checkpoints over HTTP
with cross-request micro-batching, so concurrent clients share each
device dispatch, and the chunked pooling-exact long-audio path for clips
longer than the model window:

    python -m psla_tpu_torch.tools.serve --ckpt model.pth \\
        [--ckpt model2.pth ...] [--label-csv ...] [--device cuda] \\
        [--port 8000] [--batch-size 16] [--batch-window-ms 5]

Repeating ``--ckpt`` serves a model ENSEMBLE: the members share one fbank
per micro-batch and the response is the mean of their probabilities (the
reference's ensemble protocol, src/ensemble/ensemble.py:52-68).
``--num-devices N`` replicates the members on ``cuda:0..N-1`` and splits
each micro-batch into N contiguous shards, one a card (the JAX package's
micro-batch sharded over a ('data',) mesh).

API:
  * ``GET  /healthz``  -> {"status": "ok", model info}
  * ``GET  /stats``    -> request/batch counters (mean occupancy etc.)
  * ``POST /predict``  -> top-k labels. Body is a WAV file
    (``Content-Type: audio/wav``) or JSON ``{"wav": [float...],
    "sample_rate": 16000}``. Query ``?top_k=N`` bounds the list.

Threads: a clip that fits the model window is queued for the batcher
thread, which drains up to ``batch_size`` queued clips per dispatch
(waiting at most ``batch_window_ms`` for stragglers). A longer clip runs
its chunked pass in its own handler thread, outside the hot batch, so short
requests never queue behind it. Both threads launch on the device's default
stream, which orders their kernels; inference needs no lock.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from contextlib import nullcontext

import numpy as np
import torch

from psla_tpu_torch.data.wav import decode_wav, resample
from psla_tpu_torch.inference import ensemble_probs, predict_long
from psla_tpu_torch.models.layers import for_inference

__all__ = ["InferenceEngine", "make_server", "build_parser", "engine_from_args",
           "main", "MAX_BODY_BYTES", "ServerShuttingDown"]

# largest accepted /predict body: comfortably holds an hour of PCM16 WAV
# (or ~20 min of float JSON) while bounding per-request allocation
MAX_BODY_BYTES = 128 << 20


class ServerShuttingDown(RuntimeError):
    """Raised for requests refused or abandoned because of shutdown; the
    HTTP layer maps it to 503 and every other failure to 500."""


class _Request:
    __slots__ = ("wav", "event", "probs", "error")

    def __init__(self, wav: np.ndarray):
        self.wav = wav
        self.event = threading.Event()
        self.probs: np.ndarray | None = None
        self.error: Exception | None = None


def replica_devices(num_devices: int | None, device: str | torch.device,
                    batch_size: int) -> list[torch.device]:
    """The devices of ``num_devices`` replicas: ``cuda:0..N-1`` on the card
    (``ValueError`` past the visible cards), N times the CPU for 'cpu'; one
    replica on ``device`` without N. ``batch_size`` must split evenly."""
    device = torch.device(device)
    if not num_devices or num_devices == 1:
        return [device]
    if batch_size % num_devices:
        raise ValueError(
            f"batch_size {batch_size} is not divisible by num_devices {num_devices}")
    if device.type == "cpu":
        return [device] * num_devices
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(f"requested num_devices={num_devices} but only {visible} "
                         f"devices are visible")
    return [torch.device("cuda", i) for i in range(num_devices)]


class InferenceEngine:
    """Model members on one device, or replicated on several, + the
    micro-batching queue that HTTP workers share.

    ``model`` is an ``nn.Module`` with its weights, or a list of them (an
    ensemble). The engine keeps its own serving copies
    (``models.layers.for_inference``: the weights held in the dtype each
    layer computes in, BatchNorm folded, the same bits as the model in eval
    mode) on ``device``, or on each of
    ``replica_devices(num_devices, device, batch_size)``.
    With several replicas a micro-batch is split into contiguous shards, one
    a replica. In float32 on the card it switches TF32 off for cuDNN and
    cuBLAS (process-wide, as ``train.state.create_train_state`` does), so
    the served probabilities match an offline float32 forward.
    """

    def __init__(self, model, config, names: dict, batch_size: int = 16,
                 batch_window_ms: float = 5.0,
                 device: str | torch.device = "cuda", num_devices: int | None = None):
        self.devices = replica_devices(num_devices, device, batch_size)
        self.device = self.devices[0]
        models = model if isinstance(model, (list, tuple)) else [model]
        self.replicas = [tuple(for_inference(m, d) for m in models) for d in self.devices]
        self.members = self.replicas[0]
        if self.device.type == "cuda" and self.members[0].dtype == torch.float32:
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.config = config
        self.names = names
        self.batch_size = int(batch_size)
        self.batch_window_s = float(batch_window_ms) / 1e3
        self.chunk_samples = config.fbank.buffer_length(config.target_length)
        self._queue: queue.Queue[_Request | None] = queue.Queue()
        self._stop = threading.Event()
        # counters are bumped from HTTP worker threads AND the batcher
        self._counter_lock = threading.Lock()
        self.counters = {
            "requests": 0, "batches": 0, "batched_rows": 0, "long_clips": 0,
        }
        # one dispatch at full batch before serving, so the first request
        # pays no cuDNN/cuBLAS set-up
        z = np.zeros((self.batch_size, self.chunk_samples), np.float32)
        self.batch_probs(z, np.zeros(self.batch_size, np.float32),
                         np.full(self.batch_size, self.chunk_samples, np.int32))
        self._thread = threading.Thread(target=self._batch_loop, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ public

    @torch.inference_mode()
    def batch_probs(self, wav: np.ndarray, wav_mean: np.ndarray,
                    lengths: np.ndarray) -> np.ndarray:
        """One dispatch: [b, chunk_samples] clips -> [b, n_class] mean of
        the members' probabilities. The fbank runs once for all members of
        a replica. With several replicas each takes a contiguous shard of
        the rows, and the results come back in row order."""
        return np.concatenate([o.cpu().numpy() for o in self.issue(wav, wav_mean, lengths)])

    def issue(self, wav: np.ndarray, wav_mean: np.ndarray,
              lengths: np.ndarray) -> list[torch.Tensor]:
        """The work of a dispatch queued on the devices, fetching nothing:
        each replica's shard's copy, fbank and forwards on its own device,
        one after another from this thread. Returns each replica's
        probabilities, on its device, in row order."""
        shards = np.array_split(np.arange(len(wav)), len(self.replicas))
        outs = []
        for members, device, rows in zip(self.replicas, self.devices, shards):
            if len(rows) == 0:
                continue
            lo, hi = rows[0], rows[-1] + 1
            to = dict(device=device, non_blocking=True)
            with torch.cuda.device(device) if device.type == "cuda" else nullcontext():
                outs.append(ensemble_probs(
                    members, torch.from_numpy(wav[lo:hi]).to(**to),
                    torch.from_numpy(wav_mean[lo:hi]).to(**to),
                    torch.from_numpy(lengths[lo:hi]).to(**to), self.config))
        return outs

    def _count(self, key: str, n: int = 1):
        with self._counter_lock:
            self.counters[key] += n

    def predict(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        """[n_samples] float waveform -> [n_class] probabilities."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        want = int(self.config.fbank.sample_frequency)
        if sample_rate != want:
            wav = resample(wav, sample_rate, want)
        self._count("requests")
        if wav.size > self.chunk_samples:
            # long clip: exact chunked aggregation per member in this
            # handler thread, then the ensemble mean
            self._count("long_clips")
            return np.mean(
                [predict_long(m, wav, self.config, device=self.device)
                 for m in self.members],
                axis=0,
            )
        if self._stop.is_set():
            raise ServerShuttingDown("server shutting down")
        req = _Request(wav)
        self._queue.put(req)
        # poll the stop flag so a shutdown can never strand this thread
        # on a request the batcher already exited without serving
        while not req.event.wait(timeout=1.0):
            if self._stop.is_set() and not req.event.is_set():
                raise ServerShuttingDown("server shutting down")
        if req.error is not None:
            raise req.error
        return req.probs

    def stats(self) -> dict:
        """Consistent counter snapshot + derived occupancy."""
        with self._counter_lock:
            c = dict(self.counters)
        c["mean_batch_occupancy"] = (
            c["batched_rows"] / c["batches"] if c["batches"] else 0.0
        )
        return c

    def top_k(self, probs: np.ndarray, k: int) -> list[dict]:
        order = np.argsort(probs)[::-1][:k]
        return [
            {"label": self.names.get(int(i), str(int(i))),
             "index": int(i), "prob": float(probs[i])}
            for i in order
        ]

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the batcher
        self._thread.join(timeout=30)
        # fail any requests still queued so their handler threads unblock
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = ServerShuttingDown("server shutting down")
                req.event.set()

    # ----------------------------------------------------------- batcher

    def _run_batch(self, batch: list[_Request]):
        try:
            n = len(batch)
            wav = np.zeros((n, self.chunk_samples), np.float32)
            mean = np.zeros((n,), np.float32)
            lengths = np.zeros((n,), np.int32)
            for i, r in enumerate(batch):
                wav[i, : r.wav.size] = r.wav
                # DC removal uses the clip mean (audioset_dataset.py:96-100)
                mean[i] = r.wav.mean() if r.wav.size else 0.0
                lengths[i] = max(int(r.wav.size), 1)
            probs = self.batch_probs(wav, mean, lengths)
            for i, r in enumerate(batch):
                r.probs = probs[i]
        except Exception as e:  # surface to every waiter, keep serving
            for r in batch:
                r.error = e
        finally:
            self._count("batches")
            self._count("batched_rows", len(batch))
            for r in batch:
                r.event.set()

    def _batch_loop(self):
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                continue
            batch = [item]
            deadline = time.monotonic() + self.batch_window_s
            while len(batch) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                batch.append(nxt)
            self._run_batch(batch)


def make_server(engine: InferenceEngine, port: int = 8000, host="127.0.0.1"):
    """ThreadingHTTPServer wired to the engine (caller runs serve_forever)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; /stats has the counters
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "n_class": len(engine.names),
                    "n_members": len(engine.members),
                    "batch_size": engine.batch_size,
                    "target_length": engine.config.target_length,
                    "device": str(engine.device),
                })
            elif path == "/stats":
                self._json(200, engine.stats())
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/predict":
                self._json(404, {"error": f"unknown path {path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._json(400, {"error": "malformed Content-Length"})
                return
            if n < 0:
                # rfile.read(-1) would block until client EOF
                self._json(400, {"error": "negative Content-Length"})
                return
            if n > MAX_BODY_BYTES:
                # refuse BEFORE reading: an oversized upload must not buy
                # an unbounded allocation
                self._json(413, {
                    "error": f"body of {n} bytes exceeds the "
                             f"{MAX_BODY_BYTES}-byte limit"
                })
                return
            body = self.rfile.read(n)
            # phase 1 -- parse the request: any failure is the CLIENT's (400)
            try:
                top_k = 10
                for part in query.split("&"):
                    if part.startswith("top_k="):
                        top_k = max(0, int(part.split("=", 1)[1]))
                ctype = self.headers.get("Content-Type", "")
                if "json" in ctype:
                    payload = json.loads(body)
                    wav = np.asarray(payload["wav"], np.float32)
                    sr = int(payload.get("sample_rate", 16000))
                else:
                    wav, sr = decode_wav(body)
                if sr <= 0:
                    raise ValueError(f"sample_rate must be positive, got {sr}")
            except Exception as e:
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
                return
            # phase 2 -- run the model: failures here are the SERVER's
            # (503 while shutting down, 500 for anything else)
            try:
                t0 = time.monotonic()
                probs = engine.predict(wav, sr)
                self._json(200, {
                    "top_k": engine.top_k(probs, top_k),
                    "duration_s": round(wav.size / sr, 3),
                    "latency_ms": round((time.monotonic() - t0) * 1e3, 2),
                })
            except ServerShuttingDown as e:
                self._json(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, action="append",
                   help=".pth/.pt state_dict (reference layout) or .npz of "
                        "JAX variables; repeat to serve the mean of an "
                        "ensemble (reference ensemble.py:52-68)")
    p.add_argument("--label-csv", default=None,
                   help="default: bundled vocabulary for --dataset")
    p.add_argument("--dataset", default="audioset",
                   choices=["audioset", "fsd50k"])
    p.add_argument("--model", default="efficientnet",
                   choices=["efficientnet", "resnet", "mbnet"])
    p.add_argument("--eff_b", type=int, default=2)
    p.add_argument("--att_head", type=int, default=4)
    p.add_argument("--target_length", type=int, default=1056)
    p.add_argument("--dataset_mean", type=float, default=-4.6476)
    p.add_argument("--dataset_std", type=float, default=4.5699)
    p.add_argument("--skip_norm", action="store_true",
                   help="serve with NO normalization (for models trained "
                        "with --skip_norm)")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--batch-window-ms", type=float, default=5.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:1, cpu)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="replicate the members on cuda:0..N-1 and split each "
                        "micro-batch into N shards, one a card; default: one device")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16"],
                   help="compute dtype of the forward (the served copies hold each "
                        "weight in it, cast once; use float32 for parity with "
                        "offline eval)")
    return p


def engine_from_args(args) -> InferenceEngine:
    from psla_tpu_torch import assets
    from psla_tpu_torch.data.datafiles import make_name_dict
    from psla_tpu_torch.frontend.fbank import FbankConfig
    from psla_tpu_torch.frontend.pipeline import PreprocessConfig
    from psla_tpu_torch.models import create_model
    from psla_tpu_torch.models.convert import load_variables

    names = make_name_dict(args.label_csv or assets.label_csv_for(args.dataset))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    members = []
    for ckpt in args.ckpt:
        model = create_model(args.model, label_dim=len(names), eff_b=args.eff_b,
                             head_num=args.att_head, dtype=dtype)
        model.load_state_dict(load_variables(ckpt))
        members.append(model)
    config = PreprocessConfig(
        fbank=FbankConfig(sample_frequency=float(args.sample_rate)),
        target_length=args.target_length,
        norm_mean=args.dataset_mean,
        norm_std=args.dataset_std,
        skip_norm=args.skip_norm,
    )
    return InferenceEngine(
        members, config, names, batch_size=args.batch_size,
        batch_window_ms=args.batch_window_ms, device=args.device,
        num_devices=args.num_devices,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    engine = engine_from_args(args)
    server = make_server(engine, port=args.port, host=args.host)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"({', '.join(map(str, engine.devices))}, batch_size={engine.batch_size}, "
          f"window={args.batch_window_ms}ms)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
