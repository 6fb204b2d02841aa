"""Host input pipeline: WAV decode -> fixed-shape batches of raw waveforms
(port of ``psla_tpu/data/loader.py``; single host here, ``host_id`` and
``num_hosts`` keep their meaning for data parallelism).

The reference does ALL preprocessing (fbank, mixup, SpecAugment, norm) in
CPU DataLoader worker processes (src/dataloaders/audioset_dataset.py,
src/run.py:87-103). Here the host only decodes WAVs into zero-padded raw
waveform buffers; the card does the math (``frontend/pipeline.py``, the
fbank kernel), and ``data/device_prefetch.py`` moves the batches there.

Mixup partner semantics: the reference draws the partner uniformly over the
WHOLE dataset inside __getitem__ (audioset_dataset.py:153). The same here:
the loader draws a uniform partner index per primary sample and decodes the
partner waveform alongside, so the on-card Beta(10,10) mixing sees the
same partner distribution.

Several hosts: each constructs its loader with (host_id, num_hosts); a
weighted sampler shard draws from the full distribution with a host-unique
seed (iid with replacement, so hosts need no coordination); a uniform
(bal=False) shard partitions ONE global permutation by host stride
(DistributedSampler semantics); a sequential (eval) shard takes a strided
slice of the dataset.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from psla_tpu_torch.data import native
from psla_tpu_torch.data.datafiles import Datafile
from psla_tpu_torch.data.sampler import UniformSampler, WeightedSampler
from psla_tpu_torch.data.wav import read_wav


@dataclasses.dataclass
class LoaderConfig:
    batch_size: int = 32
    buffer_samples: int = 169_200  # wav_buffer_length(target 1056 @ 16 kHz)
    num_workers: int = 8
    seed: int = 0
    mixup: bool = False  # decode uniform partner waveforms too
    drop_remainder: bool = True  # False pads the final batch (eval)
    host_id: int = 0
    num_hosts: int = 1
    prefetch: int = 2
    # Waveform wire dtype shipped to the card: 'float32' (decoded samples
    # as-is) or 'int16' (raw PCM wire, dequantized on the card by
    # train/step._wav_batch at x * 2^-15: bit-exact for PCM16 sources and
    # half the host->card bytes; see ExperimentConfig.wire).
    wire: str = "float32"


def quantize_pcm16(wav: np.ndarray) -> np.ndarray:
    """float32 [-1, 1) samples -> int16 wire format.

    Exact round trip for PCM16-sourced samples: decode yields i / 32768
    (data/wav.py), so * 32768 recovers the integer i exactly and the
    on-card x * 2^-15 dequantize reproduces the identical float32 bits.
    Other sources round to the nearest 1/32768 step."""
    return np.clip(
        np.rint(wav * 32768.0), -32768, 32767
    ).astype(np.int16)


def _decode(path: str, buffer_samples: int):
    """Decode one clip -> (buffer [buffer_samples], full-clip mean, length)."""
    wav, _sr = read_wav(path)
    mean = np.float32(wav.mean()) if wav.size else np.float32(0.0)
    n = min(wav.size, buffer_samples)
    buf = np.zeros(buffer_samples, dtype=np.float32)
    buf[:n] = wav[:n]
    return buf, mean, np.int32(n)


class AudioLoader:
    """Iterable over host batches of raw waveforms + labels.

    Each batch is a dict of numpy arrays with the field names of
    frontend.pipeline.WavBatch, plus 'n_valid' (== batch_size except for a
    padded final eval batch).
    """

    def __init__(
        self,
        datafile: Datafile,
        config: LoaderConfig,
        weights: np.ndarray | None = None,
        shuffle: bool = True,
    ):
        self.datafile = datafile
        self.config = config
        if config.wire not in ("float32", "int16"):
            raise ValueError(
                f"unknown wire format {config.wire!r} "
                "(expected 'float32' or 'int16')"
            )
        self._labels = datafile.label_matrix()
        seed = config.seed * 1009 + config.host_id
        if weights is not None:
            # with-replacement draws are iid: a host-unique seed sampling
            # the full distribution is exactly DistributedSampler-correct
            self._sampler = WeightedSampler(weights, seed=seed)
            self._sequential = False
        elif shuffle:
            # without replacement the hosts must PARTITION one global
            # permutation (same seed everywhere, host-strided slice) or
            # they would overlap on ~25% of samples and skip others
            self._sampler = UniformSampler(
                len(datafile), seed=config.seed * 1009,
                host_id=config.host_id, num_hosts=config.num_hosts,
            )
            self._sequential = False
        else:
            self._sampler = None
            self._sequential = True
        self._seed = seed
        self._mix_rng = np.random.default_rng(seed + 7919)
        self._epoch: int | None = None
        self._pool = ThreadPoolExecutor(max_workers=config.num_workers)
        self._native = native.available()

    def set_epoch(self, epoch: int):
        """Pin the next iteration's sampling + mixup-partner draws to a
        pure function of (seed, epoch) (torch DistributedSampler-style),
        so a resumed run reproduces the original epoch's batches exactly."""
        self._epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.datafile)
        if self._sequential:
            # strided host shard keeps eval deterministic across hosts
            return np.arange(self.config.host_id, n, self.config.num_hosts)
        # samplers draw a full local epoch; for multi-host training each
        # host draws len/num_hosts samples from the full distribution
        per_host = n // self.config.num_hosts if self.config.num_hosts > 1 else n
        return self._sampler.epoch(per_host, epoch=self._epoch)

    def batches_per_epoch(self) -> int:
        n = self._shard_rows()
        bs = self.config.batch_size
        return n // bs if self.config.drop_remainder else -(-n // bs)

    def _shard_rows(self) -> int:
        """Per-host row count used for batch-count math. Sequential
        multi-host shards use ceil(n / num_hosts) on EVERY host — equal
        batch counts are required because multi-host validate issues
        collectives per batch (hosts with fewer rows emit all-padding
        n_valid=0 batches instead of exiting the loop early, which would
        deadlock the pod)."""
        cfg = self.config
        n = len(self.datafile)
        if self._sequential:
            return -(-n // cfg.num_hosts) if cfg.num_hosts > 1 else n
        return n // cfg.num_hosts if cfg.num_hosts > 1 else n

    def _decode_paths(self, paths: list[str]):
        """Batch decode: native C++ thread pool (one GIL-free ctypes call)
        when available, numpy decode on the Python thread pool otherwise."""
        cfg = self.config
        if self._native:
            # the C++ decoder emits the wire dtype directly: int16 rows
            # for PCM16 sources are a straight copy (no float pass at all)
            return native.decode_batch(
                paths, cfg.buffer_samples, n_threads=cfg.num_workers,
                wire=cfg.wire,
            )
        decoded = list(
            self._pool.map(lambda p: _decode(p, cfg.buffer_samples), paths)
        )
        wav = np.stack([d[0] for d in decoded])
        mean = np.array([d[1] for d in decoded], np.float32)
        length = np.array([d[2] for d in decoded], np.int32)
        if cfg.wire == "int16":
            wav = quantize_pcm16(wav)
        return wav, mean, length

    def _build_batch(self, idxs: np.ndarray, n_valid: int) -> dict:
        cfg = self.config
        bs = len(idxs)
        paths = [self.datafile.wav_path(i) for i in idxs]
        if cfg.mixup:
            # primaries + mixup partners decode as ONE combined batch
            # call so the native thread pool is dispatched once per batch
            mix_idxs = self._mix_rng.integers(0, len(self.datafile), size=bs)
            wav, mean, length = self._decode_paths(
                paths + [self.datafile.wav_path(i) for i in mix_idxs]
            )
            return {
                "wav": wav[:bs],
                "wav_mean": mean[:bs],
                "length": length[:bs],
                "labels": self._labels[idxs],
                "n_valid": np.int32(n_valid),
                "mix_wav": wav[bs:],
                "mix_wav_mean": mean[bs:],
                "mix_length": length[bs:],
                "mix_labels": self._labels[mix_idxs],
            }
        wav, mean, length = self._decode_paths(paths)
        return {
            "wav": wav,
            "wav_mean": mean,
            "length": length,
            "labels": self._labels[idxs],
            "n_valid": np.int32(n_valid),
            "mix_wav": wav,
            "mix_wav_mean": mean,
            "mix_length": length,
            "mix_labels": self._labels[idxs],
        }

    def __iter__(self):
        cfg = self.config
        if self._epoch is not None:
            # mixup partners become a pure function of (seed, epoch) too
            self._mix_rng = np.random.default_rng(
                (self._seed + 7919, self._epoch)
            )
        idxs = self._epoch_indices()
        bs = cfg.batch_size
        # batch count comes from the host-uniform shard size, not the local
        # index count (see _shard_rows): a host whose sequential shard is
        # one row shorter still emits the same number of batches, with the
        # surplus rows marked invalid
        rows = self._shard_rows()
        n_batches = rows // bs if cfg.drop_remainder else -(-rows // bs)

        q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # never block forever: an abandoned consumer (early break, NaN
            # abort) sets `stop`, and the producer must notice even while
            # the queue is full
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                filler = idxs[-1] if len(idxs) else 0
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    chunk = idxs[b * bs : (b + 1) * bs]
                    n_valid = len(chunk)
                    if n_valid < bs:  # pad (possibly empty) final batches
                        chunk = np.r_[chunk, np.full(bs - n_valid, filler)]
                    if not put(self._build_batch(chunk.astype(np.int64), n_valid)):
                        return
            finally:
                put(None)

        t = threading.Thread(
            target=producer, daemon=True, name="psla-loader-producer"
        )
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            # drain so a producer blocked mid-put can observe `stop`
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
