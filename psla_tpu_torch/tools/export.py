"""Serialized inference artifacts with ``torch.export`` (``psla-torch-export``;
port of ``psla_tpu/tools/export.py``).

    psla-torch-export --ckpt model.pth [--ckpt model2.pth ...] --out export/

packs the checkpoint(s), the preprocessing and the forward into ONE
artifact:

    out/model.pt2   ``torch.export.save`` of the inference program, the
                    member weights embedded, the batch dimension symbolic
                    (or fixed with ``--batch``)
    out/meta.json   the label map and the audio contract (sample_rate,
                    chunk_samples, target_length, normalization)

A serving host loads it with ``load_exported(out)``, or with
``torch.export.load`` and ``torch`` alone: no module of this package, no
checkpoint. It computes what ``tools/serve.InferenceEngine.batch_probs``
computes, the mean of the members' probabilities over one fbank per batch,
with the fbank's plain 'gemm' lowering (``frontend/fbank.py``) in place of
the CUDA kernel, as the JAX export pins 'gemm' in place of its Pallas
kernel: the program holds aten operators only, so ``torch.export.load``
needs no custom op. The program is traced on ``--device``; ``load_exported``
moves it to the device it is asked for
(``torch.export.passes.move_to_device_pass``).

``--dtype`` (``bfloat16`` by default, as the JAX tool's) is the compute
dtype of the members' forwards. The program traces the serving copies
that ``InferenceEngine`` runs (``models.layers.for_inference``): each
weight is embedded in the dtype its layer computes in, cast once, and each
BatchNorm's scale and shift folded once, so a call does no work on the
weights. The fbank stays float32 and the probabilities come out float32 in
either dtype. A float32 artifact's convolutions follow the process's TF32
flags: a host that loads it with ``torch`` alone on a card sets
``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's default is True) to
get the float32 results, as ``ExportedModel`` on a card does. A bfloat16
artifact needs no TF32 setting: its convolutions run in bf16, and its
float32 products (the fbank, MobileNetV2's classifier) follow
``torch.backends.cuda.matmul.allow_tf32``, which PyTorch leaves False.

The JAX tool's ``--platforms`` has no meaning here: one program runs on
the CPU and the card.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from psla_tpu_torch.inference import ensemble_probs
from psla_tpu_torch.models.layers import for_inference
from psla_tpu_torch.train.state import place_model

ARTIFACT = "model.pt2"
META = "meta.json"
FORMAT_VERSION = 1


# --------------------------------------------------------------- building


class InferenceProgram(torch.nn.Module):
    """(wav [B, chunk], wav_mean [B], lengths [B] int32) -> the members'
    mean probabilities [B, n_class] (float32): ``batch_probs`` with the
    'gemm' fbank. ``build_program`` makes it from trained models."""

    def __init__(self, members: list[torch.nn.Module], config):
        super().__init__()
        self.members = torch.nn.ModuleList(members)
        self.config = dataclasses.replace(config, fbank_method="gemm")

    def forward(self, wav: torch.Tensor, wav_mean: torch.Tensor,
                lengths: torch.Tensor) -> torch.Tensor:
        return ensemble_probs(self.members, wav, wav_mean, lengths, self.config)


def build_program(members, config, device: str | torch.device) -> InferenceProgram:
    """The program of ``members`` (a model or a list of them) on ``device``:
    their serving copies (``for_inference``), with TF32 switched off for a
    float32 program on a card (``train.state.place_model``)."""
    if not isinstance(members, (list, tuple)):
        members = [members]
    return InferenceProgram(
        [place_model(for_inference(m, device), device) for m in members], config).eval()


def export_model(members, config, names: dict, *, batch: int | None = None,
                 device: str | torch.device = "cuda"):
    """Trace the inference program on ``device``. Returns (ExportedProgram,
    meta).

    ``batch=None`` exports a symbolic batch dimension (any B >= 1 at run
    time), traced at an example batch of 2 (a batch of 1 would be
    specialised); an int pins the batch, and ``ExportedModel.predict``
    pads to it."""
    if not isinstance(members, (list, tuple)):
        members = [members]
    # `is not None`, not truthiness: batch=0 is an error, not a symbolic batch
    if batch is not None and int(batch) < 1:
        raise ValueError(f"batch must be >= 1 (got {batch}); "
                         "omit it for a symbolic batch dimension")
    device = torch.device(device)
    program = build_program(members, config, device)
    chunk = config.fbank.buffer_length(config.target_length)
    b = int(batch) if batch is not None else 2
    example = (torch.zeros((b, chunk), device=device), torch.zeros((b,), device=device),
               torch.full((b,), chunk, dtype=torch.int32, device=device))
    with torch.no_grad():
        # one eager call first: the fbank's tables are cached per device
        # (frontend/fbank._constant), and a cache the trace filled would hold
        # the trace's placeholder tensors; warm, the trace embeds the real
        # tables as constants
        program(*example)
        dim = torch.export.Dim("batch", min=1)
        exported = torch.export.export(
            program, example,
            dynamic_shapes=None if batch is not None else ({0: dim}, {0: dim}, {0: dim}))
    meta = {
        "format_version": FORMAT_VERSION,
        "platforms": ["cpu", "cuda"],
        "batch": int(batch) if batch is not None else "symbolic",
        "n_class": len(names),
        "names": {str(int(k)): v for k, v in names.items()},
        "n_members": len(members),
        "model": {"dtype": str(members[0].dtype).removeprefix("torch.")},
        "sample_rate": float(config.fbank.sample_frequency),
        "chunk_samples": int(chunk),
        "target_length": int(config.target_length),
        "norm_mean": float(config.norm_mean),
        "norm_std": float(config.norm_std),
        "skip_norm": bool(config.skip_norm),
        "torch_version": torch.__version__,
    }
    return exported, meta


def save_exported(outdir: str, exported, meta: dict) -> None:
    os.makedirs(outdir, exist_ok=True)
    torch.export.save(exported, os.path.join(outdir, ARTIFACT))
    with open(os.path.join(outdir, META), "w") as f:
        json.dump(meta, f, indent=2)


# ---------------------------------------------------------------- loading


class ExportedModel:
    """A loaded artifact on one device: callable without the model code.
    On a card it switches TF32 off for a float32 artifact; a bfloat16
    artifact needs no TF32 setting (``meta["model"]["dtype"]``)."""

    def __init__(self, module, meta: dict, device: str | torch.device):
        self._module = module
        self.device = torch.device(device)
        self.dtype = meta.get("model", {}).get("dtype", "float32")
        if self.device.type == "cuda" and self.dtype == "float32":
            # cuDNN's float32 convolutions default to TF32, so switch it off
            # (process-wide, as InferenceEngine does); bf16 needs nothing
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.meta = meta
        self.names = {int(k): v for k, v in meta["names"].items()}
        self.chunk_samples = int(meta["chunk_samples"])
        self.n_class = int(meta["n_class"])
        self.sample_rate = float(meta["sample_rate"])
        b = meta.get("batch", "symbolic")
        self.fixed_batch = None if b == "symbolic" else int(b)

    def probs(self, wav, wav_mean=None, lengths=None) -> np.ndarray:
        """[B, chunk_samples] f32 (or a single 1-D chunk) -> [B, n_class]."""
        wav = np.asarray(wav, np.float32)
        if wav.ndim == 1:
            wav = wav[None]
        if wav.shape[1] != self.chunk_samples:
            raise ValueError(
                f"expected wav chunks of {self.chunk_samples} samples, "
                f"got {wav.shape[1]} (pad/cut host-side, or use .predict)")
        bsz = wav.shape[0]
        if self.fixed_batch and bsz != self.fixed_batch:
            raise ValueError(
                f"artifact was exported with a fixed batch of {self.fixed_batch}, "
                f"got {bsz} (use .predict, which pads)")
        if lengths is None:
            lengths = np.full((bsz,), self.chunk_samples, np.int32)
        lengths = np.asarray(lengths, np.int32)
        if wav_mean is None:
            wav_mean = wav.sum(axis=1) / np.maximum(lengths, 1).astype(np.float32)
        wav_mean = np.asarray(wav_mean, np.float32)
        args = (torch.from_numpy(x).to(self.device) for x in (wav, wav_mean, lengths))
        with torch.no_grad():
            return self._module(*args).cpu().numpy()

    def predict(self, wav) -> np.ndarray:
        """1-D waveform of ANY length -> [n_class] probabilities.

        Short clips pad into one chunk; long audio is windowed into
        chunk_samples rows whose probabilities are averaged, weighted by
        their true sample counts (the exact attention-level aggregation
        needs the pooling internals, ``inference.predict_long``, which a
        frozen artifact does not expose)."""
        wav = np.asarray(wav, np.float32).reshape(-1)
        chunk = self.chunk_samples
        n_rows = max(1, -(-wav.size // chunk))
        rows = np.zeros((n_rows, chunk), np.float32)
        lengths = np.zeros((n_rows,), np.int32)
        for r in range(n_rows):
            piece = wav[r * chunk:(r + 1) * chunk]
            rows[r, : piece.size] = piece
            lengths[r] = max(piece.size, 1)
        # the full-clip DC mean in every row, as inference.predict_long does
        mean = np.full((n_rows,), wav.mean() if wav.size else 0.0, np.float32)
        if self.fixed_batch:
            fb = self.fixed_batch
            pad = -n_rows % fb
            rows = np.pad(rows, ((0, pad), (0, 0)))
            mean = np.pad(mean, (0, pad))
            lengths = np.pad(lengths, (0, pad), constant_values=1)
            probs = np.concatenate([
                self.probs(rows[i:i + fb], mean[i:i + fb], lengths[i:i + fb])
                for i in range(0, n_rows + pad, fb)
            ])[:n_rows]
        else:
            probs = self.probs(rows, mean, lengths)
        w = lengths[:n_rows].astype(np.float64)
        return (probs * (w / w.sum())[:, None]).sum(axis=0)

    def top_k(self, wav, k: int = 10) -> list[tuple[str, float]]:
        p = self.predict(wav)
        order = np.argsort(p)[::-1][:k]
        return [(self.names.get(int(i), str(i)), float(p[i])) for i in order]


def load_exported(path: str, device: str | torch.device = "cuda") -> ExportedModel:
    """Load an artifact directory written by ``save_exported`` or the CLI
    onto ``device``."""
    from torch.export.passes import move_to_device_pass

    exported = torch.export.load(os.path.join(path, ARTIFACT))
    exported = move_to_device_pass(exported, torch.device(device))
    with open(os.path.join(path, META)) as f:
        meta = json.load(f)
    return ExportedModel(exported.module(), meta, device)


# -------------------------------------------------------------------- CLI


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", required=True, action="append",
                   help=".pth/.pt state_dict (reference layout), training checkpoint "
                        "directory, or .npz of JAX variables; repeat for an ensemble "
                        "(mean of members)")
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--label-csv", default=None,
                   help="class vocabulary; defaults to the bundled one for --dataset")
    p.add_argument("--dataset", default="audioset", choices=["audioset", "fsd50k"])
    p.add_argument("--model", default="efficientnet",
                   choices=["efficientnet", "resnet", "mbnet"])
    p.add_argument("--eff_b", type=int, default=2)
    p.add_argument("--att_head", type=int, default=4)
    p.add_argument("--target_length", type=int, default=1056)
    p.add_argument("--dataset_mean", type=float, default=-4.6476)
    p.add_argument("--dataset_std", type=float, default=4.5699)
    p.add_argument("--skip_norm", action="store_true",
                   help="bake in NO normalization (for models trained with "
                        "--skip_norm; otherwise the artifact would silently apply "
                        "the default mean/std)")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--batch", type=int, default=None,
                   help="pin a static batch size (default: symbolic -- any batch "
                        "at run time; must be >= 1)")
    p.add_argument("--device", default="cuda",
                   help="torch device to trace on (cuda, cuda:1, cpu)")
    p.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"],
                   help="compute dtype of the members' forwards, their weights "
                        "embedded in it (the fbank and the probabilities stay "
                        "float32)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

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
    exported, meta = export_model(members, config, names, batch=args.batch,
                                  device=args.device)
    meta["model"].update(name=args.model, eff_b=args.eff_b, att_head=args.att_head)
    save_exported(args.out, exported, meta)
    size = os.path.getsize(os.path.join(args.out, ARTIFACT))
    print(f"exported {len(members)} member(s), {len(names)} classes, {args.dtype}, "
          f"traced on {args.device}, batch={'symbolic' if args.batch is None else args.batch} -> "
          f"{os.path.join(args.out, ARTIFACT)} ({size / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
