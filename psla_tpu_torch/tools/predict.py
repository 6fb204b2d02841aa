"""One-click inference on audio of ANY length, on the GPU
(``psla-torch-predict``; port of ``psla_tpu/tools/predict.py``).

    psla-torch-predict clip.wav [more.wav ...] --ckpt model.pth \\
        --label-csv class_labels_indices.csv [--device cuda]

The checkpoint is anything ``models.convert.load_variables`` reads: a
reference ``.pth`` (DataParallel ``module.`` prefixes and ``_fc``
normalized), the port's own, a training checkpoint directory, or an
``.npz`` of JAX variables. A clip at another sample rate is resampled.
Audio of any duration is windowed into target_length-frame chunks, each
chunk batch through the fbank kernel, and aggregated EXACTLY at the
attention-pooling layer (``inference.predict_long``).
"""

from __future__ import annotations

import argparse

import numpy as np

from psla_tpu_torch.data.datafiles import make_name_dict
from psla_tpu_torch.data.wav import read_wav, resample
from psla_tpu_torch.frontend.fbank import FbankConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.inference import predict_long
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import load_variables
from psla_tpu_torch.train.state import place_model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("wav", nargs="+", help="WAV file(s), any duration")
    p.add_argument("--ckpt", required=True,
                   help=".pth/.pt state_dict (reference layout), training checkpoint "
                        "directory, or .npz of JAX variables")
    p.add_argument("--label-csv", required=True)
    p.add_argument("--model", default="efficientnet",
                   choices=["efficientnet", "resnet", "mbnet"])
    p.add_argument("--eff_b", type=int, default=2)
    p.add_argument("--att_head", type=int, default=4)
    p.add_argument("--target_length", type=int, default=1056)
    p.add_argument("--dataset_mean", type=float, default=-4.6476)
    p.add_argument("--dataset_std", type=float, default=4.5699)
    p.add_argument("--skip_norm", action="store_true",
                   help="predict with NO normalization (for models "
                        "trained with --skip_norm)")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--chunk_batch", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def run(argv=None) -> dict[str, np.ndarray]:
    """Predict and print the top-k of each file; returns each file's
    [n_class] probabilities."""
    args = build_parser().parse_args(argv)
    names = make_name_dict(args.label_csv)
    model = create_model(args.model, label_dim=len(names), eff_b=args.eff_b,
                         head_num=args.att_head)
    model.load_state_dict(load_variables(args.ckpt))
    place_model(model, args.device)
    config = PreprocessConfig(
        fbank=FbankConfig(sample_frequency=float(args.sample_rate)),
        target_length=args.target_length,
        norm_mean=args.dataset_mean,
        norm_std=args.dataset_std,
        skip_norm=args.skip_norm,
    )
    out = {}
    for path in args.wav:
        wav, sr = read_wav(path)
        wav = resample(wav, sr, args.sample_rate)
        probs = predict_long(model, wav, config, chunk_batch=args.chunk_batch,
                             device=args.device)
        order = np.argsort(probs)[::-1][: args.top_k]
        print(f"{path}  ({wav.size / args.sample_rate:.1f}s)")
        for i in order:
            print(f"  {probs[i]:.4f}  {names.get(int(i), str(i))}")
        out[path] = probs
    return out


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
