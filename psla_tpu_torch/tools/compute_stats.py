"""Dataset log-mel normalization statistics on the GPU, the skip_norm
onboarding loop (port of ``psla_tpu/tools/compute_stats.py``).

The reference documents the workflow for a NEW dataset
(src/dataloaders/audioset_dataset.py:72-78): run with ``skip_norm`` so
fbanks come out unnormalized, measure their mean and std, then train with
``--dataset_mean/--dataset_std``. This tool is the measuring step:

    python -m psla_tpu_torch.tools.compute_stats --datafile tr.json \\
        [--label-csv labels.csv] [--target_length 1056] [--device cuda]

It prints the mean and std of the UNNORMALIZED log-mel values over the
datafile, computed as training sees them (DC removal -> the fbank kernel
-> pad/cut to target_length, the reference's stat domain), and the flags
to pass to training.
"""

from __future__ import annotations

import argparse
import contextlib
import json

import numpy as np
import torch

from psla_tpu_torch.data.datafiles import Datafile, load_datafile
from psla_tpu_torch.data.device_prefetch import prefetch_to_device
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.frontend.fbank import FbankConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig, preprocess_eval
from psla_tpu_torch.train.step import _wav_batch


def _datafile(datafile: str, label_csv: str | None) -> Datafile:
    if label_csv:
        return load_datafile(datafile, label_csv)
    # stats need no labels: derive a vocabulary from the datafile
    with open(datafile) as f:
        entries = json.load(f)["data"]
    mids = sorted({m for e in entries for m in str(e.get("labels", "")).split(",") if m})
    return Datafile(entries=entries, index_dict={m: i for i, m in enumerate(mids)})


def compute_norm_stats(
    datafile: str,
    label_csv: str | None = None,
    target_length: int = 1056,
    num_mel_bins: int = 128,
    sample_rate: int = 16000,
    batch_size: int = 32,
    num_workers: int = 4,
    limit: int | None = None,
    fbank_method: str = "auto",
    device: str | torch.device = "cuda",
) -> tuple[float, float]:
    """Streaming mean and std of unnormalized log-mels over a datafile.

    Each batch's sums are taken on ``device`` in float64 and added there,
    and fetched once at the end. Rows past a batch's ``n_valid`` (the
    padded tail of the last batch) are left out; the frames that pad a
    clip to ``target_length`` are counted, as in the reference's domain."""
    device = torch.device(device)
    pre = PreprocessConfig(
        fbank=FbankConfig(sample_frequency=float(sample_rate), num_mel_bins=num_mel_bins),
        target_length=target_length, skip_norm=True, fbank_method=fbank_method,
    ).eval_variant()
    loader = AudioLoader(
        _datafile(datafile, label_csv),
        LoaderConfig(batch_size=batch_size,
                     buffer_samples=pre.fbank.buffer_length(target_length),
                     num_workers=num_workers, drop_remainder=False),
        shuffle=False,
    )
    s1 = torch.zeros((), dtype=torch.float64, device=device)
    s2 = torch.zeros((), dtype=torch.float64, device=device)
    seen = 0
    with torch.inference_mode(), contextlib.closing(
            prefetch_to_device(iter(loader), device, depth=2)) as batches:
        for host_batch, batch in batches:
            n_valid = int(host_batch["n_valid"])
            logmel = preprocess_eval(_wav_batch(batch, device), pre)[:n_valid].double()
            s1 += logmel.sum()
            s2 += (logmel * logmel).sum()
            seen += n_valid
            if limit is not None and seen >= limit:
                break
    n = seen * target_length * num_mel_bins
    mean = float(s1) / n
    var = max(float(s2) / n - mean * mean, 0.0)
    return mean, float(np.sqrt(var))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datafile", required=True)
    p.add_argument("--label-csv", default=None)
    p.add_argument("--dataset", default=None,
                   help="use the bundled vocabulary for this dataset "
                        "when --label-csv is not given")
    p.add_argument("--target_length", type=int, default=1056)
    p.add_argument("--num_mel_bins", type=int, default=128)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--limit", type=int, default=None,
                   help="stop after ~this many clips (estimate mode)")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--device", default="cuda",
                   help="torch device of the fbank (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    label_csv = args.label_csv
    if label_csv is None and args.dataset:
        from psla_tpu_torch import assets

        label_csv = assets.label_csv_for(args.dataset)
    mean, std = compute_norm_stats(
        args.datafile, label_csv,
        target_length=args.target_length, num_mel_bins=args.num_mel_bins,
        sample_rate=args.sample_rate, batch_size=args.batch_size,
        num_workers=args.num_workers, limit=args.limit, device=args.device,
    )
    if args.json:
        print(json.dumps({"dataset_mean": mean, "dataset_std": std}))
    else:
        print(f"log-mel mean {mean:.4f} std {std:.4f}")
        print(f"train with: --dataset_mean {mean:.4f} --dataset_std {std:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
