"""FSD50K data preparation (port of ``psla_tpu/tools/prep_fsd.py``;
reference: egs/fsd50k/prep_fsd.py).

Resamples the dev and eval audio to 16 kHz PCM16 (a polyphase resampler in
place of the reference's ``sox`` shell-outs, prep_fsd.py:22-35) and turns
the FSD50K ground-truth CSVs into train, val and eval datafiles
(prep_fsd.py:44-117), then writes the training set's balanced-sampling
weight file. Host code: it touches no card.

FSD50K CSV schema: dev.csv has (fname, labels, mids, split[train|val]);
eval.csv has (fname, labels, mids).

    python -m psla_tpu_torch.tools.prep_fsd --fsd-root FSD50K \\
        --out-dir datafiles --label-csv fsd50k_class_labels_indices.csv
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from psla_tpu_torch.data import native
from psla_tpu_torch.data.sampler import gen_weight_file
from psla_tpu_torch.data.wav import read_wav, resample, write_wav


def resample_to_16k(src: str, dst: str):
    """One file to 16 kHz PCM16 at whatever rate it has (scipy's polyphase
    resampler, ``data/wav.resample``)."""
    wav, sr = read_wav(src)
    write_wav(dst, np.clip(resample(wav, sr, 16000), -1.0, 1.0), 16000)


def resample_dir(src_dir: str, dst_dir: str, assumed_rate: int = 44100,
                 n_threads: int = 8) -> int:
    """Resample every WAV in ``src_dir`` to 16 kHz PCM16 in ``dst_dir``;
    returns how many went through the per-file path.

    The native C++ polyphase batch resampler (``csrc/resample.cc``, the
    filter of scipy's ``resample_poly``) takes every file at
    ``assumed_rate`` (FSD50K ships 44.1 kHz audio). A file at any other
    rate, or one the native path could not do, goes through
    ``resample_to_16k``, which reads the file's own rate, as the JAX tool
    does; without a C++ compiler every file does."""
    os.makedirs(dst_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(src_dir) if f.endswith(".wav"))
    srcs = [os.path.join(src_dir, f) for f in files]
    dsts = [os.path.join(dst_dir, f) for f in files]
    leftover = list(range(len(files)))
    if files and native.available():
        status = native.resample_batch(srcs, dsts, in_rate=assumed_rate, out_rate=16000,
                                       n_threads=n_threads)
        leftover = [i for i in leftover if status[i] != 0]
        print(f"native resampler: {len(files) - len(leftover)}/{len(files)} done, "
              f"{len(leftover)} via fallback")
    for k, i in enumerate(leftover):
        resample_to_16k(srcs[i], dsts[i])
        if (k + 1) % 1000 == 0:
            print(f"resampled {k + 1}/{len(leftover)}")
    return len(leftover)


def build_datafiles(
    fsd_root: str,
    out_dir: str,
    audio_16k_dev: str,
    audio_16k_eval: str,
    label_csv: str,
) -> dict[str, str]:
    """dev.csv and eval.csv -> fsd50k_tr_full.json, fsd50k_val_full.json and
    fsd50k_eval_full.json (+ the training set's weight file); returns the
    three paths by name."""
    os.makedirs(out_dir, exist_ok=True)
    gt = os.path.join(fsd_root, "FSD50K.ground_truth")

    train, val = [], []
    with open(os.path.join(gt, "dev.csv"), newline="") as f:
        for row in csv.DictReader(f):
            entry = {"wav": os.path.join(audio_16k_dev, row["fname"] + ".wav"),
                     "labels": row["mids"]}
            (train if row["split"] == "train" else val).append(entry)

    evals = []
    with open(os.path.join(gt, "eval.csv"), newline="") as f:
        for row in csv.DictReader(f):
            evals.append({"wav": os.path.join(audio_16k_eval, row["fname"] + ".wav"),
                          "labels": row["mids"]})

    paths = {}
    for name, data in (("fsd50k_tr_full", train), ("fsd50k_val_full", val),
                       ("fsd50k_eval_full", evals)):
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump({"data": data}, f, indent=1)
        paths[name] = path
        print(f"{name}: {len(data)} clips -> {path}")

    gen_weight_file(paths["fsd50k_tr_full"], label_csv)
    return paths


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fsd-root", required=True, help="FSD50K release root")
    p.add_argument("--out-dir", required=True, help="datafile output dir")
    p.add_argument("--label-csv", required=True)
    p.add_argument("--skip-resample", action="store_true")
    args = p.parse_args(argv)

    dev16 = os.path.join(args.fsd_root, "FSD50K.dev_audio_16k")
    eval16 = os.path.join(args.fsd_root, "FSD50K.eval_audio_16k")
    if not args.skip_resample:
        resample_dir(os.path.join(args.fsd_root, "FSD50K.dev_audio"), dev16)
        resample_dir(os.path.join(args.fsd_root, "FSD50K.eval_audio"), eval16)
    build_datafiles(args.fsd_root, args.out_dir, dev16, eval16, args.label_csv)


if __name__ == "__main__":
    main()
