"""The port's trainer on the card. This file imports nothing of JAX, so it
runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_trainer_cuda.py -m cuda

One epoch of ``train.loop.Trainer`` at B0 (one head, T=128, 4 classes,
batch 8, mixup and SpecAugment on) on a corpus of tone clips written here,
under torch.profiler, with ``device_prefetch`` 2 and then 0. Checks: with
prefetch the batches cross from pinned memory on a stream other than the
one the fbank kernel runs on, and without it from pageable memory on that
stream; the fbank kernel launches once a train step and once a val batch;
the two runs' losses agree within 1e-5 (cuDNN in deterministic mode; the
copies change where the bytes come from, not what the steps compute). On
the CPU every test here skips.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.data.datafiles import load_datafile, save_datafile
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.frontend import fbank_cuda
from psla_tpu_torch.train.loop import Trainer

SR, N_CLASS, B = 16000, 4, 8


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the trainer's fbank is a CUDA kernel)")


def write_corpus(root) -> tuple[str, str]:
    rng = np.random.default_rng(0)
    t = np.arange(SR) / SR
    entries = []
    for i in range(24):
        k = i % N_CLASS
        x = 0.4 * np.sin(2 * np.pi * 200.0 * (k + 1) * t) + 0.01 * rng.standard_normal(SR)
        pcm = np.round(np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
        path = os.path.join(root, f"clip_{i}.wav")
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
                    + struct.pack("<IHHIIHH", 16, 1, 1, SR, SR * 2, 2, 16) + b"data"
                    + struct.pack("<I", len(pcm)) + pcm)
        entries.append({"wav": path, "labels": f"/m/{k:05d}"})
    datafile, label_csv = os.path.join(root, "data.json"), os.path.join(root, "labels.csv")
    save_datafile(datafile, entries)
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        f.writelines(f'{k},/m/{k:05d},"class {k}"\n' for k in range(N_CLASS))
    return datafile, label_csv


def run_epoch(datafile, label_csv, exp_dir, depth):
    cfg = ExperimentConfig(
        data_train=datafile, data_val=datafile, label_csv=label_csv, exp_dir=exp_dir,
        n_class=N_CLASS, eff_b=0, att_head=1, target_length=128, freqm=24, timem=24,
        mixup=0.5, lr=1e-3, batch_size=B, n_epochs=1, warmup=False, wa=False,
        bal=False, impretrain=False, num_workers=2, device_prefetch=depth)
    df = load_datafile(datafile, label_csv)
    buf = cfg.preprocess_config().fbank.buffer_length(cfg.target_length)
    train = AudioLoader(df, LoaderConfig(batch_size=B, buffer_samples=buf, num_workers=2,
                                         mixup=True, wire=cfg.wire))
    val = AudioLoader(df, LoaderConfig(batch_size=B, buffer_samples=buf, num_workers=2,
                                       drop_remainder=False, wire=cfg.wire), shuffle=False)
    trainer = Trainer(cfg, train, val, device="cuda")
    torch.cuda.synchronize()
    before = fbank_cuda.LAUNCHES
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        trainer.train()
        torch.cuda.synchronize()
    launches = fbank_cuda.LAUNCHES - before
    trace = os.path.join(exp_dir, "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    result = np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=",")
    return trainer, launches, events, result


@pytest.mark.cuda
def test_trainer_epoch_on_card(tmp_path):
    _card()
    torch.backends.cudnn.deterministic = True
    try:
        datafile, label_csv = write_corpus(str(tmp_path))
        runs = {d: run_epoch(datafile, label_csv, str(tmp_path / f"exp{d}"), d)
                for d in (2, 0)}
    finally:
        torch.backends.cudnn.deterministic = False
    for depth, (trainer, launches, events, result) in runs.items():
        steps, val_batches = trainer.steps_per_epoch, trainer.val_loader.batches_per_epoch()
        assert (steps, val_batches) == (3, 3)
        assert launches == steps + val_batches, (depth, launches)
        fbank_streams = {e["args"]["stream"] for e in events
                         if e.get("cat") == "kernel" and "fbank" in e["name"]}
        assert len(fbank_streams) == 1, fbank_streams
        h2d = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e["name"]]
        batch_copies = [e for e in h2d if e["args"].get("bytes", 0) >= B * 4]
        if depth:
            pinned = [e for e in h2d if "Pinned" in e["name"]]
            # 8 fields a batch, 3 train and 3 val batches
            assert len(pinned) == 8 * (steps + val_batches), len(pinned)
            assert not {e["args"]["stream"] for e in pinned} & fbank_streams
        else:
            assert batch_copies and all("Pageable" in e["name"] for e in batch_copies)
            assert {e["args"]["stream"] for e in batch_copies} <= fbank_streams
        assert result.shape == (10,) and np.all(np.isfinite(result[[0, 1, 5, 6]]))
    (r2, r0) = (runs[2][3], runs[0][3])
    np.testing.assert_allclose(r2[[5, 6]], r0[[5, 6]], rtol=0, atol=1e-5)
