"""Flagship-scale rehearsal on the card: the real product at the real shape
(``psla-torch-flagship``; port of ``psla_tpu/tools/flagship.py``).

``psla-torch-smoke`` proves the cli.run -> loaders -> Trainer -> protocol
path at toy shape; this drives the same surface at the configuration every
published AudioSet run uses (reference: egs/audioset/run.sh:22-29 +
src/run.py:131 + src/traintest.py:73-212): EffNet-B2, T=1056, bs=128,
mixup 0.5, 48/192 SpecAugment masks, balanced sampler, weight averaging,
bfloat16 (as the JAX tool trains), on the card, through the actual
``python -m psla_tpu_torch.cli`` subprocess, including a SIGKILL mid-epoch
and a ``--resume`` relaunch.
The JAX tool's ``--compilation-cache`` has no counterpart: the port
compiles no programs, and its kernels' build cache (``cuda_build.py``)
survives the kill.

Stages:
  1. synthesize a flagship-shape corpus on disk (10.56 s / 16 kHz WAVs,
     labels drawn from the bundled 527-class AudioSet vocabulary);
  2. launch the CLI; kill -9 at the first epoch-2 print step;
  3. relaunch with --resume; assert it completes all epochs;
  4. parse the per-sample data/DNN meters + result.csv and emit ONE JSON
     summary that names the card and places the loader-fed sustained
     rate (the meters', and each epoch's train loop's) beside the bare
     train step's rate, when one is given
     (``chip_smoke.py`` phase 6 measures it on the same card); the two
     differ by the host loop, the loader, validation and checkpoints.

``--preflight`` (B0, T=64, bfloat16) checks the tool's own machinery on any
device in minutes; it is not a measurement. ``--synthetic-learnable``
trains a class-conditional corpus and asserts the accuracy claims.

Usage: psla-torch-flagship [--clips 1024] [--epochs 3] [--out DIR] [--keep]
       [--device cuda] [--step-clips-per-sec R]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from psla_tpu_torch import assets
from psla_tpu_torch.data.datafiles import load_label_csv
from psla_tpu_torch.data.wav import write_wav
from psla_tpu_torch.frontend.fbank import FbankConfig

TARGET_LENGTH = 1056  # frames: every published AudioSet run (run.sh:29)
DTYPE = "bfloat16"  # the run and --preflight, as the JAX tool trains
# the toy shape of --preflight (psla_tpu/tools/flagship.py:188,303)
PREFLIGHT_FLAGS = ["--eff_b", "0", "--target_length", "64", "--timem", "24",
                   "--dtype", DTYPE]
# how often leg 1's log is read for the kill step (the JAX tool's 2 s is
# longer than an epoch of 4 steps on the card)
POLL_S = 0.25


def make_corpus(d: str, n_train: int, n_val: int, seed: int = 0,
                target_length: int = TARGET_LENGTH) -> dict:
    """Synthetic flagship-shape corpus: tone+noise WAVs labeled from the
    real 527-class vocabulary (1-3 mids per clip, like AudioSet)."""
    rng = np.random.default_rng(seed)
    vocab = [row["mid"] for row in load_label_csv(assets.audioset_label_csv())]
    n_samples = FbankConfig().buffer_length(target_length)
    t = np.arange(n_samples, dtype=np.float32) / 16000.0

    def synth(i):
        f0 = float(rng.uniform(80.0, 4000.0))
        wav = 0.25 * np.sin(2 * np.pi * f0 * t)
        wav += 0.1 * np.sin(2 * np.pi * 2.01 * f0 * t)
        wav += 0.03 * rng.standard_normal(n_samples).astype(np.float32)
        return wav.astype(np.float32)

    files = {}
    for split, n in (("train", n_train), ("val", n_val)):
        entries = []
        sd = os.path.join(d, split)
        os.makedirs(sd, exist_ok=True)
        for i in range(n):
            p = os.path.join(sd, f"{i}.wav")
            write_wav(p, synth(i), 16000)
            mids = rng.choice(vocab, size=int(rng.integers(1, 4)),
                              replace=False)
            entries.append({"wav": p, "labels": ",".join(mids)})
        jf = os.path.join(d, f"{split}.json")
        with open(jf, "w") as f:
            json.dump({"data": entries}, f)
        files[split] = jf
    return files


def make_learnable_corpus(d: str, n_train: int, n_val: int, n_class: int,
                          seed: int = 0,
                          target_length: int = TARGET_LENGTH) -> dict:
    """Class-CONDITIONAL synthetic corpus: accuracy evidence, not just
    shape and throughput (a corpus of random labels scores chance).

    Class c is a tone at a log-spaced carrier f_c (125 Hz - 4 kHz, +-2%
    per-clip jitter) amplitude-modulated at a class-specific rate, a
    second harmonic, plus white noise — separable in the log-mel domain,
    but only if the WHOLE stack (fbank -> augment -> model -> protocol)
    is numerically sane. One label per clip (mixup still mixes pairs at
    train time, like the real protocol); eval clips are clean draws from
    the same generator. A model that trains through
    mixup+SpecAugment+wa+ensemble and scores mAP ~= 1.0 on held-out
    clips exercises the reference's accuracy claim end-to-end
    (traintest.py:20-230 + run.py:131-233) with no network."""
    rng = np.random.default_rng(seed)
    n_samples = FbankConfig().buffer_length(target_length)
    t = np.arange(n_samples, dtype=np.float32) / 16000.0
    carriers = np.geomspace(125.0, 4000.0, n_class)
    am_rates = 1.5 + 0.83 * np.arange(n_class)

    label_csv = os.path.join(d, "labels.csv")
    os.makedirs(d, exist_ok=True)
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for c in range(n_class):
            f.write(f"{c},/learn/{c},tone_{c}\n")

    def synth(c):
        f0 = carriers[c] * float(rng.uniform(0.98, 1.02))
        phase = float(rng.uniform(0, 2 * np.pi))
        am = 1.0 + 0.5 * np.sin(2 * np.pi * am_rates[c] * t)
        wav = 0.2 * am * np.sin(2 * np.pi * f0 * t + phase)
        wav += 0.06 * np.sin(2 * np.pi * 2.0 * f0 * t + phase)
        wav += 0.03 * rng.standard_normal(n_samples).astype(np.float32)
        return wav.astype(np.float32)

    files = {"label_csv": label_csv}
    for split, n in (("train", n_train), ("val", n_val)):
        entries = []
        sd = os.path.join(d, split)
        os.makedirs(sd, exist_ok=True)
        for i in range(n):
            c = i % n_class  # balanced
            p = os.path.join(sd, f"{i}.wav")
            write_wav(p, synth(c), 16000)
            entries.append({"wav": p, "labels": f"/learn/{c}"})
        jf = os.path.join(d, f"{split}.json")
        with open(jf, "w") as f:
            json.dump({"data": entries}, f)
        files[split] = jf
    return files


def run_learnable(
    clips: int = 3072,
    val_clips: int = 384,
    n_class: int = 32,
    epochs: int = 15,
    batch_size: int = 128,
    lr: float = 5e-4,
    out: str | None = None,
    preflight: bool = False,
    n_print_steps: int = 8,
    device: str = "cuda",
) -> dict:
    """The --synthetic-learnable flagship run: full protocol, learnable
    labels, accuracy asserted. Differences from the published flagship
    recipe, each forced by the tiny corpus: warmup off + lr 5e-4 (the
    reference's 1000-step staircase would span this whole run),
    lrscheduler_start scaled into range, bn_momentum 0.9 (eval-mode BN must
    reflect ~400 steps of statistics, not the 30-epoch default's warmup
    horizon). Everything else -- B2/T=1056/bs=128, mixup 0.5, 48x192
    SpecAugment, balanced sampler, wa window, running checkpoint
    ensemble -- is the flagship protocol."""
    target_length = 64 if preflight else TARGET_LENGTH
    d = out or tempfile.mkdtemp(prefix="psla_learnable_")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    files = make_learnable_corpus(d, clips, val_clips, n_class, target_length=target_length)
    corpus_s = time.time() - t0
    exp_dir = os.path.join(d, "exp")
    log_path = os.path.join(d, "run.log")
    wa_start = max(1, epochs - 4)
    flags = [
        "--preset", "audioset_full",
        "--data-train", files["train"], "--data-val", files["val"],
        "--label-csv", files["label_csv"], "--n_class", str(n_class),
        "--exp-dir", exp_dir,
        "--batch-size", str(batch_size), "--n-epochs", str(epochs),
        "--impretrain", "False",
        "--lr", str(lr), "--warmup", "False",
        "--lrscheduler_start", str(max(2, epochs - 5)),
        "--bn-momentum", "0.9",
        "--wa", "True", "--wa_start", str(wa_start),
        "--wa_end", str(epochs),
        "--n-print-steps", str(n_print_steps),
        "--device", device,
    ]
    if preflight:
        flags += PREFLIGHT_FLAGS

    t1 = time.time()
    proc, log = _launch(flags, log_path)
    rc = proc.wait()
    log.close()
    train_s = time.time() - t1
    if rc != 0:
        raise RuntimeError(f"learnable run failed rc={rc} -- see {log_path}")

    result = np.atleast_2d(np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=","))
    assert result.shape[0] == epochs, result.shape
    per_epoch_map = result[:, 0]
    best_single = float(np.max(per_epoch_map))
    ensemble_map = float(result[-1, -3])
    wa_path = os.path.join(exp_dir, "wa_result.csv")
    wa_map = float(np.loadtxt(wa_path)[0]) if os.path.exists(wa_path) else None

    with open(log_path) as f:
        txt = f.read()

    summary = {
        "mode": "synthetic-learnable",
        "device": child_device(txt),
        "shape": {"model": "efficientnet-b0" if preflight else "efficientnet-b2",
                  "target_length": target_length, "batch_size": batch_size,
                  "n_class": n_class, "clips": clips,
                  "val_clips": val_clips, "epochs": epochs, "lr": lr,
                  "mixup": 0.5, "freqm": 48,
                  "timem": 24 if preflight else 192, "bal": True, "dtype": DTYPE},
        "per_epoch_mAP": [round(float(x), 4) for x in per_epoch_map],
        "best_single_mAP": round(best_single, 4),
        "wa_mAP": round(wa_map, 4) if wa_map is not None else None,
        "ensemble_mAP": round(ensemble_map, 4),
        "wall_s": {"corpus": round(corpus_s, 1), "train": round(train_s, 1)},
        "exp_dir": d,
        "log": log_path,
    }
    if not preflight:
        # the accuracy claims this run exists to check
        assert best_single >= 0.95, (
            f"flagship stack failed to learn a separable corpus: best "
            f"per-epoch mAP {best_single:.4f} (see {log_path})"
        )
        assert ensemble_map >= best_single - 0.005, (
            f"checkpoint ensemble ({ensemble_map:.4f}) lost to best "
            f"single ({best_single:.4f})"
        )
        assert wa_map is not None and wa_map >= best_single - 0.005, (
            f"weight averaging ({wa_map}) lost to best single "
            f"({best_single:.4f})"
        )
        summary["accuracy_ok"] = True
    return summary


_METER_RE = re.compile(
    r"Epoch: \[(\d+)\]\[(\d+)/(\d+)\]\s+per-sample total ([0-9.e-]+)\s+"
    r"data ([0-9.e-]+)\s+dnn ([0-9.e-]+)"
)


# the trainer's line at each epoch's end (train/loop.py): the train loop's
# wall time, to the epoch's loss fetch, which waits for the card
_EPOCH_RE = re.compile(r"^epoch (\d+) train loop: (\d+) steps in ([0-9.]+) s$", re.M)


def epoch_rates(log_text: str, batch_size: int) -> dict[int, float]:
    """clips/s of each epoch's train loop from the trainer's epoch lines;
    an epoch the resumed leg ran again keeps the resumed leg's."""
    return {int(e): round(int(n) * batch_size / float(s), 1)
            for e, n, s in _EPOCH_RE.findall(log_text)}


# the line cli.run prints first: "torch <version> on <device> (<card name>)"
_DEVICE_RE = re.compile(r"^torch \S+ on (\S+) \((.*)\)$", re.M)


def child_device(log_text: str) -> dict:
    """The device the CLI subprocess trained on and its name, from its log
    (the last run's line)."""
    found = _DEVICE_RE.findall(log_text)
    if not found:
        return {"device": "unknown", "name": "unknown"}
    device, name = found[-1]
    return {"device": device, "name": name}


def _launch(flags, log_path):
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    log = open(log_path, "ab")
    return subprocess.Popen(
        [sys.executable, "-m", "psla_tpu_torch.cli", *flags],
        stdout=log, stderr=subprocess.STDOUT, env=env,
    ), log


def run(
    clips: int = 1024,
    val_clips: int = 256,
    epochs: int = 3,
    batch_size: int = 128,
    out: str | None = None,
    kill_epoch: int = 2,
    preflight: bool = False,
    n_print_steps: int = 2,
    device: str = "cuda",
    step_clips_per_sec: float | None = None,
) -> dict:
    """The kill-and-resume rehearsal. ``preflight=True`` shrinks the MODEL
    shape (B0, T=64) so the tool's own machinery -- corpus, kill, resume,
    parse -- can be checked on a CPU in minutes; the flagship measurement
    runs at the default shape on the card. ``step_clips_per_sec`` is the
    bare train step's rate at this shape on the same card (``chip_smoke.py``
    phase 6), placed beside the loader-fed rate in the summary."""
    target_length = 64 if preflight else TARGET_LENGTH
    d = out or tempfile.mkdtemp(prefix="psla_flagship_")
    os.makedirs(d, exist_ok=True)
    t0 = time.time()
    files = make_corpus(d, clips, val_clips, target_length=target_length)
    corpus_s = time.time() - t0
    exp_dir = os.path.join(d, "exp")
    log_path = os.path.join(d, "run.log")
    flags = [
        "--preset", "audioset_full",
        "--data-train", files["train"], "--data-val", files["val"],
        "--exp-dir", exp_dir,
        "--batch-size", str(batch_size), "--n-epochs", str(epochs),
        "--impretrain", "False",
        "--wa", "True", "--wa_start", str(max(1, epochs - 1)),
        "--wa_end", str(epochs),
        "--n-print-steps", str(n_print_steps),
        "--device", device,
    ]
    if preflight:
        flags += PREFLIGHT_FLAGS

    # ---- leg 1: cold start, killed mid-epoch `kill_epoch`
    t1 = time.time()
    proc, log = _launch(flags, log_path)
    killed = False
    try:
        while proc.poll() is None:
            time.sleep(POLL_S)
            with open(log_path) as f:
                txt = f.read()
            if re.search(rf"Epoch: \[{kill_epoch}\]\[", txt):
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                killed = True
                break
    finally:
        if proc.poll() is None:  # the poll itself failed: leave no child
            proc.kill()
            proc.wait()
        log.close()
    leg1_s = time.time() - t1
    if not killed:
        raise RuntimeError(
            f"leg 1 exited rc={proc.returncode} before reaching epoch "
            f"{kill_epoch}'s first print step -- see {log_path}"
        )

    # ---- leg 2: resume from the last epoch checkpoint
    t2 = time.time()
    proc, log = _launch([*flags, "--resume"], log_path)
    rc = proc.wait()
    log.close()
    leg2_s = time.time() - t2
    if rc != 0:
        raise RuntimeError(f"resume leg failed rc={rc} -- see {log_path}")

    # ---- parse evidence
    with open(log_path) as f:
        txt = f.read()
    meters = [
        {"epoch": int(m[0]), "step": int(m[1]), "total": float(m[3]),
         "data": float(m[4]), "dnn": float(m[5])}
        for m in _METER_RE.findall(txt)
    ]
    # steady state: epochs past the first (which pays the kernels' loads
    # and the allocator's warm-up) and past the first print window of each
    # epoch (loader warm-up)
    steady = [m for m in meters if m["epoch"] > 1 and m["step"] > 2]
    if not steady:
        steady = [m for m in meters if m["epoch"] > 1] or meters[-2:]
    total = float(np.median([m["total"] for m in steady]))
    data_t = float(np.median([m["data"] for m in steady]))
    dnn_t = float(np.median([m["dnn"] for m in steady]))

    result = np.atleast_2d(np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=","))
    assert result.shape[0] == epochs, result.shape
    assert np.isfinite(result[:, 5]).all(), "non-finite train loss"
    resumed = re.findall(r"^resumed from epoch (\d+)$", txt, re.M)
    wa_dir = os.path.join(exp_dir, "models", "wa")

    summary = {
        "device": child_device(txt),
        "shape": {"model": "efficientnet-b0" if preflight else "efficientnet-b2",
                  "target_length": target_length,
                  "batch_size": batch_size, "mixup": 0.5,
                  "freqm": 48, "timem": 24 if preflight else 192,
                  "bal": True, "dtype": DTYPE,
                  "n_class": 527, "clips": clips, "epochs": epochs},
        "sustained_clips_per_sec": round(1.0 / total, 1),
        "dnn_only_clips_per_sec": round(1.0 / dnn_t, 1),
        # each epoch's train loop; the resumed leg's first epoch pays its
        # process's warm-up, as epoch 1 does
        "epoch_clips_per_sec": epoch_rates(txt, batch_size),
        "bare_step_clips_per_sec": step_clips_per_sec,
        "data_time_share": round(data_t / total, 3),
        "per_sample_s": {"total": total, "data": data_t, "dnn": dnn_t},
        "killed_mid_epoch": kill_epoch,
        # the last checkpoint the kill left: kill_epoch - 1 when the kill
        # landed inside that epoch
        "resumed_from_epoch": int(resumed[-1]) if resumed else 0,
        "resume_completed_epochs": int(result.shape[0]),
        "wa_checkpoint": os.path.isdir(wa_dir),
        "wall_s": {"corpus": round(corpus_s, 1), "leg1": round(leg1_s, 1),
                   "leg2_resume": round(leg2_s, 1)},
        "exp_dir": d,
        "log": log_path,
    }
    return summary


def main_cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    # None = per-mode default (throughput rehearsal: 1024/256/3/2;
    # --synthetic-learnable: 3072/384/15/8 -- it needs enough steps to fit)
    p.add_argument("--clips", type=int, default=None)
    p.add_argument("--val-clips", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--keep", action="store_true")
    p.add_argument("--n-print-steps", type=int, default=None,
                   help="meter print cadence; each print step fetches the loss, "
                        "one sync with the card")
    p.add_argument("--preflight", action="store_true",
                   help="toy shape (B0/T=64) to check the rehearsal "
                        "machinery itself; NOT a measurement")
    p.add_argument("--synthetic-learnable", action="store_true",
                   help="class-conditional corpus + accuracy assertions "
                        "(mAP ~= 1.0, ensemble/wa >= best single) instead "
                        "of the kill/resume throughput rehearsal")
    p.add_argument("--n-class", type=int, default=32,
                   help="classes in the --synthetic-learnable corpus")
    p.add_argument("--lr", type=float, default=5e-4,
                   help="--synthetic-learnable learning rate")
    p.add_argument("--device", default="cuda",
                   help="torch device the CLI trains on (cuda, cuda:1, cpu)")
    p.add_argument("--step-clips-per-sec", type=float, default=None,
                   help="the bare train step's clips/s at this shape on the same "
                        "card (chip_smoke.py phase 6), for the summary")
    args = p.parse_args(argv)

    def d(v, default):
        return default if v is None else v

    if args.synthetic_learnable:
        res = run_learnable(
            clips=d(args.clips, 3072), val_clips=d(args.val_clips, 384),
            n_class=args.n_class, epochs=d(args.epochs, 15),
            batch_size=args.batch_size, lr=args.lr, out=args.out,
            preflight=args.preflight,
            n_print_steps=d(args.n_print_steps, 8), device=args.device)
    else:
        res = run(clips=d(args.clips, 1024),
                  val_clips=d(args.val_clips, 256),
                  epochs=d(args.epochs, 3), batch_size=args.batch_size,
                  out=args.out, preflight=args.preflight,
                  n_print_steps=d(args.n_print_steps, 2), device=args.device,
                  step_clips_per_sec=args.step_clips_per_sec)
    print(json.dumps(res))
    if not args.keep:
        shutil.rmtree(res["exp_dir"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main_cli())
