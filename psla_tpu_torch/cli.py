"""The training entry point, ``psla-torch-train`` (port of
``psla_tpu/cli.py``; replaces the reference's run.sh + run.py).

Flag names mirror src/run.py:25-72 and the JAX package's ``psla-train``;
``--preset`` pulls in a full recipe (egs/*/run.sh values) with any explicit
flag overriding it. ``--device`` picks the card (the default, ``cuda``) or
``cpu``. Flags whose code the port has not yet refuse with their ROADMAP
item (``config.unported``).

Several ranks (one card each): under a launcher (``torchrun
--nproc_per_node N -m psla_tpu_torch.cli ...``) the group comes from its
environment; otherwise ``--num-devices N`` spawns N ranks on this host
(NCCL on the cards, gloo with ``--device cpu``). ``--batch-size`` is the
global batch either way: each rank loads batch_size / N rows, or with
``--ensemble-seeds E`` batch_size / R, where R is the ranks of an ensemble
row (``parallel.ensemble.ensemble_layout``: the N ranks split into
gcd(E, N) rows, each training its E / gcd(E, N) members data-parallel
over its R = N / gcd(E, N) ranks on the same batches as every other row).

Example:
    psla-torch-train --preset audioset_full \\
        --data-train tr.json --data-val val.json --exp-dir exp/as
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import sys

import torch

from psla_tpu_torch.config import PRESETS, ExperimentConfig, unported
from psla_tpu_torch.data.datafiles import load_datafile
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.data.sampler import compute_sample_weights
from psla_tpu_torch.parallel.distributed import maybe_initialize, process_info, spawn
from psla_tpu_torch.parallel.ensemble import ensemble_layout
from psla_tpu_torch.train.ensemble_loop import EnsembleTrainer
from psla_tpu_torch.train.loop import Trainer
from psla_tpu_torch.train.protocol import post_training_summary


def _bool(v):  # the reference parses booleans with ast.literal_eval (run.py:50)
    return bool(ast.literal_eval(str(v)))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    # I/O
    p.add_argument("--data-train", type=str, default="")
    p.add_argument("--data-val", type=str, default="")
    p.add_argument("--data-eval", type=str, default=None)
    p.add_argument("--label-csv", type=str, default="")
    p.add_argument("--exp-dir", type=str, default="")
    # optimization
    p.add_argument("-b", "--batch-size", type=int, default=None)
    p.add_argument("-w", "--num-workers", type=int, default=None)
    p.add_argument("--lr", "--learning-rate", type=float, default=None)
    p.add_argument("--weight-decay", "--wd", type=float, default=None)
    p.add_argument("--n-epochs", type=int, default=None)
    p.add_argument("--n-print-steps", type=int, default=None)
    p.add_argument("--warmup", type=_bool, default=None)
    p.add_argument("--lrscheduler_start", type=int, default=None)
    p.add_argument("--lrscheduler_decay", type=float, default=None)
    p.add_argument("--loss", choices=["BCE", "CE"], default=None)
    p.add_argument("--metrics", choices=["mAP", "acc"], default=None)
    # model
    p.add_argument("--model", choices=["efficientnet", "resnet", "mbnet", "ast"], default=None)
    p.add_argument("--eff_b", type=int, default=None)
    p.add_argument("--att_head", type=int, default=None)
    p.add_argument("--impretrain", type=_bool, default=None)
    p.add_argument("--pretrained-ckpt", type=str, default=None)
    p.add_argument("--n_class", type=int, default=None)
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--bn-momentum", type=float, default=None,
                   help="BatchNorm running-stat momentum, flax convention "
                        "(default 0.99 == the reference's torch 0.01)")
    # data / augmentation
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--dataset_mean", type=float, default=None)
    p.add_argument("--dataset_std", type=float, default=None)
    p.add_argument("--target_length", type=int, default=None)
    p.add_argument("--freqm", type=int, default=None)
    p.add_argument("--timem", type=int, default=None)
    p.add_argument("--mixup", type=float, default=None)
    p.add_argument("--noise", type=_bool, default=None)
    p.add_argument("--skip_norm", type=_bool, default=None,
                   help="skip mean/std normalization")
    p.add_argument("--bal", type=_bool, default=None)
    # weight averaging
    p.add_argument("--wa", type=_bool, default=None)
    p.add_argument("--wa_start", type=int, default=None)
    p.add_argument("--wa_end", type=int, default=None)
    p.add_argument("--save_model", type=_bool, default=None)
    # engine
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks of data parallelism, one card each: under torchrun its world "
                        "size (the default), else N > 1 spawns N ranks on this host")
    p.add_argument("--ensemble-seeds", type=int, default=None,
                   help="train this many seeds in lockstep (seed, seed + 1, ...; a shared "
                        "data stream, per-seed draws) and report their mean "
                        "(EnsembleTrainer); on several ranks the members are spread "
                        "over rows of ranks")
    p.add_argument("--fbank-method", choices=["auto", "fft", "gemm", "pallas"], default=None,
                   help="'auto' and 'pallas' take the CUDA fbank kernel on the card")
    p.add_argument("--fbank-precision", choices=["highest", "high", "default"], default=None,
                   help="kept for the JAX package's flag; the kernel's spectrum is "
                        "float64 whatever it says")
    p.add_argument("--act-compress", choices=["none", "q8save", "qdq"], default=None,
                   help="int8 compression of the depthwise convolutions' inputs "
                        "(EfficientNet only): q8save keeps them as int8 for backward, "
                        "qdq quantizes them straight-through")
    p.add_argument("--remat", type=_bool, default=None,
                   help="rematerialize MBConv blocks in backward (torch.utils.checkpoint)")
    p.add_argument("--tensorboard", type=_bool, default=None,
                   help="write per-epoch scalars to {exp_dir}/tb")
    p.add_argument("--profile-steps", type=int, default=None,
                   help="capture a torch.profiler trace of this many train steps into "
                        "{exp_dir}/profile")
    p.add_argument("--profile-start-step", type=int, default=None)
    p.add_argument("--compilation-cache", type=str, default=None,
                   help="the JAX package's XLA cache: refused, no PyTorch meaning")
    p.add_argument("--wire", choices=["int16", "float32"], default=None,
                   help="host->card waveform wire format: 'int16' (raw PCM, bit-exact "
                        "for PCM16 sources, half the bytes; the default) or 'float32'")
    p.add_argument("--device-prefetch", type=int, default=None,
                   help="batches whose copy to the card runs ahead of the step, from "
                        "pinned buffers on a side stream (0 copies in line)")
    return p


def config_from_args(args) -> ExperimentConfig:
    kwargs = dict(PRESETS[args.preset]) if args.preset else {}
    fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
    kwargs.update({k: v for k, v in vars(args).items()
                   if k in fields and v is not None and v != ""})
    return ExperimentConfig(**kwargs)


def make_loaders(cfg: ExperimentConfig):
    """The train, val and (with ``data_eval``) eval loaders of this rank:
    its shard of each set, ``batch_size / world`` rows a batch
    (``batch_size`` is the global batch). An ensemble on several ranks
    (``ensemble_seeds`` > 1) replicates the batch over its rows, so a rank
    feeds its position within its row, ``batch_size / ranks a row`` rows a
    batch, and ranks at the same position in different rows load the same
    rows (JAX ``psla_tpu/cli.py`` remaps the same way)."""
    rank, world = process_info()
    what = f"the {world} ranks"
    if cfg.ensemble_seeds > 1 and world > 1:
        _, rank, world = ensemble_layout(cfg.ensemble_seeds, world, rank, world)
        what = f"the {world} ranks of an ensemble row"
    if cfg.batch_size % world:
        raise ValueError(f"--batch-size {cfg.batch_size} is the global batch and is not "
                         f"divisible by {what}")
    batch = cfg.batch_size // world
    pre = cfg.preprocess_config()
    buf = pre.fbank.buffer_length(cfg.target_length)
    train_df = load_datafile(cfg.data_train, cfg.label_csv)
    val_df = load_datafile(cfg.data_val, cfg.label_csv)

    weights = compute_sample_weights(train_df) if cfg.bal else None
    if cfg.bal:
        print("balanced sampler is being used")
    shard = dict(host_id=rank, num_hosts=world)
    train_loader = AudioLoader(
        train_df,
        LoaderConfig(batch_size=batch, buffer_samples=buf,
                     num_workers=cfg.num_workers, mixup=cfg.mixup > 0, seed=cfg.seed,
                     wire=cfg.wire, **shard),
        weights=weights,
    )
    val_loader = AudioLoader(
        val_df,
        LoaderConfig(batch_size=batch, buffer_samples=buf,
                     num_workers=cfg.num_workers, drop_remainder=False, wire=cfg.wire,
                     **shard),
        shuffle=False,
    )
    eval_loader = None
    if cfg.data_eval:
        eval_df = load_datafile(cfg.data_eval, cfg.label_csv)
        eval_loader = AudioLoader(
            eval_df,
            LoaderConfig(batch_size=batch * 2, buffer_samples=buf,
                         num_workers=cfg.num_workers, drop_remainder=False, wire=cfg.wire,
                         **shard),
            shuffle=False,
        )
    return train_loader, val_loader, eval_loader


def run(argv=None) -> dict:
    """Library entry: parse, train, and return the post-training summary.
    Joins the launcher's process group if there is one; ``--num-devices
    N`` > 1 without one spawns N ranks (``parallel.distributed.spawn``)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    maybe_initialize(device=args.device)
    cfg = config_from_args(args)
    unported(cfg)
    world = process_info()[1]
    if world == 1 and (cfg.num_devices or 1) > 1:
        return spawn(run, argv, cfg.num_devices, args.device)
    if cfg.num_devices is not None and cfg.num_devices != world:
        raise ValueError(f"--num-devices {cfg.num_devices} under a launcher's "
                         f"{world}-rank group: leave it out or give {world}")
    if not cfg.label_csv:
        # bundled public vocabularies (the reference ships the same CSVs
        # in-repo at egs/*/class_labels_indices.csv)
        from psla_tpu_torch import assets

        cfg.label_csv = assets.label_csv_for(cfg.dataset)
        print(f"using bundled label vocabulary: {cfg.label_csv}")
    if not cfg.exp_dir:
        cfg.exp_dir = (f"exp/Data-{cfg.dataset}_Model-{cfg.model}_LR-{cfg.lr}"
                       f"_Epochs-{cfg.n_epochs}")
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "host CPU"
    print(f"torch {torch.__version__} on {device} ({name})", flush=True)
    train_loader, val_loader, eval_loader = make_loaders(cfg)
    trainer_cls = EnsembleTrainer if cfg.ensemble_seeds > 1 else Trainer
    trainer = trainer_cls(cfg, train_loader, val_loader, eval_loader, device=device)
    trainer.train(resume=args.resume)
    return post_training_summary(trainer, eval_loader)


def main(argv=None) -> int:
    """Console entry point (``psla-torch-train``): setuptools wraps this in
    sys.exit(), so it returns 0 on success, not the summary dict."""
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
