"""Multi-model ensemble evaluation on the GPU (port of
``psla_tpu/tools/ensemble.py``; reference: src/ensemble/ensemble.py).

    python -m psla_tpu_torch.tools.ensemble m1.pth m2.pth ... \\
        --data-eval eval.json --label-csv labels.csv [--out-dir preds] \\
        [--sequential] [--device cuda] [--num-devices N]

Runs E checkpoints over an eval datafile, writes ``predictions_{i}.csv``
and ``target.csv``, and scores each member and the mean of their
predictions (mAP, mAUC, d') -- the protocol behind the paper's headline
ensemble mAP. A checkpoint is anything ``models.convert.load_variables``
reads: a reference ``.pth`` (``module.`` prefixes and ``_fc`` normalized),
the port's own, a training checkpoint directory, or an ``.npz`` of JAX
variables. Each member's pooling heads are read from its checkpoint;
``--att_head`` (the JAX tools' flag) checks each checkpoint's count.

The default is one STACKED pass: each batch is copied to the card once,
goes through the fbank kernel once, and then through the E member forwards
back to back (the eval half of ``psla_tpu/parallel/ensemble.py``,
``build_ensemble_eval_step``). ``--sequential`` runs E full passes, one
member on the card at a time, as the reference does. Members whose
state_dict keys or shapes differ are evaluated sequentially.

Several cards (``--num-devices N``, or torchrun's group): each rank holds
every member and evaluates its strided shard of the eval set, stacked or
sequential, with ``--batch-size`` / N rows a batch; the rows are gathered
into the dataset's order, and rank 0 writes the CSVs and prints the
scores. The JAX tool spreads each batch over every device the same way.
``--num-devices N`` without a launcher spawns N ranks on this host (NCCL
on the cards, gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
from typing import Mapping

import numpy as np
import torch

from psla_tpu_torch.config import PRESETS, ExperimentConfig, from_preset
from psla_tpu_torch.data.datafiles import load_datafile
from psla_tpu_torch.data.device_prefetch import prefetch_to_device
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig, preprocess_eval
from psla_tpu_torch.metrics import calculate_stats, d_prime
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import load_variables
from psla_tpu_torch.parallel.distributed import (
    gather_valid,
    is_primary,
    maybe_initialize,
    process_info,
    spawn,
)
from psla_tpu_torch.train.state import create_train_state, place_model
from psla_tpu_torch.train.step import _wav_batch, build_eval_step

# batches whose copy to the card runs ahead of the forward (the trainer's
# default, data/device_prefetch.py)
PREFETCH = 2


def head_num(state_dict: Mapping[str, torch.Tensor]) -> int:
    """The pooling heads of an EffNetAttention state_dict: H for per-head
    ``attention.att.{h}`` convs, 1 for one ``attention.att``, 0 for the
    mean pooling head (``models/effnet_att.py``)."""
    heads = {k.split(".")[2] for k in state_dict if k.startswith("attention.att.")}
    if "weight" in heads:
        return 1
    return len(heads)


def check_heads(ckpt: str, state_dict: Mapping[str, torch.Tensor], att_head: int | None,
                model_name: str = "efficientnet"):
    """Raise when ``att_head`` is given and the checkpoint's pooling heads
    (``head_num``) are another count. ResNet and MBNet are not checked:
    their heads are fixed and the JAX package ignores ``head_num`` for
    them."""
    if model_name != "efficientnet":
        return
    if att_head is not None and head_num(state_dict) != att_head:
        raise ValueError(f"{ckpt}: the checkpoint has {head_num(state_dict)} attention "
                         f"heads, --att_head asks for {att_head}")


def member_model(state_dict: Mapping[str, torch.Tensor], model_name: str, n_class: int,
                 eff_b: int) -> torch.nn.Module:
    """A float32 model holding ``state_dict`` (on the CPU, eval mode); the
    pooling heads are the checkpoint's (``create_model`` ignores them for
    ResNet and MBNet)."""
    model = create_model(model_name, label_dim=n_class, eff_b=eff_b,
                         head_num=head_num(state_dict))
    model.load_state_dict(state_dict)
    return model


def _batches(loader: AudioLoader, device: torch.device):
    return contextlib.closing(prefetch_to_device(iter(loader), device, depth=PREFETCH))


class _Rows:
    """The rows of an eval pass: each batch's rows with its padding mask,
    then every rank's valid rows in the dataset's order
    (``parallel.distributed.gather_valid``)."""

    def __init__(self, axis: int = 0):
        self.axis = axis
        self.preds, self.targets, self.valid = [], [], []

    def add(self, host_batch, pred: torch.Tensor):
        self.preds.append(pred)
        self.targets.append(host_batch["labels"])
        self.valid.append(np.arange(pred.shape[self.axis]) < int(host_batch["n_valid"]))

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        valid = np.concatenate(self.valid)
        return (gather_valid(torch.cat(self.preds, dim=self.axis), valid, self.axis),
                gather_valid(np.concatenate(self.targets), valid))


def predict(model: torch.nn.Module, loader: AudioLoader, pre_config: PreprocessConfig,
            device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """One model over a loader through the train package's eval step ->
    (predictions [N, C], targets [N, C]); padded rows past ``n_valid`` are
    dropped. On several ranks, every rank's shard in the dataset's order."""
    # the eval step reads the state's model and device only
    state = create_train_state(model, lambda step: 0.0, device=device)
    eval_step = build_eval_step(pre_config)
    rows = _Rows()
    with _batches(loader, state.device) as batches:
        for host_batch, batch in batches:
            out, _ = eval_step(state, batch)
            rows.add(host_batch, out)
    return rows.result()


@torch.inference_mode()
def predict_stacked(models: list[torch.nn.Module], loader: AudioLoader,
                    pre_config: PreprocessConfig, device: str | torch.device = "cuda"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """One pass for all E members -> (predictions [E, N, C], targets [N, C]).

    Each batch is copied to the card and through the fbank once; the E
    forwards then read the same log-mel one after another (none writes
    into it), so the peak memory stays near one member's activations. On
    several ranks, every rank's shard in the dataset's order."""
    device = torch.device(device)
    models = [place_model(m, device).eval() for m in models]
    eval_config = pre_config.eval_variant()
    rows = _Rows(axis=1)
    with _batches(loader, device) as batches:
        for host_batch, batch in batches:
            logmel = preprocess_eval(_wav_batch(batch, device), eval_config)
            rows.add(host_batch, torch.stack([m(logmel) for m in models]))
    return rows.result()


def scores(pred: np.ndarray, target: np.ndarray) -> tuple[float, float]:
    """(mAP, mAUC) of a prediction matrix."""
    stats = calculate_stats(pred, target)
    return (float(np.mean([s["AP"] for s in stats])),
            float(np.nanmean([s["auc"] for s in stats])))


def same_layout(state_dicts: list[Mapping[str, torch.Tensor]]) -> bool:
    """Whether every state_dict has the first one's keys and shapes."""
    first = {k: tuple(v.shape) for k, v in state_dicts[0].items()}
    return all({k: tuple(v.shape) for k, v in sd.items()} == first for sd in state_dicts[1:])


def ensemble_eval(
    checkpoints: list[str],
    loader: AudioLoader,
    pre_config: PreprocessConfig,
    model_name: str = "efficientnet",
    n_class: int = 527,
    eff_b: int = 2,
    out_dir: str | None = None,
    stacked: bool = True,
    device: str | torch.device = "cuda",
    att_head: int | None = None,
) -> dict:
    """Evaluate each checkpoint, then the mean of their predictions
    (ensemble.py:52-68). Returns per-model and ensemble mAP, mAUC and d'.
    ``att_head``, where given, must be every checkpoint's head count. On
    several ranks (``loader`` this rank's shard) every rank returns the
    scores of the whole set, and rank 0 prints them and writes the CSVs."""
    say = print if is_primary() else (lambda *a, **k: None)
    state_dicts = [load_variables(c) for c in checkpoints]
    for ckpt, sd in zip(checkpoints, state_dicts):
        check_heads(ckpt, sd, att_head, model_name)
    if stacked and not same_layout(state_dicts):
        say("checkpoint param trees differ; falling back to sequential")
        stacked = False

    def member(i: int) -> torch.nn.Module:
        return member_model(state_dicts[i], model_name, n_class, eff_b)

    if stacked:
        all_preds, target = predict_stacked(
            [member(i) for i in range(len(checkpoints))], loader, pre_config, device)
    summed = None
    per_model = []
    for i, ckpt in enumerate(checkpoints):
        if stacked:
            pred = all_preds[i]
        else:
            pred, target = predict(member(i), loader, pre_config, device)
        m, a = scores(pred, target)
        per_model.append({"ckpt": ckpt, "mAP": m, "mAUC": a, "d_prime": d_prime(a)})
        say(f"model {i} ({ckpt}): mAP {m:.6f} AUC {a:.6f}")
        if out_dir and is_primary():
            os.makedirs(out_dir, exist_ok=True)
            np.savetxt(os.path.join(out_dir, f"predictions_{i}.csv"), pred, delimiter=",")
            if i == 0:
                np.savetxt(os.path.join(out_dir, "target.csv"), target, delimiter=",")
        summed = pred if summed is None else summed + pred

    m, a = scores(summed / len(checkpoints), target)
    say(f"ensemble of {len(checkpoints)}: mAP {m:.6f} AUC {a:.6f} "
        f"d_prime {d_prime(a):.6f}")
    return {"models": per_model, "ensemble": {"mAP": m, "mAUC": a, "d_prime": d_prime(a)}}


# ------------------------------------------------------------------ CLI


def eval_parser(description: str) -> argparse.ArgumentParser:
    """The flags this tool and ``tools/weight_averaging.py`` share (the JAX
    tools' flags, and ``--device``)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("checkpoints", nargs="+",
                   help=".pth/.pt state_dicts (reference layout), training checkpoint "
                        "directories, or .npz of JAX variables")
    p.add_argument("--data-eval", required=True)
    p.add_argument("--label-csv", required=True)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None)
    p.add_argument("--model", default="efficientnet",
                   choices=["efficientnet", "resnet", "mbnet"])
    p.add_argument("--eff_b", type=int, default=2)
    p.add_argument("--att_head", type=int, default=None,
                   help="the checkpoints' attention heads (default: each checkpoint's "
                        "own; given, a checkpoint with another count is refused; not "
                        "read for resnet and mbnet)")
    p.add_argument("--n_class", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--target_length", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to evaluate on (cuda, cuda:1, cpu)")
    return p


def eval_setup(args, shard: bool = False) -> tuple[AudioLoader, PreprocessConfig, int]:
    """(eval loader, eval preprocessing, class count) from the shared flags.
    With ``shard``, on several ranks the loader is this rank's strided
    shard, and the batch size (the global batch) is split over the ranks."""
    cfg = from_preset(args.preset) if args.preset else ExperimentConfig()
    if args.target_length:
        cfg = dataclasses.replace(cfg, target_length=args.target_length)
    pre = cfg.preprocess_config().eval_variant()
    rank, world = process_info() if shard else (0, 1)
    batch_size = args.batch_size or cfg.batch_size
    if batch_size % world:
        raise ValueError(f"--batch-size {batch_size} is the global batch and is not "
                         f"divisible by the {world} ranks")
    loader = AudioLoader(
        load_datafile(args.data_eval, args.label_csv),
        LoaderConfig(batch_size=batch_size // world,
                     buffer_samples=pre.fbank.buffer_length(cfg.target_length),
                     drop_remainder=False, host_id=rank, num_hosts=world),
        shuffle=False,
    )
    return loader, pre, args.n_class or cfg.n_class


def build_parser() -> argparse.ArgumentParser:
    p = eval_parser(__doc__.split("\n")[0])
    p.add_argument("--out-dir", default=None)
    p.add_argument("--sequential", action="store_true",
                   help="one full eval pass per model (reference behavior) instead of "
                        "the stacked single-pass default")
    p.add_argument("--num-devices", type=int, default=None,
                   help="ranks that split the eval set, one card each: under torchrun its "
                        "world size (the default), else N > 1 spawns N ranks on this host")
    return p


def run(argv=None) -> dict:
    """Library entry: parse, evaluate and return ``ensemble_eval``'s scores
    (rank 0's, when it spawns ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    maybe_initialize(device=args.device)
    world = process_info()[1]
    if world == 1 and (args.num_devices or 1) > 1:
        return spawn(run, argv, args.num_devices, args.device)
    if args.num_devices is not None and args.num_devices != world:
        raise ValueError(f"--num-devices {args.num_devices} under a launcher's "
                         f"{world}-rank group: leave it out or give {world}")
    loader, pre, n_class = eval_setup(args, shard=True)
    return ensemble_eval(args.checkpoints, loader, pre, model_name=args.model,
                         n_class=n_class, eff_b=args.eff_b, out_dir=args.out_dir,
                         stacked=not args.sequential, device=args.device,
                         att_head=args.att_head)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
