"""One rank of the gloo worlds of tests/test_torch_ensemble_ranks.py.

``run_rank`` joins a gloo group of 2 or 4 ranks at a file store and runs
that world's checks once. The 2-rank world trains the float64 ensemble at
E = 3, 2 and 4 (one row of both ranks, two rows of one member, two rows of
two members), then runs ``cli.run --ensemble-seeds 2`` for an epoch, its
resume to a second, the resume of a one-process run's first epoch, and
``tools/ensemble``. The 4-rank world trains E = 2 on two rows of two
ranks, runs ``held_steps`` (E = 2 in float32 on the draws of the JAX
package's sharded step), then builds the trainer on loaders sharded by the
global rank. Each rank saves its results to
``{out_dir}/world{W}_rank{r}.pt``.
``ensemble_steps`` also computes the one-process references (at world 1)
in the test process. This module imports torch and the port only, so a
spawned rank starts without JAX.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import time

import numpy as np
import torch

from psla_tpu_torch import cli
from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.parallel import distributed
from psla_tpu_torch.parallel.ensemble import (
    EnsembleState,
    ensemble_layout,
    ensemble_member,
    local_members,
    make_ensemble_train_step,
    place_members,
)
from psla_tpu_torch.parallel.mesh import make_mesh, shard_batch
from psla_tpu_torch.tools import ensemble as ensemble_tool
from psla_tpu_torch.train.ensemble_loop import EnsembleTrainer
from psla_tpu_torch.train.state import create_train_state
from tests.torch_distributed_worker import audited_run, warm_cpu_log

# the seed counts each world trains
LAYOUTS = {2: (3, 2, 4), 4: (2,)}


class Float64Ensemble(EnsembleTrainer):
    """The ensemble trainer on float64 models (parameters, statistics and
    compute), so that a step on several ranks differs from one process only
    by the order of its float64 sums."""

    def _new_model(self, seed=None):
        return super()._new_model(seed).double()


def ensemble_steps(spec: dict, num_seeds: int, exp_dir: str) -> dict:
    """``spec["batches"]`` through ``EnsembleTrainer``'s steps on this
    process's group, from ``init_state``, then its validation: the losses,
    the stacked members after each step (gathered), this rank's own
    members, and (rank 0) the prediction files it wrote."""
    cfg = ExperimentConfig(**spec["trainer_config"], ensemble_seeds=num_seeds,
                           dtype="float64", exp_dir=exp_dir)
    train_loader, val_loader, _ = cli.make_loaders(cfg)
    trainer = Float64Ensemble(cfg, train_loader, val_loader, device="cpu")
    state = trainer.init_state()
    trainer.model = state.members[0].model
    losses, seed_losses, stacked = [], [], []
    for batch in spec["batches"]:
        draws = trainer.draws(state.step, len(batch["wav"]))
        state, metrics = trainer.train_step(state, shard_batch(batch, trainer.mesh), draws)
        losses.append(metrics["loss"])
        seed_losses.append(metrics["seed_loss"])
        stacked.append(trainer._stacked(
            [ensemble_member(state, i) for i in range(num_seeds)])["model"])
    stats, loss = trainer.validate(state, val_loader, 1)
    out = {"loss": torch.stack(losses), "seed_loss": torch.stack(seed_losses),
           "stacked": stacked, "row": trainer.mesh.row, "members": list(trainer.members),
           "local": [{k: v.clone() for k, v in m.model.state_dict().items()}
                     for m in state.members],
           "val_mAP": float(np.mean([s["AP"] for s in stats])), "val_loss": loss}
    if distributed.is_primary():
        pred_dir = os.path.join(exp_dir, "predictions")
        out["pred"] = np.stack([np.loadtxt(os.path.join(pred_dir, f"predictions_1_seed{i}.csv"),
                                           delimiter=",") for i in range(num_seeds)])
        out["mean_pred"] = np.loadtxt(os.path.join(pred_dir, "predictions_1.csv"),
                                      delimiter=",")
    return out


def cli_argv(spec: dict, exp_dir: str, epochs: int, *extra) -> list[str]:
    """``--ensemble-seeds 2`` on B0 (one head, T=64) at global batch 4, with
    mixup, SpecAugment and drop-connect, weight averaging over every epoch,
    on the CPU."""
    train, val, label_csv = spec["corpus"]
    return ["--data-train", train, "--data-val", val, "--label-csv", label_csv,
            "--exp-dir", exp_dir, "--n_class", str(spec["n_class"]), "--eff_b", "0",
            "--att_head", "1", "--target_length", str(spec["T"]), "-b", "4", "-w", "1",
            "--lr", "1e-3", "--n-epochs", str(epochs), "--wa_start", "1", "--wa_end",
            str(epochs), "--warmup", "False", "--impretrain", "False", "--mixup", "0.5",
            "--freqm", "8", "--timem", "8", "--ensemble-seeds", "2", "--device", "cpu",
            *extra]


def wait_for(path: str, seconds: float = 600):
    """Wait until the test process has written ``path``."""
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the test process never wrote {path}")
        time.sleep(0.1)


def cli_runs(spec: dict) -> dict:
    """``cli.run --ensemble-seeds 2`` under this group (a launcher's path):
    one epoch, audited; its resume to two epochs; the resume of the
    one-process run's first epoch to two, and ``tools/ensemble`` on that
    run's best members, once the test process has written them. Rank 0
    keeps a copy of the first epoch for the test process to resume at
    world 1."""
    exp, copies = spec["cli_dir"], spec["cli_copies"]
    out = {"first": audited_run(cli_argv(spec, exp, 1), exp)}
    if distributed.is_primary():
        shutil.copytree(exp, copies["ranks_epoch1"])
    distributed.barrier("copied")
    out["resumed"] = cli.run(cli_argv(spec, exp, 2, "--resume"))
    wait_for(os.path.join(copies["one_epoch1"], "DONE"))
    out["from_one_process"] = cli.run(cli_argv(spec, copies["one_epoch1"], 2, "--resume"))
    out["tool"] = ensemble_tool.run(spec["tool_argv"])
    return out


def refused_loaders(spec: dict, exp_dir: str) -> str:
    """``EnsembleTrainer``'s error for E=2 with loaders sharded by the global
    rank instead of the position within the row."""
    cfg = ExperimentConfig(**spec["trainer_config"], ensemble_seeds=2, exp_dir=exp_dir)
    loaders = cli.make_loaders(cfg)[:2]
    rank, world = distributed.process_info()
    for loader in loaders:
        loader.config = dataclasses.replace(loader.config, host_id=rank, num_hosts=world)
    try:
        EnsembleTrainer(cfg, *loaders, device="cpu")
    except ValueError as e:
        return str(e)
    return ""


def held_steps(spec: dict) -> dict:
    """E = 2 on this world's rows (``ensemble_layout``, ``make_mesh``,
    ``local_members``, ``place_members``, ``make_ensemble_train_step``),
    float32, drop-connect off, from the test process's file: each member's
    weights (the JAX package's variables of its seed) and, for each step,
    every member's draws as JAX's sharded step derives them; a rank takes
    its local members' by their global indices. The seed losses and the mean
    loss of each step."""
    wait_for(spec["held_path"])
    held = torch.load(spec["held_path"], weights_only=False)
    rank, world = distributed.process_info()
    mesh = make_mesh(device="cpu", ensemble=ensemble_layout(2, world, rank, world)[0])
    members = local_members(2, mesh)
    models = [create_model("efficientnet", label_dim=spec["n_class"], eff_b=0,
                           head_num=held["heads"], drop_connect_rate=0.0) for _ in members]
    for model, i in zip(models, members):
        model.load_state_dict(held["state_dicts"][i])
    state = place_members(EnsembleState(
        [create_train_state(m, lambda step: held["lr"], device="cpu") for m in models], mesh))
    step = make_ensemble_train_step(PreprocessConfig(target_length=spec["T"], **held["aug"]),
                                    "BCE", mesh)
    losses, seed_losses = [], []
    for batch, draws in zip(held["batches"], held["draws"]):
        state, metrics = step(state, shard_batch(batch, mesh), [draws[i] for i in members])
        losses.append(metrics["loss"])
        seed_losses.append(metrics["seed_loss"])
    return {"loss": torch.stack(losses), "seed_loss": torch.stack(seed_losses)}


def run_rank(rank: int, world: int, init_method: str, spec_path: str, out_dir: str):
    torch.set_num_threads(1)
    warm_cpu_log()
    assert distributed.maybe_initialize(rank=rank, world_size=world, init_method=init_method,
                                        device="cpu")
    try:
        spec = torch.load(spec_path, weights_only=False)
        out = {e: ensemble_steps(spec, e, os.path.join(out_dir, f"steps_e{e}_w{world}"))
               for e in LAYOUTS[world]}
        if world == 2:
            out["cli"] = cli_runs(spec)
        else:
            out["held"] = held_steps(spec)
            out["refused"] = refused_loaders(spec, os.path.join(out_dir, "refused"))
        torch.save(out, os.path.join(out_dir, f"world{world}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
