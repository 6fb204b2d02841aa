"""One rank of the two-rank world of tests/test_torch_distributed.py.

``run_rank`` joins a gloo group at a file store and runs every world-2
check of that file once: the collectives, the synced BatchNorm, the
data-parallel train step in float64, float32 and bfloat16, the eval gather of
``Trainer.validate`` and a whole ``cli.run``. It saves its results to
``{out_dir}/rank{rank}.pt`` for the tests to read. The functions that take
a ``mesh`` also compute the one-process references (at world 1) in the test
process. This module imports torch and the port only, so a spawned rank
starts without JAX.
"""

from __future__ import annotations

import builtins
import os

import numpy as np
import torch

from psla_tpu_torch import cli
from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.layers import BatchNorm
from psla_tpu_torch.parallel import distributed
from psla_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from psla_tpu_torch.train.loop import Trainer
from psla_tpu_torch.train.state import create_train_state, replicate_state
from psla_tpu_torch.train.step import build_train_step, draw_train, step_generator


def warm_cpu_log():
    """One float32 ``torch.log`` on every intra-op thread of this process,
    before any step whose bits are compared across processes. On a loaded
    machine the first float32 log a CPU thread computes can be off by up to
    ~40 ulp on that thread's whole chunk (4.0e-5 in the log-mel, caught in
    a rank's first ``preprocess_train``; every later log of the same input
    is correctly rounded but for 1 of 16384 values), which the float64
    step's 1e-10 bar sees; one log on each thread first keeps every
    compared log-mel correctly rounded."""
    x = torch.rand(4096 * torch.get_num_threads(), generator=torch.Generator().manual_seed(0))
    torch.log(x + 1e-3)


def batchnorm(spec: dict, mesh: Mesh, dtype: torch.dtype = torch.float32) -> dict:
    """A train-mode ``BatchNorm`` on this rank's rows of ``spec["bn_x"]``
    (NCHW) in ``dtype``, backward from sum(y * bn_g): its output, input
    gradient, parameter gradients (this rank's sums) and running
    statistics."""
    x, g = (shard_batch({"x": spec[k]}, mesh)["x"] for k in ("bn_x", "bn_g"))
    bn = BatchNorm(x.shape[1])
    bn.load_state_dict(spec["bn_state"])
    bn.train()
    bn.group = mesh.group
    x = torch.from_numpy(x).to(dtype).requires_grad_()
    y = bn(x)
    (y.float() * torch.from_numpy(g)).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def train_steps(spec: dict, mesh: Mesh, dtype: torch.dtype, remat: bool = False) -> dict:
    """The global batches of the spec's case for ``dtype`` through
    ``build_train_step`` on ``mesh``, from the case's weights, in ``dtype``,
    with mixup, SpecAugment and drop-connect (``remat``: each MBConv block's
    forward replayed in backward): each step's losses and the final
    state_dict, and the running statistics after the first step. A
    bfloat16 model keeps float32 parameters (``--dtype bfloat16``)."""
    case = spec["cases"][str(dtype).removeprefix("torch.")]
    cfg = PreprocessConfig(target_length=spec["T"], **case["aug"])
    model = create_model("efficientnet", label_dim=case["n_class"], eff_b=0,
                         head_num=case["heads"], bn_momentum=case["bn_momentum"], dtype=dtype,
                         remat=remat)
    model.load_state_dict(case["state_dict"])
    if dtype != torch.bfloat16:
        model.to(dtype)
    state = create_train_state(model, lambda step: case["lr"], device="cpu")
    state = replicate_state(state, mesh)
    step = build_train_step(cfg, "BCE", mesh)
    losses, first_stats = [], None
    for i, batch in enumerate(case["batches"]):
        draws = draw_train(step_generator(0, i, "cpu"), model, len(batch["wav"]), cfg)
        state, metrics = step(state, shard_batch(batch, mesh), draws)
        losses.append(metrics["loss"])
        if first_stats is None:
            first_stats = {k: v.clone() for k, v in model.state_dict().items()
                           if k.endswith(("running_mean", "running_var"))}
    return {"loss": torch.stack(losses), "state": model.state_dict(),
            "first_stats": first_stats}


def validate(spec: dict, exp_dir: str) -> dict:
    """``Trainer.validate`` on the spec's val set from the spec's weights,
    with this process's loaders (``cli.make_loaders``: its shard): the
    mAP, the loss and (rank 0) the predictions it wrote."""
    cfg = ExperimentConfig(**spec["trainer_config"], exp_dir=exp_dir)
    train_loader, val_loader, _ = cli.make_loaders(cfg)
    trainer = Trainer(cfg, train_loader, val_loader, device="cpu")
    state = trainer._state_from({"step": 0, "model": spec["state_dict"]})
    stats, loss = trainer.validate(state, val_loader, 1)
    out = {"mAP": float(np.mean([s["AP"] for s in stats])), "loss": loss}
    if distributed.is_primary():
        out["pred"] = np.loadtxt(os.path.join(exp_dir, "predictions", "predictions_1.csv"),
                                 delimiter=",")
    return out


def audited_run(argv: list[str], exp_dir: str) -> dict:
    """``cli.run(argv)``, recording every file under ``exp_dir`` that this
    process opens for writing."""
    written = []
    real_open, real_save = builtins.open, torch.save

    def record(file):
        if isinstance(file, (str, os.PathLike)):
            path = os.path.abspath(os.fspath(file))
            if path.startswith(exp_dir):
                written.append(os.path.relpath(path, exp_dir))

    def audited_open(file, mode="r", *args, **kwargs):
        if set(mode) & set("wax+"):
            record(file)
        return real_open(file, mode, *args, **kwargs)

    def audited_save(obj, f, *args, **kwargs):  # torch writes a path from C++
        record(f)
        return real_save(obj, f, *args, **kwargs)

    builtins.open, torch.save = audited_open, audited_save
    try:
        summary = cli.run(argv)
    finally:
        builtins.open, torch.save = real_open, real_save
    return {"summary": summary, "written": written}


def run_rank(rank: int, world: int, init_method: str, spec_path: str, out_dir: str):
    torch.set_num_threads(2)
    warm_cpu_log()
    assert distributed.maybe_initialize(rank=rank, world_size=world, init_method=init_method,
                                        device="cpu")
    assert distributed.maybe_initialize()  # a second call
    try:
        spec = torch.load(spec_path, weights_only=False)
        mesh = make_mesh(device="cpu")
        out = {
            "process_info": distributed.process_info(),
            "mesh": (mesh.world, mesh.rank),
            "gathered": distributed.allgather_host(np.full((2, 3), rank, np.float32)),
            "gathered_mask": distributed.allgather_host(np.arange(3) < rank + 1),
            "broadcast": distributed.broadcast_floats([rank + 0.5, -rank]),
            "batchnorm": batchnorm(spec, mesh),
            "batchnorm_bf16": batchnorm(spec, mesh, torch.bfloat16),
            "float64": train_steps(spec, mesh, torch.float64),
            "float32": train_steps(spec, mesh, torch.float32),
            "bfloat16": train_steps(spec, mesh, torch.bfloat16),
            "float64_remat": train_steps(spec, mesh, torch.float64, remat=True),
            "validate": validate(spec, spec["validate_dir"]),
            "cli": audited_run(spec["cli_argv"], spec["cli_dir"]),
        }
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()
