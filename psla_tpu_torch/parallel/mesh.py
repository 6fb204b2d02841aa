"""The data-parallel layout of a run (port of ``psla_tpu/parallel/mesh.py``).

The JAX package shards each batch over a ('data',) device mesh and lets
GSPMD derive the gradient all-reduce. Here the mesh is the
``torch.distributed`` process group: one rank a card, each rank holding a
replica of the model and its contiguous share of the global batch. The
train step (``train/step.build_train_step``) synchronizes BatchNorm's
statistics and averages the gradients over the group, so a step on W ranks
computes the one-process step on the global batch up to the order of its
sums. There is no 'ensemble' axis yet: members across ranks are ROADMAP.md,
Queue 1, item 6b.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``world`` ranks, this process being ``rank``, on ``device``. ``group``
    is the process group of the ranks (None at world 1)."""

    world: int
    rank: int
    device: torch.device
    group: dist.ProcessGroup | None = None


def make_mesh(num_devices: int | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of every rank of the default process group (one rank, this
    process, when no group is up). ``device`` is this rank's card (a bare
    'cuda' means the current one, which ``distributed.maybe_initialize``
    sets to ``cuda:{LOCAL_RANK}``) or 'cpu'. ``num_devices`` defaults to
    the world size and may not exceed it."""
    if dist.is_available() and dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), dist.group.WORLD
    else:
        world, rank, group = 1, 0, None
    if num_devices is not None:
        if num_devices > world:
            raise ValueError(
                f"requested num_devices={num_devices} but only "
                f"{world} devices are visible"
            )
        if num_devices < world:
            raise ValueError(
                f"requested num_devices={num_devices} of a {world}-rank group: a mesh "
                "spans every rank")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(world, rank, device, group if world > 1 else None)


def drop_host_meta(batch: Mapping) -> dict:
    """A loader batch without its host-side metadata ('n_valid', the count
    of rows that are not padding): read only by the host loops, and on a
    padded eval batch different on every rank."""
    return {k: v for k, v in batch.items() if k != "n_valid"}


def shard_batch(batch: Mapping, mesh: Mesh) -> dict:
    """This rank's contiguous rows of a global host batch (numpy arrays or
    tensors): rows ``[rank * b, (rank + 1) * b)``, ``b = rows / world``.
    Scalars are kept whole; host metadata is dropped."""
    batch = drop_host_meta(batch)
    rows = next(np.shape(v)[0] for v in batch.values() if np.ndim(v) > 0)
    if rows % mesh.world:
        raise ValueError(
            f"batch size {rows} is not divisible by the {mesh.world}-device "
            f"'data' mesh axis; pick a batch size that is a multiple of the "
            f"device count"
        )
    b = rows // mesh.world
    lo = mesh.rank * b
    return {k: v if np.ndim(v) == 0 else v[lo:lo + b] for k, v in batch.items()}
