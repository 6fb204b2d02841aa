"""The layout of a run over ranks (port of ``psla_tpu/parallel/mesh.py``).

The JAX package shards each batch over a ('data',) device mesh and lets
GSPMD derive the gradient all-reduce; an ensemble adds an 'ensemble' axis
in front, ``devices.reshape(ensemble, n / ensemble)``. Here a device is a
rank of the ``torch.distributed`` group, one card each, and the mesh is
what one rank sees of that grid: its row (the ensemble shard whose
members it trains) and, within the row, its position among the row's
``world`` ranks, which hold replicas of those members and split the
global batch into contiguous shares. The train step
(``train/step.build_train_step``) synchronizes BatchNorm's statistics and
averages the gradients over the row's group, so a step on a row of W ranks
computes the one-process step on the global batch up to the order of its
sums. Without ensembles there is one row of every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's row of ``world`` ranks, this process being ``rank``
    within it, on ``device``. ``group`` is the process group of the row's
    ranks (None at world 1). The row is number ``row`` of ``rows`` (the
    'ensemble' axis; 1 without ensembles), and rank ``rank`` of row ``row``
    is global rank ``row * world + rank``."""

    world: int
    rank: int
    device: torch.device
    group: dist.ProcessGroup | None = None
    rows: int = 1
    row: int = 0


def make_mesh(num_devices: int | None = None,
              device: str | torch.device = "cuda", ensemble: int = 1) -> Mesh:
    """This rank's mesh over every rank of the default process group (one
    rank, this process, when no group is up), split into ``ensemble`` rows
    of consecutive ranks (JAX's ``devices.reshape(ensemble, n /
    ensemble)``). ``device`` is this rank's card (a bare 'cuda' means the
    current one, which ``distributed.maybe_initialize`` sets to
    ``cuda:{LOCAL_RANK}``) or 'cpu'. ``num_devices`` defaults to the world
    size and may not exceed it.

    A collective at ``1 < ensemble < world``: every rank creates every
    row's group (``dist.new_group``), in row order, as NCCL and gloo need."""
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
    if world % ensemble:
        raise ValueError(f"{world} devices do not split into {ensemble} ensemble rows")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    per_row = world // ensemble
    if 1 < ensemble < world:
        groups = [dist.new_group(list(range(r * per_row, (r + 1) * per_row)))
                  for r in range(ensemble)]
        group = groups[rank // per_row]
    return Mesh(per_row, rank % per_row, device, group if per_row > 1 else None,
                rows=ensemble, row=rank // per_row)


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
