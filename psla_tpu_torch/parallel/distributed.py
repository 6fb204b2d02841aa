"""Several processes as one run: start-up and the helpers at the host
boundary (port of ``psla_tpu/parallel/distributed.py``).

The reference has no multi-node path (its only parallelism is
single-process DataParallel, src/traintest.py:44-45). Here each rank is
one process with one card, in a ``torch.distributed`` group:

  * ``maybe_initialize()`` brings the group up, once, when the caller or a
    launcher (torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``) asks for
    it; otherwise it does nothing.
  * ``make_global_batch(batch, mesh)`` is this rank's share of the global
    batch: the loader of each rank already loads only its own rows
    (``data/loader.py``, sharded by (rank, world)).
  * ``allgather_host(x)`` gathers the ranks' eval rows so that every rank
    sees the whole eval set; rank 0 writes the artifacts.
  * ``broadcast_floats`` and ``barrier`` keep the ranks' host state in step.

Every helper is a collective at world > 1: every rank calls it, in the same
order. None falls back to one process when the group or a collective
fails.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from psla_tpu_torch.parallel.mesh import Mesh, drop_host_meta, shard_batch


def maybe_initialize(*, rank: int | None = None, world_size: int | None = None,
                     init_method: str | None = None, backend: str | None = None,
                     local_rank: int | None = None, device: str = "cuda") -> bool:
    """Start the default process group if a multi-process run is asked for.

    Opt-in: explicit ``world_size`` (with ``rank`` and ``init_method``), or
    a launcher's environment (``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR``,
    as torchrun sets them; ``init_method`` then defaults to ``env://``).
    Safe to call unconditionally: a single-process run returns False. The
    backend defaults to ``nccl`` for ``device`` 'cuda' and ``gloo`` for
    'cpu'. On the card, this rank's current device becomes
    ``cuda:{local_rank}`` (default ``LOCAL_RANK``, else 0). Returns True if
    the group is (now) up; a second call returns True."""
    if dist.is_initialized():
        return True
    env = os.environ
    launched = all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
    if world_size is None and not launched:
        return False
    if world_size is None:
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
    device_type = torch.device(device).type
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        if local_rank is None:
            local_rank = int(env.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size)
    return True


def process_info() -> tuple[int, int]:
    """(rank, world) of this process: (0, 1) without a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    return process_info()[0] == 0


def make_global_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's share of the global batch, without host metadata. At
    world 1 it is ``shard_batch`` (all rows). At world W the loader of each
    rank has loaded its own rows, which are the share: 'n_valid' stays on
    the host, since on a padded eval batch it differs from rank to rank."""
    if mesh.world == 1:
        return shard_batch(batch, mesh)
    return drop_host_meta(batch)


def _comm_device(x: torch.Tensor) -> torch.device:
    """Where a collective takes ``x``: NCCL takes tensors on the card only,
    gloo tensors anywhere."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return x.device


def allgather_host(x) -> np.ndarray:
    """Every rank's ``x`` (a tensor or an array, rows of the same shape on
    every rank) concatenated along the first axis in rank order, as a numpy
    array on every rank (JAX's tiled ``process_allgather``). World 1: ``x``
    itself."""
    t = torch.as_tensor(x)
    rank, world = process_info()
    if world == 1:
        return t.cpu().numpy()
    t = t.to(_comm_device(t)).contiguous()
    parts = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def broadcast_floats(values) -> np.ndarray:
    """Rank 0's small float vector on every rank (the other ranks' values are
    ignored; every rank passes one of the same shape). World 1: the values."""
    values = np.asarray(values, np.float32)
    if process_info()[1] == 1:
        return values
    t = torch.from_numpy(values.copy())
    t = t.to(_comm_device(t))
    dist.broadcast(t, src=0)
    return t.cpu().numpy()


def barrier(name: str):
    """Wait until every rank gets here (``sync_global_devices(name)``; the
    name marks the call site). A no-op at world 1."""
    if process_info()[1] > 1:
        dist.barrier()


def broadcast_tensors(tensors, mesh: Mesh):
    """Rank 0's values of ``tensors`` copied into every rank's, in place."""
    if mesh.world == 1:
        return
    for t in tensors:
        if t.device == _comm_device(t):
            dist.broadcast(t, src=0, group=mesh.group)
        else:
            tmp = t.to(_comm_device(t))
            dist.broadcast(tmp, src=0, group=mesh.group)
            t.copy_(tmp)
