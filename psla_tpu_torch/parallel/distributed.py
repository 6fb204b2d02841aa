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
  * ``allgather_host(x)`` concatenates the ranks' rows, and
    ``gather_valid`` gathers an eval pass's rows so that every rank sees
    the whole eval set in the dataset's order; rank 0 writes the
    artifacts.
  * ``broadcast_floats`` and ``barrier`` keep the ranks' host state in step;
    ``broadcast_tensors`` copies one rank's tensors into the others' and
    ``gather_rows`` gathers a tensor on the devices.
  * ``spawn(entry, argv, world, device)`` runs an entry point on ``world``
    ranks started on this host, when no launcher started them.

Every helper is a collective at world > 1: every rank calls it, in the same
order. None falls back to one process when the group or a collective
fails.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing

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


def gather_valid(rows, valid, axis: int = 0, mesh: Mesh | None = None) -> np.ndarray:
    """The valid rows of an eval pass over a dataset, every rank's, in the
    dataset's order, as a numpy array on every rank. ``rows`` (a tensor or
    an array) are this rank's along ``axis``: its loader's shard, padded
    rows included, so that every rank gathers the same shapes; ``valid``
    marks the real ones. The ranks are ``mesh``'s row (default: every
    rank). A sequential loader shard is strided (``data/loader.py``): the
    j-th row of the rank at position p of R is the dataset's row R * j + p,
    so the gathered [P, R] rows come in order. One rank: ``rows[valid]``."""
    world, group = (process_info()[1], None) if mesh is None else (mesh.world, mesh.group)
    rows = torch.as_tensor(rows).movedim(axis, 0)
    valid = np.asarray(valid)
    if world > 1:
        parts = []
        for t in (rows, torch.as_tensor(valid)):
            t = t.to(_comm_device(t)).contiguous()
            gathered = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(gathered, t, group=group)
            parts.append(torch.stack(gathered, dim=1).flatten(0, 1))
        rows, valid = parts[0], parts[1].cpu().numpy()
    return np.moveaxis(rows.cpu().numpy()[valid], 0, axis)  # one fetch a pass


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """[world, *t.shape]: every rank's ``t`` in the rank order of ``group``
    (default: every rank), by one sum all-reduce of zero-padded rows
    (exact: each element is one rank's value plus zeros), which NCCL and
    gloo take for tensors on the card and on the CPU alike. No host sync."""
    out = t.new_zeros((dist.get_world_size(group), *t.shape))
    out[dist.get_rank(group)] = t
    dist.all_reduce(out, group=group)
    return out


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


def broadcast_tensors(tensors, mesh: Mesh | None = None, src: int = 0):
    """The values of ``tensors`` on rank ``src`` of the mesh's row (its
    position there) copied into every rank's of the row, in place; with no
    ``mesh``, global rank ``src``'s into every rank's. One collective for
    each dtype and device: the tensors travel as one flat buffer."""
    if mesh is None:
        group, root = None, src
        if process_info()[1] == 1:
            return
    else:
        if mesh.world == 1:
            return
        group, root = mesh.group, dist.get_global_rank(mesh.group, src)
    tensors = list(tensors)
    for key in dict.fromkeys((t.dtype, _comm_device(t)) for t in tensors):
        same = [t for t in tensors if (t.dtype, _comm_device(t)) == key]
        flat = torch.cat([t.reshape(-1).to(key[1]) for t in same])
        dist.broadcast(flat, src=root, group=group)
        offset = 0
        for t in same:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def _rank_main(rank: int, entry: Callable[[list[str]], dict], world: int,
               init_method: str, device: str, argv: list[str], result_path: str):
    """One spawned rank: join the group, run ``entry(argv)``, and (rank 0)
    write its result. The ranks share the host's cores: each takes its
    share of the intra-op threads a process would take alone
    (``OMP_NUM_THREADS``, else the cores)."""
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    maybe_initialize(rank=rank, world_size=world, init_method=init_method,
                     local_rank=rank, device=device)
    try:
        result = entry(argv)
        if rank == 0:
            with open(result_path, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(entry: Callable[[list[str]], dict], argv: list[str], world: int,
          device: str) -> dict:
    """``entry(argv)`` (a module-level function that returns a JSON-able
    dict) on ``world`` ranks spawned on this host (one card each), meeting
    at a file store; rank 0's result. A rank that fails fails the run
    (``torch.multiprocessing.spawn`` stops the others and raises)."""
    if torch.device(device).type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"requested num_devices={world} but only "
                         f"{torch.cuda.device_count()} devices are visible")
    with tempfile.TemporaryDirectory() as tmp:
        result_path = os.path.join(tmp, "result.json")
        torch.multiprocessing.spawn(
            _rank_main, nprocs=world, join=True,
            args=(entry, world, "file://" + os.path.join(tmp, "store"), device, argv,
                  result_path))
        with open(result_path) as f:
            return json.load(f)
