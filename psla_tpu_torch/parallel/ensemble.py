"""Multi-seed ensemble training: E independent seeds that advance in
lockstep, on one card or spread over ranks (port of
``psla_tpu/parallel/ensemble.py``).

The PSLA protocol's headline number is an ensemble of independently
trained models (reference README: 10 models -> 0.474 mAP; the reference
trains them as separate jobs). Here the E members share one data stream:
each train step takes one loader batch and runs every member's own step on
it, one after another, with the member's own draws (mixup, SpecAugment,
drop-connect), so each member makes its own fbank launch. The eval step
makes one fbank launch for all of them and runs the E eval forwards on the
same log-mel.

The JAX package stacks the members along a leading axis sharded over an
'ensemble' mesh axis and unrolls the members of a shard inside a
``shard_map`` (a ``vmap`` over the stacked kernels lowers to grouped
convolutions that XLA partitioned wrongly). The port is that unrolled
loop: a member is an ordinary ``TrainState`` whose step is the
single-model step. On W ranks ``ensemble_layout`` splits the ranks into
rows (``parallel.mesh.make_mesh(..., ensemble=rows)``): row r holds
members r * E_local .. (r + 1) * E_local - 1 (E_local = E / rows), each
replicated over the row's ranks and trained data-parallel over them on the
global batch, which every row sees whole.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable, Mapping, Sequence

import torch

from psla_tpu_torch.frontend.pipeline import PreprocessConfig, preprocess_eval
from psla_tpu_torch.parallel.distributed import broadcast_tensors, gather_rows
from psla_tpu_torch.parallel.mesh import Mesh
from psla_tpu_torch.train.optim import per_sample_loss
from psla_tpu_torch.train.state import TrainState, create_train_state, replicate_state
from psla_tpu_torch.train.step import TrainDraws, _wav_batch, build_train_step


def ensemble_layout(num_seeds: int, n_devices: int, host_id: int = 0,
                    num_hosts: int = 1) -> tuple[int, int, int]:
    """The 'ensemble' axis's shard count and the host's share of the data
    stream for an E-seed ensemble on ``n_devices`` across ``num_hosts``:
    ``(e_shards, loader_host_id, loader_num_hosts)``.

    ``e_shards`` is the largest common divisor of (num_seeds, n_devices)
    whose rows align with host boundaries (whole host groups per row, or
    whole rows per host); the remaining members of a shard run one after
    another. 1 always qualifies, so any seed count runs on any topology.
    The batch is the same on every row, so a host feeds its position
    within its row; a host that holds whole rows feeds the full stream.
    On one card this is ``(1, 0, 1)``: every member is local. The port
    runs a rank a card, so it calls this with ``(E, W, rank, W)``: rows of
    W / e_shards ranks, and a rank feeds position ``rank % (W /
    e_shards)``."""
    e = math.gcd(num_seeds, n_devices)
    while num_hosts % e and e % num_hosts:
        e -= 1
        while num_seeds % e or n_devices % e:
            e -= 1
    if num_hosts > e:
        hosts_per_row = num_hosts // e
        return e, host_id % hosts_per_row, hosts_per_row
    return e, 0, 1


@dataclasses.dataclass
class EnsembleState:
    """This rank's members' ``TrainState``s (model, Adam, schedule), stepped
    in lockstep: every member's ``step`` is the ensemble's. ``mesh`` is the
    ensemble mesh the members were placed on (None: one process, every
    member local); its row ``mesh.row`` holds the members
    ``local_members(E, mesh)``."""

    members: list[TrainState]
    mesh: Mesh | None = None

    @property
    def step(self) -> int:
        return self.members[0].step

    @property
    def device(self) -> torch.device:
        return self.members[0].device


def local_members(num_seeds: int, mesh: Mesh | None) -> range:
    """The global indices of the members that ``mesh``'s row holds."""
    rows, row = (mesh.rows, mesh.row) if mesh else (1, 0)
    if num_seeds % rows:
        raise ValueError(f"{num_seeds} ensemble members do not split over {rows} rows")
    e_local = num_seeds // rows
    return range(row * e_local, (row + 1) * e_local)


def init_ensemble_state(new_model: Callable[[int], torch.nn.Module], seeds: Sequence[int],
                        schedule: Callable[[int], float], step: int = 0,
                        device: str | torch.device = "cuda",
                        mesh: Mesh | None = None) -> EnsembleState:
    """One member per seed: ``new_model(seed)`` (a fresh initialisation from
    that seed), on ``device`` with a fresh Adam (``create_train_state``).
    With a ``mesh``, ``seeds`` are its row's members'; place them on the
    row with ``place_members``."""
    return EnsembleState([create_train_state(new_model(s), schedule, step=step, device=device)
                          for s in seeds], mesh)


def place_members(state: EnsembleState) -> EnsembleState:
    """Each member replicated over its row (``train.state.replicate_state``
    on the row's mesh: the row's first rank's values, BatchNorms synced over
    the row's group). A no-op on a row of one rank."""
    if state.mesh is not None:
        for m in state.members:
            replicate_state(m, state.mesh)
    return state


def _member_tensors(payload: dict) -> list[torch.Tensor]:
    """The tensors of a member's checkpoint payload, in a fixed order."""
    tensors = list(payload["model"].values())
    for moments in payload["optimizer"]["state"].values():
        tensors.extend(v for v in moments.values() if torch.is_tensor(v))
    return tensors


def _payload(member: TrainState) -> dict:
    return {"step": int(member.step), "model": member.model.state_dict(),
            "optimizer": member.optimizer.state_dict()}


def ensemble_member(state: EnsembleState, i: int) -> dict:
    """Member ``i``'s checkpoint payload ({"step", "model": its state_dict,
    "optimizer": its Adam state_dict}, what ``train.loop.Trainer`` writes)
    on every rank. Across ranks it is gathered from the first rank of the
    row that holds it: a collective, which every rank calls in the same
    order (JAX ``psla_tpu/parallel/ensemble.py``, ``ensemble_member``).
    Every member has the same architecture and has taken the same steps,
    so a rank receives into a copy of its own first member's payload."""
    if state.mesh is None or state.mesh.rows == 1:
        return _payload(state.members[i])
    e_local = len(state.members)
    holder = i // e_local * state.mesh.world  # the global rank
    if i // e_local == state.mesh.row:
        payload = _payload(state.members[i % e_local])
    else:
        payload = copy.deepcopy(_payload(state.members[0]))
    broadcast_tensors(_member_tensors(payload), src=holder)
    return payload


def gather_seeds(local: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """[E, ...]: every member's value from the rows' [E_local, ...] values,
    in member order, each from the rank at this rank's position in its row
    (which holds the same data rows). No host sync; a collective over every
    rank when there are several rows."""
    if mesh is None or mesh.rows == 1:
        return local
    return gather_rows(local)[mesh.rank::mesh.world].reshape(-1, *local.shape[1:])


def make_ensemble_train_step(pre_config: PreprocessConfig, loss_type: str = "BCE",
                             mesh: Mesh | None = None
                             ) -> Callable[[EnsembleState, Mapping, Sequence[TrainDraws]],
                                           tuple[EnsembleState, dict]]:
    """Returns step(state, batch, draws) -> (state, {"loss", "seed_loss"}):
    every local member's single-model train step (``build_train_step`` on
    the row's ``mesh``) on the shared batch with its own draws ``draws[m]``,
    in member order. The batch crosses to the card once. ``loss`` is the
    mean over all E seeds (a 0-d tensor on the card: a diverged member
    makes it NaN), ``seed_loss`` the E members' losses [E], on every rank
    (JAX's ``pmean`` over 'ensemble'). No host sync.

    With a ``mesh``, ``batch`` is this rank's share of the global batch (the
    row's ranks split it) and ``draws`` are the local members' draws for
    the global batch."""
    core = build_train_step(pre_config, loss_type, mesh)

    def step(state: EnsembleState, batch: Mapping, draws: Sequence[TrainDraws]):
        if len(draws) != len(state.members):
            raise ValueError(f"{len(draws)} draws for {len(state.members)} members")
        shared = _wav_batch(batch, state.device)._asdict()
        seed_loss = gather_seeds(torch.stack([core(member, shared, d)[1]["loss"]
                                              for member, d in zip(state.members, draws)]),
                                 mesh)
        return state, {"loss": seed_loss.mean(), "seed_loss": seed_loss}

    return step


def make_ensemble_eval_step(pre_config: PreprocessConfig, loss_type: str = "BCE"
                            ) -> Callable[[EnsembleState, Mapping],
                                          tuple[torch.Tensor, torch.Tensor]]:
    """Returns eval_step(state, batch) -> (probs [E_local, B, C], per-sample
    loss [E_local, B]): the batch through the eval preprocessing once (one
    fbank launch whatever E), then the local members' eval forwards one
    after another on that log-mel (none writes into it). It needs no
    collective: the caller gathers the rows
    (``train.ensemble_loop.EnsembleTrainer.validate``)."""
    eval_config = pre_config.eval_variant()

    @torch.inference_mode()
    def eval_step(state: EnsembleState, batch: Mapping):
        wb = _wav_batch(batch, state.device)
        logmel = preprocess_eval(wb, eval_config)
        probs = torch.stack([m.model.eval()(logmel) for m in state.members])
        losses = torch.stack([per_sample_loss(p, wb.labels, loss_type) for p in probs])
        return probs, losses

    return eval_step
