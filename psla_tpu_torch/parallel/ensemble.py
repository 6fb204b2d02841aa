"""Multi-seed ensemble training: E independent seeds that advance in
lockstep on one card (port of ``psla_tpu/parallel/ensemble.py``).

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
convolutions that XLA partitioned wrongly). On one card the port is that
unrolled loop: a member is an ordinary ``TrainState`` whose step is the
single-model step. ``ensemble_layout`` is kept for ensembles across
ranks (ROADMAP.md, Queue 1, item 6b), which place the members on ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import torch

from psla_tpu_torch.frontend.pipeline import PreprocessConfig, preprocess_eval
from psla_tpu_torch.train.optim import per_sample_loss
from psla_tpu_torch.train.state import TrainState, create_train_state
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
    On one card this is ``(1, 0, 1)``: every member is local."""
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
    """E members' ``TrainState``s (model, Adam, schedule), stepped in
    lockstep: every member's ``step`` is the ensemble's."""

    members: list[TrainState]

    @property
    def step(self) -> int:
        return self.members[0].step

    @property
    def device(self) -> torch.device:
        return self.members[0].device


def init_ensemble_state(new_model: Callable[[int], torch.nn.Module], seeds: Sequence[int],
                        schedule: Callable[[int], float], step: int = 0,
                        device: str | torch.device = "cuda") -> EnsembleState:
    """One member per seed: ``new_model(seed)`` (a fresh initialisation from
    that seed), on ``device`` with a fresh Adam (``create_train_state``)."""
    return EnsembleState([create_train_state(new_model(s), schedule, step=step, device=device)
                          for s in seeds])


def ensemble_member(state: EnsembleState, i: int) -> TrainState:
    """Member ``i``'s state, a plain single-model ``TrainState`` (for its
    checkpoint extract or a single-model eval)."""
    return state.members[i]


def make_ensemble_train_step(pre_config: PreprocessConfig, loss_type: str = "BCE"
                             ) -> Callable[[EnsembleState, Mapping, Sequence[TrainDraws]],
                                           tuple[EnsembleState, dict]]:
    """Returns step(state, batch, draws) -> (state, {"loss", "seed_loss"}):
    every member's single-model train step (``build_train_step``) on the
    shared batch with its own draws ``draws[m]``, in member order. The batch
    crosses to the card once. ``loss`` is the mean over the seeds (a 0-d
    tensor on the card: a diverged member makes it NaN), ``seed_loss`` the
    members' losses [E]. No host sync."""
    core = build_train_step(pre_config, loss_type)

    def step(state: EnsembleState, batch: Mapping, draws: Sequence[TrainDraws]):
        if len(draws) != len(state.members):
            raise ValueError(f"{len(draws)} draws for {len(state.members)} members")
        shared = _wav_batch(batch, state.device)._asdict()
        seed_loss = torch.stack([core(member, shared, d)[1]["loss"]
                                 for member, d in zip(state.members, draws)])
        return state, {"loss": seed_loss.mean(), "seed_loss": seed_loss}

    return step


def make_ensemble_eval_step(pre_config: PreprocessConfig, loss_type: str = "BCE"
                            ) -> Callable[[EnsembleState, Mapping],
                                          tuple[torch.Tensor, torch.Tensor]]:
    """Returns eval_step(state, batch) -> (probs [E, B, C], per-sample loss
    [E, B]): the batch through the eval preprocessing once (one fbank
    launch whatever E), then the members' eval forwards one after another
    on that log-mel (none writes into it)."""
    eval_config = pre_config.eval_variant()

    @torch.inference_mode()
    def eval_step(state: EnsembleState, batch: Mapping):
        wb = _wav_batch(batch, state.device)
        logmel = preprocess_eval(wb, eval_config)
        probs = torch.stack([m.model.eval()(logmel) for m in state.members])
        losses = torch.stack([per_sample_loss(p, wb.labels, loss_type) for p in probs])
        return probs, losses

    return eval_step
