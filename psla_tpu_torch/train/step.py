"""The train and eval steps (port of ``psla_tpu/train/step.py``).

One train step does what the reference splits across CPU dataloader
workers and its GPU step (src/traintest.py:81-109): the int16 batch
dequantized on the card, mixup or DC removal, the fbank kernel,
SpecAugment, normalize, the train-mode forward, BCE (or CE) on clamped
probabilities, backward, and Adam on the PSLA schedule. Its random draws
come in as tensors (``TrainDraws``, made by ``draw_train`` from a
``torch.Generator``), so a step is a function of the state, the batch and
the draws.

Data parallelism (``build_train_step(..., mesh)``, the JAX package's
``build_train_step`` on a ('data',) mesh): each rank takes its contiguous
share of the global batch, draws the global batch's draws and keeps its
rows, normalizes with the global batch's BatchNorm statistics
(``models.layers.SyncBatchNormFn``), and averages the gradients and the
loss over the ranks with one all-reduce before Adam, so W ranks compute the
one-process step on the global batch up to the order of the sums.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from psla_tpu_torch.frontend.pipeline import (
    PreprocessConfig,
    PreprocessDraws,
    WavBatch,
    draw_preprocess,
    preprocess_eval,
    preprocess_train,
)
from psla_tpu_torch.models.layers import BatchNorm
from psla_tpu_torch.parallel.mesh import Mesh
from psla_tpu_torch.tracing import span
from psla_tpu_torch.train.optim import bce_loss, ce_loss, per_sample_loss, set_lr
from psla_tpu_torch.train.state import TrainState


def _wav_batch(batch: Mapping[str, np.ndarray | torch.Tensor],
               device: torch.device) -> WavBatch:
    """Loader batch dict -> WavBatch on ``device``. int16 wire waveforms
    cross to the card as int16 and are dequantized there by x 2^-15: the
    float32 samples of a PCM16 source, exactly. Tensors already on
    ``device`` (``data/device_prefetch.py``'s) are taken as they are, with
    no second copy."""
    b = {k: torch.as_tensor(batch[k]).to(device) for k in WavBatch._fields}
    for k in ("wav", "mix_wav"):
        if b[k].dtype == torch.int16:
            b[k] = b[k].float() * 2.0 ** -15
    return WavBatch(**b)


class TrainDraws(NamedTuple):
    pre: PreprocessDraws
    # [len(model.effnet.drop_blocks), B] bool drop-connect keep masks, or
    # None when no block drops (ResNet and MBNet have no drop-connect)
    keep: torch.Tensor | None


def step_generator(seed: int, step: int, device: str | torch.device,
                   member: int | None = None) -> torch.Generator:
    """The generator of global step ``step``'s draws, on ``device``: the
    counterpart of the JAX step's ``fold_in(rng, step)``. Its seed is a
    fixed function of (seed, step), so a resumed run draws what the
    uninterrupted run drew. An ensemble member's stream appends its index
    ``member`` (``fold_in(fold_in(rng, m), step)`` in
    ``psla_tpu/parallel/ensemble.py``); ``member=None`` is the single
    model's."""
    entropy = [seed, 1, step] if member is None else [seed, 1, step, member]
    words = np.random.SeedSequence(entropy).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(words[0]) | int(words[1]) << 32)


def draw_train(generator: torch.Generator, model: torch.nn.Module, batch: int,
               config: PreprocessConfig) -> TrainDraws:
    """One step's draws, on the generator's device: the preprocessing's and
    one keep mask per EfficientNet block that drops (Bernoulli(1 -
    drop_rate))."""
    with span("train.draws"):
        pre = draw_preprocess(generator, batch, config)
        blocks = model.effnet.drop_blocks if hasattr(model, "effnet") else []
        if not blocks:
            return TrainDraws(pre, None)
        keep_prob = torch.tensor([1.0 - model.effnet._blocks[i].drop_rate for i in blocks],
                                 device=generator.device)
        u = torch.rand((len(blocks), batch), generator=generator, device=generator.device)
        return TrainDraws(pre, u < keep_prob[:, None])


def shard_draws(draws: TrainDraws, mesh: Mesh, rows: int) -> TrainDraws:
    """This rank's ``rows`` rows of the global batch's draws: rows
    ``[rank * rows, (rank + 1) * rows)`` of every per-clip draw, and of
    axis 1 of ``keep``."""
    lo, hi = mesh.rank * rows, (mesh.rank + 1) * rows
    per_clip = [t for d in draws.pre if d is not None for t in d]
    if draws.keep is not None:
        per_clip.append(draws.keep[0])
    if per_clip and per_clip[0].shape[0] != rows * mesh.world:
        raise ValueError(f"the draws are for {per_clip[0].shape[0]} clips; a step of "
                         f"{mesh.world} ranks x {rows} rows takes the global batch's")
    pre = PreprocessDraws(*(None if d is None else type(d)(*(t[lo:hi] for t in d))
                            for d in draws.pre))
    return TrainDraws(pre, None if draws.keep is None else draws.keep[:, lo:hi])


def _average_gradients(params, loss: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Replace every gradient by its mean over the ranks, with one all-reduce
    of a flat buffer that also carries the loss. Returns the loss's mean
    over the ranks (a 0-d tensor on the device, no host sync)."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
    dist.all_reduce(flat, group=mesh.group)
    flat /= mesh.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1].clone()


def build_train_step(pre_config: PreprocessConfig, loss_type: str = "BCE",
                     mesh: Mesh | None = None
                     ) -> Callable[[TrainState, Mapping, TrainDraws],
                                   tuple[TrainState, dict]]:
    """Returns train_step(state, batch, draws) -> (state, {"loss"}). The
    step updates the state in place (model, optimizer, step) and returns
    it; the loss is a 0-d tensor on the state's device. Without a mesh, or
    at W = 1, it is the one-process step: the single model's, and each
    ensemble member's.

    With a ``mesh`` of W > 1 ranks, the state is one that
    ``train.state.replicate_state`` placed on the mesh (its BatchNorms take
    the global statistics), ``batch`` is this rank's share of the global
    batch (``parallel.mesh.shard_batch``) and ``draws`` the global batch's
    (``draw_train`` for W x its rows; the step keeps its own,
    ``shard_draws``). The gradients and the returned loss are the means
    over the ranks."""
    loss_fn = bce_loss if loss_type == "BCE" else ce_loss
    group = mesh.group if mesh is not None and mesh.world > 1 else None
    placed = []  # the last model seen to be on the mesh's group

    def one_step(state: TrainState, batch: Mapping, draws: TrainDraws):
        model, optimizer = state.model, state.optimizer
        model.train()
        if group is not None:
            if not placed or placed[0] is not model:
                if any(bn.group is not group for bn in model.modules()
                       if isinstance(bn, BatchNorm)):
                    raise ValueError("the state's BatchNorms are not on the mesh's group: "
                                     "place the state with replicate_state(state, mesh)")
                placed[:] = [model]
            draws = shard_draws(draws, mesh, len(batch["wav"]))
        with span("train.preprocess"):
            fbank, labels = preprocess_train(_wav_batch(batch, state.device), draws.pre,
                                             pre_config)
        with span("train.forward"):
            probs = model(fbank) if draws.keep is None else model(fbank, keep=draws.keep)
            loss = loss_fn(probs, labels)
        with span("train.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        loss = loss.detach()
        if group is not None:
            with span("train.exchange"):
                loss = _average_gradients(model.parameters(), loss, mesh)
        with span("train.optimizer"):
            set_lr(optimizer, state.schedule(state.step))
            optimizer.step()
        state.step += 1
        return state, {"loss": loss}

    def train_step(state: TrainState, batch: Mapping, draws: TrainDraws):
        with span("train.step"):
            return one_step(state, batch, draws)

    return train_step


def build_eval_step(pre_config: PreprocessConfig, loss_type: str = "BCE"
                    ) -> Callable[[TrainState, Mapping],
                                  tuple[torch.Tensor, torch.Tensor]]:
    """Returns eval_step(state, batch) -> (probs [B, C], per-sample loss
    [B]), the eval forward on the eval variant of ``pre_config``. On
    several ranks each runs it on its own rows: eval-mode BatchNorm reads
    the running statistics, which every rank holds alike, so the step needs
    no collective; the caller gathers the rows
    (``train.loop.Trainer.validate``)."""
    eval_config = pre_config.eval_variant()

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping):
        model = state.model.eval()
        wb = _wav_batch(batch, state.device)
        out = model(preprocess_eval(wb, eval_config))
        return out, per_sample_loss(out, wb.labels, loss_type)

    return eval_step
