"""The train and eval steps (port of ``psla_tpu/train/step.py``).

One train step does what the reference splits across CPU dataloader
workers and its GPU step (src/traintest.py:81-109): the int16 batch
dequantized on the card, mixup or DC removal, the fbank kernel,
SpecAugment, normalize, the train-mode forward, BCE (or CE) on clamped
probabilities, backward, and Adam on the PSLA schedule. Its random draws
come in as tensors (``TrainDraws``, made by ``draw_train`` from a
``torch.Generator``), so a step is a function of the state, the batch and
the draws. The JAX package's mesh and sharding wait for the port's data
parallelism.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import numpy as np
import torch

from psla_tpu_torch.frontend.pipeline import (
    PreprocessConfig,
    PreprocessDraws,
    WavBatch,
    draw_preprocess,
    preprocess_eval,
    preprocess_train,
)
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
    pre = draw_preprocess(generator, batch, config)
    blocks = model.effnet.drop_blocks if hasattr(model, "effnet") else []
    if not blocks:
        return TrainDraws(pre, None)
    keep_prob = torch.tensor([1.0 - model.effnet._blocks[i].drop_rate for i in blocks],
                             device=generator.device)
    u = torch.rand((len(blocks), batch), generator=generator, device=generator.device)
    return TrainDraws(pre, u < keep_prob[:, None])


def make_train_step_fn(pre_config: PreprocessConfig, loss_type: str = "BCE"
                       ) -> Callable[[TrainState, Mapping, TrainDraws],
                                     tuple[TrainState, dict]]:
    """Returns train_step(state, batch, draws) -> (state, {"loss"}). The
    step updates the state in place (model, optimizer, step) and returns
    it; the loss is a 0-d tensor on the state's device."""
    loss_fn = bce_loss if loss_type == "BCE" else ce_loss

    def train_step(state: TrainState, batch: Mapping, draws: TrainDraws):
        model, optimizer = state.model, state.optimizer
        model.train()
        fbank, labels = preprocess_train(_wav_batch(batch, state.device), draws.pre,
                                         pre_config)
        probs = model(fbank) if draws.keep is None else model(fbank, keep=draws.keep)
        loss = loss_fn(probs, labels)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        set_lr(optimizer, state.schedule(state.step))
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_eval_step_fn(pre_config: PreprocessConfig, loss_type: str = "BCE"
                      ) -> Callable[[TrainState, Mapping],
                                    tuple[torch.Tensor, torch.Tensor]]:
    """Returns eval_step(state, batch) -> (probs [B, C], per-sample loss
    [B]), the eval forward on the eval variant of ``pre_config``."""
    eval_config = pre_config.eval_variant()

    @torch.inference_mode()
    def eval_step(state: TrainState, batch: Mapping):
        model = state.model.eval()
        wb = _wav_batch(batch, state.device)
        out = model(preprocess_eval(wb, eval_config))
        return out, per_sample_loss(out, wb.labels, loss_type)

    return eval_step
