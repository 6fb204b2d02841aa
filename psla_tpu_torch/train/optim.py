"""Optimizer, learning-rate schedule and losses (port of
``psla_tpu/train/optim.py``).

The reference optimizer is torch Adam with weight decay 5e-7 and betas
(0.95, 0.999) whatever --weight-decay says (src/traintest.py:52): L2 added
into the gradient before the moments, not AdamW. The JAX package writes it
as optax's add_decayed_weights -> scale_by_adam -> lr, on every parameter;
here it is ``torch.optim.Adam`` itself, on every parameter too.

The schedule (src/traintest.py:56, 92-96) is a staircase warmup, lr =
(step/1000) * base updated every 50 steps while step <= 1000, and MultiStepLR
decay by ``decay`` at epochs start, start + step, ... (1-indexed epochs,
applied from the epoch after each milestone; step 5 in PSLA's traintest.py,
AST's ``--lrscheduler_step``, 1 in its AudioSet recipe): a pure function of
the global step.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

WEIGHT_DECAY = 5e-7
ADAM_BETAS = (0.95, 0.999)
ADAM_EPS = 1e-8
EPSILON = 1e-7


def psla_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    lrscheduler_start: int = 10,
    lrscheduler_decay: float = 0.5,
    warmup: bool = True,
    lrscheduler_step: int = 5,
    warmup_steps: int = 1000,
    warmup_update_every: int = 50,
) -> Callable[[int], float]:
    """Returns schedule(step) -> lr, the reference's trajectory."""

    def schedule(step: int) -> float:
        step = int(step)
        epoch = step // steps_per_epoch + 1  # 1-indexed, like traintest.py:67
        # milestones m in {start, start + step, ...} with m <= epoch - 1
        past = (epoch - 1) - lrscheduler_start
        n_decays = 0 if past < 0 else past // lrscheduler_step + 1
        lr = base_lr * lrscheduler_decay ** n_decays
        if warmup and step <= warmup_steps:
            # the staircase includes lr = 0 for steps 0-49: the reference's
            # warmup branch fires at global_step 0 (traintest.py:92-96)
            lr = base_lr * ((min(step, warmup_steps) // warmup_update_every)
                            * warmup_update_every / warmup_steps)
        return lr

    return schedule


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   weight_decay: float = WEIGHT_DECAY) -> torch.optim.Adam:
    """The reference's Adam with L2 weight decay. The step sets each
    update's learning rate from the schedule (``set_lr``)."""
    return torch.optim.Adam(params, lr=0.0, betas=ADAM_BETAS, eps=ADAM_EPS,
                            weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float):
    for group in optimizer.param_groups:
        group["lr"] = lr


def bce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE on clamped probabilities (traintest.py:102-104): clamp to
    [1e-7, 1 - 1e-7], mean over all elements. Not
    ``F.binary_cross_entropy``, which clamps the log at -100 instead."""
    p = probs.clamp(EPSILON, 1.0 - EPSILON)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p)).mean()


def ce_loss(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """CrossEntropy on argmax targets (traintest.py:99-100). The reference
    feeds post-sigmoid probabilities to torch CE, which applies its own
    log-softmax; reproduced literally."""
    p = probs.clamp(EPSILON, 1.0 - EPSILON)
    logp = torch.log_softmax(p, dim=-1)
    idx = targets.argmax(dim=1)
    return -logp.gather(1, idx[:, None]).mean()


def per_sample_loss(probs: torch.Tensor, targets: torch.Tensor,
                    loss_type: str = "BCE") -> torch.Tensor:
    """[B] losses of the eval step (step.py's ``_per_sample_loss``)."""
    p = probs.clamp(EPSILON, 1.0 - EPSILON)
    if loss_type == "BCE":
        return -(targets * torch.log(p) + (1 - targets) * torch.log1p(-p)).mean(dim=-1)
    idx = targets.argmax(dim=1)
    logp = p - torch.logsumexp(p, dim=-1, keepdim=True)
    return -logp.gather(1, idx[:, None])[:, 0]
