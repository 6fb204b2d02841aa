"""The PSLA recipe's loss, optimizer and learning-rate schedule
(src/traintest.py), and the reference's train steps.

* BCE on probabilities clamped to [1e-7, 1 - 1e-7], the mean over every
  element (traintest.py:102-104).
* Adam, betas (0.95, 0.999), eps 1e-8, with L2 weight decay added to the
  gradient before the moments (torch's ``Adam(weight_decay=...)``,
  traintest.py:52), bias-corrected.
* The schedule (traintest.py:56, 92-96): while step <= 1000, lr = base *
  (step // 50 * 50 / 1000); after it, base * decay ** n, where n counts the
  milestones start, start + 5, ... at or below the finished epochs.
"""

from __future__ import annotations

import importlib

import torch

from benchmark.reference import kaldi_fbank
from benchmark.reference.precision import float32_products

BETAS = (0.95, 0.999)
ADAM_EPS = 1e-8
CLAMP = 1e-7


def bce(probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    p = probs.clamp(CLAMP, 1.0 - CLAMP)
    return -(targets * torch.log(p) + (1.0 - targets) * torch.log1p(-p)).mean()


def learning_rate(recipe: dict, step: int) -> float:
    base = recipe["lr"]
    if step <= 1000:
        return base * ((step // 50) * 50 / 1000)
    epoch = step // recipe["steps_per_epoch"] + 1
    past = (epoch - 1) - recipe["lrscheduler_start"]
    n = 0 if past < 0 else past // 5 + 1
    return base * recipe["lrscheduler_decay"] ** n


class Adam:
    """Adam with L2 weight decay over a dict of float32 tensors."""

    def __init__(self, params: dict[str, torch.Tensor], weight_decay: float):
        self.params, self.wd, self.t = params, weight_decay, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads: dict[str, torch.Tensor], lr: float) -> dict[str, torch.Tensor]:
        """Updates the parameters in place; returns the gradients as the
        moments took them (L2 term included)."""
        self.t += 1
        b1, b2 = BETAS
        taken = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] + self.wd * p
                taken[k] = g
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
        return taken


def family(name: str):
    """The reference module of a model family (``benchmark/reference/<name>.py``)."""
    return importlib.import_module(f"benchmark.reference.{name}")


def train_steps(config: dict, weights: dict[str, torch.Tensor], batches: list[dict],
                draws: list[dict], start_step: int, precision: str = "float32") -> dict:
    """The recipe's train steps from ``weights`` on ``batches`` with
    ``draws`` (one each a step), on the tensors' device. Returns each
    step's loss, the first step's gradients as Adam took them, and each
    parameter's change after the last step, all as tensors by name.
    Products and convolutions in full float32, both ways."""
    with float32_products():
        return _train_steps(config, weights, batches, draws, start_step, precision)


def _train_steps(config, weights, batches, draws, start_step, precision):
    fam = family(config["family"])
    shapes = fam.shapes(config)
    params = {k: weights[k].detach().clone() for k, (_, kind) in shapes.items()
              if fam.is_parameter(k, kind)}
    buffers = {k: weights[k] for k in shapes if k not in params}
    start = {k: v.clone() for k, v in params.items()}
    adam = Adam(params, config["weight_decay"])
    losses, first = [], None
    for i, (batch, draw) in enumerate(zip(batches, draws)):
        x, labels = kaldi_fbank.train_input(batch, draw, config)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        probs = fam.forward({**leaves, **buffers}, x, config, train=True,
                            keep=draw.get("keep"), precision=precision)
        loss = bce(probs, labels)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        taken = adam.step(dict(zip(leaves, grads)), learning_rate(config, start_step + i))
        losses.append(loss.detach())
        if first is None:
            first = taken
        del x, probs, loss, grads, leaves
    return {"losses": torch.stack(losses), "grads": first,
            "changes": {k: params[k] - start[k] for k in params}}
