"""Attention pooling heads over time.

Port of ``psla_tpu/models/pooling.py`` (the reference's
src/models/HigherModels.py): per head, two 1x1 convolutions (attention and
classifier) with sigmoids; attention clamped to [1e-7, 1-1e-7] and
normalized over time; the output is the attention-weighted sum of classifier
probabilities, combined across heads by a learnable head weight (1/H at
init).

The heads keep the reference's per-head ``att.{h}`` / ``cla.{h}`` 1x1 convs,
so the state_dict has its keys; the forward stacks them into one
``[H*2*n_out, C]`` product (``HeadPool``), which a serving copy holds.
Inputs are the time-major features ``[B, T, C]``. The sigmoid, the clamp
and every sum run in float32 (float64 in a model cast to float64).

``return_stats=True`` returns the streaming partial sums
``{"s1": [B, H, n_out], "s0": [B, H, n_out], "head_weight": [H]}``: every
head's output is ``sum_t att*cla / sum_t att``, so pooling decomposes exactly
over time chunks (long-clip inference, ``inference.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

EPSILON = 1e-7


def _conv1x1(n_in: int, n_out: int) -> nn.Conv2d:
    return nn.Conv2d(n_in, n_out, kernel_size=1)


def _psla_uniform_(conv: nn.Conv2d, generator: torch.Generator | None):
    """Reference head init (HigherModels.py:6-18): U(-a, a) with
    a = sqrt(3)*sqrt(2/fan_in), zero bias."""
    a = math.sqrt(2.0 / conv.in_channels) * math.sqrt(3.0)
    nn.init.uniform_(conv.weight, -a, a, generator=generator)
    nn.init.zeros_(conv.bias)


class HeadPool(nn.Module):
    """What the three poolings share: their 1x1 convs (``heads``, in the
    order of the stacked product) projected as one ``[len*n_out, C]``
    product. The stack is made at each call, unless
    ``freeze_projection`` holds it (``layers.for_inference``)."""

    def heads(self) -> list[nn.Conv2d]:
        raise NotImplementedError

    def _stacked(self) -> tuple[torch.Tensor, torch.Tensor]:
        if "proj_weight" in self._buffers:
            return self.proj_weight, self.proj_bias
        convs = self.heads()
        return (torch.cat([c.weight[:, :, 0, 0] for c in convs]),
                torch.cat([c.bias for c in convs]))

    def freeze_projection(self, dtype: torch.dtype):
        """Hold the stacked weight and bias in ``dtype`` and drop the per-head
        convs, whose state_dict keys go with them."""
        w, b = (t.detach().to(dtype) for t in self._stacked())
        for name in ("att", "cla"):
            if hasattr(self, name):
                delattr(self, name)
        self.register_buffer("proj_weight", w)
        self.register_buffer("proj_bias", b)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, C] through the stacked 1x1 convs -> sigmoid [B, T, len*n_out],
        float32 or wider."""
        w, b = self._stacked()
        y = F.linear(x, w.to(x.dtype), b.to(x.dtype))
        return torch.sigmoid(y.to(torch.promote_types(x.dtype, torch.float32)))


class MultiHeadAttentionPool(HeadPool):
    """[B, T, C] -> [B, n_out] probabilities; H attention heads."""

    def __init__(self, n_in: int, n_out: int, head_num: int = 4):
        super().__init__()
        self.n_out, self.head_num = n_out, head_num
        self.att = nn.ModuleList([_conv1x1(n_in, n_out) for _ in range(head_num)])
        self.cla = nn.ModuleList([_conv1x1(n_in, n_out) for _ in range(head_num)])
        self.head_weight = nn.Parameter(torch.full((head_num,), 1.0 / head_num))
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        for conv in [*self.att, *self.cla]:
            _psla_uniform_(conv, generator)
        nn.init.constant_(self.head_weight, 1.0 / self.head_num)

    def heads(self) -> list[nn.Conv2d]:
        return [c for pair in zip(self.att, self.cla) for c in pair]

    def forward(self, x: torch.Tensor, return_stats: bool = False):
        b, t, _ = x.shape
        y = self.project(x).view(b, t, self.head_num, 2, self.n_out)
        att = y[..., 0, :].clamp(EPSILON, 1.0 - EPSILON)  # [B, T, H, n_out]
        cla = y[..., 1, :]
        if return_stats:
            return {
                "s1": (att * cla).sum(dim=1),
                "s0": att.sum(dim=1),
                "head_weight": self.head_weight.detach(),
            }
        norm_att = att / att.sum(dim=1, keepdim=True)
        per_head = (norm_att * cla).sum(dim=1)  # [B, H, n_out]
        return torch.einsum("bho,h->bo", per_head, self.head_weight)


class AttentionPool(HeadPool):
    """Single-head attention pooling (HigherModels.py:23-82)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.n_out = n_out
        self.att = _conv1x1(n_in, n_out)
        self.cla = _conv1x1(n_in, n_out)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        _psla_uniform_(self.att, generator)
        _psla_uniform_(self.cla, generator)

    def heads(self) -> list[nn.Conv2d]:
        return [self.att, self.cla]

    def forward(self, x: torch.Tensor, return_stats: bool = False):
        b, t, _ = x.shape
        y = self.project(x).view(b, t, 2, self.n_out)
        att = y[..., 0, :].clamp(EPSILON, 1.0 - EPSILON)
        cla = y[..., 1, :]
        if return_stats:
            return {
                "s1": (att * cla).sum(dim=1, keepdim=True),
                "s0": att.sum(dim=1, keepdim=True),
                "head_weight": torch.ones(1, device=x.device),
            }
        norm_att = att / att.sum(dim=1, keepdim=True)
        return (norm_att * cla).sum(dim=1)


class MeanPool(HeadPool):
    """Classifier + sigmoid + mean over time (HigherModels.py:84-115)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.n_out = n_out
        self.cla = _conv1x1(n_in, n_out)
        self.reset_parameters()

    def reset_parameters(self, generator: torch.Generator | None = None):
        _psla_uniform_(self.cla, generator)

    def heads(self) -> list[nn.Conv2d]:
        return [self.cla]

    def forward(self, x: torch.Tensor, return_stats: bool = False):
        probs = self.project(x)  # [B, T, n_out]
        if return_stats:
            b, t, _ = x.shape
            return {
                "s1": probs.sum(dim=1)[:, None, :],
                "s0": torch.full((b, 1, self.n_out), float(t), device=x.device),
                "head_weight": torch.ones(1, device=x.device),
            }
        return probs.mean(dim=1)
