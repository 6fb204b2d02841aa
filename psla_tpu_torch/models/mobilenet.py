"""MobileNetV2 classifier (reference: src/models/Models.py:45-60).

Port of ``psla_tpu/models/mobilenet.py``: torchvision's MobileNetV2 with a
1-channel stem and a ``Linear(1280, label_dim)`` classifier, then a
sigmoid (the reference swaps in both, Models.py:51-52). The stem
(``features.0``: 32 channels, 3x3, stride 2), the 17 inverted residuals of
``INVERTED_RESIDUAL_SETTINGS`` (an expand ratio of 1 has no expand conv;
the residual only at stride 1 with as many channels out as in), the head
(``features.18``, 1280 channels), the mean over (F, T), the classifier.
Padding is torch's, ``(k - 1) // 2`` on every side.

Attribute names follow the reference (``model`` is torchvision's
MobileNetV2), so the state_dict has the keys ``psla_tpu/models/convert.py``
reads: ``model.features.0.{0,1}``; ``model.features.{i}.conv.{0.0, 0.1, 1,
2}`` for an expand ratio of 1, else ``conv.{0.0, 0.1, 1.0, 1.1, 2, 3}``;
``model.features.18.{0,1}``; ``model.classifier``.

In bfloat16 the convolutions compute in bf16, while every BatchNorm
returns float32 (the JAX package builds them with ``dtype=jnp.float32``):
the ReLU6 and the residual adds run in float32, and so does the
classifier. BatchNorm uses torch's momentum 0.1 and eps 1e-5. The forward
has no ``return_stats`` (no attention pool: ``inference.predict_long``
weights chunk probabilities by their lengths) and no drop-connect.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from psla_tpu_torch.models.layers import BatchNorm, PadConv2d, conv_bn

BN_MOMENTUM = 0.1  # torch's convention; flax's 0.9
BN_EPS = 1e-5
STEM_FILTERS = 32
HEAD_FILTERS = 1280

# (expand_ratio, out_channels, num_blocks, first_stride)
INVERTED_RESIDUAL_SETTINGS = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


def conv_bn_relu6(cin: int, cout: int, kernel: int, stride: int, groups: int,
                  dtype: torch.dtype) -> nn.Sequential:
    """torchvision's Conv2dNormActivation: keys ``{0: conv, 1: bn}``."""
    return nn.Sequential(
        PadConv2d(cin, cout, kernel, stride, pad=(kernel - 1) // 2, groups=groups,
                  dtype=dtype),
        BatchNorm(cout, eps=BN_EPS, momentum=BN_MOMENTUM, float_out=True))


class InvertedResidual(nn.Module):
    def __init__(self, expand_ratio: int, in_filters: int, out_filters: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        hidden = in_filters * expand_ratio
        self.use_res = stride == 1 and in_filters == out_filters
        layers = []
        if expand_ratio != 1:
            layers.append(conv_bn_relu6(in_filters, hidden, 1, 1, 1, dtype))
        layers += [conv_bn_relu6(hidden, hidden, 3, stride, hidden, dtype),
                   PadConv2d(hidden, out_filters, 1, dtype=dtype),
                   BatchNorm(out_filters, eps=BN_EPS, momentum=BN_MOMENTUM, float_out=True)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *fronts, project, bn = self.conv
        y = x
        for front in fronts:
            y = conv_bn(y, front[0], front[1], "relu6")
        y = conv_bn(y, project, bn, None)
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    """Features ``features.0``-``features.18`` and the classifier."""

    def __init__(self, label_dim: int, dtype: torch.dtype):
        super().__init__()
        feats = [conv_bn_relu6(1, STEM_FILTERS, 3, 2, 1, dtype)]
        in_f = STEM_FILTERS
        for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
            for i in range(n):
                feats.append(InvertedResidual(t, in_f, c, s if i == 0 else 1, dtype))
                in_f = c
        feats.append(conv_bn_relu6(in_f, HEAD_FILTERS, 1, 1, 1, dtype))
        self.features = nn.Sequential(*feats)
        self.classifier = nn.Linear(HEAD_FILTERS, label_dim)  # float32 in any dtype

    def reset_classifier(self, generator: torch.Generator | None = None):
        """variance_scaling(1/3, fan_in, uniform) (the JAX package's
        dense_kernel_init): U(-a, a), a = sqrt(1 / fan_in); zero bias."""
        a = math.sqrt(1.0 / self.classifier.in_features)
        nn.init.uniform_(self.classifier.weight, -a, a, generator=generator)
        nn.init.zeros_(self.classifier.bias)


class MBNet(nn.Module):
    """MobileNetV2 + linear classifier + sigmoid; starts in eval mode."""

    def __init__(self, label_dim: int = 527, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.label_dim = label_dim
        self.dtype = dtype  # compute dtype of the convolutions
        self.model = MobileNetV2(label_dim, dtype)
        self.model.reset_classifier()
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F] log-mel -> [B, label_dim] probabilities (float32)."""
        x = x.transpose(1, 2).unsqueeze(1)  # [B, 1, F, T]
        first, *blocks, head = self.model.features
        x = conv_bn(x, first[0], first[1], "relu6")
        for block in blocks:
            x = block(x)
        x = conv_bn(x, head[0], head[1], "relu6").mean(dim=(2, 3))  # [B, 1280] f32
        return torch.sigmoid(self.model.classifier(x))
