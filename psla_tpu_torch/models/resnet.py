"""ResNet50 + attention pooling (reference: src/models/Models.py:7-43).

Port of ``psla_tpu/models/resnet.py``: torchvision's ResNet50 with a
1-channel stem (7x7 stride 2, pad 3; BN, ReLU; 3x3 stride-2 max-pool, pad
1), the four bottleneck stages (64,3,1), (128,4,2), (256,6,2), (512,3,2)
with the stride on each stage's first 3x3 conv and a downsample on its
first block, then the mean over the frequency axis and the single-head
attention pool over time. Padding is torch's (symmetric), not TF-SAME.

fbank ``[B, T, F]`` -> NCHW ``[B, 1, F, T]`` -> ``[B, 2048, F/32, T/32]``
-> ``[B, T/32, 2048]`` -> ``[B, label_dim]`` probabilities. Attribute names
follow the reference (``model`` is torchvision's ResNet, ``attention`` the
pool), so the state_dict has the keys ``psla_tpu/models/convert.py``
reads: ``model.conv1``, ``model.bn1``, ``model.layer{s}.{j}.conv{c}`` and
``.bn{c}``, ``model.layer{s}.0.downsample.{0,1}``, ``attention.att`` and
``attention.cla``.

In bfloat16 the convolutions and the pooling projection compute in bf16;
every BatchNorm returns float32 (the JAX package builds them with
``dtype=jnp.float32``), so the ReLUs, the max-pool and the residual adds
run in float32. BatchNorm uses torch's momentum 0.1 and eps 1e-5. There is
no drop-connect: the train-mode forward takes no keep masks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from psla_tpu_torch.models.layers import BatchNorm, PadConv2d
from psla_tpu_torch.models.pooling import AttentionPool

BN_MOMENTUM = 0.1  # torch's convention; flax's 0.9
BN_EPS = 1e-5
STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))  # (planes, blocks, stride)
EXPANSION = 4


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=BN_EPS, momentum=BN_MOMENTUM, float_out=True)


class Bottleneck(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int, downsample: bool,
                 dtype: torch.dtype):
        super().__init__()
        out = planes * EXPANSION
        self.conv1 = PadConv2d(in_planes, planes, 1, dtype=dtype)
        self.bn1 = _bn(planes)
        self.conv2 = PadConv2d(planes, planes, 3, stride, pad=1, dtype=dtype)
        self.bn2 = _bn(planes)
        self.conv3 = PadConv2d(planes, out, 1, dtype=dtype)
        self.bn3 = _bn(out)
        if downsample:
            self.downsample = nn.Sequential(
                PadConv2d(in_planes, out, 1, stride, dtype=dtype), _bn(out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if hasattr(self, "downsample") else x
        return F.relu(out + identity)


class ResNet50(nn.Module):
    """Feature extractor: NCHW ``[B, 1, H, W]`` -> ``[B, 2048, H/32, W/32]``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = PadConv2d(1, 64, 7, 2, pad=3, dtype=dtype)
        self.bn1 = _bn(64)
        in_planes = 64
        for s, (planes, blocks, stride) in enumerate(STAGES):
            layer = nn.Sequential(*(
                Bottleneck(in_planes if j == 0 else planes * EXPANSION, planes,
                           stride if j == 0 else 1, j == 0, dtype)
                for j in range(blocks)))
            setattr(self, f"layer{s + 1}", layer)
            in_planes = planes * EXPANSION
        self.feature_dim = in_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)  # pads with -inf, as flax's max_pool
        for s in range(len(STAGES)):
            x = getattr(self, f"layer{s + 1}")(x)
        return x


class ResNetAttention(nn.Module):
    """ResNet50 backbone + single-head attention pool; starts in eval mode."""

    def __init__(self, label_dim: int = 527, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.label_dim = label_dim
        self.dtype = dtype  # compute dtype of the convolutions and the pool
        self.model = ResNet50(dtype=dtype)
        self.attention = AttentionPool(self.model.feature_dim, label_dim)
        self.eval()

    def forward(self, x: torch.Tensor, return_stats: bool = False):
        """[B, T, F] log-mel -> [B, label_dim] probabilities (float32), or the
        pooling partial sums with ``return_stats=True`` (see pooling.py)."""
        x = x.transpose(1, 2).unsqueeze(1)  # [B, 1, F, T]
        feats = self.model(x).mean(dim=2).transpose(1, 2)  # [B, T/32, 2048] f32
        return self.attention(feats.to(self.dtype), return_stats=return_stats)
