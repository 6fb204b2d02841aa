"""EfficientNet-B0..B7 backbone (features only).

Port of ``psla_tpu/models/efficientnet.py``: the architecture behind the
reference's ``EfficientNet.from_name('efficientnet-b{b}', in_channels=1)``
(src/models/Models.py:69-72, 109). Stem 3x3/s2 -> 7 MBConv stages (expand
1x1, depthwise k3/k5, squeeze-excite ratio 0.25 of the input filters,
project 1x1, BN + swish) -> head 1x1 conv. Attribute names are
efficientnet_pytorch's, so the state_dict has the reference's keys
(``_conv_stem``, ``_bn0``, ``_blocks.{i}._expand_conv``, ...).

In eval mode BatchNorm uses its running statistics and no block drops.
In train mode BatchNorm uses batch statistics and every block with a skip
drops its residual branch per sample at ``drop_rate`` = 0.2 * idx / blocks
(stochastic depth), from keep masks the caller passes (``keep``, one [B]
bool row per such block, in block order: ``drop_blocks``; made by
``train.step.draw_train``). ``remat`` recomputes each block's forward in
backward (``torch.utils.checkpoint``), as the JAX package's ``nn.remat``
does: only the block boundaries are kept. The recomputed forward is the
first one bit for bit, the int8 copy of ``act_compress='q8save'`` and the
bfloat16 BatchNorms included (tests/test_torch_bf16_train.py).

``act_compress`` ('none', 'q8save' or 'qdq'; ops/qsave.py) acts on each
block's depthwise convolution (``layers.conv_bn``) and adds no parameter.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from psla_tpu_torch.models.layers import (
    ACT_COMPRESS,
    BatchNorm,
    SameConv2d,
    conv_bn,
    drop_connect,
    round_filters,
    round_repeats,
)


@dataclasses.dataclass(frozen=True)
class BlockArgs:
    kernel: int
    stride: int
    expand_ratio: int
    in_filters: int
    out_filters: int
    num_repeat: int
    se_ratio: float = 0.25


# The EfficientNet-B0 base architecture (7 stages).
BASE_BLOCKS: tuple[BlockArgs, ...] = (
    BlockArgs(3, 1, 1, 32, 16, 1),
    BlockArgs(3, 2, 6, 16, 24, 2),
    BlockArgs(5, 2, 6, 24, 40, 2),
    BlockArgs(3, 2, 6, 40, 80, 3),
    BlockArgs(5, 1, 6, 80, 112, 3),
    BlockArgs(5, 2, 6, 112, 192, 4),
    BlockArgs(3, 1, 6, 192, 320, 1),
)

# b -> (width_coefficient, depth_coefficient)
SCALING: dict[int, tuple[float, float]] = {
    0: (1.0, 1.0),
    1: (1.0, 1.1),
    2: (1.1, 1.2),
    3: (1.2, 1.4),
    4: (1.4, 1.8),
    5: (1.6, 2.2),
    6: (1.8, 2.6),
    7: (2.0, 3.1),
}

STEM_FILTERS = 32
HEAD_FILTERS = 1280
DROP_CONNECT_RATE = 0.2


def efficientnet_arch(b: int):
    """Resolved per-variant architecture: (stem, [(BlockArgs, repeats)], head).

    The head width matches the reference's middim table
    [1280,1280,1408,1536,1792,2048,2304,2560] (Models.py:66).
    """
    width, depth = SCALING[b]
    stem = round_filters(STEM_FILTERS, width)
    blocks = []
    for args in BASE_BLOCKS:
        blocks.append(
            (
                dataclasses.replace(
                    args,
                    in_filters=round_filters(args.in_filters, width),
                    out_filters=round_filters(args.out_filters, width),
                ),
                round_repeats(args.num_repeat, depth),
            )
        )
    head = round_filters(HEAD_FILTERS, width)
    return stem, blocks, head


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with squeeze-and-excitation."""

    def __init__(self, kernel: int, stride: int, expand_ratio: int,
                 in_filters: int, out_filters: int, se_ratio: float,
                 drop_rate: float, act_compress: str = "none"):
        super().__init__()
        expanded = in_filters * expand_ratio
        self.drop_rate = drop_rate
        self.act_compress = act_compress
        self.has_skip = stride == 1 and in_filters == out_filters
        if expand_ratio != 1:
            self._expand_conv = SameConv2d(in_filters, expanded, 1)
            self._bn0 = BatchNorm(expanded)
        self._depthwise_conv = SameConv2d(expanded, expanded, kernel, stride,
                                          groups=expanded)
        self._bn1 = BatchNorm(expanded)
        self.has_se = se_ratio > 0
        if self.has_se:
            se_filters = max(1, int(in_filters * se_ratio))
            self._se_reduce = SameConv2d(expanded, se_filters, 1, bias=True)
            self._se_expand = SameConv2d(se_filters, expanded, 1, bias=True)
        self._project_conv = SameConv2d(expanded, out_filters, 1)
        self._bn2 = BatchNorm(out_filters)

    @property
    def can_drop(self) -> bool:
        """Whether train mode drops this block's residual branch."""
        return self.has_skip and self.drop_rate > 0

    def remat_contexts(self):
        """``checkpoint``'s context_fn: the recomputed forward runs with
        the block's BatchNorms ``replaying``."""

        @contextlib.contextmanager
        def replaying():
            bns = [m for m in self.modules() if isinstance(m, BatchNorm)]
            for bn in bns:
                bn.replaying = True
            try:
                yield
            finally:
                for bn in bns:
                    bn.replaying = False

        return contextlib.nullcontext(), replaying()

    def forward(self, x: torch.Tensor, keep: torch.Tensor | None = None) -> torch.Tensor:
        inputs = x
        if hasattr(self, "_expand_conv"):
            x = conv_bn(x, self._expand_conv, self._bn0, "silu")
        x = conv_bn(x, self._depthwise_conv, self._bn1, "silu", self.act_compress)
        if self.has_se:
            s = x.mean(dim=(2, 3), keepdim=True)
            s = self._se_expand(nn.functional.silu(self._se_reduce(s)))
            x = x * torch.sigmoid(s)
        x = conv_bn(x, self._project_conv, self._bn2, None)
        if self.has_skip:
            if self.training and self.can_drop:
                x = drop_connect(x, keep, self.drop_rate)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """EfficientNet feature extractor. NCHW in; [B, C, H/32, W/32] out."""

    def __init__(self, b: int = 2, drop_connect_rate: float = DROP_CONNECT_RATE,
                 remat: bool = False, act_compress: str = "none"):
        super().__init__()
        if act_compress not in ACT_COMPRESS:
            raise ValueError(f"unknown act_compress {act_compress!r}; choices: {ACT_COMPRESS}")
        self.remat = remat
        stem, blocks, head = efficientnet_arch(b)
        self.feature_dim = head
        self._conv_stem = SameConv2d(1, stem, 3, 2)
        self._bn0 = BatchNorm(stem)
        total = sum(r for _, r in blocks)
        mods = []
        for args, repeats in blocks:
            for rep in range(repeats):
                mods.append(MBConvBlock(
                    kernel=args.kernel,
                    stride=args.stride if rep == 0 else 1,
                    expand_ratio=args.expand_ratio,
                    in_filters=args.in_filters if rep == 0 else args.out_filters,
                    out_filters=args.out_filters,
                    se_ratio=args.se_ratio,
                    drop_rate=drop_connect_rate * len(mods) / total,
                    act_compress=act_compress,
                ))
        self._blocks = nn.ModuleList(mods)
        self._conv_head = SameConv2d(blocks[-1][0].out_filters, head, 1)
        self._bn1 = BatchNorm(head)

    @property
    def drop_blocks(self) -> list[int]:
        """Indices of the blocks that take a keep mask in train mode."""
        return [i for i, blk in enumerate(self._blocks) if blk.can_drop]

    def forward(self, x: torch.Tensor,
                keep: torch.Tensor | None = None) -> torch.Tensor:
        """``keep``: [len(drop_blocks), B] bool, read in train mode only."""
        if self.training and keep is None and self.drop_blocks:
            raise ValueError("train mode drops blocks: pass their keep masks "
                             "(train.step.draw_train)")
        x = conv_bn(x, self._conv_stem, self._bn0, "silu")
        masks = iter(keep) if keep is not None else None
        for block in self._blocks:
            k = next(masks) if masks is not None and block.can_drop else None
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, k, use_reentrant=False,
                               context_fn=block.remat_contexts)
            else:
                x = block(x, k)
        return conv_bn(x, self._conv_head, self._bn1, "silu")
