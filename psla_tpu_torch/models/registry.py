"""Model selection by name (reference: src/run.py:105-110)."""

from __future__ import annotations

import torch

from psla_tpu_torch.models.effnet_att import EffNetAttention
from psla_tpu_torch.models.layers import BatchNorm, SameConv2d
from psla_tpu_torch.models.pooling import AttentionPool, MeanPool, MultiHeadAttentionPool

MODEL_REGISTRY = ("efficientnet", "resnet", "mbnet")


def create_model(
    name: str,
    label_dim: int = 527,
    eff_b: int = 2,
    head_num: int = 4,
    dtype: torch.dtype = torch.float32,
    generator: torch.Generator | None = None,
    remat: bool = False,
    drop_connect_rate: float = 0.2,
    bn_momentum: float = 0.99,
) -> EffNetAttention:
    """Build the module for a model name (run.py's --model choices), in
    eval mode.

    Weights are initialised as the JAX package initialises them (He-normal
    over fan-out for convs, the reference's uniform for the pooling heads),
    drawn from ``generator`` (default: seeded with 0). ``remat`` and
    ``drop_connect_rate`` act in train mode (models/efficientnet.py), and
    so does ``bn_momentum``, the running statistics' momentum in flax's
    convention (0.99 keeps 99% of the old statistics at each step, torch's
    momentum 0.01).
    """
    if name in ("resnet", "mbnet"):
        raise NotImplementedError(
            f"model {name!r} is not ported yet: ROADMAP.md, Queue 1, "
            "'ResNet and MobileNet backbones'"
        )
    if name != "efficientnet":
        raise ValueError(f"unknown model {name!r}; choices: {MODEL_REGISTRY}")
    model = EffNetAttention(label_dim=label_dim, b=eff_b, head_num=head_num,
                            dtype=dtype, drop_connect_rate=drop_connect_rate,
                            remat=remat)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = 1.0 - bn_momentum
        if isinstance(mod, (SameConv2d, MultiHeadAttentionPool, AttentionPool,
                            MeanPool)):
            mod.reset_parameters(generator)
    return model
