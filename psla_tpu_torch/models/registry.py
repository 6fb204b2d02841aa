"""Model selection by name (reference: src/run.py:105-110)."""

from __future__ import annotations

import torch

from psla_tpu_torch.models.effnet_att import EffNetAttention
from psla_tpu_torch.models.layers import BatchNorm, PadConv2d, SameConv2d
from psla_tpu_torch.models.mobilenet import MBNet, MobileNetV2
from psla_tpu_torch.models.pooling import AttentionPool, MeanPool, MultiHeadAttentionPool
from psla_tpu_torch.models.resnet import ResNetAttention
from psla_tpu_torch.models.spectrogram_transformer import ASTModel

MODEL_REGISTRY = ("efficientnet", "resnet", "mbnet", "ast")


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
    act_compress: str = "none",
    input_fdim: int = 128,
    input_tdim: int = 1024,
) -> torch.nn.Module:
    """Build the module for a model name (run.py's --model choices), in
    eval mode.

    Weights are initialised as the JAX package initialises them (He-normal
    over fan-out for convs, the reference's uniform for the pooling heads,
    variance scaling for MBNet's classifier), drawn from ``generator``
    (default: seeded with 0). For EfficientNet, ``remat``,
    ``drop_connect_rate`` and ``act_compress`` (ops/qsave.py) act in train
    mode (models/efficientnet.py), and so does ``bn_momentum``, the running
    statistics' momentum in flax's convention (0.99 keeps 99% of the old
    statistics at each step, torch's momentum 0.01). ResNet and MBNet keep
    torch's momentum 0.1, ignore ``eff_b``, ``head_num`` (ResNet has one
    attention head, MBNet none), ``drop_connect_rate`` and ``bn_momentum``,
    and refuse ``remat`` and ``act_compress``, as the JAX package does.

    ``ast`` is AST-Base/16 (models/spectrogram_transformer.py) for
    ``input_fdim`` mel bins by ``input_tdim`` frames, its positional
    embedding sized for that grid. It ignores ``eff_b``, ``head_num``,
    ``drop_connect_rate`` and ``bn_momentum`` and refuses ``remat`` and
    ``act_compress``, as ResNet and MBNet do. The CNNs take any number of
    frames and ignore the two sizes.
    """
    if name == "efficientnet":
        model = EffNetAttention(label_dim=label_dim, b=eff_b, head_num=head_num,
                                dtype=dtype, drop_connect_rate=drop_connect_rate,
                                remat=remat, act_compress=act_compress)
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.momentum = 1.0 - bn_momentum
    elif name in ("resnet", "mbnet", "ast"):
        if remat or act_compress != "none":
            # refused rather than ignored (the reference's ignored-flag quirks
            # are not reproduced)
            raise ValueError(f"remat/act_compress are EfficientNet-only options "
                             f"(got model={name!r})")
        if name == "ast":
            model = ASTModel(label_dim=label_dim, input_fdim=input_fdim,
                             input_tdim=input_tdim, dtype=dtype)
        else:
            model = (ResNetAttention if name == "resnet" else MBNet)(label_dim=label_dim,
                                                                     dtype=dtype)
    else:
        raise ValueError(f"unknown model {name!r}; choices: {MODEL_REGISTRY}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for mod in model.modules():
        if isinstance(mod, (SameConv2d, PadConv2d, MultiHeadAttentionPool, AttentionPool,
                            MeanPool, ASTModel)):
            mod.reset_parameters(generator)
        elif isinstance(mod, MobileNetV2):
            mod.reset_classifier(generator)
    return model
