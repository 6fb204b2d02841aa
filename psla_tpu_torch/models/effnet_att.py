"""EffNetAttention: the PSLA flagship model (src/models/Models.py:63-113).

Port of ``psla_tpu/models/effnet_att.py``. fbank ``[B, T, F]`` -> NCHW
``[B, 1, F, T]`` (frequency as image height, time as width, as the
reference feeds it) -> EfficientNet features -> mean over the residual
frequency axis -> attention pooling over time -> ``[B, n_classes]``
probabilities in (0, 1).

A model starts in eval mode (running BatchNorm statistics, no
stochastic depth); ``train()`` switches to batch statistics and
drop-connect (efficientnet.py), whose keep masks ``forward`` takes as
``keep``.
"""

from __future__ import annotations

import torch
from torch import nn

from psla_tpu_torch.models.efficientnet import EfficientNet
from psla_tpu_torch.models.pooling import AttentionPool, MeanPool, MultiHeadAttentionPool


class EffNetAttention(nn.Module):
    def __init__(self, label_dim: int = 527, b: int = 2, head_num: int = 4,
                 dtype: torch.dtype = torch.float32,
                 drop_connect_rate: float = 0.2, remat: bool = False,
                 act_compress: str = "none"):
        super().__init__()
        self.label_dim, self.b, self.head_num = label_dim, b, head_num
        # compute dtype of the forward; parameters stay float32
        self.dtype = dtype
        self.effnet = EfficientNet(b=b, drop_connect_rate=drop_connect_rate,
                                   remat=remat, act_compress=act_compress)
        c = self.effnet.feature_dim
        if head_num > 1:
            # the reference always builds 4 heads whatever head_num says
            # (Models.py:76-80); here head_num is honored, as in psla_tpu
            self.attention = MultiHeadAttentionPool(c, label_dim, head_num)
        elif head_num == 1:
            self.attention = AttentionPool(c, label_dim)
        elif head_num == 0:
            self.attention = MeanPool(c, label_dim)
        else:
            raise ValueError(
                "head_num must be >= 0 (0=mean pooling, 1=single-head, "
                ">1=multi-head attention)"
            )
        self.eval()

    def forward(self, x: torch.Tensor, return_stats: bool = False,
                keep: torch.Tensor | None = None):
        """[B, T, F] log-mel -> [B, label_dim] probabilities (float32), or the
        pooling partial sums with ``return_stats=True`` (see pooling.py).
        ``keep``: the drop-connect masks of train mode (EfficientNet.forward)."""
        x = x.transpose(1, 2).unsqueeze(1).to(self.dtype)  # [B, 1, F, T]
        feats = self.effnet(x, keep)  # [B, C, F/32, T/32]
        feats = feats.mean(dim=2).transpose(1, 2)  # [B, T/32, C]
        return self.attention(feats, return_stats=return_stats)
