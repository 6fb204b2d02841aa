"""Fused eval MBConv blocks with hand-written CUDA kernels (port of psla_tpu.ops)."""

from psla_tpu_torch.ops.fused_mbconv import (  # noqa: F401
    fold_block,
    fold_block_params,
    fused_mbconv_eval,
)
from psla_tpu_torch.ops.mbconv_vmem import fused_mbconv_eval_v2  # noqa: F401
