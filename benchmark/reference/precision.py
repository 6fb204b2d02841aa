"""Operand rounding for the reference's matrix products and convolutions.

``float32`` leaves the operands alone (the reference proper, with TF32 off:
``float32_products``).
The lower precisions are the controls that the comparison deciding
``correct`` must reject, emulated the same way on the CPU and on the card:

* ``tf32``: each operand rounded to TF32 (10 mantissa bits, round to
  nearest even), as the tensor cores read float32 operands with TF32 on;
  the gradient that flows back through an operand is rounded the same
  way, since it is the operand of the backward products.
"""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("float32", "tf32")


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` with its mantissa rounded to 10 bits (nearest even)."""
    bits = t.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32).view(t.shape)


_ROUND = {"tf32": round_tf32}


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, precision):
        ctx.precision = precision
        return _ROUND[precision](t)

    @staticmethod
    def backward(ctx, g):
        return _ROUND[ctx.precision](g), None


@contextlib.contextmanager
def float32_products():
    """cuBLAS and cuDNN in full float32 (TF32 off: cuDNN allows it by
    default) inside the block, the flags restored after it."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as a product reads it at ``precision``."""
    if precision == "float32":
        return t
    if precision not in _ROUND:
        raise ValueError(f"unknown precision {precision!r}; choices: {PRECISIONS}")
    return _Round.apply(t, precision)
