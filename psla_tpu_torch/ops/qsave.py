"""int8 activation compression of the depthwise convolutions' inputs (port
of ``psla_tpu/ops/qsave.py``; ROADMAP Queue 1 item 9).

The input of an MBConv block's depthwise convolution is the expanded
tensor, the largest a block keeps for backward. Two compressions of it,
selected by ``act_compress`` (``models.layers.conv_bn``):

* ``q8save``: the forward is the uncompressed convolution, bit for bit;
  the convolution keeps its input for backward as per-channel int8 with a
  float32 scale a channel (``DwConvQ8Save``), not at the activation's
  width. Only the weight gradient reads it (the data gradient of a
  convolution does not depend on its input), so only that gradient
  carries quantization error.
* ``qdq``: a straight-through quantize-dequantize of the input before the
  convolution (``qdq``): the forward sees the int8 values, the gradient
  passes as through the identity.

Plain PyTorch, as the JAX module is ``jnp`` ops under a ``custom_vjp``. The
layout is NCHW, so the channel axis is 1 where the JAX package's NHWC
puts it last; ``quantize_int8`` gives the JAX function's ``q`` and
``scale`` bit for bit on the same values.
"""

from __future__ import annotations

import torch

INT8_MAX = 127.0


def _channel_shape(x: torch.Tensor, axis: int) -> list[int]:
    shape = [1] * x.dim()
    shape[axis % x.dim()] = -1
    return shape


def quantize_int8(x: torch.Tensor, axis: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 along ``axis``: (q int8 of ``x``'s shape,
    scale float32 [C]), scale = max(amax, 1e-12) / 127, q = x / scale
    rounded half to even (``jnp.round``'s rule) and clipped to +-127."""
    axis = axis % x.dim()
    dims = tuple(i for i in range(x.dim()) if i != axis)
    # |x| and its max are exact in x's own dtype: no float32 copy for them
    amax = x.abs().amax(dim=dims).float()
    scale = torch.clamp(amax, min=1e-12) / INT8_MAX
    # a bfloat16 x promotes to float32 in the division: one float32 tensor
    q = torch.div(x.float() if x.dtype == torch.float64 else x,
                  scale.view(_channel_shape(x, axis)))
    return q.round_().clamp_(-INT8_MAX, INT8_MAX).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, axis: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """q x scale in float32, rounded once to ``dtype``."""
    return (q.float() * scale.view(_channel_shape(q, axis))).to(dtype)


def qdq(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """Straight-through quantize-dequantize: the int8 values forward, the
    identity's gradient backward (the JAX expression
    ``x + stop_gradient(deq - x)``, rounded as it rounds)."""
    q, scale = quantize_int8(x.detach(), axis)
    deq = dequantize_int8(q, scale, axis, x.dtype)
    return x + (deq - x).detach()


class DwConvQ8Save(torch.autograd.Function):
    """A grouped convolution whose backward reads its input as int8.

    ``apply(x, weight, stride, padding)``: ``F.conv2d(x, weight, None,
    stride, padding, 1, groups=weight.shape[0])``, the call
    ``SameConv2d.forward`` makes, so the output is the uncompressed one.
    Saved for backward: ``quantize_int8(x)`` and the weight. Backward
    dequantizes the input to the weight's dtype (the compute dtype: the
    caller casts both) and returns both gradients of the convolution at
    that input; the data gradient does not read it, and is exact."""

    @staticmethod
    def forward(ctx, x, weight, stride: int, padding: tuple[int, int]):
        y = torch.nn.functional.conv2d(x, weight, None, stride, padding, 1, weight.shape[0])
        q, scale = quantize_int8(x, axis=1)
        ctx.save_for_backward(q, scale, weight)
        ctx.stride, ctx.padding = stride, padding
        return y

    @staticmethod
    def backward(ctx, grad):
        q, scale, weight = ctx.saved_tensors
        xq = dequantize_int8(q, scale, 1, weight.dtype)
        dx, dw, _ = torch.ops.aten.convolution_backward(
            grad, xq, weight, None, [ctx.stride] * 2, list(ctx.padding), [1, 1], False,
            [0, 0], weight.shape[0], [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return dx, dw, None, None
