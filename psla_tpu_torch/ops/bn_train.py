"""Train-mode BatchNorm with the activation that follows it fused in, as
one hand-written CUDA kernel each way for Hopper (sm_90a).

Replaces no TPU kernel: it takes the place of cuDNN's train-mode BatchNorm
(``F.batch_norm``) and PyTorch's elementwise SiLU on the card. The kernels
are ``psla_tpu_torch/csrc/bn_train.cu``; its source note gives the bound
on an H100 (bytes: 8 B an element forward, 12 B backward) and the design.

``bn_act`` is the wrapper and ``bn_act_plain`` its plain version,
``F.batch_norm`` then the activation. A tensor on the CPU takes the plain
version; a CUDA tensor launches the kernels or raises. The forward keeps
x and the batch's [C] mean and invstd for the backward, which recomputes
the normalized value and the SiLU's slope from them (the plain version
keeps the normalized value too, for SiLU's backward).
``LAUNCHES_FW`` and ``LAUNCHES_BW`` count the kernels' launches.

``geometry`` chooses the launch from the shape alone: a cluster of G
blocks a channel, and whether a block holds its run of the channel in
shared memory (read once from device memory) or streams it twice.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from psla_tpu_torch.cuda_build import CudaLibrary

# Launches of the kernels in this process (the plain version does not count).
LAUNCHES_FW = 0
LAUNCHES_BW = 0

# The activations the kernels fuse: none and SiLU.
ACTS = (None, "silu")

# Shared with csrc/bn_train.cu: the most shared memory a held run takes
# (kSmemCap) and the largest cluster (kMaxCluster).
SMEM_CAP = 110 * 1024
MAX_CLUSTER = 16
# Held runs are cut to this where a cluster of up to MAX_CLUSTER allows:
# on the H100 runs of 50-75 KB ran 10-30% faster than runs of ~105 KB or
# ~26 KB (cluster sizes swept at B2's layer shapes).
HELD_TARGET = 72 * 1024
# Streamed runs take a cluster of 8 (16 where 8 a channel would leave SMs
# without a block): within 5% of the fastest cluster at every streamed B2
# shape swept.
STREAM_CLUSTER = 8


def _bind(lib: ctypes.CDLL):
    lib.psla_bn_fw_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
    )
    lib.psla_bn_fw_launch.restype = ctypes.c_int
    lib.psla_bn_bw_launch.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.psla_bn_bw_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("bn_train.cu", "psla_bn_train", _bind)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns the handle."""
    return LIBRARY.load()


@functools.lru_cache(maxsize=None)
def geometry(n: int, c: int, hw: int, vw: int, operands: int, sms: int) -> tuple[int, bool]:
    """(G, held) for a channel of ``n`` rows of ``hw`` floats, read as items
    of ``vw`` floats, with ``operands`` tensors of that shape to read (1
    forward: x; 2 backward: x and dz), on a card of ``sms`` SMs.

    Held: the smallest G whose runs (ceil(items / G) items of each operand)
    fit ``HELD_TARGET``, else the smallest whose runs fit ``SMEM_CAP``.
    Streamed, when no G up to ``MAX_CLUSTER`` holds the run:
    ``STREAM_CLUSTER``, doubled if the C * G blocks would leave SMs empty."""
    items = n * hw // vw
    item_bytes = 4 * vw * operands
    for cap in (HELD_TARGET, SMEM_CAP):
        g = 1
        while g <= MAX_CLUSTER:
            if -(-items // g) * item_bytes <= cap:
                return g, True
            g *= 2
    return (STREAM_CLUSTER if STREAM_CLUSTER * c >= sms else 2 * STREAM_CLUSTER), False


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _GradInOwnStrides(torch.autograd.Function):
    """The identity, whose backward hands on the gradient in exactly the
    strides of its input (a copy where they differ, else the gradient
    itself). ``F.batch_norm``'s train-mode backward on the CPU computes
    wrong dx, dweight and dbias (off by more than their norm) when the
    output's gradient is channels-last with a non-canonical stride on a
    size-1 last dimension, on a contiguous input: what
    ``EffNetAttention.forward``'s ``mean(dim=2).transpose(1, 2)`` hands
    back when one time step is left after the last stride (T' = 1, a
    ``target_length`` of 32 or less). ``g.contiguous(memory_format=...)``
    would not do: its check ignores size-1 dimensions and can return the
    odd strides unchanged."""

    @staticmethod
    def forward(ctx, y):
        ctx.size, ctx.stride = y.shape, y.stride()
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if g.stride() == ctx.stride:
            return g
        return torch.empty_strided(ctx.size, ctx.stride, dtype=g.dtype,
                                   device=g.device).copy_(g)


def bn_act_plain(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor, momentum: float, eps: float,
                 act: str | None = None) -> torch.Tensor:
    """The kernels' plain version: ``F.batch_norm`` in train mode (the
    running statistics updated in place), then ``act``."""
    y = F.batch_norm(x, running_mean, running_var, weight, bias, True, momentum, eps)
    y = _GradInOwnStrides.apply(y)
    return F.silu(y) if act == "silu" else y


def _vw(*tensors: torch.Tensor) -> int:
    """4 (16-byte items) where every row and every pointer allows it, else 1."""
    hw = tensors[0].shape[2] * tensors[0].shape[3]
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return 4 if hw % 4 == 0 and aligned else 1


class _BatchNormAct(torch.autograd.Function):
    """z = act(BN(x)) with the batch's statistics, by the two kernels."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, act):
        global LAUNCHES_FW
        x = x.contiguous()
        n, c, h, w = x.shape
        dev = x.get_device()
        z = torch.empty_like(x)
        stats = torch.empty((2, c), dtype=torch.float32, device=x.device)  # mean, invstd
        vw = _vw(x, z)
        g, held = geometry(n, c, h * w, vw, 1, _sms(dev))
        err = build().psla_bn_fw_launch(
            x.data_ptr(), z.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            running_mean.data_ptr(), running_var.data_ptr(), stats.data_ptr(),
            stats.data_ptr() + 4 * c, n, c, h * w, vw, g, int(held), ACTS.index(act),
            float(momentum), float(eps), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"BatchNorm forward kernel launch failed: CUDA error {err}")
        LAUNCHES_FW += 1
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.act = act
        return z

    @staticmethod
    def backward(ctx, dz):
        global LAUNCHES_BW
        x, weight, bias, stats = ctx.saved_tensors
        dz = dz.contiguous()  # the T' = 1 head hands back odd strides
        n, c, h, w = x.shape
        dev = x.get_device()
        dx = torch.empty_like(x)
        dweight, dbias = torch.empty_like(weight), torch.empty_like(bias)
        vw = _vw(x, dz, dx)
        g, held = geometry(n, c, h * w, vw, 2, _sms(dev))
        err = build().psla_bn_bw_launch(
            x.data_ptr(), dz.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            stats.data_ptr(), stats.data_ptr() + 4 * c, dx.data_ptr(), dweight.data_ptr(),
            dbias.data_ptr(), n, c, h * w, vw, g, int(held), ACTS.index(ctx.act),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"BatchNorm backward kernel launch failed: CUDA error {err}")
        LAUNCHES_BW += 1
        return dx, dweight, dbias, None, None, None, None, None


def bn_act(x: torch.Tensor, running_mean: torch.Tensor, running_var: torch.Tensor,
           weight: torch.Tensor, bias: torch.Tensor, momentum: float, eps: float,
           act: str | None = None) -> torch.Tensor:
    """Train-mode BatchNorm of NCHW float32 ``x`` with the batch's
    statistics, then ``act`` (one of ``ACTS``); the running statistics are
    updated in place by ``F.batch_norm``'s rule (``momentum``, the unbiased
    variance)."""
    if act not in ACTS:
        raise ValueError(f"bn_act fuses the activations {ACTS}, got {act!r}")
    if x.is_cpu:
        return bn_act_plain(x, running_mean, running_var, weight, bias, momentum, eps, act)
    if not x.is_cuda:
        raise ValueError(f"bn_act: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"bn_act takes NCHW float32, got {x.dtype} {tuple(x.shape)}")
    c, dev = x.shape[1], x.get_device()
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        if (t.dtype != torch.float32 or t.shape != (c,) or not t.is_contiguous()
                or t.get_device() != dev):
            raise ValueError(f"bn_act: {name} must be contiguous float32 [{c}] on {x.device}")
    if x.numel() <= c:
        raise ValueError(f"Expected more than 1 value per channel when training, got input "
                         f"size {tuple(x.shape)}")
    return _BatchNormAct.apply(x, weight, bias, running_mean, running_var, momentum, eps, act)
