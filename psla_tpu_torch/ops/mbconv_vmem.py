"""Fused eval-mode MBConv block, v2: one launch per block, stride 1 or 2.

Port of ``psla_tpu/ops/mbconv_vmem.py``. The same block as
``ops/fused_mbconv.py`` (BatchNorm folded by ``fold_block_params`` or
``fold_block``): expand 1x1 + swish -> depthwise kxk (SAME, stride 1 or 2)
+ swish -> squeeze-excite computed in the kernel -> project 1x1 (+ the
residual when stride is 1 and Cin == Cout). NHWC in and out, in the dtype
of x.

Kernel: ``csrc/mbconv_v2.cu`` (CUDA C++ for sm_90a) replaces
``psla_tpu/ops/mbconv_vmem.py::_eval_kernel``. The TPU kernel holds one
clip's whole map in VMEM; a Hopper SM has 228 KB of shared memory, so the
kernel is one cooperative launch whose persistent blocks pass through
phases separated by grid-wide barriers and keep the expanded and the
depthwise activations in device scratch (see the source's note).
``fused_mbconv_eval_v2_plain`` is its plain version: padding of the
post-expand activation and strided slices per tap, with the kernel's
rounding points. The TPU kernel's parity-plane split was Mosaic's way
around strided slices; neither the card nor the plain version needs it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. ``LAUNCHES`` counts the kernel's launches.

``fast=True``: the 1x1 products take bfloat16 operands and sum in float32;
the expanded activation, each depthwise tap's product, the depthwise output
and the gate are rounded to bfloat16 where the JAX kernel rounds them; the
squeeze-excite mean is taken of the bfloat16 depthwise output.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from psla_tpu_torch.cuda_build import CudaLibrary
from psla_tpu_torch.ops.fused_mbconv import check_args, dot, se_gate

# Launches of the kernel in this process (the plain version does not count).
LAUNCHES = 0

# Output pixels of one depthwise work item (shared with csrc/mbconv_v2.cu).
_PT = 64


def _bind(lib: ctypes.CDLL):
    lib.psla_mbconv_v2_launch.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )
    lib.psla_mbconv_v2_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("mbconv_v2.cu", "psla_mbconv_v2", _bind)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns the handle."""
    return LIBRARY.load()


def same_pad(n: int, k: int, s: int) -> tuple[int, int, int]:
    """TF 'SAME' padding of one spatial axis: (out, lo, hi), the extra
    element at the high end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    lo = total // 2
    return out, lo, total - lo


def fused_mbconv_eval_v2_plain(x: torch.Tensor, folded: dict, kernel: int,
                               stride: int = 1, fast: bool = True) -> torch.Tensor:
    """The kernel's plain version: [B, H, W, Cin] -> [B, Ho, Wo, Cout]."""
    b, h, w, cin = x.shape
    k = kernel
    act = torch.bfloat16 if fast else torch.float32
    ho, lo_h, hi_h = same_pad(h, k, stride)
    wo, lo_w, hi_w = same_pad(w, k, stride)
    if "w1" in folded:
        e = F.silu(dot(x, folded["w1"], fast) + folded["b1"]).to(act)
    else:
        e = x.to(act)
    # SAME zeroes the depthwise input (the post-expand activation)
    e = F.pad(e, (0, 0, lo_w, hi_w, lo_h, hi_h))
    wd = folded["wd"].to(act)
    acc = torch.zeros(b, ho, wo, e.shape[-1], device=x.device)
    for dw in range(k):
        for dh in range(k):
            tap = e[:, dh: dh + (ho - 1) * stride + 1: stride,
                    dw: dw + (wo - 1) * stride + 1: stride]
            acc = acc + (tap * wd[dh * k + dw]).float()
    d = F.silu(acc + folded["bd"]).to(act)
    gate = se_gate(d.float().sum(dim=(1, 2)) / float(ho * wo), folded)
    g = d * gate[:, None, None, :].to(act)
    cout = folded["wp"].shape[1]
    p = dot(g, folded["wp"], fast) + folded["bp"]
    if stride == 1 and cin == cout:
        p = p + x.float()
    return p.to(x.dtype)


def fused_mbconv_eval_v2(x: torch.Tensor, folded: dict, kernel: int, stride: int = 1,
                         fast: bool = True) -> torch.Tensor:
    """One MBConv block, eval mode (BN folded): [B, H, W, Cin] float32 or
    bfloat16 -> [B, Ho, Wo, Cout] in x's dtype. ``fast=True`` runs the
    products and taps in bfloat16 (f32 sums); ``fast=False`` is float32."""
    check_args(x, folded, kernel, stride, (torch.float32, torch.bfloat16),
               "fused_mbconv_eval_v2")
    if x.device.type == "cpu":
        return fused_mbconv_eval_v2_plain(x, folded, kernel, stride, fast)
    b, h, w, cin = x.shape
    has_expand = "w1" in folded
    ce, cse = folded["wr"].shape
    cout = folded["wp"].shape[1]
    ho, _, _ = same_pad(h, kernel, stride)
    wo, _, _ = same_pad(w, kernel, stride)
    act = torch.bfloat16 if fast else torch.float32
    dev = x.device
    # Scratch freed on return is handed out again only in stream order (the
    # caching allocator), so after this launch has read and written it.
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=dev)
    e = torch.empty((b, h, w, ce), dtype=act, device=dev) if has_expand else None
    d = torch.empty((b, ho, wo, ce), dtype=act, device=dev)
    partial = torch.empty((b, -(-ho * wo // _PT), ce), dtype=torch.float32, device=dev)
    gate = torch.empty((b, ce), dtype=torch.float32, device=dev)
    ptr = lambda key: folded[key].data_ptr() if key in folded else None  # noqa: E731
    lib = build()
    err = lib.psla_mbconv_v2_launch(
        x.data_ptr(), ptr("w1"), ptr("b1"), ptr("wd"), ptr("bd"), ptr("wr"), ptr("br"),
        ptr("we"), ptr("be"), ptr("wp"), ptr("bp"), out.data_ptr(),
        None if e is None else e.data_ptr(), d.data_ptr(), partial.data_ptr(),
        gate.data_ptr(), b, h, w, cin, ce, cse, cout, kernel, stride, int(fast),
        int(has_expand), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mbconv v2 kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
