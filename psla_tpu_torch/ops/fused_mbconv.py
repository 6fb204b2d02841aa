"""Fused eval-mode MBConv block, v1: two passes that recompute.

Port of ``psla_tpu/ops/fused_mbconv.py``. One stride-1 EfficientNet block in
eval mode, BatchNorm folded into the convs (``fold_block_params`` from the
JAX package's variables, ``fold_block`` from the port's own
``MBConvBlock``): expand 1x1 + swish -> depthwise kxk (SAME) + swish ->
squeeze-excite -> project 1x1 (+ residual). Layout NHWC, as the JAX
functions have it.

The block runs in two passes over row tiles of the flattened map, and the
expanded tensors never reach device memory: pass 1 computes expand +
depthwise per tile and keeps only per-channel sums for the squeeze-excite
mean; the small SE MLP runs between the passes in PyTorch; pass 2 computes
expand + depthwise again, gates, projects and adds the residual.

Kernels (CUDA C++ for sm_90a):

* ``mbconv_pass1`` (``csrc/mbconv_pass1.cu``) replaces
  ``psla_tpu/ops/fused_mbconv.py::_pass1_kernel``;
* ``mbconv_pass2`` (``csrc/mbconv_pass2.cu``) replaces
  ``psla_tpu/ops/fused_mbconv.py::_pass2_kernel``.

Both stage x and take the taps with the same code
(``csrc/mbconv_front.cuh``). Their outputs do not depend on ``tile``, so each
takes 2-D windows and expanded-channel slices of its own
(``pass1_geometry``, ``pass2_geometry``).

``pass1_plain`` and ``pass2_plain`` are their plain versions: the JAX
algorithm itself (tiles of ``tile`` flattened rows with a halo of
``m*W + m`` rows, the row mask and the per-``dw`` column masks, per-tile
sums added in tile order), so ``tile`` means the same on the CPU and the
masking is tested there; the kernels' results do not depend on it. A CPU
tensor takes the plain versions; a CUDA tensor launches the kernels or
raises. ``LAUNCHES_PASS1`` and ``LAUNCHES_PASS2`` count the kernels'
launches.

``fast=True`` rounds the operands of the two 1x1 products to bfloat16 and
sums in float32, keeps the expanded activation in bfloat16 and takes each
depthwise tap's product in bfloat16; the depthwise output and the gate
stay float32 (the JAX kernel's rounding points).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from psla_tpu_torch.cuda_build import CudaLibrary

# Launches of the two kernels in this process (plain versions do not count).
LAUNCHES_PASS1 = 0
LAUNCHES_PASS2 = 0

KEYS = ("w1", "b1", "wd", "bd", "wr", "br", "we", "be", "wp", "bp")


def _bind(lib: ctypes.CDLL):
    lib.psla_mbconv_pass1_launch.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    )
    lib.psla_mbconv_pass1_launch.restype = ctypes.c_int


def _bind_pass2(lib: ctypes.CDLL):
    lib.psla_mbconv_pass2_launch.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 17 + [ctypes.c_void_p]
    )
    lib.psla_mbconv_pass2_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("mbconv_pass1.cu", "psla_mbconv_pass1", _bind)
PASS2_LIBRARY = CudaLibrary("mbconv_pass2.cu", "psla_mbconv_pass2", _bind_pass2)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load pass 1's library; returns the handle."""
    return LIBRARY.load()


def build_pass2() -> ctypes.CDLL:
    """Compile (if needed) and load pass 2's library; returns the handle."""
    return PASS2_LIBRARY.load()


# ------------------------------------------------------------------ folding


def _bn_affine(bn_params, bn_stats, eps=1e-3):
    scale = np.asarray(bn_params["scale"], np.float64)
    bias = np.asarray(bn_params["bias"], np.float64)
    mean = np.asarray(bn_stats["mean"], np.float64)
    var = np.asarray(bn_stats["var"], np.float64)
    s = scale / np.sqrt(var + eps)
    return s, bias - mean * s


def _fold(expand, depthwise, project, se, device) -> dict[str, torch.Tensor]:
    """Fold (kernel, (scale, bias, mean, var)) pairs in float64.

    ``expand`` and ``project`` kernels are [Cin, Cout], ``depthwise`` is
    [k, k, Ce]; ``se`` is (wr [Ce, Cse], br, we [Cse, Ce], be)."""
    out = {}
    if expand is not None:
        w, bn = expand
        s, b = _bn_affine(*bn)
        out["w1"] = w * s[None, :]
        out["b1"] = b
    w, bn = depthwise
    s, b = _bn_affine(*bn)
    out["wd"] = w.reshape(-1, w.shape[-1]) * s[None, :]
    out["bd"] = b
    out["wr"], out["br"], out["we"], out["be"] = se
    w, bn = project
    s, b = _bn_affine(*bn)
    out["wp"] = w * s[None, :]
    out["bp"] = b
    return {
        key: torch.from_numpy(np.array(v, np.float32, order="C")).to(device)
        for key, v in out.items()
    }


def fold_block_params(block_params: dict, block_stats: dict,
                      device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """JAX MBConvBlock params + batch_stats (numpy) -> BN-folded weights.

    Keys and shapes: ``w1`` [Cin, Ce] and ``b1`` [Ce] (absent when
    expand_ratio is 1), ``wd`` [k*k, Ce] (row ``dh*k + dw``), ``bd`` [Ce],
    ``wr`` [Ce, Cse], ``br`` [Cse], ``we`` [Cse, Ce], ``be`` [Ce],
    ``wp`` [Ce, Cout], ``bp`` [Cout]; float32 on ``device``."""
    def bn(name):
        p, s = block_params[name]["bn"], block_stats[name]["bn"]
        return {"scale": p["scale"], "bias": p["bias"]}, {"mean": s["mean"], "var": s["var"]}

    def kernel(name):
        return np.asarray(block_params[name]["conv"]["kernel"], np.float64)

    expand = ((kernel("expand")[0, 0], bn("expand"))
              if "expand" in block_params else None)
    se = tuple(np.asarray(x, np.float32) for x in (
        block_params["se_reduce"]["kernel"][0, 0], block_params["se_reduce"]["bias"],
        block_params["se_expand"]["kernel"][0, 0], block_params["se_expand"]["bias"]))
    return _fold(expand, (kernel("depthwise")[:, :, 0, :], bn("depthwise")),
                 (kernel("project")[0, 0], bn("project")), se, device)


def fold_block(block) -> dict[str, torch.Tensor]:
    """The port's ``MBConvBlock`` (OIHW convs, eval BatchNorm) -> the same
    dict as ``fold_block_params``, on the block's device."""
    def bn(mod):
        f = lambda t: t.detach().cpu().numpy().astype(np.float64)  # noqa: E731
        return ({"scale": f(mod.weight), "bias": f(mod.bias)},
                {"mean": f(mod.running_mean), "var": f(mod.running_var)}, mod.eps)

    def w(conv):  # [O, I, kh, kw] -> [kh, kw, I, O] (HWIO)
        return conv.weight.detach().cpu().numpy().astype(np.float64).transpose(2, 3, 1, 0)

    device = block._depthwise_conv.weight.device
    expand = ((w(block._expand_conv)[0, 0], bn(block._bn0))
              if hasattr(block, "_expand_conv") else None)
    f32 = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    se = (w(block._se_reduce)[0, 0].astype(np.float32), f32(block._se_reduce.bias),
          w(block._se_expand)[0, 0].astype(np.float32), f32(block._se_expand.bias))
    return _fold(expand, (w(block._depthwise_conv)[:, :, 0, :], bn(block._bn1)),
                 (w(block._project_conv)[0, 0], bn(block._bn2)), se, device)


# ------------------------------------------------------------------ checks


def check_args(x: torch.Tensor, folded: dict, kernel: int, stride: int,
               dtypes: tuple[torch.dtype, ...], name: str):
    """Shapes, dtypes, contiguity and devices the kernels take."""
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be [B, H, W, Cin], got {tuple(x.shape)}")
    if x.dtype not in dtypes:
        raise ValueError(f"{name}: x must be one of {dtypes}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous (NHWC)")
    if kernel not in (3, 5):
        raise ValueError(f"{name}: kernel must be 3 or 5, got {kernel}")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    has_expand = "w1" in folded
    ce = folded["wd"].shape[1]
    cin = x.shape[-1]
    if folded["wd"].shape[0] != kernel * kernel:
        raise ValueError(f"{name}: wd is {tuple(folded['wd'].shape)} for kernel {kernel}")
    if has_expand and tuple(folded["w1"].shape) != (cin, ce):
        raise ValueError(f"{name}: w1 is {tuple(folded['w1'].shape)}, x has Cin {cin}")
    if not has_expand and ce != cin:
        raise ValueError(f"{name}: no expand, but Ce {ce} != Cin {cin}")
    for key in KEYS:
        if key not in folded:
            if key in ("w1", "b1") and not has_expand:
                continue
            raise ValueError(f"{name}: folded lacks {key!r}")
        t = folded[key]
        if t.device != x.device:
            raise ValueError(f"{name}: folded[{key!r}] is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: folded[{key!r}] must be contiguous float32")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def dot(a: torch.Tensor, w: torch.Tensor, fast: bool) -> torch.Tensor:
    """The kernels' 1x1 product: bf16 operands summed in f32 when ``fast``."""
    if fast:
        return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()
    return a.float() @ w


def se_gate(mean: torch.Tensor, folded: dict) -> torch.Tensor:
    """Squeeze-excite MLP: per-clip channel means [B, Ce] -> gate [B, Ce]."""
    hidden = F.silu(mean @ folded["wr"] + folded["br"])
    return torch.sigmoid(hidden @ folded["we"] + folded["be"])


# ------------------------------------------------------------------ plain


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _geometry(x: torch.Tensor, kernel: int, tile: int):
    b, h, w, cin = x.shape
    hw = h * w
    m = kernel // 2
    hl = _round_up(m * w + m, 8)
    tile = min(tile, _round_up(hw, 8))
    return b, h, w, cin, hw, m, hl, tile, -(-hw // tile)


def _padded_rows(x: torch.Tensor, hl: int, tile: int, n_tiles: int) -> torch.Tensor:
    b, h, w, cin = x.shape
    x_flat = x.reshape(b, h * w, cin).float()
    rows_pad = n_tiles * tile + 2 * hl
    return F.pad(x_flat, (0, 0, hl, rows_pad - h * w - hl))


def _expand_depthwise(chunk, folded, g0, *, tile, hl, m, width, hw, fast):
    """chunk [B, tile + 2*hl, Cin] -> (post-depthwise swish [B, tile, Ce] f32,
    global row indices [tile]); the JAX ``_expand_depthwise``."""
    act = torch.bfloat16 if fast else torch.float32
    dev = chunk.device
    src = (g0 - hl) + torch.arange(chunk.shape[1], device=dev)
    e = F.silu(dot(chunk, folded["w1"], fast) + folded["b1"]) if "w1" in folded else chunk
    row_ok = ((src >= 0) & (src < hw)).to(act)[None, :, None]
    e = e.to(act) * row_ok
    gidx = g0 + torch.arange(tile, device=dev)
    col = gidx % width
    wd = folded["wd"].to(act)
    acc = torch.zeros(chunk.shape[0], tile, e.shape[-1], device=dev)
    for dw in range(-m, m + 1):  # one column mask per dw, shared across dh
        cmask = ((col + dw >= 0) & (col + dw < width)).float()[None, :, None]
        part = torch.zeros_like(acc)
        for dh in range(-m, m + 1):
            off = dh * width + dw
            j = (dh + m) * (2 * m + 1) + (dw + m)
            part = part + (e[:, hl + off: hl + off + tile] * wd[j]).float()
        acc = acc + part * cmask
    return F.silu(acc + folded["bd"]), gidx


def pass1_plain(x: torch.Tensor, folded: dict, kernel: int, fast: bool = True,
                tile: int = 2048) -> torch.Tensor:
    """Pass 1's plain version: per-clip channel sums [B, Ce] (float32) of the
    post-depthwise activation, per-tile sums added in tile order."""
    b, h, w, cin, hw, m, hl, tile, n_tiles = _geometry(x, kernel, tile)
    x_pad = _padded_rows(x, hl, tile, n_tiles)
    sums = torch.zeros(b, folded["wd"].shape[1], device=x.device)
    for t in range(n_tiles):
        d, gidx = _expand_depthwise(
            x_pad[:, t * tile: t * tile + tile + 2 * hl], folded, t * tile,
            tile=tile, hl=hl, m=m, width=w, hw=hw, fast=fast)
        sums = sums + (d * (gidx < hw).float()[None, :, None]).sum(dim=1)
    return sums


def pass2_plain(x: torch.Tensor, folded: dict, gate: torch.Tensor, kernel: int,
                fast: bool = True, tile: int = 2048) -> torch.Tensor:
    """Pass 2's plain version: [B, H, W, Cin] and the gate [B, Ce] ->
    [B, H, W, Cout] float32."""
    b, h, w, cin, hw, m, hl, tile, n_tiles = _geometry(x, kernel, tile)
    x_pad = _padded_rows(x, hl, tile, n_tiles)
    cout = folded["wp"].shape[1]
    out = []
    for t in range(n_tiles):
        chunk = x_pad[:, t * tile: t * tile + tile + 2 * hl]
        d, _ = _expand_depthwise(chunk, folded, t * tile, tile=tile, hl=hl, m=m,
                                 width=w, hw=hw, fast=fast)
        p = dot(d * gate[:, None, :], folded["wp"], fast) + folded["bp"]
        if cin == cout:
            p = p + chunk[:, hl: hl + tile]
        out.append(p)
    return torch.cat(out, dim=1)[:, :hw].reshape(b, h, w, cout)


def fused_mbconv_eval_plain(x: torch.Tensor, folded: dict, kernel: int,
                            fast: bool = True, tile: int = 2048) -> torch.Tensor:
    """The block through the two plain passes and the SE MLP."""
    hw = x.shape[1] * x.shape[2]
    gate = se_gate(pass1_plain(x, folded, kernel, fast, tile) / float(hw), folded)
    return pass2_plain(x, folded, gate, kernel, fast, tile)


# ------------------------------------------------------------------ pass-2 geometry

P2_THREADS = 256     # threads a block (8 warps)
P2_CHUNK = 32        # expanded channels of one chunk
P2_MAX_P = 64        # output pixels of one window, at most
P2_TN = (2, 4, 8, 12, 16, 24)  # output channels a thread holds (kernel templates)
P2_MAX_WASTE = 0.125  # share of computed pixels that may lie outside the map
SMEM_LIMIT = 232448  # dynamic shared memory a block may opt in to (H100)


@dataclasses.dataclass(frozen=True)
class Pass2Geometry:
    """Launch geometry of the pass-2 kernel (``csrc/mbconv_pass2.cu``).

    A block owns one ``th`` x ``tw`` window of output pixels of one clip and
    one slice of ``slice_len`` expanded channels; the grid is ``windows``
    (over all clips) x ``slices``. In the projection thread ``t < tp * tc``
    holds pixels ``4 * (t // tc) + i`` (i < 4) and output channels
    ``t % tc + tc * j`` (j < ``tn``)."""

    th: int
    tw: int
    windows: int      # over all clips: b * ceil(h / th) * ceil(w / tw)
    slices: int       # S: partial products summed by a second kernel when > 1
    slice_len: int    # expanded channels of a slice (a multiple of P2_CHUNK)
    p: int            # th * tw
    tp: int           # pixel groups of four: ceil(p / 4)
    tc: int           # output-channel groups
    tn: int           # output channels a thread holds (one of P2_TN)
    threads: int
    smem: int         # dynamic shared memory, bytes

    @property
    def ctas(self) -> int:
        return self.windows * self.slices


def _p2_proj(tp: int, cout: int):
    """(cost, tc, tn) of the cheapest projection layout for tp pixel groups:
    time goes with the warps each of the 4 schedulers runs times tn."""
    best = None
    for tn in P2_TN:
        tc = -(-cout // tn)
        if tp * tc > P2_THREADS:
            continue
        warps = -(-(tp * tc) // 32)
        cost = -(-warps // 4) * tn
        if best is None or cost < best[0]:
            best = (cost, tc, tn)
    return best


def _front_cost(nw: int, p: int, cin: int, k: int, has_expand: bool) -> int:
    """Cycles the front of one window takes for a chunk of 32 expanded
    channels, roughly: the expand over ``nw`` halo pixels in rounds of 64
    (16 an input channel), and the taps of ``p`` output pixels (8 warps, 2
    a scheduler)."""
    expand = -(-nw // 64) * 16 * _round_up(cin, 4) if has_expand else nw
    return expand + -(-p // 8) * (2 * k * k + 12) * 2


def _p2_smem(nw: int, cin: int, tp: int, tc: int, tn: int, k: int,
             has_expand: bool) -> int:
    """Shared memory of one block, floats -> bytes (mirrors smem_floats()
    in csrc/mbconv_pass2.cu)."""
    xs = nw * (_round_up(cin, 8) + 4)          # the halo window of x
    es = nw * P2_CHUNK                          # e of one chunk
    gt = P2_CHUNK * (4 * tp + 4)                # gated d, transposed
    w1 = _round_up(cin, 4) * P2_CHUNK if has_expand else 0  # w1's chunk
    wp = P2_CHUNK * _round_up(tc * tn, 4)       # wp's rows of the chunk
    small = (k * k + 3) * P2_CHUNK              # wd, b1, bd, gate of the chunk
    return 4 * (xs + es + gt + w1 + wp + small)


@functools.lru_cache(maxsize=None)
def pass2_geometry(b: int, h: int, w: int, cin: int, ce: int, cout: int, k: int,
                   sm_count: int, has_expand: bool | None = None) -> Pass2Geometry:
    """The pass-2 kernel's window, slices and block shape for one block.

    The window is the one with the least work (halo recompute of the expand
    in 64-row rounds, the depthwise, the projection) whose computed pixels
    outside the map stay within ``P2_MAX_WASTE`` and whose shared memory
    fits; then S is the smallest number of expanded-channel slices that
    gives at least two blocks of threads an SM, each slice of at least 64
    channels (or S = 1). Pass 2's output does not depend on the JAX
    function's ``tile``, so the geometry does not either. ``has_expand``
    defaults to Ce != Cin (EfficientNet's blocks without expand have
    Ce == Cin)."""
    m = k // 2
    if has_expand is None:
        has_expand = ce != cin
    best = None
    for th in range(1, min(h, P2_MAX_P) + 1):
        for tw in range(1, min(w, P2_MAX_P // th) + 1):
            nh, nwin_w = -(-h // th), -(-w // tw)
            if 1 - h * w / (nh * th * nwin_w * tw) > P2_MAX_WASTE:
                continue
            p = th * tw
            tp = -(-p // 4)
            proj = _p2_proj(tp, cout)
            if proj is None:
                continue
            nw = (th + 2 * m) * (tw + 2 * m)
            smem = _p2_smem(nw, cin, tp, proj[1], proj[2], k, has_expand)
            if smem > SMEM_LIMIT:
                continue
            # cycles a chunk of 32 expanded channels takes, roughly: the
            # front, and the projection (32 channels x 4 pixels x tn, per
            # warp a scheduler runs)
            front = _front_cost(nw, 4 * tp, cin, k, has_expand)
            cost = nh * nwin_w * (front + 128 * proj[0])
            key = (cost, -p)
            if best is None or key < best[0]:
                best = (key, th, tw, nh * nwin_w, tp, proj[1], proj[2], smem)
    if best is None:
        raise ValueError(f"pass 2: no window fits Cin {cin}, Cout {cout}, k {k}")
    _, th, tw, per_clip, tp, tc, tn, smem = best
    windows = b * per_clip
    slices, slice_len = 1, _round_up(ce, P2_CHUNK)
    for s in range(2, ce // 64 + 1):
        if windows * slices >= 2 * sm_count:
            break
        length = _round_up(-(-ce // s), P2_CHUNK)
        n = -(-ce // length)
        if ce - (n - 1) * length < 64:
            continue
        slices, slice_len = n, length
    return Pass2Geometry(th=th, tw=tw, windows=windows, slices=slices,
                         slice_len=slice_len, p=th * tw, tp=tp, tc=tc, tn=tn,
                         threads=P2_THREADS, smem=smem)


# ------------------------------------------------------------------ pass-1 geometry

P1_MAX_P = 256  # output pixels of one window, at most (taps: 32 a warp)


@dataclasses.dataclass(frozen=True)
class Pass1Geometry:
    """Launch geometry of the pass-1 kernel (``csrc/mbconv_pass1.cu``).

    A block of ``threads`` threads owns one ``th`` x ``tw`` window of output
    pixels of one clip and one slice of ``slice_len`` expanded channels; the
    grid is ``windows`` (over all clips) x ``slices``, and the per-window
    sums [B, ``per_clip``, Ce] are added in window order by a second
    kernel."""

    th: int
    tw: int
    per_clip: int     # windows a clip: ceil(h / th) * ceil(w / tw)
    windows: int      # over all clips: b * per_clip
    slices: int       # S
    slice_len: int    # expanded channels of a slice (a multiple of P2_CHUNK)
    p: int            # th * tw
    threads: int
    smem: int         # dynamic shared memory, bytes

    @property
    def ctas(self) -> int:
        return self.windows * self.slices


def _p1_smem(nw: int, cin: int, k: int, has_expand: bool) -> int:
    """Shared memory of one block, floats -> bytes (mirrors smem_floats()
    in csrc/mbconv_pass1.cu)."""
    xs = nw * (_round_up(cin, 8) + 4)          # the halo window of x
    es = nw * P2_CHUNK                          # e of one chunk
    w1 = _round_up(cin, 4) * P2_CHUNK if has_expand else 0  # w1's chunk
    # b1; wd and bd in two buffers; the 8 warps' sums in two tables
    small = P2_CHUNK + 2 * (k * k + 1) * P2_CHUNK + 2 * 8 * P2_CHUNK
    return 4 * (xs + es + w1 + small)


@functools.lru_cache(maxsize=None)
def pass1_geometry(b: int, h: int, w: int, cin: int, ce: int, k: int, sm_count: int,
                   has_expand: bool | None = None) -> Pass1Geometry:
    """The pass-1 kernel's window and slices for one block.

    The window is the one with the least work of the front (the expand over
    the halo in 64-row rounds, the taps: pass 2's model without the
    projection) whose computed pixels outside the map stay within
    ``P2_MAX_WASTE`` and whose shared memory fits. Windows reach
    ``P1_MAX_P`` pixels: the work that model counts over B2's blocks stops
    falling there. Then S is the smallest number of slices of whole chunks
    that gives at least two blocks of threads an SM (or one chunk a slice).
    Pass 1's sums do not depend on the JAX function's ``tile``, so the
    geometry does not either. ``has_expand`` defaults to Ce != Cin."""
    m = k // 2
    if has_expand is None:
        has_expand = ce != cin
    best = None
    for th in range(1, min(h, P1_MAX_P) + 1):
        for tw in range(1, min(w, P1_MAX_P // th) + 1):
            nh, nwin_w = -(-h // th), -(-w // tw)
            if 1 - h * w / (nh * th * nwin_w * tw) > P2_MAX_WASTE:
                continue
            nw = (th + 2 * m) * (tw + 2 * m)
            smem = _p1_smem(nw, cin, k, has_expand)
            if smem > SMEM_LIMIT:
                continue
            cost = nh * nwin_w * _front_cost(nw, th * tw, cin, k, has_expand)
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, th, tw, nh * nwin_w, smem)
    if best is None:
        raise ValueError(f"pass 1: no window fits Cin {cin}, k {k}")
    _, th, tw, per_clip, smem = best
    windows = b * per_clip
    chunks = -(-ce // P2_CHUNK)
    for s in range(1, chunks + 1):
        slice_len = -(-chunks // s) * P2_CHUNK
        slices = -(-ce // slice_len)
        if windows * slices >= 2 * sm_count:
            break
    return Pass1Geometry(th=th, tw=tw, per_clip=per_clip, windows=windows, slices=slices,
                         slice_len=slice_len, p=th * tw, threads=P2_THREADS, smem=smem)


# ------------------------------------------------------------------ kernels


def _ptr(folded: dict, key: str) -> int | None:
    return folded[key].data_ptr() if key in folded else None


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def mbconv_pass1(x: torch.Tensor, folded: dict, kernel: int, fast: bool = True,
                 tile: int = 2048) -> torch.Tensor:
    """Pass 1 (kernel on CUDA, plain version on the CPU): [B, Ce] sums.

    ``tile`` is the JAX function's row tile: checked, and used by the plain
    version; the sums do not depend on it, and the kernel takes its windows
    and slices from ``pass1_geometry``."""
    check_args(x, folded, kernel, 1, (torch.float32,), "mbconv_pass1")
    if tile <= 0:
        raise ValueError(f"mbconv_pass1: tile must be positive, got {tile}")
    if x.device.type == "cpu":
        return pass1_plain(x, folded, kernel, fast, tile)
    if x.shape[0] > 65535:
        raise ValueError(f"mbconv_pass1: at most 65535 clips, got {x.shape[0]}")
    b, h, w, cin = x.shape
    ce = folded["wd"].shape[1]
    geo = pass1_geometry(b, h, w, cin, ce, kernel, _sm_count(x.device), "w1" in folded)
    partial = torch.empty((b, geo.per_clip, ce), dtype=torch.float32, device=x.device)
    sums = torch.empty((b, ce), dtype=torch.float32, device=x.device)
    lib = build()
    err = lib.psla_mbconv_pass1_launch(
        x.data_ptr(), _ptr(folded, "w1"), _ptr(folded, "b1"), folded["wd"].data_ptr(),
        folded["bd"].data_ptr(), partial.data_ptr(), sums.data_ptr(),
        b, h, w, cin, ce, kernel, int(fast), int("w1" in folded),
        geo.th, geo.tw, geo.slices, geo.slice_len, geo.threads, geo.smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mbconv pass-1 kernel launch failed: CUDA error {err}")
    global LAUNCHES_PASS1
    LAUNCHES_PASS1 += 1
    return sums


def mbconv_pass2(x: torch.Tensor, folded: dict, gate: torch.Tensor, kernel: int,
                 fast: bool = True, tile: int = 2048) -> torch.Tensor:
    """Pass 2 (kernel on CUDA, plain version on the CPU): [B, H, W, Cout].

    ``tile`` is the JAX function's row tile: checked, and used by the plain
    version; the output does not depend on it, and the kernel takes its
    windows and slices from ``pass2_geometry``."""
    check_args(x, folded, kernel, 1, (torch.float32,), "mbconv_pass2")
    ce = folded["wd"].shape[1]
    if tuple(gate.shape) != (x.shape[0], ce) or gate.dtype != torch.float32 \
            or gate.device != x.device or not gate.is_contiguous():
        raise ValueError(f"mbconv_pass2: gate must be contiguous float32 [B, Ce] "
                         f"on x's device, got {tuple(gate.shape)} {gate.dtype}")
    if tile <= 0:
        raise ValueError(f"mbconv_pass2: tile must be positive, got {tile}")
    if x.device.type == "cpu":
        return pass2_plain(x, folded, gate, kernel, fast, tile)
    if x.shape[0] > 65535:
        raise ValueError(f"mbconv_pass2: at most 65535 clips, got {x.shape[0]}")
    b, h, w, cin = x.shape
    cout = folded["wp"].shape[1]
    geo = pass2_geometry(b, h, w, cin, ce, cout, kernel, _sm_count(x.device),
                         "w1" in folded)
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    partial = (torch.empty((geo.slices, b * h * w, cout), dtype=torch.float32,
                           device=x.device) if geo.slices > 1 else None)
    lib = build_pass2()
    err = lib.psla_mbconv_pass2_launch(
        x.data_ptr(), _ptr(folded, "w1"), _ptr(folded, "b1"), folded["wd"].data_ptr(),
        folded["bd"].data_ptr(), gate.data_ptr(), folded["wp"].data_ptr(),
        folded["bp"].data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(),
        b, h, w, cin, ce, cout, kernel, int(fast), int("w1" in folded),
        geo.th, geo.tw, geo.slices, geo.slice_len, geo.tc, geo.tn, geo.threads, geo.smem,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mbconv pass-2 kernel launch failed: CUDA error {err}")
    global LAUNCHES_PASS2
    LAUNCHES_PASS2 += 1
    return out


def fused_mbconv_eval(x: torch.Tensor, folded: dict, kernel: int, fast: bool = True,
                      tile: int = 2048, *, stride: int = 1) -> torch.Tensor:
    """One stride-1 MBConv block, eval mode: [B, H, W, Cin] float32 ->
    [B, H, W, Cout] float32. ``folded``: ``fold_block_params`` or
    ``fold_block``. The residual is added when Cin == Cout. Stride-2 blocks
    go to ``mbconv_vmem.fused_mbconv_eval_v2``."""
    if stride != 1:
        raise ValueError(f"fused_mbconv_eval takes stride 1 only, got {stride}")
    check_args(x, folded, kernel, 1, (torch.float32,), "fused_mbconv_eval")
    if x.device.type == "cpu":
        return fused_mbconv_eval_plain(x, folded, kernel, fast, tile)
    hw = x.shape[1] * x.shape[2]
    gate = se_gate(mbconv_pass1(x, folded, kernel, fast, tile) / float(hw), folded)
    return mbconv_pass2(x, folded, gate.contiguous(), kernel, fast, tile)
