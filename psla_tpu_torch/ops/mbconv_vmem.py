"""Fused eval-mode MBConv block, v2: one call per block, stride 1 or 2.

Port of ``psla_tpu/ops/mbconv_vmem.py``. The same block as
``ops/fused_mbconv.py`` (BatchNorm folded by ``fold_block_params`` or
``fold_block``): expand 1x1 + swish -> depthwise kxk (SAME, stride 1 or 2)
+ swish -> squeeze-excite computed on the card -> project 1x1 (+ the
residual when stride is 1 and Cin == Cout). NHWC in and out, in the dtype
of x.

Kernels: ``csrc/mbconv_v2.cu`` (CUDA C++ for sm_90a) replaces
``psla_tpu/ops/mbconv_vmem.py::_eval_kernel``. The TPU kernel holds one
clip's whole map in VMEM; a Hopper SM has 228 KB of shared memory, and the
squeeze-excite mean needs all of a clip's depthwise output before any
output can be gated. So the block runs as four kernels in stream order,
each with its own grid and block shape (``v2_geometry``, cached per
shape): A. the expand product on the tensor cores into device scratch;
B. the depthwise taps over a window staged in shared memory, with
per-window channel sums; C. the squeeze-excite gate per clip; D. the
project product on the tensor cores with the gate applied as its A tile
is read (see the source's note). ``fused_mbconv_eval_v2_plain`` is its
plain version: padding of the post-expand activation and strided slices
per tap, with the kernels' rounding points. The TPU kernel's parity-plane
split was Mosaic's way around strided slices; neither the card nor the
plain version needs it.

A CPU tensor takes the plain version; a CUDA tensor launches the kernels
or raises. ``LAUNCHES`` counts the calls that launched them (one a block).
The kernels copy rows in 16-byte pieces: the wrapper pads channel counts
that are not multiples of 8 with zeros (``pad_channels``) and drops the
padded outputs.

``fast=True``: the 1x1 products take bfloat16 operands and sum in float32
(``mma.sync`` m16n8k16); the expanded activation, each depthwise tap's
product, the depthwise output and the gate are rounded to bfloat16 where
the JAX kernel rounds them; the squeeze-excite mean is taken of the
bfloat16 depthwise output. ``fast=False`` runs the products as 3xTF32
(m16n8k8: each float32 operand split into two TF32 parts, three products
summed in float32), everything else in float32.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F

from psla_tpu_torch.cuda_build import CudaLibrary
from psla_tpu_torch.ops.fused_mbconv import (
    KEYS,
    SMEM_LIMIT,
    _sm_count,
    check_args,
    dot,
    se_gate,
)

# Launches of the kernels in this process, one per block call (the plain
# version does not count).
LAUNCHES = 0

PHASES = {"expand": 1, "depthwise": 2, "se": 4, "project": 8}
ALL_PHASES = 15


def _bind(lib: ctypes.CDLL):
    lib.psla_mbconv_v2_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
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


# ------------------------------------------------------------------ geometry

BK = 32              # depth of one staged chunk of a product (elements)
CHANNEL_ALIGN = 8    # the kernels take channel counts in multiples of this
GEMM_NI = (1, 2, 4)  # n8 tiles a warp holds (kernel templates)
GEMM_MAX_SPLITS = 4  # runs of K, added in order by a second kernel
GEMM_SPLIT_WARPS = 16  # K is split while the grid holds fewer warps an SM
GEMM_SPLIT_CHUNKS = 4  # chunks of a run, at least
MAX_WARPS = 8
DW_CW = 32           # channels of one depthwise slice (a lane each)
DW_THREADS = 256
DW_MAX_P = 128       # output pixels of one depthwise window, at most
DW_SMEM_MAX = 64 * 1024  # a window's staged input, at most (three blocks an SM)
DW_MAX_WASTE = 0.125  # share of a window grid's pixels that may lie outside the map
SE_THREADS = 512


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pitch(n: int, mod: int) -> int:
    """The smallest pitch >= n (in 4-byte words) that is ``mod`` modulo 32:
    a warp's fragment loads then fall on distinct banks."""
    p = n - n % 32 + mod
    return p if p >= n else p + 32


def a_pitch_bytes(a_bytes: int, fast: bool) -> int:
    """Row pitch of a staged A chunk (BK elements) in bytes (mirrors
    a_pitch in csrc/mbconv_v2.cu). A float32 chunk read as bf16 pairs
    (float2) wants rows 8 words apart modulo 32, else 4; bfloat16 rows take
    20 words (distinct banks for both fragment shapes)."""
    if a_bytes == 2:
        return 80
    return 4 * _pitch(BK, 8 if fast else 4)


def b_pitch(bn: int, fast: bool) -> int:
    """Row pitch (floats) of a staged B chunk [BK, bn] (mirrors b_pitch in
    csrc/mbconv_v2.cu): bf16 pairs read rows 2t, 2t+1, TF32 rows t."""
    return _pitch(bn, 4 if fast else 8)


def gemm_stages(k: int) -> int:
    """Chunks of a product in flight: two (double-buffered), one where K
    fits one chunk."""
    return 1 if k <= BK else 2


def gemm_smem(bm: int, bn: int, k: int, a_bytes: int, fast: bool, gate: bool) -> int:
    """Shared memory of one product block, bytes (mirrors gemm_smem in
    csrc/mbconv_v2.cu): an A and a B chunk for each chunk in flight, and
    the clip's gate row (project only)."""
    a = bm * a_pitch_bytes(a_bytes, fast)
    b = BK * b_pitch(bn, fast) * 4
    g = 4 * _round_up(k, BK) if gate else 0
    return gemm_stages(k) * (a + b) + g


@dataclasses.dataclass(frozen=True)
class GemmGeometry:
    """One 1x1 product's tiles: C [segs * rows, n] = A [segs * rows, k] @ B.

    Rows come in ``segs`` segments of ``rows`` (the project product's
    segments are clips, so a tile never spans two clips and takes one gate
    row); a block of ``32 * wm * wn`` threads owns ``bm = 32 * wm`` rows of
    one segment and ``bn = 8 * ni * wn`` columns, each warp 32 rows x
    ``8 * ni`` columns. With ``splits`` > 1 each tile's K chunks are cut
    into that many runs, a block each, whose sums a second kernel adds in
    run order."""

    segs: int
    rows: int
    n: int
    k: int
    wm: int
    wn: int
    ni: int
    splits: int
    smem: int

    @property
    def bm(self) -> int:
        return 32 * self.wm

    @property
    def bn(self) -> int:
        return 8 * self.ni * self.wn

    @property
    def tiles_m(self) -> int:  # a segment
        return -(-self.rows // self.bm)

    @property
    def tiles_n(self) -> int:
        return -(-self.n // self.bn)

    @property
    def ctas(self) -> int:
        return self.segs * self.tiles_m * self.tiles_n * self.splits

    @property
    def threads(self) -> int:
        return 32 * self.wm * self.wn


def gemm_tiles(segs: int, rows: int, n: int, k: int, sm_count: int, *, a_bytes: int = 4,
               fast: bool = False, gate: bool = False) -> GemmGeometry:
    """The tiles of one product: among warp layouts of at most 8 warps and
    n8 tiles of ``GEMM_NI``, those that give at least two blocks of threads
    an SM (else one an SM, else all), the cheapest by a cost of padded
    products (three for 3xTF32, and more fragment loads per product for
    narrow warp tiles) plus the chunk reads from L2."""
    kp = _round_up(k, BK)
    cands = []
    for ni in GEMM_NI:
        for wn in range(1, MAX_WARPS + 1):
            for wm in (1, 2, 4, 8):
                if wm * wn > MAX_WARPS:
                    continue
                bm, bn = 32 * wm, 8 * ni * wn
                if bn > 8 * ni * max(1, -(-n // (8 * ni))):  # no all-padding warps
                    continue
                smem = gemm_smem(bm, bn, k, a_bytes, fast, gate)
                if smem > SMEM_LIMIT:
                    continue
                tm, tn = segs * -(-rows // bm), -(-n // bn)
                macs = tm * bm * tn * bn * kp * (1 if fast else 3) * (1 + 0.5 / ni)
                reads = tm * tn * kp * (bm + bn)
                cost = macs / 64 + reads
                cands.append((tm * tn, cost, -(wm * wn), GemmGeometry(
                    segs=segs, rows=rows, n=n, k=k, wm=wm, wn=wn, ni=ni, splits=1,
                    smem=smem)))
    most = max(c[0] for c in cands)
    for floor in (2 * sm_count, sm_count, most):
        ok = [c for c in cands if c[0] >= floor]
        if ok:
            return split_k(min(ok, key=lambda c: (c[1], c[2]))[3], sm_count)
    raise AssertionError("unreachable")


def split_k(g: GemmGeometry, sm_count: int) -> GemmGeometry:
    """Splits K into runs while the grid holds fewer than GEMM_SPLIT_WARPS
    warps an SM (a long K on few rows), up to GEMM_MAX_SPLITS runs of at
    least GEMM_SPLIT_CHUNKS chunks."""
    nk = -(-g.k // BK)
    splits = 1
    while (splits < GEMM_MAX_SPLITS and nk // (splits + 1) >= GEMM_SPLIT_CHUNKS
           and g.ctas * splits * g.wm * g.wn < GEMM_SPLIT_WARPS * sm_count):
        splits += 1
    return dataclasses.replace(g, splits=splits)


def dw_smem(th: int, tw: int, k: int, stride: int, e_bytes: int) -> int:
    """Shared memory of one depthwise block, bytes (mirrors dw_smem in
    csrc/mbconv_v2.cu): the window's input with its halo, DW_CW channels,
    and the channel sums of the sixteen half-warps (or of the eight warps'
    even and odd pixel rounds)."""
    hh, hw = (th - 1) * stride + k, (tw - 1) * stride + k
    return hh * hw * DW_CW * e_bytes + 4 * 2 * (DW_THREADS // 32) * DW_CW


def se_smem(ce: int, cse: int, wg: int, groups: int) -> int:
    """Shared memory of one squeeze-excite block, bytes (mirrors se_smem in
    csrc/mbconv_v2.cu): the mean, the partial sums, the hidden units."""
    return 4 * (ce + max(wg * ce, groups * cse) + cse)


@dataclasses.dataclass(frozen=True)
class V2Geometry:
    """The launch geometry of the four phase kernels of one block.

    ``expand`` (None without expand) and ``project`` are the two products.
    The depthwise kernel's block owns a ``th`` x ``tw`` window of output
    pixels of one clip and DW_CW channels; the clip's ``nwy`` x ``nwx``
    windows each write one channel sum. The squeeze-excite kernel runs one
    block of SE_THREADS threads a clip: ``se_wg`` groups of windows add the
    window sums (each group a run of windows in order, then the groups in
    order), and ``se_groups`` groups of channels share the hidden units'
    sums (each a stride of the channels, then the groups in order)."""

    expand: GemmGeometry | None
    th: int
    tw: int
    nwy: int
    nwx: int
    dw_slices: int
    dw_smem: int
    se_wg: int
    se_groups: int
    se_smem: int
    project: GemmGeometry

    @property
    def windows(self) -> int:  # a clip
        return self.nwy * self.nwx


def dw_window(b: int, ho: int, wo: int, k: int, stride: int, ce: int, sm_count: int,
              e_bytes: int = 4) -> tuple[int, int]:
    """The depthwise window: at most DW_MAX_P output pixels, computed pixels
    outside the map within DW_MAX_WASTE, staged input within DW_SMEM_MAX;
    the least staged halo input plus taps, among windows that give at least
    two blocks of threads an SM where some do."""
    slices = -(-ce // DW_CW)
    cands = []
    for th in range(1, min(ho, DW_MAX_P) + 1):
        for tw in range(1, min(wo, DW_MAX_P // th) + 1):
            nwy, nwx = -(-ho // th), -(-wo // tw)
            if 1 - ho * wo / (nwy * th * nwx * tw) > DW_MAX_WASTE:
                continue
            if dw_smem(th, tw, k, stride, e_bytes) > DW_SMEM_MAX:
                continue
            hh, hw = (th - 1) * stride + k, (tw - 1) * stride + k
            cost = nwy * nwx * (4 * hh * hw + th * tw * k * k)
            ctas = b * nwy * nwx * slices
            cands.append((ctas >= 2 * sm_count, cost, -th * tw, th, tw))
    fill = any(c[0] for c in cands)
    best = min((c for c in cands if c[0] == fill), key=lambda c: (c[1], c[2]))
    return best[3], best[4]


@functools.lru_cache(maxsize=None)
def v2_geometry(b: int, h: int, w: int, cin: int, ce: int, cse: int, cout: int, k: int,
                stride: int, sm_count: int, has_expand: bool | None = None,
                fast: bool = False, x_bf16: bool = False) -> V2Geometry:
    """Each phase kernel's tiles and grid for one block (cached per shape).
    ``has_expand`` defaults to Ce != Cin; ``fast`` and ``x_bf16`` set the
    element sizes and fragment paddings that shared memory depends on."""
    if has_expand is None:
        has_expand = ce != cin
    ho, _, _ = same_pad(h, k, stride)
    wo, _, _ = same_pad(w, k, stride)
    x_bytes = 2 if x_bf16 else 4
    act_bytes = 2 if fast else 4
    expand = (gemm_tiles(1, b * h * w, ce, cin, sm_count, a_bytes=x_bytes, fast=fast)
              if has_expand else None)
    e_bytes = act_bytes if has_expand else x_bytes
    th, tw = dw_window(b, ho, wo, k, stride, ce, sm_count, e_bytes)
    nwy, nwx = -(-ho // th), -(-wo // tw)
    wg = max(1, min(nwy * nwx, SE_THREADS // ce))
    groups = max(1, SE_THREADS // cse)
    project = gemm_tiles(b, ho * wo, cout, ce, sm_count, a_bytes=act_bytes, fast=fast,
                         gate=True)
    return V2Geometry(expand=expand, th=th, tw=tw, nwy=nwy, nwx=nwx,
                      dw_slices=-(-ce // DW_CW), dw_smem=dw_smem(th, tw, k, stride, e_bytes),
                      se_wg=wg, se_groups=groups, se_smem=se_smem(ce, cse, wg, groups),
                      project=project)


# ------------------------------------------------------------------ plain


def fused_mbconv_eval_v2_plain(x: torch.Tensor, folded: dict, kernel: int,
                               stride: int = 1, fast: bool = True) -> torch.Tensor:
    """The kernels' plain version: [B, H, W, Cin] -> [B, Ho, Wo, Cout]."""
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


# ------------------------------------------------------------------ kernels


def _gemm_ints(g: GemmGeometry | None) -> list[int]:
    if g is None:
        return [0] * 7
    return [g.wm, g.wn, g.ni, g.tiles_m, g.tiles_n, g.splits, g.smem]


def pad_channels(x: torch.Tensor, folded: dict) -> tuple[torch.Tensor, dict]:
    """x and the folded weights as the kernels take them: Cin, Ce and Cout
    padded with zeros up to multiples of CHANNEL_ALIGN (the kernels copy
    rows in 16-byte pieces), and every tensor on a 16-byte boundary. A
    padded expanded channel is 0 after the expand and after the depthwise
    (swish(0) = 0) and meets zero rows of wr and wp, so the first Cout
    output channels do not change; the caller drops the rest. EfficientNet's
    channel counts are multiples of 8: its tensors pass through as they are."""
    cin, ce, cout = x.shape[-1], folded["wr"].shape[0], folded["wp"].shape[1]
    pi, pe, po = (-c % CHANNEL_ALIGN for c in (cin, ce, cout))
    if not (pi or pe or po) and all(t.data_ptr() % 16 == 0 for t in (x, *folded.values())):
        return x, folded
    # padding at the end of each dimension, first to last
    amounts = {"w1": (pi, pe), "b1": (pe,), "wd": (0, pe), "bd": (pe,), "wr": (pe, 0),
               "br": (0,), "we": (0, pe), "be": (pe,), "wp": (pe, po), "bp": (po,)}

    def padded(t: torch.Tensor, amount: tuple[int, ...]) -> torch.Tensor:
        if any(amount):
            t = F.pad(t, [p for a in reversed(amount) for p in (0, a)])
        return t if t.data_ptr() % 16 == 0 else t.clone()

    return (padded(x, (0, 0, 0, pi)),
            {key: padded(t, amounts[key]) for key, t in folded.items()})


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What the shape of a block call fixes: the C side's dims and geometry
    arguments, the output's shape, and the scratch's size and layout (the
    byte offsets of e, d, the window sums, the gate and the K runs' sums,
    None where a block has none)."""

    dims: ctypes.Array
    geom: ctypes.Array
    out_shape: tuple[int, int, int, int]
    scratch_bytes: int
    offsets: tuple[int | None, ...]


@functools.lru_cache(maxsize=None)
def _plan(b: int, h: int, w: int, cin: int, ce: int, cse: int, cout: int, kernel: int,
          stride: int, sm_count: int, has_expand: bool, fast: bool, x_bf16: bool,
          residual: bool) -> _Plan:
    ho, _, _ = same_pad(h, kernel, stride)
    wo, _, _ = same_pad(w, kernel, stride)
    geo = v2_geometry(b, h, w, cin, ce, cse, cout, kernel, stride, sm_count, has_expand, fast,
                      x_bf16)
    act_bytes = 2 if fast else 4
    runs = [g.splits * g.segs * g.rows * g.n for g in (geo.expand, geo.project)
            if g is not None and g.splits > 1]
    sizes = (act_bytes * b * h * w * ce if has_expand else 0, act_bytes * b * ho * wo * ce,
             4 * b * geo.windows * ce, 4 * b * ce, 4 * max(runs, default=0))
    offsets, end = [], 0
    for size in sizes:  # each on a 256-byte boundary
        offsets.append(end if size else None)
        end += _round_up(size, 256)
    dims = (ctypes.c_int * 13)(b, h, w, cin, ce, cse, cout, kernel, stride, int(fast),
                               int(has_expand), int(x_bf16), int(residual))
    geom = (ctypes.c_int * 22)(
        *_gemm_ints(geo.expand), geo.th, geo.tw, geo.dw_smem, geo.se_wg, geo.se_groups,
        SE_THREADS, geo.se_smem, *_gemm_ints(geo.project), geo.nwy * geo.nwx)
    return _Plan(dims=dims, geom=geom, out_shape=(b, ho, wo, cout), scratch_bytes=end,
                 offsets=tuple(offsets))


def _runner(x: torch.Tensor, folded: dict, kernel: int, stride: int, fast: bool):
    """Allocates the output and the scratch of one block call and returns
    (out, launch), where ``launch(phases)`` launches the phase kernels in
    the mask (``PHASES``) on the current stream and raises on an error."""
    b, h, w, cin = x.shape
    cout = folded["wp"].shape[1]
    residual = stride == 1 and cin == cout
    x, folded = pad_channels(x, folded)
    ce, cse = folded["wr"].shape
    dev = x.device
    plan = _plan(b, h, w, x.shape[-1], ce, cse, folded["wp"].shape[1], kernel, stride,
                 _sm_count(dev), "w1" in folded, fast, x.dtype == torch.bfloat16, residual)
    out = torch.empty(plan.out_shape, dtype=x.dtype, device=dev)
    # One scratch allocation. Scratch freed on return is handed out again
    # only in stream order (the caching allocator), so after these launches
    # have read and written it.
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    base = scratch.data_ptr()
    ptrs = (ctypes.c_void_p * 17)(
        x.data_ptr(), *(folded[key].data_ptr() if key in folded else None for key in KEYS),
        out.data_ptr(), *(None if off is None else base + off for off in plan.offsets))
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = _Launcher(build(), ptrs, plan.dims, plan.geom, stream, (x, folded, out, scratch))
    return out[..., :cout], launch


class _Launcher:
    """Launches a block call's phase kernels; keeps its output and scratch
    alive."""

    def __init__(self, lib, ptrs, dims, geom, stream, keep):
        self.lib, self.ptrs, self.dims, self.geom = lib, ptrs, dims, geom
        self.stream, self.keep = stream, keep

    def __call__(self, phases: int = ALL_PHASES):
        err = self.lib.psla_mbconv_v2_launch(self.ptrs, self.dims, self.geom, phases,
                                             self.stream)
        if err != 0:
            raise RuntimeError(f"mbconv v2 kernel launch failed: CUDA error {err}")


def phase_launcher(x: torch.Tensor, folded: dict, kernel: int, stride: int = 1,
                   fast: bool = True):
    """(out, launch) for timing the phase kernels of one block on the card:
    ``launch(PHASES["depthwise"])`` runs that phase alone on the same
    scratch. Not counted in ``LAUNCHES``."""
    check_args(x, folded, kernel, stride, (torch.float32, torch.bfloat16), "phase_launcher")
    if x.device.type != "cuda":
        raise ValueError("phase_launcher: the phase kernels run on the card only")
    return _runner(x, folded, kernel, stride, fast)


def fused_mbconv_eval_v2(x: torch.Tensor, folded: dict, kernel: int, stride: int = 1,
                         fast: bool = True) -> torch.Tensor:
    """One MBConv block, eval mode (BN folded): [B, H, W, Cin] float32 or
    bfloat16 -> [B, Ho, Wo, Cout] in x's dtype. ``fast=True`` runs the
    products and taps in bfloat16 (f32 sums); ``fast=False`` is float32."""
    check_args(x, folded, kernel, stride, (torch.float32, torch.bfloat16),
               "fused_mbconv_eval_v2")
    if x.device.type == "cpu":
        return fused_mbconv_eval_v2_plain(x, folded, kernel, stride, fast)
    out, launch = _runner(x, folded, kernel, stride, fast)
    launch(ALL_PHASES)
    global LAUNCHES
    LAUNCHES += 1
    return out.contiguous()
