"""The v2 phase kernels' launch geometry (psla_tpu_torch.ops.mbconv_vmem.
v2_geometry) and the arithmetic they imply, on the CPU.

The kernels (csrc/mbconv_v2.cu) run only on the card. Here:

* the geometry on every block of EfficientNet-B2 at the serving shape (16
  clips, 64 x 528 after the stem, 132 SMs): the product tiles cover each
  product once, the depthwise windows' halos stay in the padded map, shared
  memory fits, and the grids fill the card;
* the 3xTF32 products of ``fast=False`` emulated in numpy (TF32 rounding to
  nearest with ties away from zero, the three products of each 8-deep
  k-step summed from zero and added to the float32 sum, K's runs added in
  order where the product splits K) against float64, at
  the JAX package's f32 bars (3e-6 abs with rtol 1e-5, or 1e-5 of max
  |ref| for the long sums); one TF32 product misses them. The tensor
  cores' own rounding inside a k-step is not modelled: the card run holds
  the kernel itself to the same bars;
* the depthwise kernel's window sums and the squeeze-excite kernel's sums,
  in their order, composed with the plain front and project into the JAX
  ``fused_mbconv_eval_v2`` (Pallas in interpret mode, as
  tests/test_mbconv_vmem.py runs it) at 3e-6 abs and rtol 1e-5;
* the wrapper's zero padding of channel counts that are not multiples of 8
  leaves the block's output as it was (the plain version on both).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from psla_tpu.ops.mbconv_vmem import fused_mbconv_eval_v2 as jax_v2
from psla_tpu_torch import ops
from psla_tpu_torch.models.efficientnet import efficientnet_arch
from psla_tpu_torch.ops import mbconv_vmem as v2
from tests.torch_mbconv_fixtures import nhwc_input, random_block

torch.set_num_threads(2)

SM_COUNT = 132
CLIPS = 16
SMEM_LIMIT = 232448  # 227 KB, the most a block of threads may opt in to


def b2_blocks() -> list[tuple[int, int, int, int, int, int, int, int]]:
    """[(k, stride, h, w, cin, ce, cse, cout)] of EfficientNet-B2's 23
    blocks at the serving shape (64 x 528 after the stem)."""
    _, stages, _ = efficientnet_arch(2)
    h, w, out = 64, 528, []
    for args, repeats in stages:
        for r in range(repeats):
            stride = args.stride if r == 0 else 1
            cin = args.in_filters if r == 0 else args.out_filters
            out.append((args.kernel, stride, h, w, cin, cin * args.expand_ratio,
                        max(1, int(cin * 0.25)), args.out_filters))
            h, w = -(-h // stride), -(-w // stride)
    return out


B2 = b2_blocks()


def _covered_once(extent: int, tile: int, tiles: int) -> bool:
    count = np.zeros(tiles * tile, np.int64)
    for t in range(tiles):
        count[t * tile:(t + 1) * tile] += 1
    return bool((count[:extent] == 1).all()) and (tiles - 1) * tile < extent


# ------------------------------------------------------------------ (a) geometry


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("index", range(23))
def test_geometry_on_b2_blocks(index, fast):
    k, s, h, w, cin, ce, cse, cout = B2[index]
    geo = v2.v2_geometry(CLIPS, h, w, cin, ce, cse, cout, k, s, SM_COUNT, None, fast, False)
    ho, lo_h, hi_h = v2.same_pad(h, k, s)
    wo, lo_w, hi_w = v2.same_pad(w, k, s)
    # A: the expand product [16 * h * w, ce], one segment; D: the project
    # product [ho * wo, cout] in 16 segments (clips) of whole row tiles
    products = [(geo.project, CLIPS, ho * wo, cout, ce)]
    if ce != cin:
        products.append((geo.expand, 1, CLIPS * h * w, ce, cin))
    else:
        assert geo.expand is None
    for g, segs, rows, n, kk in products:
        assert (g.segs, g.rows, g.n, g.k) == (segs, rows, n, kk)
        assert _covered_once(rows, g.bm, g.tiles_m) and _covered_once(n, g.bn, g.tiles_n)
        assert g.ni in v2.GEMM_NI and g.wm * g.wn <= v2.MAX_WARPS and g.threads <= 256
        assert g.ctas >= SM_COUNT
        assert g.smem <= SMEM_LIMIT
        # K runs: each non-empty, together all of K's chunks once
        nk, runs = -(-kk // v2.BK), g.splits
        cps = -(-nk // runs)
        assert 1 <= runs <= v2.GEMM_MAX_SPLITS and (runs - 1) * cps < nk <= runs * cps
        assert runs == 1 or nk // runs >= v2.GEMM_SPLIT_CHUNKS
    # B: windows tile the output map once; each window's halo, over its
    # pixels in the map, lies in the SAME-padded input
    assert geo.windows == -(-ho // geo.th) * -(-wo // geo.tw)
    assert geo.th * geo.tw <= v2.DW_MAX_P
    assert _covered_once(ho, geo.th, geo.nwy) and _covered_once(wo, geo.tw, geo.nwx)
    for wy in range(geo.nwy):
        last = min(ho, (wy + 1) * geo.th) - 1
        assert wy * geo.th * s - lo_h >= -lo_h
        assert last * s - lo_h + k - 1 <= h + hi_h - 1
    for wx in range(geo.nwx):
        last = min(wo, (wx + 1) * geo.tw) - 1
        assert last * s - lo_w + k - 1 <= w + hi_w - 1
    assert geo.dw_slices == -(-ce // v2.DW_CW)
    assert CLIPS * geo.windows * geo.dw_slices >= 2 * SM_COUNT
    assert geo.dw_smem <= v2.DW_SMEM_MAX <= SMEM_LIMIT
    # C: one block a clip, so 16 blocks of threads: the one phase that
    # cannot fill the card at 16 clips
    assert geo.se_smem <= SMEM_LIMIT
    assert 1 <= geo.se_wg <= geo.windows and geo.se_wg * ce <= max(v2.SE_THREADS, ce)
    assert geo.se_groups * cse <= max(v2.SE_THREADS, cse)


def test_geometry_is_cached_and_mirrors_the_smem_rule():
    a = v2.v2_geometry(CLIPS, 4, 33, 352, 2112, 88, 352, 3, 1, SM_COUNT)
    assert a is v2.v2_geometry(CLIPS, 4, 33, 352, 2112, 88, 352, 3, 1, SM_COUNT)
    # A rows: bfloat16 80 bytes; float32 144 (TF32 fragments) or 160 (bf16
    # pairs); B rows 8 or 4 words past a multiple of 32
    assert (v2.a_pitch_bytes(2, True), v2.a_pitch_bytes(4, False),
            v2.a_pitch_bytes(4, True)) == (80, 144, 160)
    assert (v2.b_pitch(16, False), v2.b_pitch(16, True), v2.b_pitch(64, True)) == (40, 36, 68)
    for fast in (False, True):
        g = v2.v2_geometry(CLIPS, 4, 33, 352, 2112, 88, 352, 3, 1, SM_COUNT, None, fast).project
        assert g.smem == v2.gemm_smem(g.bm, g.bn, g.k, 2 if fast else 4, fast, True)
    # double-buffered chunks, one buffer where K fits one chunk
    assert [v2.gemm_stages(k) for k in (16, 32, 33, 2112)] == [1, 1, 2, 2]


# ------------------------------------------------------------------ (b) 3xTF32


def tf32(a: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32: float32 to 10 mantissa bits, to nearest, ties away
    from zero."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def products_3xtf32(a: np.ndarray, b: np.ndarray, runs: int = 1) -> np.ndarray:
    """The kernel's fast=False product: each 8-deep k-step sums big*small,
    small*big and big*big from zero in float32, then adds to the run's sum;
    K's 32-deep chunks are cut into ``runs`` runs, whose sums are added in
    run order."""
    a_big = tf32(a)
    a_small = tf32(a - a_big)
    b_big = tf32(b)
    b_small = tf32(b - b_big)
    k = a.shape[1]
    nk = -(-k // 32)
    cps = -(-nk // runs)
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for r in range(runs):
        acc = np.zeros_like(out)
        for k0 in range(32 * r * cps, min(k, 32 * (r + 1) * cps), 8):
            step = np.zeros_like(acc)
            for x, y in ((a_big, b_small), (a_small, b_big), (a_big, b_big)):
                for kk in range(k0, min(k0 + 8, k)):
                    step = step + np.outer(x[:, kk], y[kk])  # exact: 11 x 11 bits
            acc = acc + step
        out = out + acc
    return out


def products_tf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    a, b = tf32(a), tf32(b)
    for kk in range(a.shape[1]):
        acc = acc + np.outer(a[:, kk], b[kk])
    return acc


def within_f32_bars(got: np.ndarray, ref: np.ndarray) -> bool:
    return bool(np.allclose(got, ref, atol=3e-6, rtol=1e-5)
                or np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("k", [16, 144, 1248, 2112])
def test_3xtf32_split_meets_the_f32_bars(k):
    """Operands drawn like a B2 block's: swish activations of unit-variance
    pre-activations, and a folded 1x1 kernel (normal over fan-in, times a
    BatchNorm scale near 1)."""
    rng = np.random.default_rng(k)
    z = rng.standard_normal((64, k))
    a = (z / (1 + np.exp(-z))).astype(np.float32)
    b = (rng.normal(0.0, np.sqrt(1.0 / k), (k, 24))
         * rng.uniform(0.8, 1.2, 24) / np.sqrt(rng.uniform(0.5, 1.5, 24) + 1e-3)
         ).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    assert within_f32_bars(products_3xtf32(a, b), ref)
    if k >= 4 * 32 * 4:  # K long enough for the project's four runs
        assert within_f32_bars(products_3xtf32(a, b, runs=4), ref)
    assert not within_f32_bars(products_tf32(a, b), ref)  # one TF32 product misses


def test_tf32_rounding():
    x = np.array([1.0, 1 + 2.0 ** -11, 1 + 2.0 ** -10 + 2.0 ** -11, -(1 + 2.0 ** -11),
                  1 + 2.0 ** -12], np.float32)
    np.testing.assert_array_equal(
        tf32(x), np.array([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -9, -(1 + 2.0 ** -10), 1.0],
                          np.float32))


# ------------------------------------------------------------------ (c) window sums, SE


def f32_sum(terms) -> np.float32:
    s = np.float32(0.0)
    for t in terms:
        s = np.float32(s + np.float32(t))
    return s


def emulate_gate(d: np.ndarray, folded: dict, geo: v2.V2Geometry) -> np.ndarray:
    """The depthwise kernel's window sums of d [B, Ho, Wo, Ce] and the
    squeeze-excite kernel, in their orders, in float32 -> gate [B, Ce]."""
    b, ho, wo, ce = d.shape
    wr, br, we, be = (folded[key].numpy() for key in ("wr", "br", "we", "be"))
    cse = wr.shape[1]
    # window (wy, wx): its pixels q (row-major in the window) in the map; the
    # sums of q = i (mod 16), each in pixel order, added for i = 0..15
    partial = np.zeros((b, geo.windows, ce), np.float32)
    for wy in range(geo.nwy):
        for wx in range(geo.nwx):
            rows = [[] for _ in range(16)]
            for q in range(geo.th * geo.tw):
                y, x = wy * geo.th + q // geo.tw, wx * geo.tw + q % geo.tw
                if y < ho and x < wo:
                    rows[q % 16].append(d[:, y, x])
            s = np.zeros((b, ce), np.float32)
            for r in rows:
                t = np.zeros((b, ce), np.float32)
                for v in r:
                    t = t + v
                s = s + t
            partial[:, wy * geo.nwx + wx] = s
    gate = np.zeros((b, ce), np.float32)
    run = -(-geo.windows // geo.se_wg)
    for bi in range(b):
        mean = np.zeros(ce, np.float32)
        for c in range(ce):
            parts = [f32_sum(partial[bi, g * run:min(geo.windows, (g + 1) * run), c])
                     for g in range(geo.se_wg)]
            mean[c] = np.float32(f32_sum(parts) / np.float32(ho * wo))
        hid = np.zeros(cse, np.float32)
        for j in range(cse):
            parts = []
            for g in range(geo.se_groups):
                s = np.float32(0.0)
                for c in range(g, ce, geo.se_groups):  # fmaf: one rounding
                    s = np.float32(np.float64(s) + np.float64(mean[c]) * np.float64(wr[c, j]))
                parts.append(s)
            z = np.float32(f32_sum(parts) + br[j])
            hid[j] = np.float32(z / (np.float32(1) + np.exp(-z, dtype=np.float32)))
        for c in range(ce):
            s = np.float32(0.0)
            for j in range(cse):
                s = np.float32(np.float64(s) + np.float64(hid[j]) * np.float64(we[j, c]))
            z = np.float32(s + be[c])
            gate[bi, c] = np.float32(1) / (np.float32(1) + np.exp(-z, dtype=np.float32))
    return gate


def plain_front(x: torch.Tensor, folded: dict, k: int, s: int) -> torch.Tensor:
    """d = swish(depthwise(swish(x @ w1 + b1)) + bd), float32, SAME."""
    b, h, w, _ = x.shape
    ho, lo_h, hi_h = v2.same_pad(h, k, s)
    wo, lo_w, hi_w = v2.same_pad(w, k, s)
    e = F.silu(x @ folded["w1"] + folded["b1"]) if "w1" in folded else x
    e = F.pad(e, (0, 0, lo_w, hi_w, lo_h, hi_h))
    acc = torch.zeros(b, ho, wo, e.shape[-1])
    for dw in range(k):
        for dh in range(k):
            acc = acc + e[:, dh: dh + (ho - 1) * s + 1: s,
                          dw: dw + (wo - 1) * s + 1: s] * folded["wd"][dh * k + dw]
    return F.silu(acc + folded["bd"])


# (kernel, stride, cin, cout, expand, h, w, sm_count): many 1-row windows
# (the 132-SM grid search at 2 clips), windows past 16 pixels, stride 2 with
# odd extents, no expand
EMULATED = [(3, 1, 16, 16, 6, 9, 25, SM_COUNT), (5, 1, 24, 24, 6, 10, 22, 2),
            (5, 2, 24, 40, 6, 13, 29, 2), (3, 1, 32, 16, 1, 12, 30, 2)]


@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_window_and_se_sums_give_the_jax_block(shape):
    k, s, cin, cout, expand, h, w, sms = shape
    blk = random_block(k, s, cin, cout, expand, seed=h + w)
    folded = ops.fold_block(blk)
    x = nhwc_input(2, h, w, cin, seed=cin + k)
    ce, cse = folded["wr"].shape
    geo = v2.v2_geometry(2, h, w, cin, ce, cse, cout, k, s, sms)
    if sms == 2:
        assert geo.th * geo.tw > 16  # the mod-16 rows hold several pixels each
    assert geo.windows > 1
    d = plain_front(x, folded, k, s)
    gate = torch.from_numpy(emulate_gate(d.numpy(), folded, geo))
    # the gate against the plain version's own (sums in another order)
    ref_gate = v2.se_gate(d.sum(dim=(1, 2)) / float(d.shape[1] * d.shape[2]), folded)
    np.testing.assert_allclose(gate.numpy(), ref_gate.numpy(), atol=1e-6, rtol=1e-6)
    out = (d * gate[:, None, None, :]) @ folded["wp"] + folded["bp"]
    if s == 1 and cin == cout:
        out = out + x
    jf = {key: t.numpy() for key, t in folded.items()}
    ref = np.asarray(jax_v2(jnp.asarray(x.numpy()), jf, k, s, fast=False))
    np.testing.assert_allclose(out.numpy(), ref, atol=3e-6, rtol=1e-5)


# ------------------------------------------------------------------ (d) channel padding

# (kernel, stride, cin, cout, expand): ragged Cin, Ce and Cout, with the
# residual and without, and no expand (Ce = Cin)
RAGGED = [(3, 1, 12, 12, 6), (5, 2, 12, 20, 6), (3, 1, 20, 20, 1), (3, 2, 10, 14, 3)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", RAGGED)
def test_padded_channels_leave_the_block_unchanged(shape, fast):
    """The wrapper pads ragged channel counts with zeros (the kernels take
    multiples of 8): the plain version on the padded tensors, cut to Cout,
    gives the block on the tensors as they were."""
    k, s, cin, cout, expand = shape
    folded = ops.fold_block(random_block(k, s, cin, cout, expand, seed=cin + cout))
    x = nhwc_input(2, 6, 9, cin, seed=k + s)
    xp, fp = v2.pad_channels(x, folded)
    cin_p, ce_p, cout_p = xp.shape[-1], fp["wr"].shape[0], fp["wp"].shape[1]
    assert (cin_p % 8, ce_p % 8, cout_p % 8) == (0, 0, 0)
    assert (cin_p - cin, cout_p - cout) == (-cin % 8, -cout % 8)
    # the plain version decides the residual from the shapes: the same here
    assert (s == 1 and cin_p == cout_p) == (s == 1 and cin == cout)
    got = v2.fused_mbconv_eval_v2_plain(xp, fp, k, s, fast)[..., :cout]
    ref = v2.fused_mbconv_eval_v2_plain(x, folded, k, s, fast)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)


def test_aligned_multiples_of_8_pass_through():
    folded = ops.fold_block(random_block(3, 1, 16, 16, 6, seed=1))
    x = nhwc_input(2, 5, 7, 16, seed=1)
    xp, fp = v2.pad_channels(x, folded)
    assert xp is x and all(fp[key] is t for key, t in folded.items())
    unaligned = torch.zeros(2 * 5 * 7 * 16 + 1)[1:].view(2, 5, 7, 16)  # 4 bytes past
    xa, _ = v2.pad_channels(unaligned, folded)
    assert xa.data_ptr() % 16 == 0 and torch.equal(xa, unaligned)
