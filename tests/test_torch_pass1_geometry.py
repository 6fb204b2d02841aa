"""The pass-1 kernel's launch geometry (psla_tpu_torch.ops.fused_mbconv.
pass1_geometry) and the decomposition it implies, on the CPU.

The kernel (csrc/mbconv_pass1.cu) runs only on the card. Here the geometry
is checked on every stride-1 block of EfficientNet-B2 at the serving shape
(16 clips, 64 x 528 after the stem, 132 SMs), and the kernel's split of the
work (2-D windows with a halo, slices of whole 32-channel chunks, per-window
channel sums added in window order) is emulated with the same rounding
points and held to ``pass1_plain`` at the JAX package's v1 bars: 2e-6 abs
per summed activation (2e-6 * H * W on a sum) with rtol 1e-5 in float32,
5e-2 with ``fast=True``. The emulated sums, through the SE MLP and
``pass2_plain``, are held to the JAX ``fused_mbconv_eval`` (Pallas in
interpret mode, as tests/test_fused_mbconv.py runs it) at 2e-6.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from psla_tpu.ops.fused_mbconv import fused_mbconv_eval as jax_v1
from psla_tpu_torch import ops
from psla_tpu_torch.ops import fused_mbconv as v1
from tests.torch_mbconv_fixtures import b2_stride1_blocks, nhwc_input, random_block

torch.set_num_threads(2)

SM_COUNT = 132
B2_BLOCKS = b2_stride1_blocks()


@pytest.mark.parametrize("index", range(19))
def test_geometry_on_b2_blocks(index):
    k, h, w, cin, ce, _ = B2_BLOCKS[index]
    geo = v1.pass1_geometry(16, h, w, cin, ce, k, SM_COUNT)
    nwy, nwx = -(-h // geo.th), -(-w // geo.tw)
    assert geo.per_clip == nwy * nwx and geo.windows == 16 * geo.per_clip
    # every pixel of a clip lies in exactly one window
    owned = np.zeros((h, w), np.int64)
    for wy in range(nwy):
        for wx in range(nwx):
            owned[wy * geo.th:(wy + 1) * geo.th, wx * geo.tw:(wx + 1) * geo.tw] += 1
    assert (owned == 1).all()
    assert geo.ctas >= 2 * SM_COUNT  # two blocks of threads an SM
    computed = geo.windows * geo.th * geo.tw
    assert (computed - 16 * h * w) / computed <= 0.125
    # the slices cover Ce in whole chunks of 32, the last one non-empty
    assert geo.slice_len % v1.P2_CHUNK == 0
    assert (geo.slices - 1) * geo.slice_len < ce <= geo.slices * geo.slice_len
    assert geo.smem <= 232448
    assert geo.p == geo.th * geo.tw <= v1.P1_MAX_P and geo.threads == 256


def test_slices_are_the_fewest_that_fill_the_card():
    """S is the smallest that gives two blocks of threads an SM: one slice
    fewer (of whole chunks) would not."""
    for k, h, w, cin, ce, _ in B2_BLOCKS:
        geo = v1.pass1_geometry(16, h, w, cin, ce, k, SM_COUNT)
        if geo.slices > 1:
            chunks = -(-ce // v1.P2_CHUNK)
            fewer = -(-ce // (-(-chunks // (geo.slices - 1)) * v1.P2_CHUNK))
            assert geo.windows * fewer < 2 * SM_COUNT


def emulate_pass1(x, folded, kernel, fast, geo):
    """csrc/mbconv_pass1.cu's split of the work, in PyTorch: per slice and
    window, expand + swish on the halo window (zero outside the map after
    the swish) and the taps grouped by dw; d summed over the window's pixels
    in the map; the per-window sums added in window order."""
    b, h, w, _ = x.shape
    m = kernel // 2
    ce = folded["wd"].shape[1]
    act = torch.bfloat16 if fast else torch.float32
    nwy, nwx = -(-h // geo.th), -(-w // geo.tw)
    hp, wp_ = nwy * geo.th, nwx * geo.tw
    xp = F.pad(x, (0, 0, m, m + wp_ - w, m, m + hp - h))
    inmap = F.pad(torch.ones(h, w), (m, m + wp_ - w, m, m + hp - h))
    partial = torch.zeros(b, nwy * nwx, ce)
    for s in range(geo.slices):
        lo, hi = s * geo.slice_len, min(ce, (s + 1) * geo.slice_len)
        for wy in range(nwy):
            for wx in range(nwx):
                y0, x0 = wy * geo.th, wx * geo.tw
                win = xp[:, y0:y0 + geo.th + 2 * m, x0:x0 + geo.tw + 2 * m]
                if "w1" in folded:
                    e = F.silu(v1.dot(win, folded["w1"][:, lo:hi], fast) + folded["b1"][lo:hi])
                else:
                    e = win[..., lo:hi]
                mask = inmap[y0:y0 + geo.th + 2 * m, x0:x0 + geo.tw + 2 * m]
                e = e.to(act) * mask[None, :, :, None].to(act)
                wd = folded["wd"][:, lo:hi].to(act)
                acc = torch.zeros(b, geo.th, geo.tw, hi - lo)
                for dw in range(kernel):
                    taps = torch.zeros_like(acc)
                    for dh in range(kernel):
                        taps = taps + (e[:, dh:dh + geo.th, dw:dw + geo.tw]
                                       * wd[dh * kernel + dw]).float()
                    acc = acc + taps
                d = F.silu(acc + folded["bd"][lo:hi])
                out_mask = inmap[m + y0:m + y0 + geo.th, m + x0:m + x0 + geo.tw]
                partial[:, wy * nwx + wx, lo:hi] = (d * out_mask[None, :, :, None]).sum((1, 2))
    sums = torch.zeros(b, ce)
    for t in range(nwy * nwx):  # window order
        sums = sums + partial[:, t]
    return sums


# (kernel, cin, expand, h, w): 3 slices of one chunk; k5 on a W=33 map;
# no expand with 2 slices; odd extents; several windows a clip
EMULATED = [(3, 16, 6, 8, 24), (5, 32, 6, 4, 33), (3, 64, 1, 8, 24), (3, 32, 6, 7, 13),
            (5, 8, 6, 20, 40)]


def _case(shape):
    kernel, cin, expand, h, w = shape
    blk = random_block(kernel, 1, cin, cin, expand, seed=cin + h)
    folded = ops.fold_block(blk)
    x = nhwc_input(2, h, w, cin, seed=w)
    ce = folded["wd"].shape[1]
    geo = v1.pass1_geometry(2, h, w, cin, ce, kernel, SM_COUNT)
    return kernel, folded, x, geo


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", EMULATED)
def test_kernel_decomposition_matches_plain_version(shape, fast):
    kernel, folded, x, geo = _case(shape)
    h, w = x.shape[1:3]
    assert geo.slices == -(-folded["wd"].shape[1] // v1.P2_CHUNK)  # one chunk a slice
    assert geo.per_clip > 1 or h * w <= v1.P1_MAX_P
    got = emulate_pass1(x, folded, kernel, fast, geo)
    ref = v1.pass1_plain(x, folded, kernel, fast, tile=64)
    bars = dict(atol=5e-2, rtol=5e-2) if fast else dict(atol=2e-6 * h * w, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **bars)


@pytest.mark.parametrize("shape", EMULATED[:4])
def test_emulated_sums_give_the_jax_block(shape):
    """The emulated sums -> the SE MLP -> pass2_plain against the JAX
    package's fused_mbconv_eval on the same folded weights."""
    kernel, folded, x, geo = _case(shape)
    hw = float(x.shape[1] * x.shape[2])
    gate = v1.se_gate(emulate_pass1(x, folded, kernel, False, geo) / hw, folded)
    got = v1.pass2_plain(x, folded, gate, kernel, fast=False, tile=64)
    jf = {key: t.numpy() for key, t in folded.items()}
    ref = np.asarray(jax_v1(jnp.asarray(x.numpy()), jf, kernel, fast=False, tile=64))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_cpu_wrapper_is_the_plain_version_for_any_tile(monkeypatch, fast):
    """On a CPU tensor mbconv_pass1 returns pass1_plain's result for each
    tile, builds nothing and launches nothing."""
    def no_build():
        raise AssertionError("the CUDA build must not be attempted on the CPU")

    monkeypatch.setattr(v1, "build", no_build)
    blk = random_block(5, 1, 24, 24, 6, seed=3)
    folded = ops.fold_block(blk)
    x = nhwc_input(2, 6, 11, 24, seed=3)
    outs = []
    for tile in (24, 2048):
        got = v1.mbconv_pass1(x, folded, 5, fast, tile)
        torch.testing.assert_close(got, v1.pass1_plain(x, folded, 5, fast, tile),
                                   rtol=0, atol=0)
        outs.append(got)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6 * 66, rtol=1e-6)
    assert v1.LAUNCHES_PASS1 == 0
    with pytest.raises(ValueError, match="tile"):
        v1.mbconv_pass1(x, folded, 5, fast, 0)
