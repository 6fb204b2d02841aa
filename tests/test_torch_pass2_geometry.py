"""The pass-2 kernel's launch geometry (psla_tpu_torch.ops.fused_mbconv.
pass2_geometry) and the decomposition it implies, on the CPU.

The kernel (csrc/mbconv_pass2.cu) runs only on the card. Here the geometry
is checked on every stride-1 block of EfficientNet-B2 at the serving shape
(16 clips, 64 x 528 after the stem, 132 SMs), and the kernel's split of the
work (2-D windows with a halo, expanded-channel slices whose partial
products are added in slice order, then bp and the residual) is emulated
with the same rounding points and held to ``pass2_plain`` at the JAX
package's v1 bars: 2e-6 abs with rtol 1e-5 in float32, 5e-2 with
``fast=True``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from psla_tpu_torch import ops
from psla_tpu_torch.ops import fused_mbconv as v1
from tests.torch_mbconv_fixtures import b2_stride1_blocks, nhwc_input, random_block

torch.set_num_threads(2)

SM_COUNT = 132
B2_BLOCKS = b2_stride1_blocks()


def test_b2_has_19_stride1_blocks():
    assert len(B2_BLOCKS) == 19
    assert B2_BLOCKS[-1] == (3, 4, 33, 352, 2112, 352)


@pytest.mark.parametrize("index", range(19))
def test_geometry_on_b2_blocks(index):
    k, h, w, cin, ce, cout = B2_BLOCKS[index]
    geo = v1.pass2_geometry(16, h, w, cin, ce, cout, k, SM_COUNT)
    nwy, nwx = -(-h // geo.th), -(-w // geo.tw)
    assert geo.windows == 16 * nwy * nwx
    # every output pixel of a clip lies in exactly one window
    owned = np.zeros((h, w), np.int64)
    for wy in range(nwy):
        for wx in range(nwx):
            owned[wy * geo.th:(wy + 1) * geo.th, wx * geo.tw:(wx + 1) * geo.tw] += 1
    assert (owned == 1).all()
    assert geo.ctas >= 2 * SM_COUNT  # two blocks of threads an SM
    computed = geo.windows * geo.th * geo.tw
    assert (computed - 16 * h * w) / computed <= 0.125
    last = ce - (geo.slices - 1) * geo.slice_len
    assert 0 < last <= geo.slice_len and geo.slice_len % v1.P2_CHUNK == 0
    assert geo.slices == 1 or min(geo.slice_len, last) >= 64
    assert geo.smem <= 232448
    assert geo.p == geo.th * geo.tw <= v1.P2_MAX_P and geo.tp == -(-geo.p // 4)
    assert geo.tn in v1.P2_TN and geo.tc * geo.tn >= cout
    assert geo.tp * geo.tc <= geo.threads == 256


def emulate_pass2(x, folded, gate, kernel, fast, geo):
    """csrc/mbconv_pass2.cu's split of the work, in PyTorch: per slice and
    window, expand + swish on the halo window (zero outside the map after
    the swish), the taps grouped by dw, the gate and the projection; the
    slices' partial products added in slice order, then bp and the
    residual."""
    b, h, w, cin = x.shape
    m = kernel // 2
    ce, cout = folded["wd"].shape[1], folded["wp"].shape[1]
    act = torch.bfloat16 if fast else torch.float32
    nwy, nwx = -(-h // geo.th), -(-w // geo.tw)
    hp, wp_ = nwy * geo.th, nwx * geo.tw
    xp = F.pad(x, (0, 0, m, m + wp_ - w, m, m + hp - h))
    inmap = F.pad(torch.ones(h, w), (m, m + wp_ - w, m, m + hp - h))
    total = None
    for s in range(geo.slices):
        lo, hi = s * geo.slice_len, min(ce, (s + 1) * geo.slice_len)
        part = torch.zeros(b, hp, wp_, cout)
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
                d = F.silu(acc + folded["bd"][lo:hi]) * gate[:, None, None, lo:hi]
                part[:, y0:y0 + geo.th, x0:x0 + geo.tw] = v1.dot(d, folded["wp"][lo:hi], fast)
        total = part if total is None else total + part
    out = total[:, :h, :w] + folded["bp"]
    return out + x if cin == cout else out


# (kernel, cin, cout, expand, h, w): residual, k5 + residual over 192
# expanded channels (three slices), no expand, odd extents with slices
EMULATED = [(3, 16, 16, 6, 8, 24), (5, 32, 32, 6, 4, 33), (3, 32, 16, 1, 8, 24),
            (3, 32, 40, 6, 7, 13)]


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", EMULATED)
def test_kernel_decomposition_matches_plain_version(shape, fast):
    kernel, cin, cout, expand, h, w = shape
    blk = random_block(kernel, 1, cin, cout, expand, seed=cin + h)
    folded = ops.fold_block(blk)
    x = nhwc_input(2, h, w, cin, seed=w)
    ce = folded["wd"].shape[1]
    gate = v1.se_gate(v1.pass1_plain(x, folded, kernel, fast) / float(h * w), folded)
    geo = v1.pass2_geometry(2, h, w, cin, ce, cout, kernel, SM_COUNT)
    assert (geo.slices > 1) == (ce >= 128)
    got = emulate_pass2(x, folded, gate, kernel, fast, geo)
    ref = v1.pass2_plain(x, folded, gate, kernel, fast, tile=64)
    bars = dict(atol=5e-2, rtol=5e-2) if fast else dict(atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **bars)


@pytest.mark.parametrize("fast", [False, True])
def test_cpu_wrapper_is_the_plain_version_for_any_tile(monkeypatch, fast):
    """On a CPU tensor mbconv_pass2 returns pass2_plain's result for each
    tile, builds nothing and launches nothing."""
    def no_build():
        raise AssertionError("the CUDA build must not be attempted on the CPU")

    monkeypatch.setattr(v1, "build_pass2", no_build)
    blk = random_block(5, 1, 24, 24, 6, seed=3)
    folded = ops.fold_block(blk)
    x = nhwc_input(2, 6, 11, 24, seed=3)
    gate = v1.se_gate(v1.pass1_plain(x, folded, 5, fast) / 66.0, folded)
    outs = []
    for tile in (24, 2048):
        got = v1.mbconv_pass2(x, folded, gate, 5, fast, tile)
        torch.testing.assert_close(got, v1.pass2_plain(x, folded, gate, 5, fast, tile),
                                   rtol=0, atol=0)
        outs.append(got)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-6, rtol=1e-6)
    assert v1.LAUNCHES_PASS2 == 0
    with pytest.raises(ValueError, match="tile"):
        v1.mbconv_pass2(x, folded, gate, 5, fast, 0)
