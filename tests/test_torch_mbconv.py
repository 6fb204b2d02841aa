"""The port's fused MBConv ops (psla_tpu_torch.ops) against the JAX package's.

The same numpy-made block weights and inputs go through the JAX functions
(``psla_tpu.ops``, Pallas in interpret mode on the CPU, as
tests/test_fused_mbconv.py and tests/test_mbconv_vmem.py run them) and the
port's plain versions, which CPU tensors take. Bars are the JAX package's
own: v1 2e-6 and tile invariance 1e-6 (test_fused_mbconv.py:47,56), v2 3e-6
(test_mbconv_vmem.py:55), rtol 1e-5, and 5e-2 for ``fast=True``. The
kernels themselves run only on the card (tests/test_torch_kernels.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psla_tpu.models.efficientnet import MBConvBlock as JaxBlock
from psla_tpu.models.efficientnet import efficientnet_arch as jax_arch
from psla_tpu.ops.fused_mbconv import fold_block_params as jax_fold
from psla_tpu.ops.fused_mbconv import fused_mbconv_eval as jax_v1
from psla_tpu.ops.mbconv_vmem import fused_mbconv_eval_v2 as jax_v2
from psla_tpu_torch import ops
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.models.layers import conv_bn, same_padding
from psla_tpu_torch.ops import fused_mbconv as v1
from psla_tpu_torch.ops import mbconv_vmem as v2
from tests.torch_mbconv_fixtures import random_block as port_block
from tests.torch_port_fixtures import jax_variables

torch.set_num_threads(2)

CPU = torch.device("cpu")
V1_SHAPES = [(3, 16, 16, 6), (5, 24, 16, 6), (3, 32, 16, 1), (3, 16, 24, 6)]
V2_SHAPES = [
    (3, 1, 16, 16, 6, 8, 24),   # skip connection
    (5, 1, 24, 16, 6, 8, 24),   # k5
    (3, 1, 32, 16, 1, 8, 24),   # no expand
    (3, 2, 16, 24, 6, 8, 24),   # stride 2
    (5, 2, 24, 48, 6, 10, 40),  # stride 2, k5
    (3, 2, 16, 24, 6, 9, 25),   # stride 2, odd extents
    (5, 2, 24, 40, 6, 7, 23),   # stride 2, k5, odd extents
]


@functools.lru_cache(maxsize=None)
def jax_block(kernel, stride, cin, cout, expand, h, w, seed=0):
    """(flax block, variables, x) as the JAX package's tests make them:
    flax init, BatchNorm statistics |N(1, 0.2)|, x ~ N(0, 1) of [2, h, w, cin]."""
    rng = np.random.default_rng(seed)
    blk = JaxBlock(kernel=kernel, stride=stride, expand_ratio=expand,
                   in_filters=cin, out_filters=cout, se_ratio=0.25, drop_rate=0.0)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    variables = blk.init(jax.random.PRNGKey(seed), jnp.asarray(x), False)
    stats = jax.tree.map(
        lambda a: np.abs(rng.standard_normal(a.shape).astype(np.float32) * 0.2 + 1.0),
        variables["batch_stats"])
    variables = jax.tree.map(np.asarray, dict(variables, batch_stats=stats))
    return blk, variables, x


def port_folded(variables):
    return v1.fold_block_params(variables["params"], variables["batch_stats"], CPU)


def module_nhwc(block, x: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        y = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).numpy()


# ------------------------------------------------------------------ folding


@pytest.mark.parametrize("expand,kernel", [(6, 3), (1, 3), (6, 5)])
def test_fold_block_params_equals_jax(expand, kernel):
    _, variables, _ = jax_block(kernel, 1, 16 * (2 if expand == 1 else 1), 16,
                                expand, 8, 24, seed=7)
    ref = jax_fold(variables["params"], variables["batch_stats"])
    got = port_folded(variables)
    assert got.keys() == ref.keys()
    for key, t in got.items():
        assert t.dtype == torch.float32 and t.device == CPU
        np.testing.assert_array_equal(t.numpy(), ref[key], err_msg=key)


@functools.lru_cache(maxsize=None)
def b0_pair():
    """(JAX variables, the port's B0 backbone) of one numpy-made tree."""
    variables = jax_variables(4, 11, 6)
    model = create_model("efficientnet", label_dim=6, eff_b=0, head_num=4)
    model.load_state_dict(from_jax_variables(variables, 6))
    return variables, model.effnet.eval()


def b0_block_args():
    """[(kernel, stride)] of B0's 16 blocks, from the JAX architecture."""
    _, blocks, _ = jax_arch(0)
    return [(a.kernel, a.stride if r == 0 else 1) for a, n in blocks for r in range(n)]


@pytest.mark.parametrize("index", range(16))
def test_fold_block_matches_jax_fold_of_the_same_block(index):
    variables, effnet = b0_pair()
    ref = jax_fold(variables["params"]["effnet"][f"block_{index}"],
                   variables["batch_stats"]["effnet"][f"block_{index}"])
    got = ops.fold_block(effnet._blocks[index])
    assert got.keys() == ref.keys()
    for key, t in got.items():
        assert tuple(t.shape) == ref[key].shape, key
        np.testing.assert_allclose(t.numpy(), ref[key], atol=1e-6, rtol=0, err_msg=key)


# ------------------------------------------------------------------ v1


@pytest.mark.parametrize("kernel,cin,cout,expand", V1_SHAPES)
def test_v1_plain_matches_jax(kernel, cin, cout, expand):
    _, variables, x = jax_block(kernel, 1, cin, cout, expand, 8, 24)
    folded = jax_fold(variables["params"], variables["batch_stats"])
    ref = np.asarray(jax_v1(jnp.asarray(x), folded, kernel, fast=False, tile=64))
    got = ops.fused_mbconv_eval(torch.from_numpy(x), port_folded(variables), kernel,
                                fast=False, tile=64).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)


def test_v1_plain_tile_invariance_and_jax():
    _, variables, x = jax_block(3, 1, 16, 16, 6, 10, 40, seed=3)
    folded = port_folded(variables)
    a = ops.fused_mbconv_eval(torch.from_numpy(x), folded, 3, fast=False, tile=64).numpy()
    b = ops.fused_mbconv_eval(torch.from_numpy(x), folded, 3, fast=False, tile=400).numpy()
    np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-6)
    jf = jax_fold(variables["params"], variables["batch_stats"])
    ref = np.asarray(jax_v1(jnp.asarray(x), jf, 3, fast=False, tile=400))
    np.testing.assert_allclose(b, ref, atol=2e-6, rtol=1e-5)


def test_v1_plain_fast_matches_jax_fast():
    _, variables, x = jax_block(3, 1, 16, 16, 6, 8, 24, seed=5)
    jf = jax_fold(variables["params"], variables["batch_stats"])
    ref = np.asarray(jax_v1(jnp.asarray(x), jf, 3, fast=True, tile=64))
    got = ops.fused_mbconv_eval(torch.from_numpy(x), port_folded(variables), 3,
                                fast=True, tile=64).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("kernel,cin,cout,expand", V1_SHAPES)
def test_v1_plain_matches_port_module(kernel, cin, cout, expand):
    blk = port_block(kernel, 1, cin, cout, expand, seed=kernel + cin + cout)
    x = np.random.default_rng(cin).standard_normal((2, 9, 23, cin)).astype(np.float32)
    ref = module_nhwc(blk, x)
    folded = ops.fold_block(blk)
    got = ops.fused_mbconv_eval(torch.from_numpy(x), folded, kernel, False, 64).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)
    fast = ops.fused_mbconv_eval(torch.from_numpy(x), folded, kernel, True, 64).numpy()
    np.testing.assert_allclose(fast, ref, atol=5e-2, rtol=5e-2)


def test_v1_passes_compose():
    """pass 1's sums, the SE MLP and pass 2 give the block."""
    blk = port_block(3, 1, 16, 16, 6, seed=2)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 6, 11, 16))
                         .astype(np.float32))
    folded = ops.fold_block(blk)
    sums = v1.mbconv_pass1(x, folded, 3, False, 24)
    np.testing.assert_allclose(sums.numpy() / 66.0,
                               _depthwise_mean(blk, x).numpy(), atol=1e-6, rtol=1e-5)
    gate = v1.se_gate(sums / 66.0, folded)
    got = v1.mbconv_pass2(x, folded, gate, 3, False, 24)
    torch.testing.assert_close(got, ops.fused_mbconv_eval(x, folded, 3, False, 24),
                               rtol=0, atol=0)


def _depthwise_mean(blk, x):
    with torch.inference_mode():
        h = x.permute(0, 3, 1, 2)
        h = conv_bn(h, blk._expand_conv, blk._bn0, "silu")
        h = conv_bn(h, blk._depthwise_conv, blk._bn1, "silu")
    return h.mean(dim=(2, 3))


# ------------------------------------------------------------------ v2


@pytest.mark.parametrize("kernel,stride,cin,cout,expand,h,w", V2_SHAPES)
def test_v2_plain_matches_jax(kernel, stride, cin, cout, expand, h, w):
    _, variables, x = jax_block(kernel, stride, cin, cout, expand, h, w)
    jf = jax_fold(variables["params"], variables["batch_stats"])
    ref = np.asarray(jax_v2(jnp.asarray(x), jf, kernel, stride, fast=False))
    got = ops.fused_mbconv_eval_v2(torch.from_numpy(x), port_folded(variables),
                                   kernel, stride, fast=False).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=3e-6, rtol=1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_v2_plain_fast_matches_jax_fast(stride):
    _, variables, x = jax_block(3, stride, 16, 16 if stride == 1 else 24, 6, 8, 24, seed=5)
    jf = jax_fold(variables["params"], variables["batch_stats"])
    ref = np.asarray(jax_v2(jnp.asarray(x), jf, 3, stride, fast=True))
    got = ops.fused_mbconv_eval_v2(torch.from_numpy(x), port_folded(variables), 3,
                                   stride, fast=True).numpy()
    np.testing.assert_allclose(got, ref, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("kernel,stride,cin,cout,expand,h,w", V2_SHAPES)
def test_v2_plain_matches_port_module(kernel, stride, cin, cout, expand, h, w):
    blk = port_block(kernel, stride, cin, cout, expand, seed=h * w + cin)
    x = np.random.default_rng(h + w).standard_normal((2, h, w, cin)).astype(np.float32)
    ref = module_nhwc(blk, x)
    folded = ops.fold_block(blk)
    got = ops.fused_mbconv_eval_v2(torch.from_numpy(x), folded, kernel, stride, False)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-6, rtol=1e-5)
    fast = ops.fused_mbconv_eval_v2(torch.from_numpy(x), folded, kernel, stride, True)
    np.testing.assert_allclose(fast.numpy(), ref, atol=5e-2, rtol=5e-2)


def test_v2_plain_keeps_bfloat16_input_dtype():
    blk = port_block(3, 1, 16, 16, 6, seed=4)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 8, 12, 16))
                         .astype(np.float32))
    folded = ops.fold_block(blk)
    ref = ops.fused_mbconv_eval_v2(x, folded, 3, 1, True)
    got = ops.fused_mbconv_eval_v2(x.bfloat16(), folded, 3, 1, True)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_allclose(got.float().numpy(), ref.numpy(), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("n", [7, 8, 24, 25, 132, 528])
def test_same_pad_matches_layers_same_padding(n):
    for k in (3, 5):
        for s in (1, 2):
            out, lo, hi = v2.same_pad(n, k, s)
            assert (lo, hi) == same_padding(n, k, s)
            assert out == -(-n // s) and lo + n + hi >= (out - 1) * s + k


# ------------------------------------------------------------------ slice


@functools.lru_cache(maxsize=None)
def b0_chain():
    """B0's 16 blocks chained from one [1, 16, 32, 32] NHWC map: through
    the JAX v2 function, the port's v2 plain version and the port's modules."""
    variables, effnet = b0_pair()
    x = np.random.default_rng(12).standard_normal((1, 16, 32, 32)).astype(np.float32)
    jx, px = jnp.asarray(x), torch.from_numpy(x)
    for i, (kernel, stride) in enumerate(b0_block_args()):
        jf = jax_fold(variables["params"]["effnet"][f"block_{i}"],
                      variables["batch_stats"]["effnet"][f"block_{i}"])
        jx = jax_v2(jx, jf, kernel, stride, fast=False)
        px = ops.fused_mbconv_eval_v2(px, ops.fold_block(effnet._blocks[i]), kernel,
                                      stride, fast=False)
    with torch.inference_mode():
        mx = torch.from_numpy(x).permute(0, 3, 1, 2)
        for block in effnet._blocks:
            mx = block(mx)
    return np.asarray(jx), px.numpy(), mx.permute(0, 2, 3, 1).numpy()


def test_b0_chain_matches_jax_chain():
    ref, got, _ = b0_chain()
    assert got.shape == ref.shape == (1, 1, 2, 320)
    scale = float(np.abs(ref).max())
    assert np.ptp(ref) > 0.1, "chain output too flat to prove parity"
    # 16 blocks of f32 sums: the error grows with the output's size
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)


def test_b0_chain_matches_port_modules():
    _, got, ref = b0_chain()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=2e-5 * scale, rtol=0)


# ------------------------------------------------------------------ wrappers


def test_wrappers_on_cpu_never_build(monkeypatch):
    def no_build():
        raise AssertionError("the CUDA build must not be attempted on the CPU")

    monkeypatch.setattr(v1, "build", no_build)
    monkeypatch.setattr(v2, "build", no_build)
    blk = port_block(3, 1, 16, 16, 6, seed=9)
    folded = ops.fold_block(blk)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 5, 7, 16))
                         .astype(np.float32))
    ops.fused_mbconv_eval(x, folded, 3)
    ops.fused_mbconv_eval_v2(x, folded, 3, 2)
    gate = v1.mbconv_pass1(x, folded, 3) / 35.0
    v1.mbconv_pass2(x, folded, v1.se_gate(gate, folded), 3)
    assert v1.LAUNCHES_PASS1 == v1.LAUNCHES_PASS2 == v2.LAUNCHES == 0


def test_argument_checks_raise():
    blk = port_block(3, 1, 16, 16, 6, seed=10)
    folded = ops.fold_block(blk)
    x = torch.zeros(2, 5, 7, 16)
    with pytest.raises(ValueError, match="stride 1"):
        ops.fused_mbconv_eval(x, folded, 3, stride=2)
    with pytest.raises(ValueError, match="stride"):
        ops.fused_mbconv_eval_v2(x, folded, 3, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_mbconv_eval_v2(x.transpose(1, 2), folded, 3)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_mbconv_eval(x.double(), folded, 3)
    with pytest.raises(ValueError, match="one of"):
        ops.fused_mbconv_eval_v2(x.half(), folded, 3)
    with pytest.raises(ValueError, match="kernel"):
        ops.fused_mbconv_eval_v2(x, folded, 5)
    with pytest.raises(ValueError, match="Cin"):
        ops.fused_mbconv_eval_v2(torch.zeros(2, 5, 7, 8), folded, 3)
    bad = dict(folded, wp=folded["wp"].double())
    with pytest.raises(ValueError, match="wp"):
        ops.fused_mbconv_eval_v2(x, bad, 3)
    with pytest.raises(ValueError, match="gate"):
        v1.mbconv_pass2(x, folded, torch.zeros(2, 3), 3)
    with pytest.raises(ValueError, match="on meta"):
        ops.fused_mbconv_eval_v2(x, dict(folded, bd=folded["bd"].to("meta")), 3)
