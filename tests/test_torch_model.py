"""The port's models (psla_tpu_torch.models) against the JAX package's.

The same EffNetAttention(b=0) variables, drawn from numpy with randomized
BatchNorm statistics and widened pooling heads (tests/torch_port_fixtures.py),
go through both packages: the JAX tree directly, the port through
``from_jax_variables``. Bars: 2e-5 on probabilities and
pooling partial sums (f32 summation order through 16 MBConv blocks), and an
exact round trip back through psla_tpu's converter.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

from psla_tpu.models import create_model as jax_create_model
from psla_tpu.models.convert import convert_effnet_attention
from psla_tpu.models.layers import ReferenceBatchNorm
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import (
    from_jax_variables,
    load_variables,
    normalize_state_dict,
)
from psla_tpu_torch.models.layers import BN_EPS, BatchNorm, SameConv2d, same_padding
from tests.torch_port_fixtures import jax_model, jax_variables

torch.set_num_threads(2)

N_CLASS = 6
T_LEN = 64
ATOL = 2e-5


@functools.lru_cache(maxsize=None)
def jax_reference(head_num: int, seed: int):
    """(variables, probs, stats) of the JAX model on the shared batch."""
    v = jax_variables(head_num, seed, N_CLASS)
    model = jax_model(head_num, N_CLASS)
    run = jax.jit(lambda v, x: (model.apply(v, x, train=False),
                                model.apply(v, x, train=False, return_stats=True)))
    probs, stats = run(v, jnp.asarray(fbank_batch()))
    return v, np.asarray(probs), jax.tree.map(np.asarray, stats)


def port_model(variables: dict, head_num: int, n_class: int = N_CLASS,
               dtype=torch.float32):
    model = create_model("efficientnet", label_dim=n_class, eff_b=0,
                         head_num=head_num, dtype=dtype)
    model.load_state_dict(from_jax_variables(variables, n_class))
    return model


@functools.lru_cache(maxsize=None)
def fbank_batch() -> np.ndarray:
    rng = np.random.default_rng(5)
    return rng.standard_normal((2, T_LEN, 128)).astype(np.float32)


@pytest.mark.parametrize("head_num", [4, 1, 0])
def test_eval_forward_matches_jax(head_num):
    v, ref, _ = jax_reference(head_num, seed=head_num)
    with torch.inference_mode():
        got = port_model(v, head_num)(torch.from_numpy(fbank_batch())).numpy()
    assert got.shape == (2, N_CLASS)
    assert np.ptp(ref) > 0.05, "probabilities too flat to prove parity"
    assert np.ptp(ref, axis=0).max() > 1e-3, "output does not depend on the input"
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("head_num", [4, 1, 0])
def test_return_stats_match_jax(head_num):
    v, _, ref = jax_reference(head_num, seed=head_num)
    with torch.inference_mode():
        got = port_model(v, head_num)(torch.from_numpy(fbank_batch()),
                                      return_stats=True)
    for key in ("s1", "s0", "head_weight"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   atol=ATOL, rtol=2e-6)


@pytest.mark.parametrize("head_num", [4, 1, 0])
def test_weights_round_trip_exactly(head_num):
    v = jax_variables(head_num, 20 + head_num, N_CLASS)
    sd = port_model(v, head_num).state_dict()
    back = convert_effnet_attention(sd, N_CLASS)
    flat_v = traverse_util.flatten_dict(v)
    flat_back = traverse_util.flatten_dict(back)
    assert flat_back.keys() == flat_v.keys()
    for path, x in flat_v.items():
        np.testing.assert_array_equal(flat_back[path], x, err_msg=str(path))


def test_state_dict_has_reference_keys():
    sd = create_model("efficientnet", label_dim=N_CLASS, eff_b=0).state_dict()
    for key in ("effnet._conv_stem.weight", "effnet._bn0.running_var",
                "effnet._blocks.0._depthwise_conv.weight",
                "effnet._blocks.1._expand_conv.weight",
                "effnet._blocks.1._se_reduce.bias", "effnet._conv_head.weight",
                "effnet._bn1.weight", "attention.att.3.weight",
                "attention.cla.0.bias", "attention.head_weight"):
        assert key in sd, key
    assert sd["effnet._blocks.0._depthwise_conv.weight"].shape == (32, 1, 3, 3)


def test_reference_pth_loads_after_normalize(tmp_path):
    """A reference-style checkpoint (DataParallel prefix, fc and
    num_batches_tracked entries) loads strictly into the port."""
    v = jax_variables(4, 30, N_CLASS)
    sd = port_model(v, 4).state_dict()
    ref_style = {f"module.{k}": t for k, t in sd.items()}
    ref_style["module.effnet._fc.weight"] = torch.zeros(3, 3)
    ref_style["module.effnet._bn0.num_batches_tracked"] = torch.tensor(7)
    path = tmp_path / "ref.pth"
    torch.save(ref_style, path)
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0)
    model.load_state_dict(load_variables(str(path)))
    for k, t in model.state_dict().items():
        torch.testing.assert_close(t, sd[k], rtol=0, atol=0)
    assert normalize_state_dict(ref_style).keys() == sd.keys()


def test_npz_of_jax_variables_loads(tmp_path):
    v = jax_variables(4, 31, N_CLASS)
    flat = traverse_util.flatten_dict(v, sep="/")
    path = tmp_path / "vars.npz"
    np.savez(path, **flat)
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0)
    model.load_state_dict(load_variables(str(path)))
    x = torch.from_numpy(fbank_batch())
    with torch.inference_mode():
        torch.testing.assert_close(model(x), port_model(v, 4)(x), rtol=0, atol=0)
    with pytest.raises(ValueError, match="npz"):
        load_variables(str(tmp_path))


def test_unported_backbones_raise():
    """Every family builds now (ResNet and MBNet are held to the JAX
    package in tests/test_torch_backbones.py); remat, an EfficientNet-only
    option, raises for the other two as the JAX package's create_model
    does."""
    for name in ("efficientnet", "resnet", "mbnet"):
        model = create_model(name, label_dim=N_CLASS, eff_b=0)
        assert not model.training and model.train() is model and model.training
        with torch.inference_mode():
            assert model.eval()(torch.from_numpy(fbank_batch())).shape == (2, N_CLASS)
    for name in ("resnet", "mbnet"):
        with pytest.raises(ValueError, match="EfficientNet-only"):
            create_model(name, label_dim=N_CLASS, remat=True)


@pytest.mark.parametrize("size,kernel,stride", [
    (9, 3, 2), (10, 3, 2), (11, 5, 2), (12, 5, 2), (7, 5, 1), (8, 1, 1),
])
def test_same_conv_matches_jax_same(size, kernel, stride):
    """TF-SAME is asymmetric at stride 2; depthwise weights are [C,1,k,k]."""
    rng = np.random.default_rng(size * 10 + kernel)
    c = 3
    x = rng.standard_normal((1, size, size + 1, c)).astype(np.float32)
    w = rng.standard_normal((kernel, kernel, 1, c)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=c,
        precision=jax.lax.Precision.HIGHEST,
    )
    conv = SameConv2d(c, c, kernel, stride, groups=c)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.transpose(w, (3, 2, 0, 1))))
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    lo, hi = same_padding(size, kernel, stride)
    assert hi - lo in (0, 1)


def test_bfloat16_forward_keeps_f32_statistics():
    """In bf16 the activations are bf16 while BN statistics and all
    parameters stay f32; the probabilities stay near the f32 ones."""
    v = jax_variables(4, 40, N_CLASS)
    f32 = port_model(v, 4)
    bf16 = port_model(v, 4, dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in bf16.state_dict().values())
    x = torch.from_numpy(fbank_batch())
    with torch.inference_mode():
        a, b = f32(x), bf16(x)
    assert b.dtype == torch.float32
    assert float((a - b).abs().max()) < 0.1


def test_bfloat16_batchnorm_rounds_as_flax():
    """In bf16 the port's BatchNorm gives flax's bits: (x - mean) * mul +
    bias in float32, rounded once. Running means N(0, 2) with inputs
    centred on them (a trained network's regime): rounding the folded scale
    and shift to bf16 first loses the result where x * mul and the shift
    cancel."""
    rng = np.random.default_rng(6)
    c = 64
    mean = rng.normal(0.0, 2.0, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, c).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c).astype(np.float32)
    x = (mean + np.sqrt(var) * rng.standard_normal((2, 8, 16, c))).astype(np.float32)
    x16 = jnp.asarray(x, jnp.bfloat16)  # NHWC
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    bn_jax = ReferenceBatchNorm(use_running_average=True, epsilon=BN_EPS,
                                dtype=jnp.bfloat16)
    ref = np.asarray(bn_jax.apply(variables, x16).astype(jnp.float32))
    bn = BatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    xt = torch.from_numpy(np.array(x16.astype(jnp.float32))).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = bn(xt.bfloat16())
        f32 = bn(xt)
    assert got.dtype == torch.bfloat16 and f32.dtype == torch.float32
    np.testing.assert_array_equal(got.float().permute(0, 2, 3, 1).numpy(), ref)
    y = (x16.astype(jnp.float32) - mean) * (scale / np.sqrt(var + BN_EPS)) + bias
    np.testing.assert_allclose(f32.permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               atol=2e-6, rtol=0)


def test_bfloat16_forward_matches_jax():
    """The port's bf16 eval forward against the JAX bf16 forward, on the
    weights and batch of the f32 parity test. The bar is twice JAX's own
    bf16-vs-f32 spread on the same inputs: BatchNorm rounds where flax
    does, but the SiLU does not (XLA's logistic and PyTorch's differ in
    the last bf16 bit on many of the stem's outputs), so the two bf16
    forwards are separate bf16 evaluations, each about as far from f32."""
    v, ref32, _ = jax_reference(4, seed=4)
    ref16 = jax.jit(functools.partial(
        jax_create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=4,
                         dtype=jnp.bfloat16).apply, train=False,
    ))(v, jnp.asarray(fbank_batch()))
    ref16 = np.asarray(ref16, np.float32)
    spread = float(np.abs(ref16 - ref32).max())
    assert spread > 0
    with torch.inference_mode():
        got = port_model(v, 4, dtype=torch.bfloat16)(torch.from_numpy(fbank_batch()))
    err = float(np.abs(got.numpy() - ref16).max())
    assert err <= 2 * spread, (err, spread)
