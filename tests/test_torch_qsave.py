"""The port's int8 activation compression (``psla_tpu_torch/ops/qsave.py``
and ``act_compress`` in the models) against ``psla_tpu.ops.qsave`` and the
JAX package's compressed models, on the CPU.

The same numpy arrays go through both packages, NHWC on the JAX side and
NCHW (transposed) on the port's. Bars:
- ``quantize_int8``'s ``q`` and ``scale``, ``dequantize_int8`` and the
  ``qdq`` forward equal to JAX's bit for bit, in float32 and bfloat16 (ties
  of the rounding and an all-zero channel included); the straight-through
  gradient within 1e-7 of JAX's (tests/test_qsave.py:49);
- ``DwConvQ8Save`` at stride 1 and 2, with symmetric and asymmetric
  TF-SAME padding: the forward equal bit for bit to ``SameConv2d``'s, the
  data gradient equal to the uncompressed one (it reads no input), the
  weight gradient within relative 5e-3 and
  cosine > 0.99999 of it (tests/test_qsave.py:78-89; measured 8.5e-4 to
  2.9e-3) and within 1e-5 of JAX's ``dw_conv_q8save`` weight gradient
  (measured 6.0e-8 at most);
- EffNet-B0 (one head, 4 classes, drop-connect off) in train mode on a
  [2, 64, 64] input from the shared numpy-made variables, against the JAX
  model in the same mode, both modes in float64 on both sides (the
  quantization itself stays float32 on both, as the JAX module keeps
  it): the loss within 1e-8 (measured 8.6e-15 for q8save, 5.4e-9 for
  qdq) and each parameter's gradient within 1e-6 of the JAX leaf's norm
  plus 1e-7 of the whole gradient's (at most 2.3% and 9.5% of that bar
  used). The port's uncompressed model misses JAX's compressed depthwise
  weight gradients by at least 367 (q8save) and 6.6e4 (qdq) bars: the
  model-level check sees whether the compression runs. In float32 the
  packages' ~1e-6 noise flips a few int8 roundings: under qdq train-mode
  BatchNorm carries them through 16 blocks to 1.8e-2 on the loss, as
  large as qdq's own effect, and under q8save they move the depthwise
  weight gradients by up to 6e-4 of their norm, near int8's own effect.
  [4, 64, 128] takes twice as long (XLA's CPU convolutions are slow in
  float64).
- The uncompressed B0 on a [4, 32, 64] input, in float64 at the same bars
  (measured: the loss 2.1e-14 off, at most 1.2e-7 of a gradient's bar used).
  It leaves one time step after the last stride, where
  ``EffNetAttention.forward``'s pooling hands the head's train-mode
  BatchNorm a gradient whose strides ``F.batch_norm``'s CPU backward gets
  wrong (tests/test_torch_batchnorm_strides.py); without
  ``ops.bn_train._GradInOwnStrides`` the gradients miss JAX's by 100-180%
  of their norm (the stem's weight gradient by 37.6 against a bar of
  4.5e-5).
- The JAX package's bars against the uncompressed model
  (tests/test_qsave.py:119-132), on the port from its own initialisation
  (the JAX package's scheme) and that test's input: q8save's loss within
  1e-6 and gradient cosine > 0.999 (measured 0 and 0.999947), qdq's loss
  within 5e-2 and cosine > 0.9 (8.6e-3 and 0.9457). The state_dict's keys
  and shapes are those of ``act_compress='none'``.
"""

import concurrent.futures
import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psla_tpu.models.pooling as jax_pooling
from psla_tpu.models import EffNetAttention as JaxEffNetAttention
from psla_tpu.ops import qsave as jax_qsave
from psla_tpu.train.optim import bce_loss as jax_bce_loss
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.models.layers import SameConv2d
from psla_tpu_torch.ops.qsave import (
    DwConvQ8Save,
    dequantize_int8,
    qdq,
    quantize_int8,
)
from psla_tpu_torch.train.optim import bce_loss
from tests.torch_port_fixtures import jax_variables

torch.set_num_threads(2)

B, T, F, N_CLASS = 2, 64, 64, 4
SEED = 7
MODES = ("q8save", "qdq")
# one time step after the last stride (T' = 1), uncompressed
ONE_STEP = ("none", (4, 32, 64))
# the loss, and each gradient within GRAD_RTOL of the JAX leaf's norm plus
# GRAD_FLOOR of the whole gradient's
LOSS_ATOL, GRAD_RTOL, GRAD_FLOOR = 1e-8, 1e-6, 1e-7


def _nhwc(t: torch.Tensor) -> jax.Array:
    a = t.detach().float().numpy().transpose(0, 2, 3, 1)
    return jnp.asarray(a, jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


def _nchw(a) -> np.ndarray:
    return np.asarray(a, np.float32).transpose(0, 3, 1, 2)


def _activation(seed: int, shape=(2, 8, 16, 16)) -> torch.Tensor:
    """Channels of different ranges, one all-zero, and exact ties of the
    rounding (q = k + 0.5) in channel 1."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.01, 3.0, (1, shape[1], 1, 1))
    x[:, 2] = 0.0
    x[0, 1, 0, :4] = np.array([-254.0, 1.0, 3.0, -5.0]) / 2.0
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_and_qdq_match_jax_bit_for_bit(dtype):
    x = _activation(1).to(dtype)
    q, scale = quantize_int8(x, axis=1)
    jq, jscale = jax_qsave.quantize_int8(_nhwc(x), axis=-1)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert int(q[0, 1, 0, 0]) == -127 and bool((q[:, 2] == 0).all())
    deq = dequantize_int8(q, scale, 1, dtype)
    assert deq.dtype == dtype
    np.testing.assert_array_equal(
        deq.float().numpy(), _nchw(jax_qsave.dequantize_int8(jq, jscale, -1, _nhwc(x).dtype)))
    np.testing.assert_array_equal(qdq(x).float().numpy(), _nchw(jax_qsave.qdq(_nhwc(x))))


def test_qdq_straight_through_gradient_matches_jax():
    x = _activation(2)
    xt = x.clone().requires_grad_(True)
    torch.sin(qdq(xt)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jnp.sin(jax_qsave.qdq(v))))(_nhwc(x))
    np.testing.assert_allclose(xt.grad.numpy(), _nchw(jg), atol=1e-7, rtol=0)
    # the straight-through gradient: the identity's, taken at the quantized point
    np.testing.assert_allclose(xt.grad.numpy(), torch.cos(qdq(x)).numpy(), atol=1e-7, rtol=0)


def _cosine(a: np.ndarray, b: np.ndarray) -> float:
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# (size, kernel, stride): TF-SAME (1, 1), (0, 1), (1, 1), (1, 2) and (2, 2)
@pytest.mark.parametrize("size,kernel,stride", [
    (16, 3, 1), (16, 3, 2), (15, 3, 2), (16, 5, 2), (16, 5, 1),
])
def test_dw_conv_q8save_against_the_conv_and_jax(size, kernel, stride):
    rng = np.random.default_rng(size + 10 * kernel + 100 * stride)
    c = 8
    # tests/test_qsave.py's draw: standard normal input, kernel x 0.2
    x = torch.from_numpy(rng.standard_normal((2, c, size, size + 2)).astype(np.float32))
    w = rng.standard_normal((c, 1, kernel, kernel)).astype(np.float32) * 0.2
    conv = SameConv2d(c, c, kernel, stride, groups=c)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
    xp, padding = conv.pad_input(x)
    assert (padding == (0, 0)) == (xp is not x)  # the asymmetric cases pad here

    def grads(fn):
        xx = x.clone().requires_grad_(True)
        ww = torch.from_numpy(w).requires_grad_(True)
        y = fn(xx, ww)
        (y ** 2).mean().backward()
        return y.detach(), xx.grad, ww.grad

    def compressed(xx, ww):
        xx, pad = conv.pad_input(xx)
        return DwConvQ8Save.apply(xx, ww, stride, pad)

    def exact(xx, ww):
        xx, pad = conv.pad_input(xx)
        return torch.nn.functional.conv2d(xx, ww, None, stride, pad, 1, c)

    y, dx, dw = grads(compressed)
    y_ref, dx_ref, dw_ref = grads(exact)
    torch.testing.assert_close(y, conv(x).detach(), rtol=0, atol=0)
    torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx_ref, rtol=0, atol=0)  # the data gradient reads no input
    rel = float((dw - dw_ref).norm() / dw_ref.norm())
    assert rel < 5e-3, rel
    assert _cosine(dw.numpy(), dw_ref.numpy()) > 0.99999
    kernel_hwio = jnp.asarray(w.transpose(2, 3, 1, 0))
    jdw = jax.grad(lambda kk: jnp.mean(jax_qsave.dw_conv_q8save(
        _nhwc(x), kk, (stride, stride), "SAME") ** 2))(kernel_hwio)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw).transpose(3, 2, 0, 1), atol=1e-5,
                               rtol=0)


@functools.lru_cache(maxsize=None)
def _inputs(shape=(B, T, F)):
    rng = np.random.default_rng(SEED)
    x = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    y = np.eye(N_CLASS, dtype=np.float32)[np.arange(shape[0]) % N_CLASS]
    return x, y


def _state_dict64(tree: dict) -> dict:
    """``from_jax_variables`` of a float64 tree, in float64: the converter
    keeps float32, so the tree goes through it as the sum of two float32
    trees (the rounded tree and what the rounding left)."""
    hi = jax.tree.map(lambda a: np.asarray(a).astype(np.float32), tree)
    lo = jax.tree.map(lambda a, h: (np.asarray(a) - h).astype(np.float32), tree, hi)
    hi, lo = from_jax_variables(hi, N_CLASS), from_jax_variables(lo, N_CLASS)
    return {k: hi[k].double() + lo[k].double() for k in hi}


def _jax_grads(mode: str, shape=(B, T, F)):
    """The JAX model's train-mode loss and parameter gradients in ``mode``
    (tests/test_qsave.py's loss) in float64 on an input of ``shape``,
    compiled; calling the result runs it and returns them under the port's
    keys."""
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         jax_variables(1, SEED, N_CLASS))
        x, y = (jnp.asarray(a, jnp.float64) for a in _inputs(shape))
        model = JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=1, drop_connect_rate=0.0,
                                   dtype=jnp.float64, act_compress=mode)

        def loss(params):
            out, _ = model.apply({"params": params, "batch_stats": v["batch_stats"]}, x,
                                 train=True, mutable=["batch_stats"])
            return jax_bce_loss(out, y)

        # LLVM's expensive passes keep IEEE semantics: the same bits, compiled faster
        compiled = jax.jit(jax.value_and_grad(loss), compiler_options={
            "xla_llvm_disable_expensive_passes": True}).lower(v["params"]).compile()

    def run() -> tuple[float, dict]:
        with jax.enable_x64(True):
            value, grads = compiled(v["params"])
            grads = jax.tree.map(np.asarray, grads)
        return float(value), _state_dict64(dict(v, params=grads))

    return run


@pytest.fixture(scope="module")
def jax_grads():
    """Both modes' JAX gradients and the uncompressed one at ``ONE_STEP``,
    compiled in three threads and run one at a time (XLA's CPU runtime can
    give other bits to a program that runs while another does:
    tests/test_torch_bf16_train.py). The pooling head's float32 sigmoid is
    raised to float64 (the ``jnp.float32`` of ``psla_tpu.models.pooling``);
    ``psla_tpu.ops.qsave`` keeps its float32 quantization, as the port's
    does."""
    jax_variables(1, SEED, N_CLASS)  # filled once, before the threads share it
    pins = types.SimpleNamespace(**vars(jnp))
    pins.float32 = jnp.float64
    with mock.patch.object(jax_pooling, "jnp", pins), \
            concurrent.futures.ThreadPoolExecutor(len(MODES) + 1) as pool:
        compiled = {m: pool.submit(_jax_grads, m) for m in MODES}
        compiled[ONE_STEP] = pool.submit(_jax_grads, *ONE_STEP)
        return {m: f.result()() for m, f in compiled.items()}


def _port_grads(mode: str, dtype: torch.dtype = torch.float64, init: str = "shared",
                shape=(B, T, F)):
    """The port's train-mode loss and parameter gradients, from the shared
    variables on this module's input (of ``shape``), or (``init="own"``)
    from the port's own initialisation (the JAX package's scheme) on
    tests/test_qsave.py's input and labels, 3 classes."""
    if init == "shared":
        n_class, (x, y) = N_CLASS, _inputs(shape)
    else:
        n_class = 3
        x = (np.random.RandomState(3).randn(2, 64, 128) * 0.5).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[[0, 1]]
    model = create_model("efficientnet", label_dim=n_class, eff_b=0, head_num=1,
                         drop_connect_rate=0.0, dtype=dtype, act_compress=mode)
    if init == "shared":
        model.load_state_dict(from_jax_variables(jax_variables(1, SEED, N_CLASS), N_CLASS))
    x, y = (torch.from_numpy(a).to(dtype) for a in (x, y))
    loss = bce_loss(model.to(dtype).train()(x), y)
    loss.backward()
    return (float(loss.detach()), {k: p.grad for k, p in model.named_parameters()},
            {k: tuple(t.shape) for k, t in model.state_dict().items()})


@functools.lru_cache(maxsize=None)
def _port_uncompressed(dtype: torch.dtype, init: str):
    return _port_grads("none", dtype, init)


def _grad_bar_used(grads: dict, jax_grads: dict) -> float:
    """The largest share of a gradient's bar (GRAD_RTOL of the JAX leaf's
    norm plus GRAD_FLOOR of the whole gradient's) that the port's uses;
    asserts each is within its bar."""
    assert grads.keys() <= jax_grads.keys()
    whole = float(torch.sqrt(sum((jax_grads[k] ** 2).sum() for k in grads)))
    used = 0.0
    for k, g in grads.items():
        bound = GRAD_RTOL * float(jax_grads[k].norm()) + GRAD_FLOOR * whole
        off = float((g.double() - jax_grads[k]).norm())
        used = max(used, off / bound)
        assert off <= bound, (k, off, bound)
    return used


def test_gradients_at_one_time_step_match_jax(jax_grads):
    """The uncompressed B0 where one time step is left after the last
    stride (T' = 1): the loss and every parameter's gradient against the
    JAX model's, in float64 (see the module docstring)."""
    loss, grads, _ = _port_grads("none", shape=ONE_STEP[1])
    jax_loss, jax_grads = jax_grads[ONE_STEP]
    used = _grad_bar_used(grads, jax_grads)
    print(f"T'=1: loss {abs(loss - jax_loss):.3g}, largest share of a gradient's bar "
          f"used {used:.3g}")
    assert abs(loss - jax_loss) < LOSS_ATOL, (loss, jax_loss)


@pytest.mark.parametrize("mode", MODES)
def test_compressed_model_gradients_match_jax(mode, jax_grads):
    """The loss and every parameter's gradient against the JAX model's in
    the same mode, in float64 (see the module docstring); the compression
    is engaged: the port's uncompressed model misses JAX's depthwise weight
    gradients by far more than the bar. Then the JAX package's bars against
    the uncompressed model (tests/test_qsave.py's setup) and the
    state_dict's layout."""
    loss, grads, layout = _port_grads(mode)
    jax_loss, jax_grads = jax_grads[mode]
    print(f"{mode}: loss {abs(loss - jax_loss):.3g}")
    assert abs(loss - jax_loss) < LOSS_ATOL, (loss, jax_loss)
    used = _grad_bar_used(grads, jax_grads)
    whole = float(torch.sqrt(sum((jax_grads[k] ** 2).sum() for k in grads)))
    bounds = {k: GRAD_RTOL * float(jax_grads[k].norm()) + GRAD_FLOOR * whole for k in grads}
    exact = _port_uncompressed(torch.float64, "shared")[1]
    depthwise = [k for k in grads if "_depthwise_conv" in k]
    margin = min(float((exact[k] - jax_grads[k]).norm()) / bounds[k] for k in depthwise)
    print(f"{mode}: largest share of a gradient's bar used {used:.3f}; the uncompressed "
          f"model's depthwise gradients {margin:.3g} bars off at least")
    assert len(depthwise) == 16 and margin > 100, margin

    # the JAX package's bars against the uncompressed model, on the port
    loss, grads, layout = _port_grads(mode, torch.float32, init="own")
    base_loss, base_grads, base_layout = _port_uncompressed(torch.float32, "own")
    assert layout == base_layout  # no parameter or buffer added
    flat = torch.cat([grads[k].ravel() for k in base_grads]).numpy()
    base = torch.cat([g.ravel() for g in base_grads.values()]).numpy()
    print(f"{mode}: vs act_compress='none' loss {abs(loss - base_loss):.3g}, gradient "
          f"cosine {_cosine(flat, base):.6f}")
    if mode == "q8save":
        assert abs(loss - base_loss) < 1e-6, (loss, base_loss)
        assert _cosine(flat, base) > 0.999
    else:
        assert abs(loss - base_loss) < 5e-2, (loss, base_loss)
        assert _cosine(flat, base) > 0.9


def test_act_compress_is_checked():
    with pytest.raises(ValueError, match="unknown act_compress"):
        create_model("efficientnet", label_dim=N_CLASS, eff_b=0, act_compress="int4")
    for name in ("resnet", "mbnet"):
        with pytest.raises(ValueError, match="EfficientNet-only"):
            create_model(name, label_dim=N_CLASS, act_compress="q8save")
