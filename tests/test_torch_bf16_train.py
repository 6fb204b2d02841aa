"""bfloat16 training of the port (``--dtype bfloat16``) against the JAX
package's bf16 train step, and the train-mode BatchNorm on a bf16 input
against flax's, on the CPU.

The step: EffNetAttention(b=0, 4 heads, 4 classes, drop-connect off) from
the shared numpy-made variables (tests/torch_port_fixtures.py), one tone
batch of 4 clips at T=64, 128 mels, deterministic preprocessing, BCE and
Adam at lr 1e-3. The JAX step (``make_train_step_fn``, the model built
with ``dtype=jnp.bfloat16``) and the port's steps all take one log-mel and
labels that the port made (each ``preprocess_train`` patched to return
them: the two packages' float32 fbanks differ by up to ~1e-3 on
near-silent bands), the JAX step compiled with XLA's excess precision off
(``STRICT_BF16``). The float32 control is the port's float32 step on the
same inputs: 1.3e-5 from JAX's float32 step in the loss, and JAX's
bf16-vs-float32 spread measured against either is the same to four digits
(0.43119 and 0.43117 of the gradient's norm), so it stands for JAX's own.
The port's ``--act-compress q8save`` step is held to the same JAX step: a
q8save forward is the uncompressed one (tests/test_qsave.py), and int8
moves only the depthwise weight gradients, by ~1e-3 of their norm
(tests/test_torch_qsave.py), under a hundredth of the gradient bar.

Bars, the repo's bf16 rule (tests/test_torch_model.py,
tests/test_torch_backbones.py): about twice the measured error, and no
more than twice JAX's own bf16-vs-float32 spread on the same inputs.
Measured, port bf16 vs JAX bf16 (JAX bf16 vs float32), the same for
``none`` and ``q8save`` to three digits:
- the loss 3.03e-3 (8.45e-3), bar 6e-3;
- the stem BatchNorm's running statistics after the step, max 9.5e-7
  (2.3e-4), bar 2e-6 and a twentieth of the spread: they are taken before
  any bf16 rounding has been carried through a BatchNorm, so they hold
  the bf16 rounding of the stem convolution itself;
- the gradients, the distance of the whole relative to its norm, 0.448
  (0.431), bar 0.9;
- all running statistics after the step, max 1.9e-2 (2.16e-2), bar 0.04.
Only the loss and the stem's statistics separate the bf16 step from a
float32 one. At this size (batch 4, T=64, so 32 to 2048 values a channel
for each train-mode BatchNorm) bf16 rounding moves the gradients of
either package by ~40% of their norm, in every block alike (the same at
batch 16, T=128): the gradient and statistics bars say only that the port
is no further from JAX's bf16 step than that step is from float32.

The train-mode BatchNorm on a bf16 input: the one-process layer within one
bf16 spacing of flax's ``ReferenceBatchNorm(dtype=bfloat16)`` (measured:
equal on every output), its running statistics within 1e-6;
``BatchNorm(float_out=True)`` within 1e-6 of the float64 layer (measured
6.5e-7) and of flax's ``ReferenceBatchNorm(dtype=float32)`` within 1e-6
plus flax's own distance from the float64 layer (8.3e-6; flax takes the
variance as E[x^2] - E[x]^2), its running statistics likewise; rounding the
output to bf16 before casting it up would miss by ~1e-2. Remat under
q8save: the bf16 step with ``remat=True`` equals the step without, bit
for bit.
"""

import concurrent.futures
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import psla_tpu.train.step as jax_step
import psla_tpu_torch.train.step as port_step
from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.models import EffNetAttention as JaxEffNetAttention
from psla_tpu.models.layers import ReferenceBatchNorm
from psla_tpu.train.optim import make_optimizer as jax_make_optimizer
from psla_tpu.train.state import TrainState as JaxTrainState
from psla_tpu_torch.frontend.pipeline import PreprocessConfig, preprocess_train
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.models.layers import BN_EPS, BatchNorm
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import _wav_batch, build_train_step, draw_train
from tests.test_torch_augment import tone_batch
from tests.torch_port_fixtures import grad_recording, jax_variables

torch.set_num_threads(2)

B, T, N_CLASS, HEADS, SEED, LR = 4, 64, 4, 4, 21, 1e-3
CONFIG = PreprocessConfig(target_length=T, freq_mask=0, time_mask=0, mixup_rate=0.0)
LOSS_BAR, STEM_BAR, GRAD_BAR, STATS_BAR = 6e-3, 2e-6, 0.9, 0.04
STEM_STATS = ("effnet._bn0.running_mean", "effnet._bn0.running_var")

# XLA's CPU backend computes a bf16 convolution in float32 and, by default
# (xla_allow_excess_precision), keeps its output in float32 where the program
# rounds it to bf16 (on a TPU or a GPU the output is bf16). The JAX steps are
# compiled with that option off: the same bits as a process started with
# XLA_FLAGS=--xla_allow_excess_precision=false (tests/test_torch_backbones.py).
# LLVM's expensive passes are skipped: they keep IEEE semantics (XLA sets no
# fast-math), so the bits are the same, and a bf16 step compiles in about
# half the time.
STRICT_BF16 = {"xla_allow_excess_precision": False, "xla_llvm_disable_expensive_passes": True}


def _jax_step():
    """The JAX package's bf16 train step (``make_train_step_fn``) from the
    shared start, compiled; calling the result runs it and returns its
    loss, gradients (kept by ``grad_recording``) and running statistics,
    under the port's keys."""
    v = jax_variables(HEADS, SEED, N_CLASS)
    model = JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=HEADS, drop_connect_rate=0.0,
                               dtype=jnp.bfloat16)
    tx = grad_recording(jax_make_optimizer(lambda step: LR))
    state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                          batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    fn = jax_step.make_train_step_fn(model, tx, JaxPreprocessConfig(target_length=T))
    args = (state, _batch(), jax.random.PRNGKey(0))
    compiled = jax.jit(fn, compiler_options=STRICT_BF16).lower(*args).compile()

    def run() -> dict:
        state, metrics = compiled(*args)
        sd = from_jax_variables(jax.tree.map(np.asarray, {
            "params": state.opt_state[0], "batch_stats": state.batch_stats}), N_CLASS)
        stats = ("running_mean", "running_var")
        return {"loss": float(metrics["loss"]),
                "grads": {k: t for k, t in sd.items() if not k.endswith(stats)},
                "stats": {k: t for k, t in sd.items() if k.endswith(stats)}}

    return run


def _batch() -> dict:
    batch = tone_batch(30, CONFIG.fbank.buffer_length(T))
    batch["labels"] = np.eye(N_CLASS, dtype=np.float32)[np.arange(B) % N_CLASS]
    batch["mix_labels"] = np.roll(batch["labels"], 1, 0)
    return batch


def _port_step(dtype: torch.dtype, mode: str = "none", remat: bool = False,
               inputs: tuple[torch.Tensor, torch.Tensor] | None = None) -> dict:
    """The port's train step from the shared start: its loss, gradients and
    running statistics after the step. ``inputs``: the (log-mel, labels)
    its ``preprocess_train`` returns, in place of computing them."""
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=HEADS,
                         drop_connect_rate=0.0, dtype=dtype, act_compress=mode, remat=remat)
    model.load_state_dict(from_jax_variables(jax_variables(HEADS, SEED, N_CLASS), N_CLASS))
    state = create_train_state(model, lambda step: LR, device="cpu")
    draws = draw_train(torch.Generator().manual_seed(0), model, B, CONFIG)
    assert draws.keep is None  # drop-connect off: the JAX side draws no masks
    with contextlib.ExitStack() as stack:
        if inputs is not None:
            stack.enter_context(mock.patch.object(port_step, "preprocess_train",
                                                  lambda *args: inputs))
        state, metrics = build_train_step(CONFIG)(state, _batch(), draws)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    return {"loss": float(metrics["loss"]),
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "stats": {k: t.clone() for k, t in model.state_dict().items()
                      if k.endswith(("running_mean", "running_var"))}}


@pytest.fixture(scope="module")
def steps():
    """{"jax": the JAX bf16 step, "float32": the port's float32 step,
    "none"/"q8save": the port's bf16 steps}, each {"loss", "grads",
    "stats"}. Every step's ``preprocess_train`` returns one log-mel and
    labels, made once by the port: under a loaded machine the JAX bf16
    step's loss was once 0.6130 against its usual 0.6269 (bf16 rounding
    through the train-mode BatchNorms turns any float32 difference of the
    inputs into more than the bars). The JAX step compiles in a thread
    while the port's run."""
    draws = draw_train(torch.Generator().manual_seed(0), create_model(
        "efficientnet", label_dim=N_CLASS, eff_b=0, drop_connect_rate=0.0), B, CONFIG)
    inputs = preprocess_train(_wav_batch(_batch(), torch.device("cpu")), draws.pre, CONFIG)
    jax_variables(HEADS, SEED, N_CLASS)  # filled once, before the thread shares it
    x, y = (jnp.asarray(t.numpy()) for t in inputs)
    with mock.patch.object(jax_step, "preprocess_train", lambda key, wavs, config: (x, y)), \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        compiled = pool.submit(_jax_step)
        out = {m: _port_step(torch.bfloat16, m, inputs=inputs) for m in ("none", "q8save")}
        out["float32"] = _port_step(torch.float32, inputs=inputs)
        out["jax"] = compiled.result()()
    return out


def _whole(d: dict, keys) -> torch.Tensor:
    return torch.cat([d[k].double().ravel() for k in keys])


@pytest.mark.parametrize("mode", ["none", "q8save"])
def test_bfloat16_train_step_matches_jax(steps, mode):
    """The port's bf16 step (``--dtype bfloat16``, and with ``--act-compress
    q8save``) against the JAX package's, at the bars of the module
    docstring."""
    got, want, f32 = steps[mode], steps["jax"], steps["float32"]
    loss_err, loss_spread = abs(got["loss"] - want["loss"]), abs(want["loss"] - f32["loss"])
    s, sw, s32 = (_whole(r["stats"], STEM_STATS) for r in (got, want, f32))
    stem_err, stem_spread = float((s - sw).abs().max()), float((sw - s32).abs().max())
    g, gw, g32 = (_whole(r["grads"], got["grads"]) for r in (got, want, f32))
    grad_err = float((g - gw).norm() / gw.norm())
    grad_spread = float((gw - g32).norm() / gw.norm())
    s, sw, s32 = (_whole(r["stats"], got["stats"]) for r in (got, want, f32))
    stats_err, stats_spread = float((s - sw).abs().max()), float((sw - s32).abs().max())
    print(f"{mode}: loss {loss_err:.3g} (spread {loss_spread:.3g}), stem statistics "
          f"{stem_err:.3g} ({stem_spread:.3g}), gradients {grad_err:.3g} ({grad_spread:.3g}), "
          f"statistics {stats_err:.3g} ({stats_spread:.3g})")
    assert loss_err <= LOSS_BAR and loss_err <= 2 * loss_spread, (loss_err, loss_spread)
    assert stem_err <= STEM_BAR and stem_err <= stem_spread / 20, (stem_err, stem_spread)
    assert grad_err <= GRAD_BAR and grad_err <= 2 * grad_spread, (grad_err, grad_spread)
    assert stats_err <= STATS_BAR and stats_err <= 2 * stats_spread, (stats_err, stats_spread)


def test_bfloat16_q8save_step_is_the_same_under_remat():
    """Remat replays each block's forward in backward, the int8 copy and the
    bf16 BatchNorms included: the same step, bit for bit."""
    a = _port_step(torch.bfloat16, "q8save")
    b = _port_step(torch.bfloat16, "q8save", remat=True)
    assert a["loss"] == b["loss"]
    for part in ("grads", "stats"):
        for k, t in a[part].items():
            torch.testing.assert_close(b[part][k], t, rtol=0, atol=0, msg=k)


def _bn_case(c: int = 16):
    rng = np.random.default_rng(8)
    mean = rng.normal(0.0, 2.0, c).astype(np.float32)
    x = (mean + rng.uniform(0.5, 2.0, c) * rng.standard_normal((4, 6, 10, c)))  # NHWC
    params = {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
              "bias": rng.normal(0.0, 0.1, c).astype(np.float32)}
    stats = {"mean": rng.normal(0.0, 0.1, c).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return jnp.asarray(x, jnp.bfloat16), params, stats


def _flax_train_bn(x16, params, stats, dtype, eps: float, momentum: float):
    bn = ReferenceBatchNorm(use_running_average=False, momentum=momentum, epsilon=eps,
                            dtype=dtype)
    y, mutated = jax.jit(lambda v, x: bn.apply(v, x, mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, x16)
    return np.asarray(y.astype(jnp.float32)), jax.tree.map(np.asarray, mutated["batch_stats"])


def _port_train_bn(x16, params, stats, eps: float, momentum: float, float_out: bool):
    bn = BatchNorm(x16.shape[-1], eps=eps, momentum=momentum, float_out=float_out)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    x = torch.from_numpy(np.array(x16.astype(jnp.float32))).permute(0, 3, 1, 2)
    with torch.no_grad():
        y = bn.train()(x.bfloat16())
    return y, bn


def test_train_batchnorm_on_bfloat16_matches_flax():
    """EfficientNet's layer (flax ``dtype=bfloat16``): statistics in
    float32, the output rounded once to bf16."""
    x16, params, stats = _bn_case()
    ref, ref_stats = _flax_train_bn(x16, params, stats, jnp.bfloat16, BN_EPS, 0.99)
    y, bn = _port_train_bn(x16, params, stats, BN_EPS, 0.01, float_out=False)
    assert y.dtype == torch.bfloat16
    got = y.float().permute(0, 2, 3, 1).numpy()
    spacing = np.spacing(np.abs(ref).astype(jnp.bfloat16)).astype(np.float32)
    assert (np.abs(got - ref) <= spacing).all()
    print(f"bf16 BatchNorm: {np.mean(got != ref):.2%} of the outputs off flax's by a spacing")
    np.testing.assert_allclose(bn.running_mean.numpy(), ref_stats["mean"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(), ref_stats["var"], atol=1e-6, rtol=0)


def test_train_batchnorm_float_out_matches_flax():
    """ResNet50's and MobileNetV2's layer (flax ``dtype=float32``) on a
    bf16 input: normalized in float32 and returned in float32, never
    rounded to bf16. Held to the float64 layer on the same input within
    1e-6, and to flax within 1e-6 plus flax's own distance from it (the
    bars of tests/test_torch_distributed.py)."""
    x16, params, stats = _bn_case()
    ref, ref_stats = _flax_train_bn(x16, params, stats, jnp.float32, 1e-5, 0.9)
    y, bn = _port_train_bn(x16, params, stats, 1e-5, 0.1, float_out=True)
    assert y.dtype == torch.float32
    x64 = np.asarray(x16.astype(jnp.float32)).astype(np.float64)
    exact = ((x64 - x64.mean((0, 1, 2))) / np.sqrt(x64.var((0, 1, 2)) + 1e-5)
             * params["scale"] + params["bias"])
    got = y.permute(0, 2, 3, 1).numpy()
    err, flax_own = float(np.abs(got - exact).max()), float(np.abs(ref - exact).max())
    print(f"float_out BatchNorm: {err:.3g} from the float64 layer (flax {flax_own:.3g})")
    assert err <= 1e-6, err
    assert float(np.abs(got - ref).max()) <= 1e-6 + flax_own
    n = x64.size // x64.shape[-1]
    for k, batch in (("mean", x64.mean((0, 1, 2))), ("var", x64.var((0, 1, 2)) * n / (n - 1))):
        exact = 0.9 * stats[k] + 0.1 * batch
        port = getattr(bn, f"running_{k}").numpy()
        flax_own = float(np.abs(ref_stats[k] - exact).max())
        assert float(np.abs(port - exact).max()) <= 1e-6, k
        assert float(np.abs(port - ref_stats[k]).max()) <= 1e-6 + flax_own, k
