"""One train step of the port's ResNet50 and MobileNetV2 against the JAX
package's ``make_train_step_fn``, on the CPU.

Both packages start from the same numpy-made variables
(``torch_port_fixtures.jax_backbone_variables``). The port takes a tone
batch (4 clips, T=64, 128 mels, 7 classes; mixup 0.5 with the batch rolled
by one, SpecAugment 48/24) with draws rebuilt from a JAX step's key
(tests/test_torch_augment.py), once in float32 and once with the model cast
to float64. Neither backbone has drop-connect: the draws carry no keep
masks. JAX's step runs in float64 on the port's log-mel and labels
(``_float64_pins``): the two backbones name ``jnp.float32`` for their
BatchNorm outputs, MBNet's classifier, the attention head's sigmoid and
flax's statistics, and those are raised to float64. The log-mel is the
port's because the two packages' float32 fbanks differ by up to ~1e-3 on
near-silent bands (tests/test_torch_augment.py holds them to each other).
The gradients come out of each step: the port's from ``.grad``, JAX's
from a transform chained before its optimizer that keeps them
(``torch_port_fixtures.grad_recording``).

Bars. Against JAX's float64 step, measured: the port's float64 step's
loss 1e-12 (2.4e-14), each leaf's gradient within 1e-9 of the JAX leaf's
norm plus 1e-12 of the whole gradient's (1.6e-11; MBNet's projection
BatchNorm biases have a true gradient of 0, since a constant there is
removed by the next train-mode BatchNorm, and both packages return
~1e-16), the running statistics 1e-9 relative + 1e-10 (3.3e-12); the
port's float32 step's loss 1e-5 (2.6e-7), gradients 1e-3 plus 1e-6 of the
whole (4.0e-5), running statistics 1e-6 + 2e-5 relative
(tests/test_torch_train_step.py; 1.1e-5 on a running variance of 2.7).
The parameters after Adam: its first update lr * g / (|g| + eps) moves by
at most lr / eps times a change of g, so each parameter lies within that
much of the gradient difference of JAX's, plus 1e-12 (float64) or 1e-7 and
one float32 spacing (float32). The float32 step's parameters are also
optax's Adam (the JAX package's ``make_optimizer``) on the port's own
gradients within 1e-7 plus one float32 spacing. BatchNorm's momentum is
torch's 0.1 (flax's 0.9), and every parameter and statistic moved.
"""

import contextlib
import types
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import psla_tpu.models.layers as jax_layers
import psla_tpu.models.mobilenet as jax_mobilenet
import psla_tpu.models.pooling as jax_pooling
import psla_tpu.models.resnet as jax_resnet
import psla_tpu.train.step as jax_step
import psla_tpu_torch.train.step as port_step
from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.train.optim import make_optimizer as jax_make_optimizer
from psla_tpu.train.state import TrainState as JaxTrainState
from psla_tpu_torch.frontend.pipeline import PreprocessConfig, preprocess_train
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.models.layers import BatchNorm
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import TrainDraws, build_train_step, draw_train
from tests.test_torch_augment import jax_preprocess_draws, tone_batch
from tests.test_torch_backbones import NAMES, N_CLASS, port_model
from tests.torch_port_fixtures import grad_recording, jax_backbone, jax_backbone_variables

torch.set_num_threads(2)

B, T, F = 4, 64, 128
LR = 1e-3
SEED = 3
AUGMENT = dict(freq_mask=48, time_mask=24, mixup_rate=0.5)
STATS_ATOL, STATS_RTOL = 1e-6, 2e-5
ADAM_EPS = 1e-8  # the JAX package's and the port's

def _step_batch() -> dict:
    batch = tone_batch(30, PreprocessConfig(target_length=T).fbank.buffer_length(T), b=B)
    batch["labels"] = np.eye(N_CLASS, dtype=np.float32)[np.arange(B) % N_CLASS]
    batch["mix_labels"] = np.roll(batch["labels"], 1, 0)
    return batch


def _float64(sd: dict) -> dict:
    return {k: t.detach().double() for k, t in sd.items()}


def _port_step(name: str, dtype: torch.dtype, batch: dict, draws: TrainDraws) -> dict:
    """The port's step from the shared start: its loss, state_dict,
    gradients and the log-mel its preprocessing made."""
    model = port_model(name, jax_backbone_variables(name, SEED, N_CLASS), dtype=dtype).to(dtype)
    assert draw_train(torch.Generator().manual_seed(0), model, B,
                      PreprocessConfig(target_length=T, **AUGMENT)).keep is None
    # torch's momentum 0.1 (flax's 0.9 in the JAX model)
    assert {m.momentum for m in model.modules() if isinstance(m, BatchNorm)} == {0.1}
    state = create_train_state(model, lambda step: LR, device="cpu")
    seen = []

    def recording(*args):
        seen.append(preprocess_train(*args))
        return seen[-1]

    with mock.patch.object(port_step, "preprocess_train", recording):
        state, metrics = build_train_step(PreprocessConfig(target_length=T, **AUGMENT))(
            state, batch, draws)
    assert state.step == 1
    return {"loss": float(metrics["loss"]), "dtype": dtype, "sd": _float64(model.state_dict()),
            "grads": {k: p.grad.detach().double() for k, p in model.named_parameters()},
            "logmel": seen[0][0]}


def _jax_step64(name: str, batch: dict) -> dict:
    """The JAX package's step in float64 (under ``_float64_pins``): its
    loss, state_dict and gradients under the port's keys."""
    with jax.enable_x64(True):
        v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                         jax_backbone_variables(name, SEED, N_CLASS))
        tx = grad_recording(jax_make_optimizer(lambda step: LR))
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                              batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
        fn = jax_step.make_train_step_fn(jax_backbone(name, N_CLASS, jnp.float64), tx,
                                         JaxPreprocessConfig(target_length=T))
        state, metrics = jax.jit(fn)(state, batch, jax.random.PRNGKey(42))
        tree = jax.tree.map(np.asarray, {"params": state.params,
                                         "batch_stats": state.batch_stats})
        grads = jax.tree.map(np.asarray, state.opt_state[0])
    return {"loss": float(metrics["loss"]), "dtype": torch.float64,
            "sd": _state_dict64(tree),
            "grads": _params_only(_state_dict64(dict(tree, params=grads)))}


@contextlib.contextmanager
def _float64_pins(logmel: torch.Tensor, labels: torch.Tensor):
    """The JAX package's step in float64 on the port's log-mel and labels.
    Its preprocess_train, which make_train_step_fn looks up when it is
    traced, returns them; the rest of the step (the train forward, BCE,
    backward, the BatchNorm updates, Adam) is the JAX package's, with the
    ``jnp.float32`` its model modules name raised to float64."""
    pins = types.SimpleNamespace(**vars(jnp))
    pins.float32 = jnp.float64
    with contextlib.ExitStack() as stack:
        for module in (jax_layers, jax_pooling, jax_mobilenet, jax_resnet):
            stack.enter_context(mock.patch.object(module, "jnp", pins))
        with jax.enable_x64(True):
            x = jnp.asarray(logmel.numpy(), jnp.float64)
            y = jnp.asarray(labels.numpy(), jnp.float64)
        stack.enter_context(mock.patch.object(jax_step, "preprocess_train",
                                              lambda key, wavs, config: (x, y)))
        yield


def _state_dict64(tree: dict) -> dict:
    """``from_jax_variables`` of a float64 tree, in float64: the converter
    keeps float32, so the tree goes through it as the sum of two float32
    trees (the rounded tree and what the rounding left)."""
    hi = jax.tree.map(lambda a: a.astype(np.float32), tree)
    lo = jax.tree.map(lambda a, h: (a - h).astype(np.float32), tree, hi)
    hi, lo = from_jax_variables(hi, N_CLASS), from_jax_variables(lo, N_CLASS)
    return {k: hi[k].double() + lo[k].double() for k in hi}


def _params_only(sd: dict) -> dict:
    """A state_dict without its BatchNorm statistics."""
    return {k: t for k, t in sd.items() if not k.endswith(("running_mean", "running_var"))}


@pytest.fixture(scope="module")
def steps():
    """The port's step of each backbone in float32 and in float64, and the
    JAX package's in float64, from the same start and draws."""
    batch = _step_batch()
    rng = jax.random.PRNGKey(42)
    pre_key, _ = jax.random.split(jax.random.fold_in(rng, 0))
    draws = TrainDraws(jax_preprocess_draws(pre_key, B, T, F), None)
    # the port's log-mel of the batch: both of its steps make this one
    logmel, labels = preprocess_train(port_step._wav_batch(batch, torch.device("cpu")),
                                      draws.pre, PreprocessConfig(target_length=T, **AUGMENT))
    for name in NAMES:  # drawn (and cached) outside the pins
        jax_backbone_variables(name, SEED, N_CLASS)
    out = {}
    with _float64_pins(logmel, labels), ThreadPoolExecutor(len(NAMES)) as pool:
        jax64 = {name: pool.submit(_jax_step64, name, batch) for name in NAMES}
        for name in NAMES:  # while the JAX steps compile
            for dtype in (torch.float32, torch.float64):
                out[name, dtype] = _port_step(name, dtype, batch, draws)
                assert torch.equal(out[name, dtype].pop("logmel"), logmel)
        for name in NAMES:
            out[name, "jax"] = jax64[name].result()
    return out


def _gradients_within(got: dict, want: dict, rtol: float, floor: float) -> None:
    """Each leaf of ``got`` within ``rtol`` of the norm of ``want``'s leaf,
    plus ``floor`` of the norm of the whole of ``want``."""
    assert got.keys() == want.keys()
    whole = float(torch.sqrt(sum((g ** 2).sum() for g in want.values())))
    for k, g in want.items():
        off = float((got[k] - g).norm())
        assert off <= rtol * float(g.norm()) + floor * whole, (k, off, float(g.norm()))


def _adam_moves_within(got: dict, want: dict, atol: float) -> None:
    """Each parameter of ``got`` within ``atol`` of ``want``'s, plus lr / eps
    times the two steps' gradient difference (one float32 spacing more for
    a float32 parameter)."""
    for k, g in want["grads"].items():
        p, ref = got["sd"][k], want["sd"][k]
        bar = atol + LR / ADAM_EPS * (got["grads"][k] - g).abs()
        if got["dtype"] == torch.float32:
            bar = bar + torch.from_numpy(np.spacing(np.abs(ref.float().numpy()))).double()
        assert ((p - ref).abs() <= bar).all(), (k, float((p - ref).abs().max()))


@pytest.mark.parametrize("precision", ["float32", "float64"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name, precision, steps):
    """One train step (batch statistics, BCE, backward, Adam) from the same
    variables and draws, held to the JAX package's step (see the module
    docstring for the bars)."""
    exact = steps[name, "jax"]
    start = _float64(from_jax_variables(jax_backbone_variables(name, SEED, N_CLASS), N_CLASS))
    stats = [k for k in start if k.endswith(("running_mean", "running_var"))]
    params = list(exact["grads"])
    if precision == "float64":
        got = steps[name, torch.float64]
        assert abs(got["loss"] - exact["loss"]) < 1e-12, (got["loss"], exact["loss"])
        _gradients_within(got["grads"], exact["grads"], 1e-9, 1e-12)
        for k in stats:
            torch.testing.assert_close(got["sd"][k], exact["sd"][k], rtol=1e-9, atol=1e-10,
                                       msg=k)
        _adam_moves_within(got, exact, 1e-12)
        return

    got = steps[name, torch.float32]
    assert abs(got["loss"] - exact["loss"]) < 1e-5, (got["loss"], exact["loss"])
    for k in stats:
        bar = STATS_ATOL + STATS_RTOL * exact["sd"][k].abs()
        assert ((got["sd"][k] - exact["sd"][k]).abs() <= bar).all(), k
        assert not torch.equal(got["sd"][k], start[k]), k  # the statistics moved
    _gradients_within(got["grads"], exact["grads"], 1e-3, 1e-6)
    _adam_moves_within(got, exact, 1e-7)

    # the port's parameters are optax's Adam on the port's own gradients
    tx = jax_make_optimizer(lambda step: LR)
    adam = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        {k: got["grads"][k].float().numpy() for k in params},
        {k: start[k].float().numpy() for k in params})
    for k in params:
        ref = np.asarray(adam[k])
        err = np.abs(got["sd"][k].float().numpy() - ref)
        assert (err <= 1e-7 + np.spacing(np.abs(ref))).all(), (k, err.max())
        assert not torch.equal(got["sd"][k], start[k]), k  # every parameter moved
