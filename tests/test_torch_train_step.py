"""The port's train step against psla_tpu's ``make_train_step_fn``.

Both start from the same numpy-made EffNetAttention(b=0) variables
(tests/torch_port_fixtures.py) and take the same raw waveform batches (the
batch rolled by one as the mixup partners). The JAX step makes its draws
from ``fold_in(rng, step)``; the port's step is fed the same draws, rebuilt
from that key (``jax_preprocess_draws``, tests/test_torch_augment.py).
Drop-connect is off on both sides, as in tests/test_torch_twin.py: flax
draws its masks per module path, which the port does not rebuild (the
masks themselves are held to JAX's in tests/test_torch_train.py).

Bars, tests/test_torch_twin.py's (157-158, 248-249): the step-0 loss 1e-5
deterministic and 1e-4 with mixup and SpecAugment (the JAX step fuses its
preprocessing into the forward), 2e-2 over the run (Adam's sqrt(v) grows
reduction-order noise). After the first deterministic step the running
statistics are held at 1e-5 plus 5e-5 relative: the forward's own bar
(tests/test_torch_train.py, same inputs) is 1e-5, and here each package
also makes its own log-mels (float32 FFTs that differ by up to ~1.3e-3 on
near-silent bands), which the last blocks' statistics, taken over 32 values
a channel, carry to ~2e-5 on running variances of ~1.4.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.models import EffNetAttention as JaxEffNetAttention
from psla_tpu.train.optim import make_optimizer as jax_make_optimizer
from psla_tpu.train.state import TrainState as JaxTrainState
from psla_tpu.train.step import make_train_step_fn as jax_make_train_step_fn
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import TrainDraws, build_train_step
from tests.test_torch_augment import jax_preprocess_draws, tone_batch
from tests.torch_port_fixtures import jax_variables

torch.set_num_threads(2)

B, T, F, N_CLASS = 4, 64, 128, 4
N_STEPS = 4
LR = 1e-3


def batches(n: int) -> list[dict]:
    out = []
    for seed in range(2):
        bt = tone_batch(30 + seed, n)
        bt["labels"] = np.eye(N_CLASS, dtype=np.float32)[(np.arange(B) + seed) % N_CLASS]
        bt["mix_labels"] = np.roll(bt["labels"], 1, 0)
        out.append(bt)
    return out


def config_kwargs(augmented: bool) -> dict:
    return (dict(freq_mask=48, time_mask=24, mixup_rate=0.5) if augmented
            else dict(freq_mask=0, time_mask=0, mixup_rate=0.0))


def jax_run(augmented: bool) -> tuple[list[float], dict]:
    """N_STEPS of the JAX step: its losses, and its state after step 0."""
    jax_cfg = JaxPreprocessConfig(target_length=T, **config_kwargs(augmented))
    data = batches(jax_cfg.fbank.buffer_length(T))
    v = jax_variables(4, 21, N_CLASS)
    jax_model = JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=4, drop_connect_rate=0.0)
    tx = jax_make_optimizer(lambda step: LR)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                           batch_stats=v["batch_stats"], opt_state=tx.init(v["params"]))
    jax_step = jax.jit(jax_make_train_step_fn(jax_model, tx, jax_cfg))
    rng = jax.random.PRNGKey(42)
    losses, first = [], None
    for i in range(N_STEPS):
        jstate, m = jax_step(jstate, data[i % len(data)], rng)
        losses.append(float(m["loss"]))
        if i == 0:
            first = {"params": jstate.params,
                     "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}
    return losses, first


@pytest.fixture(scope="module")
def jax_runs():
    """Both cases' JAX runs, compiled and run in two threads (XLA releases
    the interpreter lock): {augmented: (losses, state after step 0)}."""
    jax_variables(4, 21, N_CLASS)  # filled once, before the threads share it
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        runs = {a: pool.submit(jax_run, a) for a in (False, True)}
        return {a: f.result() for a, f in runs.items()}


@pytest.mark.parametrize("augmented", [False, True])
def test_train_step_matches_jax(jax_runs, augmented):
    cfg = PreprocessConfig(target_length=T, **config_kwargs(augmented))
    data = batches(cfg.fbank.buffer_length(T))
    v = jax_variables(4, 21, N_CLASS)
    jax_losses, jax_first = jax_runs[augmented]
    rng = jax.random.PRNGKey(42)

    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=4,
                         drop_connect_rate=0.0)
    model.load_state_dict(from_jax_variables(v, N_CLASS))
    state = create_train_state(model, lambda step: LR, device="cpu")
    step = build_train_step(cfg)

    losses = []
    for i in range(N_STEPS):
        batch = data[i % len(data)]
        pre_key, _ = jax.random.split(jax.random.fold_in(rng, i))
        draws = TrainDraws(jax_preprocess_draws(pre_key, B, T, F), None)
        state, m = step(state, batch, draws)
        losses.append(float(m["loss"]))
        if i == 0 and not augmented:
            want = from_jax_variables(jax_first, N_CLASS)
            for k, t in model.state_dict().items():
                if k.endswith(("running_mean", "running_var")):
                    np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-5,
                                               rtol=5e-5, err_msg=k)
    diffs = np.abs(np.asarray(jax_losses) - np.asarray(losses))
    assert diffs[0] < (1e-4 if augmented else 1e-5), (jax_losses[0], losses[0])
    assert diffs.max() < 2e-2, list(zip(jax_losses, losses))
    assert state.step == N_STEPS
    assert losses[-1] < losses[0], losses  # it learns
