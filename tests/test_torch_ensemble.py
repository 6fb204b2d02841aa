"""The port's multi-seed ensemble steps (``psla_tpu_torch/parallel/
ensemble.py``) against the JAX package's (``psla_tpu/parallel/ensemble.py``).

``ensemble_layout`` is held to JAX's on tests/test_parallel.py's table and
a sweep. The train step is held to ``build_ensemble_train_step_single_rng``
on a one-device ('ensemble', 'data') mesh, the JAX package's "2 seeds on
one chip": E=2, batch 4, T=64, 3 steps with mixup 0.5 and SpecAugment,
drop-connect off on both sides (flax draws its masks per module path,
which the port does not rebuild). Each member's weights are the shared
numpy-made EffNetAttention(b=0) variables of its own seed
(tests/torch_port_fixtures.py), stacked for JAX and carried into the port
by ``from_jax_variables``; each member's draws are rebuilt from JAX's key
``split(fold_in(fold_in(rng, m), step))[0]`` (``jax_preprocess_draws``).
Bars, tests/test_torch_twin.py's (157-158, 248-249): each seed's step-0
loss 1e-4, 2e-2 over the run. The eval step is held to
``build_ensemble_eval_step``: probabilities 2e-5, per-sample losses 1e-5
(tests/test_torch_train.py's eval-step bars). On the CPU the log-mel
computations are counted: E a train step, 1 an eval batch.
"""

import concurrent.futures
import functools
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.models import EffNetAttention as JaxEffNetAttention
from psla_tpu.parallel import ensemble as jax_ensemble
from psla_tpu.parallel.mesh import make_mesh, shard_batch
from psla_tpu.train.optim import make_optimizer as jax_make_optimizer
from psla_tpu.train.state import TrainState as JaxTrainState
from psla_tpu_torch.frontend import pipeline
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.parallel import ensemble
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import TrainDraws
from tests.test_torch_augment import jax_preprocess_draws, tone_batch
from tests.torch_port_fixtures import jax_variables

torch.set_num_threads(2)

E, B, T, F, N_CLASS, HEADS = 2, 4, 64, 128, 4, 4
SEEDS = (21, 22)
N_STEPS = 3
LR = 1e-3
AUG = dict(freq_mask=48, time_mask=24, mixup_rate=0.5)


# ------------------------------------------------------------ layout

LAYOUT_TABLE = [  # tests/test_parallel.py's cases
    (2, 8, 0, 1), (3, 8, 0, 1), (10, 8, 0, 1), (2, 1, 0, 1),
    (2, 8, 3, 4), (2, 8, 1, 4), (2, 8, 2, 4),
    (4, 8, 1, 2), (2, 4, 1, 2), (6, 6, 3, 4),
]


def layout_sweep(num_hosts: int) -> list[tuple[int, int, int, int]]:
    """Seeds 1-12 on 1-16 devices a host, from every host of ``num_hosts``."""
    return [(seeds, per_host * num_hosts, host, num_hosts)
            for seeds, per_host, host in itertools.product(
                range(1, 13), (1, 2, 4, 8, 16), range(num_hosts))]


@pytest.mark.parametrize("cases", [[c] for c in LAYOUT_TABLE]
                         + [layout_sweep(h) for h in (1, 2, 4)],
                         ids=[f"{c}" for c in LAYOUT_TABLE]
                         + [f"sweep-{h}-hosts" for h in (1, 2, 4)])
def test_ensemble_layout_matches_jax(cases):
    for seeds, n_devices, host_id, num_hosts in cases:
        assert ensemble.ensemble_layout(seeds, n_devices, host_id, num_hosts) == \
            jax_ensemble.ensemble_layout(seeds, n_devices, host_id, num_hosts), \
            (seeds, n_devices, host_id, num_hosts)


# ------------------------------------------------------------ steps


def batches(n: int) -> list[dict]:
    out = []
    for seed in range(2):
        bt = tone_batch(40 + seed, n)
        bt["labels"] = np.eye(N_CLASS, dtype=np.float32)[(np.arange(B) + seed) % N_CLASS]
        bt["mix_labels"] = np.roll(bt["labels"], 1, 0)
        out.append(bt)
    return out


def stacked(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def port_state() -> ensemble.EnsembleState:
    members = []
    for s in SEEDS:
        model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=HEADS,
                             drop_connect_rate=0.0)
        model.load_state_dict(from_jax_variables(jax_variables(HEADS, s, N_CLASS), N_CLASS))
        members.append(create_train_state(model, lambda step: LR, device="cpu"))
    return ensemble.EnsembleState(members)


@functools.lru_cache(maxsize=None)
def jax_model():
    return JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=HEADS, drop_connect_rate=0.0)


@functools.lru_cache(maxsize=None)
def jax_mesh():
    return make_mesh(num_devices=1, ensemble=1, ensemble_axis=True)


def jax_train_state(members: list[dict], tx, mesh) -> JaxTrainState:
    params = stacked([v["params"] for v in members])
    return jax.device_put(JaxTrainState(
        step=np.zeros((E,), np.int32), params=params,
        batch_stats=stacked([v["batch_stats"] for v in members]),
        opt_state=jax.jit(jax.vmap(tx.init))(params)), NamedSharding(mesh, P("ensemble")))


def compiled(step, *args):
    """``step`` (a jitted function) lowered and compiled for ``args``."""
    return step.lower(*args).compile()


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX ensemble train and eval steps, compiled in two threads while
    the port's side runs (XLA's compile releases the interpreter lock):
    {"train": (future, cfg, tx), "eval": (future, cfg)}."""
    mesh = jax_mesh()
    members = [jax_variables(HEADS, s, N_CLASS) for s in SEEDS]
    train_cfg = JaxPreprocessConfig(target_length=T, **AUG)
    eval_cfg = JaxPreprocessConfig(target_length=T)
    n = train_cfg.fbank.buffer_length(T)
    tx = jax_make_optimizer(lambda step: LR)
    place = NamedSharding(mesh, P("ensemble"))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        train = pool.submit(
            compiled, jax_ensemble.build_ensemble_train_step_single_rng(
                jax_model(), tx, train_cfg, "BCE", mesh, E),
            jax_train_state(members, tx, mesh), shard_batch(batches(n)[0], mesh),
            jax.random.PRNGKey(0))
        evaluate = pool.submit(
            compiled, jax_ensemble.build_ensemble_eval_step(
                jax_model(), eval_cfg, "BCE", mesh, E),
            jax.device_put(stacked([v["params"] for v in members]), place),
            jax.device_put(stacked([v["batch_stats"] for v in members]), place),
            shard_batch(tone_batch(50, n), mesh))
        yield {"train": (train, train_cfg, tx), "eval": (evaluate, eval_cfg)}


@pytest.fixture
def count_logmels(monkeypatch):
    """The number of log-mel computations (the fbank's launches on the card)."""
    calls = []
    logmel = pipeline._logmel

    def counted(*args, **kwargs):
        calls.append(1)
        return logmel(*args, **kwargs)

    monkeypatch.setattr(pipeline, "_logmel", counted)
    return calls


def test_ensemble_train_step_matches_jax(jax_steps, count_logmels):
    future, jax_cfg, tx = jax_steps["train"]
    cfg = PreprocessConfig(target_length=T, **AUG)
    data = batches(cfg.fbank.buffer_length(T))
    rng = jax.random.PRNGKey(42)

    state = port_state()
    step = ensemble.make_ensemble_train_step(cfg)
    losses = []
    for i in range(N_STEPS):
        draws = [TrainDraws(jax_preprocess_draws(
            jax.random.split(jax.random.fold_in(jax.random.fold_in(rng, j), i))[0], B, T, F),
            None) for j in range(E)]
        before = len(count_logmels)
        state, m = step(state, data[i % len(data)], draws)
        assert len(count_logmels) - before == E  # one fbank a member
        assert m["loss"].shape == () and m["seed_loss"].shape == (E,)
        torch.testing.assert_close(m["loss"], m["seed_loss"].mean(), rtol=0, atol=0)
        losses.append(m["seed_loss"].numpy())

    mesh = jax_mesh()
    jax_step = future.result()
    jstate = jax_train_state([jax_variables(HEADS, s, N_CLASS) for s in SEEDS], tx, mesh)
    jax_losses = []
    for i in range(N_STEPS):
        jstate, m = jax_step(jstate, shard_batch(data[i % len(data)], mesh), rng)
        np.testing.assert_allclose(float(m["loss"]), np.mean(m["seed_loss"]), rtol=1e-6)
        jax_losses.append(np.asarray(m["seed_loss"]))
    jax_losses, losses = np.stack(jax_losses), np.stack(losses)  # [steps, E]
    diffs = np.abs(jax_losses - losses)
    assert diffs[0].max() < 1e-4, (jax_losses[0], losses[0])
    assert diffs.max() < 2e-2, (jax_losses, losses)
    assert state.step == N_STEPS and all(mb.step == N_STEPS for mb in state.members)
    assert np.abs(losses[:, 0] - losses[:, 1]).min() > 1e-4  # the seeds differ
    p0, p1 = (dict(mb.model.named_parameters()) for mb in state.members)
    assert max(float((p0[k] - p1[k]).detach().abs().max()) for k in p0) > 1e-3


def test_ensemble_eval_step_matches_jax(jax_steps, count_logmels):
    future, jax_cfg = jax_steps["eval"]
    cfg = PreprocessConfig(target_length=T)
    batch = tone_batch(50, cfg.fbank.buffer_length(T))
    got, got_loss = ensemble.make_ensemble_eval_step(cfg)(port_state(), batch)

    members = [jax_variables(HEADS, s, N_CLASS) for s in SEEDS]
    mesh = jax_mesh()
    place = NamedSharding(mesh, P("ensemble"))
    want, want_loss = future.result()(
        jax.device_put(stacked([v["params"] for v in members]), place),
        jax.device_put(stacked([v["batch_stats"] for v in members]), place),
        shard_batch(batch, mesh))
    assert len(count_logmels) == 1  # one fbank for all members
    assert got.shape == (E, B, N_CLASS) and got_loss.shape == (E, B)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_loss.numpy(), np.asarray(want_loss), atol=1e-5, rtol=0)
    assert float((got[0] - got[1]).abs().max()) > 1e-3  # two models, not one twice
