"""The port's training pieces against the JAX package's: train-mode
BatchNorm and drop-connect, the train-mode forward, remat, the schedule,
Adam, the losses, the eval step, the int16 wire batch, and the train
package's isolation from JAX. (The train step against the JAX step is in
tests/test_torch_train_step.py.)

Weights are the shared numpy-made EffNetAttention(b=0) variables
(tests/torch_port_fixtures.py), carried into the port by
``from_jax_variables``; batches are made with numpy. Bars: BatchNorm 1e-6
(to the float64 layer, and to flax's plus flax's own rounding); the B0
train forward's probabilities 2e-5 and its batch statistics 1e-5 (float32
sums in another order through 16 blocks); Adam 1e-7 (plus one float32
spacing of the parameter); losses 1e-6; the eval step's probabilities
2e-5 and per-sample losses 1e-5; remat and the int16 batch exactly equal
to their counterparts.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.models import EffNetAttention as JaxEffNetAttention
from psla_tpu.models.layers import ReferenceBatchNorm
from psla_tpu.models.layers import drop_connect as jax_drop_connect
from psla_tpu.train import optim as jax_optim
from psla_tpu.train.state import TrainState as JaxTrainState
from psla_tpu.train.step import _per_sample_loss as jax_per_sample_loss
from psla_tpu.train.step import make_eval_step_fn as jax_make_eval_step_fn
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.models.layers import BN_EPS, BatchNorm, drop_connect
from psla_tpu_torch.train import optim
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_eval_step, build_train_step, draw_train
from tests.test_torch_augment import tone_batch
from tests.torch_port_fixtures import jax_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, F, N_CLASS = 4, 64, 128, 4
SEED = 8


def port_model(variables: dict, **kw):
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=4, **kw)
    model.load_state_dict(from_jax_variables(variables, N_CLASS))
    return model


def fbank_batch(seed: int = 0) -> np.ndarray:
    """Log-mel-like inputs: per-sample offsets, so the batch statistics are
    not those of a standard normal."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)) + rng.normal(0.0, 0.5, (B, 1, 1))
    return x.astype(np.float32)


def stats_of(model) -> dict:
    return {k: v for k, v in model.state_dict().items() if k.endswith(("running_mean",
                                                                       "running_var"))}


# ------------------------------------------------------------ layers


@pytest.mark.parametrize("shape", [(4, 8, 16, 24), (2, 2, 2, 40), (3, 5, 7, 8),
                                   (16, 32, 33, 8)])
def test_batchnorm_train_matches_reference_batchnorm(shape):
    """Batch statistics, the biased variance in the output, the unbiased
    one into running_var (n = B*H*W), momentum 0.99 flax = 0.01 torch.

    The port's output is held to the float64 BatchNorm at 1e-6, and to
    ReferenceBatchNorm at 1e-6 plus flax's own distance from the float64
    one: flax takes the variance as E[x^2] - E[x]^2 in float32, whose
    rounding passes 1e-6 on these inputs and grows with n; F.batch_norm
    subtracts the mean first (models/layers.py). The running statistics take 0.01
    of the batch's, and are held to ReferenceBatchNorm's at 1e-6. The input
    is contiguous NCHW, as the model's convolutions give it."""
    rng = np.random.default_rng(shape[1])
    c = shape[-1]
    x = (rng.normal(0.0, 0.5, c) + rng.uniform(0.5, 2.0, c)
         * rng.standard_normal(shape)).astype(np.float32)  # NHWC
    variables = {
        "params": {"scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                   "bias": rng.normal(0.0, 0.1, c).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0.0, 0.1, c).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, c).astype(np.float32)},
    }
    bn_jax = ReferenceBatchNorm(use_running_average=False, momentum=0.99, epsilon=BN_EPS)
    ref, mutated = bn_jax.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(c)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"])})
    bn.train()
    got = bn(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    got, ref = got.detach().numpy(), np.asarray(ref)
    x64 = x.astype(np.float64)
    exact = ((x64 - x64.mean((0, 1, 2))) / np.sqrt(x64.var((0, 1, 2)) + BN_EPS)
             * variables["params"]["scale"] + variables["params"]["bias"])
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=0)
    flax_own = float(np.abs(ref - exact).max())
    np.testing.assert_allclose(got, ref, atol=1e-6 + flax_own, rtol=0)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), atol=1e-6, rtol=0)


def test_batchnorm_replaying_leaves_the_statistics():
    bn = BatchNorm(3).train()
    x = torch.randn(2, 3, 4, 4, generator=torch.Generator().manual_seed(0))
    bn.replaying = True
    y = bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(3))
    assert torch.equal(bn.running_var, torch.ones(3))
    bn.replaying = False
    assert torch.equal(bn(x), y)
    assert not torch.equal(bn.running_mean, torch.zeros(3))


@pytest.mark.parametrize("rate", [0.2, 0.05, 0.5])
def test_drop_connect_with_a_shared_mask(rate):
    """The JAX function's own Bernoulli mask, handed to the port."""
    rng = np.random.default_rng(int(rate * 100))
    x = rng.standard_normal((16, 5, 6, 8)).astype(np.float32)
    key = jax.random.PRNGKey(int(rate * 100))
    ref = np.asarray(jax_drop_connect(jnp.asarray(x), key, rate, deterministic=False))
    keep = np.array(jax.random.bernoulli(key, 1.0 - rate, (16, 1, 1, 1))).reshape(16)
    got = drop_connect(torch.from_numpy(x), torch.from_numpy(keep), rate)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0 < keep.sum() < 16 or rate < 0.1


def test_blocks_drop_only_in_train_mode_and_only_with_a_skip():
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0)
    blocks = model.effnet._blocks
    drops = model.effnet.drop_blocks
    assert drops == [i for i, b in enumerate(blocks) if b.has_skip and i > 0]
    assert [blocks[i].drop_rate for i in drops] == pytest.approx(
        [0.2 * i / len(blocks) for i in drops])
    blk = blocks[drops[-1]]
    x = torch.randn(4, blk._project_conv.out_channels, 4, 2)
    none = torch.zeros(4, dtype=torch.bool)
    with torch.no_grad():
        blk.eval()
        assert torch.equal(blk(x, none), blk(x))
        blk.train()
        # every branch dropped: the block is its skip
        assert torch.equal(blk(x, none), x)


# ------------------------------------------------------------ forward


def test_train_forward_matches_jax():
    """model.apply(train=True, mutable=['batch_stats']) at B0: the
    probabilities and the updated batch statistics."""
    v = jax_variables(4, SEED, N_CLASS)
    x = fbank_batch()
    jax_model = JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=4, drop_connect_rate=0.0)
    ref, mutated = jax.jit(lambda v, x: jax_model.apply(
        v, x, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    model = port_model(v, drop_connect_rate=0.0).train()
    probs = model(torch.from_numpy(x))
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(ref), atol=2e-5, rtol=0)
    want = from_jax_variables({"params": v["params"],
                               "batch_stats": jax.tree.map(np.asarray, mutated["batch_stats"])},
                              N_CLASS)
    got = stats_of(model)
    assert got.keys() == stats_of(port_model(v)).keys() and len(got) == 2 * 49
    for k, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    # the statistics moved (batch statistics, not the running ones)
    assert any(not torch.equal(t, from_jax_variables(v, N_CLASS)[k]) for k, t in got.items())


def test_train_mode_switches_and_eval_forward_is_unchanged():
    v = jax_variables(4, SEED, N_CLASS)
    x = torch.from_numpy(fbank_batch(1))
    fresh = port_model(v)
    assert not fresh.training
    model = port_model(v)
    assert model.train() is model and model.training
    assert all(m.training for m in model.modules())
    with pytest.raises(ValueError, match="keep masks"):
        model(x)  # drop-connect 0.2: train mode needs the step's masks
    model.eval()
    with torch.inference_mode():
        assert torch.equal(model(x), fresh(x))


def _step_batch(seed: int, n: int) -> dict:
    bt = tone_batch(seed, n)
    bt["labels"] = np.eye(N_CLASS, dtype=np.float32)[np.arange(B) % N_CLASS]
    bt["mix_labels"] = np.roll(bt["labels"], 1, 0)
    return bt


def test_remat_gives_the_same_step():
    """Same draws (drop-connect 0.2 on): remat on and off give the same loss,
    gradients, parameters and running statistics after a step: the keep
    masks replay from the draws, and the recomputed forward does not fold
    its statistics in a second time."""
    v = jax_variables(4, SEED, N_CLASS)
    cfg = PreprocessConfig(target_length=T, time_mask=24)
    n = cfg.fbank.buffer_length(T)
    batch = _step_batch(2, n)
    step = build_train_step(cfg)
    results = []
    for remat in (False, True):
        model = port_model(v, remat=remat)
        state = create_train_state(model, lambda s: 1e-3, device="cpu")
        draws = draw_train(torch.Generator().manual_seed(3), model, B, cfg)
        assert draws.keep is not None and not draws.keep.all()
        state, metrics = step(state, batch, draws)
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        results.append((metrics["loss"], grads, copy.deepcopy(model.state_dict())))
    (l0, g0, s0), (l1, g1, s1) = results
    assert torch.equal(l0, l1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    assert any(not torch.equal(s0[k], from_jax_variables(v, N_CLASS)[k])
               for k in s0 if k.endswith("running_var"))


# ------------------------------------------------------------ optimizer


@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("steps_per_epoch", [37, 100, 250])
def test_lr_schedule_matches_jax(warmup, steps_per_epoch):
    """Steps 0-3000: the warmup staircase (0 for steps 0-49) and the decays.
    JAX computes in float32; the port in float64, so equal to float32
    rounding."""
    kw = dict(base_lr=1e-4, steps_per_epoch=steps_per_epoch, lrscheduler_start=2,
              lrscheduler_decay=0.5, warmup=warmup)
    ref = np.asarray(jax.jit(jax.vmap(jax_optim.psla_lr_schedule(**kw)))(
        jnp.arange(3001)))
    sched = optim.psla_lr_schedule(**kw)
    got = np.array([sched(s) for s in range(3001)])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    if warmup:
        assert (got[:50] == 0).all() and got[50] > 0
    assert len(set(got[1100:].tolist())) > 1  # decays happen in the range


def test_adam_update_matches_optax():
    """Two updates of torch Adam with L2 on every parameter against the JAX
    package's optax chain, on the same gradients: 1e-7 plus the float32
    spacing of the parameter (the two updates differ by ~1e-10 here, which
    can round the updated parameter one ulp apart)."""
    rng = np.random.default_rng(5)
    shapes = [(16, 8, 3, 3), (16,), (1,), (4, 527)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 1e-2 for s in shapes]
             for _ in range(2)]
    lrs = [1e-3, 5e-4]
    tx = jax_optim.make_optimizer(lambda step: jnp.asarray(lrs)[step])
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = optim.make_optimizer(ps)
    for step in range(2):
        updates, opt_state = tx.update([jnp.asarray(g) for g in grads[step]], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, g in zip(ps, grads[step]):
            p.grad = torch.from_numpy(g)
        optim.set_lr(opt, lrs[step])
        opt.step()
        for p, want in zip(ps, jp):
            want = np.asarray(want)
            err = np.abs(p.detach().numpy() - want)
            assert (err <= 1e-7 + np.spacing(np.abs(want))).all(), err.max()
    assert opt.param_groups[0]["weight_decay"] == jax_optim.WEIGHT_DECAY


def test_losses_match_jax():
    rng = np.random.default_rng(9)
    probs = rng.uniform(0.0, 1.0, (8, 12)).astype(np.float32)
    probs[0, :3] = [0.0, 1.0, 1e-9]  # the clamp
    soft = rng.uniform(0.0, 1.0, (8, 12)).astype(np.float32)
    p, t = torch.from_numpy(probs), torch.from_numpy(soft)
    for port_fn, jax_fn in ((optim.bce_loss, jax_optim.bce_loss),
                            (optim.ce_loss, jax_optim.ce_loss)):
        np.testing.assert_allclose(port_fn(p, t).numpy(),
                                   np.asarray(jax_fn(jnp.asarray(probs), jnp.asarray(soft))),
                                   atol=1e-6, rtol=0)
    for loss_type in ("BCE", "CE"):
        np.testing.assert_allclose(
            optim.per_sample_loss(p, t, loss_type).numpy(),
            np.asarray(jax_per_sample_loss(jnp.asarray(probs), jnp.asarray(soft), loss_type)),
            atol=1e-6, rtol=0)
    # the clamp, not F.binary_cross_entropy's -100 floor on the log
    assert float(optim.bce_loss(torch.tensor([0.0]), torch.tensor([1.0]))) == pytest.approx(
        -np.log(np.float32(1e-7)), rel=1e-6)


# ------------------------------------------------------------ steps


def test_eval_step_matches_jax():
    v = jax_variables(4, SEED, N_CLASS)
    jax_cfg = JaxPreprocessConfig(target_length=T)
    cfg = PreprocessConfig(target_length=T)
    n = cfg.fbank.buffer_length(T)
    batch = _step_batch(4, n)
    jax_model = JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=4)
    jax_state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                              batch_stats=v["batch_stats"], opt_state=None)
    ref_probs, ref_loss = jax.jit(jax_make_eval_step_fn(jax_model, jax_cfg))(jax_state, batch)
    state = create_train_state(port_model(v).train(), lambda s: 0.0, device="cpu")
    probs, loss = build_eval_step(cfg)(state, batch)
    assert not state.model.training
    np.testing.assert_allclose(probs.numpy(), np.asarray(ref_probs), atol=2e-5, rtol=0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ref_loss), atol=1e-5, rtol=0)
    assert float(np.ptp(np.asarray(ref_probs), axis=0).max()) > 1e-3  # input-dependent


def test_int16_batch_steps_as_its_float32_copy():
    """PCM16 wire waveforms dequantized by x 2^-15 give the step of their
    float32 copy, bit for bit."""
    cfg = PreprocessConfig(target_length=T, time_mask=24)
    n = cfg.fbank.buffer_length(T)
    rng = np.random.default_rng(12)
    pcm = (rng.standard_normal((B, n)) * 4000).astype(np.int16)
    f32 = pcm.astype(np.float32) * np.float32(2.0 ** -15)
    base = _step_batch(5, n)
    model = port_model(jax_variables(4, SEED, N_CLASS))
    out = []
    for wav in (pcm, f32):
        batch = dict(base, wav=wav, mix_wav=np.roll(wav, 1, 0),
                     wav_mean=f32.mean(1), mix_wav_mean=np.roll(f32.mean(1), 1))
        m = copy.deepcopy(model)
        state = create_train_state(m, lambda s: 1e-3, step=7, device="cpu")
        draws = draw_train(torch.Generator().manual_seed(1), m, B, cfg)
        state, metrics = build_train_step(cfg)(state, batch, draws)
        assert state.step == 8
        out.append((metrics["loss"], m.state_dict()))
    assert torch.equal(out[0][0], out[1][0])
    for k, t in out[0][1].items():
        assert torch.equal(t, out[1][1][k]), k


# ------------------------------------------------------------ isolation


def test_train_package_imports_nothing_of_jax():
    """The ast scan of tests/test_torch_serve.py walks the whole port, train/
    included; importing the train package loads no JAX module."""
    from tests.test_torch_serve import FORBIDDEN, _port_sources
    sources = [os.path.relpath(p, REPO) for p in _port_sources()]
    for name in ("optim", "state", "step"):
        assert os.path.join("psla_tpu_torch", "train", f"{name}.py") in sources
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import psla_tpu_torch.train.step, psla_tpu_torch.train.optim, "
        "psla_tpu_torch.train.state, psla_tpu_torch.frontend.augment\n"
        f"bad = sorted(m for m in set(sys.modules) - before "
        f"if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
