"""The port's ``Trainer`` against the JAX package's, on the CPU.

Both train B0 with one head on the same synthetic tone corpus
(tests/synth.build_corpus: 4 classes, 16 one-second clips, batch 8, T=128,
2 steps an epoch) for 3 epochs with the same ``ExperimentConfig`` values,
from the same ``pretrained_ckpt``: numpy-made variables
(tests/torch_port_fixtures.py) in the reference key layout, which both
packages load. Mixup and SpecAugment are off, and drop-connect is off on
both sides (switched off here, as tests/test_torch_train_step.py does:
flax draws its masks per module path, which the port does not rebuild).

Bars, tests/test_torch_twin.py's (157-158, 248-249): the epoch-1 train loss
1e-4 (a mean over 2 steps whose first agrees to ~1e-6; both packages take
their float32 'fft' fbank lowering on the CPU, which differ by up to
~1.3e-3 on near-silent log-mel bands), and 2e-2 over the run for the loss
columns and the predictions (Adam's sqrt(v) grows reduction-order noise).
The learning rate is the audioset_full preset's, 1e-4: Adam's first update
moves each parameter by about lr x sign(g), so where the two packages'
gradients differ in sign the runs part by 2 lr; at 5e-3 the third step's
losses already differ by ~2e-2 (at 1e-4, by ~1e-5).
A port checkpoint read back by the JAX converter gives the JAX eval
forward within 2e-5 (tests/test_torch_model.py's B0 bar). The exact resume
is tests/test_torch_cli.py's, through ``--resume``.
"""

import concurrent.futures
import functools
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psla_tpu.config import ExperimentConfig as JaxExperimentConfig
from psla_tpu.data import AudioLoader as JaxAudioLoader
from psla_tpu.data import LoaderConfig as JaxLoaderConfig
from psla_tpu.data import load_datafile as jax_load_datafile
from psla_tpu.models import EffNetAttention as JaxEffNetAttention
from psla_tpu.models.convert import convert_effnet_attention
from psla_tpu.train import Trainer as JaxTrainer
from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.data.datafiles import load_datafile
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import CHECKPOINT_FILE, from_jax_variables
from psla_tpu_torch.frontend.pipeline import preprocess_eval
from psla_tpu_torch.train.loop import Trainer
from psla_tpu_torch.train.step import _wav_batch
from tests.synth import build_corpus
from tests.torch_port_fixtures import jax_variables, tmp_path  # noqa: F401

torch.set_num_threads(2)

N_CLASS, HEADS, T, B = 4, 1, 128, 8
CONFIG = dict(
    n_class=N_CLASS, model="efficientnet", eff_b=0, att_head=HEADS, target_length=T,
    freqm=0, timem=0, mixup=0.0, lr=1e-4, batch_size=B, n_epochs=3, warmup=False,
    bn_momentum=0.3, lrscheduler_start=100, wa=True, wa_start=2, wa_end=3, num_workers=2,
    n_print_steps=1000, bal=False, seed=0, impretrain=False, num_devices=1,
)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    datafile, label_csv = build_corpus(str(root), num_classes=N_CLASS, clips_per_class=4,
                                       seconds=1.0, multi_label_frac=0.0)
    ckpt = str(root / "start.pth")
    torch.save(from_jax_variables(jax_variables(HEADS, 41, N_CLASS), N_CLASS), ckpt)
    return datafile, label_csv, ckpt


def _loaders(loader_cls, config_cls, df, cfg):
    buf = cfg.preprocess_config().fbank.buffer_length(cfg.target_length)
    train = loader_cls(df, config_cls(batch_size=cfg.batch_size, buffer_samples=buf,
                                      num_workers=2, mixup=cfg.mixup > 0, seed=cfg.seed,
                                      wire=cfg.wire))
    val = loader_cls(df, config_cls(batch_size=cfg.batch_size, buffer_samples=buf,
                                    num_workers=2, drop_remainder=False, wire=cfg.wire),
                     shuffle=False)
    return train, val


def _no_drop_connect(trainer: Trainer) -> Trainer:
    new_model = trainer._new_model

    def model_without_drop_connect():
        m = new_model()
        for block in m.effnet._blocks:
            block.drop_rate = 0.0
        return m

    trainer._new_model = model_without_drop_connect
    return trainer


def port_trainer(corpus, exp_dir, **overrides) -> Trainer:
    datafile, label_csv, ckpt = corpus
    cfg = ExperimentConfig(**{**CONFIG, "data_train": datafile, "data_val": datafile,
                              "label_csv": label_csv, "exp_dir": exp_dir,
                              "pretrained_ckpt": ckpt, **overrides})
    train, val = _loaders(AudioLoader, LoaderConfig, load_datafile(datafile, label_csv), cfg)
    return Trainer(cfg, train, val, device="cpu")


@pytest.fixture(scope="module")
def twins(corpus, tmp_path_factory):
    """3 epochs of each package's trainer, the JAX one in a thread while the
    port's trains (XLA and torch release the interpreter lock): (port
    trainer, its state, its exp_dir, the JAX exp_dir), removed after the
    module's tests."""
    datafile, label_csv, ckpt = corpus
    jax_dir = str(tmp_path_factory.mktemp("exp_jax"))
    cfg = JaxExperimentConfig(**{**CONFIG, "data_train": datafile, "data_val": datafile,
                                 "label_csv": label_csv, "exp_dir": jax_dir,
                                 "pretrained_ckpt": ckpt})
    train, val = _loaders(JaxAudioLoader, JaxLoaderConfig,
                          jax_load_datafile(datafile, label_csv), cfg)
    jax_trainer = JaxTrainer(cfg, train, val)
    jax_trainer.model = _ShapeInit(label_dim=N_CLASS, b=0, head_num=HEADS,
                                   bn_momentum=cfg.bn_momentum, drop_connect_rate=0.0)
    jax_trainer._build_steps()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_run = pool.submit(jax_trainer.train)
        port_dir = str(tmp_path_factory.mktemp("exp_port"))
        trainer = _no_drop_connect(port_trainer(corpus, port_dir))
        state = trainer.train()
        jax_run.result()
    yield trainer, state, port_dir, jax_dir
    for d in (port_dir, jax_dir):
        shutil.rmtree(d, ignore_errors=True)


class _ShapeInit(JaxEffNetAttention):
    """The JAX model whose ``init`` returns zeros of the variables' shapes:
    the JAX trainer replaces every value with the ``pretrained_ckpt``'s
    (``Trainer._load_pretrained``), and flax's eager init of B0 takes ~30 s
    on the CPU."""

    def init(self, rngs, *args, **kwargs):
        shapes = jax.eval_shape(functools.partial(super().init, **kwargs), rngs, *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


def _csv(exp_dir, *path):
    return np.loadtxt(os.path.join(exp_dir, *path), delimiter=",")


def test_trainer_matches_the_jax_trainer(twins):
    _, state, port_dir, jax_dir = twins
    got, want = _csv(port_dir, "result.csv"), _csv(jax_dir, "result.csv")
    assert got.shape == want.shape == (3, 10)
    # d' is inf where the AUC reaches 1, on both sides alike
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert np.all(np.isfinite(np.delete(got, 4, axis=1)))
    assert abs(got[0, 5] - want[0, 5]) < 1e-4, (got[0, 5], want[0, 5])
    np.testing.assert_allclose(got[:, 5:7], want[:, 5:7], rtol=0, atol=2e-2)
    np.testing.assert_allclose(got[:, 9], want[:, 9], rtol=1e-6)  # the learning rates
    assert got[-1, 5] < got[0, 5]  # it learns
    for name in ("predictions_3.csv", "ensemble_predictions.csv", "predictions_wa.csv",
                 "target.csv"):
        a, b = _csv(port_dir, "predictions", name), _csv(jax_dir, "predictions", name)
        assert a.shape == b.shape == (16, N_CLASS), name
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-2, err_msg=name)
    assert state.step == 6


def test_artifacts_written(twins):
    _, _, exp_dir, _ = twins
    pred = os.path.join(exp_dir, "predictions")
    # the running ensemble deleted the epoch-1 and -2 prediction CSVs
    assert not os.path.exists(os.path.join(pred, "predictions_1.csv"))
    assert os.path.exists(os.path.join(pred, "predictions_3.csv"))
    with open(os.path.join(pred, "ensemble_predictions.csv")) as f:
        assert f.readline().strip() == "# epoch=3"
    for tag in ("epoch_1", "epoch_2", "epoch_3", "best", "wa"):
        assert os.path.isfile(os.path.join(exp_dir, "models", tag, CHECKPOINT_FILE)), tag
    for name in ("wa_result.csv", "stats_3.pickle", "progress.json", "config.json"):
        assert os.path.exists(os.path.join(exp_dir, name)), name
    ckpt = torch.load(os.path.join(exp_dir, "models", "epoch_3", CHECKPOINT_FILE),
                      weights_only=True)
    assert ckpt["step"] == 6 and ckpt["optimizer"]["state"]
    # the config.json keys are the JAX package's and AST's milestone step
    assert sorted(ExperimentConfig.load(os.path.join(exp_dir, "config.json")).__dict__) == \
        sorted([*JaxExperimentConfig().__dict__, "lrscheduler_step"])


def test_checkpoint_reads_back_through_the_jax_converter(twins):
    """The wa checkpoint's state_dict is in the reference layout: the JAX
    package's converter reads it, and its eval forward agrees on the
    corpus's log-mels."""
    trainer, _, exp_dir, _ = twins
    sd = torch.load(os.path.join(exp_dir, "models", "wa", CHECKPOINT_FILE),
                    weights_only=True)["model"]
    variables = convert_effnet_attention(sd, N_CLASS)
    trainer.val_loader.set_epoch(1)
    batch = _wav_batch(next(iter(trainer.val_loader)), torch.device("cpu"))
    x = preprocess_eval(batch, trainer.pre_config.eval_variant())
    jax_model = JaxEffNetAttention(label_dim=N_CLASS, b=0, head_num=HEADS)
    want = jax.jit(functools.partial(jax_model.apply, train=False))(
        variables, jnp.asarray(x.numpy()))
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=HEADS)
    model.load_state_dict(sd)
    with torch.inference_mode():
        got = model(x).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)
    assert np.ptp(got, axis=0).max() > 1e-2  # the output depends on the input


def test_weight_average_divides_by_the_true_count(twins, corpus, tmp_path):
    _, _, exp_dir, _ = twins

    def model_sd(tag, root=exp_dir):
        return torch.load(os.path.join(root, "models", tag, CHECKPOINT_FILE),
                          weights_only=True)["model"]

    e1, e2, e3 = (model_sd(f"epoch_{e}") for e in (1, 2, 3))
    wa = model_sd("wa")
    for k in wa:
        torch.testing.assert_close(wa[k], (e2[k] + e3[k]) / 2, rtol=0, atol=0)
    # save_model=False: the average of 1..3 over 3 (not 4), then the epoch
    # checkpoints are gone, and a resume of the finished run loads 'wa'
    copy_dir = str(tmp_path / "exp")
    shutil.copytree(exp_dir, copy_dir)
    t = _no_drop_connect(port_trainer(corpus, copy_dir, save_model=False))
    state = t.weight_average(1, 3)
    wa3 = model_sd("wa", copy_dir)
    for k in wa3:
        torch.testing.assert_close(wa3[k], (e1[k] + e2[k] + e3[k]) / 3, rtol=0, atol=0)
        torch.testing.assert_close(state.model.state_dict()[k], wa3[k], rtol=0, atol=0)
    assert state.step == 0
    for e in (1, 2, 3):
        assert not os.path.exists(os.path.join(copy_dir, "models", f"epoch_{e}"))
    resumed = t.train(resume=True)
    assert resumed.step == 0  # the 'wa' state: nothing trained
    t.config.n_epochs = 4  # not finished: the missing epoch_3 cannot be resumed
    with pytest.raises(FileNotFoundError, match="save_model"):
        t.train(resume=True)


AUGMENTED = dict(mixup=0.5, freqm=24, timem=24, wa=False)


def test_step_draws_depend_on_seed_and_step_only(corpus, tmp_path):
    t = port_trainer(corpus, str(tmp_path / "d"), **AUGMENTED)
    t.model = t._new_model()
    d1, d2, d3 = t.draws(5, B), t.draws(5, B), t.draws(6, B)
    torch.testing.assert_close(d1.pre.mixup.lam, d2.pre.mixup.lam, rtol=0, atol=0)
    torch.testing.assert_close(d1.keep, d2.keep, rtol=0, atol=0)
    assert not torch.equal(d1.pre.mixup.lam, d3.pre.mixup.lam)


def _poison_step(trainer: Trainer, nan_at_call: int):
    """NaN the loss of one step only: later losses stay finite, so an abort
    can only come from the divergence flag kept on the device."""
    orig = trainer.train_step
    calls = {"n": 0}

    def poisoned(state, batch, draws):
        state, metrics = orig(state, batch, draws)
        calls["n"] += 1
        if calls["n"] == nan_at_call:
            metrics = dict(metrics, loss=metrics["loss"] * float("nan"))
        return state, metrics

    trainer.train_step = poisoned


@pytest.mark.parametrize("print_steps,nan_at,steps_run", [
    (2, 1, 2),  # within the print window: abort at the next print step
    (1000, 4, 4),  # the last step of the epoch: the epoch-end backstop
])
def test_nan_aborts(corpus, tmp_path, capsys, print_steps, nan_at, steps_run):
    """At batch 4, 4 steps an epoch: the print step 2 ends before the
    epoch does, so only the flag on the card can stop it there."""
    exp_dir = str(tmp_path / "nan")
    t = port_trainer(corpus, exp_dir, n_print_steps=print_steps, batch_size=4)
    _poison_step(t, nan_at)
    state = t.train()
    assert "training diverged..." in capsys.readouterr().out
    assert state.step == steps_run
    assert not os.path.exists(os.path.join(exp_dir, "stats_1.pickle"))


def test_validate_ensemble_replay_is_idempotent(tmp_path):
    """A replayed epoch's validate_ensemble (a crash between the fold and
    progress.json) does not fold that epoch in again; the running mean is
    the JAX package's."""
    pred_dir = tmp_path / "predictions"
    pred_dir.mkdir()
    target = np.tile([[1.0, 0.0, 1.0], [0.0, 1.0, 0.0]], (4, 1))
    np.savetxt(pred_dir / "target.csv", target, delimiter=",")
    stub = SimpleNamespace(exp_dir=str(tmp_path),
                           _ensemble_folded_epoch=Trainer._ensemble_folded_epoch)
    rng = np.random.RandomState(0)
    p = [rng.rand(8, 3) for _ in range(3)]
    np.savetxt(pred_dir / "predictions_1.csv", p[0], delimiter=",")
    Trainer.validate_ensemble(stub, 1)
    np.savetxt(pred_dir / "predictions_2.csv", p[1], delimiter=",")
    Trainer.validate_ensemble(stub, 2)
    ens_path = pred_dir / "ensemble_predictions.csv"
    want = np.loadtxt(ens_path, delimiter=",")
    np.testing.assert_allclose(want, (p[0] + p[1]) / 2, rtol=1e-6)
    stats = Trainer.validate_ensemble(stub, 2)  # the replay
    np.testing.assert_array_equal(np.loadtxt(ens_path, delimiter=","), want)
    assert np.isfinite(np.mean([s["AP"] for s in stats]))
    np.savetxt(pred_dir / "predictions_3.csv", p[2], delimiter=",")
    Trainer.validate_ensemble(stub, 3)
    got3 = np.loadtxt(ens_path, delimiter=",")
    np.testing.assert_allclose(got3, (p[0] + p[1] + p[2]) / 3, rtol=1e-6)
    # the JAX package's fold of the same files gives the same bytes
    jax_dir = tmp_path / "jax"
    shutil.copytree(pred_dir, jax_dir / "predictions")
    os.remove(jax_dir / "predictions" / "ensemble_predictions.csv")
    np.savetxt(jax_dir / "predictions" / "predictions_1.csv", p[0], delimiter=",")
    np.savetxt(jax_dir / "predictions" / "predictions_2.csv", p[1], delimiter=",")
    jstub = SimpleNamespace(exp_dir=str(jax_dir),
                            _ensemble_folded_epoch=JaxTrainer._ensemble_folded_epoch)
    for e in (1, 2, 3):
        JaxTrainer.validate_ensemble(jstub, e)
    assert open(ens_path).read() == open(jax_dir / "predictions" /
                                          "ensemble_predictions.csv").read()


def test_backbone_only_checkpoint_is_refused(corpus, tmp_path):
    """A backbone-only checkpoint that fits loads as the backbone with the
    fresh pooling head (models/convert.convert_imagenet_backbone, the
    ImageNet path); one that lacks part of the backbone is refused, so no
    backbone entry keeps its random initialisation."""
    sd = torch.load(corpus[2], weights_only=True)
    path = str(tmp_path / "backbone.pth")
    torch.save({k: v for k, v in sd.items() if not k.startswith("attention.")}, path)
    t = port_trainer(corpus, str(tmp_path / "bb"), pretrained_ckpt=path)
    got = t.init_state().model.state_dict()
    fresh = t._new_model().state_dict()
    for k, v in got.items():
        assert torch.equal(v, fresh[k] if k.startswith("attention.") else sd[k]), k
    torch.save({k: v for k, v in sd.items()
                if not k.startswith(("attention.", "effnet._blocks.3."))}, path)
    with pytest.raises(ValueError, match="does not fit"):
        port_trainer(corpus, str(tmp_path / "bb2"), pretrained_ckpt=path).init_state()
