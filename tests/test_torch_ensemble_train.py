"""``psla-torch-train --ensemble-seeds 2`` on the CPU (``cli.run`` ->
``train/ensemble_loop.EnsembleTrainer``), mirroring the JAX package's
tests/test_ensemble_train.py: the protocol's summary, the per-seed
artifacts, the seed-mean predictions, the per-seed checkpoints read by
``tools/ensemble``, the stacked checkpoint refused by ``load_variables``,
the pretrained overlay (heads per seed, backbone shared),
``seed_result.csv`` read alike by both packages' ``watch``, and a 2-epoch
run resumed to 3 equal at atol 0 to an uninterrupted 3-epoch run.

Size: B0, one head, T=64, 4 classes, batch 8, on tests/synth.build_corpus
(16 half-second tone clips: 2 steps an epoch), mixup 0.5 and SpecAugment,
drop-connect on.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from psla_tpu.tools import watch as jax_watch
from psla_tpu_torch import cli
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import CHECKPOINT_FILE, load_variables
from psla_tpu_torch.tools import watch
from psla_tpu_torch.tools.ensemble import ensemble_eval
from psla_tpu_torch.train.ensemble_loop import HEAD_KEYS, EnsembleTrainer
from tests.synth import build_corpus
from tests.torch_port_fixtures import tmp_path  # noqa: F401

torch.set_num_threads(2)

E, N_CLASS = 2, 4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("enscorpus")
    return build_corpus(str(root), num_classes=N_CLASS, clips_per_class=4, seconds=0.5,
                        multi_label_frac=0.0)


def argv(corpus, exp_dir, *extra) -> list[str]:
    datafile, label_csv = corpus
    return ["--data-train", datafile, "--data-val", datafile, "--label-csv", label_csv,
            "--exp-dir", exp_dir, "--n_class", str(N_CLASS), "--eff_b", "0",
            "--att_head", "1", "--impretrain", "False", "--target_length", "64",
            "--freqm", "8", "--timem", "8", "--mixup", "0.5", "--lr", "2e-3", "-b", "8",
            "--warmup", "False", "--bn-momentum", "0.5", "--bal", "False", "-w", "2",
            "--ensemble-seeds", str(E), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def ens_run(corpus, tmp_path_factory):
    """2 epochs, weight averaging over both, the protocol on an eval set;
    removed after the module's tests."""
    exp = str(tmp_path_factory.mktemp("ensexp"))
    summary = cli.run(argv(corpus, exp, "--n-epochs", "2", "--wa_start", "1", "--wa_end",
                           "2", "--data-eval", corpus[0]))
    yield summary, exp
    shutil.rmtree(exp, ignore_errors=True)


def read(path: str) -> np.ndarray:
    return np.loadtxt(path, delimiter=",")


def test_summary_and_protocol(ens_run):
    summary, exp = ens_run
    assert set(summary) == {"best_single", "wa", "ensemble"}
    for part in summary.values():
        assert set(part) == {"val_mAP", "val_mAUC", "eval_mAP", "eval_mAUC"}
        assert all(np.isfinite(v) for v in part.values())
    for name in ("result.csv", "best_single_result.csv", "wa_result.csv",
                 "ensemble_result.csv", "seed_result.csv"):
        assert os.path.exists(os.path.join(exp, name)), name
    assert read(os.path.join(exp, "result.csv")).shape == (2, 10)


def test_per_seed_artifacts(ens_run):
    """The latest epoch's member matrices only; stacked checkpoints under
    every tag, single-model extracts for 'best' and 'wa'."""
    _, exp = ens_run
    pred = os.path.join(exp, "predictions")
    for i in range(E):
        assert read(os.path.join(pred, f"predictions_2_seed{i}.csv")).shape == (16, N_CLASS)
        assert not os.path.exists(os.path.join(pred, f"predictions_1_seed{i}.csv"))
        assert os.path.exists(os.path.join(pred, f"predictions_eval_2_seed{i}.csv"))
    fresh = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=1).state_dict()
    for tag in ("epoch_1", "epoch_2", "best", "wa"):
        ckpt = torch.load(os.path.join(exp, "models", tag, CHECKPOINT_FILE),
                          weights_only=True)
        assert ckpt["seeds"] == E and len(ckpt["optimizer"]) == E, tag
        assert ckpt["step"] == {"epoch_1": 2, "epoch_2": 4, "wa": 0}.get(tag, ckpt["step"])
        assert {k: tuple(v.shape) for k, v in ckpt["model"].items()} == \
            {k: (E, *v.shape) for k, v in fresh.items()}, tag
    for tag in ("best", "wa"):
        stacked = torch.load(os.path.join(exp, "models", tag, CHECKPOINT_FILE),
                             weights_only=True)["model"]
        for i in range(E):
            one = torch.load(os.path.join(exp, "models", f"{tag}_seed{i}", CHECKPOINT_FILE),
                             weights_only=True)
            assert set(one) == {"step", "model", "optimizer"}
            for k, v in one["model"].items():
                torch.testing.assert_close(v, stacked[k][i], rtol=0, atol=0, msg=k)
    assert not os.path.isdir(os.path.join(exp, "models", "epoch_1_seed0"))


def test_load_variables_refuses_the_stacked_checkpoint(ens_run):
    _, exp = ens_run
    with pytest.raises(ValueError, match="best_seed0 .. best_seed1"):
        load_variables(os.path.join(exp, "models", "best"))
    assert set(load_variables(os.path.join(exp, "models", "best_seed1"))) == set(
        create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=1).state_dict())


def test_seed_mean_and_ensemble_map(ens_run):
    _, exp = ens_run
    pred = os.path.join(exp, "predictions")
    p0, p1 = (read(os.path.join(pred, f"predictions_2_seed{i}.csv")) for i in range(E))
    np.testing.assert_allclose(read(os.path.join(pred, "predictions_2.csv")), (p0 + p1) / 2,
                               atol=1e-7, rtol=0)
    assert np.abs(p0 - p1).max() > 1e-4  # two models
    rows = {r.split(",")[0]: r.strip().split(",") for r in
            open(os.path.join(exp, "seed_result.csv")) if r.strip()}
    assert list(rows)[:2] == ["1", "2"] and len(rows) == 9  # epochs, then the tags
    assert set(rows) >= {"wa", "best_single_valid_set", "best_single_eval_set",
                         "wa_valid_set", "wa_eval_set", "eval_1", "eval_2"}
    m0, m1, ens = map(float, rows["2"][1:])
    assert ens >= min(m0, m1) - 1e-6
    result = read(os.path.join(exp, "result.csv"))
    assert abs(result[1, 0] - ens) < 1e-6  # result.csv's mAP is the seed mean's


def test_member_checkpoints_read_by_the_ensemble_tool(ens_run, corpus):
    """``tools/ensemble.ensemble_eval`` on best_seed0 and best_seed1 gives
    the members' predictions the protocol wrote for the best epoch."""
    _, exp = ens_run
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv(corpus, exp)))
    _, val_loader, _ = cli.make_loaders(cfg)
    out = os.path.join(exp, "ensemble_tool")
    res = ensemble_eval([os.path.join(exp, "models", f"best_seed{i}") for i in range(E)],
                        val_loader, cfg.preprocess_config(), n_class=N_CLASS, eff_b=0,
                        out_dir=out, device="cpu", att_head=1)
    assert np.isfinite(res["ensemble"]["mAP"])
    pred = os.path.join(exp, "predictions")
    for i in range(E):
        np.testing.assert_allclose(
            read(os.path.join(out, f"predictions_{i}.csv")),
            read(os.path.join(pred, f"predictions_best_single_valid_set_seed{i}.csv")),
            atol=1e-6, rtol=0)


def test_seed_result_read_alike_by_both_watch_tools(ens_run):
    _, exp = ens_run
    ours, theirs = watch.read_state(exp), jax_watch.read_state(exp)
    assert ours["seed_rows"] == theirs["seed_rows"] and len(ours["seed_rows"]) == 9
    assert ours["config"]["ensemble_seeds"] == E
    assert watch.render(ours) == jax_watch.render(theirs)


@pytest.mark.parametrize("model", ["efficientnet", "resnet", "mbnet"])
def test_pretrained_overlay_keeps_heads_per_seed(corpus, tmp_path, model):
    """A full checkpoint of each family: every member takes its backbone
    and keeps its own fresh head (its init from seed + i): the pooling
    heads, MBNet's classifier."""
    donor = create_model(model, label_dim=N_CLASS, eff_b=0, head_num=1,
                         generator=torch.Generator().manual_seed(99)).state_dict()
    path = str(tmp_path / "full.pth")
    torch.save(donor, path)
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv(corpus, str(tmp_path / "exp"), "--model", model, "--pretrained-ckpt", path)))
    train_loader, val_loader, _ = cli.make_loaders(cfg)
    trainer = EnsembleTrainer(cfg, train_loader, val_loader, device="cpu")
    state = trainer.init_state()
    heads = [k for k in donor if k.startswith(HEAD_KEYS)]
    assert heads and len(heads) < len(donor)
    for i, member in enumerate(state.members):
        got = member.model.state_dict()
        fresh = trainer._new_model(cfg.seed + i).state_dict()
        for k, v in donor.items():
            want = fresh[k] if k in heads else v
            torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=f"{i} {k}")
    h0, h1 = (m.model.state_dict()[heads[0]] for m in state.members)
    assert not torch.equal(h0, h1)


def test_refuses_one_seed(corpus, tmp_path):
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        argv(corpus, str(tmp_path / "exp"), "--ensemble-seeds", "1")))
    with pytest.raises(ValueError, match="ensemble_seeds >= 2"):
        EnsembleTrainer(cfg, *cli.make_loaders(cfg)[:2], device="cpu")


def test_resume_reproduces_the_uninterrupted_run_exactly(ens_run, corpus, tmp_path):
    """The module's 2-epoch run resumed to 3 epochs equals a 3-epoch run bit
    for bit (atol 0): the stacked checkpoint restores every member's model,
    Adam and step, each member's draws come from (seed, step, member), the
    sampling is keyed by epoch, and seed_result.csv keeps its rows."""
    _, exp = ens_run
    resumed, straight = str(tmp_path / "resumed"), str(tmp_path / "straight")
    shutil.copytree(exp, resumed)
    assert cli.main(argv(corpus, resumed, "--n-epochs", "3", "--wa", "False",
                         "--resume")) == 0
    assert cli.main(argv(corpus, straight, "--n-epochs", "3", "--wa", "False")) == 0
    a, b = (torch.load(os.path.join(d, "models", "epoch_3", CHECKPOINT_FILE),
                       weights_only=True) for d in (straight, resumed))
    assert a["step"] == b["step"] == 6
    for k, v in a["model"].items():
        torch.testing.assert_close(v, b["model"][k], rtol=0, atol=0, msg=k)
    for i in range(E):
        for j, st in a["optimizer"][i]["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(v, b["optimizer"][i]["state"][j][k], rtol=0,
                                           atol=0)
    np.testing.assert_array_equal(read(os.path.join(straight, "result.csv")),
                                  read(os.path.join(resumed, "result.csv")))
    rows = [open(os.path.join(d, "seed_result.csv")).read().splitlines() for d in
            (straight, resumed)]
    assert rows[1][:3] == rows[0][:3] and rows[0][2].startswith("3,")
    with open(os.path.join(resumed, "progress.json")) as f:
        assert json.load(f)["global_step"] == 6
