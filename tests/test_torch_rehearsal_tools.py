"""The port's rehearsal tools on the CPU: ``psla-torch-smoke`` (the single
run and the whole PSLA protocol loop) and ``psla-torch-flagship`` (its
corpora against the JAX tool's, its log parsing, and the kill-and-resume
machinery at the preflight shape).

Size: the tools' own toy shapes (EffNet-B0, T=64). Both train in bfloat16,
as the JAX tools do.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from psla_tpu.tools import flagship as jax_flagship
from psla_tpu_torch import cli
from psla_tpu_torch.tools import flagship, smoke
from tests.torch_port_fixtures import tmp_path  # noqa: F401

torch.set_num_threads(2)

ARTIFACTS = {"result.csv", "config.json", "progress.json", "wa_result.csv",
             "best_single_result.csv", "ensemble_result.csv", "models", "predictions"}


# -------------------------------------------------------------------- smoke


def test_smoke_run_writes_the_artifact_set(tmp_path):
    res = smoke.run(epochs=2, exp_root=str(tmp_path), device="cpu")
    exp = tmp_path / "exp"
    assert ARTIFACTS <= set(os.listdir(exp))
    for key in ("best_single", "wa", "ensemble"):
        assert np.isfinite(res["summary"][key]["eval_mAP"])
    with open(exp / "config.json") as f:
        cfg = json.load(f)
    assert (cfg["dtype"], cfg["eff_b"], cfg["target_length"]) == ("bfloat16", 0, 64)
    for name in ("epoch_1", "epoch_2", "best", "wa"):
        assert (exp / "models" / name / "checkpoint.pth").exists(), name


def test_smoke_passes_its_flags_to_cli_run(tmp_path, monkeypatch):
    """smoke.run calls the library entry (cli.run, which returns the
    summary) with a corpus, from scratch, in bfloat16, on the given device."""
    calls = {}

    def fake_run(argv):
        calls["argv"] = argv
        exp = argv[argv.index("--exp-dir") + 1]
        for d in ("models", "predictions"):
            os.makedirs(os.path.join(exp, d))
        for f in ARTIFACTS - {"models", "predictions"}:
            open(os.path.join(exp, f), "w").write("0\n")
        return {k: {"eval_mAP": 0.9} for k in ("best_single", "wa", "ensemble")}

    monkeypatch.setattr(cli, "run", fake_run)
    res = smoke.run(epochs=2, exp_root=str(tmp_path), device="cuda:1")
    argv = calls["argv"]
    assert res["summary"]["wa"]["eval_mAP"] == 0.9
    assert argv[argv.index("--dtype") + 1] == "bfloat16"
    assert argv[argv.index("--device") + 1] == "cuda:1"
    assert argv[argv.index("--impretrain") + 1] == "False"
    assert "--data-train" in argv


def test_run_protocol_chains_the_psla_loop(tmp_path):
    """Round 1, the train-set predictions, the enhancement with its weight
    file, the retrain and its control: labels were added and changed the
    retrain's first-epoch loss."""
    res = smoke.run_protocol(epochs=1, exp_root=str(tmp_path), device="cpu")
    assert res["labels_added"] > 0
    assert res["retrain_loss"] != res["control_loss"]
    assert all(np.isfinite(p["eval_mAP"]) for p in res["summary"].values())
    for f in ("tr_type1_2_5.json", "tr_type1_2_5_weight.csv", "exp_round1/result.csv",
              "exp_round2/result.csv", "exp_round2_control/result.csv",
              "train_preds/predictions_0.csv"):
        assert (tmp_path / f).exists(), f


@pytest.mark.parametrize("protocol", [False, True], ids=["smoke", "protocol"])
def test_main_cli_names_the_device(tmp_path, monkeypatch, capsys, protocol):
    seen = {}

    def fake(*args, device):
        seen["device"] = device
        return {"summary": {"wa": {"eval_mAP": 0.5}}, "exp_dir": str(tmp_path / "gone")}

    os.makedirs(tmp_path / "gone")
    monkeypatch.setattr(smoke, "run_protocol" if protocol else "run", fake)
    assert smoke.main_cli(["--device", "cpu"] + (["--protocol"] if protocol else [])) == 0
    kind = "PROTOCOL" if protocol else "SMOKE"
    assert capsys.readouterr().out.startswith(f"{kind} OK on cpu: ")
    assert seen["device"] == "cpu"
    assert not (tmp_path / "gone").exists()  # removed without --keep


# ----------------------------------------------------------------- flagship

SYNTHETIC_LOG = """\
torch 2.11.0+cu128 on cuda (NVIDIA H100 80GB HBM3)
Epoch: [1][1/4]  per-sample total 0.01234  data 0.00012  dnn 0.01222  loss 0.6931
Epoch: [1][3/4]  per-sample total 0.00456  data 0.00010  dnn 0.00446  loss 0.6712
epoch 1 train loop: 4 steps in 2.345 s
epoch 1 training time: 3.000
Epoch: [2][1/4]  per-sample total 2.5e-03  data 1e-05  dnn 0.00249  loss 0.6500
torch 2.11.0+cu128 on cuda:1 (NVIDIA H100 80GB HBM3)
resumed from epoch 1
Epoch: [2][3/4]  per-sample total 0.00300  data 0.00002  dnn 0.00298  loss 0.6400
epoch 2 train loop: 4 steps in 1.6 s
"""


def test_meter_re_parses_a_synthetic_log():
    """The regex is the JAX tool's; the lines are the port's trainer's."""
    assert flagship._METER_RE.pattern == jax_flagship._METER_RE.pattern
    found = flagship._METER_RE.findall(SYNTHETIC_LOG)
    assert [(m[0], m[1], m[2]) for m in found] == [("1", "1", "4"), ("1", "3", "4"),
                                                   ("2", "1", "4"), ("2", "3", "4")]
    assert [float(m[3]) for m in found] == [0.01234, 0.00456, 2.5e-3, 0.003]
    assert [float(m[5]) for m in found] == [0.01222, 0.00446, 0.00249, 0.00298]
    assert flagship.child_device(SYNTHETIC_LOG) == {"device": "cuda:1",
                                                    "name": "NVIDIA H100 80GB HBM3"}
    assert flagship.child_device("") == {"device": "unknown", "name": "unknown"}
    assert flagship.epoch_rates(SYNTHETIC_LOG, 128) == {1: round(512 / 2.345, 1), 2: 320.0}


@pytest.mark.parametrize("learnable", [False, True], ids=["corpus", "learnable"])
def test_corpora_equal_jax(tmp_path, learnable):
    """The same seeded WAVs, datafiles and label CSV as the JAX tool's."""
    for name, tool in (("jax", jax_flagship), ("port", flagship)):
        if learnable:
            tool.make_learnable_corpus(str(tmp_path / name), 6, 3, n_class=3,
                                       target_length=64)
        else:
            tool.make_corpus(str(tmp_path / name), 4, 2, target_length=64)
    cmp = filecmp.dircmp(tmp_path / "jax", tmp_path / "port")
    assert not cmp.left_only and not cmp.right_only
    for sub in ("train", "val"):
        wavs = sorted(os.listdir(tmp_path / "jax" / sub))
        assert len(wavs) == (6 if sub == "train" else 3) * learnable + (
            (4 if sub == "train" else 2) * (not learnable))
        _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax" / sub, tmp_path / "port" / sub,
                                               wavs, shallow=False)
        assert not mismatch and not errors
    for sub in ("train", "val"):
        ours = json.load(open(tmp_path / "port" / f"{sub}.json"))["data"]
        theirs = json.load(open(tmp_path / "jax" / f"{sub}.json"))["data"]
        assert [e["labels"] for e in ours] == [e["labels"] for e in theirs]


def test_flagship_preflight_kills_and_resumes(tmp_path, monkeypatch):
    """The whole rehearsal at the preflight shape on the CPU: leg 1 killed
    at epoch 2's first print step, leg 2 resumed to the end, the summary
    parsed from the CLI subprocess's log. The CLI subprocesses take the test
    process's 2 threads (by default torch takes every core, which the other
    test workers share)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    res = flagship.run(clips=32, val_clips=16, epochs=3, batch_size=8, out=str(tmp_path),
                       preflight=True, n_print_steps=1, device="cpu",
                       step_clips_per_sec=123.0)
    assert res["device"] == {"device": "cpu", "name": "host CPU"}
    assert res["resume_completed_epochs"] == 3 and res["killed_mid_epoch"] == 2
    assert 1 <= res["resumed_from_epoch"] <= 2
    assert res["wa_checkpoint"] is True
    assert res["bare_step_clips_per_sec"] == 123.0
    assert sorted(res["epoch_clips_per_sec"]) == [1, 2, 3]
    assert res["sustained_clips_per_sec"] > 0 and 0 <= res["data_time_share"] <= 1
    assert res["shape"]["dtype"] == "bfloat16" and res["shape"]["model"] == "efficientnet-b0"
    with open(tmp_path / "exp" / "config.json") as f:
        cfg = json.load(f)
    assert (cfg["dtype"], cfg["compilation_cache"], cfg["eff_b"]) == ("bfloat16", "", 0)
    with open(res["log"]) as f:
        assert f.read().count("torch ") >= 2  # two legs
