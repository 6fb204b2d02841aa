"""The harness: the manifest keeps the benchmark's contract, every cell's
files are found by name, a new cell needs only new files and an entry, the
result line has its keys, and ``run.py`` refuses to run without a card and
prints no result once JAX or the JAX package is loaded."""

import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.drivers import train

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"}}
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keeps_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "benchmark/run.py"] and m["paths"] == ["benchmark"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    for section, keys in KEYS.items():
        for e in m[section]:
            assert set(e) == keys and NAME.match(e["name"])
    for section, keys in METRIC_KEYS.items():
        for e in m[section]:
            assert keys <= set(e) <= keys | {"workloads"}, e["name"]
            assert NAME.match(e["name"]) and UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
    cells = {w["name"]: w for w in m["workloads"]}
    names = [e["name"] for s in ("configs", "workloads", "end_to_end", "per_layer")
             for e in m[s]]
    assert len(names) == len(set(names))
    e2e = {e["name"]: e for e in m["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    assert all(0.01 <= e["bound"] <= 0.25 for e in e2e.values())
    assert all(e["source"] in ("host_clock", "device_trace") for e in e2e.values())
    for e in m["per_layer"]:
        assert e["moves"] in e2e
        for w in e["workloads"]:
            assert w in e2e[e["moves"]].get("workloads", cells)
    assert sum(w["chips"] == 4 for w in m["workloads"]) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(m)) < 64 * 1024


@pytest.mark.parametrize("name", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_finds_its_files_by_name(name):
    c = harness.cell(name)
    assert c.chips == next(w["chips"] for w in manifest()["workloads"] if w["name"] == name)
    assert (ROOT / "benchmark/drivers" / f"{c.workload['driver']}.py").is_file()
    assert (ROOT / "benchmark/reference" / f"{c.config['family']}.py").is_file()
    assert {m["name"] for m in c.end_to_end} == {"setup_s", *c.workload["report"]}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_needs_only_its_files_and_an_entry(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = manifest()
    wl = json.loads((ROOT / "benchmark/workloads/audioset_full.train.json").read_text())
    wl["traffic"]["pool_batches"] = 4
    (tmp_path / "benchmark/workloads/audioset_full.train_short.json").write_text(json.dumps(wl))
    m["workloads"].append({"name": "audioset_full.train_short", "config": "audioset_full",
                           "traffic": "train_short", "chips": 1, "why": "a new mix"})
    for e in m["end_to_end"] + m["per_layer"]:
        if "audioset_full.train" in e.get("workloads", []):
            e["workloads"].append("audioset_full.train_short")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    c = harness.cell("audioset_full.train_short", root=tmp_path)
    assert c.workload["traffic"]["pool_batches"] == 4
    assert [e["name"] for e in c.per_layer] == [e["name"] for e in
                                               harness.cell("audioset_full.train").per_layer]


TINY = dict(eff_b=0, n_class=10, target_length=64, batch_size=4, freqm=8, timem=16)


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_has_its_keys(traced):
    c = harness.cell("audioset_full.train")
    c.config.update(TINY)
    c.workload["profile_steps"] = 1
    out = train.run(c, seed=2**31 + 11, seconds=1.0, traced=traced, t0=time.perf_counter(),
                    device="cpu")
    line = json.loads(json.dumps(harness.result(c, out, traced)))
    # the contract's keys; "compared", each number compared beside its
    # limit, comes last as the contract asks
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == want + (["breakdown"] if traced else []) + ["compared"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["compared"]) == {"loss_gap", "grad_gap", "change_gap"}
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
    else:
        assert set(line["metrics"]) == {"train_clips_per_s", "setup_s"}


def test_run_prints_no_result_once_jax_is_loaded(monkeypatch, capsys):
    """A per-layer metric reader that loads the JAX package, as a later
    metric file could: the check runs after the result is built."""
    from benchmark import run

    assert not harness.forbidden_modules()
    c = harness.cell("audioset_full.train")
    c.config.update(TINY)
    c.workload["profile_steps"] = 1
    out = train.run(c, seed=2**31 + 12, seconds=1.0, traced=True, t0=time.perf_counter(),
                    device="cpu")

    def reader(trace):
        monkeypatch.setitem(sys.modules, "psla_tpu", types.ModuleType("psla_tpu"))
        return 1.0

    monkeypatch.setenv("PSLA_TPU_TORCH_BUILD_DIR", "unused")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(train, "run", lambda *a, **k: out)
    monkeypatch.setattr(harness, "metric_reader", lambda name: reader)
    capsys.readouterr()
    rc = run.main(["--workload", "audioset_full.train", "--seed", "5", "--seconds", "1",
                   "--trace", "1"])
    printed = capsys.readouterr()
    assert rc == 3 and printed.out == ""
    assert "psla_tpu" in printed.err


def _run(cwd: Path):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "audioset_full.train", "--seed", "3", "--seconds", "1"],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
