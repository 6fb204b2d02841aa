"""The port's spans (``psla_tpu_torch/tracing.py``) on the CPU: none without
a profiler, the train step's phases nested in order under one, AST's spans
inside its forward, the input queue's wait once a batch, and every span
the package opens named in ``SPANS``.

Size: B0, one head, T=64, 4 classes, batch 4, mixup and SpecAugment on;
AST at width 32, 2 blocks, 2 heads, 32 mel bins.
"""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from psla_tpu_torch import tracing
from psla_tpu_torch.data.device_prefetch import BATCH_FIELDS, prefetch_to_device
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import ASTModel, create_model
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_train_step, draw_train, step_generator

torch.set_num_threads(2)

PACKAGE = pathlib.Path(tracing.__file__).resolve().parent
PHASES = ("psla.train.preprocess", "psla.train.forward", "psla.train.backward",
          "psla.train.optimizer")


def spans(trace_path) -> list[dict]:
    """The ``psla.*`` spans of a chrome trace, in order of their start."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"
                   and e["name"].startswith("psla.")), key=lambda e: e["ts"])


def assert_step_phases(trace_path) -> list[dict]:
    """Every ``psla.train.step`` of the trace holds the four phases, in
    order, on its own thread and inside its interval. Returns the spans."""
    found = spans(trace_path)
    steps = [e for e in found if e["name"] == "psla.train.step"]
    assert steps, [e["name"] for e in found]
    for step in steps:
        inside = [e for e in found if e["tid"] == step["tid"] and e is not step
                  and step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]]
        assert tuple(e["name"] for e in inside) == PHASES
    return found


def test_no_profiler_no_span(monkeypatch):
    def refused(*_):
        raise AssertionError("a profiler call with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert tracing.span("train.step") is tracing.span("prefetch.wait")
    with tracing.span("train.step"):
        pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(tracing.span("train.step"), torch.profiler.record_function)


def test_the_package_opens_only_the_named_spans():
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "span"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                opened.add("psla." + node.args[0].value)
    assert opened == set(tracing.SPANS)


def test_train_step_phases_nest_in_order(tmp_path):
    cfg = PreprocessConfig(target_length=64, freq_mask=24, time_mask=16, mixup_rate=1.0)
    n = cfg.fbank.buffer_length(64)
    rng = np.random.default_rng(3)
    wav = (rng.standard_normal((4, n)) * 3000).astype(np.int16)
    labels = np.eye(4, dtype=np.float32)
    batch = {"wav": wav, "wav_mean": np.zeros(4, np.float32),
             "length": np.full(4, n, np.int32), "labels": labels,
             "mix_wav": np.roll(wav, 1, 0), "mix_wav_mean": np.zeros(4, np.float32),
             "mix_length": np.full(4, n, np.int32), "mix_labels": np.roll(labels, 1, 0)}
    model = create_model("efficientnet", label_dim=4, eff_b=0, head_num=1)
    state = create_train_state(model, lambda step: 1e-3, device="cpu")
    step = build_train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        draws = draw_train(step_generator(5, 0, "cpu"), model, 4, cfg)
        state, out = step(state, batch, draws)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    found = assert_step_phases(path)
    assert [e["name"] for e in found] == ["psla.train.draws", "psla.train.step", *PHASES]
    assert state.step == 1 and torch.isfinite(out["loss"])


def test_ast_forward_opens_its_spans_in_order(tmp_path):
    """One forward of a two-block AST: embed, then attention and mlp a
    block, then head: 2 x depth + 2 spans."""
    depth = 2
    model = ASTModel(label_dim=4, input_fdim=32, input_tdim=64, embed_dim=32, depth=depth,
                     num_heads=2)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        model(torch.randn(2, 64, 32))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert [e["name"] for e in spans(path)] == [
        "psla.ast.embed", *["psla.ast.attention", "psla.ast.mlp"] * depth, "psla.ast.head"]


@pytest.mark.parametrize("taken", [1, 3])
def test_prefetch_waits_once_a_batch_taken(tmp_path, taken):
    host = [{k: np.full((2, 8), i, np.float32) for k in BATCH_FIELDS} for i in range(5)]
    feed = prefetch_to_device(iter(host), "cpu", depth=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = [next(feed)[1]["wav"][0, 0].item() for _ in range(taken)]
    feed.close()
    assert got == list(range(taken))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert [e["name"] for e in spans(path)] == ["psla.prefetch.wait"] * taken
