"""``benchmark/spans.py`` on hand-made chrome traces of three threads: the
step's, with nested spans; autograd's, launching kernels inside
``psla.train.backward``'s interval; the prefetch producer's, launching a
copy inside the same interval. And the reader leaves what the accepted
metrics read as ``harness.read_chrome_trace`` reads it."""

import json
import time

import pytest

from benchmark import harness, spans
from benchmark.drivers import train
from benchmark.tests.test_bench_harness import TINY

STEP, AUTOGRAD, PREFETCH, STRAY = 1, 2, 3, 4


def span(name, tid, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur}


def launch(corr, tid, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid, "ts": ts,
            "dur": 1.0, "args": {"correlation": corr}}


def device(corr, name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def events(with_spans: bool = True) -> list[dict]:
    """One step, 1000-1995 us, behind a 100-us wait for its batch; the
    device idle 1000-1020 and 1200-1300 inside the step (the second in the
    forward), and 2000-2150 after it."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.step", "pid": 1, "tid": STEP,
         "ts": 1000, "dur": 1000},
        # the step thread's operations and launches
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1, "tid": STEP,
         "ts": 1250, "dur": 20},
        launch(1, STEP, 1010), launch(2, STEP, 1260), launch(5, STEP, 1910),
        launch(8, STEP, 1985),  # after the optimizer, in the step's own time
        # autograd's thread: operations recorded, no span of its own
        {"ph": "X", "cat": "cpu_op", "name": "autograd::engine", "pid": 1, "tid": AUTOGRAD,
         "ts": 1500, "dur": 350},
        launch(3, AUTOGRAD, 1510), launch(4, AUTOGRAD, 1700),
        # the producer: its own span around its copy
        launch(6, PREFETCH, 1520, "cudaMemcpyAsync"),
        # a thread the profiler does not follow
        launch(9, STRAY, 1530, "cudaMemcpyAsync"),
        # the device
        device(1, "fbank_kernel", 1020, 180),
        device(2, "sm90_xmma_fprop", 1300, 200),
        device(3, "void_cudnn::bn_bw_1C11_kernel", 1500, 200),
        device(4, "wgrad_alg0_engine", 1700, 200),
        device(6, "Memcpy HtoD (Pinned -> Device)", 1530, 50, "gpu_memcpy"),
        device(9, "Memcpy HtoD (Pinned -> Device)", 1590, 10, "gpu_memcpy"),
        device(5, "multi_tensor_apply_kernel_adam", 1900, 50),
        device(8, "vectorized_elementwise_kernel", 1950, 50),
        device(7, "vectorized_elementwise_kernel", 2150, 100),  # launched by no call seen
    ]
    if with_spans:
        ev += [span("psla.prefetch.wait", STEP, 880, 100),
               span("psla.train.step", STEP, 1000, 995),
               span("psla.train.preprocess", STEP, 1005, 200),
               span("psla.train.forward", STEP, 1210, 280),
               span("psla.train.backward", STEP, 1495, 400),
               span("psla.train.optimizer", STEP, 1900, 80),
               span("psla.prefetch.stage", PREFETCH, 1515, 20)]
    return ev


def write(tmp_path, ev, name="trace.json") -> str:
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_each_launch_goes_to_its_span(tmp_path):
    t = spans.read_chrome_trace(write(tmp_path, events()), window_s=0.00125)
    assert t.steps == 1
    assert t.span_device_s == pytest.approx({
        "psla.train.preprocess": 180e-6, "psla.train.forward": 200e-6,
        "psla.train.backward": 400e-6,  # autograd's thread, in the step's backward
        "psla.prefetch.stage": 50e-6,  # the producer's copy, not the backward's
        "psla.train.optimizer": 50e-6, "psla.train.step": 50e-6,
        None: 110e-6})  # the unfollowed thread's copy and the unlaunched kernel
    assert t.span_host_s["psla.prefetch.wait"] == pytest.approx(100e-6)
    assert t.step_idle_s == pytest.approx(120e-6)


def test_quantities(tmp_path):
    t = spans.read_chrome_trace(write(tmp_path, events()), window_s=0.00125)
    q = spans.quantities(t)
    assert q["preprocess_ms"] == pytest.approx(0.18)
    assert q["forward_ms"] == pytest.approx(0.2)
    assert q["backward_ms"] == pytest.approx(0.4)
    assert q["optimizer_ms"] == pytest.approx(0.05)
    assert q["idle_step"] == pytest.approx(9.6)  # 120 us of 1250
    assert q["data_wait"] == pytest.approx(8.0)
    assert q["phase_share"] == pytest.approx(100 * 830 / 880)


def test_quantities_are_none_without_spans(tmp_path):
    t = spans.read_chrome_trace(write(tmp_path, events(with_spans=False)), window_s=0.00125)
    assert t.steps == 0 and set(t.span_device_s) == {None}
    assert set(spans.quantities(t).values()) == {None}
    assert set(spans.quantities(spans.SpanTrace()).values()) == {None}


def test_gaps_take_the_innermost_program_span(tmp_path):
    t = spans.read_chrome_trace(write(tmp_path, events()), window_s=0.00125)
    base = harness.read_chrome_trace(write(tmp_path, events(), "b.json"), 0.00125)
    assert [label for label, _ in base.gaps] == ["host: no recorded operation", "bench.step"]
    assert [label for label, _ in t.gaps] == ["host: no recorded operation",
                                              "psla.train.forward"]
    assert [s for _, s in t.gaps] == [s for _, s in base.gaps]


def test_without_program_spans_the_trace_reads_as_before(tmp_path):
    ev = events(with_spans=False)
    ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::rsub", "pid": 1, "tid": STEP,
               "ts": 2010, "dur": 150})
    path = write(tmp_path, ev)
    t, base = spans.read_chrome_trace(path, 0.00125), harness.read_chrome_trace(path, 0.00125)
    assert (t.window_s, t.busy_s, t.ops, t.gaps) == (base.window_s, base.busy_s, base.ops,
                                                     base.gaps)
    assert [label for label, _ in t.gaps] == ["aten::rsub", "bench.step"]


@pytest.mark.parametrize("metric", ["idle.train", "bn_share.train", "fbank_roofline.train",
                                    "mfu.train"])
def test_the_accepted_metrics_read_the_same(tmp_path, metric):
    path = write(tmp_path, events())
    t, base = spans.read_chrome_trace(path, 0.00125), harness.read_chrome_trace(path, 0.00125)
    counters = {"fbank_bound_s": 1e-5, "fbank_launches": 1, "clips_per_s": 300.0,
                "train_flop_per_clip": 1e10, "peak_flop_s": 6.7e13}
    t.counters, base.counters = dict(counters), dict(counters)
    read = harness.metric_reader(metric)
    assert read(t) is not None and read(t) == read(base)


def test_a_traced_cpu_run_reads_the_spans():
    """The train cell's driver on the CPU at a tiny size, its window read
    by this reader: the profiled steps and their waits for a batch."""
    c = harness.cell("audioset_full.train")
    c.config.update(TINY)
    c.workload["profile_steps"] = 2
    with spans.reading_spans():
        out = train.run(c, seed=2**31 + 21, seconds=1.0, traced=True, t0=time.perf_counter(),
                        device="cpu")
    assert harness.read_chrome_trace is spans._read_base
    assert isinstance(out.trace, spans.SpanTrace)
    assert out.trace.steps == 2 and out.trace.span_host_s["psla.prefetch.wait"] > 0
    line = harness.result(c, out, True)
    assert set(line["metrics"]) <= {m["name"] for m in c.per_layer}
