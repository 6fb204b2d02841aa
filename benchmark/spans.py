#!/usr/bin/env python3
"""The program's spans (``psla.*``, opened by ``psla_tpu_torch/tracing.py``)
read from the same ``torch.profiler`` chrome trace as
``harness.read_chrome_trace``, and the per-layer quantities they give.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

runs the cell once, traced, as ``run.py --trace 1`` does, and prints the
run's traced result line with a ``spans`` object beside it: what
``quantities`` reads, the device and host seconds by span, the steps, and
the idle gaps labelled by ``bench.*`` and ``psla.*`` spans.

Attribution: each device operation (kernel, memcpy, memset) is matched by
``args.correlation`` to the CUDA runtime or driver call that launched it,
and the call to the innermost ``psla.*`` span open at its start on its own
thread. A call on a thread that holds no ``psla.*`` span but on which the
profiler recorded operations goes to the innermost span open at that time
on the thread that holds ``psla.train.step``: autograd's device threads,
which launch the backward while the calling thread waits in
``psla.train.backward``. A call on a thread where the profiler recorded no
operation (one it does not follow, such as the prefetch producer's under
the default profiler), or one outside every span, goes to None.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

if __package__ in (None, ""):  # run as a script from the checkout's root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness, run  # noqa: E402

STEP = "psla.train.step"
PHASES = ("psla.train.preprocess", "psla.train.forward", "psla.train.backward",
          "psla.train.optimizer")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_read_base = harness.read_chrome_trace  # held here: main() puts this module's in its place


@dataclasses.dataclass
class SpanTrace(harness.Trace):
    """``harness.Trace`` with the program's spans: the device seconds of the
    operations launched inside each span (innermost; None for the rest),
    the host seconds of each span, the number of steps, and the idle
    seconds inside the steps' intervals. ``gaps`` are labelled by the
    innermost ``bench.*`` or ``psla.*`` span at their middle."""

    span_device_s: dict = dataclasses.field(default_factory=dict)
    span_host_s: dict = dataclasses.field(default_factory=dict)
    steps: int = 0
    step_idle_s: float = 0.0


def _label(around: list[dict]) -> str:
    """``harness.read_chrome_trace``'s gap label, with ``psla.*`` spans
    taken as ``bench.*`` spans are."""
    spans = [e for e in around if e["name"].startswith(("bench.", "psla."))]
    if spans:
        return min(spans, key=lambda e: e["dur"])["name"]
    if around:
        return max(around, key=lambda e: e["dur"])["name"]
    return "host: no recorded operation"


class _Open:
    """The ``psla.*`` spans of each thread, for the innermost one open at a
    time."""

    def __init__(self, spans: list[dict]):
        self.by_tid: dict = {}
        for e in sorted(spans, key=lambda e: e["ts"]):
            self.by_tid.setdefault(e["tid"], []).append(e)
        self.starts = {tid: [e["ts"] for e in s] for tid, s in self.by_tid.items()}

    def innermost(self, tid, ts: float) -> str | None:
        spans = self.by_tid.get(tid, [])
        for i in range(bisect.bisect_right(self.starts.get(tid, []), ts) - 1, -1, -1):
            if ts <= spans[i]["ts"] + spans[i]["dur"]:
                return spans[i]["name"]  # the latest start that holds ts
        return None


def _overlap(a: float, b: float, busy: list[list[float]]) -> float:
    """The part of [a, b] that the merged intervals ``busy`` cover."""
    i = max(bisect.bisect_right([s for s, _ in busy], a) - 1, 0)
    covered = 0.0
    for s, e in busy[i:]:
        if s >= b:
            break
        covered += max(0.0, min(e, b) - max(s, a))
    return covered


def read_chrome_trace(path: str, window_s: float) -> SpanTrace:
    base = _read_base(path, window_s)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("dur") is not None]
    dev = [e for e in events if e.get("cat") in harness.DEVICE_CATS]
    host = [e for e in events if e.get("cat") in harness.HOST_CATS]
    spans = [e for e in host if e["name"].startswith("psla.")]
    busy = harness._union((e["ts"], e["ts"] + e["dur"]) for e in dev)

    gaps = []
    idle = sorted(((s - e, e, s) for (_, e), (s, _) in zip(busy, busy[1:])),
                  reverse=True)[:harness.GAPS]
    for length, end, start in idle:
        mid = 0.5 * (end + start)
        gaps.append((_label([e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]),
                     length * 1e-6))

    opened = _Open(spans)
    steps = [e for e in spans if e["name"] == STEP]
    step_tid = steps[0]["tid"] if steps else None
    followed = {e["tid"] for e in host if e.get("cat") in ("cpu_op", "user_annotation")}
    launches = {e["args"]["correlation"]: e for e in host
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device_s: dict = {}
    for op in dev:
        call = launches.get(op.get("args", {}).get("correlation"))
        name = None
        if call is not None:
            if call["tid"] in opened.by_tid:
                name = opened.innermost(call["tid"], call["ts"])
            elif call["tid"] in followed and step_tid is not None:
                name = opened.innermost(step_tid, call["ts"])
        device_s[name] = device_s.get(name, 0.0) + op["dur"] * 1e-6
    host_s: dict = {}
    for e in spans:
        host_s[e["name"]] = host_s.get(e["name"], 0.0) + e["dur"] * 1e-6
    step_idle = sum(e["dur"] - _overlap(e["ts"], e["ts"] + e["dur"], busy) for e in steps)
    return SpanTrace(window_s=base.window_s, busy_s=base.busy_s, ops=base.ops, gaps=gaps,
                     span_device_s=device_s, span_host_s=host_s, steps=len(steps),
                     step_idle_s=step_idle * 1e-6)


def quantities(trace: SpanTrace) -> dict[str, float | None]:
    """What the spans give, each None where its spans or device operations
    are missing: the device ms a step of the operations launched in each
    of the four phases, the idle time inside ``psla.train.step`` and the
    host time in ``psla.prefetch.wait``, each over the profiled window (%),
    and the four phases' share of the steps' device time (%)."""
    dev = trace.span_device_s
    out: dict[str, float | None] = {}
    for phase in PHASES:
        short = phase.rsplit(".", 1)[1]
        out[f"{short}_ms"] = (1e3 * dev[phase] / trace.steps
                              if trace.steps and phase in dev else None)
    has_window = trace.window_s > 0 and bool(trace.ops)
    out["idle_step"] = (100.0 * trace.step_idle_s / trace.window_s
                        if has_window and trace.steps else None)
    wait = trace.span_host_s.get("psla.prefetch.wait")
    out["data_wait"] = 100.0 * wait / trace.window_s if has_window and wait is not None else None
    in_steps = sum(s for k, s in dev.items() if k is not None and k.startswith("psla.train.")
                   and k != "psla.train.draws")
    out["phase_share"] = (100.0 * sum(dev.get(p, 0.0) for p in PHASES) / in_steps
                          if in_steps > 0 else None)
    return out


@contextlib.contextmanager
def reading_spans():
    """Within the block, ``harness.profiled`` reads its window with this
    module's ``read_chrome_trace``."""
    harness.read_chrome_trace = read_chrome_trace
    try:
        yield
    finally:
        harness.read_chrome_trace = _read_base


def main(argv=None) -> int:
    t0 = time.perf_counter()
    args = run.parse(argv)
    os.environ["PSLA_TPU_TORCH_BUILD_DIR"] = str(harness.ROOT / "build" / "psla_tpu_torch")
    cell = harness.cell(args.workload)
    driver = importlib.import_module(f"benchmark.drivers.{cell.workload['driver']}")
    with reading_spans():
        out = driver.run(cell, seed=args.seed, seconds=args.seconds, traced=True, t0=t0)
    line = harness.result(cell, out, True)
    trace = out.trace
    line["spans"] = {"quantities": quantities(trace), "steps": trace.steps,
                     "device_s": {str(k): v for k, v in trace.span_device_s.items()},
                     "host_s": trace.span_host_s,
                     "idle_gaps": [[g[:160], s] for g, s in trace.gaps]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
