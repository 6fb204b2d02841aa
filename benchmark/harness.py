"""What every cell shares: the manifest and the files it names, the
device's description, the traced window, the import check and the result
line. Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# whole top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "psla_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with the files it names."""

    name: str
    chips: int
    workload: dict  # benchmark/workloads/<name>.json
    config: dict  # the configuration's file
    end_to_end: list[dict]  # the manifest's end-to-end metrics this cell reports
    per_layer: list[dict]  # the manifest's per-layer metrics this cell reports


def cell(name: str, manifest: dict | None = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``manifest``), its
    workload file (``benchmark/workloads/<name>.json``) and configuration
    file, and the metrics it reports: the end-to-end metrics that list it
    (or list no cells), and the per-layer metrics that list it (or list
    none and move one of those)."""
    manifest = load_json(root / "BENCHMARK.json") if manifest is None else manifest
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    workload = load_json(root / "benchmark" / "workloads" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m["workloads"] or ("workloads" not in m and m["moves"] in moved)]
    return Cell(name, entry["chips"], workload, load_json(root / conf["file"]), e2e, layer)


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """``read(trace)`` of ``benchmark/metrics/<name>.py``."""
    return load_module(HERE / "metrics" / f"{name}.py").read


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card() -> dict:
    """The card as ``nvidia-smi`` names it, with its power limit."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return {}
    name, _, limit = out[0].partition(",") if out else ("", "", "")
    return {"smi_name": name.strip(), "power_limit": limit.strip()}


# ------------------------------------------------------------------ trace


@dataclasses.dataclass
class Trace:
    """What a traced run read: the profiled window's length on the host's
    clock, the seconds some operation ran on the device in it, the device
    operations (name, seconds), the idle gaps (what the host was doing,
    seconds) and the cell driver's counters."""

    window_s: float = 0.0
    busy_s: float = 0.0
    ops: list = dataclasses.field(default_factory=list)
    gaps: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


def _union(intervals) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
GAPS = 10  # the longest idle gaps kept, each labelled
# the host's events: its operations and spans, and its calls into CUDA
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def read_chrome_trace(path: str, window_s: float) -> Trace:
    """A ``torch.profiler`` chrome trace -> ``Trace``: device operations,
    their merged busy time, and the ``GAPS`` longest idle gaps between them,
    each labelled by the innermost benchmark span (``bench.*``) or else the
    outermost host operation or CUDA call running at its middle."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and e.get("dur") is not None]
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("dur") is not None]
    busy = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    ops = [(e["name"], e["dur"] * 1e-6) for e in dev]
    idle = sorted(((start - end, end, start) for (_, end), (start, _) in zip(busy, busy[1:])),
                  reverse=True)[:GAPS]
    gaps = []
    for length, end, start in idle:
        mid = 0.5 * (end + start)
        around = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        spans = [e for e in around if e["name"].startswith("bench.")]
        if spans:
            label = min(spans, key=lambda e: e["dur"])["name"]
        elif around:
            label = max(around, key=lambda e: e["dur"])["name"]
        else:
            label = "host: no recorded operation"
        gaps.append((label, length * 1e-6))
    return Trace(window_s=window_s, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 ops=ops, gaps=gaps)


@contextlib.contextmanager
def profiled(trace_holder: list, sync, host: bool = True):
    """Profile the device, and with ``host`` the host's operations, over
    the block; on leaving, append the ``Trace`` of that window to
    ``trace_holder``. ``sync`` waits for the device, at both ends of the
    host-timed window. The chrome trace is written under ``TMPDIR`` and
    removed once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():  # without a card, the host alone
        activities.append(ProfilerActivity.CPU)
    tmp = tempfile.mkdtemp(prefix="bench-profile-")
    try:
        sync()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            yield
            sync()
            window = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace_holder.append(read_chrome_trace(path, window))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def warm_profiler(sync):
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, which takes seconds) is paid in set-up and not in the window."""
    with profiled([], sync):
        sync()


def top(pairs, n: int = 10) -> list[list]:
    """The ``n`` largest entries of (name, seconds) pairs summed by name."""
    total: dict[str, float] = {}
    for name, s in pairs:
        total[name] = total.get(name, 0.0) + s
    return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(trace: Trace) -> dict:
    return {"device_ops": top(trace.ops), "idle_gaps": [[g[:160], s] for g, s in trace.gaps]}


# ------------------------------------------------------------------ result


@dataclasses.dataclass
class Outcome:
    """What a driver hands back from one run."""

    values: dict  # end-to-end quantities by the workload file's names
    setup_s: float
    attempted: int
    failed: int
    checks: list  # [(name, value, limit)]: correct while value <= limit
    memory_peak_bytes: int
    device_kind: str
    device_count: int
    trace: Trace | None = None
    notes: list = dataclasses.field(default_factory=list)  # lines for standard error


def result(c: Cell, out: Outcome, traced: bool) -> dict:
    """The run's result line: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the end-to-end metrics, or the per-layer ones when
    traced), ``device``, ``breakdown`` when traced, and last the numbers
    compared with their limits."""
    correct = all(v == v and v <= lim for _, v, lim in out.checks) and out.failed == 0
    metrics = {}
    if traced:
        for m in c.per_layer:
            value = metric_reader(m["name"])(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        names = c.workload["report"]
        for m in c.end_to_end:
            value = out.setup_s if m["name"] == "setup_s" else out.values[names[m["name"]]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": out.device_kind, "count": out.device_count,
              "memory_peak_bytes": out.memory_peak_bytes, **card()}
    line = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    if traced:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        line["breakdown"] = breakdown(out.trace)
    line["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in out.checks}
    return line
