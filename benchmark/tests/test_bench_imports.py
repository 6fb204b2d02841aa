"""No module the benchmark runs loads JAX, its libraries or the JAX package
(compared by whole top-level names: ``psla_tpu_torch`` is the program
and is allowed), and the yardstick, the reference above all, loads
nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "psla_tpu")
# the benchmark's own yardstick: traffic, work counts, comparison, reference
YARDSTICK = ["benchmark.harness", "benchmark.work", "benchmark.traffic", "benchmark.compare",
             "benchmark.weights", "benchmark.reference.kaldi_fbank",
             "benchmark.reference.training", "benchmark.reference.precision"]


def loaded_after(modules: list[str], files: list[str] = ()) -> list[str]:
    """Top-level names in ``sys.modules`` of a fresh interpreter after
    importing ``modules`` and loading the metric ``files``."""
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import importlib, json\n"
            "from benchmark.harness import load_module\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"for f in {list(files)!r}: load_module(__import__('pathlib').Path(f))\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, timeout=300)
    return json.loads(out.stdout.strip().splitlines()[-1])


def benchmark_modules() -> tuple[list[str], list[str], list[str]]:
    """Every driver and metric reader under ``benchmark/`` (those of cells
    kept beside the manifest's too), and the manifest's model families."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    families = {json.loads((ROOT / c["file"]).read_text())["family"]
                for c in manifest["configs"]}
    drivers = sorted(p.stem for p in (ROOT / "benchmark/drivers").glob("*.py")
                     if p.stem != "__init__")
    metrics = sorted(str(p) for p in (ROOT / "benchmark/metrics").glob("*.py"))
    return ([f"benchmark.drivers.{d}" for d in drivers],
            [f"benchmark.reference.{f}" for f in sorted(families)], metrics)


def test_nothing_the_benchmark_runs_loads_jax():
    drivers, families, metrics = benchmark_modules()
    top = loaded_after(["benchmark.run", *drivers, *families, *YARDSTICK], metrics)
    assert "psla_tpu_torch" in top  # the drivers drive the program
    assert not [m for m in top if m in FORBIDDEN]


def test_the_reference_loads_nothing_of_the_program():
    _, families, metrics = benchmark_modules()
    top = loaded_after([*families, *YARDSTICK], metrics)
    assert "psla_tpu_torch" not in top
    assert not [m for m in top if m in FORBIDDEN]
