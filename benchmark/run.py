#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the machine's own cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its workload file
(``benchmark/workloads/<cell>.json``) names the driver
(``benchmark/drivers/<driver>.py``), the precision and the traffic, and its
configuration file the model and recipe. The run makes its weights and
inputs from ``--seed``, warms up (``setup_s``), measures for ``--seconds``,
then checks what the timed path produced against the plain reference. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` when
traced, and ``compared``, each number compared with its limit, which also
close standard error. Without a card, or with fewer than the cell asks
for, it exits with 2 and prints no result; it never falls back to the CPU.
If JAX, its libraries or the JAX package (``psla_tpu``, by whole top-level
name) are loaded once the result is built, it names them on standard
error, exits with 3 and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    # the program's kernel libraries build once into the checkout
    os.environ["PSLA_TPU_TORCH_BUILD_DIR"] = str(ROOT / "build" / "psla_tpu_torch")
    from benchmark import harness

    cell = harness.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    driver = importlib.import_module(f"benchmark.drivers.{cell.workload['driver']}")
    out = driver.run(cell, seed=args.seed, seconds=args.seconds, traced=bool(args.trace),
                     t0=T0)
    line = harness.result(cell, out, bool(args.trace))
    # after every metric reader has been loaded, just before the result
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for note in out.notes:
        print(note, file=sys.stderr)
    for name, value, limit in out.checks:
        print(f"compared {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
