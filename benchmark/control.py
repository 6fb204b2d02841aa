#!/usr/bin/env python3
"""The readings that set the upper end of each limit a cell compares:
the control (the reference put in the program's place at the precision
below the one the cell states) and, for a training cell, its faults,
planted in the reference put in the program's place. The benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Training cells (the reference at the cell's own size, from the weights,
batches and draws its runs make):

* ``control``: every product and convolution at TF32 (``precision.tf32``);
* ``half_batch``: the steps on the first half of the batch's rows, the
  mean taken over them;
* ``altered``: each step's loss, the answer a step produces, altered by
  1% where it is computed;
* ``unchanged`` (a step that hands its state back unchanged) needs no run:
  its first moment and its change are zero, so it reads 1 on the
  gradient and the change.

One JSON line a seed and reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sliced(batches: list[dict], draws: list[dict], rows: int):
    def cut(d):
        return {k: (v[:, :rows] if k == "keep" else v[:rows]) for k, v in d.items()}
    return [cut(b) for b in batches], [cut(d) for d in draws]


def train_readings(cell, seed: int, dev) -> dict:
    import torch

    from benchmark import compare, program, traffic
    from benchmark.reference import training
    from benchmark.weights import make_weights

    wl, config = cell.workload, cell.config
    batch, steps = config["batch_size"], wl["checked_steps"]
    (weights,) = make_weights(config, seed, dev)
    pool = traffic.train_pool(wl["traffic"], config, batch, seed, dev)
    rates = training.family(config["family"]).drop_rates(config)
    draws = [program.make_draws(program.step_generator(seed, wl["start_step"] + i, dev),
                                batch, rates) for i in range(steps)]
    batches = [{k: torch.as_tensor(v).to(dev) for k, v in pool[i % len(pool)].items()}
               for i in range(steps)]

    def steps_of(b, d, precision="float32"):
        out = training.train_steps(config, weights, b, d, wl["start_step"], precision)
        return {"losses": [float(x) for x in out["losses"]],
                "grads": compare.norms(out["grads"]), "changes": compare.norms(out["changes"])}

    reference = training.train_steps(config, weights, batches, draws, wl["start_step"])
    readings = {"control": steps_of(batches, draws, "tf32"),
                "half_batch": steps_of(*sliced(batches, draws, batch // 2))}
    bce = training.bce
    training.bce = lambda p, t: bce(p, t) * 1.01
    try:
        readings["altered"] = steps_of(batches, draws)
    finally:
        training.bce = bce
    out = {name: {n: v for n, v, _ in compare.train_checks(r, reference, wl["limits"])[0]}
           for name, r in readings.items()}
    out["unchanged"] = {"grad_gap": 1.0, "change_gap": 1.0}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = harness.cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        readings = train_readings(cell, seed, dev)
        for name, numbers in readings.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                              **numbers}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
