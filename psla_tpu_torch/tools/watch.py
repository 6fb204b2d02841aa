"""Live experiment monitor: follow a (possibly running) exp_dir
(``psla-torch-watch``; port of ``psla_tpu/tools/watch.py``).

The reference's only observability is stdout prints + flat files. This
tool turns the artifact files the port's trainer writes (config.json,
progress.json, result.csv, and seed_result.csv once multi-seed ensembles
are ported) into a live status view, so a training run on a GPU host can
be monitored from any shell, with no tensorboard (though --tensorboard
scalars exist too, train/loop.py). It reads files only and touches no card:

    psla-torch-watch exp/audioset-full-0817          # follow
    psla-torch-watch exp/audioset-full-0817 --once   # snapshot
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

RESULT_COLS = (
    "metric", "mAUC", "mid_prec", "mid_rec", "d_prime",
    "train_loss", "valid_loss", "ens_metric", "ens_mAUC", "lr",
)


def _try_parse(path: str, parse):
    """Parse one artifact file; None if absent OR torn. The trainer
    writes result.csv / progress.json non-atomically while running, so
    a poll can land mid-write — treat a parse error as 'not yet' and
    let the next poll pick up the completed write."""
    if not os.path.exists(path):
        return None
    try:
        return parse(path)
    except (ValueError, json.JSONDecodeError, OSError):
        return None


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def read_state(exp_dir: str) -> dict:
    """Parse the artifact files into one status dict (missing -> {})."""
    out: dict = {"exp_dir": exp_dir}
    cfg = _try_parse(os.path.join(exp_dir, "config.json"), _load_json)
    if cfg is not None:
        out["config"] = {
            k: cfg.get(k)
            for k in ("dataset", "model", "eff_b", "n_class", "batch_size",
                      "lr", "n_epochs", "ensemble_seeds")
        }
    prog = _try_parse(os.path.join(exp_dir, "progress.json"), _load_json)
    if prog is not None:
        out["progress"] = prog
    rows = _try_parse(
        os.path.join(exp_dir, "result.csv"),
        lambda p: np.atleast_2d(np.loadtxt(p, delimiter=",")),
    )
    if rows is not None and rows.size and rows.shape[1] == len(RESULT_COLS):
        done = [i for i, r in enumerate(rows) if np.any(r != 0)]
        out["epochs"] = [
            {"epoch": i + 1, **dict(zip(RESULT_COLS, map(float, rows[i])))}
            for i in done
        ]
    seed_rows = _try_parse(
        os.path.join(exp_dir, "seed_result.csv"),
        lambda p: [
            line.strip().split(",")
            for line in open(p) if line.strip()
        ],
    )
    if seed_rows is not None:
        out["seed_rows"] = seed_rows
    return out


def render(state: dict, prev_epochs: int = 0) -> tuple[str, int]:
    """Text for everything newer than prev_epochs; returns (text, count)."""
    lines = []
    cfg = state.get("config")
    if prev_epochs == 0 and cfg:
        ens = (f" x{cfg['ensemble_seeds']} seeds"
               if (cfg.get("ensemble_seeds") or 1) > 1 else "")
        lines.append(
            f"== {state['exp_dir']}: {cfg['model']}-b{cfg['eff_b']}{ens} on "
            f"{cfg['dataset']} ({cfg['n_class']} classes), bs={cfg['batch_size']} "
            f"lr={cfg['lr']} for {cfg['n_epochs']} epochs"
        )
    epochs = state.get("epochs", [])
    for row in epochs[prev_epochs:]:
        lines.append(
            f"epoch {row['epoch']:>3}: metric {row['metric']:.4f}  "
            f"AUC {row['mAUC']:.4f}  train_loss {row['train_loss']:.4f}  "
            f"valid_loss {row['valid_loss']:.4f}  ens {row['ens_metric']:.4f}  "
            f"lr {row['lr']:.2e}"
        )
    prog = state.get("progress")
    if prog and epochs and len(epochs) != prev_epochs:
        lines.append(
            f"   best: metric {prog['best_metric']:.4f} @ epoch "
            f"{prog['best_epoch']} | step {prog['global_step']}"
        )
    return "\n".join(lines), len(epochs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("exp_dir")
    p.add_argument("--once", action="store_true", help="snapshot and exit")
    p.add_argument("--interval", type=float, default=10.0)
    p.add_argument("--max-polls", type=int, default=None,
                   help="stop after N polls (default: until interrupted)")
    args = p.parse_args(argv)

    seen = 0
    polls = 0
    while True:
        state = read_state(args.exp_dir)
        text, seen_now = render(state, seen)
        if text:
            print(text, flush=True)
        seen = seen_now
        polls += 1
        if args.once or (args.max_polls is not None and polls >= args.max_polls):
            break
        prog = state.get("progress")
        cfg = state.get("config")
        if prog and cfg and prog.get("epoch", 0) >= (cfg.get("n_epochs") or 0):
            print("training complete.")
            break
        time.sleep(args.interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
