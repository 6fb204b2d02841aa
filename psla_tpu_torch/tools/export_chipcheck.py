"""The bfloat16 export artifact checked on the serving hardware
(``psla-torch-export-chipcheck``; port of
``psla_tpu/tools/export_chipcheck.py``).

A deployer runs it on the device that will serve (a card by default,
``--device cpu`` on a host without one). It

  1. builds the flagship serving model in bfloat16 (EffNet-B2 + 4-head
     attention, 527 classes, T=1056; the usual shape flags override it),
     from ``--ckpt`` files or the port's own seeded random init,
  2. exports it through the product path (``tools/export.export_model``),
     writes the artifact and loads it back from disk
     (``save_exported`` / ``load_exported``),
  3. runs one seeded waveform batch through the artifact's ``.probs`` and
     through the live inference program (``tools/export.build_program``,
     eager) on the same device,
  4. holds them elementwise at ``--atol`` and prints one JSON verdict line;
     the exit code is 1 when they disagree or a probability is not finite.

    python -m psla_tpu_torch.tools.export_chipcheck [--eff_b 2]
        [--target_length 1056] [--batch 4] [--ckpt model.pth ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--ckpt", action="append", default=None,
                   help="optional checkpoint(s); default: random init")
    p.add_argument("--model", default="efficientnet",
                   choices=["efficientnet", "resnet", "mbnet"])
    p.add_argument("--eff_b", type=int, default=2)
    p.add_argument("--att_head", type=int, default=4)
    p.add_argument("--n_class", type=int, default=527)
    p.add_argument("--target_length", type=int, default=1056)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--atol", type=float, default=1e-6)
    p.add_argument("--device", default="cuda",
                   help="torch device to export and run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)

    from psla_tpu_torch.frontend.fbank import FbankConfig
    from psla_tpu_torch.frontend.pipeline import PreprocessConfig
    from psla_tpu_torch.models import create_model
    from psla_tpu_torch.models.convert import load_variables
    from psla_tpu_torch.tools import export as exp_mod

    device = torch.device(args.device)
    config = PreprocessConfig(fbank=FbankConfig(), target_length=args.target_length)
    members = []
    for ckpt in args.ckpt or [None]:
        model = create_model(args.model, label_dim=args.n_class, eff_b=args.eff_b,
                             head_num=args.att_head, dtype=torch.bfloat16)
        if ckpt is not None:
            model.load_state_dict(load_variables(ckpt))
        members.append(model)

    names = {i: str(i) for i in range(args.n_class)}
    exported, meta = exp_mod.export_model(members, config, names, device=device)
    with tempfile.TemporaryDirectory(prefix="psla_chipcheck_") as d:
        exp_mod.save_exported(d, exported, meta)
        blob_mb = os.path.getsize(os.path.join(d, exp_mod.ARTIFACT)) / 1e6
        loaded = exp_mod.load_exported(d, device)

        chunk = loaded.chunk_samples
        rng = np.random.default_rng(0)
        wav = rng.standard_normal((args.batch, chunk)).astype(np.float32) * 0.1
        mean = wav.mean(axis=1)
        lengths = np.full((args.batch,), chunk, np.int32)
        got = loaded.probs(wav, mean, lengths)

    program = exp_mod.build_program(members, config, device)
    with torch.no_grad():
        want = program(*(torch.from_numpy(x).to(device) for x in (wav, mean, lengths)))
    want = want.cpu().numpy()
    max_abs = float(np.max(np.abs(got - want)))
    ok = bool(max_abs <= args.atol) and bool(np.isfinite(got).all())
    print(json.dumps({
        "check": f"export_{device.type}_lowering",
        "backend": device.type,
        "ok": ok,
        "max_abs_diff_vs_native": max_abs,
        "atol": args.atol,
        "blob_mb": round(blob_mb, 1),
        "shape": {"model": args.model, "eff_b": args.eff_b,
                  "att_head": args.att_head, "n_class": args.n_class,
                  "target_length": args.target_length,
                  "batch": args.batch,
                  "n_members": len(members)},
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
