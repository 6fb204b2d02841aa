"""End-to-end smoke test on the card (``psla-torch-smoke``; port of
``psla_tpu/tools/smoke.py``).

Deployment sanity check: writes a tiny synthetic dataset of
class-dependent tones and runs the whole pipeline through ``cli.run`` --
host decode -> preprocessing on the device (mixup, the fbank kernel,
SpecAugment) -> training epochs -> validation -> checkpoint ensemble ->
weight averaging -> post-training protocol -- then checks that every
expected artifact is in the experiment directory. ``--protocol`` chains
the whole PSLA protocol loop instead (``run_protocol``).

Both paths train in bfloat16, as the JAX tool does
(``psla_tpu/tools/smoke.py:53,145``).

    psla-torch-smoke [--epochs 2] [--protocol] [--keep] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import tempfile

import numpy as np
import torch

DTYPE = "bfloat16"  # as the JAX tool trains (psla_tpu/tools/smoke.py)


def run(epochs: int = 2, exp_root: str | None = None, device: str = "cuda") -> dict:
    """The single-run smoke: EffNet-B0 at T=64, 2 classes, 16 clips."""
    from psla_tpu_torch.cli import run as cli_run
    from psla_tpu_torch.data.wav import write_wav

    d = exp_root or tempfile.mkdtemp(prefix="psla_smoke_")
    rng = np.random.default_rng(0)
    entries = []
    t = np.arange(16000) / 16000
    for i in range(16):
        p = os.path.join(d, f"{i}.wav")
        tone = 0.3 * np.sin(2 * np.pi * (300 if i % 2 else 800) * t)
        write_wav(p, tone + rng.standard_normal(16000) * 0.05, 16000)
        entries.append({"wav": p, "labels": "/m/0" if i % 2 else "/m/1"})
    for name in ("tr", "val"):
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump({"data": entries}, f)
    with open(os.path.join(d, "labels.csv"), "w") as f:
        f.write("index,mid,display_name\n0,/m/0,tone300\n1,/m/1,tone800\n")

    exp = os.path.join(d, "exp")
    summary = cli_run([
        "--data-train", os.path.join(d, "tr.json"),
        "--data-val", os.path.join(d, "val.json"),
        "--label-csv", os.path.join(d, "labels.csv"),
        "--exp-dir", exp,
        "--n_class", "2", "--eff_b", "0", "--target_length", "64",
        "--impretrain", "False",
        "--batch-size", "8", "--n-epochs", str(epochs),
        "--wa", "True", "--wa_start", "1", "--wa_end", str(epochs),
        "--bal", "True", "--dtype", DTYPE,
        "--n-print-steps", "100", "--lr", "1e-3", "--device", device,
    ])
    expect = {
        "result.csv", "config.json", "progress.json", "wa_result.csv",
        "best_single_result.csv", "ensemble_result.csv", "models",
        "predictions",
    }
    have = {os.path.basename(p) for p in glob.glob(os.path.join(exp, "*"))}
    missing = expect - have
    assert not missing, f"missing artifacts: {missing}"
    for key in ("best_single", "wa", "ensemble"):
        assert np.isfinite(summary[key]["eval_mAP"]), summary
    return {"summary": summary, "exp_dir": d}


def run_protocol(
    epochs: int = 1,
    exp_root: str | None = None,
    round1_epochs: int = 4,
    device: str = "cuda",
) -> dict:
    """The COMPLETE PSLA protocol loop, chained end to end:

      round-1 train -> predict on the TRAIN set -> fix_type1 + fix_type2 +
      merge (ontology percentile thresholds) -> regenerate weight file ->
      round-2 train on the enhanced datafile

    (reference: src/label_enhancement/fix_type1.py:83-130 +
    egs/fsd50k/run.sh:39-44 -- each stage exists there as a standalone
    script; this pins the inter-stage file contracts: prediction-CSV row
    order = datafile order, *_type1_2_{p}.json naming, weight-file
    regeneration). Every stage is driven through its CLI surface:
    ``cli.run``, ``tools/ensemble.main`` and ``tools/label_enhancement.main``.

    `round1_epochs` floors the FIRST training leg, and both legs run with
    --bn-momentum 0.5: a from-scratch model's eval-mode forward is
    input-independent until the BatchNorm running statistics leave their
    init, and the strict `pred > threshold` enhancement rule then adds
    nothing. Momentum 0.5 brings the running statistics to the batch
    statistics within ~10 updates, so round-1 predictions depend on the
    input at smoke scale. The round-2 retrain leg only needs to complete,
    so it uses `epochs`.
    """
    from psla_tpu_torch.cli import run as cli_run
    from psla_tpu_torch.data.datafiles import load_datafile
    from psla_tpu_torch.data.sampler import compute_sample_weights
    from psla_tpu_torch.data.wav import write_wav
    from psla_tpu_torch.tools import ensemble as ensemble_tool
    from psla_tpu_torch.tools import label_enhancement as le

    d = exp_root or tempfile.mkdtemp(prefix="psla_protocol_")
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)

    # 3-class corpus with a real ontology chain mid0 -> mid1 -> mid2
    # (mid0 is mid1's parent, mid1 is mid2's parent), so both error types
    # have candidates: a clip labeled mid0 can gain child mid1 (type 1),
    # a clip labeled mid2 can gain ancestors mid1/mid0 (type 2).
    mids = ["/m/proto0", "/m/proto1", "/m/proto2"]
    freqs = [300, 600, 1200]
    t = np.arange(16000) / 16000
    entries = []
    for i in range(24):
        k = i % 3
        p = os.path.join(d, f"{i}.wav")
        wav = 0.3 * np.sin(2 * np.pi * freqs[k] * t)
        # make the classes acoustically overlap a little so round-1
        # predictions give the thresholds something to work with
        wav += 0.1 * np.sin(2 * np.pi * freqs[(k + 1) % 3] * t)
        write_wav(p, wav + rng.standard_normal(16000) * 0.05, 16000)
        entries.append({"wav": p, "labels": mids[k]})
    tr_json = os.path.join(d, "tr.json")
    with open(tr_json, "w") as f:
        json.dump({"data": entries}, f)
    label_csv = os.path.join(d, "labels.csv")
    with open(label_csv, "w") as f:
        f.write("index,mid,display_name\n")
        for k, mid in enumerate(mids):
            f.write(f'{k},{mid},"tone {freqs[k]}"\n')
    onto_json = os.path.join(d, "ontology.json")
    with open(onto_json, "w") as f:
        json.dump([
            {"id": mids[0], "child_ids": [mids[1]], "restrictions": []},
            {"id": mids[1], "child_ids": [mids[2]], "restrictions": []},
            {"id": mids[2], "child_ids": [], "restrictions": []},
        ], f)

    base_flags = [
        "--data-val", tr_json, "--label-csv", label_csv,
        "--n_class", "3", "--eff_b", "0", "--target_length", "64",
        "--impretrain", "False", "--batch-size", "8",
        "--dtype", DTYPE,
        "--n-print-steps", "100", "--lr", "1e-3", "--wa", "False",
        "--bn-momentum", "0.5", "--device", device,
    ]

    # ---- stage 1: round-1 training
    exp1 = os.path.join(d, "exp_round1")
    cli_run(["--data-train", tr_json, "--exp-dir", exp1, "--bal", "True",
             "--n-epochs", str(max(epochs, round1_epochs)), *base_flags])
    best_ckpt = os.path.join(exp1, "models", "best")
    assert os.path.isdir(best_ckpt), best_ckpt

    # ---- stage 2: predictions on the TRAIN set (row i = datafile row i)
    preds_dir = os.path.join(d, "train_preds")
    ensemble_tool.main([
        best_ckpt, "--data-eval", tr_json, "--label-csv", label_csv,
        "--n_class", "3", "--eff_b", "0", "--target_length", "64",
        "--batch-size", "8", "--out-dir", preds_dir, "--device", device,
    ])
    pred_csv = os.path.join(preds_dir, "predictions_0.csv")
    target_csv = os.path.join(preds_dir, "target.csv")
    pred = np.loadtxt(pred_csv, delimiter=",")
    target = np.loadtxt(target_csv, delimiter=",")
    assert pred.shape == target.shape == (24, 3), pred.shape
    # the strict `pred > threshold` rule needs input-dependent scores;
    # constant columns here mean the round-1 leg undertrained (BN running
    # stats still at init) -- raise round1_epochs, don't loosen thresholds
    assert float(pred.std(axis=0).max()) > 1e-6, (
        f"round-1 predictions are (near-)constant: std={pred.std(axis=0)}"
    )
    # row order contract: target row i reproduces datafile row i's labels
    idx = {m: k for k, m in enumerate(mids)}
    for i, e in enumerate(entries):
        expect = np.zeros(3)
        expect[[idx[m] for m in e["labels"].split(",")]] = 1.0
        np.testing.assert_array_equal(target[i], expect)

    # ---- stage 3: fix_type1 + fix_type2 + merge + weight files
    le.main([
        "--mode", "all", "--datafile", tr_json, "--label-csv", label_csv,
        "--ontology", onto_json, "--pred", pred_csv, "--target", target_csv,
        "--thresholds", "5",  # permissive percentile: guarantees additions
    ])
    enhanced_json = os.path.join(d, "tr_type1_2_5.json")
    assert os.path.exists(enhanced_json), enhanced_json
    with open(enhanced_json) as f:
        enhanced = json.load(f)["data"]
    added = 0
    for orig, enh in zip(entries, enhanced):
        o = set(orig["labels"].split(","))
        n = set(enh["labels"].split(","))
        assert o <= n, (o, n)  # enhancement only ADDS labels
        assert enh["wav"] == orig["wav"]
        added += len(n - o)
    assert added > 0, "the 5th-percentile merge added no labels"

    # ---- stage 4: weight file regenerated for the enhanced datafile and
    # consistent with what the balanced sampler computes from it
    weight_csv = os.path.join(d, "tr_type1_2_5_weight.csv")
    assert os.path.exists(weight_csv), weight_csv
    weights = np.loadtxt(weight_csv, delimiter=",")
    df_enh = load_datafile(enhanced_json, label_csv)
    np.testing.assert_allclose(weights, compute_sample_weights(df_enh), rtol=1e-6)
    # the added labels must shift the balanced sampler's distribution
    # against the original datafile's (1000/(count+0.01), gen_weight_file.py
    # semantics), so the retrain samples differently because of them
    weights_orig = compute_sample_weights(load_datafile(tr_json, label_csv))
    assert weights.shape == weights_orig.shape
    assert not np.allclose(weights, weights_orig, rtol=1e-6), (
        "label enhancement added labels but left every sampling weight "
        "unchanged - the retrain would be identical to the control"
    )

    # ---- stage 5: round-2 training on the enhanced labels, plus a
    # no-enhancement CONTROL leg with the identical config/seed. The only
    # input difference is the enhanced labels; their effect must reach the
    # training signal (first-epoch loss differs: weighted sampling order
    # and BCE targets both change). Reference: egs/fsd50k/run.sh:39-44.
    exp2 = os.path.join(d, "exp_round2")
    summary = cli_run(["--data-train", enhanced_json, "--exp-dir", exp2,
                       "--bal", "True", "--n-epochs", str(epochs), *base_flags])
    assert os.path.exists(os.path.join(exp2, "result.csv"))
    for part in summary.values():
        assert np.isfinite(part["eval_mAP"]), summary
    exp_ctl = os.path.join(d, "exp_round2_control")
    cli_run(["--data-train", tr_json, "--exp-dir", exp_ctl,
             "--bal", "True", "--n-epochs", "1", *base_flags])
    loss_enh = float(np.atleast_2d(np.loadtxt(
        os.path.join(exp2, "result.csv"), delimiter=","))[0, 5])
    loss_ctl = float(np.atleast_2d(np.loadtxt(
        os.path.join(exp_ctl, "result.csv"), delimiter=","))[0, 5])
    assert loss_enh != loss_ctl, (
        f"enhanced retrain's first-epoch loss ({loss_enh}) is identical "
        "to the no-enhancement control - the enhanced labels never "
        "reached training"
    )
    return {
        "summary": summary, "exp_dir": d, "labels_added": added,
        "retrain_loss": loss_enh, "control_loss": loss_ctl,
    }


def device_name(device: str) -> str:
    """The torch device and, on a card, its name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"{dev} ({torch.cuda.get_device_name(dev)})"
    return str(dev)


def main_cli(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--keep", action="store_true",
                   help="keep the experiment directory")
    p.add_argument("--protocol", action="store_true",
                   help="chain the FULL PSLA protocol loop (train -> "
                        "train-set predict -> label enhancement -> weight "
                        "file -> retrain) instead of the single-run smoke")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    args = p.parse_args(argv)
    if args.protocol:
        res = run_protocol(args.epochs, device=args.device)
    else:
        res = run(args.epochs, device=args.device)
    kind = "PROTOCOL" if args.protocol else "SMOKE"
    print(f"{kind} OK on {device_name(args.device)}: {res['summary']}")
    if not args.keep:
        shutil.rmtree(res["exp_dir"], ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main_cli())
