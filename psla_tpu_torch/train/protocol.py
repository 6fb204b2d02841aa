"""Post-training evaluation protocol (reference: src/run.py:134-233; port of
``psla_tpu/train/protocol.py``).

Two branches:
  * datasets with a separate eval set (FSD50K): re-evaluate the best-single
    and weight-averaged checkpoints on val+eval sets, then run every epoch
    checkpoint on the eval set and average the prediction matrices
    (checkpoint ensemble) -> best_single_result.csv / wa_result.csv /
    ensemble_result.csv (run.py:135-200);
  * eval-only datasets (AudioSet): summarize from result.csv — mean of the
    last 5 epochs, the wa row, and the running-ensemble columns
    (run.py:202-233).
"""

from __future__ import annotations

import os

import numpy as np

from psla_tpu_torch.metrics import calculate_stats
from psla_tpu_torch.parallel.distributed import is_primary


def _mean_ap_auc(stats):
    return (
        float(np.mean([s["AP"] for s in stats])),
        float(np.nanmean([s["auc"] for s in stats])),
    )


def _save(path: str, values):
    """Rank 0 writes a summary CSV (every rank computes the same values)."""
    if is_primary():
        np.savetxt(path, values)


def post_training_summary(trainer, eval_loader=None) -> dict:
    """Run the protocol with a ``train.loop.Trainer``; returns the summary
    dict and writes the CSVs."""
    cfg = trainer.config
    exp_dir = trainer.exp_dir
    summary = {}
    print("---------------Result Summary---------------")

    if eval_loader is not None:
        # best single model
        state = trainer.restore_checkpoint("best")
        stats, _ = trainer.validate(state, trainer.val_loader, "best_single_valid_set")
        val_map, val_auc = _mean_ap_auc(stats)
        stats, _ = trainer.validate(
            state, eval_loader, "best_single_eval_set", eval_target=True
        )
        eval_map, eval_auc = _mean_ap_auc(stats)
        _save(
            os.path.join(exp_dir, "best_single_result.csv"),
            [val_map, val_auc, eval_map, eval_auc],
        )
        summary["best_single"] = dict(
            val_mAP=val_map, val_mAUC=val_auc, eval_mAP=eval_map, eval_mAUC=eval_auc
        )
        print(f"best single: val mAP {val_map:.6f} eval mAP {eval_map:.6f}")

        # weight-averaged model
        if os.path.isdir(trainer._ckpt_dir("wa")):
            state = trainer.restore_checkpoint("wa")
            stats, _ = trainer.validate(state, trainer.val_loader, "wa_valid_set")
            val_map, val_auc = _mean_ap_auc(stats)
            stats, _ = trainer.validate(state, eval_loader, "wa_eval_set")
            eval_map, eval_auc = _mean_ap_auc(stats)
            _save(
                os.path.join(exp_dir, "wa_result.csv"),
                [val_map, val_auc, eval_map, eval_auc],
            )
            summary["wa"] = dict(
                val_mAP=val_map, val_mAUC=val_auc,
                eval_mAP=eval_map, eval_mAUC=eval_auc,
            )
            print(f"weight avg: val mAP {val_map:.6f} eval mAP {eval_map:.6f}")

        # checkpoint ensemble on the eval set
        result = np.atleast_2d(
            np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=",")
        )
        val_map, val_auc = float(result[-1, -3]), float(result[-1, -2])
        ensemble_pred = None
        count = 0
        for epoch in range(1, cfg.n_epochs + 1):
            tag = f"epoch_{epoch}"
            if not os.path.isdir(trainer._ckpt_dir(tag)):
                continue
            state = trainer.restore_checkpoint(tag)
            trainer.validate(state, eval_loader, f"eval_{epoch}")
            pred = np.loadtxt(
                os.path.join(exp_dir, "predictions", f"predictions_eval_{epoch}.csv"),
                delimiter=",",
            )
            ensemble_pred = pred if ensemble_pred is None else ensemble_pred + pred
            count += 1
        if count == 0:
            # per-epoch checkpoints can be absent (--save_model False lets
            # weight averaging delete them, traintest.py:310-311 semantics)
            print("ensemble: no per-epoch checkpoints on disk, skipped")
        else:
            target = np.loadtxt(
                os.path.join(exp_dir, "predictions", "eval_target.csv"),
                delimiter=",",
            )
            ensemble_pred = ensemble_pred / count
            stats = calculate_stats(ensemble_pred, target)
            eval_map, eval_auc = _mean_ap_auc(stats)
            _save(
                os.path.join(exp_dir, "ensemble_result.csv"),
                [val_map, val_auc, eval_map, eval_auc],
            )
            summary["ensemble"] = dict(
                val_mAP=val_map, val_mAUC=val_auc,
                eval_mAP=eval_map, eval_mAUC=eval_auc,
            )
            print(f"ensemble ({count} ckpts): eval mAP {eval_map:.6f}")
    else:
        result = np.atleast_2d(
            np.loadtxt(os.path.join(exp_dir, "result.csv"), delimiter=",")
        )
        last5 = result[-5:].mean(axis=0)
        summary["best_single"] = dict(eval_mAP=float(last5[0]), eval_mAUC=float(last5[1]))
        _save(
            os.path.join(exp_dir, "best_single_result.csv"), [last5[0], last5[1]]
        )
        print(f"last-5-epoch mean: mAP {last5[0]:.6f} AUC {last5[1]:.6f}")

        wa_path = os.path.join(exp_dir, "wa_result.csv")
        if os.path.exists(wa_path):
            wa = np.loadtxt(wa_path)
            summary["wa"] = dict(eval_mAP=float(wa[0]), eval_mAUC=float(wa[1]))
            print(f"weight avg: mAP {wa[0]:.6f} AUC {wa[1]:.6f}")

        ens_map, ens_auc = float(result[-1, -3]), float(result[-1, -2])
        summary["ensemble"] = dict(eval_mAP=ens_map, eval_mAUC=ens_auc)
        _save(os.path.join(exp_dir, "ensemble_result.csv"), [ens_map, ens_auc])
        print(f"ensemble: mAP {ens_map:.6f} AUC {ens_auc:.6f}")
    return summary
