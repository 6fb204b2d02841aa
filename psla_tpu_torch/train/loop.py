"""Training and validation engine: the reference's train-loop protocol on
one card or on several ranks (port of ``psla_tpu/train/loop.py``).

It does what src/traintest.py does: per-epoch train and validate, a running
checkpoint ensemble of prediction CSVs, 10-column result.csv rows, best and
per-epoch checkpoints, the NaN-divergence abort, per-sample data/DNN timing
meters, and weight averaging at the end. Beyond the reference, as in the
JAX package: a resumed run replays the uninterrupted run, because the step
counter and the optimizer are restored, each step's draws come from
(seed, step) (``train.step.step_generator``) and the sampling is keyed by
epoch (tests/test_torch_cli.py holds a CPU resume to atol 0).

Artifacts under exp_dir, as the JAX package lays them out:
  result.csv, wa_result.csv, stats_{epoch}.pickle, progress.json,
  config.json, predictions/{target.csv, predictions_{e}.csv,
  ensemble_predictions.csv}, models/{epoch_N, best, wa}/checkpoint.pth
  (``torch.save`` of {"step", "model": the state_dict in the reference key
  layout, "optimizer": Adam's state_dict}).

Several ranks (``torch.distributed``, ``parallel/``): each rank's loader
holds its share of the global batch, the train step synchronizes BatchNorm
and averages the gradients, validation gathers every rank's rows in the
dataset's order, and only rank 0 writes files (CSVs, checkpoints,
tensorboard, the profile, weight averaging's deletes), each write followed
by a barrier where another rank reads it next.

Deliberate deviation kept from the JAX package: weight averaging divides
by the true checkpoint count (the reference's validate_wa divides by N+1,
traintest.py:302-315).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import shutil
import time

import numpy as np
import torch

from psla_tpu_torch.config import ExperimentConfig, unported
from psla_tpu_torch.data.device_prefetch import prefetch_to_device
from psla_tpu_torch.data.loader import AudioLoader
from psla_tpu_torch.metrics import calculate_stats, d_prime
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import CHECKPOINT_FILE, load_variables
from psla_tpu_torch.models.pretrained import (
    convert_imagenet_state_dict,
    resolve_imagenet_checkpoint,
)
from psla_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_floats,
    gather_valid,
    is_primary,
)
from psla_tpu_torch.parallel.mesh import Mesh, make_mesh
from psla_tpu_torch.train.meters import AverageMeter
from psla_tpu_torch.train.optim import psla_lr_schedule
from psla_tpu_torch.train.state import TrainState, create_train_state, replicate_state
from psla_tpu_torch.train.step import (
    TrainDraws,
    build_eval_step,
    build_train_step,
    draw_train,
    step_generator,
)


def _fresh_progress() -> dict:
    return {
        "epoch": 0, "global_step": 0, "best_epoch": 0,
        "best_metric": -float("inf"), "best_ensemble_epoch": 0,
        "best_ensemble_metric": -float("inf"), "history": [],
    }


class Trainer:
    """The PSLA trainer on ``device`` ('cuda' unless the caller asks for
    'cpu'). The loaders are ``data.loader.AudioLoader``s, each this rank's
    shard when the process group has several ranks (``cli.make_loaders``);
    the mesh spans every rank of the group (``parallel.mesh.make_mesh``,
    ``config.num_devices`` ranks)."""

    def __init__(
        self,
        config: ExperimentConfig,
        train_loader: AudioLoader,
        val_loader: AudioLoader,
        eval_loader: AudioLoader | None = None,
        device: str | torch.device = "cuda",
    ):
        unported(config)
        self.config = config
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.eval_loader = eval_loader
        self.device = torch.device(device)
        self.mesh = self._make_mesh()

        self.exp_dir = os.path.abspath(config.exp_dir)
        if is_primary():
            os.makedirs(os.path.join(self.exp_dir, "models"), exist_ok=True)
            os.makedirs(os.path.join(self.exp_dir, "predictions"), exist_ok=True)
            config.save(os.path.join(self.exp_dir, "config.json"))
        barrier("trainer_init")

        self.pre_config = config.preprocess_config()
        self.steps_per_epoch = max(1, train_loader.batches_per_epoch())
        self.schedule = psla_lr_schedule(
            config.lr,
            self.steps_per_epoch,
            lrscheduler_start=config.lrscheduler_start,
            lrscheduler_decay=config.lrscheduler_decay,
            lrscheduler_step=config.lrscheduler_step,
            warmup=config.warmup,
            warmup_steps=config.warmup_steps,
            warmup_update_every=config.warmup_update_every,
        )
        self._build_steps()
        # the module being trained (train() sets it; an ensemble's first
        # member); draws() reads which of its blocks drop
        self.model: torch.nn.Module | None = None
        self._profiler = None
        self._tb = None
        # target CSVs this trainer has (re)written: the first write of each
        # OVERWRITES, so reusing an exp_dir never scores new predictions
        # against a stale target matrix from an old run
        self._targets_refreshed: set[str] = set()
        # per epoch: its meters, and the seconds of its train loop (to the
        # epoch-end loss fetch, which waits for the card)
        self.meters: dict[str, AverageMeter] = {}
        self.train_seconds: dict[int, float] = {}

    def _make_mesh(self) -> Mesh:
        """This rank's mesh: one row of every rank (the ensemble trainer
        lays out its own)."""
        return make_mesh(self.config.num_devices, self.device)

    def _build_steps(self):
        """The train and eval steps (the ensemble trainer builds its own)."""
        self.train_step = build_train_step(self.pre_config, self.config.loss, self.mesh)
        self.eval_step = build_eval_step(self.pre_config, self.config.loss)

    # ------------------------------------------------------ tensorboard

    def _tb_writer(self):
        """Lazy SummaryWriter into {exp_dir}/tb (config.tensorboard), on
        rank 0. Returns None when disabled or unavailable, and on the other
        ranks."""
        if not self.config.tensorboard or not is_primary():
            return None
        if self._tb is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("tensorboard requested but not importable; skipping")
                self.config = dataclasses.replace(self.config, tensorboard=False)
                return None
            self._tb = SummaryWriter(os.path.join(self.exp_dir, "tb"))
        return self._tb

    def _tb_epoch(self, epoch: int, scalars: dict):
        tb = self._tb_writer()
        if tb is None:
            return
        for k, v in scalars.items():
            tb.add_scalar(k, v, epoch)
        tb.flush()

    # ------------------------------------------------------------- state

    def _new_model(self, seed: int | None = None) -> torch.nn.Module:
        """A module of the configured architecture, freshly initialised
        from ``seed`` (default: the config's; on the CPU): its compute
        ``dtype`` and ``act_compress`` the config's, as the JAX trainer
        builds its model (training and validation run it); parameters,
        statistics and so checkpoints stay float32. AST's positional
        embedding is sized for the config's mel bins and target length."""
        cfg = self.config
        return create_model(
            cfg.model, label_dim=cfg.n_class, eff_b=cfg.eff_b, head_num=cfg.att_head,
            dtype=getattr(torch, cfg.dtype), act_compress=cfg.act_compress,
            remat=cfg.remat, bn_momentum=cfg.bn_momentum,
            input_fdim=cfg.num_mel_bins, input_tdim=cfg.target_length,
            generator=torch.Generator().manual_seed(cfg.seed if seed is None else seed),
        )

    def _pretrained(self) -> dict[str, torch.Tensor] | None:
        """The state_dict of ``pretrained_ckpt`` or, under ``impretrain``, of
        the ImageNet file that ``models.pretrained.resolve_imagenet_checkpoint``
        finds on disk (it raises when there is none); None without either."""
        cfg = self.config
        path = cfg.pretrained_ckpt
        if not path and cfg.impretrain:
            path = resolve_imagenet_checkpoint(cfg.model, cfg.eff_b)
            print(f"loading ImageNet pretrained backbone: {path}")
        return load_variables(path) if path else None

    def _convert_pretrained(self, sd: dict[str, torch.Tensor],
                            init: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A pretrained state_dict over a fresh model's ``init``. The file is
        a full model in the reference key layout (anything
        ``models.convert.load_variables`` reads), or a backbone alone, such
        as an ImageNet efficientnet_pytorch or torchvision checkpoint: then
        the head, and for ResNet and MBNet the 1-channel stem, stay fresh.
        As in the JAX trainer (``psla_tpu/train/loop.py``), an EfficientNet
        or ResNet file without ``attention`` keys is a backbone, and so is
        an MBNet file without ``model.`` keys (torchvision's own layout)."""
        model = self.config.model
        if model == "mbnet":
            backbone_only = not any(k.startswith("model.") for k in sd)
        else:
            backbone_only = not any("attention" in k for k in sd)
        return convert_imagenet_state_dict(sd, model, init) if backbone_only else sd

    def init_state(self) -> TrainState:
        """A fresh initialisation from the config's seed, overlaid with the
        pretrained file (``_pretrained``, ``_convert_pretrained``) if any."""
        model = self._new_model()
        sd = self._pretrained()
        if sd is not None:
            model.load_state_dict(self._convert_pretrained(sd, model.state_dict()))
        state = create_train_state(model, self.schedule, step=0, device=self.device)
        return replicate_state(state, self.mesh)

    @staticmethod
    def _models(state: TrainState) -> list[torch.nn.Module]:
        """The modules a state trains (an ensemble's members)."""
        return [state.model]

    def draws(self, step: int, batch_size: int) -> TrainDraws:
        """Global step ``step``'s random draws for ``batch_size`` clips (the
        global batch: every rank draws all of them and its step keeps its
        rows), from its own generator (``step_generator``, seeded from the
        config's seed and ``step``)."""
        gen = step_generator(self.config.seed, step, self.device)
        return draw_train(gen, self.model, batch_size, self.pre_config)

    # ------------------------------------------------------- checkpointing

    def _ckpt_dir(self, tag) -> str:
        return os.path.join(self.exp_dir, "models", str(tag))

    @staticmethod
    def _checkpoint(state: TrainState) -> dict:
        """What a checkpoint file holds: {"step", "model", "optimizer"}."""
        return {"step": int(state.step), "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict()}

    def _write_checkpoint(self, payload: dict, tag):
        path = self._ckpt_dir(tag)
        os.makedirs(path, exist_ok=True)
        tmp = os.path.join(path, CHECKPOINT_FILE + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(path, CHECKPOINT_FILE))

    def save_checkpoint(self, state: TrainState, tag):
        """Rank 0 writes; every rank waits until the file is there."""
        if is_primary():
            self._write_checkpoint(self._checkpoint(state), tag)
        barrier(f"checkpoint_{tag}")

    def _load(self, tag) -> dict:
        return torch.load(os.path.join(self._ckpt_dir(tag), CHECKPOINT_FILE),
                          map_location="cpu", weights_only=True)

    def _state_from(self, ckpt: dict) -> TrainState:
        """The state of a checkpoint's "model" and "step", with its
        "optimizer" if it has one (else a fresh Adam)."""
        model = self._new_model()
        model.load_state_dict(ckpt["model"])
        state = create_train_state(model, self.schedule, step=int(ckpt["step"]),
                                   device=self.device)
        if "optimizer" in ckpt:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        return replicate_state(state, self.mesh)

    def restore_checkpoint(self, tag) -> TrainState:
        return self._state_from(self._load(tag))

    # ----------------------------------------------------------- profiling

    def _profile_tick(self, gstep: int):
        """Start and stop a torch.profiler trace around the configured steps
        (config.profile_steps / profile_start_step), written as a Chrome
        trace into {exp_dir}/profile: rank 0's, of every thread, so that it
        holds the prefetch producer's ``psla.prefetch.stage`` spans beside
        the step's (``psla_tpu_torch/tracing.py``)."""
        cfg = self.config
        if not cfg.profile_steps or not is_primary():
            return
        if self._profiler is None and gstep == cfg.profile_start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(
                activities=activities, experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True))
            self._profiler.start()
        elif self._profiler is not None and gstep >= cfg.profile_start_step + cfg.profile_steps:
            self._profile_flush()

    def _profile_flush(self):
        """Close a still-open trace window (its last steps included)."""
        if self._profiler is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        out = os.path.join(self.exp_dir, "profile")
        os.makedirs(out, exist_ok=True)
        self._profiler.export_chrome_trace(
            os.path.join(out, f"trace_steps_{self.config.profile_start_step}.json"))
        self._profiler = None
        self.config = dataclasses.replace(self.config, profile_steps=0)

    def _progress_path(self):
        return os.path.join(self.exp_dir, "progress.json")

    def _load_progress(self):
        if os.path.exists(self._progress_path()):
            with open(self._progress_path()) as f:
                return json.load(f)
        return _fresh_progress()

    def _save_progress(self, progress):
        if is_primary():
            with open(self._progress_path(), "w") as f:
                json.dump(progress, f, indent=1)

    # ------------------------------------------------------------ training

    def train(self, resume: bool = False) -> TrainState:
        cfg = self.config
        progress = self._load_progress()
        if resume and progress["epoch"] > 0:
            tag = f"epoch_{progress['epoch']}"
            if os.path.isdir(self._ckpt_dir(tag)):
                state = self.restore_checkpoint(tag)
                print(f"resumed from epoch {progress['epoch']}")
            else:
                # per-epoch checkpoints are deleted by weight averaging
                # when save_model=False (traintest.py:310-311 semantics)
                fallback = next(
                    (t for t in ("wa", "best") if os.path.isdir(self._ckpt_dir(t))), None)
                if progress["epoch"] >= cfg.n_epochs and fallback:
                    # run already completed (incl. wa); nothing to train
                    state = self.restore_checkpoint(fallback)
                    print(f"resume: per-epoch checkpoints were deleted (save_model=False) "
                          f"and training is complete; loaded '{fallback}'")
                    return state
                raise FileNotFoundError(
                    f"cannot resume: models/{tag} is missing (per-epoch checkpoints are "
                    "deleted by weight averaging when save_model=False). Keep "
                    "save_model=True for resumable runs, or restart without --resume.")
        else:
            progress = _fresh_progress()
            state = self.init_state()
        models = self._models(state)
        self.model = models[0]

        n_params = sum(p.numel() for m in models for p in m.parameters())
        print(f"Total parameter number is : {n_params / 1e6:.3f} million")

        result_rows = np.zeros((cfg.n_epochs, 10))
        result_path = os.path.join(self.exp_dir, "result.csv")
        if resume and os.path.exists(result_path):
            prev = np.atleast_2d(np.loadtxt(result_path, delimiter=","))
            result_rows[: prev.shape[0]] = prev[: cfg.n_epochs]

        start_time = time.time()
        for epoch in range(progress["epoch"] + 1, cfg.n_epochs + 1):
            epoch_begin = time.time()
            # epoch-keyed sampling: a resumed run replays the exact batch
            # sequence the uninterrupted run would have seen
            self.train_loader.set_epoch(epoch)
            meters = self.meters = {
                k: AverageMeter()
                for k in ("per_sample_time", "per_sample_data_time",
                          "per_sample_dnn_time", "loss")
            }
            end_time = time.time()
            # No host sync each step: the losses stay on the card and are
            # fetched once an epoch, and the divergence flag ORs isnan(loss)
            # on the card, read at print steps (the reference's
            # loss_meter.avg-is-nan window, traintest.py:125-131): a NaN at
            # any step aborts at the end of its print window. On several
            # ranks the loss is the mean over the ranks, so the flag is the
            # OR over the ranks too, and every rank aborts at the same step.
            gstep = progress["global_step"]
            epoch_losses = []
            diverged = torch.zeros((), dtype=torch.bool, device=self.device)
            # copies to the card run device_prefetch batches ahead from
            # pinned buffers on a side stream, so the 'data' meter reads
            # input starvation (the queue wait), not the copy
            with contextlib.closing(prefetch_to_device(
                    iter(self.train_loader), self.device, depth=cfg.device_prefetch)) as batches:
                for i, (host_batch, batch) in enumerate(batches):
                    bs = max(int(host_batch["n_valid"]), 1)
                    data_t = time.time() - end_time
                    dnn_start = time.time()
                    self._profile_tick(gstep)
                    state, metrics = self.train_step(state, batch, self.draws(
                        state.step, len(host_batch["wav"]) * self.mesh.world))
                    epoch_losses.append(metrics["loss"])
                    diverged.logical_or_(torch.isnan(metrics["loss"]))
                    gstep += 1
                    is_print = gstep % cfg.n_print_steps == 0 and gstep != 0
                    if is_print:
                        # the fetch waits for the print window's steps, so the
                        # meters amortize the card's time over the window
                        loss, step_diverged = float(metrics["loss"]), bool(diverged)
                    now = time.time()
                    meters["per_sample_data_time"].update(data_t / bs, bs)
                    meters["per_sample_dnn_time"].update((now - dnn_start) / bs, bs)
                    meters["per_sample_time"].update((now - end_time) / bs, bs)
                    if is_print:
                        meters["loss"].update(loss, bs)
                        print(
                            f"Epoch: [{epoch}][{i}/{self.steps_per_epoch}]  "
                            f"per-sample total {meters['per_sample_time'].avg:.5f}  "
                            f"data {meters['per_sample_data_time'].avg:.5f}  "
                            f"dnn {meters['per_sample_dnn_time'].avg:.5f}  "
                            f"loss {loss:.4f}",
                            flush=True,
                        )
                        if step_diverged:
                            print("training diverged...")
                            self._profile_flush()
                            return state
                    end_time = time.time()
            self._profile_flush()
            if epoch_losses:  # one sync an epoch for the exact mean
                fetched = torch.stack(epoch_losses).cpu().numpy()
                # epoch-end backstop: a NaN between the last print step and
                # epoch end must still abort before validate/checkpointing
                if np.isnan(fetched).any():
                    print("training diverged...")
                    return state
                meters["loss"].reset()
                meters["loss"].update(float(np.mean(fetched)), len(epoch_losses))
            self.train_seconds[epoch] = time.time() - epoch_begin
            print(f"epoch {epoch} train loop: {len(epoch_losses)} steps in "
                  f"{self.train_seconds[epoch]:.3f} s", flush=True)

            # ---------------- validation + artifacts (traintest.py:136-200)
            stats, valid_loss = self.validate(state, self.val_loader, epoch)

            mAP = float(np.mean([s["AP"] for s in stats]))
            mAUC = float(np.nanmean([s["auc"] for s in stats]))
            acc = stats[0]["acc"]
            # the running ensemble reads the CSVs, which rank 0 writes: it
            # scores them, and every rank takes its numbers
            ens_mAP = ens_mAUC = ens_acc = 0.0
            if is_primary():
                ensemble_stats = self.validate_ensemble(epoch)
                ens_mAP = float(np.mean([s["AP"] for s in ensemble_stats]))
                ens_mAUC = float(np.nanmean([s["auc"] for s in ensemble_stats]))
                ens_acc = ensemble_stats[0]["acc"]
            ens_mAP, ens_mAUC, ens_acc = (
                float(v) for v in broadcast_floats([ens_mAP, ens_mAUC, ens_acc]))
            mid_p = float(np.mean([s["precisions"][len(s["precisions"]) // 2] for s in stats]))
            mid_r = float(np.mean([s["recalls"][len(s["recalls"]) // 2] for s in stats]))
            cur_lr = float(self.schedule(state.step))

            main = mAP if cfg.metrics == "mAP" else acc
            ens_main = ens_mAP if cfg.metrics == "mAP" else ens_acc
            print(f"mAP: {mAP:.6f}" if cfg.metrics == "mAP" else f"acc: {acc:.6f}")
            print(f"AUC: {mAUC:.6f}")
            print(f"d_prime: {d_prime(mAUC):.6f}")
            print(f"train_loss: {meters['loss'].avg:.6f}")
            print(f"valid_loss: {valid_loss:.6f}")

            result_rows[epoch - 1] = [
                main, mAUC, mid_p, mid_r, d_prime(mAUC), meters["loss"].avg,
                valid_loss, ens_main, ens_mAUC, cur_lr,
            ]
            if is_primary():
                np.savetxt(result_path, result_rows, delimiter=",")
            self._tb_epoch(epoch, {
                "loss/train": meters["loss"].avg,
                "loss/valid": valid_loss,
                f"val/{cfg.metrics}": main,
                "val/AUC": mAUC,
                "val/d_prime": d_prime(mAUC),
                f"ensemble/{cfg.metrics}": ens_main,
                "lr": cur_lr,
                "time/per_sample_total": meters["per_sample_time"].avg,
                "time/per_sample_data": meters["per_sample_data_time"].avg,
                "time/per_sample_dnn": meters["per_sample_dnn_time"].avg,
            })

            if main > progress["best_metric"]:
                progress["best_metric"] = main
                progress["best_epoch"] = epoch
            if ens_main > progress["best_ensemble_metric"]:
                progress["best_ensemble_metric"] = ens_main
                progress["best_ensemble_epoch"] = epoch

            if progress["best_epoch"] == epoch:
                self.save_checkpoint(state, "best")
            self.save_checkpoint(state, f"epoch_{epoch}")

            if is_primary():
                with open(os.path.join(self.exp_dir, f"stats_{epoch}.pickle"), "wb") as f:
                    pickle.dump(stats, f, protocol=pickle.HIGHEST_PROTOCOL)

            progress["epoch"] = epoch
            progress["global_step"] = state.step
            progress["history"].append(
                [epoch, state.step, progress["best_epoch"], progress["best_metric"],
                 time.time() - start_time])
            self._save_progress(progress)
            print(f"epoch {epoch} training time: {time.time() - epoch_begin:.3f}")

        if cfg.wa:
            self.weight_average(cfg.wa_start, cfg.wa_end)
        if self._tb is not None:
            self._tb.close()
        return state

    # ---------------------------------------------------------- validation

    def validate(self, state: TrainState, loader: AudioLoader, epoch, eval_target=False):
        """No-grad eval pass; writes prediction CSVs (traintest.py:232-276).
        The padded tail rows of the last batch (past ``n_valid``) are
        dropped. The loss is the mean of per-sample losses (the reference
        averages per-batch means; identical for equal batch sizes). On
        several ranks each evaluates its own shard, every rank gets all rows
        in the dataset's order (``parallel.distributed.gather_valid``) and
        rank 0 writes."""
        preds, targets, losses, valid = [], [], [], []
        with contextlib.closing(prefetch_to_device(
                iter(loader), self.device, depth=self.config.device_prefetch)) as batches:
            for host_batch, batch in batches:
                out, per_sample = self.eval_step(state, batch)
                preds.append(out)
                targets.append(host_batch["labels"])
                losses.append(per_sample)
                valid.append(np.arange(len(out)) < int(host_batch["n_valid"]))
        valid = np.concatenate(valid)
        output, target, loss_rows = (
            gather_valid(rows, valid, mesh=self.mesh)
            for rows in (torch.cat(preds), np.concatenate(targets), torch.cat(losses)))
        loss = float(np.mean(loss_rows))
        stats = calculate_stats(output, target)

        if is_primary():
            pred_dir = os.path.join(self.exp_dir, "predictions")
            self._write_target_csv(pred_dir, "target.csv", target)
            np.savetxt(os.path.join(pred_dir, f"predictions_{epoch}.csv"), output,
                       delimiter=",")
            if eval_target:
                self._write_target_csv(pred_dir, "eval_target.csv", target)
        barrier(f"validate_{epoch}")  # the protocol reads the CSVs next
        return stats, loss

    def _write_target_csv(self, pred_dir: str, name: str, target):
        """Write a target matrix once per trainer: the FIRST write
        overwrites any file left by a previous run in the same exp_dir
        (stale targets would silently corrupt ensemble/protocol metrics),
        later calls keep it (the reference writes target.csv once,
        traintest.py:269-270)."""
        path = os.path.join(pred_dir, name)
        if name not in self._targets_refreshed or not os.path.exists(path):
            np.savetxt(path, target, delimiter=",")
            self._targets_refreshed.add(name)

    @staticmethod
    def _ensemble_folded_epoch(path) -> int:
        """Last epoch folded into the running-ensemble CSV (0 if none),
        stored as a '# epoch=N' comment header inside the CSV itself
        (np.loadtxt skips comment lines), so the matrix and its fold state
        change in ONE atomic os.replace."""
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            first = f.readline()
        if first.startswith("#") and "epoch=" in first:
            return int(first.split("epoch=")[1])
        return 0

    def validate_ensemble(self, epoch: int):
        """Running mean of per-epoch prediction CSVs (traintest.py:278-294),
        deleting the previous epoch's file.

        Idempotent per epoch: a crash between this fold and the epoch's
        progress.json write makes the resumed run REPLAY the epoch's
        validate; the fold marker keeps the replay from re-adding the
        epoch's predictions at the wrong weight."""
        pred_dir = os.path.join(self.exp_dir, "predictions")
        target = np.loadtxt(os.path.join(pred_dir, "target.csv"), delimiter=",")
        ens_path = os.path.join(pred_dir, "ensemble_predictions.csv")
        folded = self._ensemble_folded_epoch(ens_path)
        if folded >= epoch:  # replayed epoch: already folded in
            ensemble = np.loadtxt(ens_path, delimiter=",")
        elif epoch == 1:
            ensemble = np.loadtxt(os.path.join(pred_dir, "predictions_1.csv"), delimiter=",")
        else:
            ensemble = np.loadtxt(ens_path, delimiter=",") * (epoch - 1)
            ensemble += np.loadtxt(os.path.join(pred_dir, f"predictions_{epoch}.csv"),
                                   delimiter=",")
            prev = os.path.join(pred_dir, f"predictions_{epoch - 1}.csv")
            if os.path.exists(prev):
                os.remove(prev)
            ensemble = ensemble / epoch
        if folded < epoch:
            tmp = ens_path + ".tmp"
            np.savetxt(tmp, ensemble, delimiter=",", header=f"epoch={epoch}")
            os.replace(tmp, ens_path)
        return calculate_stats(np.atleast_2d(ensemble), np.atleast_2d(target))

    # ------------------------------------------------------ weight averaging

    def weight_average(self, start_epoch: int, end_epoch: int) -> TrainState:
        """Average the model's floating-point entries (parameters and
        BatchNorm statistics) over the epoch checkpoints
        (traintest.py:296-322 semantics, with the true 1/N); an integer
        entry keeps its last value. Deletes the epoch checkpoints when
        save_model=False."""
        total = None
        count = 0
        to_delete = []
        for epoch in range(start_epoch, end_epoch + 1):
            tag = f"epoch_{epoch}"
            if not os.path.exists(self._ckpt_dir(tag)):
                continue
            sd = self._load(tag)["model"]
            total = sd if total is None else {
                k: total[k] + v if v.is_floating_point() else v for k, v in sd.items()}
            count += 1
            if not self.config.save_model:
                to_delete.append(self._ckpt_dir(tag))
        # every rank has read the checkpoints before rank 0 deletes them
        barrier("wa_delete")
        if is_primary():
            for path in to_delete:
                shutil.rmtree(path)
        if count == 0:
            raise FileNotFoundError(f"no checkpoints in epochs [{start_epoch}, {end_epoch}]")
        state = self._state_from({"step": 0, "model": {
            k: v / count if v.is_floating_point() else v for k, v in total.items()}})
        self.save_checkpoint(state, "wa")
        stats, _ = self.validate(state, self.val_loader, "wa")
        mAP = float(np.mean([s["AP"] for s in stats]))
        mAUC = float(np.nanmean([s["auc"] for s in stats]))
        if is_primary():
            np.savetxt(os.path.join(self.exp_dir, "wa_result.csv"), [mAP, mAUC])
        barrier("wa_result")
        print(f"weight-averaged model ({count} ckpts): mAP {mAP:.6f} AUC {mAUC:.6f}")
        return state
