"""The ensemble trainer: E independent seeds trained in lockstep on one
card (port of ``psla_tpu/train/ensemble_loop.py``).

The PSLA protocol's headline numbers come from ensembles of independently
trained models (reference README.md:206: 10 models -> 0.474 mAP; the
reference trains them as separate jobs and combines them afterwards with
src/ensemble/ensemble.py). ``psla-torch-train --ensemble-seeds E`` trains
the E members side by side (``parallel/ensemble.py``): one shared data
stream, each member's own initialisation (seed + i), its own mixup,
SpecAugment and drop-connect draws (``train.step.step_generator`` with the
member's index), its own Adam. The whole Trainer protocol applies per seed
and to the seed mean:

  * ``predictions_{e}.csv`` holds the seed-mean prediction matrix, so
    result.csv's ensemble columns and the running checkpoint ensemble
    become a checkpoints x seeds ensemble;
  * each member's matrix is ``predictions_{e}_seed{i}.csv`` (the latest
    integer epoch only), and ``seed_result.csv`` holds one row per epoch
    or protocol tag: the members' mAPs, then the ensemble's;
  * the checkpoint under each tag is stacked (every state_dict entry
    stacked along a leading seed axis, E Adam states): it is what a resume
    and weight averaging read; for 'best' and 'wa' each member is also
    saved alone in ``models/{tag}_seed{i}``, a single-model checkpoint
    that ``tools/ensemble``, ``tools/weight_averaging``, ``tools/predict``
    and ``tools/convert_ckpt`` read;
  * ``--impretrain`` / ``--pretrained-ckpt``: the file is read once and
    converted against each member's own initialisation, so what the
    converter takes from the init (ResNet's and MBNet's 1-channel stem)
    stays per seed, and the pooling heads and MBNet's classifier always
    stay per-seed fresh, as in the reference protocol, where each member is
    a job with its own init.

Left out until ensembles across ranks (ROADMAP.md, Queue 1, item 6b): the JAX
trainer's multi-host pieces (its loader-shard check, the CLI's loader remap
by ``ensemble_layout``, the gather of members sharded across hosts). Here
every member is on the one card.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from psla_tpu_torch.data.device_prefetch import prefetch_to_device
from psla_tpu_torch.metrics import calculate_stats
from psla_tpu_torch.parallel.ensemble import (
    EnsembleState,
    ensemble_member,
    init_ensemble_state,
    make_ensemble_eval_step,
    make_ensemble_train_step,
)
from psla_tpu_torch.train.loop import Trainer
from psla_tpu_torch.train.step import TrainDraws, draw_train, step_generator

# state_dict keys of the pooling heads (EfficientNet, ResNet) and MBNet's
# classifier: per-seed fresh even when a pretrained file is loaded (the
# JAX package's 'attention' and 'classifier' collections)
HEAD_KEYS = ("attention.", "model.classifier.")


class EnsembleTrainer(Trainer):
    """The PSLA trainer for ``config.ensemble_seeds`` members on ``device``
    ('cuda' unless the caller asks for 'cpu')."""

    def __init__(self, config, train_loader, val_loader, eval_loader=None,
                 device: str | torch.device = "cuda"):
        if config.ensemble_seeds < 2:
            raise ValueError("EnsembleTrainer needs ensemble_seeds >= 2")
        self.num_seeds = config.ensemble_seeds
        self._seed_rows: dict[str, str] = {}  # seed_result.csv, keyed rows
        super().__init__(config, train_loader, val_loader, eval_loader, device=device)

    def _build_steps(self):
        self.train_step = make_ensemble_train_step(self.pre_config, self.config.loss)
        self.eval_step = make_ensemble_eval_step(self.pre_config, self.config.loss)

    # ------------------------------------------------------------- state

    def init_state(self) -> EnsembleState:
        """Member i freshly initialised from seed + i (member 0 is the single
        model's init), overlaid with the pretrained file if any."""
        cfg = self.config
        state = init_ensemble_state(self._new_model,
                                    [cfg.seed + i for i in range(self.num_seeds)],
                                    self.schedule, device=self.device)
        sd = self._pretrained()
        if sd is not None:
            self._overlay_pretrained(sd, state)
        return state

    def _overlay_pretrained(self, sd: dict[str, torch.Tensor], state: EnsembleState):
        """Convert the file against every member's own init and load it,
        keeping each member's own head keys (``HEAD_KEYS``)."""
        for member in state.members:
            init = {k: v.detach().cpu() for k, v in member.model.state_dict().items()}
            converted = self._convert_pretrained(sd, init)
            member.model.load_state_dict(
                {k: init[k] if k.startswith(HEAD_KEYS) else v for k, v in converted.items()})

    @staticmethod
    def _models(state: EnsembleState) -> list[torch.nn.Module]:
        return [m.model for m in state.members]

    def draws(self, step: int, batch_size: int) -> list[TrainDraws]:
        """Global step ``step``'s draws of each member, each from its own
        generator (``step_generator`` with the member's index)."""
        return [draw_train(step_generator(self.config.seed, step, self.device, member=i),
                           self.model, batch_size, self.pre_config)
                for i in range(self.num_seeds)]

    # ------------------------------------------------------- checkpointing

    @staticmethod
    def _checkpoint(state: EnsembleState) -> dict:
        """The stacked checkpoint: {"step", "seeds": E, "model": every
        state_dict entry stacked along a leading seed axis, "optimizer": the
        members' Adam state_dicts}. Weight averaging averages it entry by
        entry."""
        sds = [m.model.state_dict() for m in state.members]
        return {"step": int(state.step), "seeds": len(sds),
                "model": {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]},
                "optimizer": [m.optimizer.state_dict() for m in state.members]}

    def save_checkpoint(self, state: EnsembleState, tag):
        super().save_checkpoint(state, tag)
        if str(tag) in ("best", "wa"):
            for i in range(self.num_seeds):
                self._write_checkpoint(Trainer._checkpoint(ensemble_member(state, i)),
                                       f"{tag}_seed{i}")

    def _state_from(self, ckpt: dict) -> EnsembleState:
        """The members of a stacked checkpoint (or of weight averaging's
        stacked mean, which has no optimizer: fresh Adams)."""
        if ckpt.get("seeds", self.num_seeds) != self.num_seeds:
            raise ValueError(f"the checkpoint holds {ckpt['seeds']} ensemble members, "
                             f"--ensemble-seeds asks for {self.num_seeds}")
        members = []
        for i in range(self.num_seeds):
            one = {"step": ckpt["step"], "model": {k: v[i] for k, v in ckpt["model"].items()}}
            if "optimizer" in ckpt:
                one["optimizer"] = ckpt["optimizer"][i]
            members.append(super()._state_from(one))
        return EnsembleState(members)

    # ------------------------------------------------------- seed_result

    def _write_seed_result(self, key, member_maps, ens_map):
        """Rewrite seed_result.csv whole, like result.csv: one row per key
        (epoch number or protocol tag), so a resume that replays an epoch's
        validation overwrites its row. Epoch rows first (sorted), tag rows
        ('best_single_valid_set', 'wa', 'eval_*') after. Written through a
        rename, so a reader never sees a torn file."""
        self._seed_rows[str(key)] = (
            f"{key}," + ",".join(f"{m:.6f}" for m in member_maps) + f",{ens_map:.6f}")
        keys = (sorted((k for k in self._seed_rows if k.isdigit()), key=int)
                + [k for k in self._seed_rows if not k.isdigit()])
        path = os.path.join(self.exp_dir, "seed_result.csv")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write("".join(self._seed_rows[k] + "\n" for k in keys))
        os.replace(tmp, path)

    def train(self, resume: bool = False) -> EnsembleState:
        if resume:
            # reload the rows so the whole-file rewrite keeps them
            path = os.path.join(self.exp_dir, "seed_result.csv")
            if os.path.exists(path):
                with open(path) as f:
                    for line in f:
                        if line.strip():
                            self._seed_rows[line.split(",", 1)[0]] = line.strip()
        return super().train(resume)

    # --------------------------------------------------------- validation

    def validate(self, state: EnsembleState, loader, epoch, eval_target=False):
        """Every member and the seed mean in one pass (one fbank launch a
        batch). Returns the seed mean's (stats, loss), which the trainer and
        the protocol read; the members' mAPs go to seed_result.csv."""
        preds, targets, losses = [], [], []
        with contextlib.closing(prefetch_to_device(
                iter(loader), self.device, depth=self.config.device_prefetch)) as batches:
            for host_batch, batch in batches:
                out, per_sample = self.eval_step(state, batch)
                n_valid = int(host_batch["n_valid"])
                preds.append(out[:, :n_valid])
                targets.append(host_batch["labels"][:n_valid])
                losses.append(per_sample[:, :n_valid])
        output = torch.cat(preds, dim=1).cpu().numpy()  # [E, N, C], one fetch a pass
        target = np.concatenate(targets)
        loss = float(np.mean(torch.cat(losses, dim=1).cpu().numpy()))
        member_stats = [calculate_stats(output[i], target) for i in range(self.num_seeds)]
        mean_pred = output.mean(axis=0)
        stats = calculate_stats(mean_pred, target)

        pred_dir = os.path.join(self.exp_dir, "predictions")
        self._write_target_csv(pred_dir, "target.csv", target)
        np.savetxt(os.path.join(pred_dir, f"predictions_{epoch}.csv"), mean_pred,
                   delimiter=",")
        for i in range(self.num_seeds):
            np.savetxt(os.path.join(pred_dir, f"predictions_{epoch}_seed{i}.csv"), output[i],
                       delimiter=",")
            # keep only the latest epoch's member matrices, as the reference
            # bounds its per-epoch CSVs (traintest.py:288)
            if isinstance(epoch, int) and epoch > 1:
                prev = os.path.join(pred_dir, f"predictions_{epoch - 1}_seed{i}.csv")
                if os.path.exists(prev):
                    os.remove(prev)
        if eval_target:
            self._write_target_csv(pred_dir, "eval_target.csv", target)
        member_maps = [float(np.mean([s["AP"] for s in ms])) for ms in member_stats]
        ens_map = float(np.mean([s["AP"] for s in stats]))
        self._write_seed_result(epoch, member_maps, ens_map)
        print(f"[{epoch}] seed mAPs: " + " ".join(f"{m:.4f}" for m in member_maps)
              + f" | seed-ensemble mAP: {ens_map:.4f}")
        return stats, loss
