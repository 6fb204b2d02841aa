"""The ensemble trainer: E independent seeds trained in lockstep, on one
card or on several ranks (port of ``psla_tpu/train/ensemble_loop.py``).

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

Several ranks (``--num-devices W``): ``parallel.ensemble.ensemble_layout``
splits the W ranks into rows of R ranks; each row trains E / rows members
data-parallel over its R ranks, and every row sees the same batches (each
rank's loader is sharded by its position within its row,
``cli.make_loaders``; ``_check_loader_shards`` refuses a loader sharded
by the global rank). The stacked checkpoint is gathered to rank 0, which
alone writes it, so it is the same file whatever the layout, and a run
resumes from it at any W. Validation gathers every row's members and every
position's rows into [E, N, C] in the dataset's order; rank 0 writes.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from psla_tpu_torch.data.device_prefetch import prefetch_to_device
from psla_tpu_torch.metrics import calculate_stats
from psla_tpu_torch.parallel.distributed import (
    barrier,
    gather_valid,
    is_primary,
    process_info,
)
from psla_tpu_torch.parallel.ensemble import (
    EnsembleState,
    ensemble_layout,
    ensemble_member,
    gather_seeds,
    init_ensemble_state,
    local_members,
    make_ensemble_eval_step,
    make_ensemble_train_step,
    place_members,
)
from psla_tpu_torch.parallel.mesh import Mesh, make_mesh
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

    def _make_mesh(self) -> Mesh:
        """The ensemble mesh: ``ensemble_layout``'s rows over the ranks; on
        several ranks, first the loaders' shards are checked against it."""
        rank, world = process_info()
        rows, position, per_row = ensemble_layout(self.num_seeds, world, rank, world)
        if world > 1:
            self._check_loader_shards(position, per_row)
        return make_mesh(self.config.num_devices, self.device, ensemble=rows)

    @property
    def members(self) -> range:
        """The global indices of this rank's members (its row's)."""
        return local_members(self.num_seeds, self.mesh)

    def _build_steps(self):
        self.train_step = make_ensemble_train_step(self.pre_config, self.config.loss,
                                                   self.mesh)
        self.eval_step = make_ensemble_eval_step(self.pre_config, self.config.loss)

    def _check_loader_shards(self, position: int, per_row: int):
        """The rows see the same batches, so each loader must be sharded by
        this rank's position within its row (``cli.make_loaders`` does it);
        a loader sharded by the global rank would feed the replicas of a
        member different rows. Raises for such a loader (JAX
        ``EnsembleTrainer._check_loader_shards``)."""
        for name in ("train_loader", "val_loader", "eval_loader"):
            loader = getattr(self, name)
            if loader is None:
                continue
            got = (loader.config.host_id, loader.config.num_hosts)
            if got != (position, per_row):
                raise ValueError(
                    f"EnsembleTrainer: {name} is sharded as {got[0]}/{got[1]} but this "
                    f"rank's position within its ensemble row is {position}/{per_row}; "
                    "build the loaders with the ensemble_layout-remapped shard "
                    "(cli.make_loaders does this)")

    # ------------------------------------------------------------- state

    def init_state(self) -> EnsembleState:
        """Member i freshly initialised from seed + i (member 0 is the single
        model's init), overlaid with the pretrained file if any: this rank's
        row's members, replicated over the row."""
        cfg = self.config
        state = init_ensemble_state(self._new_model, [cfg.seed + i for i in self.members],
                                    self.schedule, device=self.device, mesh=self.mesh)
        sd = self._pretrained()
        if sd is not None:
            self._overlay_pretrained(sd, state)
        return place_members(state)

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
        """Global step ``step``'s draws of each local member for the global
        batch, each from its own generator (``step_generator`` with the
        member's global index)."""
        return [draw_train(step_generator(self.config.seed, step, self.device, member=i),
                           self.model, batch_size, self.pre_config)
                for i in self.members]

    # ------------------------------------------------------- checkpointing

    @staticmethod
    def _stacked(payloads: list[dict]) -> dict:
        """The stacked checkpoint of the E members' payloads
        (``ensemble_member``): {"step", "seeds": E, "model": every
        state_dict entry stacked along a leading seed axis, "optimizer": the
        members' Adam state_dicts}. Weight averaging averages it entry by
        entry."""
        sds = [p["model"] for p in payloads]
        return {"step": payloads[0]["step"], "seeds": len(sds),
                "model": {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]},
                "optimizer": [p["optimizer"] for p in payloads]}

    def save_checkpoint(self, state: EnsembleState, tag):
        """Every member gathered (a collective), then rank 0 writes the
        stacked checkpoint and, for 'best' and 'wa', each member alone; every
        rank waits until the files are there."""
        payloads = [ensemble_member(state, i) for i in range(self.num_seeds)]
        if is_primary():
            self._write_checkpoint(self._stacked(payloads), tag)
            if str(tag) in ("best", "wa"):
                for i, payload in enumerate(payloads):
                    self._write_checkpoint(payload, f"{tag}_seed{i}")
        barrier(f"checkpoint_{tag}")

    def _state_from(self, ckpt: dict) -> EnsembleState:
        """This rank's members of a stacked checkpoint (or of weight
        averaging's stacked mean, which has no optimizer: fresh Adams), each
        replicated over the row (``Trainer._state_from``)."""
        if ckpt.get("seeds", self.num_seeds) != self.num_seeds:
            raise ValueError(f"the checkpoint holds {ckpt['seeds']} ensemble members, "
                             f"--ensemble-seeds asks for {self.num_seeds}")
        members = []
        for i in self.members:
            one = {"step": ckpt["step"], "model": {k: v[i] for k, v in ckpt["model"].items()}}
            if "optimizer" in ckpt:
                one["optimizer"] = ckpt["optimizer"][i]
            members.append(super()._state_from(one))
        return EnsembleState(members, self.mesh)

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
        batch on each rank). Returns the seed mean's (stats, loss), which the
        trainer and the protocol read; the members' mAPs go to
        seed_result.csv. On several ranks each evaluates its loader shard
        with its row's members; every rank gets all members' rows in the
        dataset's order (``gather_seeds`` over the rows, then
        ``gather_valid`` over the positions) and rank 0 writes."""
        preds, targets, losses, valid = [], [], [], []
        with contextlib.closing(prefetch_to_device(
                iter(loader), self.device, depth=self.config.device_prefetch)) as batches:
            for host_batch, batch in batches:
                out, per_sample = self.eval_step(state, batch)
                preds.append(out)
                targets.append(host_batch["labels"])
                losses.append(per_sample)
                valid.append(np.arange(out.shape[1]) < int(host_batch["n_valid"]))
        valid = np.concatenate(valid)
        output, loss_rows = (  # [E, N, C] and [E, N]
            gather_valid(gather_seeds(torch.cat(rows, dim=1), self.mesh), valid, axis=1,
                         mesh=self.mesh) for rows in (preds, losses))
        target = gather_valid(np.concatenate(targets), valid, mesh=self.mesh)
        loss = float(np.mean(loss_rows))
        member_stats = [calculate_stats(output[i], target) for i in range(self.num_seeds)]
        mean_pred = output.mean(axis=0)
        stats = calculate_stats(mean_pred, target)
        member_maps = [float(np.mean([s["AP"] for s in ms])) for ms in member_stats]
        ens_map = float(np.mean([s["AP"] for s in stats]))
        if is_primary():
            self._write_validation(epoch, target, mean_pred, output, eval_target)
            self._write_seed_result(epoch, member_maps, ens_map)
        barrier(f"validate_{epoch}")  # the protocol reads the CSVs next
        print(f"[{epoch}] seed mAPs: " + " ".join(f"{m:.4f}" for m in member_maps)
              + f" | seed-ensemble mAP: {ens_map:.4f}")
        return stats, loss

    def _write_validation(self, epoch, target, mean_pred, output, eval_target: bool):
        """The target matrix, the seed mean's predictions and each member's
        (rank 0)."""
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
