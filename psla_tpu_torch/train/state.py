"""Training state (the counterpart of ``psla_tpu/train/state.py``).

The JAX state is an immutable pytree of (step, params, batch_stats,
opt_state). Here the model holds the parameters and BatchNorm statistics,
the optimizer its moments, and a step updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from psla_tpu_torch.models.layers import set_batchnorm_group
from psla_tpu_torch.parallel.distributed import broadcast_tensors
from psla_tpu_torch.parallel.mesh import Mesh
from psla_tpu_torch.train.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    """Everything that evolves during training.

    ``step`` is the global step: the next update uses the learning rate
    ``schedule(step)``, counted from 0.
    """

    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def place_model(model: torch.nn.Module, device: str | torch.device) -> torch.nn.Module:
    """Moves ``model`` to ``device``. A float32 model on the card switches
    TF32 off for cuDNN and cuBLAS (process-wide, as
    ``tools/serve.InferenceEngine`` does), so its convolutions and products
    are the float32 ones the JAX package computes."""
    device = torch.device(device)
    model.to(device)
    if device.type == "cuda" and getattr(model, "dtype", torch.float32) == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return model


def create_train_state(model: torch.nn.Module, schedule: Callable[[int], float],
                       step: int = 0, device: str | torch.device = "cuda") -> TrainState:
    """Moves ``model`` to ``device`` (``place_model``) and gives it a fresh
    Adam."""
    place_model(model, device)
    return TrainState(step=step, model=model,
                      optimizer=make_optimizer(model.parameters()),
                      schedule=schedule)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """The state placed on ``mesh``, in place: rank 0's model (parameters
    and BatchNorm statistics) and Adam moments copied into every rank's, as
    the JAX package places the state replicated (``psla_tpu/train/loop.py``),
    and the model's BatchNorms synced over the mesh's group (the global
    batch's statistics in train mode). A no-op at world 1."""
    if mesh.world > 1:
        tensors = list(state.model.state_dict().values())
        for moments in state.optimizer.state.values():
            tensors.extend(v for v in moments.values() if torch.is_tensor(v))
        broadcast_tensors(tensors, mesh)
        set_batchnorm_group(state.model, mesh.group)
    return state
