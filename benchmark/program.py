"""The benchmark's hand-over to the program under test, ``psla_tpu_torch``:
the configuration's model with the benchmark's weights, the preprocessing
and the schedule the configuration states, and a step's draws in the
program's types. Only the drivers import this module; the reference never
does.
"""

from __future__ import annotations

import numpy as np
import torch

from psla_tpu_torch.frontend.augment import MaskDraws, MixupDraws
from psla_tpu_torch.frontend.fbank import FbankConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig, PreprocessDraws
from psla_tpu_torch.models import create_model
from psla_tpu_torch.train.optim import psla_lr_schedule
from psla_tpu_torch.train.step import TrainDraws

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def preprocess_config(config: dict) -> PreprocessConfig:
    return PreprocessConfig(
        fbank=FbankConfig(sample_frequency=float(config["sample_rate"]),
                          num_mel_bins=config["num_mel_bins"]),
        target_length=config["target_length"], freq_mask=config["freqm"],
        time_mask=config["timem"], mixup_rate=config["mixup"],
        norm_mean=config["dataset_mean"], norm_std=config["dataset_std"])


def model(config: dict, weights: dict[str, torch.Tensor], dtype: str = "float32"
          ) -> torch.nn.Module:
    """The configuration's model (``create_model``) holding ``weights``, on
    their device, in eval mode."""
    m = create_model(config["model"], label_dim=config["n_class"], eff_b=config["eff_b"],
                     head_num=config["att_head"], dtype=DTYPES[dtype],
                     bn_momentum=config["bn_momentum"])
    m.to(next(iter(weights.values())).device)
    m.load_state_dict(weights)
    return m


def schedule(config: dict):
    return psla_lr_schedule(config["lr"], config["steps_per_epoch"],
                            config["lrscheduler_start"], config["lrscheduler_decay"])


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of step ``step``'s draws: a fixed function of the run's
    seed and the step."""
    words = np.random.SeedSequence([int(seed), 7, int(step)]).generate_state(2)
    return torch.Generator(device=device).manual_seed(int(words[0]) | int(words[1]) << 31)


def make_draws(gen: torch.Generator, batch: int, drop_rates: list[float]) -> dict:
    """One step's draws: the mixup gate and lambda ~ Beta(10, 10) (the 10th
    of 19 sorted uniforms), the two masks' uniforms, and the drop-connect
    keep masks ([blocks, batch] bool), on the generator's device."""
    def u(*shape):
        return torch.rand(shape, generator=gen, device=gen.device)

    gate, lam = u(batch), u(batch, 19).sort(dim=1).values[:, 9]
    draws = {"mix_gate": gate, "mix_lam": lam, "freq_value": u(batch),
             "freq_start": u(batch), "time_value": u(batch), "time_start": u(batch)}
    if drop_rates:
        keep_prob = 1.0 - torch.tensor(drop_rates, device=gen.device)
        draws["keep"] = u(len(drop_rates), batch) < keep_prob[:, None]
    return draws


def train_draws(draws: dict) -> TrainDraws:
    """The benchmark's draws as the program's ``TrainDraws``."""
    pre = PreprocessDraws(MixupDraws(draws["mix_gate"], draws["mix_lam"]),
                          MaskDraws(draws["freq_value"], draws["freq_start"]),
                          MaskDraws(draws["time_value"], draws["time_start"]), None)
    return TrainDraws(pre, draws.get("keep"))
