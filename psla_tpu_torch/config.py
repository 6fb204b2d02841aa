"""Typed experiment configuration and dataset presets (port of
``psla_tpu/config.py``).

One dataclass replaces the reference's bash-variable -> argparse -> dict
chain (egs/*/run.sh + src/run.py:25-80). It has the JAX package's fields,
defaults and presets, so both write the same ``config.json`` keys, and
beyond them AST's ``lrscheduler_step`` and its AudioSet preset. Fixes of
reference quirks kept from the JAX package: ``weight_decay`` and ``noise``
are honored (the reference ignores both flags), and ``att_head`` values
other than 4 take effect.

``unported`` refuses the one field that has no PyTorch meaning,
``compilation_cache``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from psla_tpu_torch.frontend.fbank import FbankConfig
from psla_tpu_torch.frontend.pipeline import PreprocessConfig


@dataclasses.dataclass
class ExperimentConfig:
    # data
    data_train: str = ""
    data_val: str = ""
    data_eval: Optional[str] = None
    label_csv: str = ""
    exp_dir: str = "exp/psla"
    dataset: str = "audioset"
    n_class: int = 527
    # model
    model: str = "efficientnet"
    eff_b: int = 2
    att_head: int = 4
    bn_momentum: float = 0.99  # flax convention: torch momentum 0.01 == 0.99 here
    impretrain: bool = True  # load a pretrained backbone checkpoint
    pretrained_ckpt: Optional[str] = None
    # preprocessing
    target_length: int = 1056
    num_mel_bins: int = 128
    freqm: int = 48
    timem: int = 192
    mixup: float = 0.5
    dataset_mean: float = -4.6476
    dataset_std: float = 4.5699
    noise: bool = False
    skip_norm: bool = False
    sample_rate: int = 16000
    # optimization
    lr: float = 1e-4
    weight_decay: float = 5e-7
    batch_size: int = 100
    n_epochs: int = 30
    warmup: bool = True
    # the staircase warmup: the reference hardcodes 1000 steps updated
    # every 50 (traintest.py:92-96)
    warmup_steps: int = 1000
    warmup_update_every: int = 50
    lrscheduler_start: int = 10
    lrscheduler_decay: float = 0.5
    # epochs between the decay's milestones: PSLA's 5 (traintest.py), AST's
    # lrscheduler_step (1 in its AudioSet recipe; a preset's value, no flag);
    # not in the JAX package
    lrscheduler_step: int = 5
    loss: str = "BCE"
    metrics: str = "mAP"
    # sampling
    bal: bool = True
    # weight averaging / ensembling
    wa: bool = True
    wa_start: int = 16
    wa_end: int = 30
    save_model: bool = True
    # engine
    num_workers: int = 8
    n_print_steps: int = 100
    seed: int = 0
    # compute dtype of training and validation, "float32" or "bfloat16";
    # parameters, BatchNorm statistics and Adam stay float32
    dtype: str = "float32"
    # rematerialize MBConv blocks in backward (torch.utils.checkpoint):
    # a quarter of the peak memory on the card (PERF.md)
    remat: bool = False
    # int8 compression of the depthwise convolutions' inputs (ops/qsave.py):
    # 'none', 'q8save' (the same forward, an int8 copy for backward) or 'qdq'
    act_compress: str = "none"
    # fbank lowering: 'auto' (the CUDA kernel on the card, 'fft' on the
    # CPU), 'fft', 'gemm', or 'pallas' (the kernel) -- frontend/pipeline.py
    fbank_method: str = "auto"
    # kept for the JAX package's config.json; the kernel's spectrum is
    # float64 whatever it says (frontend/fbank.py)
    fbank_precision: str = "high"
    # data parallelism: the ranks of the process group, one card each
    # (default: the group's world size; cli.run spawns N ranks on this host
    # when no launcher started the group)
    num_devices: Optional[int] = None
    # multi-seed ensemble training (train/ensemble_loop.EnsembleTrainer) when > 1
    ensemble_seeds: int = 1
    # a torch.profiler trace of train steps [profile_start_step,
    # profile_start_step + profile_steps) into {exp_dir}/profile
    profile_steps: int = 0
    profile_start_step: int = 5
    # per-epoch scalars to {exp_dir}/tb for tensorboard, beside result.csv
    tensorboard: bool = False
    # the JAX package's persistent XLA cache; no PyTorch meaning (the
    # kernels' build cache, cuda_build.py, plays its part): refused
    compilation_cache: str = ""
    # host->card waveform wire: 'int16' ships raw PCM and dequantizes on
    # the card (train/step._wav_batch), bit-exact for PCM16 sources and half
    # the bytes; 'float32' for bit-exact handling of other sources
    wire: str = "int16"
    # batches whose copy to the card runs ahead of the step, from pinned
    # buffers on a side stream (data/device_prefetch.py); 0 copies in line
    device_prefetch: int = 2

    def preprocess_config(self) -> PreprocessConfig:
        return PreprocessConfig(
            fbank=FbankConfig(
                sample_frequency=float(self.sample_rate),
                num_mel_bins=self.num_mel_bins,
                precision=self.fbank_precision,
            ),
            target_length=self.target_length,
            freq_mask=self.freqm,
            time_mask=self.timem,
            mixup_rate=self.mixup,
            norm_mean=self.dataset_mean,
            norm_std=self.dataset_std,
            skip_norm=self.skip_norm,
            noise=self.noise,
            fbank_method=self.fbank_method,
        )

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls(**json.load(f))


def unported(cfg: ExperimentConfig):
    """Raise for a setting the port refuses: the JAX package's XLA cache."""
    if cfg.compilation_cache:
        raise ValueError(
            "--compilation_cache is the JAX package's persistent XLA cache and has no "
            "PyTorch meaning: the port compiles no programs, and its kernels' build "
            "cache (cuda_build.py) plays that part")


# Presets mirroring the reference recipes (egs/*/run.sh).

FSD50K = dict(
    dataset="fsd50k", n_class=200, lr=5e-4, batch_size=24, n_epochs=40,
    wa_start=21, wa_end=40, lrscheduler_start=10, lrscheduler_decay=0.5,
    freqm=48, timem=192, mixup=0.5, bal=True, target_length=3000,
)

AUDIOSET_FULL = dict(
    dataset="audioset", n_class=527, lr=1e-4, batch_size=100, n_epochs=30,
    wa_start=16, wa_end=30, lrscheduler_start=10, lrscheduler_decay=0.5,
    freqm=48, timem=192, mixup=0.5, bal=True, target_length=1056,
)

AUDIOSET_BALANCED = dict(
    dataset="audioset", n_class=527, lr=1e-3, batch_size=100, n_epochs=60,
    wa_start=41, wa_end=60, lrscheduler_start=35, lrscheduler_decay=0.5,
    freqm=48, timem=192, mixup=0.5, bal=False, target_length=1056,
)

# The Audio Spectrogram Transformer's full-AudioSet recipe (github.com/
# YuanGongND/ast, egs/audioset/run.sh, set=full; its dataloader is PSLA's):
# AST-Base/16 from scratch (impretrain False: DeiT's ImageNet weights need a
# download), T=1024, batch 12, lr 1e-5, decay by half every epoch from 2.
AUDIOSET_FULL_AST = dict(
    dataset="audioset", n_class=527, model="ast", impretrain=False, lr=1e-5,
    batch_size=12, n_epochs=5, wa_start=1, wa_end=5, lrscheduler_start=2,
    lrscheduler_step=1, lrscheduler_decay=0.5, freqm=48, timem=192, mixup=0.5, bal=True,
    target_length=1024, dataset_mean=-4.2677393, dataset_std=4.5689974,
)

PRESETS = {
    "fsd50k": FSD50K,
    "audioset_full": AUDIOSET_FULL,
    "audioset_balanced": AUDIOSET_BALANCED,
    "audioset_full_ast": AUDIOSET_FULL_AST,
}


def from_preset(name: str, **overrides) -> ExperimentConfig:
    kwargs = dict(PRESETS[name])
    kwargs.update(overrides)
    return ExperimentConfig(**kwargs)
