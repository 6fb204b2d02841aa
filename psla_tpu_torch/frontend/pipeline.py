"""Preprocessing: waveform batch -> normalized log-mel.

Port of ``psla_tpu/frontend/pipeline.py``, in the reference's order
(src/dataloaders/audioset_dataset.py:139-202):

    eval:  DC removal -> kaldi fbank -> pad/truncate to target_length
           -> (x-mean)/std
    train: mixup (or DC removal) -> kaldi fbank -> pad/truncate
           -> SpecAugment -> (x-mean)/std -> optional noise

On a CUDA tensor the fbank is the hand-written kernel (``fbank_cuda``);
on a CPU tensor its plain lowering. The training augmentations take their
random draws as tensors (``PreprocessDraws``, made by ``draw_preprocess``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from psla_tpu_torch.frontend import augment
from psla_tpu_torch.frontend.fbank import FbankConfig, fbank_batched
from psla_tpu_torch.frontend.fbank import pad_or_truncate as _pad_or_truncate
from psla_tpu_torch.frontend.fbank_cuda import fbank_cuda

__all__ = ["PreprocessConfig", "WavBatch", "PreprocessDraws", "wav_buffer_length",
           "draw_preprocess", "preprocess_train", "preprocess_eval", "_logmel",
           "_pad_or_truncate"]


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Static preprocessing parameters (the reference's audio_conf dict,
    src/run.py:74-80). Same fields and defaults as the JAX package's."""

    fbank: FbankConfig = FbankConfig()
    target_length: int = 1056
    freq_mask: int = 48
    time_mask: int = 192
    mixup_rate: float = 0.5
    norm_mean: float = -4.6476
    norm_std: float = 4.5699
    skip_norm: bool = False
    noise: bool = False
    # 'fft' | 'fft64' | 'gemm' (plain lowerings, fbank.py; 'fft64' is the
    # kernel's plain version) | 'pallas' (the hand kernel, fbank_cuda.py; its
    # plain version on a CPU tensor) | 'auto' (the kernel for a CUDA tensor,
    # 'fft' for a CPU tensor).
    fbank_method: str = "auto"

    @property
    def num_mel_bins(self) -> int:
        return self.fbank.num_mel_bins

    def eval_variant(self) -> "PreprocessConfig":
        """The val_audio_conf analogue: no masking/mixup/noise (run.py:78-80)."""
        return dataclasses.replace(
            self, freq_mask=0, time_mask=0, mixup_rate=0.0, noise=False
        )


def wav_buffer_length(config: PreprocessConfig) -> int:
    """Waveform buffer size: the smallest sample count that covers
    target_length frames. Only the first buffer_length samples can
    influence the first target_length frames."""
    return config.fbank.buffer_length(config.target_length)


class WavBatch(NamedTuple):
    """The JAX package's WavBatch. The training fields default to None, so
    eval callers give only the first three."""

    wav: torch.Tensor  # [B, N] f32 zero-padded raw waveform buffers
    wav_mean: torch.Tensor  # [B] full-clip mean
    length: torch.Tensor  # [B] int32 true sample count, clipped to N
    labels: torch.Tensor | None = None  # [B, C] f32 multi-hot labels
    # Mixup partners (uniformly sampled over the dataset, by the caller).
    mix_wav: torch.Tensor | None = None
    mix_wav_mean: torch.Tensor | None = None
    mix_length: torch.Tensor | None = None
    mix_labels: torch.Tensor | None = None


class PreprocessDraws(NamedTuple):
    """One training batch's random draws; None where the config does not
    use them (no mixup, no mask, no noise)."""

    mixup: augment.MixupDraws | None
    freq: augment.MaskDraws | None
    time: augment.MaskDraws | None
    noise: augment.NoiseDraws | None


def draw_preprocess(generator: torch.Generator, batch: int,
                    config: PreprocessConfig) -> PreprocessDraws:
    """The draws of ``preprocess_train`` for a batch, on the generator's
    device."""
    return PreprocessDraws(
        augment.draw_mixup(generator, batch) if config.mixup_rate > 0.0 else None,
        augment.draw_mask(generator, batch) if config.freq_mask != 0 else None,
        augment.draw_mask(generator, batch) if config.time_mask != 0 else None,
        augment.draw_noise(generator, batch, config.target_length, config.num_mel_bins)
        if config.noise else None,
    )


def _logmel(
    wav: torch.Tensor, lengths: torch.Tensor | None, config: PreprocessConfig
) -> torch.Tensor:
    """fbank + pad/truncate to target_length by the configured lowering."""
    method = config.fbank_method
    if method == "auto":
        method = "pallas" if wav.is_cuda else "fft"
    if method == "pallas":
        if lengths is not None:
            lengths = lengths.to(torch.int32)
        return fbank_cuda(
            wav.contiguous(), lengths, config=config.fbank,
            target_frames=config.target_length,
        )
    logmel, _ = fbank_batched(wav, lengths, config=config.fbank, method=method)
    return _pad_or_truncate(logmel, config.target_length)


def preprocess_train(
    batch: WavBatch, draws: PreprocessDraws, config: PreprocessConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Training preprocessing. Returns (fbank [B, T, F], labels [B, C])."""
    if config.mixup_rate > 0.0:
        wav, labels, _ = augment.mixup_waveforms(
            batch.wav, batch.wav_mean, batch.length,
            batch.mix_wav, batch.mix_wav_mean, batch.mix_length,
            batch.labels, batch.mix_labels, draws.mixup, config.mixup_rate,
        )
    else:
        wav = augment.dc_remove(batch.wav, batch.wav_mean, batch.length)
        labels = batch.labels

    logmel = _logmel(wav, batch.length, config)
    logmel = augment.spec_augment(logmel, draws.freq, draws.time,
                                  config.freq_mask, config.time_mask)
    if not config.skip_norm:
        logmel = augment.normalize(logmel, config.norm_mean, config.norm_std)
    if config.noise:
        logmel = augment.add_noise(logmel, draws.noise)
    return logmel, labels


def preprocess_eval(batch: WavBatch, config: PreprocessConfig) -> torch.Tensor:
    """Eval preprocessing: DC removal -> fbank -> pad/cut -> normalize."""
    wav = augment.dc_remove(batch.wav, batch.wav_mean, batch.length)
    logmel = _logmel(wav, batch.length, config)
    if not config.skip_norm:
        logmel = augment.normalize(logmel, config.norm_mean, config.norm_std)
    return logmel
