"""Waveform and fbank transforms: DC removal, normalize, and the training
augmentations (port of ``psla_tpu/frontend/augment.py``).

The reference's dataloader augmentations
(src/dataloaders/audioset_dataset.py:139-199) as functions of tensors:

  * SpecAugment: one frequency and one time mask per sample, as
    ``torchaudio.transforms.FrequencyMasking/TimeMasking`` draw them
    (``_mask_axis``), masked bins set to 0.
  * Mixup: waveform-domain mixing with lambda ~ Beta(10, 10) under a
    Bernoulli(mixup_rate) gate, partners supplied by the caller.
  * Noise: fbank + U[0,1] * u / 10 and a time roll in [-10, 10).

Every augmentation takes its random draws as tensors; ``draw_*`` makes
them from a ``torch.Generator`` on the generator's device. The JAX package
draws them from ``jax.random`` keys inside the same functions, so the tests
hand its draws to these.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def dc_remove(
    wav: torch.Tensor, wav_mean: torch.Tensor, lengths: torch.Tensor
) -> torch.Tensor:
    """Single-sample DC removal (audioset_dataset.py:91-92) on [B, N] buffers:
    subtract the clip mean over the true length, keep the padding at 0."""
    pos = torch.arange(wav.shape[-1], device=wav.device)[None, :]
    valid = pos < lengths[:, None]
    return torch.where(valid, wav - wav_mean[:, None], 0.0)


def normalize(fbank: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    """(x - mean) / std (audioset_dataset.py:190-192)."""
    return (fbank - mean) / std


# ------------------------------------------------------------------ draws


def _uniform(generator: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def sample_beta_10_10(generator: torch.Generator, n: int) -> torch.Tensor:
    """[n] draws of Beta(10, 10): the 10th smallest of 19 U(0, 1) draws.

    The k-th order statistic of m uniforms is Beta(k, m + 1 - k) exactly.
    torch's ``Beta`` takes no generator, so this is how a step's lambda
    comes from the caller's generator."""
    return _uniform(generator, n, 19).sort(dim=1).values[:, 9]


class MixupDraws(NamedTuple):
    gate: torch.Tensor  # [B] U(0, 1): mix where gate < mixup_rate
    lam: torch.Tensor  # [B] Beta(10, 10)


class MaskDraws(NamedTuple):
    """The two uniforms of one torchaudio mask per sample ([B] each)."""

    value: torch.Tensor
    start: torch.Tensor


class NoiseDraws(NamedTuple):
    u: torch.Tensor  # [B] U(0, 1): the noise level over 10
    noise: torch.Tensor  # [B, T, F] U(0, 1)
    shift: torch.Tensor  # [B] int64 in [-10, 10)


def draw_mixup(generator: torch.Generator, batch: int) -> MixupDraws:
    return MixupDraws(_uniform(generator, batch), sample_beta_10_10(generator, batch))


def draw_mask(generator: torch.Generator, batch: int) -> MaskDraws:
    return MaskDraws(_uniform(generator, batch), _uniform(generator, batch))


def draw_noise(generator: torch.Generator, batch: int, frames: int,
               bins: int) -> NoiseDraws:
    shift = torch.randint(-10, 10, (batch,), generator=generator,
                          device=generator.device)
    return NoiseDraws(_uniform(generator, batch),
                      _uniform(generator, batch, frames, bins), shift)


# ------------------------------------------------------------ augmentations


def _mask_axis(draws: MaskDraws, size: int, mask_param: int) -> torch.Tensor:
    """[B, size] float32 keep-masks (1 keep, 0 masked), one per sample.

    torchaudio.functional.mask_along_axis: value = u1 * mask_param and
    min_value = u2 * (size - value) as continuous float32 numbers, then the
    INTEGER range [floor(min_value), floor(min_value) + floor(value)) is
    masked (value 0.9 masks nothing)."""
    value = draws.value * mask_param
    min_value = draws.start * (size - value)
    start = torch.floor(min_value)[:, None]
    width = torch.floor(value)[:, None]
    idx = torch.arange(size, dtype=torch.float32, device=value.device)[None, :]
    masked = (idx >= start) & (idx < start + width)
    return torch.where(masked, 0.0, 1.0)


def spec_augment(
    fbank: torch.Tensor,
    freq: MaskDraws,
    time: MaskDraws,
    freq_mask: int,
    time_mask: int,
) -> torch.Tensor:
    """Per-sample SpecAugment on [B, T, F] log-mels (fill value 0), before
    normalize as in the reference (audioset_dataset.py:176-195), so masked
    bins become (0 - mean) / std."""
    _, t, f = fbank.shape
    out = fbank
    if freq_mask != 0:
        out = out * _mask_axis(freq, f, freq_mask)[:, None, :]
    if time_mask != 0:
        out = out * _mask_axis(time, t, time_mask)[:, :, None]
    return out


def mixup_waveforms(
    wav: torch.Tensor,
    wav_mean: torch.Tensor,
    lengths: torch.Tensor,
    partner_wav: torch.Tensor,
    partner_mean: torch.Tensor,
    partner_lengths: torch.Tensor,
    labels: torch.Tensor,
    partner_labels: torch.Tensor,
    draws: MixupDraws,
    mixup_rate: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Waveform-domain mixup over [B, N] zero-padded buffers
    (_wav2fbank's mixup branch, audioset_dataset.py:94-117,147-165):

      1. both waveforms DC-removed over their true lengths,
      2. the partner cut or zero-padded to the primary's length,
      3. mix = lam * w1 + (1 - lam) * w2,
      4. the mix DC-removed again over the primary's length,
      5. labels = lam * labels1 + (1 - lam) * labels2.

    Samples the gate leaves out get single-sample DC removal and their own
    labels. Returns (wav [B, N], labels [B, C], lam [B], 1 where unmixed).
    """
    n = wav.shape[1]
    do_mix = draws.gate < mixup_rate
    lam = draws.lam
    pos = torch.arange(n, device=wav.device)[None, :]
    valid1 = pos < lengths[:, None]
    w1 = torch.where(valid1, wav - wav_mean[:, None], 0.0)
    valid2 = (pos < partner_lengths[:, None]) & valid1
    w2 = torch.where(valid2, partner_wav - partner_mean[:, None], 0.0)

    mix = lam[:, None] * w1 + (1.0 - lam[:, None]) * w2
    mix_mean = mix.sum(dim=1) / lengths.clamp(min=1).float()
    mix = torch.where(valid1, mix - mix_mean[:, None], 0.0)

    out_wav = torch.where(do_mix[:, None], mix, w1)
    lam_eff = torch.where(do_mix, lam, 1.0)
    out_labels = lam_eff[:, None] * labels + (1.0 - lam_eff)[:, None] * partner_labels
    return out_wav, out_labels, lam_eff


def add_noise(fbank: torch.Tensor, draws: NoiseDraws) -> torch.Tensor:
    """Reference noise augmentation (audioset_dataset.py:197-199): fbank +
    noise * u / 10, then each sample rolled along time by its shift."""
    t = fbank.shape[1]
    out = fbank + draws.noise * draws.u[:, None, None] / 10.0
    idx = (torch.arange(t, device=fbank.device)[None, :] - draws.shift[:, None]) % t
    return torch.gather(out, 1, idx[:, :, None].expand_as(out))
