"""The kaldi log-mel fbank and the PSLA recipe's waveform and log-mel
augmentations, in plain PyTorch.

The fbank is ``torchaudio.compliance.kaldi.fbank`` as the PSLA reference
calls it (src/dataloaders/audioset_dataset.py:119-120): htk_compat,
use_energy off, a symmetric Hann window, 128 mel bins, dither 0, 25 ms
frames every 10 ms with snip_edges, per-frame DC removal, pre-emphasis
0.97, the power spectrum of the frame zero-padded to 512 points, mel banks
from 20 Hz to Nyquist, and log(max(mel, float32 eps)). The spectrum is
taken in float64 from the float32 frames and rounded to float32 before the
banks: more exact than a float32 FFT, whose error relative to a frame's
energy shows in the log of its quietest bands. Frames past a clip's true
length are zero, and the time axis is cut or zero-padded to the target
(audioset_dataset.py:125-132).

The augmentations take their random draws as tensors, which the benchmark
makes from its seed and hands to the program too:

* mixup (audioset_dataset.py:94-117): both clips DC-removed over their
  own lengths, the partner cut to the primary's length, lam * w1 +
  (1 - lam) * w2 DC-removed again, labels mixed by lam; a clip whose gate
  draw is not below the mixup rate keeps its own waveform, DC-removed, and
  its own labels;
* SpecAugment as torchaudio's FrequencyMasking / TimeMasking draw it: width
  floor(u1 * param), start floor(u2 * (size - u1 * param)), masked to 0
  before normalization;
* normalization (x - mean) / std.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = float(np.finfo(np.float32).eps)


def window_size(sample_rate: float) -> int:
    return int(sample_rate * 0.025)


def window_shift(sample_rate: float) -> int:
    return int(sample_rate * 0.010)


def buffer_length(frames: int, sample_rate: float = 16000.0) -> int:
    """The fewest samples that give ``frames`` frames."""
    return (frames - 1) * window_shift(sample_rate) + window_size(sample_rate)


def valid_frames(length: int, sample_rate: float = 16000.0) -> int:
    ws, sh = window_size(sample_rate), window_shift(sample_rate)
    return 0 if length < ws else 1 + (length - ws) // sh


def _mel(freq):
    return 1127.0 * np.log1p(np.asarray(freq, np.float64) / 700.0)


def mel_banks(num_bins: int, nfft: int, sample_rate: float,
              low_freq: float = 20.0) -> np.ndarray:
    """[num_bins, nfft // 2 + 1] triangular kaldi banks, float32 (the
    Nyquist column zero, as torchaudio pads it)."""
    high_freq = 0.5 * sample_rate
    bins = nfft // 2
    lo, hi = _mel(low_freq), _mel(high_freq)
    delta = (hi - lo) / (num_bins + 1)
    b = np.arange(num_bins, dtype=np.float64)[:, None]
    left, center, right = lo + b * delta, lo + (b + 1) * delta, lo + (b + 2) * delta
    mel = _mel(sample_rate / nfft * np.arange(bins))[None, :]
    tri = np.maximum(0.0, np.minimum((mel - left) / (center - left),
                                     (right - mel) / (right - center)))
    out = np.zeros((num_bins, bins + 1), np.float32)
    out[:, :bins] = tri.astype(np.float32)
    return out


def hann(size: int) -> np.ndarray:
    n = np.arange(size, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / (size - 1))).astype(np.float32)


def logmel(wav: torch.Tensor, lengths: torch.Tensor, target_frames: int,
           num_mel_bins: int = 128, sample_rate: float = 16000.0) -> torch.Tensor:
    """[B, N] float32 waveforms with [B] true lengths -> [B, target, mels]."""
    ws, sh = window_size(sample_rate), window_shift(sample_rate)
    nfft = 1 << (ws - 1).bit_length()
    frames = wav.float().unfold(-1, ws, sh)  # [B, M, ws]
    x = frames - frames.mean(dim=-1, keepdim=True)
    x = x - 0.97 * torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    x = x * torch.from_numpy(hann(ws)).to(x.device)
    spec = torch.fft.rfft(x.double(), n=nfft)
    power = (spec.real ** 2 + spec.imag ** 2).float()
    banks = torch.from_numpy(mel_banks(num_mel_bins, nfft, sample_rate)).to(x.device)
    out = torch.log(torch.clamp_min(power @ banks.T, EPS))
    m = out.shape[1]
    n_valid = torch.tensor([valid_frames(int(n), sample_rate) for n in lengths.tolist()],
                           device=wav.device)
    out = torch.where(torch.arange(m, device=wav.device)[None, :, None]
                      < n_valid[:, None, None], out, 0.0)
    if m >= target_frames:
        return out[:, :target_frames]
    return torch.nn.functional.pad(out, (0, 0, 0, target_frames - m))


def _valid(lengths: torch.Tensor, n: int) -> torch.Tensor:
    return torch.arange(n, device=lengths.device)[None, :] < lengths[:, None]


def dc_remove(wav: torch.Tensor, mean: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """The clip's mean (over its true length) removed; padding stays 0."""
    return torch.where(_valid(lengths, wav.shape[1]), wav - mean[:, None], 0.0)


def mixup(wav, mean, lengths, labels, mix_wav, mix_mean, mix_lengths, mix_labels,
          gate, lam, rate: float):
    """(waveforms, labels) after the recipe's mixup, from the draws."""
    n = wav.shape[1]
    valid = _valid(lengths, n)
    w1 = torch.where(valid, wav - mean[:, None], 0.0)
    w2 = torch.where(_valid(mix_lengths, n) & valid, mix_wav - mix_mean[:, None], 0.0)
    mixed = lam[:, None] * w1 + (1.0 - lam[:, None]) * w2
    mixed_mean = mixed.sum(dim=1) / lengths.clamp(min=1).float()
    mixed = torch.where(valid, mixed - mixed_mean[:, None], 0.0)
    do_mix = gate < rate
    lam = torch.where(do_mix, lam, 1.0)
    out_labels = lam[:, None] * labels + (1.0 - lam)[:, None] * mix_labels
    return torch.where(do_mix[:, None], mixed, w1), out_labels


def keep_mask(value: torch.Tensor, start: torch.Tensor, size: int,
              param: int) -> torch.Tensor:
    """[B, size] 1 where kept, 0 in the mask torchaudio draws from (value, start)."""
    width = torch.floor(value * param)
    first = torch.floor(start * (size - value * param))
    idx = torch.arange(size, dtype=torch.float32, device=value.device)[None, :]
    masked = (idx >= first[:, None]) & (idx < first[:, None] + width[:, None])
    return (~masked).float()


def normalize(x: torch.Tensor, mean: float, std: float) -> torch.Tensor:
    return (x - mean) / std


def train_input(batch: dict, draws: dict, recipe: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """A host batch (int16 waveforms and their partners) and a step's draws
    -> (normalized log-mel [B, T, F], mixed labels [B, C]) by the recipe."""
    def wav(key):
        return batch[key].float() * 2.0 ** -15

    x, labels = mixup(wav("wav"), batch["wav_mean"], batch["length"], batch["labels"],
                      wav("mix_wav"), batch["mix_wav_mean"], batch["mix_length"],
                      batch["mix_labels"], draws["mix_gate"], draws["mix_lam"],
                      recipe["mixup"])
    fb = logmel(x, batch["length"], recipe["target_length"], recipe["num_mel_bins"],
                recipe["sample_rate"])
    _, t, f = fb.shape
    fb = fb * keep_mask(draws["freq_value"], draws["freq_start"], f, recipe["freqm"])[:, None, :]
    fb = fb * keep_mask(draws["time_value"], draws["time_start"], t, recipe["timem"])[:, :, None]
    return normalize(fb, recipe["dataset_mean"], recipe["dataset_std"]), labels


def eval_input(wav: torch.Tensor, lengths: torch.Tensor, recipe: dict) -> torch.Tensor:
    """[B, N] float32 clips (zero past their lengths) -> normalized log-mel:
    DC removal over the true length, the fbank, the cut to the target."""
    n = wav.shape[1]
    valid = _valid(lengths, n)
    mean = torch.where(valid, wav, 0.0).sum(dim=1) / lengths.clamp(min=1).float()
    x = dc_remove(wav, mean, lengths)
    fb = logmel(x, lengths, recipe["target_length"], recipe["num_mel_bins"],
                recipe["sample_rate"])
    return normalize(fb, recipe["dataset_mean"], recipe["dataset_std"])

