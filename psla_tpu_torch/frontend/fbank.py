"""Kaldi-compatible log-mel filterbank on torch tensors.

The port of ``psla_tpu/frontend/fbank.py``. Plain lowerings on whatever
device the waveform lies on, float32 unless named otherwise:

  * ``method='fft'``  -- per-frame DC removal, pre-emphasis and window in the
    golden order, then ``torch.fft.rfft``. Tightest parity with kaldi.
  * ``method='fft64'`` -- the same, with the per-frame chain, the rFFT and
    the power spectrum in float64 (from the float32 samples), the power
    rounded to float32 before the mel banks. This is the order and the
    precision of the CUDA kernel (``fbank_cuda.py``), and it is that
    kernel's plain version. In float32 both other lowerings round relative
    to a frame's energy, which after pre-emphasis costs up to ~4e-3 in the
    log-mel of a frame's lowest bands.
  * ``method='gemm'`` -- the whole per-frame chain folded into ONE
    ``[window_size, 2*(nfft/2+1)]`` matrix (``frontend_matrix``), so a batch
    of frames is one matrix product:
        power = (F @ A_cos)^2 + (F @ A_sin)^2 ;  mel = power @ banks^T
    The JAX package's TPU kernel computes this form.

The constant matrices are built in float64 with numpy and cast to float32,
exactly as the JAX package builds them, so they agree bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from psla_tpu_torch.frontend import kaldi_numpy as _ref

EPSILON = float(np.finfo(np.float32).eps)


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Static fbank parameters (hashable: keys the constant caches).

    Defaults reproduce the PSLA reference call
    (src/dataloaders/audioset_dataset.py:119-120) plus kaldi defaults.
    """

    sample_frequency: float = 16000.0
    num_mel_bins: int = 128
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    window_type: str = "hanning"
    preemphasis_coefficient: float = 0.97
    remove_dc_offset: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0  # <=0 means nyquist + high_freq
    # Kept so a config reads the same in both packages; no value changes
    # the arithmetic here. The plain lowerings' matmuls are float32 (TF32 is
    # off), and the CUDA kernel computes its spectrum in float64 (up to each
    # bin's power; the mel sums and the log in float32) for all three.
    precision: str = "highest"

    @property
    def window_size(self) -> int:
        return int(self.sample_frequency * self.frame_length_ms * 0.001)

    @property
    def window_shift(self) -> int:
        return int(self.sample_frequency * self.frame_shift_ms * 0.001)

    @property
    def padded_window_size(self) -> int:
        return _ref.next_power_of_2(self.window_size)

    @property
    def num_spectrum_bins(self) -> int:
        return self.padded_window_size // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if num_samples < self.window_size:
            return 0
        return 1 + (num_samples - self.window_size) // self.window_shift

    def buffer_length(self, num_frames: int) -> int:
        """Smallest sample count that yields exactly `num_frames` frames."""
        return (num_frames - 1) * self.window_shift + self.window_size


@functools.lru_cache(maxsize=None)
def mel_banks(config: FbankConfig = FbankConfig()) -> np.ndarray:
    """[num_mel_bins, num_spectrum_bins] kaldi triangular filterbank (f32)."""
    return _ref.mel_banks_numpy(
        config.num_mel_bins,
        config.padded_window_size,
        config.sample_frequency,
        config.low_freq,
        config.high_freq,
    )


@functools.lru_cache(maxsize=None)
def mel_bank_runs(config: FbankConfig = FbankConfig()) -> tuple[np.ndarray, np.ndarray]:
    """The banks as their non-zeros: each kaldi mel row is one run of bins.

    Returns ``runs`` [num_mel_bins, 3] int32 (first bin, count, offset into
    ``weights``) and ``weights`` [sum of counts] float32, the row values from
    the first to the last non-zero bin. A row with no non-zero bin has
    count 0, so its sum is 0, as in the dense product.
    """
    banks = mel_banks(config)
    runs = np.zeros((banks.shape[0], 3), np.int32)
    weights, offset = [], 0
    for m, row in enumerate(banks):
        nz = np.flatnonzero(row)
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if nz.size else (0, 0)
        runs[m] = first, count, offset
        weights.append(row[first:first + count])
        offset += count
    return runs, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _window_np(config: FbankConfig) -> np.ndarray:
    return _ref._window(config.window_type, config.window_size)


@functools.lru_cache(maxsize=None)
def frontend_matrix(config: FbankConfig = FbankConfig()) -> np.ndarray:
    """Fold DC-removal + preemphasis + window + real DFT into one matrix.

    Returns A of shape [window_size, 2 * num_spectrum_bins] (f32) such that
    for a raw frame f (length window_size):
        y = f @ A ;  power[k] = y[k]^2 + y[k + num_spectrum_bins]^2
    equals the kaldi power spectrum of the processed frame.
    """
    ws = config.window_size
    nfft = config.padded_window_size
    nbins = config.num_spectrum_bins

    chain = np.eye(ws, dtype=np.float64)
    if config.remove_dc_offset:
        chain = chain - np.full((ws, ws), 1.0 / ws)
    c = config.preemphasis_coefficient
    if c != 0.0:
        pre = np.eye(ws) * (1.0)
        for i in range(1, ws):
            pre[i, i - 1] = -c
        pre[0, 0] = 1.0 - c
        chain = pre @ chain
    chain = np.diag(_window_np(config).astype(np.float64)) @ chain

    n = np.arange(ws, dtype=np.float64)
    k = np.arange(nbins, dtype=np.float64)[:, None]
    ang = 2.0 * np.pi * k * n[None, :] / nfft
    dft_cos = np.cos(ang)
    dft_sin = -np.sin(ang)

    a = np.concatenate([dft_cos @ chain, dft_sin @ chain], axis=0)  # [2*nbins, ws]
    return np.ascontiguousarray(a.T, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _constant(build, config: FbankConfig, device: torch.device) -> torch.Tensor:
    """``build(config)``'s numpy constant, uploaded once per device."""
    return torch.from_numpy(build(config)).to(device)


def frame_signal(wav: torch.Tensor, config: FbankConfig) -> torch.Tensor:
    """[..., N] -> [..., M, window_size] via snip-edges strided framing."""
    m = config.num_frames(wav.shape[-1])
    if m == 0:
        return wav.new_zeros(wav.shape[:-1] + (0, config.window_size))
    return wav.unfold(-1, config.window_size, config.window_shift)


def _power_spectrum_fft(frames: torch.Tensor, config: FbankConfig) -> torch.Tensor:
    """Golden-ordered per-frame ops + rFFT. frames: [..., M, window_size]."""
    x = frames
    if config.remove_dc_offset:
        x = x - x.mean(dim=-1, keepdim=True)
    c = config.preemphasis_coefficient
    if c != 0.0:
        prev = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
        x = x - c * prev
    x = x * _constant(_window_np, config, x.device)
    spec = torch.fft.rfft(x, n=config.padded_window_size)
    return spec.real**2 + spec.imag**2


def _power_spectrum_gemm(frames: torch.Tensor, config: FbankConfig) -> torch.Tensor:
    y = frames @ _constant(frontend_matrix, config, frames.device)
    nbins = config.num_spectrum_bins
    return y[..., :nbins] ** 2 + y[..., nbins:] ** 2


def fbank(
    wav: torch.Tensor,
    config: FbankConfig = FbankConfig(),
    method: str = "fft",
) -> torch.Tensor:
    """Log-mel fbank of waveform(s). [..., N] -> [..., M, num_mel_bins] f32.

    The matrix products need full float32 on the card: TF32 (about three
    digits) would cost ~1e-1 in the log-mel domain. That is PyTorch's
    default (``torch.backends.cuda.matmul.allow_tf32`` is False), and
    ``InferenceEngine`` pins it in float32 mode; nothing here changes it.
    """
    wav = wav.to(torch.float32)
    frames = frame_signal(wav, config)
    if method == "fft":
        power = _power_spectrum_fft(frames, config)
    elif method == "fft64":
        power = _power_spectrum_fft(frames.double(), config).float()
    elif method == "gemm":
        power = _power_spectrum_gemm(frames, config)
    else:
        raise ValueError(f"unknown method {method!r}")
    mel = power @ _constant(mel_banks, config, wav.device).T
    return torch.log(torch.clamp_min(mel, EPSILON))


def valid_frames(
    lengths: torch.Tensor, config: FbankConfig
) -> torch.Tensor:
    """[B] sample counts -> [B] int32 frame counts (0 below one window)."""
    ws, sh = config.window_size, config.window_shift
    frames = 1 + torch.div(lengths - ws, sh, rounding_mode="floor")
    return torch.where(lengths >= ws, frames, 0).to(torch.int32)


def fbank_batched(
    wav: torch.Tensor,
    lengths: torch.Tensor | None = None,
    config: FbankConfig = FbankConfig(),
    method: str = "fft",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fbank over fixed-size waveform buffers with true lengths.

    Args:
      wav: [B, N] zero-padded waveform buffers.
      lengths: [B] int true sample counts, or None if all buffers are full.

    Returns:
      (logmel [B, M, num_mel_bins], frame_valid [B, M] bool). Frames at or
      beyond a sample's true frame count are zeroed, reproducing the
      reference's zero-padding of short clips in the *log-mel* domain
      (src/dataloaders/audioset_dataset.py:125-132).
    """
    logmel = fbank(wav, config=config, method=method)
    m = logmel.shape[-2]
    if lengths is None:
        valid = torch.ones(logmel.shape[:-1], dtype=torch.bool, device=wav.device)
        return logmel, valid
    n_valid = valid_frames(lengths.to(wav.device), config)
    valid = torch.arange(m, device=wav.device)[None, :] < n_valid[:, None]
    logmel = torch.where(valid[..., None], logmel, 0.0)
    return logmel, valid


def pad_or_truncate(logmel: torch.Tensor, target_length: int) -> torch.Tensor:
    """Zero-pad or cut the time axis of [B, M, F] to target_length
    (audioset_dataset.py:125-132)."""
    m = logmel.shape[1]
    if m >= target_length:
        return logmel[:, :target_length, :]
    return torch.nn.functional.pad(logmel, (0, 0, 0, target_length - m))
