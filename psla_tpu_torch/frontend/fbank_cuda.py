"""The log-mel fbank as one hand-written CUDA kernel for Hopper (sm_90a).

Replaces the TPU kernel ``psla_tpu/frontend/fbank_pallas.py::_fbank_kernel``
(launched by ``fbank_pallas``). The kernel is ``psla_tpu_torch/csrc/fbank.cu``;
its source note gives the bound on an H100 (bytes: ~6 us for the 16-clip
serving micro-batch) and the design: a real FFT in each warp and the mel
banks' non-zeros, in place of the TPU kernel's two dense products.

``fbank_cuda`` is its wrapper and ``fbank_plain`` its plain version (the
'fft64' lowering of ``fbank.py``: the kernel's order of operations and its
float64 spectrum, with the same frame-count rule and the same padding to
``target_frames``). A tensor on the CPU takes the plain version; a CUDA
tensor launches the kernel or raises. The library is compiled by ``nvcc``
from the source in this package at first use (``cuda_build``).
``LAUNCHES`` counts the kernel's launches.

``kernel_tables`` builds the kernel's constants: the window, the twiddle
factors of the FFT (float64, computed on the host), and the banks as runs
of bins with their packed weights.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from psla_tpu_torch.cuda_build import CudaLibrary
from psla_tpu_torch.frontend.fbank import (
    FbankConfig,
    _window_np,
    fbank_batched,
    mel_bank_runs,
    pad_or_truncate,
)

# Launches of the kernel in this process (the plain version does not count).
LAUNCHES = 0

# Limits shared with csrc/fbank.cu: the FFT length, and the mel bins (4 a
# lane).
_MAX_NFFT, _MAX_MELS = 512, 128


def _bind(lib: ctypes.CDLL):
    lib.psla_fbank_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_double, ctypes.c_void_p]
    )
    lib.psla_fbank_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("fbank.cu", "psla_fbank", _bind)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns the handle."""
    return LIBRARY.load()


def fft_layout(config: FbankConfig) -> tuple[int, int, int]:
    """(half, lanes, regs): the real FFT of ``padded_window_size`` points is
    a complex FFT of ``half`` = nfft/2 points, held by a warp as ``lanes``
    lanes (min(32, half); lanes past them mirror these) of ``regs`` points
    each; point n lies in lane n % lanes, register n // lanes."""
    half = config.padded_window_size // 2
    lanes = min(32, half)
    return half, lanes, half // lanes


@functools.lru_cache(maxsize=None)
def kernel_tables(config: FbankConfig) -> dict[str, np.ndarray]:
    """The kernel's constants.

    * ``window`` [window_size] float32: the window of ``config.window_type``
      (the plain version's).
    * ``twiddle`` [half + 1, 2] float64: W^k = exp(-2 pi i k / nfft),
      k = 0..half (cos, -sin): the split of the packed FFT into the real
      FFT's bins, and the butterflies' factors (W_2h^j = W^(j * half / h)).
    * ``twiddle2`` [regs, lanes, 2] float64: exp(-2 pi i a k2 / half), the
      factor between the in-register and the across-lane steps, for lane a
      and in-register bin k2.
    * ``mel_runs`` [n_mels, 3] int32 and ``mel_weights``: the banks'
      non-zeros (``fbank.mel_bank_runs``).
    """
    nfft = config.padded_window_size
    if not 2 <= nfft <= _MAX_NFFT:
        raise ValueError(f"fbank_cuda takes padded_window_size 2..{_MAX_NFFT}, got {nfft}")
    half, lanes, regs = fft_layout(config)
    ang = -2.0 * np.pi * np.arange(half + 1, dtype=np.float64) / nfft
    ang2 = (-2.0 * np.pi / half) * np.outer(np.arange(regs), np.arange(lanes)).astype(np.float64)
    runs, weights = mel_bank_runs(config)
    return {
        "window": _window_np(config).astype(np.float32),
        "twiddle": np.stack([np.cos(ang), np.sin(ang)], -1),
        "twiddle2": np.stack([np.cos(ang2), np.sin(ang2)], -1),
        "mel_runs": runs,
        "mel_weights": weights,
    }


@functools.lru_cache(maxsize=None)
def _device_tables(config: FbankConfig, device: torch.device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in kernel_tables(config).items()}


def fbank_plain(
    wav: torch.Tensor,
    lengths: torch.Tensor | None,
    config: FbankConfig,
    target_frames: int,
) -> torch.Tensor:
    """The kernel's plain version: [B, N] -> [B, target_frames, n_mels]."""
    logmel, _ = fbank_batched(wav, lengths, config=config, method="fft64")
    return pad_or_truncate(logmel, target_frames)


def fbank_cuda(
    wav: torch.Tensor,
    lengths: torch.Tensor | None = None,
    config: FbankConfig = FbankConfig(),
    target_frames: int = 1056,
) -> torch.Tensor:
    """Fused log-mel fbank: [B, N] waveforms -> [B, target_frames, n_mels].

    ``lengths`` ([B] int32) gives each buffer's true sample count; frames
    that would read past it (or past N) are zero, as is the padding up to
    ``target_frames``.
    """
    if wav.dim() != 2:
        raise ValueError(f"wav must be [B, N], got {tuple(wav.shape)}")
    if lengths is not None and tuple(lengths.shape) != (wav.shape[0],):
        raise ValueError(
            f"lengths must be [{wav.shape[0]}], got {tuple(lengths.shape)}"
        )
    if wav.device.type == "cpu":
        return fbank_plain(wav, lengths, config, target_frames)
    if wav.device.type != "cuda":
        raise ValueError(f"fbank_cuda: unsupported device {wav.device}")
    if wav.dtype != torch.float32 or not wav.is_contiguous():
        raise ValueError("fbank_cuda: wav must be contiguous float32")
    if lengths is not None and (
        lengths.dtype != torch.int32 or lengths.device != wav.device
        or not lengths.is_contiguous()
    ):
        raise ValueError("fbank_cuda: lengths must be contiguous int32 on wav's device")
    n_mels = config.num_mel_bins
    if n_mels > _MAX_MELS:
        raise ValueError(f"fbank_cuda takes at most {_MAX_MELS} mel bins, got {n_mels}")
    tables = _device_tables(config, wav.device)  # raises on an FFT length it cannot take
    b, n = wav.shape
    if b > 65535:
        raise ValueError(f"fbank_cuda takes at most 65535 clips, got {b}")
    out = torch.empty((b, target_frames, n_mels), dtype=torch.float32,
                      device=wav.device)
    lib = build()
    err = lib.psla_fbank_launch(
        wav.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        *(tables[k].data_ptr() for k in ("window", "twiddle", "twiddle2",
                                         "mel_runs", "mel_weights")),
        out.data_ptr(),
        b, n, target_frames, config.window_size, config.window_shift,
        config.padded_window_size, n_mels, int(config.remove_dc_offset),
        config.preemphasis_coefficient,
        torch.cuda.current_stream(wav.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fbank kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
