"""The log-mel fbank as one hand-written CUDA kernel for Hopper (sm_90a).

Replaces the TPU kernel ``psla_tpu/frontend/fbank_pallas.py::_fbank_kernel``
(launched by ``fbank_pallas``). The kernel is ``psla_tpu_torch/csrc/fbank.cu``;
its source note gives the bound on an H100 (bytes: ~6 us for the 16-clip
serving micro-batch) and the design, whose dense products do ~30x the
operations that bound counts.

``fbank_cuda`` is its wrapper and ``fbank_plain`` its plain version (the
'gemm' lowering of ``fbank.py`` with the same frame-count rule and the same
padding to ``target_frames``). A tensor on the CPU takes the plain version; a
CUDA tensor launches the kernel or raises. The library is compiled by
``nvcc`` from the source in this package at first use (``cuda_build``).
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from psla_tpu_torch.cuda_build import CudaLibrary
from psla_tpu_torch.frontend.fbank import (
    FbankConfig,
    fbank_batched,
    frontend_matrix,
    mel_banks,
    pad_or_truncate,
)

# Launches of the kernel in this process (the plain version does not count).
LAUNCHES = 0

# Tile constants shared with csrc/fbank.cu.
_KC, _NBP, _KB, _MELP = 16, 288, 64, 128


def _bind(lib: ctypes.CDLL):
    lib.psla_fbank_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    lib.psla_fbank_launch.restype = ctypes.c_int


LIBRARY = CudaLibrary("fbank.cu", "psla_fbank", _bind)


def build() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library; returns the handle."""
    return LIBRARY.load()


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@functools.lru_cache(maxsize=None)
def _kernel_constants(
    config: FbankConfig, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """A as [k_pad, 2, 288] (cos | sin, bins zero-padded) and banks^T as
    [kb_pad, 128], zero-padded so the kernel's chunk loads need no guards."""
    ws, nbins = config.window_size, config.num_spectrum_bins
    a = frontend_matrix(config)
    a_pad = np.zeros((_round_up(ws, _KC), 2, _NBP), np.float32)
    a_pad[:ws, 0, :nbins] = a[:, :nbins]
    a_pad[:ws, 1, :nbins] = a[:, nbins:]
    banks = mel_banks(config)
    banks_pad = np.zeros((_round_up(nbins, _KB), _MELP), np.float32)
    banks_pad[:nbins, : banks.shape[0]] = banks.T
    return (torch.from_numpy(a_pad).to(device),
            torch.from_numpy(banks_pad).to(device))


def fbank_plain(
    wav: torch.Tensor,
    lengths: torch.Tensor | None,
    config: FbankConfig,
    target_frames: int,
) -> torch.Tensor:
    """The kernel's plain version: [B, N] -> [B, target_frames, n_mels]."""
    logmel, _ = fbank_batched(wav, lengths, config=config, method="gemm")
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
    nbins, n_mels = config.num_spectrum_bins, config.num_mel_bins
    if nbins > _NBP or n_mels > _MELP:
        raise ValueError(
            f"fbank_cuda takes at most {_NBP} spectrum bins and {_MELP} mel "
            f"bins, got {nbins} and {n_mels}"
        )
    b, n = wav.shape
    if b > 65535:
        raise ValueError(f"fbank_cuda takes at most 65535 clips, got {b}")
    out = torch.empty((b, target_frames, n_mels), dtype=torch.float32,
                      device=wav.device)
    lib = build()
    a_pad, banks_pad = _kernel_constants(config, wav.device)
    err = lib.psla_fbank_launch(
        wav.data_ptr(),
        None if lengths is None else lengths.data_ptr(),
        a_pad.data_ptr(), banks_pad.data_ptr(), out.data_ptr(),
        b, n, target_frames, config.window_size, config.window_shift,
        a_pad.shape[0], nbins, banks_pad.shape[0], n_mels,
        torch.cuda.current_stream(wav.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fbank kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
