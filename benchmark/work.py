"""The benchmark's yardstick of work: model FLOPs, the fbank kernel's
operations and bytes, the H100's peaks, and the groups a device trace's
kernels fall into. Nothing here reads the program under test.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import kaldi_fbank
from benchmark.reference.training import family

# One NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit).
PEAK_FLOP_S = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "fp8": 1979e12}
PEAK_BYTES_S = 3.35e12


def peak_flop_s(precision: str) -> float:
    return PEAK_FLOP_S[precision]


def forward_flop(config: dict, frames: int | None = None) -> float:
    """FLOPs of one clip's forward through the configuration's model at
    ``frames`` frames (default the configuration's target length): the
    reference's forward under ``FlopCounterMode`` on ``meta`` tensors, so
    the products and convolutions count whatever later computes them."""
    fam = family(config["family"])
    frames = config["target_length"] if frames is None else frames
    w = {k: torch.empty(shape, device="meta") for k, (shape, _) in fam.shapes(config).items()}
    x = torch.empty((1, frames, config["num_mel_bins"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        fam.forward(w, x, config)
    return float(counter.get_total_flops())


def train_flop(config: dict) -> float:
    """FLOPs of one clip's training step: forward and backward, 3 x the
    forward's (the backward takes the data and the weight gradients)."""
    return 3.0 * forward_flop(config)


def fbank_bound(lengths, buffer: int, target: int, num_mel_bins: int = 128,
                sample_rate: float = 16000.0) -> dict:
    """Least time of one launch of the log-mel fbank over clips of these
    ``lengths`` in buffers of ``buffer`` samples, cut to ``target`` frames:
    the larger of its operations over the float32 peak and its bytes over
    the memory rate.

    Only the valid frames need work. A frame takes DC removal,
    pre-emphasis and the window (5 flop a sample), a real FFT of the padded
    window (2.5 n log2 n), the power spectrum (3 a bin), the mel banks'
    non-zeros (2 each) and the floor and log (2 a mel bin). The bytes are
    the samples those frames read, the lengths, the [B, T, mels] output,
    the window and the banks' non-zeros."""
    ws = kaldi_fbank.window_size(sample_rate)
    nfft = 1 << (ws - 1).bit_length()
    nb = nfft // 2 + 1
    nnz = int(np.count_nonzero(kaldi_fbank.mel_banks(num_mel_bins, nfft, sample_rate)))
    valid = [min(kaldi_fbank.valid_frames(min(int(x), buffer), sample_rate), target)
             for x in lengths]
    frames = sum(valid)
    samples = sum(kaldi_fbank.buffer_length(v, sample_rate) for v in valid if v)
    flop = frames * (5 * ws + 2.5 * nfft * float(np.log2(nfft)) + 3 * nb + 2 * nnz
                     + 2 * num_mel_bins)
    nbytes = 4 * (samples + len(valid) + len(valid) * target * num_mel_bins + ws + nnz)
    t_ops, t_bytes = flop / PEAK_FLOP_S["float32"], nbytes / PEAK_BYTES_S
    return {"s": max(t_ops, t_bytes), "by": "operations" if t_ops >= t_bytes else "bytes",
            "flop": flop, "bytes": nbytes}


# Device kernels of a train step by what they compute, matched on the
# kernel's name in this order (the first match wins).
KERNEL_GROUPS = (
    ("depthwise conv backward", r"conv_depthwise.*(backward|grad)"),
    ("depthwise conv forward", r"conv_depthwise"),
    ("BatchNorm backward", r"bn_bw|batch_norm_backward|batch_norm_collect_stat.*backward"),
    ("BatchNorm forward", r"bn_fw|batch_norm"),
    ("convolutions and products (cuDNN, cuBLAS)",
     r"xmma|implicit_gemm|wgrad|dgrad|gemm|cudnn|cutlass|sm90_|winograd|fft2d"),
    ("fbank kernel", r"fbank"),
    ("NCCL collectives", r"nccl"),
    ("Adam (foreach)", r"foreach|adam"),
    ("host-device copies", r"Memcpy|Memset"),
)
OTHER = "elementwise and other"


def kernel_group(name: str) -> str:
    return next((g for g, pattern in KERNEL_GROUPS if re.search(pattern, name, re.I)), OTHER)
