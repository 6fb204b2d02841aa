"""Arbitrary-length audio inference via chunked, pooling-exact aggregation.

Port of ``psla_tpu/inference.py``:

  waveform (any length)
    -> grid of target_length-frame chunks
    -> eval preprocessing per chunk batch (DC removal with the FULL-clip
       mean -> fbank -> normalize)
    -> backbone forward per chunk batch
    -> exact streaming aggregation at the attention-pooling layer: each
       head's output is sum_t(att*cla)/sum_t(att), which decomposes over
       chunks, so summing the per-chunk partial sums reproduces pooling over
       the full sequence (models/pooling.py return_stats).

Only the convolutional receptive field at chunk boundaries differs from one
pass over the whole clip. A model whose forward has no ``return_stats`` is
combined by frame-count-weighted averaging of chunk probabilities instead.
A final partial chunk is zero-padded in the log-mel domain before
normalization, as the reference's eval path pads
(src/dataloaders/audioset_dataset.py:125-132).
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from psla_tpu_torch.frontend import augment
from psla_tpu_torch.frontend.pipeline import PreprocessConfig, _logmel


def _chunk_logmel(wav: torch.Tensor, wav_mean: torch.Tensor,
                  lengths: torch.Tensor, config: PreprocessConfig) -> torch.Tensor:
    """Eval preprocessing over a [N, chunk_samples] chunk batch."""
    wav = augment.dc_remove(wav, wav_mean, lengths)
    logmel = _logmel(wav, lengths, config)
    if not config.skip_norm:
        logmel = augment.normalize(logmel, config.norm_mean, config.norm_std)
    return logmel


def ensemble_probs(members, wav: torch.Tensor, wav_mean: torch.Tensor,
                   lengths: torch.Tensor, config: PreprocessConfig) -> torch.Tensor:
    """[B, chunk_samples] clips -> the members' mean probabilities [B,
    n_class] (float32). The fbank runs once for all members."""
    logmel = _chunk_logmel(wav, wav_mean, lengths, config)
    acc = members[0](logmel).float()
    for m in members[1:]:
        acc = acc + m(logmel).float()
    return acc / len(members)


def aggregate_stats(stats: dict) -> torch.Tensor:
    """Combine per-chunk pooling stats -> [n_class] probabilities.

    ``s1``/``s0`` carry leading chunk axes (all summed); ``head_weight`` is
    the per-model [H] constant (a stack of identical rows also works).
    """
    s1 = torch.as_tensor(stats["s1"])
    s0 = torch.as_tensor(stats["s0"])
    reduce_dims = tuple(range(s1.dim() - 2))
    if reduce_dims:
        s1 = s1.sum(dim=reduce_dims)  # [H, n_class]
        s0 = s0.sum(dim=reduce_dims)
    hw = torch.as_tensor(stats["head_weight"]).reshape(-1, s1.shape[0])[0]
    return torch.einsum("ho,h->o", s1 / s0, hw.to(s1.device))


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def predict_long(
    model: torch.nn.Module,
    waveform: np.ndarray,
    config: PreprocessConfig,
    chunk_batch: int = 8,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """[n_samples] waveform of ANY length -> [n_class] probabilities.

    Runs ceil(samples / chunk_samples) chunks through ``model`` (which must
    already lie on ``device``) in batches of ``chunk_batch`` and aggregates
    exactly at the pooling layer.
    """
    device = torch.device(device)
    if _model_device(model).type != device.type:
        raise ValueError(
            f"model is on {_model_device(model)}, predict_long runs on "
            f"{device}: move the model or pass device="
        )
    waveform = np.asarray(waveform, dtype=np.float32).reshape(-1)
    chunk_samples = config.fbank.buffer_length(config.target_length)
    n = waveform.size
    n_chunks = max(1, -(-n // chunk_samples))
    padded = np.zeros(n_chunks * chunk_samples, dtype=np.float32)
    padded[:n] = waveform
    chunks = torch.from_numpy(padded.reshape(n_chunks, chunk_samples)).to(device)
    # DC removal uses the FULL-clip mean (the reference subtracts the clip
    # mean before fbank, audioset_dataset.py:96-100).
    mean = float(waveform.mean()) if n else 0.0
    lengths = np.minimum(
        np.maximum(n - np.arange(n_chunks) * chunk_samples, 0), chunk_samples
    ).astype(np.int32)
    lengths_t = torch.from_numpy(lengths).to(device)

    supports_stats = "return_stats" in inspect.signature(model.forward).parameters
    s1, s0, head_weight = [], [], None
    probs_acc = 0.0
    weight_acc = 0.0
    for lo in range(0, n_chunks, chunk_batch):
        hi = min(lo + chunk_batch, n_chunks)
        logmel = _chunk_logmel(
            chunks[lo:hi],
            torch.full((hi - lo,), mean, dtype=torch.float32, device=device),
            lengths_t[lo:hi],
            config,
        )
        if supports_stats:
            st = model(logmel, return_stats=True)
            s1.append(st["s1"])
            s0.append(st["s0"])
            head_weight = st["head_weight"]
        else:
            probs = model(logmel).double().cpu().numpy()
            w = np.maximum(lengths[lo:hi].astype(np.float64), 1.0)
            probs_acc = probs_acc + (probs * w[:, None]).sum(0)
            weight_acc += w.sum()

    if supports_stats:
        stats = {"s1": torch.cat(s1), "s0": torch.cat(s0), "head_weight": head_weight}
        return aggregate_stats(stats).float().cpu().numpy()
    return (probs_acc / weight_acc).astype(np.float32)
