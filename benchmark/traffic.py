"""The one generator of the benchmark's inputs, driven by a workload file's
``traffic`` parameters and the run's seed.

Every seed gives the same set of sizes and arrival gaps, in another order:
clip lengths and gaps are fixed quantiles of their distributions, shuffled
by the seed, so two seeds do the same work. Waveforms (noise at a
seeded level plus a seeded tone) are drawn on the device in one call and
copied to the host, as a loader would hand them over.

Training (``train_pool``): ``pool_batches`` batches of distinct clips that
the window cycles through, each with its mixup partners (clips of the
next batch), int16 PCM as the loader's wire carries it, true lengths,
full-clip means and multi-hot labels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import kaldi_fbank


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), *stream]))


def length_mix(mix: list[dict], n: int, sample_rate: float) -> np.ndarray:
    """``n`` clip lengths in samples, in the mix's order: each part
    ``{"share": s, "seconds": x}`` or ``{"share": s, "uniform": [lo, hi]}``
    gets round(s * n) clips (the last part the rest), a uniform part at
    evenly spaced quantiles."""
    out, left = [], n
    for i, part in enumerate(mix):
        k = left if i == len(mix) - 1 else min(left, round(part["share"] * n))
        left -= k
        if "seconds" in part:
            secs = np.full(k, float(part["seconds"]))
        else:
            lo, hi = part["uniform"]
            secs = lo + (hi - lo) * (np.arange(k) + 0.5) / max(k, 1)
        out.append(np.floor(secs * sample_rate).astype(np.int64))
    return np.concatenate(out)


def waveforms(n: int, samples: int, seed: int, device) -> torch.Tensor:
    """[n, samples] float32 clips on ``device``: noise at a level in
    [0.01, 0.1] plus a tone of amplitude 0.2 at 100-4000 Hz."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    params = torch.rand(n, 3, generator=gen, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float32) / 16000.0
    freq = 100.0 + 3900.0 * params[:, :1]
    tone = 0.2 * torch.sin(2 * math.pi * freq * t[None, :] + 2 * math.pi * params[:, 1:2])
    noise = torch.randn(n, samples, generator=gen, device=device)
    return noise * (0.01 + 0.09 * params[:, 2:3]) + tone


def train_pool(traffic: dict, config: dict, batch: int, seed: int, device) -> list[dict]:
    """The window's host batches (numpy), in the order the feed takes them."""
    sr = float(config["sample_rate"])
    buffer = kaldi_fbank.buffer_length(config["target_length"], sr)
    n = traffic["pool_batches"] * batch
    rng = _rng(seed, 1)
    lengths = np.minimum(rng.permutation(length_mix(traffic["lengths"], n, sr)), buffer)
    wav = waveforms(n, buffer, seed, device)
    wav = wav * (torch.arange(buffer, device=device)[None, :]
                 < torch.from_numpy(lengths).to(device)[:, None])
    pcm = torch.round(wav.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)
    f32 = pcm.float() * 2.0 ** -15
    means = (f32.sum(dim=1) / torch.from_numpy(np.maximum(lengths, 1)).to(device)).cpu().numpy()
    pcm = pcm.cpu().numpy()
    labels = np.zeros((n, config["n_class"]), np.float32)
    per_clip = traffic["labels_per_clip"]
    for i in range(n):
        labels[i, rng.choice(config["n_class"], per_clip, replace=False)] = 1.0
    lengths = lengths.astype(np.int32)
    pool = []
    for k in range(traffic["pool_batches"]):
        rows = np.arange(k * batch, (k + 1) * batch)
        partner = ((k + 1) % traffic["pool_batches"]) * batch + (np.arange(batch) * 7 + 3) % batch
        pool.append({"wav": pcm[rows], "wav_mean": means[rows], "length": lengths[rows],
                     "labels": labels[rows], "mix_wav": pcm[partner],
                     "mix_wav_mean": means[partner], "mix_length": lengths[partner],
                     "mix_labels": labels[partner]})
    return pool

