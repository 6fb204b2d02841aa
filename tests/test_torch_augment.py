"""The port's training augmentations against the JAX package's.

``psla_tpu_torch.frontend.augment`` takes its random draws as tensors; the
JAX functions draw them from ``jax.random`` keys. ``jax_preprocess_draws``
rebuilds, from the key that ``preprocess_train`` gets, every draw the JAX
functions make (the key schedule of ``psla_tpu/frontend/pipeline.py`` and
``augment.py``), and the port gets those. Bars: masks exact (the same
float32 floors), waveforms and labels 1e-6 (float32 sums over 16k samples
in another order), log-mels 2e-4 abs plus 1e-4 relative: on the CPU both
packages take their float32 'fft' lowering, and where an FFT is on either
side that is the JAX package's bar (test_goldens.py:50) and the eval
path's (tests/test_torch_fbank.py). The relative part covers the
near-silent bands (log-mel ~ -15), where the two float32 FFTs round
relative to the frame's energy and differ by up to ~1.3e-3.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

from psla_tpu.frontend import augment as jax_augment
from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.frontend.pipeline import WavBatch as JaxWavBatch
from psla_tpu.frontend.pipeline import preprocess_train as jax_preprocess_train
from psla_tpu_torch.frontend import augment
from psla_tpu_torch.frontend.pipeline import (
    PreprocessConfig,
    PreprocessDraws,
    WavBatch,
    draw_preprocess,
    preprocess_train,
)

torch.set_num_threads(2)

B, T, F, N_CLASS = 4, 64, 128, 4
WAV_ATOL = 1e-6
LOGMEL_ATOL, FFT_RTOL = 2e-4, 1e-4


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _mask_draws(key, b: int) -> augment.MaskDraws:
    """The two uniforms of each sample's mask, as spec_augment draws them:
    split(key, b) per sample, then split(k) -> (k1, k2) in _mask_axis."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1), jax.random.uniform(k2)
    value, start = jax.vmap(one)(jax.random.split(key, b))
    return augment.MaskDraws(_t(value), _t(start))


def jax_mixup_draws(k_mix, b: int) -> augment.MixupDraws:
    k_gate, k_lam = jax.random.split(k_mix)
    gate = jax.random.uniform(k_gate, (b,))
    lam = jax.random.beta(k_lam, 10.0, 10.0, (b,)).astype(jnp.float32)
    return augment.MixupDraws(_t(gate), _t(lam))


def jax_spec_draws(k_spec, b: int) -> tuple[augment.MaskDraws, augment.MaskDraws]:
    fkeys, tkeys = jax.random.split(k_spec)
    return _mask_draws(fkeys, b), _mask_draws(tkeys, b)


def jax_noise_draws(k_noise, b: int, t: int, f: int) -> augment.NoiseDraws:
    k1, k2, k3 = jax.random.split(k_noise, 3)
    u = jax.random.uniform(k1, (b, 1, 1))
    noise = jax.random.uniform(k2, (b, t, f))
    shift = jax.random.randint(k3, (b,), -10, 10)
    return augment.NoiseDraws(_t(u).reshape(b), _t(noise), _t(shift).long())


def jax_preprocess_draws(pre_key, b: int, t: int, f: int) -> PreprocessDraws:
    """Every draw psla_tpu's preprocess_train(pre_key, ...) makes."""
    k_mix, k_spec, k_noise = jax.random.split(pre_key, 3)
    freq, time = jax_spec_draws(k_spec, b)
    return PreprocessDraws(jax_mixup_draws(k_mix, b), freq, time,
                           jax_noise_draws(k_noise, b, t, f))


def tone_batch(seed: int, n: int, b: int = B, ragged: bool = True) -> dict:
    """Numpy batch dict: tones plus noise and a DC offset, ragged lengths
    (full, about half, 900 samples), multi-hot labels, and mixup partners
    that are the batch rolled by one."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    wav = np.stack([0.3 * np.sin(2 * np.pi * rng.uniform(200, 3000) * t)
                    + 0.02 * rng.standard_normal(n) + rng.normal(0, 0.05)
                    for _ in range(b)]).astype(np.float32)
    lengths = np.full(b, n, np.int32)
    if ragged:
        lengths[1], lengths[3] = n // 2 + 37, 900
        wav[1, lengths[1]:] = 0.0
        wav[3, lengths[3]:] = 0.0
    means = np.array([wav[i, :lengths[i]].mean() for i in range(b)], np.float32)
    labels = (rng.uniform(size=(b, N_CLASS)) < 0.4).astype(np.float32)
    return {
        "wav": wav, "wav_mean": means, "length": lengths, "labels": labels,
        "mix_wav": np.roll(wav, 1, 0), "mix_wav_mean": np.roll(means, 1),
        "mix_length": np.roll(lengths, 1), "mix_labels": np.roll(labels, 1, 0),
    }


@pytest.mark.parametrize("seed,freq_mask,time_mask", [
    (0, 48, 192), (1, 48, 24), (2, 0, 24), (3, 48, 0), (4, 127, 64), (5, 1, 1),
])
def test_spec_augment_matches_jax(seed, freq_mask, time_mask):
    """Exact masks: on ones the output is the masks' product."""
    key = jax.random.PRNGKey(seed)
    b = 16
    ones = jnp.ones((b, T, F), jnp.float32)
    ref = np.asarray(jax_augment.spec_augment(key, ones, freq_mask, time_mask))
    freq, time = jax_spec_draws(key, b)
    got = augment.spec_augment(torch.ones(b, T, F), freq, time, freq_mask, time_mask)
    np.testing.assert_array_equal(got.numpy(), ref)
    if time_mask > 1:  # the masks do mask something
        assert (ref == 0).any()


@pytest.mark.parametrize("rate", [0.5, 1.0, 0.0])
def test_mixup_waveforms_matches_jax(rate):
    n = 16000
    bt = tone_batch(7, n)
    key = jax.random.PRNGKey(11)
    args = [bt[k] for k in ("wav", "wav_mean", "length", "mix_wav", "mix_wav_mean",
                            "mix_length", "labels", "mix_labels")]
    wav, labels, lam = jax_augment.mixup_waveforms(key, *map(jnp.asarray, args), rate)
    got = augment.mixup_waveforms(*map(_t, args), jax_mixup_draws(key, B), rate)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(wav), atol=WAV_ATOL, rtol=0)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(labels), atol=WAV_ATOL, rtol=0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(lam))
    # padding past each primary's length stays 0
    for i in range(B):
        assert not got[0][i, bt["length"][i]:].any()


def test_add_noise_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jax_augment.add_noise(key, jnp.asarray(x)))
    draws = jax_noise_draws(key, B, T, F)
    got = augment.add_noise(_t(x), draws)
    np.testing.assert_allclose(got.numpy(), ref, atol=WAV_ATOL, rtol=0)
    assert (draws.shift != 0).any()


@pytest.mark.parametrize("mixup,noise", [(0.5, False), (0.0, True), (1.0, True)])
def test_preprocess_train_matches_jax(mixup, noise):
    """The whole training frontend, fed the step key's draws."""
    jax_cfg = JaxPreprocessConfig(target_length=T, freq_mask=48, time_mask=24,
                                  mixup_rate=mixup, noise=noise)
    cfg = PreprocessConfig(target_length=T, freq_mask=48, time_mask=24,
                           mixup_rate=mixup, noise=noise)
    n = cfg.fbank.buffer_length(T)
    bt = tone_batch(int(mixup * 10) + noise, n)
    key = jax.random.PRNGKey(21)
    ref_fb, ref_lab = jax_preprocess_train(
        key, JaxWavBatch(**{k: jnp.asarray(v) for k, v in bt.items()}), jax_cfg)
    fb, lab = preprocess_train(WavBatch(**{k: _t(v) for k, v in bt.items()}),
                               jax_preprocess_draws(key, B, T, F), cfg)
    assert fb.shape == (B, T, F) and lab.shape == (B, N_CLASS)
    # back to the log-mel domain, where the bar is stated
    std, mean = cfg.norm_std, cfg.norm_mean
    np.testing.assert_allclose(fb.numpy() * std + mean, np.asarray(ref_fb) * std + mean,
                               atol=LOGMEL_ATOL, rtol=FFT_RTOL)
    np.testing.assert_allclose(lab.numpy(), np.asarray(ref_lab), atol=WAV_ATOL, rtol=0)


def test_beta_sampler_moments():
    """Beta(10, 10) from the 10th of 19 uniforms: mean 1/2, variance 1/84,
    and the distribution itself (Kolmogorov-Smirnov against scipy's)."""
    g = torch.Generator().manual_seed(0)
    lam = augment.sample_beta_10_10(g, 200_000).double().numpy()
    assert lam.min() > 0.0 and lam.max() < 1.0
    # 5 standard errors: 2.4e-4 for the mean, ~3.8e-5 for the variance
    assert abs(lam.mean() - 0.5) < 1.2e-3
    assert abs(lam.var() - 1.0 / 84.0) < 2e-4
    assert scipy.stats.kstest(lam, scipy.stats.beta(10, 10).cdf).pvalue > 1e-3


def test_draws_follow_the_config_and_the_generator():
    cfg = PreprocessConfig(target_length=T, noise=True)
    a = draw_preprocess(torch.Generator().manual_seed(4), B, cfg)
    b = draw_preprocess(torch.Generator().manual_seed(4), B, cfg)
    for x, y in zip(jax.tree.leaves(tuple(a)), jax.tree.leaves(tuple(b))):
        assert torch.equal(x, y)
    assert a.noise.noise.shape == (B, T, F) and a.mixup.lam.shape == (B,)
    assert a.noise.shift.min() >= -10 and a.noise.shift.max() < 10
    off = draw_preprocess(torch.Generator(), B, cfg.eval_variant())
    assert off == PreprocessDraws(None, None, None, None)
