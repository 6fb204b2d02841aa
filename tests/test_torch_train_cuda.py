"""The port's train step on the card. This file imports nothing of JAX, so
it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_train_cuda.py -m cuda

On a CUDA tensor the step's fbank is the hand-written kernel; each test
holds the step to the same step through the kernel's plain version
('fft64') with the same draws, at B0, T=64, batch 4. Bars: the loss 1e-5
(the kernel is ~5e-7 from its plain version in the log-mel), running
statistics 1e-5; remat on and off 1e-5 (cuDNN may pick other algorithms
for the recomputed forward). On the CPU every test here skips.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from psla_tpu_torch.frontend import fbank_cuda
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_eval_step, build_train_step, draw_train

B, T, N_CLASS = 4, 64, 8
CFG = PreprocessConfig(target_length=T, time_mask=24)
ATOL = 1e-5


def batch() -> dict:
    n = CFG.fbank.buffer_length(T)
    rng = np.random.default_rng(0)
    t = np.arange(n) / 16000.0
    wav = np.stack([0.3 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(n)
                    for f in (300.0, 700.0, 1500.0, 3100.0)])
    pcm = np.round(wav * 32767.0).astype(np.int16)
    lengths = np.array([n, n // 2, n, 1000], np.int32)
    means = np.array([pcm[i, :m].mean() / 32768.0 for i, m in enumerate(lengths)], np.float32)
    labels = np.eye(N_CLASS, dtype=np.float32)[[0, 3, 5, 7]]
    return {"wav": pcm, "wav_mean": means, "length": lengths, "labels": labels,
            "mix_wav": np.roll(pcm, 1, 0), "mix_wav_mean": np.roll(means, 1),
            "mix_length": np.roll(lengths, 1), "mix_labels": np.roll(labels, 1, 0)}


def state(remat: bool = False):
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, remat=remat,
                         generator=torch.Generator().manual_seed(1))
    return create_train_state(model, lambda step: 1e-3, device="cuda")


def stats(model) -> dict:
    return {k: v for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the step's fbank is a CUDA kernel)")


@pytest.mark.cuda
def test_train_step_through_the_kernel_on_card():
    _card()
    a, b = state(), state()
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    draws = draw_train(torch.Generator(device="cuda").manual_seed(2), a.model, B, CFG)
    assert draws.keep.is_cuda and draws.pre.mixup.lam.is_cuda
    before = fbank_cuda.LAUNCHES
    a, ma = build_train_step(CFG)(a, batch(), draws)
    torch.cuda.synchronize()
    assert fbank_cuda.LAUNCHES == before + 1
    b, mb = build_train_step(dataclasses.replace(CFG, fbank_method="fft64"))(b, batch(), draws)
    assert fbank_cuda.LAUNCHES == before + 1
    assert np.isfinite(float(ma["loss"]))
    assert abs(float(ma["loss"]) - float(mb["loss"])) < ATOL
    sa, sb = stats(a.model), stats(b.model)
    for k in sa:
        np.testing.assert_allclose(sa[k].cpu().numpy(), sb[k].cpu().numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)
    probs, loss = build_eval_step(CFG)(a, batch())
    assert probs.shape == (B, N_CLASS) and loss.shape == (B,)
    assert fbank_cuda.LAUNCHES == before + 2
    assert bool(torch.isfinite(probs).all()) and not a.model.training


@pytest.mark.cuda
def test_remat_gives_the_same_step_on_card():
    _card()
    out = []
    for remat in (False, True):
        s = state(remat)
        draws = draw_train(torch.Generator(device="cuda").manual_seed(3), s.model, B, CFG)
        s, m = build_train_step(CFG)(s, batch(), draws)
        out.append((float(m["loss"]), copy.deepcopy(stats(s.model))))
    assert abs(out[0][0] - out[1][0]) < ATOL
    for k, v in out[0][1].items():
        np.testing.assert_allclose(v.cpu().numpy(), out[1][1][k].cpu().numpy(), atol=ATOL,
                                   rtol=0, err_msg=k)
