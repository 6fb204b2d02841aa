"""The benchmark's plain reference held to psla_tpu_torch at small sizes on
the CPU: the fbank, the train-mode and eval-mode forwards, the recipe's
preprocessing, BCE, Adam and the schedule, and whole train steps."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import program, traffic
from benchmark.reference import effnet_attention, kaldi_fbank, training
from benchmark.weights import make_weights
from psla_tpu_torch.frontend.fbank import FbankConfig, fbank_batched, pad_or_truncate
from psla_tpu_torch.frontend.pipeline import WavBatch, preprocess_train
from psla_tpu_torch.train.optim import bce_loss, make_optimizer, psla_lr_schedule, set_lr
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_train_step

SMALL = dict(family="effnet_attention", model="efficientnet", eff_b=0, att_head=4,
             n_class=10, num_mel_bins=128, target_length=64, sample_rate=16000,
             mixup=0.5, freqm=8, timem=16, dataset_mean=-4.6476, dataset_std=4.5699,
             lr=1e-3, weight_decay=5e-7, lrscheduler_start=10, lrscheduler_decay=0.5,
             bn_momentum=0.99, steps_per_epoch=100)


def host_batch(seed: int, batch: int, config: dict) -> dict:
    """An int16 batch with ragged lengths, mixup partners, multi-hot labels."""
    rng = np.random.default_rng(seed)
    n = kaldi_fbank.buffer_length(config["target_length"])
    pcm = (rng.standard_normal((batch, n)) * 3000).astype(np.int16)
    lengths = np.full(batch, n, np.int32)
    lengths[1] = n // 3
    lengths[2] = 100  # below one window: no frame
    pcm[1, lengths[1]:] = 0
    pcm[2, lengths[2]:] = 0
    f32 = pcm.astype(np.float32) / 32768
    means = np.array([f32[i, :k].mean() for i, k in enumerate(lengths)], np.float32)
    labels = (rng.uniform(size=(batch, config["n_class"])) < 0.2).astype(np.float32)
    out = {"wav": pcm, "wav_mean": means, "length": lengths, "labels": labels,
           "mix_wav": np.roll(pcm, 1, 0), "mix_wav_mean": np.roll(means, 1),
           "mix_length": np.roll(lengths, 1), "mix_labels": np.roll(labels, 1, 0)}
    return {k: torch.from_numpy(v) for k, v in out.items()}


def test_fbank_matches_the_port():
    cfg = FbankConfig()
    rng = np.random.default_rng(0)
    n = cfg.buffer_length(50)
    wav = torch.from_numpy(rng.standard_normal((3, n)).astype(np.float32) * 0.1)
    lengths = torch.tensor([n, n // 2, 300], dtype=torch.int32)
    wav[1, n // 2:] = 0
    ours = kaldi_fbank.logmel(wav, lengths, 64)
    theirs, _ = fbank_batched(wav, lengths, cfg, method="fft64")
    theirs = pad_or_truncate(theirs, 64)
    assert ours.shape == theirs.shape == (3, 64, 128)
    assert float((ours - theirs).abs().max()) < 2e-4
    assert float(ours[2].abs().max()) == 0.0  # no whole frame


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port(train):
    torch.manual_seed(0)
    (w,) = make_weights(SMALL, 3, "cpu")
    model = program.model(SMALL, w)
    buffer = kaldi_fbank.buffer_length(SMALL["target_length"])
    x = kaldi_fbank.eval_input(traffic.waveforms(4, buffer, 5, "cpu"),
                               torch.full((4,), buffer), SMALL)
    keep = None
    if train:
        model.train()
        rates = effnet_attention.drop_rates(SMALL)
        keep = torch.rand(len(rates), 4) < 0.7
        assert len(rates) == len(model.effnet.drop_blocks)
    with torch.no_grad():
        ours = effnet_attention.forward(w, x, SMALL, train=train, keep=keep)
        theirs = model(x, keep=keep) if train else model(x)
    assert ours.shape == (4, SMALL["n_class"])
    assert float((ours - theirs).abs().max()) < 2e-5
    # the calibrated weights keep the answer input-dependent
    assert float((ours[1:] - ours[:1]).abs().max()) > 1e-2


def test_parameter_shapes_are_the_port_state_dict():
    w = make_weights(dict(SMALL, eff_b=2, n_class=527), 0, "cpu")[0]
    model = program.model(dict(SMALL, eff_b=2, n_class=527), w)
    sd = model.state_dict()
    assert list(sd) == list(w)
    assert all(sd[k].shape == w[k].shape for k in w)
    assert sum(v.numel() for v in w.values()) == 13_708_334


def test_train_input_matches_preprocess_train():
    batch = host_batch(1, 4, SMALL)
    draws = program.make_draws(torch.Generator().manual_seed(2), 4, [])
    draws["mix_gate"][:2] = 0.1  # two clips mixed, two not
    draws["mix_gate"][2:] = 0.9
    ours, ours_labels = kaldi_fbank.train_input(batch, draws, SMALL)
    wb = {k: batch[k] for k in WavBatch._fields}
    for k in ("wav", "mix_wav"):
        wb[k] = wb[k].float() * 2.0 ** -15
    pre = dataclasses.replace(program.preprocess_config(SMALL), fbank_method="fft64")
    theirs, theirs_labels = preprocess_train(WavBatch(**wb), program.train_draws(draws).pre, pre)
    assert float((ours - theirs).abs().max()) < 2e-4 / SMALL["dataset_std"]
    assert float((ours_labels - theirs_labels).abs().max()) < 1e-6


def test_bce_adam_and_schedule_match_the_port():
    torch.manual_seed(0)
    p = torch.rand(5, 7)
    t = (torch.rand(5, 7) < 0.3).float()
    assert float(training.bce(p, t)) == pytest.approx(float(bce_loss(p, t)), rel=1e-7)
    sched = psla_lr_schedule(1e-4, 20000, 10, 0.5)
    cfg = dict(lr=1e-4, steps_per_epoch=20000, lrscheduler_start=10, lrscheduler_decay=0.5)
    for step in (0, 49, 50, 999, 1000, 1001, 2000, 219_999, 220_000, 320_000):
        assert training.learning_rate(cfg, step) == pytest.approx(sched(step), rel=1e-12)
    w = {"a": torch.randn(6, 3), "b": torch.randn(4)}
    ours = training.Adam({k: v.clone() for k, v in w.items()}, 5e-7)
    theirs = {k: torch.nn.Parameter(v.clone()) for k, v in w.items()}
    opt = make_optimizer(theirs.values())
    for i in range(3):
        g = {k: torch.randn_like(v) for k, v in w.items()}
        ours.step(g, 1e-3)
        for k, v in theirs.items():
            v.grad = g[k].clone()
        set_lr(opt, 1e-3)
        opt.step()
    for k in w:
        assert float((ours.params[k] - theirs[k].detach()).abs().max()) < 1e-7


def test_train_steps_match_the_port():
    """Two steps of the reference against the program's train step from the
    same weights, batches and draws."""
    (w,) = make_weights(SMALL, 4, "cpu")
    batches = [host_batch(10 + i, 4, SMALL) for i in range(2)]
    rates = effnet_attention.drop_rates(SMALL)
    draws = [program.make_draws(torch.Generator().manual_seed(20 + i), 4, rates)
             for i in range(2)]
    start = 2000
    ref = training.train_steps(SMALL, w, batches, draws, start)
    model = program.model(SMALL, w)
    state = create_train_state(model, program.schedule(SMALL), step=start, device="cpu")
    step = build_train_step(dataclasses.replace(program.preprocess_config(SMALL),
                                                fbank_method="fft64"))
    losses = []
    for b, d in zip(batches, draws):
        state, out = step(state, b, program.train_draws(d))
        losses.append(float(out["loss"]))
    assert np.allclose(losses, ref["losses"].numpy(), rtol=1e-5, atol=0)
    params = dict(state.model.named_parameters())
    for k, change in ref["changes"].items():
        got = params[k].detach() - w[k]
        # Adam's steps are about lr each: a sign flipped by rounding moves 2 lr
        assert float((got - change).abs().max()) <= 2 * 2 * SMALL["lr"], k
    assert ref["grads"].keys() == ref["changes"].keys()
