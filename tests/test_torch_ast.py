"""The Audio Spectrogram Transformer (``models/spectrogram_transformer.py``)
held to the benchmark's plain reference (``benchmark/reference/
spectrogram_transformer.py``) on the CPU: the eval forward, the gradients,
two train steps, the state_dict against the reference's shapes (also at
AST-Base/16's widths, on the meta device), bfloat16, the registry's
refusals, the schedule's milestone step and a trainer run of the
``audioset_full_ast`` preset.

Size: width 64, 2 blocks, 4 heads, 32 mel bins, T=64 (2 x 5 patches, 12
tokens), batch 4.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from benchmark import program, traffic
from benchmark.reference import kaldi_fbank, spectrogram_transformer, training
from benchmark.weights import make_weights
from psla_tpu_torch import cli
from psla_tpu_torch.models import create_model, spectrogram_transformer as ast_model
from psla_tpu_torch.train import loop
from psla_tpu_torch.train.optim import psla_lr_schedule
from psla_tpu_torch.train.state import create_train_state
from psla_tpu_torch.train.step import build_train_step
from tests.synth import build_corpus
from tests.torch_port_fixtures import tmp_path  # noqa: F401

torch.set_num_threads(2)

WIDTHS = dict(embed_dim=64, depth=2, num_heads=4)
TINY = dict(family="spectrogram_transformer", model="ast", **WIDTHS, mlp_ratio=4,
            fstride=10, tstride=10, n_class=10, num_mel_bins=32, target_length=64,
            sample_rate=16000, mixup=0.5, freqm=8, timem=16, dataset_mean=-4.2677393,
            dataset_std=4.5689974, lr=1e-3, weight_decay=5e-7, lrscheduler_start=2,
            lrscheduler_decay=0.5, steps_per_epoch=100, batch_size=4)
with open(os.path.join(os.path.dirname(__file__), "..", "benchmark", "configs",
                       "ast_audioset.json")) as _f:
    BASE = json.load(_f)
EVAL_BAR = 2e-5  # the eval forward's bar, as for the CNNs (test_bench_reference.py)


def tiny_model(weights=None, dtype=torch.float32, label_dim=TINY["n_class"],
               input_fdim=TINY["num_mel_bins"], input_tdim=TINY["target_length"]):
    """AST at the test's widths, with ``weights`` or seeded."""
    model = ast_model.ASTModel(label_dim=label_dim, input_fdim=input_fdim,
                               input_tdim=input_tdim, dtype=dtype, **WIDTHS)
    if weights is None:
        model.reset_parameters(torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(weights)
    return model


def logmel(seed: int, clips: int = 4) -> torch.Tensor:
    buffer = kaldi_fbank.buffer_length(TINY["target_length"])
    return kaldi_fbank.eval_input(traffic.waveforms(clips, buffer, seed, "cpu"),
                                  torch.full((clips,), buffer), TINY)


def test_eval_forward_matches_the_reference():
    (w,) = make_weights(TINY, 3, "cpu")
    model = tiny_model(w)
    x = logmel(5)
    calls = ast_model.ATTENTION_CALLS
    with torch.no_grad():
        ours = spectrogram_transformer.forward(w, x, TINY)
        theirs = model(x)
    assert ast_model.ATTENTION_CALLS == calls + TINY["depth"]
    assert theirs.shape == (4, TINY["n_class"]) and theirs.dtype == torch.float32
    assert float((ours - theirs).abs().max()) < EVAL_BAR
    # the seeded weights keep the answer input-dependent
    assert float((ours[1:] - ours[:1]).abs().max()) > 1e-2


def test_gradients_match_the_reference():
    """Each leaf's gradient of the BCE loss within 1e-5 of its norm plus
    1e-7 of the whole gradient's (a bias whose gradient is rounding alone
    has no relative bar of its own)."""
    (w,) = make_weights(TINY, 4, "cpu")
    model = tiny_model(w).train()
    x = logmel(6)
    labels = (torch.rand(4, TINY["n_class"], generator=torch.Generator().manual_seed(1))
              < 0.2).float()
    training.bce(model(x), labels).backward()
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    loss = training.bce(spectrogram_transformer.forward(leaves, x, TINY, train=True), labels)
    ref = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    total = float(torch.linalg.vector_norm(torch.cat([g.flatten() for g in ref.values()])))
    for k, p in model.named_parameters():
        gap = float(torch.linalg.vector_norm(p.grad - ref[k]))
        assert gap <= 1e-5 * float(torch.linalg.vector_norm(ref[k])) + 1e-7 * total, k


def test_train_steps_match_the_reference():
    """Two steps of the program's train step against the reference's from
    the same weights, batches and draws: the port's train-loss bar, 1e-5."""
    (w,) = make_weights(TINY, 7, "cpu")
    pool = traffic.train_pool({"pool_batches": 2, "labels_per_clip": 2,
                               "lengths": [{"share": 0.5, "seconds": 0.7},
                                           {"share": 0.5, "uniform": [0.1, 0.7]}]},
                              TINY, 4, 8, "cpu")
    batches = [{k: torch.as_tensor(v) for k, v in b.items()} for b in pool]
    draws = [program.make_draws(torch.Generator().manual_seed(20 + i), 4, []) for i in range(2)]
    start = 2000
    ref = training.train_steps(TINY, w, batches, draws, start)
    state = create_train_state(tiny_model(w), program.schedule(TINY), step=start,
                               device="cpu")
    step = build_train_step(dataclasses.replace(program.preprocess_config(TINY),
                                                fbank_method="fft64"))
    losses = []
    for b, d in zip(batches, draws):
        state, out = step(state, b, program.train_draws(d))
        losses.append(float(out["loss"]))
    assert np.allclose(losses, ref["losses"].numpy(), rtol=1e-5, atol=0)
    params = dict(state.model.named_parameters())
    assert params.keys() == ref["changes"].keys()
    for k, change in ref["changes"].items():
        got = params[k].detach() - w[k]
        # Adam's steps are about lr each: a sign flipped by rounding moves 2 lr
        assert float((got - change).abs().max()) <= 2 * 2 * TINY["lr"], k


@pytest.mark.parametrize("config", [TINY, BASE], ids=["tiny", "ast_base16"])
def test_state_dict_is_the_reference_shapes(config):
    """The keys in order and the shapes; ``create_model("ast")`` is AST-Base/16
    at its published widths (built on the meta device): 86.6M parameters,
    pos_embed [1, 1214, 768], in eval mode."""
    if config is TINY:
        model = tiny_model()
    else:
        with torch.device("meta"):
            model = create_model("ast", label_dim=config["n_class"])
        assert tuple(model.v.pos_embed.shape) == (1, 1214, 768)
        assert sum(p.numel() for p in model.parameters()) == 86_594_063
        assert not model.training
    want = spectrogram_transformer.shapes(config)
    assert [(k, tuple(v.shape)) for k, v in model.state_dict().items()] == \
        [(k, s) for k, (s, _) in want.items()]


def test_bfloat16_forward_is_near_the_float32_reference():
    """bf16 products (8 mantissa bits: ~4e-3 a rounding) through two blocks
    move a probability by under 0.02; the output stays float32 and differs
    from the float32 reference by more than float32's rounding."""
    (w,) = make_weights(TINY, 9, "cpu")
    x = logmel(10)
    with torch.no_grad():
        ours = tiny_model(w, torch.bfloat16)(x)
        ref = spectrogram_transformer.forward(w, x, TINY)
    assert ours.dtype == torch.float32
    gap = float((ours - ref).abs().max())
    assert 10 * EVAL_BAR < gap < 0.02


@pytest.mark.parametrize("option", [dict(remat=True), dict(act_compress="q8save")])
def test_registry_refuses_efficientnet_options(option):
    with pytest.raises(ValueError, match="EfficientNet-only"):
        create_model("ast", **option)


@pytest.mark.parametrize("step", [5, 1])
def test_schedule_milestone_step_is_multisteplr(step):
    """After the warmup, the rate of every step is torch's MultiStepLR over
    milestones range(start, 1000, step), stepped once an epoch as PSLA's and
    AST's traintest.py step it; 5 is the default."""
    steps_per_epoch, start = 300, 2
    kwargs = {} if step == 5 else {"lrscheduler_step": step}
    sched = psla_lr_schedule(1e-5, steps_per_epoch, start, 0.5, **kwargs)
    opt = torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=1e-5)
    multistep = torch.optim.lr_scheduler.MultiStepLR(opt, list(range(start, 1000, step)), 0.5)
    for epoch in range(1, 14):
        for s in range((epoch - 1) * steps_per_epoch, epoch * steps_per_epoch, 37):
            if s > 1000:
                assert sched(s) == pytest.approx(opt.param_groups[0]["lr"], rel=1e-12), s
        opt.step()
        multistep.step()


def test_trainer_runs_the_ast_preset(tmp_path, monkeypatch):
    """``--preset audioset_full_ast`` through ``cli.run``: AST (at the test's
    widths) sized by the trainer for the run's frames and mel bins, the
    schedule on AST's milestone step 1, and the protocol's artifacts."""
    datafile, label_csv = build_corpus(str(tmp_path / "corpus"), num_classes=4,
                                       clips_per_class=2, seconds=1.0)
    built, schedules = [], []

    def tiny(name, **kwargs):
        assert name == "ast"
        built.append((kwargs["input_fdim"], kwargs["input_tdim"]))
        return tiny_model(label_dim=kwargs["label_dim"], input_fdim=kwargs["input_fdim"],
                          input_tdim=kwargs["input_tdim"])

    def recorded(*args, **kwargs):
        schedules.append(kwargs)
        return psla_lr_schedule(*args, **kwargs)

    monkeypatch.setattr(loop, "create_model", tiny)
    monkeypatch.setattr(loop, "psla_lr_schedule", recorded)
    exp = str(tmp_path / "exp")
    summary = cli.run(["--preset", "audioset_full_ast", "--data-train", datafile,
                       "--data-val", datafile, "--label-csv", label_csv, "--exp-dir", exp,
                       "--n_class", "4", "--target_length", "64", "-b", "4", "-w", "2",
                       "--n-epochs", "2", "--wa_end", "2", "--device", "cpu"])
    assert all(np.isfinite(v) for part in summary.values() for v in part.values())
    assert built and set(built) == {(128, 64)}
    assert schedules[0]["lrscheduler_start"] == 2 and schedules[0]["lrscheduler_step"] == 1
    with open(os.path.join(exp, "config.json")) as f:
        cfg = json.load(f)
    assert (cfg["model"], cfg["batch_size"], cfg["lr"]) == ("ast", 4, 1e-5)
    assert os.path.isfile(os.path.join(exp, "models", "wa", "checkpoint.pth"))
