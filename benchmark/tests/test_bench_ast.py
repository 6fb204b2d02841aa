"""The AST family's work counts, its two attention readers and its cell's
comparison: the model FLOPs against the hand count at AST-Base/16's size,
the attention count against the products that FlopCounterMode counts in
the reference, the readers on a synthetic trace, and at a tiny size on the
CPU a sound run of ``ast_audioset.train`` correct while the control and
each fault fail the cell's own limits."""

import dataclasses
import json
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import control, harness, program, work
from benchmark.drivers import train
from benchmark.reference import spectrogram_transformer as st

CONFIG = json.loads((harness.ROOT / "benchmark/configs/ast_audioset.json").read_text())
FORWARD = "fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel)"
BACKWARD = ("fmha_cutlassB_f32_aligned_64x64_k64_sm80"
            "(PyTorchMemEffAttention::AttentionBackwardKernel)")
GEMM = "ampere_sgemm_128x64_nn"


def test_forward_flop_is_the_hand_count():
    """2 x multiply-adds: per block qkv, proj, fc1, fc2 on N = 1214 tokens
    and Q K^T, P V; the patch convolution on 12 x 101 patches; mlp_head."""
    n, d = 1214, 768
    block = 2 * n * d * (3 * d + d + 4 * d + 4 * d) + 4 * n * n * d
    hand = 12 * block + 2 * 1212 * d * 16 * 16 + 2 * d * 527
    assert st.tokens(CONFIG) == n
    assert work.forward_flop(CONFIG) == hand
    assert hand / 1e9 == pytest.approx(261.03, abs=0.005)


def test_attention_work_is_the_counted_products():
    """The reference's attention of one clip and block, forward and
    backward, under FlopCounterMode on meta tensors, x the blocks."""
    n, d = st.tokens(CONFIG), CONFIG["embed_dim"]
    qkv = torch.empty((1, n, 3 * d), device="meta", requires_grad=True)
    with FlopCounterMode(display=False) as counter:
        st.attention(qkv, CONFIG["num_heads"]).sum().backward()
    assert st.attention_work(CONFIG)["flop"] == CONFIG["depth"] * counter.get_total_flops()
    rows = n * CONFIG["num_heads"]
    assert st.attention_work(CONFIG)["bytes"] == CONFIG["depth"] * 4 * (12 * n * d + 2 * rows)


def trace(ops, **counters):
    return harness.Trace(window_s=1.0, busy_s=0.2, ops=ops, counters=counters)


def test_attention_readers():
    share = harness.metric_reader("attn_share.train")
    roofline = harness.metric_reader("attn_roofline.train")
    t = trace([(FORWARD, 0.02), (BACKWARD, 0.04), (GEMM, 0.14)], fbank_launches=3)
    assert share(t) == pytest.approx(30.0)
    w = st.attention_work(CONFIG)
    bound = 3 * CONFIG["batch_size"] * max(3 * w["flop"] / 495e12, w["bytes"] / 3.35e12)
    assert roofline(t) == pytest.approx(100 * bound / 0.06)
    assert 0 < roofline(t) <= 100


def test_attention_readers_find_nothing_without_attention():
    share = harness.metric_reader("attn_share.train")
    roofline = harness.metric_reader("attn_roofline.train")
    assert share(trace([(GEMM, 0.1)], fbank_launches=3)) is None
    assert roofline(trace([(GEMM, 0.1)], fbank_launches=3)) is None
    assert roofline(trace([(FORWARD, 0.1)])) is None  # no profiled steps counted


# ------------------------------------------- the cell's comparison, tiny


# the published width and heads, one block, 64 frames: the change_gap's
# worst leaf is a qkv bias, whose key part has no gradient but rounding and
# L2 (softmax ignores a shift common to every key) and so moves under Adam
# by the sign of that rounding; narrower, that part weighs more in the
# leaf's norm (width 64 reads ~1e-3)
TINY = dict(depth=1, target_length=64, n_class=10, freqm=8, timem=16, batch_size=4)
SEED = 2**31 + 101


@pytest.fixture
def tiny_cell(monkeypatch):
    """``ast_audioset.train`` at the tests' size: the program's model built
    at the configuration's sizes (``program.model`` builds AST-Base/16's),
    and its fbank by the kernel's plain version, as test_bench_control.py
    takes it."""
    from psla_tpu_torch.models import ASTModel

    plain = program.preprocess_config
    monkeypatch.setattr(program, "preprocess_config",
                        lambda c: dataclasses.replace(plain(c), fbank_method="fft64"))

    def model(config, weights, dtype="float32"):
        m = ASTModel(label_dim=config["n_class"], dtype=program.DTYPES[dtype],
                     input_fdim=config["num_mel_bins"], input_tdim=config["target_length"],
                     **{k: config[k] for k in ("fstride", "tstride", "embed_dim", "depth",
                                               "num_heads", "mlp_ratio")})
        m.to(next(iter(weights.values())).device)
        m.load_state_dict(weights)
        return m

    monkeypatch.setattr(program, "model", model)
    c = harness.cell("ast_audioset.train")
    c.config.update(TINY)
    return c


def test_a_sound_ast_run_is_correct(tiny_cell):
    out = train.run(tiny_cell, seed=SEED, seconds=1.0, traced=False, t0=time.perf_counter(),
                    device="cpu")
    assert harness.result(tiny_cell, out, False)["correct"], out.checks


def test_the_ast_control_and_faults_fail_the_limits(tiny_cell):
    readings = control.train_readings(tiny_cell, SEED, torch.device("cpu"))
    limits = tiny_cell.workload["limits"]
    for reading, numbers in readings.items():
        assert [k for k, v in numbers.items() if k in limits and v > limits[k]], (reading,
                                                                               numbers)
