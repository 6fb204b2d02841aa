"""The benchmark's work counts against hand counts at small shapes."""

import math

import numpy as np

from benchmark import work
from benchmark.reference import effnet_attention, kaldi_fbank

SMALL = dict(family="effnet_attention", eff_b=0, att_head=4, n_class=10,
             num_mel_bins=32, target_length=32)


def hand_forward_flop(config: dict) -> int:
    """2 x multiply-adds of every convolution and head product: a
    convolution's output elements x its input channels a group x k x k."""
    def out(size, stride):
        return -(-size // stride)

    h, w = config["num_mel_bins"], config["target_length"]
    h, w = out(h, 2), out(w, 2)
    stem = effnet_attention._filters(32, 1.0)
    flop = 2 * h * w * stem * 1 * 9
    for blk in effnet_attention.blocks(config["eff_b"]):
        if blk["expand"] != 1:
            flop += 2 * h * w * blk["mid"] * blk["cin"]
        h, w = out(h, blk["stride"]), out(w, blk["stride"])
        flop += 2 * h * w * blk["mid"] * blk["kernel"] ** 2  # depthwise
        flop += 2 * blk["se"] * blk["mid"] * 2  # squeeze-excite on the pooled vector
        flop += 2 * h * w * blk["cout"] * blk["mid"]
    head = effnet_attention.head_width(config["eff_b"])
    flop += 2 * h * w * head * effnet_attention.blocks(config["eff_b"])[-1]["cout"]
    flop += 2 * config["att_head"] * 2 * w * head * config["n_class"]  # att and cla
    return flop


def test_forward_flop_is_the_hand_count():
    assert work.forward_flop(SMALL) == hand_forward_flop(SMALL)
    assert work.train_flop(SMALL) == 3 * hand_forward_flop(SMALL)
    assert work.forward_flop(SMALL, frames=64) == hand_forward_flop(dict(SMALL, target_length=64))


def test_fbank_bound_is_the_hand_count():
    nnz = int(np.count_nonzero(kaldi_fbank.mel_banks(128, 512, 16000.0)))
    got = work.fbank_bound([400, 0, 10**6], buffer=560, target=3)
    # 400 samples make one frame, 0 none, the full 560-sample buffer two
    frames = 3
    flop = frames * (5 * 400 + 2.5 * 512 * 9 + 3 * 257 + 2 * nnz + 2 * 128)
    nbytes = 4 * ((400 + 560) + 3 + 3 * 3 * 128 + 400 + nnz)
    assert math.isclose(got["flop"], flop) and got["bytes"] == nbytes
    assert math.isclose(got["s"], max(flop / 67e12, nbytes / 3.35e12))


def test_peaks_by_precision():
    assert work.peak_flop_s("float32") == 67e12
    assert work.peak_flop_s("bfloat16") == 989e12


def test_kernel_groups():
    assert work.kernel_group("void cudnn::bn_fw_tr_1C11_kernel_NCHW<float>") == "BatchNorm forward"
    assert work.kernel_group("fbank_kernel") == "fbank kernel"
    assert work.kernel_group("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "NCCL collectives"
    assert work.kernel_group("vectorized_elementwise_kernel") == work.OTHER
