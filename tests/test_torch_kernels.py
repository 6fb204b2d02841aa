"""The CUDA kernels' wrappers: the fbank (psla_tpu_torch.frontend.fbank_cuda)
and the fused MBConv blocks (psla_tpu_torch.ops).

This file imports nothing of JAX, so its card tests also run where only
the port is installed:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

On the CPU the wrapper takes its plain version and never builds the
kernel; the tables the kernel reads (twiddles, window, the banks' runs of
bins) are checked here by emulating the kernel's arithmetic with them. Bar: 2e-4 abs in the log-mel
domain (f32 summation order), the JAX package's own for its kernel. The
MBConv kernels are held to their plain versions at the JAX package's bars
for the fused blocks: 2e-6 (v1) and 3e-6 (v2) abs with rtol 1e-5 in
float32, 5e-2 with fast=True.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from psla_tpu_torch import cuda_build, ops
from psla_tpu_torch.frontend import fbank_cuda
from psla_tpu_torch.frontend.fbank import (
    FbankConfig,
    fbank_batched,
    mel_bank_runs,
    mel_banks,
    pad_or_truncate,
)
from psla_tpu_torch.ops import fused_mbconv as v1
from psla_tpu_torch.ops import mbconv_vmem as v2
from tests.torch_mbconv_fixtures import nhwc_input, random_block

torch.set_num_threads(2)

ATOL = 2e-4
TARGET = 100
CFG = FbankConfig()


@functools.lru_cache(maxsize=None)
def ragged_batch():
    """[5, N] noise-plus-tone clips with lengths: full, short, zero, longer
    than the buffer, and full with a digitally silent second half."""
    n = CFG.buffer_length(TARGET)
    rng = np.random.default_rng(0)
    t = np.arange(n) / CFG.sample_frequency
    wav = (0.1 * rng.standard_normal((5, n))
           + 0.3 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    lengths = np.array([n, CFG.buffer_length(40), 0, n + 5000, n], np.int32)
    wav[1, lengths[1]:] = 0.0
    wav[2] = 0.0
    wav[4, n // 2:] = 0.0
    return wav, lengths


def _bitrev(x: np.ndarray, bits: int) -> np.ndarray:
    return np.array([int(format(int(v), f"0{bits}b")[::-1], 2) if bits else 0
                     for v in np.atleast_1d(x)])


def emulate_kernel(wav: np.ndarray, lengths: np.ndarray, config: FbankConfig,
                   target: int) -> np.ndarray:
    """csrc/fbank.cu's arithmetic on the tables the wrapper builds, in
    float64 as the kernel computes up to each bin's power: its lane/register
    layout of the packed FFT, its butterflies and twiddle tables, its split
    into the real FFT's bins and its runs of mel bins."""
    tab = fbank_cuda.kernel_tables(config)
    window = tab["window"].astype(np.float64)
    tw = tab["twiddle"][:, 0].astype(np.float64) + 1j * tab["twiddle"][:, 1]
    tw2 = tab["twiddle2"][..., 0].astype(np.float64) + 1j * tab["twiddle2"][..., 1]
    runs, weights = tab["mel_runs"], tab["mel_weights"].astype(np.float64)
    half, lanes, regs = fbank_cuda.fft_layout(config)
    nfft, ws, shift = config.padded_window_size, config.window_size, config.window_shift
    b, n = wav.shape
    out = np.zeros((b, target, config.num_mel_bins))
    for i in range(b):
        n_valid = min(config.num_frames(min(int(lengths[i]), n)), target)
        if n_valid == 0:
            continue
        frames = np.stack([wav[i, t * shift: t * shift + ws] for t in range(n_valid)])
        x = frames.astype(np.float64)
        if config.remove_dc_offset:
            x = x - x.mean(axis=1, keepdims=True)
        prev = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        x = (x - config.preemphasis_coefficient * prev) * window
        padded = np.zeros((n_valid, nfft))
        padded[:, :ws] = x
        z = padded[:, 0::2] + 1j * padded[:, 1::2]  # [F, half]
        v = z.reshape(n_valid, regs, lanes).copy()  # point a + lanes*r: v[:, r, a]
        h = regs // 2
        while h >= 1:  # in registers: DIF over r
            for r in range(regs):
                if r & h:
                    continue
                top, bot = v[:, r].copy(), v[:, r + h].copy()
                v[:, r] = top + bot
                v[:, r + h] = (top - bot) * tw[(r & (h - 1)) * (nfft // (2 * h))]
            h //= 2
        rbits, lbits = regs.bit_length() - 1, lanes.bit_length() - 1
        k2 = _bitrev(np.arange(regs), rbits)
        v = v * tw2[k2]  # register r holds bin k2 = bitrev(r)
        a = np.arange(lanes)
        h = lanes // 2
        while h >= 1:  # across lanes: DIF by xor shuffles
            other = v[:, :, a ^ h]
            bottom = (a & h) != 0
            v = np.where(bottom, (other - v) * tw[(a & (h - 1)) * (half // h)], v + other)
            h //= 2
        zf = np.zeros((n_valid, half), complex)
        zf[:, k2[:, None] + regs * _bitrev(a, lbits)[None, :]] = v
        np.testing.assert_allclose(zf, np.fft.fft(z, axis=1), atol=1e-9 * (1 + np.abs(z).sum()))
        k = np.arange(half + 1)
        zk, zc = zf[:, k & (half - 1)], np.conj(zf[:, (half - k) & (half - 1)])
        spec = 0.5 * ((zk + zc) - 1j * tw * (zk - zc))
        power = spec.real ** 2 + spec.imag ** 2
        mel = np.zeros((n_valid, config.num_mel_bins))
        for m, (first, count, offset) in enumerate(runs):
            mel[:, m] = power[:, first:first + count] @ weights[offset:offset + count]
        out[i, :n_valid] = np.log(np.maximum(mel, np.finfo(np.float32).eps))
    return out.astype(np.float32)


KERNEL_CONFIGS = [
    CFG, FbankConfig(sample_frequency=8000.0, num_mel_bins=64),
    FbankConfig(sample_frequency=1000.0, num_mel_bins=10),  # half = 16 < 32 lanes
]


@pytest.mark.parametrize("config", KERNEL_CONFIGS)
def test_kernel_tables_reproduce_the_plain_version(config):
    """The kernel's FFT layout and tables, emulated in float64, give the
    plain version's log-mel on the ragged batch."""
    wav, lengths = ragged_batch()
    ref = fbank_cuda.fbank_plain(torch.from_numpy(wav), torch.from_numpy(lengths),
                                 config, TARGET).numpy()
    got = emulate_kernel(wav, lengths, config, TARGET)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    tab = fbank_cuda.kernel_tables(config)
    half, lanes, regs = fbank_cuda.fft_layout(config)
    assert tab["twiddle"].shape == (half + 1, 2) and tab["twiddle"].dtype == np.float64
    assert tab["twiddle2"].shape == (regs, lanes, 2) and tab["twiddle2"].dtype == np.float64
    assert tab["window"].shape == (config.window_size,)


@pytest.mark.parametrize("config", KERNEL_CONFIGS)
def test_sparse_bank_table_reproduces_mel_banks(config):
    """The runs of bins and packed weights give mel_banks(config) exactly,
    all-zero rows (count 0) included."""
    banks = mel_banks(config)
    runs, weights = mel_bank_runs(config)
    dense = np.zeros_like(banks)
    for m, (first, count, offset) in enumerate(runs):
        dense[m, first:first + count] = weights[offset:offset + count]
    np.testing.assert_array_equal(dense, banks)
    assert runs.dtype == np.int32 and weights.dtype == np.float32
    assert runs[:, 2].tolist() == np.concatenate([[0], np.cumsum(runs[:-1, 1])]).tolist()
    assert weights.size == runs[:, 1].sum() == np.count_nonzero(banks)
    empty = [m for m, row in enumerate(banks) if not row.any()]
    assert all(runs[m, 1] == 0 for m in empty)
    if config == CFG:  # kaldi's 128 mels from 20 Hz leave mel 3 without a bin
        assert empty == [3]


def test_wrapper_takes_plain_version_on_cpu(monkeypatch):
    """A CPU tensor never builds or launches the kernel."""
    def no_build():
        raise AssertionError("the CUDA build must not be attempted on the CPU")

    monkeypatch.setattr(fbank_cuda, "build", no_build)
    before = fbank_cuda.LAUNCHES
    wav, lengths = (torch.from_numpy(x) for x in ragged_batch())
    got = fbank_cuda.fbank_cuda(wav, lengths, CFG, TARGET)
    ref = fbank_cuda.fbank_plain(wav, lengths, CFG, TARGET)
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    assert fbank_cuda.LAUNCHES == before == 0


def test_wrapper_checks_shapes():
    wav = torch.zeros(2, 1000)
    with pytest.raises(ValueError, match=r"\[B, N\]"):
        fbank_cuda.fbank_cuda(wav[0], None, CFG, 4)
    with pytest.raises(ValueError, match="lengths"):
        fbank_cuda.fbank_cuda(wav, torch.zeros(3, dtype=torch.int32), CFG, 4)
    with pytest.raises(ValueError, match="padded_window_size"):  # nfft 2048
        fbank_cuda.kernel_tables(FbankConfig(sample_frequency=48000.0))


@pytest.mark.cuda
@pytest.mark.parametrize("config", KERNEL_CONFIGS[:2])
@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_kernel_matches_plain_version_on_card(precision, config):
    """The hand kernel against its plain version ('fft') and the 'gemm'
    lowering on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain version's bar
    config = dataclasses.replace(config, precision=precision)
    wav, lengths = ragged_batch()
    wav_t = torch.from_numpy(wav).cuda()
    len_t = torch.from_numpy(lengths).cuda()
    before = fbank_cuda.LAUNCHES
    got = fbank_cuda.fbank_cuda(wav_t, len_t, config, TARGET)
    nolen = fbank_cuda.fbank_cuda(wav_t, None, config, TARGET)
    torch.cuda.synchronize()
    assert fbank_cuda.LAUNCHES == before + 2
    ref = fbank_cuda.fbank_plain(wav_t, len_t, config, TARGET)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=0)
    gemm, _ = fbank_batched(wav_t, len_t, config, method="gemm")
    np.testing.assert_allclose(got.cpu().numpy(), pad_or_truncate(gemm, TARGET).cpu().numpy(),
                               atol=ATOL, rtol=0)
    ref = fbank_cuda.fbank_plain(wav_t, None, config, TARGET)
    np.testing.assert_allclose(nolen.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match="float32"):
        fbank_cuda.fbank_cuda(wav_t.double(), len_t, config, TARGET)
    with pytest.raises(ValueError, match="lengths"):
        fbank_cuda.fbank_cuda(wav_t, len_t.long(), config, TARGET)
    assert fbank_cuda.LAUNCHES == before + 2


@pytest.mark.cuda
def test_kernel_takes_a_half_warp_fft_on_card():
    """nfft = 32: a 16-point packed FFT, lanes 16-31 mirroring 0-15."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    config = KERNEL_CONFIGS[2]
    wav, lengths = (torch.from_numpy(x).cuda() for x in ragged_batch())
    got = fbank_cuda.fbank_cuda(wav, lengths, config, TARGET)
    ref = fbank_cuda.fbank_plain(wav, lengths, config, TARGET)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), atol=ATOL, rtol=0)


def test_build_dir_rule(monkeypatch, tmp_path):
    """$PSLA_TPU_TORCH_BUILD_DIR, else the checkout's build/psla_tpu_torch/;
    each library is named by a digest of its source."""
    monkeypatch.delenv("PSLA_TPU_TORCH_BUILD_DIR", raising=False)
    root = cuda_build.CSRC.parents[1]
    assert cuda_build.build_dir() == root / "build" / "psla_tpu_torch"
    monkeypatch.setenv("PSLA_TPU_TORCH_BUILD_DIR", str(tmp_path))
    assert cuda_build.build_dir() == tmp_path
    libs = (fbank_cuda.LIBRARY, v1.LIBRARY, v1.PASS2_LIBRARY, v2.LIBRARY)
    assert {lib.source.name for lib in libs} == {"fbank.cu", "mbconv_pass1.cu",
                                                 "mbconv_pass2.cu", "mbconv_v2.cu"}
    assert all(lib.source.exists() for lib in libs)


def test_build_digest_covers_headers(tmp_path):
    """A library's digest changes with its source and with any .cuh header
    under csrc/, and with nothing else there."""
    src = tmp_path / "kernel.cu"
    src.write_text('#include "front.cuh"\n')
    header = tmp_path / "front.cuh"
    header.write_text("// v1\n")
    first = cuda_build.source_digest(src)
    (tmp_path / "notes.txt").write_text("not a header")
    (tmp_path / "other.cu").write_text("// another kernel")
    assert cuda_build.source_digest(src) == first
    header.write_text("// v2\n")
    second = cuda_build.source_digest(src)
    assert second != first
    (tmp_path / "more.cuh").write_text("")
    assert cuda_build.source_digest(src) != second
    src.write_text('#include "front.cuh"\n// edited\n')
    assert cuda_build.source_digest(src) not in (first, second)
    # the package's two v1 passes share csrc/mbconv_front.cuh
    assert (cuda_build.CSRC / "mbconv_front.cuh").exists()


# ------------------------------------------------------------------ MBConv

# (kernel, stride, cin, cout, expand, h, w): skip, k5, no expand, stride 2
# with even and odd extents
MBCONV_SHAPES = [
    (3, 1, 16, 16, 6, 8, 24), (5, 1, 24, 16, 6, 8, 24), (3, 1, 32, 16, 1, 8, 24),
    (3, 2, 16, 24, 6, 8, 24), (5, 2, 24, 40, 6, 7, 23), (3, 2, 16, 24, 6, 9, 25),
]


def bars(fast: bool, atol: float) -> dict:
    return dict(atol=5e-2, rtol=5e-2) if fast else dict(atol=atol, rtol=1e-5)


@pytest.mark.parametrize("shape", MBCONV_SHAPES[:3])
def test_v1_and_v2_plain_versions_agree(shape):
    """The two plain algorithms (flattened row tiles with masks; padding and
    strided slices) give the same stride-1 block."""
    kernel, _, cin, cout, expand, h, w = shape
    blk = random_block(kernel, 1, cin, cout, expand, seed=cin + h)
    x = nhwc_input(2, h, w, cin, seed=w)
    folded = ops.fold_block(blk)
    a = v1.fused_mbconv_eval_plain(x, folded, kernel, fast=False, tile=40)
    b = v2.fused_mbconv_eval_v2_plain(x, folded, kernel, 1, fast=False)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-6, rtol=1e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    assert not torch.backends.cuda.matmul.allow_tf32  # the plain versions' bar


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", MBCONV_SHAPES)
def test_mbconv_v2_kernel_matches_plain_version_on_card(shape, fast):
    _card()
    kernel, stride, cin, cout, expand, h, w = shape
    blk = random_block(kernel, stride, cin, cout, expand, seed=h * w).cuda()
    folded = ops.fold_block(blk)
    x = nhwc_input(3, h, w, cin, seed=cin).cuda()
    before = v2.LAUNCHES
    got = ops.fused_mbconv_eval_v2(x, folded, kernel, stride, fast)
    again = ops.fused_mbconv_eval_v2(x, folded, kernel, stride, fast)
    torch.cuda.synchronize()
    assert v2.LAUNCHES == before + 2
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics
    ref = v2.fused_mbconv_eval_v2_plain(x, folded, kernel, stride, fast)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **bars(fast, 3e-6))
    xb = x.bfloat16()
    got = ops.fused_mbconv_eval_v2(xb, folded, kernel, stride, fast)
    ref = v2.fused_mbconv_eval_v2_plain(xb, folded, kernel, stride, fast)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_mbconv_v2_stride2_k5_ragged_n_tile_on_card(fast):
    """B2's block 16 at 16 clips (k=5, stride 2, 8 x 66 -> 4 x 33, Cin 120,
    Ce 720, Cout 208): the project product's last N tile runs past Cout.
    The phase kernels against the plain version; at float32 a block that
    sums 720 channels is held to 1e-5 of max |ref| where it misses the
    elementwise bar only through its long sums (as chip_smoke.py holds
    every B2 block)."""
    _card()
    kernel, stride, cin, cout, expand, h, w = 5, 2, 120, 208, 6, 8, 66
    blk = random_block(kernel, stride, cin, cout, expand, seed=17).cuda()
    folded = ops.fold_block(blk)
    ce, cse = folded["wr"].shape
    geo = v2.v2_geometry(16, h, w, cin, ce, cse, cout, kernel, stride,
                         torch.cuda.get_device_properties(0).multi_processor_count,
                         True, fast, False)
    assert geo.project.tiles_n * geo.project.bn > cout  # a ragged N tile
    x = nhwc_input(16, h, w, cin, seed=5).cuda()
    before = v2.LAUNCHES
    got = ops.fused_mbconv_eval_v2(x, folded, kernel, stride, fast)
    again = ops.fused_mbconv_eval_v2(x, folded, kernel, stride, fast)
    torch.cuda.synchronize()
    assert v2.LAUNCHES == before + 2
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics
    ref = v2.fused_mbconv_eval_v2_plain(x, folded, kernel, stride, fast).cpu().numpy()
    got = got.cpu().numpy()
    assert got.shape == ref.shape == (16, 4, 33, cout)
    if fast or np.allclose(got, ref, **bars(fast, 3e-6)):
        np.testing.assert_allclose(got, ref, **bars(fast, 3e-6))
    else:
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape", [(3, 1, 12, 12, 6), (5, 2, 12, 20, 6), (3, 1, 20, 20, 1),
                                   (3, 1, 10, 14, 6)])
def test_mbconv_v2_ragged_channels_and_unaligned_input_on_card(shape, fast):
    """Channel counts that are not multiples of 8, which the wrapper pads
    with zeros for the kernels: with the residual, without it where the
    padded Cin and Cout are equal (10 -> 14), and without expand; and the
    same input starting 4 bytes past a 16-byte boundary."""
    _card()
    k, s, cin, cout, expand = shape
    folded = ops.fold_block(random_block(k, s, cin, cout, expand, seed=cin + cout).cuda())
    x = nhwc_input(3, 9, 13, cin, seed=k).cuda()
    unaligned = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape)
    unaligned.copy_(x)
    before = v2.LAUNCHES
    got = ops.fused_mbconv_eval_v2(x, folded, k, s, fast)
    shifted = ops.fused_mbconv_eval_v2(unaligned, folded, k, s, fast)
    torch.cuda.synchronize()
    assert v2.LAUNCHES == before + 2
    assert got.is_contiguous() and got.shape == (3, -(-9 // s), -(-13 // s), cout)
    torch.testing.assert_close(got, shifted, rtol=0, atol=0)
    ref = v2.fused_mbconv_eval_v2_plain(x, folded, k, s, fast)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **bars(fast, 3e-6))


# (shape, clips): the stride-1 shapes above at 3 clips, two B2 shapes at 2
# clips whose pass 2 splits the expanded channels (S > 1) over windows that
# do not divide the map's width, and a k5 shape on a W=33 map whose pass 1
# runs nine slices of one chunk
V1_CARD_CASES = [(s, 3) for s in MBCONV_SHAPES if s[1] == 1] + [
    ((3, 1, 208, 352, 6, 4, 33), 2), ((5, 1, 120, 120, 6, 8, 66), 2),
    ((5, 1, 48, 48, 6, 4, 33), 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [64, 400])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("shape,clips", V1_CARD_CASES)
def test_mbconv_v1_kernels_match_plain_versions_on_card(shape, clips, fast, tile):
    _card()
    kernel, _, cin, cout, expand, h, w = shape
    blk = random_block(kernel, 1, cin, cout, expand, seed=h + w).cuda()
    folded = ops.fold_block(blk)
    x = nhwc_input(clips, h, w, cin, seed=cout).cuda()
    p1, p2 = v1.LAUNCHES_PASS1, v1.LAUNCHES_PASS2
    sums = v1.mbconv_pass1(x, folded, kernel, fast, tile)
    again = v1.mbconv_pass1(x, folded, kernel, fast, tile)
    torch.cuda.synchronize()
    assert torch.equal(sums, again)  # no atomics
    ref = v1.pass1_plain(x, folded, kernel, fast, tile)
    # a sum of h*w activations: the per-element bar times h*w
    np.testing.assert_allclose(sums.cpu().numpy(), ref.cpu().numpy(),
                               **bars(fast, 2e-6 * h * w))
    gate = v1.se_gate(ref / float(h * w), folded).contiguous()
    got = v1.mbconv_pass2(x, folded, gate, kernel, fast, tile)
    again = v1.mbconv_pass2(x, folded, gate, kernel, fast, tile)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, again, rtol=0, atol=0)  # no atomics
    ref = v1.pass2_plain(x, folded, gate, kernel, fast, tile)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **bars(fast, 2e-6))
    block = ops.fused_mbconv_eval(x, folded, kernel, fast, tile)
    torch.cuda.synchronize()
    assert (v1.LAUNCHES_PASS1, v1.LAUNCHES_PASS2) == (p1 + 3, p2 + 3)
    ref = v1.fused_mbconv_eval_plain(x, folded, kernel, fast, tile)
    np.testing.assert_allclose(block.cpu().numpy(), ref.cpu().numpy(), **bars(fast, 2e-6))


@pytest.mark.cuda
def test_mbconv_wrappers_refuse_bad_arguments_on_card():
    _card()
    blk = random_block(3, 1, 16, 16, 6, seed=1).cuda()
    folded = ops.fold_block(blk)
    x = nhwc_input(2, 5, 7, 16, seed=1).cuda()
    launches = (v1.LAUNCHES_PASS1, v1.LAUNCHES_PASS2, v2.LAUNCHES)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_mbconv_eval(x.double(), folded, 3)
    with pytest.raises(ValueError, match="one of"):
        ops.fused_mbconv_eval_v2(x.half(), folded, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_mbconv_eval_v2(x.transpose(1, 2), folded, 3)
    cpu_folded = {k: t.cpu() for k, t in folded.items()}
    with pytest.raises(ValueError, match="is on cpu"):
        ops.fused_mbconv_eval_v2(x, cpu_folded, 3)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.fused_mbconv_eval(x, cpu_folded, 3)
    with pytest.raises(ValueError, match="gate"):
        v1.mbconv_pass2(x, folded, torch.zeros(2, 96), 3)
    assert (v1.LAUNCHES_PASS1, v1.LAUNCHES_PASS2, v2.LAUNCHES) == launches
