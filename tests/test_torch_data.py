"""The port's host data path against the JAX package's: samplers, sample
weights, loader batches (native and numpy decode, float32 and int16 wire,
mixup partners, the padded eval tail), the metrics, and the prefetch to the
device on the CPU.

The samplers, weights and batches are numpy on both sides, so they are held
equal; the metrics to 1e-12. Every wait on a thread has a timeout.
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch

from psla_tpu.data import AudioLoader as JaxAudioLoader
from psla_tpu.data import LoaderConfig as JaxLoaderConfig
from psla_tpu.data import load_datafile as jax_load_datafile
from psla_tpu.data.sampler import UniformSampler as JaxUniformSampler
from psla_tpu.data.sampler import WeightedSampler as JaxWeightedSampler
from psla_tpu.data.sampler import compute_sample_weights as jax_weights
from psla_tpu.data.sampler import gen_weight_file as jax_gen_weight_file
from psla_tpu.metrics import calculate_stats as jax_calculate_stats
from psla_tpu.metrics import mean_average_precision as jax_map
from psla_tpu_torch.data import native
from psla_tpu_torch.data.datafiles import load_datafile
from psla_tpu_torch.data.device_prefetch import BATCH_FIELDS, prefetch_to_device, to_device
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig, quantize_pcm16
from psla_tpu_torch.data.sampler import (
    UniformSampler,
    WeightedSampler,
    compute_sample_weights,
    gen_weight_file,
)
from psla_tpu_torch.data.wav import read_wav, resample
from psla_tpu_torch.metrics import calculate_stats, d_prime, mean_average_precision
from psla_tpu_torch.tools import gen_weight_file as gen_weight_file_cli
from psla_tpu_torch.train.step import _wav_batch
from tests.synth import build_corpus

torch.set_num_threads(2)

WAIT_S = 30


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    # multi-label clips, so the weights differ from clip to clip
    return build_corpus(str(root), num_classes=4, clips_per_class=5, seconds=0.5,
                        multi_label_frac=0.5)


def test_sample_weights_equal_the_jax_package(corpus, tmp_path):
    datafile, label_csv = corpus
    w = compute_sample_weights(load_datafile(datafile, label_csv))
    np.testing.assert_array_equal(w, jax_weights(jax_load_datafile(datafile, label_csv)))
    assert len(np.unique(w)) > 1
    a = gen_weight_file(datafile, label_csv, str(tmp_path / "port.csv"))
    b = jax_gen_weight_file(datafile, label_csv, str(tmp_path / "jax.csv"))
    assert open(a).read() == open(b).read()
    assert gen_weight_file_cli.main(["--label_indices_path", label_csv, "--datafile_path",
                                     datafile, "--out", str(tmp_path / "cli.csv")]) == 0
    assert open(tmp_path / "cli.csv").read() == open(b).read()


@pytest.mark.parametrize("seed,epoch", [(0, None), (0, 1), (3, 2), (11, 7)])
def test_samplers_draw_the_jax_index_sequences(seed, epoch):
    w = np.random.default_rng(seed).uniform(0.1, 5.0, 37)
    port, jax_s = WeightedSampler(w, seed), JaxWeightedSampler(w, seed)
    for _ in range(2):  # the stateful stream too, where epoch is None
        np.testing.assert_array_equal(port.epoch(epoch=epoch), jax_s.epoch(epoch=epoch))
        np.testing.assert_array_equal(port.epoch(20, epoch=epoch), jax_s.epoch(20, epoch=epoch))
    for host in range(3):
        port, jax_s = UniformSampler(37, seed, host, 3), JaxUniformSampler(37, seed, host, 3)
        np.testing.assert_array_equal(port.epoch(epoch=epoch), jax_s.epoch(epoch=epoch))
        np.testing.assert_array_equal(port.epoch(5, epoch=epoch), jax_s.epoch(5, epoch=epoch))
    with pytest.raises(ValueError):
        WeightedSampler(np.zeros(3))


def _loaders(corpus, native_decode: bool, **kw):
    datafile, label_csv = corpus
    shuffle = kw.pop("shuffle", True)
    bal = kw.pop("bal", False)
    df, jdf = load_datafile(datafile, label_csv), jax_load_datafile(datafile, label_csv)
    weights = compute_sample_weights(df) if bal else None
    cfg = dict(batch_size=6, buffer_samples=6000, num_workers=2, **kw)
    port = AudioLoader(df, LoaderConfig(**cfg), weights=weights, shuffle=shuffle)
    jax_l = JaxAudioLoader(jdf, JaxLoaderConfig(**cfg), weights=weights, shuffle=shuffle)
    port._native = jax_l._native = native_decode and native.available()
    return port, jax_l


@pytest.mark.parametrize("native_decode", [True, False])
@pytest.mark.parametrize("kw", [
    dict(mixup=True, seed=3, bal=True, wire="int16"),
    dict(mixup=True, seed=1, wire="float32"),
    dict(mixup=False, seed=2, wire="int16"),
    dict(shuffle=False, drop_remainder=False, wire="float32"),
    dict(shuffle=False, drop_remainder=False, wire="int16"),
])
def test_loader_batches_equal_the_jax_loader(corpus, native_decode, kw):
    port, jax_l = _loaders(corpus, native_decode, **kw)
    assert port.batches_per_epoch() == jax_l.batches_per_epoch()
    for epoch in (1, 2):
        port.set_epoch(epoch)
        jax_l.set_epoch(epoch)
        got, want = list(port), list(jax_l)
        assert len(got) == len(want) == port.batches_per_epoch()
        for b, c in zip(got, want):
            assert b.keys() == c.keys()
            for k in b:
                assert np.asarray(b[k]).dtype == np.asarray(c[k]).dtype, k
                np.testing.assert_array_equal(b[k], c[k], err_msg=k)
    if not kw.get("drop_remainder", True):
        assert int(got[-1]["n_valid"]) == 20 - 6 * 3  # the padded eval tail
        assert got[-1]["wav"].shape[0] == 6
    if kw.get("mixup"):
        assert any(not np.array_equal(b["mix_wav"], b["wav"]) for b in got)
    assert got[0]["wav"].dtype == (np.int16 if kw["wire"] == "int16" else np.float32)


def test_quantize_pcm16_round_trips_pcm16_samples():
    pcm = np.arange(-32768, 32768, 7, dtype=np.int16)
    f32 = pcm.astype(np.float32) / 32768.0
    np.testing.assert_array_equal(quantize_pcm16(f32), pcm)
    np.testing.assert_array_equal(quantize_pcm16(np.array([2.0, -2.0], np.float32)),
                                  [32767, -32768])


@pytest.mark.parametrize("seed", [0, 1])
def test_calculate_stats_matches_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    target = (rng.uniform(size=(300, 6)) < 0.3).astype(np.float64)
    target[:, 5] = 0.0  # a class without positives: AUC nan on both sides
    output = np.round(rng.uniform(size=target.shape), 2)  # ties
    got, want = calculate_stats(output, target, 50), jax_calculate_stats(output, target, 50)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=1e-12, err_msg=k)
    assert abs(mean_average_precision(output, target) - jax_map(output, target)) <= 1e-12
    assert abs(d_prime(0.8) - 1.1902) < 1e-4
    with pytest.raises(ValueError):
        calculate_stats(output[:, :2], target)


# ------------------------------------------------------------ prefetch


def _host_batches(n: int, log: list | None = None, fail_at: int | None = None,
                  closed: threading.Event | None = None):
    try:
        for i in itertools.count() if n < 0 else range(n):
            if i == fail_at:
                raise RuntimeError(f"decode failed at batch {i}")
            if log is not None:
                log.append(i)
            b = {k: np.full((2, 3), i, np.float32) for k in BATCH_FIELDS}
            b["length"] = np.array([i, i], np.int32)
            b["n_valid"] = np.int32(i)
            yield b
    finally:
        if closed is not None:
            closed.set()


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetch_keeps_order_and_pairing(depth):
    src = list(_host_batches(7))
    out = list(prefetch_to_device(iter(src), "cpu", depth=depth))
    assert len(out) == 7
    for i, (hb, db) in enumerate(out):
        assert hb is src[i] and db.keys() == set(BATCH_FIELDS)
        for k in BATCH_FIELDS:
            assert isinstance(db[k], torch.Tensor) and db[k].device.type == "cpu"
            np.testing.assert_array_equal(db[k].numpy(), hb[k])
        assert db["length"].dtype == torch.int32


def test_prefetch_runs_ahead():
    log: list = []
    it = prefetch_to_device(_host_batches(10, log), "cpu", depth=2)
    next(it)
    deadline = time.monotonic() + WAIT_S
    while len(log) < 4 and time.monotonic() < deadline:
        time.sleep(0.01)
    # the consumer holds batch 0, two wait in the queue, one more is staged
    assert len(log) == 4, log
    it.close()


def test_prefetch_stops_its_producer_on_an_early_break():
    closed = threading.Event()
    got = []
    for hb, _ in prefetch_to_device(_host_batches(-1, closed=closed), "cpu", depth=2):
        got.append(int(hb["n_valid"]))
        if len(got) == 3:
            break
    assert got == [0, 1, 2]
    assert closed.wait(timeout=WAIT_S), "the producer never closed the loader"


def test_prefetch_passes_a_producer_error_on():
    got = []
    with pytest.raises(RuntimeError, match="batch 3"):
        for hb, _ in prefetch_to_device(_host_batches(10, fail_at=3), "cpu", depth=2):
            got.append(int(hb["n_valid"]))
    assert got == [0, 1, 2]


def test_wav_batch_takes_device_tensors_without_a_copy():
    hb = next(_host_batches(1))
    db = to_device(hb, torch.device("cpu"))
    wb = _wav_batch(db, torch.device("cpu"))
    assert wb.wav.data_ptr() == db["wav"].data_ptr()
    assert wb.length.data_ptr() == db["length"].data_ptr()


def test_native_decode_and_resample_match_numpy_and_scipy(corpus, tmp_path):
    """The port's own build of the C++ (csrc/wavio.cc, resample.cc)."""
    datafile, label_csv = corpus
    path = load_datafile(datafile, label_csv).wav_path(3)
    if not native.available():
        pytest.skip("no C++ compiler: the loader decodes with numpy")
    wav, sr = read_wav(path)
    buf, mean, length, rate = native.decode_one(path, 10000)
    assert (rate, length) == (sr, wav.size)
    np.testing.assert_array_equal(buf[: wav.size], wav)
    assert not buf[wav.size:].any() and abs(mean - wav.mean()) < 1e-7
    dst = str(tmp_path / "8k.wav")
    status = native.resample_batch([path, path], [dst, str(tmp_path / "x.wav")], sr, 8000)
    assert status[0] == 0
    got, got_sr = read_wav(dst)
    want = resample(wav, sr, 8000)
    assert got_sr == 8000 and got.shape == want.shape
    np.testing.assert_allclose(got, np.clip(want, -1, 1), rtol=0, atol=2.0 / 32768)
    assert native.resample_batch([path], [dst], 44100, 8000)[0] == native.RATE_MISMATCH
