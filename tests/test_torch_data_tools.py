"""The port's data tools on the CPU against the JAX package's: the WAV
writer, ``prep_audioset``, ``prep_fsd`` and the experiment monitor
``watch``. All host code; the same numpy-seeded inputs go through both
packages.

Bars: files the JAX tools write byte for byte (datafiles, weight CSVs, WAVs)
are byte-identical; resampled PCM16 within 1 step of the JAX tool's output
and of ``data/wav.resample`` (the native resampler's filter is scipy's, its
sums run in another order).
"""

import csv
import json
import os

import numpy as np
import pytest

from psla_tpu.data.wav import write_wav as jax_write_wav
from psla_tpu.tools import prep_audioset as jax_prep_audioset
from psla_tpu.tools import prep_fsd as jax_prep_fsd
from psla_tpu.tools import watch as jax_watch
from psla_tpu_torch import assets
from psla_tpu_torch.data import native
from psla_tpu_torch.data.wav import read_wav, resample, write_wav
from psla_tpu_torch.tools import prep_audioset, prep_fsd, watch


def read_bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def pcm16(path) -> tuple[np.ndarray, int]:
    wav, sr = read_wav(path)
    return np.round(wav * 32768.0).astype(np.int32), sr


# ---------------------------------------------------------------- write_wav


@pytest.mark.parametrize("case", ["noise", "clipped", "float32_edges", "empty"])
def test_write_wav_bytes_equal_jax(tmp_path, case):
    rng = np.random.default_rng(3)
    wav = {
        "noise": 0.3 * rng.standard_normal(4000),
        "clipped": 1.7 * rng.standard_normal(4000),  # ~44% of samples past +-1
        # exact halves of a PCM16 step (round half to even), the clip edges
        "float32_edges": np.array([-1.5, -1.0, -0.5 / 32767, 0.0, 0.5 / 32767,
                                   1.5 / 32767, 1.0, 2.0], np.float32),
        "empty": np.zeros(0),
    }[case]
    for sr in (16000, 44100):
        ours, theirs = tmp_path / f"port_{sr}.wav", tmp_path / f"jax_{sr}.wav"
        write_wav(str(ours), wav, sr)
        jax_write_wav(str(theirs), wav, sr)
        assert read_bytes(ours) == read_bytes(theirs)
        back, got_sr = read_wav(str(ours))
        assert got_sr == sr and back.shape == wav.shape
        assert np.all(np.abs(back) <= 1.0)


# ------------------------------------------------------------ prep_audioset

SEGMENTS = """# Segments csv created Sun Mar 5 2017
# num_ytids=6, num_segs=6
# YTID, start_seconds, end_seconds, positive_labels
abc123, 30.000, 40.000, "/m/0,/m/1"
def456, 0.000, 10.000, "/m/1"
missing1, 5.000, 15.000, "/m/0"
ghi789, 1.000, 11.000, "/m/zzz"
bad000, 2.000, 12.000, "/m/0,/m/zzz"
both11, 3.000, 13.000, "/m/1"
"""


def audioset_fixture(root):
    seg = root / "segments.csv"
    seg.write_text(SEGMENTS)
    wav_dir = root / "wavs"
    wav_dir.mkdir()
    rng = np.random.default_rng(0)
    write_wav(str(wav_dir / "abc123.wav"), 0.2 * rng.standard_normal(4000), 16000)
    write_wav(str(wav_dir / "Ydef456.wav"), 0.2 * rng.standard_normal(4000), 16000)
    write_wav(str(wav_dir / "ghi789.wav"), 0.2 * rng.standard_normal(4000), 16000)
    (wav_dir / "bad000.wav").write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")  # undecodable
    # both names present: the plain one wins in both packages
    write_wav(str(wav_dir / "both11.wav"), 0.2 * rng.standard_normal(4000), 16000)
    write_wav(str(wav_dir / "Yboth11.wav"), 0.2 * rng.standard_normal(4000), 16000)
    label_csv = root / "labels.csv"
    label_csv.write_text("index,mid,display_name\n0,/m/0,a\n1,/m/1,b\n")
    return str(seg), str(wav_dir), str(label_csv)


def test_prep_audioset_datafile_equals_jax(tmp_path):
    seg, wav_dir, label_csv = audioset_fixture(tmp_path)
    assert prep_audioset.parse_segments_csv(seg) == jax_prep_audioset.parse_segments_csv(seg)
    for ytid in ("abc123", "def456", "missing1", "both11"):
        assert prep_audioset.find_wav(wav_dir, ytid) == jax_prep_audioset.find_wav(wav_dir, ytid)
    ours = str(tmp_path / "port" / "train.json")
    theirs = str(tmp_path / "jax" / "train.json")
    report = prep_audioset.build_datafile(seg, wav_dir, label_csv, ours)
    want = jax_prep_audioset.build_datafile(seg, wav_dir, label_csv, theirs)
    assert read_bytes(ours) == read_bytes(theirs)
    assert read_bytes(report["weight_file"]) == read_bytes(want["weight_file"])
    assert {k: v for k, v in report.items() if k != "weight_file"} == {
        "clips": 4, "missing_wavs": 1, "dropped_unknown_labels": 2}
    data = json.loads(read_bytes(ours))["data"]
    # Y-prefixed found; the undecodable clip is kept with its known mid, as
    # the JAX tool keeps it (neither decodes)
    assert [os.path.basename(e["wav"]) for e in data] == [
        "abc123.wav", "Ydef456.wav", "bad000.wav", "both11.wav"]
    assert data[2]["labels"] == "/m/0"


def test_prep_audioset_main_no_weights(tmp_path):
    seg, wav_dir, label_csv = audioset_fixture(tmp_path)
    out = tmp_path / "df" / "eval.json"
    argv = ["--segments-csv", seg, "--wav-dir", wav_dir, "--label-csv", label_csv,
            "--out", str(out), "--no-weights"]
    assert prep_audioset.main(argv) == 0
    assert not os.path.exists(str(out)[:-5] + "_weight.csv")
    jax_out = tmp_path / "jdf" / "eval.json"
    assert jax_prep_audioset.main(argv[:-2] + [str(jax_out), "--no-weights"]) == 0
    assert read_bytes(out) == read_bytes(jax_out)


# ----------------------------------------------------------------- prep_fsd


def fsd_root(root, rng, rates=(44100, 44100, 44100, 22050)):
    """An FSD50K-layout root: ground-truth CSVs and seeded tone-and-noise
    clips at ``rates`` (dev) and 44.1 kHz (eval)."""
    mids = [row["mid"] for row in csv.DictReader(open(assets.fsd50k_label_csv()))]
    gt = root / "FSD50K.ground_truth"
    gt.mkdir(parents=True)
    dev_dir, eval_dir = root / "FSD50K.dev_audio", root / "FSD50K.eval_audio"
    dev_dir.mkdir()
    eval_dir.mkdir()

    def clip(path, sr):
        n = int(rng.uniform(0.3, 1.2) * sr)
        t = np.arange(n) / sr
        x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 6000) * t) + 0.05 * rng.standard_normal(n)
        write_wav(str(path), x, sr)

    def labels():
        pick = rng.choice(len(mids), size=int(rng.integers(1, 4)), replace=False)
        return ",".join(mids[i] for i in pick)

    dev = ["fname,labels,mids,split"]
    for i, sr in enumerate(rates):
        clip(dev_dir / f"{100 + i}.wav", sr)
        dev.append(f'{100 + i},x,"{labels()}",{"val" if i == 1 else "train"}')
    ev = ["fname,labels,mids"]
    for i in range(2):
        clip(eval_dir / f"{200 + i}.wav", 44100)
        ev.append(f'{200 + i},x,"{labels()}"')
    (gt / "dev.csv").write_text("\n".join(dev) + "\n")
    (gt / "eval.csv").write_text("\n".join(ev) + "\n")
    return str(root)


def test_prep_fsd_datafiles_equal_jax(tmp_path):
    root = fsd_root(tmp_path / "fsd", np.random.default_rng(5))
    label_csv = assets.fsd50k_label_csv()
    dev16, eval16 = os.path.join(root, "dev16"), os.path.join(root, "eval16")
    ours = prep_fsd.build_datafiles(root, str(tmp_path / "port"), dev16, eval16, label_csv)
    theirs = jax_prep_fsd.build_datafiles(root, str(tmp_path / "jax"), dev16, eval16,
                                          label_csv)
    assert ours.keys() == theirs.keys() == {"fsd50k_tr_full", "fsd50k_val_full",
                                            "fsd50k_eval_full"}
    for name in ours:
        assert read_bytes(ours[name]) == read_bytes(theirs[name]), name
    weights = ours["fsd50k_tr_full"][:-5] + "_weight.csv"
    assert read_bytes(weights) == read_bytes(theirs["fsd50k_tr_full"][:-5] + "_weight.csv")
    sizes = [len(json.loads(read_bytes(ours[n]))["data"]) for n in ours]
    assert sizes == [3, 1, 2]


def test_prep_fsd_resample_dir_matches_jax(tmp_path):
    """Both tools resample the same 44.1 kHz and 22.05 kHz clips: the port's
    PCM16 within 1 step of the JAX tool's and of ``wav.resample``; the
    native path takes every 44.1 kHz file and leaves the 22.05 kHz one to
    the per-file path."""
    root = fsd_root(tmp_path / "fsd", np.random.default_rng(6))
    src = os.path.join(root, "FSD50K.dev_audio")
    ours, theirs = str(tmp_path / "port16"), str(tmp_path / "jax16")
    leftover = prep_fsd.resample_dir(src, ours, n_threads=2)
    jax_prep_fsd.resample_dir(src, theirs, n_threads=2)
    assert leftover == (1 if native.available() else 4)
    files = sorted(os.listdir(src))
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs)) == files
    for f in files:
        got, sr = pcm16(os.path.join(ours, f))
        want, jax_sr = pcm16(os.path.join(theirs, f))
        assert sr == jax_sr == 16000
        assert got.shape == want.shape and int(np.abs(got - want).max()) <= 1, f
        x, in_sr = read_wav(os.path.join(src, f))
        plain = np.round(np.clip(resample(x, in_sr, 16000), -1, 1) * 32767).astype(np.int32)
        assert got.shape == plain.shape and int(np.abs(got - plain).max()) <= 1, f


def test_prep_fsd_main(tmp_path):
    root = fsd_root(tmp_path / "fsd", np.random.default_rng(7))
    out = str(tmp_path / "datafiles")
    prep_fsd.main(["--fsd-root", root, "--out-dir", out, "--label-csv",
                   assets.fsd50k_label_csv()])
    tr = json.loads(read_bytes(os.path.join(out, "fsd50k_tr_full.json")))["data"]
    for e in tr:
        assert e["wav"].startswith(os.path.join(root, "FSD50K.dev_audio_16k"))
        assert read_wav(e["wav"])[1] == 16000
    assert os.path.exists(os.path.join(out, "fsd50k_tr_full_weight.csv"))


# -------------------------------------------------------------------- watch


def fake_exp(d, epochs_done=2, n_epochs=3, seeds=False):
    os.makedirs(d, exist_ok=True)
    cfg = dict(dataset="fsd50k", model="efficientnet", eff_b=2, n_class=200,
               batch_size=24, lr=5e-4, n_epochs=n_epochs, ensemble_seeds=2 if seeds else 1,
               target_length=3000)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    rows = np.zeros((n_epochs, 10))
    rng = np.random.default_rng(epochs_done)
    for i in range(epochs_done):
        rows[i] = rng.uniform(0.01, 0.9, 10)
    np.savetxt(os.path.join(d, "result.csv"), rows, delimiter=",")
    with open(os.path.join(d, "progress.json"), "w") as f:
        json.dump({"epoch": epochs_done, "global_step": 37 * epochs_done,
                   "best_epoch": 1, "best_metric": float(rows[0, 0])}, f)
    if seeds:
        with open(os.path.join(d, "seed_result.csv"), "w") as f:
            f.write("1,0.41,0.43\n2,0.44,0.45\n")


@pytest.mark.parametrize("seeds", [False, True], ids=["one_seed", "two_seeds"])
def test_watch_read_state_and_render_equal_jax(tmp_path, seeds):
    d = str(tmp_path / "exp")
    fake_exp(d, epochs_done=1, seeds=seeds)
    state = watch.read_state(d)
    assert state == jax_watch.read_state(d)
    text, seen = watch.render(state, 0)
    assert (text, seen) == jax_watch.render(state, 0)
    assert seen == 1 and "efficientnet-b2" in text
    fake_exp(d, epochs_done=3, seeds=seeds)
    state = watch.read_state(d)
    assert watch.render(state, seen) == jax_watch.render(state, seen)
    assert "epoch   1" not in watch.render(state, seen)[0]


def test_watch_torn_and_missing_files(tmp_path):
    d = tmp_path / "exp"
    d.mkdir()
    (d / "progress.json").write_text('{"epoch": 1, "glo')  # a poll mid-write
    (d / "result.csv").write_text("0.1,0.2\n")  # not 10 columns
    assert watch.read_state(str(d)) == jax_watch.read_state(str(d)) == {"exp_dir": str(d)}
    assert watch.render(watch.read_state(str(d))) == ("", 0)


def test_watch_main_once_and_follow(tmp_path, capsys):
    d = str(tmp_path / "exp")
    fake_exp(d, epochs_done=2)
    assert watch.main([d, "--once"]) == 0
    out = capsys.readouterr().out
    assert jax_watch.main([d, "--once"]) == 0
    assert capsys.readouterr().out == out
    fake_exp(d, epochs_done=3, n_epochs=3)
    assert watch.main([d, "--interval", "0.01"]) == 0
    assert "training complete." in capsys.readouterr().out
    assert watch.main([str(tmp_path), "--once", "--max-polls", "1"]) == 0
