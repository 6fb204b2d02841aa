"""The ``torch.export`` artifact (``psla_tpu_torch/tools/export.py``) and
``psla-torch-export-chipcheck`` on the CPU: round-trip parity with the live
engine, modelled on tests/test_export.py, and the bfloat16 artifact against
the JAX package's.

The float32 artifact must reproduce ``InferenceEngine.batch_probs`` with
the same plain fbank lowering ('gemm', which the artifact pins) within 1e-6
at batches it was not traced at, average ensemble members like the engine,
pad to a fixed batch, reject batch 0, carry ``skip_norm``, and load with
``torch`` alone: a bare subprocess imports no module of this package. The
CLI's default is the bfloat16 artifact, as the JAX tool's: within 1e-6 of
the live bf16 engine, of ``load_exported`` in a bare subprocess, and within
twice JAX's own bf16-vs-float32 spread of the JAX package's bf16
``build_infer_fn`` on the same weights and waveforms (the rule of
tests/test_torch_model.py). B0, one head, 5 classes, T=32; the members are
numpy-made variables (tests/torch_port_fixtures.py).
"""

import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.models import create_model as jax_create_model
from psla_tpu.tools.export import build_infer_fn
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.tools import export as exp_mod
from psla_tpu_torch.tools import export_chipcheck
from psla_tpu_torch.tools.serve import InferenceEngine
from tests.torch_port_fixtures import jax_model, jax_variables, tmp_path  # noqa: F401

torch.set_num_threads(2)

T, N_CLASS, HEADS = 32, 5, 1
NAMES = {i: n for i, n in enumerate("abcde")}
CFG = PreprocessConfig(target_length=T, norm_mean=-4.0, norm_std=4.0)
JAX_CFG = JaxPreprocessConfig(target_length=T, norm_mean=-4.0, norm_std=4.0)
BF16_SEED = 8


def member(seed: int, dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    model = create_model("efficientnet", label_dim=N_CLASS, eff_b=0, head_num=HEADS,
                         dtype=dtype)
    model.load_state_dict(from_jax_variables(jax_variables(HEADS, seed, N_CLASS), N_CLASS))
    return model


def write_labels(path) -> str:
    path.write_text("index,mid,display_name\n"
                    + "".join(f"{i},/m/{i},{n}\n" for i, n in NAMES.items()))
    return str(path)


def ragged_batch(seed: int, bsz: int = 3):
    """(wav, mean, lengths): noise clips, the last one half a chunk long."""
    chunk = CFG.fbank.buffer_length(T)
    wav = (0.1 * np.random.default_rng(seed).standard_normal((bsz, chunk))).astype(np.float32)
    lengths = np.full((bsz,), chunk, np.int32)
    lengths[-1] = chunk // 2
    wav[-1, lengths[-1]:] = 0.0
    return wav, (wav.sum(axis=1) / lengths).astype(np.float32), lengths


def live_probs(members, config, wav, mean, lengths) -> np.ndarray:
    """The live engine's dispatch with the artifact's fbank lowering."""
    engine = InferenceEngine(members, dataclasses.replace(config, fbank_method="gemm"),
                             NAMES, batch_size=2, device="cpu")
    try:
        return engine.batch_probs(wav, mean, lengths)
    finally:
        engine.close()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One symbolic-batch single-member export, and the artifact loaded,
    shared by the fast tests."""
    members = [member(3)]
    exported, meta = exp_mod.export_model(members, CFG, NAMES, device="cpu")
    out = str(tmp_path_factory.mktemp("export"))
    exp_mod.save_exported(out, exported, meta)
    return out, members, exp_mod.load_exported(out, device="cpu")


def test_symbolic_batch_round_trip(artifact):
    out, members, loaded = artifact
    assert loaded.fixed_batch is None
    chunk = loaded.chunk_samples
    assert chunk == CFG.fbank.buffer_length(T)
    rng = np.random.default_rng(0)
    for bsz in (1, 3):  # neither is the traced batch (2)
        wav = (0.1 * rng.standard_normal((bsz, chunk))).astype(np.float32)
        lengths = np.full((bsz,), chunk, np.int32)
        lengths[-1] = chunk // 2 if bsz > 1 else chunk
        wav[-1, lengths[-1]:] = 0.0
        mean = (wav.sum(axis=1) / lengths).astype(np.float32)
        got = loaded.probs(wav, mean, lengths)
        assert got.shape == (bsz, N_CLASS)
        np.testing.assert_allclose(got, live_probs(members, CFG, wav, mean, lengths),
                                   rtol=0, atol=1e-6)


def test_meta_contract(artifact):
    out, _, _ = artifact
    meta = json.load(open(os.path.join(out, exp_mod.META)))
    assert meta["format_version"] == exp_mod.FORMAT_VERSION
    assert meta["batch"] == "symbolic"
    assert meta["n_class"] == N_CLASS and meta["n_members"] == 1
    assert meta["names"]["0"] == "a"
    assert meta["sample_rate"] == 16000.0
    assert meta["chunk_samples"] == CFG.fbank.buffer_length(T)
    assert meta["target_length"] == T
    assert (meta["norm_mean"], meta["norm_std"], meta["skip_norm"]) == (-4.0, 4.0, False)
    assert meta["torch_version"] == torch.__version__
    assert set(meta["platforms"]) == {"cpu", "cuda"}


def test_probs_defaults_and_validation(artifact):
    out, members, loaded = artifact
    chunk = loaded.chunk_samples
    wav = np.random.default_rng(1).standard_normal(chunk).astype(np.float32)
    got = loaded.probs(wav)  # 1-D: one clip, the full chunk and its own mean
    want = live_probs(members, CFG, wav[None], np.array([wav.mean()], np.float32),
                      np.array([chunk], np.int32))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="chunk"):
        loaded.probs(np.zeros((1, chunk + 1), np.float32))


def test_predict_long_audio_chunks_and_weights(artifact):
    _, _, loaded = artifact
    chunk = loaded.chunk_samples
    wav = (0.1 * np.random.default_rng(2).standard_normal(int(2.5 * chunk))).astype(np.float32)
    got = loaded.predict(wav)
    assert got.shape == (N_CLASS,)
    rows = np.zeros((3, chunk), np.float32)
    lengths = np.array([chunk, chunk, wav.size - 2 * chunk], np.int32)
    for r in range(3):
        rows[r, : lengths[r]] = wav[r * chunk:(r + 1) * chunk]
    probs = loaded.probs(rows, np.full((3,), wav.mean(), np.float32), lengths)
    w = lengths.astype(np.float64)
    np.testing.assert_allclose(got, (probs * (w / w.sum())[:, None]).sum(0), rtol=0,
                               atol=1e-6)
    top = loaded.top_k(wav, k=2)
    assert [n for n, _ in top] == [NAMES[i] for i in np.argsort(got)[::-1][:2]]


def test_batch_zero_is_rejected():
    with pytest.raises(ValueError, match="batch must be >= 1"):
        exp_mod.export_model([member(3)], CFG, NAMES, batch=0, device="cpu")


def test_cli_fixed_batch_ensemble_skip_norm(tmp_path, capsys):
    """psla-torch-export end to end: two members, a fixed batch of 2 and
    skip_norm. The artifact is the members' mean under no normalization,
    refuses another batch in ``probs``, and pads in ``predict``."""
    label_csv = tmp_path / "labels.csv"
    label_csv.write_text("index,mid,display_name\n"
                         + "".join(f"{i},/m/{i},{n}\n" for i, n in NAMES.items()))
    ckpts = []
    for seed in (4, 5):
        path = str(tmp_path / f"m{seed}.pth")
        torch.save(member(seed).state_dict(), path)
        ckpts += ["--ckpt", path]
    out = str(tmp_path / "art")
    assert exp_mod.main(ckpts + ["--out", out, "--label-csv", str(label_csv), "--eff_b", "0",
                                 "--att_head", str(HEADS), "--target_length", str(T),
                                 "--batch", "2", "--skip_norm", "--device", "cpu",
                                 "--dtype", "float32"]) == 0
    assert "exported 2 member(s)" in capsys.readouterr().out
    meta = json.load(open(os.path.join(out, exp_mod.META)))
    assert meta["batch"] == 2 and meta["skip_norm"] is True and meta["n_members"] == 2
    assert meta["model"] == {"name": "efficientnet", "eff_b": 0, "att_head": HEADS,
                             "dtype": "float32"}
    loaded = exp_mod.load_exported(out, device="cpu")
    chunk = loaded.chunk_samples
    rng = np.random.default_rng(6)
    wav = (0.1 * rng.standard_normal((2, chunk))).astype(np.float32)
    mean = wav.mean(axis=1)
    lengths = np.full((2,), chunk, np.int32)
    members = [member(4), member(5)]
    want = live_probs(members, dataclasses.replace(CFG, skip_norm=True), wav, mean, lengths)
    np.testing.assert_allclose(loaded.probs(wav, mean, lengths), want, rtol=0, atol=1e-6)
    normalized = live_probs(members, CFG, wav, mean, lengths)
    assert np.abs(normalized - want).max() > 1e-4  # skip_norm changes the output
    with pytest.raises(ValueError, match="fixed batch"):
        loaded.probs(wav[:1])
    long = (0.1 * rng.standard_normal(int(2.5 * chunk))).astype(np.float32)
    got = loaded.predict(long)  # 3 rows, padded to 4
    rows = np.zeros((4, chunk), np.float32)
    lens = np.array([chunk, chunk, long.size - 2 * chunk, 1], np.int32)
    for r in range(3):
        rows[r, : lens[r]] = long[r * chunk:(r + 1) * chunk]
    full_mean = np.full((2,), long.mean(), np.float32)
    probs = np.concatenate([loaded.probs(rows[i:i + 2], full_mean, lens[i:i + 2])
                            for i in (0, 2)])[:3]
    w = lens[:3].astype(np.float64)
    np.testing.assert_allclose(got, (probs * (w / w.sum())[:, None]).sum(0), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="batch must be >= 1"):
        exp_mod.main(ckpts + ["--out", out, "--label-csv", str(label_csv), "--eff_b", "0",
                              "--att_head", str(HEADS), "--target_length", str(T),
                              "--batch", "0", "--device", "cpu"])


BARE = """
import sys, numpy as np, torch
before = set(sys.modules)
for artifact, inputs, out in zip(*[iter(sys.argv[1:])] * 3):
    program = torch.export.load(artifact).module()
    x = np.load(inputs)
    with torch.no_grad():
        got = program(*(torch.from_numpy(x[k]) for k in ("wav", "mean", "lengths")))
    np.save(out, got.numpy())
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "psla_tpu_torch")
print("psla_tpu_torch modules:", loaded)
sys.exit(1 if loaded else 0)
"""


@pytest.fixture(scope="module")
def bf16_artifact(tmp_path_factory):
    """``psla-torch-export`` at its defaults (the bf16 artifact) of one
    member, loaded; JAX's bf16 and float32 ``build_infer_fn`` on the same
    variables and ``ragged_batch(BF16_SEED)``, compiled and run in a thread
    meanwhile."""
    root = tmp_path_factory.mktemp("bf16_export")
    wav, mean, lengths = ragged_batch(BF16_SEED)
    variables = jax_variables(HEADS, 3, N_CLASS)

    def jax_probs():
        out = {}
        for name, model in (("bfloat16", jax_create_model(
                "efficientnet", label_dim=N_CLASS, eff_b=0, head_num=HEADS,
                dtype=jnp.bfloat16)), ("float32", jax_model(HEADS, N_CLASS))):
            fn = jax.jit(build_infer_fn(model, [variables], JAX_CFG))
            out[name] = np.asarray(fn(jnp.asarray(wav), jnp.asarray(mean),
                                      jnp.asarray(lengths)), np.float32)
        return out

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        jax_future = pool.submit(jax_probs)
        ckpt = str(root / "m3.pth")
        torch.save(member(3).state_dict(), ckpt)
        out = str(root / "art")
        assert exp_mod.main(["--ckpt", ckpt, "--out", out,
                             "--label-csv", write_labels(root / "labels.csv"),
                             "--eff_b", "0", "--att_head", str(HEADS),
                             "--target_length", str(T), "--dataset_mean", "-4.0",
                             "--dataset_std", "4.0", "--device", "cpu"]) == 0
        loaded = exp_mod.load_exported(out, device="cpu")
        jax_out = jax_future.result()
    return out, loaded, jax_out


def test_cli_defaults_to_a_bfloat16_artifact(bf16_artifact):
    out, loaded, _ = bf16_artifact
    assert exp_mod.build_parser().get_default("dtype") == "bfloat16"
    meta = json.load(open(os.path.join(out, exp_mod.META)))
    assert meta["model"] == {"name": "efficientnet", "eff_b": 0, "att_head": HEADS,
                             "dtype": "bfloat16"}
    assert loaded.dtype == "bfloat16" and meta["batch"] == "symbolic"
    # the artifact's weights are embedded in the dtype they compute in
    program = torch.export.load(os.path.join(out, exp_mod.ARTIFACT))
    held = {**program.state_dict, **program.constants}
    convs = [v for k, v in held.items() if v.dim() == 4 and v.shape[-1] in (1, 3, 5)
             and "proj" not in k]
    assert convs and all(v.dtype == torch.bfloat16 for v in convs)


def test_bfloat16_artifact_matches_jax_and_the_live_engine(bf16_artifact):
    """Within twice JAX's own bf16-vs-float32 spread of JAX's bf16 program
    (BatchNorm rounds where flax does, XLA's SiLU and PyTorch's differ in
    the last bf16 bit), and within 1e-6 of the live bf16 engine."""
    _, loaded, ref = bf16_artifact
    wav, mean, lengths = ragged_batch(BF16_SEED)
    got = loaded.probs(wav, mean, lengths)
    assert got.dtype == np.float32 and got.shape == (3, N_CLASS)
    spread = float(np.abs(ref["bfloat16"] - ref["float32"]).max())
    err = float(np.abs(got - ref["bfloat16"]).max())
    assert 0 < spread and err <= 2 * spread, (err, spread)
    live = live_probs([member(3, torch.bfloat16)], CFG, wav, mean, lengths)
    np.testing.assert_allclose(got, live, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def bare_outputs(artifact, bf16_artifact, tmp_path_factory):
    """Both artifacts run by one subprocess that imports torch and numpy
    only, outside the repo: {"float32", "bfloat16"} -> (inputs, output)."""
    root = tmp_path_factory.mktemp("bare")
    cases = {"float32": (artifact[0], 7), "bfloat16": (bf16_artifact[0], BF16_SEED)}
    argv, inputs = [], {}
    for name, (out, seed) in cases.items():
        inputs[name] = ragged_batch(seed)
        wav, mean, lengths = inputs[name]
        np.savez(root / f"{name}.npz", wav=wav, mean=mean, lengths=lengths)
        argv += [os.path.join(out, exp_mod.ARTIFACT), str(root / f"{name}.npz"),
                 str(root / f"{name}.npy")]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "2"  # the test process's own thread count
    proc = subprocess.run([sys.executable, "-c", BARE, *argv], cwd=str(root), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return {name: (inputs[name], np.load(root / f"{name}.npy")) for name in cases}


def test_bare_torch_loads_the_artifact(artifact, bare_outputs):
    """A subprocess that imports torch and numpy only, outside the repo,
    runs the artifact to the same output."""
    _, members, _ = artifact
    (wav, mean, lengths), got = bare_outputs["float32"]
    np.testing.assert_allclose(got, live_probs(members, CFG, wav, mean, lengths),
                               rtol=0, atol=1e-6)


def test_bare_torch_loads_the_bfloat16_artifact(bf16_artifact, bare_outputs):
    _, loaded, _ = bf16_artifact
    (wav, mean, lengths), got = bare_outputs["bfloat16"]
    np.testing.assert_allclose(got, loaded.probs(wav, mean, lengths), rtol=0, atol=1e-6)


def test_export_chipcheck_on_the_cpu(capsys):
    """psla-torch-export-chipcheck at small shapes with ``--device cpu``:
    exit 0 and one JSON line with the JAX tool's keys."""
    assert export_chipcheck.main(["--device", "cpu", "--eff_b", "0", "--att_head", "1",
                                  "--n_class", str(N_CLASS), "--target_length", str(T),
                                  "--batch", "2"]) == 0
    verdict = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(verdict) == {"check", "backend", "ok", "max_abs_diff_vs_native", "atol",
                            "blob_mb", "shape"}
    assert verdict["ok"] is True and verdict["backend"] == "cpu"
    assert verdict["max_abs_diff_vs_native"] <= verdict["atol"] == 1e-6
    assert verdict["shape"] == {"model": "efficientnet", "eff_b": 0, "att_head": 1,
                                "n_class": N_CLASS, "target_length": T, "batch": 2,
                                "n_members": 1}
    assert verdict["blob_mb"] > 0
