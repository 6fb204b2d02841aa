"""The entry points with ``--model resnet|mbnet`` on the CPU:
``convert_ckpt``, ``tools/ensemble`` (stacked and sequential),
``weight_averaging``, ``psla-torch-export`` (its ``torch.export`` round
trip), ``psla-torch-serve``'s engine, ``psla-torch-predict``, and a
1-epoch ``psla-torch-train --model mbnet`` with ``Trainer.init_state``
telling a full checkpoint from a torchvision backbone.

Members are numpy-made variables (``torch_port_fixtures.jax_backbone_variables``)
saved as ``.pth`` files with DataParallel prefixes; 7 classes, T=64, on
tests/synth.build_corpus (7 one-second tone clips). Bars: stacked against
sequential 2e-6 (tests/test_tools.py:242), the artifact and predict 1e-6
of the live path, the averaged state 1e-6 of the mean.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from psla_tpu_torch import cli
from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.data.datafiles import load_datafile, save_datafile
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.data.wav import read_wav, write_wav
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.inference import predict_long
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables, load_variables
from psla_tpu_torch.tools import convert_ckpt, ensemble, predict, serve, weight_averaging
from psla_tpu_torch.tools import export as export_tool
from psla_tpu_torch.tools.serve import InferenceEngine
from psla_tpu_torch.train.loop import Trainer
from tests.synth import build_corpus
from tests.test_pretrained import _mobilenet_v2_imagenet_sd
from tests.test_torch_backbones import NAMES, N_CLASS, T
from tests.torch_port_fixtures import jax_backbone_variables, tmp_path  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("backbone_corpus")
    return build_corpus(str(root), num_classes=N_CLASS, clips_per_class=1, seconds=1.0,
                        multi_label_frac=0.3)


def _members(name: str, root) -> list[str]:
    paths = []
    for seed in (11, 12):
        sd = from_jax_variables(jax_backbone_variables(name, seed, N_CLASS), N_CLASS)
        path = str(root / f"{name}_{seed}.pth")
        torch.save({f"module.{k}": t for k, t in sd.items()}, path)  # DataParallel keys
        paths.append(path)
    return paths


@pytest.mark.parametrize("name", NAMES)
def test_tools_take_the_backbones(name, corpus, tmp_path):
    """convert_ckpt, tools/ensemble (stacked and sequential, --att_head not
    compared) and weight_averaging with --model resnet|mbnet --device cpu on
    2 saved members."""
    datafile, label_csv = corpus
    paths = _members(name, tmp_path)
    out = str(tmp_path / "converted.pth")
    assert convert_ckpt.main(["--pth", paths[0], "--model", name, "--n-class",
                              str(N_CLASS), "--out", out]) == 0
    sd = torch.load(out, weights_only=True)
    assert sd.keys() == create_model(name, label_dim=N_CLASS).state_dict().keys()
    with pytest.raises(ValueError, match="holds a"):
        convert_ckpt.main(["--pth", paths[0], "--model", "efficientnet", "--out", out])

    common = paths + ["--data-eval", datafile, "--label-csv", label_csv, "--model", name,
                      "--n_class", str(N_CLASS), "--target_length", str(T),
                      "--batch-size", "4", "--att_head", "4", "--device", "cpu"]
    preds = {}
    for mode, extra in (("stacked", []), ("sequential", ["--sequential"])):
        d = str(tmp_path / mode)
        assert ensemble.main(common + ["--out-dir", d] + extra) == 0
        preds[mode] = np.stack([np.loadtxt(os.path.join(d, f"predictions_{i}.csv"),
                                           delimiter=",") for i in range(2)])
    assert preds["stacked"].shape == (2, N_CLASS, N_CLASS)
    np.testing.assert_allclose(preds["stacked"], preds["sequential"], atol=2e-6, rtol=0)
    assert np.abs(preds["stacked"][0] - preds["stacked"][1]).max() > 1e-3

    loader, pre, n_class = ensemble.eval_setup(ensemble.eval_parser("x").parse_args(common))
    res = weight_averaging.weight_average_eval(paths, loader, pre, model_name=name,
                                               n_class=n_class, device="cpu", att_head=4)
    members = [load_variables(p) for p in paths]
    for k, t in res["state_dict"].items():
        if t.is_floating_point():
            torch.testing.assert_close(t, (members[0][k] + members[1][k]) / 2,
                                       rtol=0, atol=1e-6)
    assert res["predictions"].shape == (N_CLASS, N_CLASS) and np.isfinite(res["mAP"])
    assert weight_averaging.main(common) == 0


@pytest.mark.parametrize("name", NAMES)
def test_serving_tools_take_the_backbones(name, corpus, tmp_path):
    """psla-torch-export (its torch.export round trip within 1e-6 of the
    live engine on the artifact's 'gemm' fbank), psla-torch-serve's engine
    in its default bfloat16, and psla-torch-predict (equal to predict_long)
    with --model resnet|mbnet --device cpu."""
    _, label_csv = corpus
    path = _members(name, tmp_path)[0]
    model = create_model(name, label_dim=N_CLASS)
    model.load_state_dict(load_variables(path))
    width = ["--model", name, "--label-csv", label_csv, "--target_length", str(T),
             "--device", "cpu"]
    out = str(tmp_path / "export")
    assert export_tool.main(["--ckpt", path, "--out", out, "--dtype", "float32"] + width) == 0
    loaded = export_tool.load_exported(out, device="cpu")
    chunk = loaded.chunk_samples
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((3, chunk))).astype(np.float32)
    lengths = np.array([chunk, chunk // 2, chunk], np.int32)
    wav[1, lengths[1]:] = 0.0
    mean = (wav.sum(axis=1) / lengths).astype(np.float32)
    engine = InferenceEngine([model], PreprocessConfig(target_length=T, fbank_method="gemm"),
                             {i: str(i) for i in range(N_CLASS)}, batch_size=2, device="cpu")
    try:
        live = engine.batch_probs(wav, mean, lengths)
    finally:
        engine.close()
    np.testing.assert_allclose(loaded.probs(wav, mean, lengths), live, rtol=0, atol=1e-6)

    engine = serve.engine_from_args(serve.build_parser().parse_args(["--ckpt", path] + width))
    try:
        assert engine.members[0].dtype == torch.bfloat16
        probs = engine.predict(wav[0], 16000)
    finally:
        engine.close()
    assert probs.shape == (N_CLASS,) and np.all((probs > 0) & (probs < 1))

    clip = str(tmp_path / "clip.wav")
    long_wav = (0.1 * rng.standard_normal(int(2.5 * chunk))).astype(np.float32)
    write_wav(clip, long_wav, 16000)
    got = predict.run([clip, "--ckpt", path] + width)[clip]
    want = predict_long(model, read_wav(clip)[0], PreprocessConfig(target_length=T),
                        device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cli_trains_mbnet_and_init_state_tells_files_apart(corpus, tmp_path):
    """``cli.run --model mbnet --device cpu`` for 1 epoch (B=2, T=64, 4
    clips: 2 steps) writes finite CSVs; then
    ``Trainer.init_state`` takes the run's full MBNet checkpoint as a full
    model and a raw torchvision mobilenet_v2 file as a backbone."""
    datafile, label_csv = corpus
    sub = str(tmp_path / "train.json")
    save_datafile(sub, load_datafile(datafile, label_csv).entries[:4])
    exp = str(tmp_path / "exp")
    cli.run(["--data-train", sub, "--data-val", sub, "--label-csv", label_csv,
             "--exp-dir", exp, "--model", "mbnet", "--n_class", str(N_CLASS),
             "--target_length", str(T), "-b", "2", "-w", "1", "--n-epochs", "1",
             "--impretrain", "False", "--warmup", "False", "--wa_start", "1",
             "--wa_end", "1", "--device", "cpu"])
    result = np.loadtxt(os.path.join(exp, "result.csv"), delimiter=",")
    assert result.shape == (10,) and np.all(np.isfinite(result))
    for csv in ("predictions/predictions_1.csv", "wa_result.csv"):
        assert np.all(np.isfinite(np.loadtxt(os.path.join(exp, csv), delimiter=",")))

    full = os.path.join(exp, "models", "wa")
    raw = str(tmp_path / "mobilenet_v2-seeded.pth")
    imagenet = _mobilenet_v2_imagenet_sd(np.random.RandomState(2))
    torch.save({k: torch.from_numpy(np.asarray(x)) for k, x in imagenet.items()}, raw)
    cfg = ExperimentConfig(data_train=sub, data_val=sub, label_csv=label_csv,
                           exp_dir=str(tmp_path / "init"), model="mbnet", n_class=N_CLASS,
                           target_length=T, batch_size=2, num_workers=1)
    loader = AudioLoader(load_datafile(sub, label_csv),
                         LoaderConfig(batch_size=2, num_workers=1,
                                      buffer_samples=cfg.preprocess_config().fbank
                                      .buffer_length(T)), shuffle=False)
    states = {}
    for which, path in (("full", full), ("backbone", raw)):
        trainer = Trainer(dataclasses.replace(cfg, pretrained_ckpt=path), loader, loader,
                          device="cpu")
        states[which] = trainer.init_state().model.state_dict()
    wa = load_variables(full)
    assert all(torch.equal(states["full"][k], wa[k]) for k in wa)
    fresh = Trainer(cfg, loader, loader, device="cpu")._new_model().state_dict()
    got = states["backbone"]
    for k in got:
        if k in ("model.features.0.0.weight", "model.classifier.weight",
                 "model.classifier.bias"):
            assert torch.equal(got[k], fresh[k]), k
        else:
            assert torch.equal(got[k], torch.from_numpy(imagenet[k[len("model."):]])), k
