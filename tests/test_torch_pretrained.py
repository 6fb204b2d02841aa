"""ImageNet initialisation from a local file (``impretrain=True``, the "P"
of PSLA) in the port, against the JAX package's.

Mirrors tests/test_pretrained.py: the resolution order (environment
variable, then the cache globs), the loud failure when nothing is on disk
(which names the canonical URL and downloads nothing), the backbone
conversion held to ``psla_tpu.models.convert.convert_imagenet_backbone`` on
the same arrays (rtol 1e-6), and the trainer loading the backbone under
``impretrain=True``. The ImageNet-layout B0 state dicts are made from a
seed (tests/test_convert.py's ``_imagenet_state_dict``: 3-channel stem,
``_fc``, no pooling head).
"""

import os
import socket

import numpy as np
import pytest
import torch

from psla_tpu.models.convert import convert_imagenet_backbone as jax_convert_backbone
from psla_tpu_torch import cli
from psla_tpu_torch.config import ExperimentConfig
from psla_tpu_torch.data.datafiles import load_datafile
from psla_tpu_torch.data.loader import AudioLoader, LoaderConfig
from psla_tpu_torch.models.convert import convert_imagenet_backbone, from_jax_variables
from psla_tpu_torch.models.pretrained import (
    IMAGENET_URLS,
    MissingPretrainedError,
    find_imagenet_checkpoint,
    load_imagenet_variables,
    resolve_imagenet_checkpoint,
)
from psla_tpu_torch.train.loop import Trainer
from tests.synth import build_corpus
from tests.test_convert import _imagenet_state_dict
from tests.test_pretrained import _mobilenet_v2_imagenet_sd
from tests.torch_port_fixtures import jax_backbone_variables, jax_variables, tmp_path  # noqa: F401

torch.set_num_threads(2)

N_CLASS = 3


@pytest.fixture
def isolated_cache(tmp_path, monkeypatch):
    """Every search location is an empty directory, and no socket connects."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("PSLA_TPU_CACHE", str(cache))
    monkeypatch.delenv("PSLA_TPU_IMAGENET_CKPT", raising=False)
    # HOME too, so a real torch hub cache cannot leak in
    monkeypatch.setenv("HOME", str(tmp_path))

    def no_network(*args, **kwargs):
        raise AssertionError("the port must not open a network connection")

    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    return str(cache)


def test_resolve_env_var_wins(isolated_cache, tmp_path, monkeypatch):
    p = tmp_path / "weights.pth"
    p.write_bytes(b"x")
    open(os.path.join(isolated_cache, "efficientnet-b2-8bb594d6.pth"), "wb").write(b"x")
    monkeypatch.setenv("PSLA_TPU_IMAGENET_CKPT", str(p))
    assert resolve_imagenet_checkpoint("efficientnet", 2) == str(p)


def test_resolve_env_var_missing_raises(isolated_cache, monkeypatch):
    monkeypatch.setenv("PSLA_TPU_IMAGENET_CKPT", "/nonexistent/w.pth")
    with pytest.raises(MissingPretrainedError, match="does not exist"):
        resolve_imagenet_checkpoint("efficientnet", 2)


def test_resolve_cache_glob(isolated_cache, tmp_path):
    path = os.path.join(isolated_cache, "efficientnet-b2-8bb594d6.pth")
    open(path, "wb").write(b"x")
    assert resolve_imagenet_checkpoint("efficientnet", 2) == path
    os.remove(path)
    adv = os.path.join(isolated_cache, "adv-efficientnet-b2-6e9d97e5.pth")
    open(adv, "wb").write(b"x")
    assert resolve_imagenet_checkpoint("efficientnet", 2) == adv
    assert find_imagenet_checkpoint("efficientnet", 0) is None
    # torch hub's cache, where the reference's efficientnet_pytorch puts it
    os.remove(adv)
    hub = tmp_path / ".cache" / "torch" / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    (hub / "efficientnet-b0-355c32eb.pth").write_bytes(b"x")
    hub_file = str(hub / "efficientnet-b0-355c32eb.pth")
    assert find_imagenet_checkpoint("efficientnet", 0) == hub_file


def test_resolve_missing_raises_with_instructions(isolated_cache):
    with pytest.raises(MissingPretrainedError) as exc:
        resolve_imagenet_checkpoint("efficientnet", 2)
    msg = str(exc.value)
    assert IMAGENET_URLS["efficientnet", 2] in msg  # the file to fetch
    assert "PSLA_TPU_IMAGENET_CKPT" in msg          # the environment variable
    assert "--pretrained-ckpt" in msg               # an explicit file
    assert "--impretrain False" in msg              # training from scratch
    # ResNet's file, torchvision's name, is found in the cache
    resnet = os.path.join(isolated_cache, "resnet50-19c8e357.pth")
    open(resnet, "wb").write(b"x")
    assert resolve_imagenet_checkpoint("resnet") == resnet
    with pytest.raises(MissingPretrainedError) as exc:
        resolve_imagenet_checkpoint("mbnet")
    assert IMAGENET_URLS["mbnet", None] in str(exc.value)


@pytest.mark.parametrize("stem", ["sum", "random"])
def test_backbone_conversion_matches_jax(stem):
    sd = _imagenet_state_dict(0, np.random.RandomState(1))
    assert sd["_conv_stem.weight"].shape[1] == 3 and "_fc.weight" in sd
    init = jax_variables(4, 7, N_CLASS)
    want = from_jax_variables(jax_convert_backbone(sd, init, stem=stem), N_CLASS)
    port_init = from_jax_variables(init, N_CLASS)
    got = convert_imagenet_backbone(sd, port_init, stem=stem)
    assert got.keys() == want.keys() == port_init.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)
    stem_w = got["effnet._conv_stem.weight"]
    if stem == "sum":
        torch.testing.assert_close(
            stem_w, torch.from_numpy(sd["_conv_stem.weight"]).sum(1, keepdim=True),
            rtol=1e-6, atol=0)
    else:
        assert torch.equal(stem_w, port_init["effnet._conv_stem.weight"])
    for k in got:  # the pooling head is the fresh model's
        if k.startswith("attention."):
            assert torch.equal(got[k], port_init[k])
    with pytest.raises(ValueError, match="unknown stem"):
        convert_imagenet_backbone(sd, port_init, stem="mean")


def test_load_imagenet_variables_reads_a_saved_file(tmp_path):
    sd = _imagenet_state_dict(0, np.random.RandomState(2))
    path = str(tmp_path / "efficientnet-b0-seeded.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    init = from_jax_variables(jax_variables(4, 7, N_CLASS), N_CLASS)
    got = load_imagenet_variables(path, "efficientnet", init)
    want = convert_imagenet_backbone(sd, init)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    # a torchvision mobilenet_v2 file converts over a fresh MBNet
    mb = _mobilenet_v2_imagenet_sd(np.random.RandomState(2))
    mb_path = str(tmp_path / "mobilenet_v2-seeded.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in mb.items()}, mb_path)
    mb_init = from_jax_variables(jax_backbone_variables("mbnet", 7, N_CLASS), N_CLASS)
    got = load_imagenet_variables(mb_path, "mbnet", mb_init)
    assert got.keys() == mb_init.keys()
    assert torch.equal(got["model.features.1.conv.0.0.weight"],
                       torch.from_numpy(mb["features.1.conv.0.0.weight"]))
    assert torch.equal(got["model.classifier.weight"], mb_init["model.classifier.weight"])


def test_backbone_of_another_size_is_refused():
    sd = _imagenet_state_dict(0, np.random.RandomState(1))
    del sd["_blocks.3._bn1.running_var"]
    with pytest.raises(ValueError, match="does not fit"):
        convert_imagenet_backbone(sd, from_jax_variables(jax_variables(4, 7, N_CLASS),
                                                          N_CLASS))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return build_corpus(str(tmp_path_factory.mktemp("corpus")), num_classes=N_CLASS,
                        clips_per_class=2, seconds=0.5, multi_label_frac=0.0)


def _trainer(corpus, exp_dir, **overrides) -> Trainer:
    datafile, label_csv = corpus
    cfg = ExperimentConfig(data_train=datafile, data_val=datafile, label_csv=label_csv,
                           exp_dir=exp_dir, n_class=N_CLASS, eff_b=0, att_head=4,
                           target_length=64, batch_size=4, n_epochs=1, num_workers=1,
                           **overrides)
    buf = cfg.preprocess_config().fbank.buffer_length(cfg.target_length)
    loader = AudioLoader(load_datafile(datafile, label_csv),
                         LoaderConfig(batch_size=4, buffer_samples=buf, num_workers=1),
                         shuffle=False)
    return Trainer(cfg, loader, loader, device="cpu")


def test_trainer_impretrain_loads_the_backbone(isolated_cache, corpus, tmp_path, monkeypatch):
    sd = _imagenet_state_dict(0, np.random.RandomState(3))
    path = str(tmp_path / "imagenet_b0.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, path)
    monkeypatch.setenv("PSLA_TPU_IMAGENET_CKPT", path)
    trainer = _trainer(corpus, str(tmp_path / "exp"), impretrain=True)
    state = trainer.init_state()
    got = state.model.state_dict()
    torch.testing.assert_close(
        got["effnet._conv_stem.weight"],
        torch.from_numpy(sd["_conv_stem.weight"]).sum(1, keepdim=True), rtol=1e-6, atol=0)
    torch.testing.assert_close(got["effnet._bn0.running_mean"],
                               torch.from_numpy(sd["_bn0.running_mean"]), rtol=0, atol=0)
    torch.testing.assert_close(got["effnet._bn1.running_mean"],
                               torch.from_numpy(sd["_bn1.running_mean"]), rtol=0, atol=0)
    fresh = trainer._new_model().state_dict()
    assert all(torch.equal(got[k], fresh[k]) for k in got if k.startswith("attention."))


def test_impretrain_without_weights_is_loud(isolated_cache, corpus, tmp_path):
    with pytest.raises(MissingPretrainedError, match="efficientnet-b0"):
        _trainer(corpus, str(tmp_path / "exp"), impretrain=True).init_state()
    datafile, label_csv = corpus
    with pytest.raises(MissingPretrainedError, match="efficientnet-b0-355c32eb.pth"):
        cli.run(["--data-train", datafile, "--data-val", datafile, "--label-csv", label_csv,
                 "--exp-dir", str(tmp_path / "cli"), "--n_class", str(N_CLASS), "--eff_b",
                 "0", "--target_length", "64", "-b", "4", "-w", "1", "--impretrain", "True",
                 "--device", "cpu"])
