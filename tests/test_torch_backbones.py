"""The port's ResNet50 and MobileNetV2 (ResNetAttention, MBNet) against the
JAX package's, on the CPU: the eval forward, ``return_stats``, the weights,
bfloat16, ``predict_long`` and the ImageNet conversion. (One train step is
in tests/test_torch_backbone_train.py, the tools in
tests/test_torch_backbone_tools.py.)

The same numpy-made variables (``torch_port_fixtures.jax_backbone_variables``:
conv kernels He-normal over fan-in, randomized BatchNorm statistics) go
through both packages: the JAX tree directly, the port through
``from_jax_variables``. Sizes: log-mel [2, 64, 64], 7 classes;
``predict_long`` runs the fbank at 128 mels, T=64.

Bars, the JAX package's own:
- eval forward and ``return_stats`` 2e-5 (tests/test_torch_model.py), the
  weights' round trip exact;
- bf16 against JAX run with XLA's excess precision off (``STRICT_BF16``):
  ResNet 0.01 and MBNet 0.06, about twice the measured error, and within
  twice JAX's own bf16-vs-f32 spread on the same inputs;
- ``predict_long`` 1e-4 (tests/test_inference.py), through the exact
  pooling statistics for ResNet and the length-weighted fallback for MBNet;
- the ImageNet conversion rtol 1e-6 against ``psla_tpu.models.convert``.
"""

import functools
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import traverse_util

import psla_tpu.models.convert as jax_convert
from psla_tpu.frontend.pipeline import PreprocessConfig as JaxPreprocessConfig
from psla_tpu.inference import predict_long as jax_predict_long
from psla_tpu.models.layers import ReferenceBatchNorm
from psla_tpu.models.mobilenet import INVERTED_RESIDUAL_SETTINGS as JAX_SETTINGS
from psla_tpu_torch.frontend.pipeline import PreprocessConfig
from psla_tpu_torch.inference import _chunk_logmel, predict_long
from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import (
    convert_imagenet_mbnet,
    convert_imagenet_resnet,
    from_jax_variables,
    model_family,
)
from psla_tpu_torch.models.layers import BatchNorm, PadConv2d
from psla_tpu_torch.models.mobilenet import INVERTED_RESIDUAL_SETTINGS
from psla_tpu_torch.models.pretrained import load_imagenet_variables
from tests.test_pretrained import _mobilenet_v2_imagenet_sd, _resnet50_imagenet_sd
from tests.torch_port_fixtures import jax_backbone, jax_backbone_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CLASS = 7
ATOL = 2e-5
NAMES = ("resnet", "mbnet")
JAX_CONVERTERS = {"resnet": jax_convert.convert_resnet_attention,
                  "mbnet": jax_convert.convert_mbnet}
T = 64  # predict_long's chunks, at the fbank's 128 mels


def port_model(name: str, variables: dict, dtype=torch.float32):
    model = create_model(name, label_dim=N_CLASS, dtype=dtype)
    model.load_state_dict(from_jax_variables(variables, N_CLASS))
    return model


@functools.lru_cache(maxsize=None)
def logmel() -> np.ndarray:
    return np.random.default_rng(5).standard_normal((2, 64, 64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_reference(name: str):
    """(variables, probs, ResNet's pooling stats or None) of the JAX model
    on the shared log-mel: one compile a model."""
    v = jax_backbone_variables(name, 1, N_CLASS)
    model = jax_backbone(name, N_CLASS)

    def run(v, x):
        stats = model.apply(v, x, train=False, return_stats=True) if name == "resnet" else None
        return model.apply(v, x, train=False), stats

    probs, stats = jax.jit(run)(v, jnp.asarray(logmel()))
    return v, np.asarray(probs), None if stats is None else jax.tree.map(np.asarray, stats)


# The JAX bfloat16 forwards, in a process of their own with XLA's excess
# precision off. XLA's CPU backend computes a bf16 convolution in float32
# and, by default (--xla_allow_excess_precision), keeps its output in
# float32 where the program rounds it to bf16 (on a TPU or a GPU the output
# is bf16), which halves JAX's own bf16-vs-f32 spread on MBNet. The flag
# leaves float32 programs as they are.
STRICT_BF16 = """
import sys
import numpy as np, jax, jax.numpy as jnp
from tests.torch_port_fixtures import jax_backbone, jax_backbone_variables
n_class, out = int(sys.argv[1]), sys.argv[2]
x = jnp.asarray(np.load(sys.argv[3]))
res = {}
for name in ("resnet", "mbnet"):
    v = jax_backbone_variables(name, 1, n_class)
    model = jax_backbone(name, n_class, jnp.bfloat16)
    res[name] = np.asarray(
        jax.jit(lambda v, x: model.apply(v, x, train=False))(v, x), np.float32)
np.savez(out, **res)
"""


@functools.lru_cache(maxsize=None)
def jax_bfloat16_reference() -> dict:
    with tempfile.TemporaryDirectory() as d:
        x = os.path.join(d, "x.npy")
        np.save(x, logmel())
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_allow_excess_precision=false")
        out = os.path.join(d, "out.npz")
        proc = subprocess.run([sys.executable, "-c", STRICT_BF16, str(N_CLASS), out, x],
                              cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        with np.load(out) as z:
            return {k: z[k] for k in z.files}


# ------------------------------------------------------------------ forward


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(name):
    v, ref, _ = jax_reference(name)
    with torch.inference_mode():
        got = port_model(name, v)(torch.from_numpy(logmel())).numpy()
    assert got.shape == (2, N_CLASS) and got.dtype == np.float32
    assert np.ptp(ref) > 0.05, "probabilities too flat to prove parity"
    assert np.ptp(ref, axis=0).max() > 1e-3, "output does not depend on the input"
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_resnet_return_stats_match_jax():
    v, _, ref = jax_reference("resnet")
    with torch.inference_mode():
        got = port_model("resnet", v)(torch.from_numpy(logmel()), return_stats=True)
    for key in ("s1", "s0", "head_weight"):
        np.testing.assert_allclose(got[key].numpy(), ref[key], atol=ATOL, rtol=2e-6)


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip_exactly(name, monkeypatch):
    """from_jax_variables, then the JAX package's converter: the variables
    back exactly, and the converter reads every key of the port's
    state_dict (no key of another name, none left over)."""
    v = jax_backbone_variables(name, 20, N_CLASS)
    sd = port_model(name, v).state_dict()
    read = set()
    normalize = jax_convert.normalize_state_dict

    class Recording(dict):
        def __getitem__(self, key):
            read.add(key)
            return dict.__getitem__(self, key)

    monkeypatch.setattr(jax_convert, "normalize_state_dict",
                        lambda s: Recording(normalize(s)))
    back = JAX_CONVERTERS[name](sd, N_CLASS)
    assert read == set(sd)
    flat_v, flat_back = traverse_util.flatten_dict(v), traverse_util.flatten_dict(back)
    assert flat_back.keys() == flat_v.keys()
    for path, x in flat_v.items():
        np.testing.assert_array_equal(flat_back[path], x, err_msg=str(path))
    assert model_family(sd) == name
    assert INVERTED_RESIDUAL_SETTINGS == JAX_SETTINGS


# The port's bf16 probabilities against the strict JAX bf16 run, measured:
# ResNet 0.0046, MBNet 0.033 (JAX's own bf16-vs-f32 spread 0.0075 and
# 0.093). The bars leave about twice that.
BF16_ATOL = {"resnet": 0.01, "mbnet": 0.06}


@pytest.mark.parametrize("name", NAMES)
def test_bfloat16_forward_matches_jax(name):
    """The bf16 eval forward within ``BF16_ATOL`` of JAX's bf16 forward,
    JAX rounding each bf16 convolution's output as its program says
    (STRICT_BF16), and within twice JAX's own bf16-vs-f32 spread on the
    same inputs (the rule of tests/test_torch_model.py)."""
    v, ref32, _ = jax_reference(name)
    ref16 = jax_bfloat16_reference()[name]
    spread = float(np.abs(ref16 - ref32).max())
    assert spread > 0
    model = port_model(name, v, dtype=torch.bfloat16)
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    with torch.inference_mode():
        got = model(torch.from_numpy(logmel()))
    assert got.dtype == torch.float32
    err = float(np.abs(got.numpy() - ref16).max())
    assert err <= BF16_ATOL[name], (err, BF16_ATOL[name])
    assert err <= 2 * spread, (err, spread)


@pytest.mark.parametrize("name", NAMES)
def test_bfloat16_backbone_batchnorm_returns_float32(name):
    """Under bf16 the convolutions compute in bf16 and every BatchNorm of
    the two backbones returns float32 (flax's BatchNorm(dtype=float32)):
    the layer against flax's on a bf16 input, and the dtypes in a forward.
    EfficientNet's BatchNorm still rounds to the input's dtype."""
    rng = np.random.default_rng(6)
    c = 16
    mean = rng.normal(0.0, 2.0, c).astype(np.float32)
    var = rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale = rng.uniform(0.8, 1.2, c).astype(np.float32)
    bias = rng.normal(0.0, 0.1, c).astype(np.float32)
    x16 = jnp.asarray(mean + rng.standard_normal((2, 4, 8, c)), jnp.bfloat16)  # NHWC
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    ref = ReferenceBatchNorm(use_running_average=True, epsilon=1e-5,
                             dtype=jnp.float32).apply(variables, x16)
    assert ref.dtype == jnp.float32
    bn = BatchNorm(c, eps=1e-5, float_out=True)
    bn.load_state_dict({"weight": torch.from_numpy(scale), "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean),
                        "running_var": torch.from_numpy(var)})
    xt = torch.from_numpy(np.array(x16.astype(jnp.float32))).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = bn(xt.bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               atol=2e-6, rtol=0)

    model = create_model(name, label_dim=N_CLASS, dtype=torch.bfloat16)
    seen = {}
    for mod in model.modules():
        if isinstance(mod, (BatchNorm, PadConv2d)):
            mod.register_forward_hook(
                lambda m, args, out: seen.setdefault(type(m), set()).add(out.dtype))
    with torch.inference_mode():
        model(torch.from_numpy(logmel()))
    assert seen == {BatchNorm: {torch.float32}, PadConv2d: {torch.bfloat16}}
    assert all(m.float_out for m in model.modules() if isinstance(m, BatchNorm))
    effnet = create_model("efficientnet", label_dim=N_CLASS, eff_b=0)
    assert not any(m.float_out for m in effnet.modules() if isinstance(m, BatchNorm))


def test_create_model_builds_every_family():
    for name in ("efficientnet", "resnet", "mbnet"):
        model = create_model(name, label_dim=N_CLASS, eff_b=0, bn_momentum=0.5)
        assert not model.training and model.train() is model and model.training
        momenta = {m.momentum for m in model.modules() if isinstance(m, BatchNorm)}
        # torch's 0.1 for the two backbones whatever bn_momentum says, as
        # the JAX package keeps flax's 0.9 for them
        assert momenta == ({0.5} if name == "efficientnet" else {0.1})
    for name in ("resnet", "mbnet"):
        with pytest.raises(ValueError, match="EfficientNet-only"):
            create_model(name, label_dim=N_CLASS, remat=True)


# --------------------------------------------------------------- predict_long


@pytest.mark.parametrize("name", NAMES)
def test_predict_long_matches_jax(name):
    """2.5 chunks of 64 frames, chunk batch 2: ResNet through the exact
    pooling statistics, MBNet (no return_stats) through the length-weighted
    mean of its chunk probabilities, in both packages."""
    v = jax_backbone_variables(name, 4, N_CLASS)
    cfg = PreprocessConfig(target_length=T)
    n = int(2.5 * cfg.fbank.buffer_length(T))
    wav = (np.random.default_rng(3).standard_normal(n) * 0.1).astype(np.float32)
    want = jax_predict_long(jax_backbone(name, N_CLASS), v, wav,
                            JaxPreprocessConfig(target_length=T), chunk_batch=2)
    model = port_model(name, v)
    got = predict_long(model, wav, cfg, chunk_batch=2, device="cpu")
    assert got.shape == (N_CLASS,) and np.all(np.isfinite(got))
    assert np.ptp(want) > 1e-3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if name == "mbnet":  # by hand: the chunks' probabilities weighted by length
        chunk = cfg.fbank.buffer_length(T)
        lengths = np.array([chunk, chunk, n - 2 * chunk])
        rows = np.zeros((3, chunk), np.float32)
        for i in range(3):
            rows[i, :lengths[i]] = wav[i * chunk:(i + 1) * chunk]
        with torch.inference_mode():
            probs = model(_chunk_logmel(torch.from_numpy(rows),
                                        torch.full((3,), float(wav.mean())),
                                        torch.from_numpy(lengths.astype(np.int32)),
                                        cfg)).double().numpy()
        np.testing.assert_allclose(got, (probs * lengths[:, None]).sum(0) / lengths.sum(),
                                   atol=1e-6, rtol=0)


# --------------------------------------------------------------- ImageNet


IMAGENET = {"resnet": (_resnet50_imagenet_sd, convert_imagenet_resnet,
                       jax_convert.convert_imagenet_resnet, "model.conv1.weight"),
            "mbnet": (_mobilenet_v2_imagenet_sd, convert_imagenet_mbnet,
                      jax_convert.convert_imagenet_mbnet, "model.features.0.0.weight")}


@pytest.mark.parametrize("name", NAMES)
def test_imagenet_conversion_matches_jax(name, tmp_path):
    """A seeded torchvision-layout file (3-channel stem, ``fc`` or
    ``classifier.1``, ``num_batches_tracked``) over a fresh model: equal to
    the JAX conversion carried across; the stem, the attention head and the
    classifier are the init's, every other entry the file's."""
    make, port_convert, jax_convert_fn, stem = IMAGENET[name]
    sd = make(np.random.RandomState(1))
    init = jax_backbone_variables(name, 7, N_CLASS)
    want = from_jax_variables(jax_convert_fn(sd, init), N_CLASS)
    port_init = from_jax_variables(init, N_CLASS)
    got = port_convert(sd, port_init)
    assert got.keys() == want.keys() == port_init.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=0)
    fresh = [k for k in got if k == stem or not k.startswith("model.")
             or k.startswith("model.classifier.")]
    assert stem in fresh and len(fresh) == (5 if name == "resnet" else 3)
    for k in got:
        if k in fresh:
            assert torch.equal(got[k], port_init[k]), k
        else:
            assert torch.equal(got[k], torch.from_numpy(sd[k[len("model."):]])), k
    # from a saved file, with the keys already under "model."
    path = str(tmp_path / f"{name}-seeded.pth")
    torch.save({f"model.{k}": torch.from_numpy(np.asarray(x)) for k, x in sd.items()}, path)
    loaded = load_imagenet_variables(path, name, port_init)
    assert all(torch.equal(loaded[k], got[k]) for k in got)
    del sd[next(k for k in sd if k.endswith("bn2.running_var") or k.endswith(".2.running_var"))]
    with pytest.raises(ValueError, match="does not fit"):
        port_convert(sd, port_init)
