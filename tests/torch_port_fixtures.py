"""Shared inputs for the tests of the PyTorch port (tests/test_torch_*.py).

``jax_variables`` builds a JAX EffNetAttention variable tree whose every
leaf is drawn from numpy: the tree's structure comes from
``jax.eval_shape`` (no compile), conv kernels are He-normal over fan-in
(over fan-out, the JAX package's init, the activations shrink block by
block until the output no longer depends on the input), BatchNorm
statistics are randomized (mean ~N(0, 0.1), var ~U(0.5, 1.5)) so eval
outputs are not flat, and the pooling kernels are widened so the
probabilities spread. The same tree goes through both packages.
``jax_backbone_variables`` does the same for ResNetAttention and MBNet.
``tmp_path``, imported by a test module, replaces pytest's with one that is
removed when the test ends.
"""

from __future__ import annotations

import functools
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from flax import traverse_util

from psla_tpu.models import create_model as jax_create_model


@functools.lru_cache(maxsize=None)
def jax_model(head_num: int, n_class: int):
    return jax_create_model("efficientnet", label_dim=n_class, eff_b=0,
                            head_num=head_num)


@functools.lru_cache(maxsize=None)
def jax_variables(head_num: int, seed: int, n_class: int) -> dict:
    """Numpy-filled {'params', 'batch_stats'} for EffNetAttention(b=0)."""
    model = jax_model(head_num, n_class)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 64, 128), jnp.float32),
                             train=False),
        jax.random.PRNGKey(0),
    )
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(shapes)
    out = {}
    for path, s in sorted(flat.items()):
        shape, leaf = s.shape, path[-1]
        if path[0] == "batch_stats":
            x = (rng.normal(0.0, 0.1, shape) if leaf == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif path[1] == "attention":
            if leaf == "kernel":
                a = 4.0 * np.sqrt(6.0 / shape[0])
                x = rng.uniform(-a, a, shape)
            elif leaf == "head_weight":
                x = rng.uniform(0.1, 0.4, shape)
            else:
                x = rng.normal(0.0, 0.1, shape)
        elif leaf == "kernel":  # HWIO conv kernel: He-normal over fan-in
            x = rng.normal(0.0, np.sqrt(2.0 / (shape[0] * shape[1] * shape[2])),
                           shape)
        elif leaf == "scale":
            x = rng.uniform(0.8, 1.2, shape)
        else:  # BN and SE biases
            x = rng.normal(0.0, 0.1, shape)
        out[path] = x.astype(np.float32)
    return traverse_util.unflatten_dict(out)


@functools.lru_cache(maxsize=None)
def jax_backbone(name: str, n_class: int, dtype=jnp.float32):
    return jax_create_model(name, label_dim=n_class, dtype=dtype)


@functools.lru_cache(maxsize=None)
def _backbone_shapes(name: str, n_class: int) -> list:
    """The (path, shape) leaves of the model's variables, in order."""
    model = jax_backbone(name, n_class)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 64, 64), jnp.float32), train=False),
        jax.random.PRNGKey(0),
    )
    return sorted(traverse_util.flatten_dict(shapes).items())


@functools.lru_cache(maxsize=None)
def jax_backbone_variables(name: str, seed: int, n_class: int) -> dict:
    """Numpy-filled {'params', 'batch_stats'} for ResNetAttention or MBNet,
    drawn as ``jax_variables`` draws EfficientNet's, with two changes.
    The pooling head and MBNet's classifier are at the reference's scale,
    U(-a, a) with a = sqrt(6 / fan_in), not widened. ResNet's last
    BatchNorm of each residual branch (``conv3``'s) scales by U(0.1, 0.3):
    at He-normal over fan-in every block doubles the activations' second
    moment, and over 16 blocks the probabilities saturate at 0 and 1."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in _backbone_shapes(name, n_class):
        shape, leaf = s.shape, path[-1]
        if path[0] == "batch_stats":
            x = (rng.normal(0.0, 0.1, shape) if leaf == "mean"
                 else rng.uniform(0.5, 1.5, shape))
        elif path[1] in ("attention", "classifier"):
            if leaf == "kernel":
                a = np.sqrt(6.0 / shape[0])
                x = rng.uniform(-a, a, shape)
            else:
                x = rng.normal(0.0, 0.1, shape)
        elif leaf == "kernel":  # HWIO conv kernel: He-normal over fan-in
            x = rng.normal(0.0, np.sqrt(2.0 / (shape[0] * shape[1] * shape[2])),
                           shape)
        elif leaf == "scale":
            x = rng.uniform(*((0.1, 0.3) if "conv3" in path else (0.8, 1.2)), shape)
        else:  # BN biases
            x = rng.normal(0.0, 0.1, shape)
        out[path] = x.astype(np.float32)
    return traverse_util.unflatten_dict(out)


def grad_recording(tx: optax.GradientTransformation) -> optax.GradientTransformation:
    """``tx`` after a transform that passes the gradients on unchanged and
    keeps them as its state: a step's gradients are ``opt_state[0]``."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    return optax.chain(keep, tx)


@pytest.fixture
def tmp_path(tmp_path):
    """pytest's ``tmp_path``, removed when the test ends: the port's tests
    write checkpoints of tens of MB an epoch, and pytest keeps the
    directories of its last three sessions."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)
