"""The serving copy (``psla_tpu_torch.models.layers.for_inference``) on the
CPU: the same bits as the model in eval mode, no weight cast in a call, no
train mode.

Each model family in float32 and bfloat16 on numpy-made weights carried
from the JAX package (tests/torch_port_fixtures.py): EfficientNet-B0 with
two heads on a [2, 32, 128] log-mel, ResNet50 and MobileNetV2 on
[2, 64, 64] (at 32 frames ResNet50's last strided 3x3 convolution has one
output column, a shape whose bf16 convolution on the CPU reads memory it
never wrote, so the forward is not reproducible there). The copy is held
at ``atol=0``: it runs the module's own operators on the weights the
module casts at each call, cast once.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.convert import from_jax_variables
from psla_tpu_torch.models.layers import BatchNorm, FoldedBatchNorm, for_inference
from tests.torch_port_fixtures import jax_backbone_variables, jax_variables

torch.set_num_threads(2)

N_CLASS, HEADS = 5, 2
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = {"efficientnet": (2, 32, 128), "resnet": (2, 64, 64), "mbnet": (2, 64, 64)}


def model_of(name: str, dtype: torch.dtype) -> torch.nn.Module:
    if name == "efficientnet":
        model = create_model(name, label_dim=N_CLASS, eff_b=0, head_num=HEADS, dtype=dtype)
        variables = jax_variables(HEADS, 3, N_CLASS)
    else:
        model = create_model(name, label_dim=N_CLASS, dtype=dtype)
        variables = jax_backbone_variables(name, 3, N_CLASS)
    model.load_state_dict(from_jax_variables(variables, N_CLASS))
    return model


def logmel(name: str) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(4).standard_normal(SHAPES[name]).astype(np.float32))


class CountCasts(TorchDispatchMode):
    """Counts ``aten._to_copy`` calls (all of them, and those whose source
    is one of ``weights``, by storage) and ``aten.cat`` calls."""

    def __init__(self, weights):
        super().__init__()
        self.ptrs = {t.untyped_storage().data_ptr() for t in weights}
        self.casts = self.weight_casts = self.cats = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._to_copy.default:
            self.casts += 1
            self.weight_casts += args[0].untyped_storage().data_ptr() in self.ptrs
        elif func is torch.ops.aten.cat.default:
            self.cats += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", SHAPES)
def test_serving_copy_is_bit_equal_to_eval(name, dtype):
    model = model_of(name, DTYPES[dtype])
    serving = for_inference(model)
    x = logmel(name)
    with torch.inference_mode():
        want = model.eval()(x)
        got = serving(x)
    assert got.dtype == want.dtype == torch.float32
    assert bool(torch.isfinite(want).all())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not any(isinstance(m, BatchNorm) for m in serving.modules())
    assert any(isinstance(m, FoldedBatchNorm) for m in serving.modules())
    # the source model is left as it was: float32 weights, its own BatchNorms
    assert all(t.dtype == torch.float32 for t in model.state_dict().values())
    if name == "efficientnet":  # the pooling statistics go through the held heads
        with torch.inference_mode():
            want, got = model(x, return_stats=True), serving(x, return_stats=True)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_serving_copy_casts_no_weight():
    """One bf16 EfficientNet forward: the module casts every conv weight and
    bias and stacks the heads at the call; the copy does neither. The casts
    left are the activations' (the input, BatchNorm's float32 arithmetic)."""
    model = model_of("efficientnet", torch.bfloat16)
    serving = for_inference(model)
    x = logmel("efficientnet")
    n_weights = sum(1 for m in model.modules() if isinstance(m, torch.nn.Conv2d)
                    and m not in set(model.attention.modules())
                    for t in (m.weight, m.bias) if t is not None)
    counts = {}
    for what, mod in (("module", model), ("copy", serving)):
        # no_grad: under inference_mode a cast reaches the mode as aten.to
        with torch.no_grad(), CountCasts([*mod.parameters(), *mod.buffers()]) as c:
            mod(x)
        counts[what] = c
    module, copy_ = counts["module"], counts["copy"]
    msg = (f"_to_copy: module {module.casts} ({module.weight_casts} of weights, "
           f"{module.cats} cat), copy {copy_.casts} ({copy_.weight_casts} of weights, "
           f"{copy_.cats} cat); {n_weights} conv weights and biases")
    assert module.weight_casts == n_weights and module.cats == 2, msg
    assert copy_.weight_casts == 0 and copy_.cats == 0, msg
    # the module's casts are the copy's plus one a weight and one a stacked head tensor
    assert module.casts == copy_.casts + n_weights + 2, msg


@pytest.mark.parametrize("float_out", [False, True])
def test_folded_batchnorm_has_the_bits_of_the_layer(float_out):
    """Eval BatchNorm on a bf16 input whose channel means are large against
    their spread, where x * mul and the shift cancel: the folded layer's
    held scale and shift give the layer's bits (flax's order in float32),
    rounded to bf16 or kept in float32 (``float_out``)."""
    rng = np.random.default_rng(9)
    c = 16
    bn = BatchNorm(c, float_out=float_out)
    bn.load_state_dict({
        "weight": torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)),
        "bias": torch.from_numpy(rng.normal(0.0, 0.5, c).astype(np.float32)),
        "running_mean": torch.from_numpy(rng.normal(0.0, 300.0, c).astype(np.float32)),
        "running_var": torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))})
    x = (bn.running_mean[:, None, None]
         + torch.from_numpy(rng.standard_normal((4, c, 16, 16)).astype(np.float32))).bfloat16()
    with torch.inference_mode():
        want, got = bn(x), FoldedBatchNorm(bn)(x)
    assert got.dtype == want.dtype == (torch.float32 if float_out else torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_serving_copy_has_no_train_mode():
    serving = for_inference(model_of("mbnet", torch.float32))
    serving.eval()  # eval is a no-op on the copy
    with pytest.raises(RuntimeError, match="no train mode"):
        serving.train()
    with pytest.raises(RuntimeError, match="no train mode"):
        serving.train(True)
    assert not any(p.requires_grad for p in serving.parameters())
