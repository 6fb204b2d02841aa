"""Train-mode BatchNorm given a gradient in odd strides (the port's
``models/layers.py``), on the CPU.

``F.batch_norm``'s train-mode backward on the CPU computes dx, dweight and
dbias wrong, by more than their norm, when the output's gradient is
channels-last with a non-canonical stride on a size-1 last dimension while
the input is contiguous: strides (32, 1, 16, 32) on a [4, 16, 2, 1] input,
where channels-last's own are (32, 1, 16, 16). A model hands its last
BatchNorm such a gradient when one time step is left after the last stride
(T' = 1): the pooling's ``mean(dim=2).transpose(1, 2)`` in
``EffNetAttention`` and ``ResNetAttention``. The port's ``BatchNorm`` hands
``F.batch_norm`` the gradient in its output's own strides
(``ops.bn_train._GradInOwnStrides``). tests/test_torch_qsave.py holds B0 at
T' = 1 to the JAX model.

Bars: bit for bit. The layer on the odd-strided gradient against the same
gradient made contiguous, in float64 and float32; ResNetAttention's train
step at T' = 1 against the same step with the backbone output's gradient
made contiguous by a hook, every parameter gradient. ResNet's last ReLU
hands its last BatchNorm the gradient in NCHW strides, so ResNet met this
bar before the repair too (measured at batch 2 and 4, 32 to 128 mel bins):
the test keeps it so. MobileNetV2 pools over both axes and never
transposes.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from psla_tpu_torch.models import create_model
from psla_tpu_torch.models.layers import BatchNorm
from psla_tpu_torch.train.optim import bce_loss

torch.set_num_threads(2)

SHAPE, ODD_STRIDES = (4, 16, 2, 1), (32, 1, 16, 32)


def _odd(g: torch.Tensor) -> torch.Tensor:
    return torch.empty_strided(SHAPE, ODD_STRIDES, dtype=g.dtype).copy_(g)


def _layer_grads(x: torch.Tensor, g: torch.Tensor, state: dict) -> list[torch.Tensor]:
    bn = BatchNorm(SHAPE[1]).to(x.dtype)
    bn.load_state_dict(state)
    bn.train()
    x = x.clone().requires_grad_()
    y = bn(x)
    y.backward(g)
    return [y.detach(), x.grad, bn.weight.grad, bn.bias.grad, bn.running_mean,
            bn.running_var]


def _inputs(dtype: torch.dtype):
    rng = np.random.default_rng(12)
    c = SHAPE[1]
    x, g = (torch.from_numpy(rng.standard_normal(SHAPE)).to(dtype) for _ in range(2))
    state = {"weight": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0.0, 0.1, c),
             "running_mean": rng.normal(0.0, 0.1, c), "running_var": rng.uniform(0.5, 1.5, c)}
    return x, g, {k: torch.from_numpy(v).to(dtype) for k, v in state.items()}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batchnorm_gradient_does_not_depend_on_its_strides(dtype):
    x, g, state = _inputs(dtype)
    assert g.is_contiguous() and _odd(g).stride() == ODD_STRIDES
    want = _layer_grads(x, g, state)
    got = _layer_grads(x, _odd(g), state)
    for name, a, b in zip(("y", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_raw_batch_norm_has_the_fault():
    """The fault the layer steers round is ``F.batch_norm``'s own, so the
    test above tests the repair: the raw call parts by more than the
    gradient's norm."""
    x, g, state = _inputs(torch.float64)

    def raw(grad):
        xx = x.clone().requires_grad_()
        F.batch_norm(xx, state["running_mean"].clone(), state["running_var"].clone(),
                     state["weight"], state["bias"], True, 0.01, 1e-3).backward(grad)
        return xx.grad

    want, got = raw(g), raw(_odd(g))
    rel = float((got - want).norm() / want.norm())
    print(f"raw F.batch_norm dx under strides {ODD_STRIDES}: relative error {rel:.3g}")
    assert rel > 0.1, rel


def _resnet_grads(contiguous_hook: bool) -> dict:
    """ResNetAttention's train-mode loss gradients at T' = 1 ([2, 32, 64]
    log-mel: a [2, 2048, 2, 1] backbone output); with ``contiguous_hook``
    the backbone output's gradient is copied to contiguous strides."""
    model = create_model("resnet", label_dim=4,
                         generator=torch.Generator().manual_seed(3)).train()
    if contiguous_hook:
        def hook(module, args, out):
            out.register_hook(lambda g: g.clone(memory_format=torch.contiguous_format))

        model.model.register_forward_hook(hook)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 32, 64)).astype(np.float32))
    y = torch.from_numpy(np.eye(4, dtype=np.float32)[[0, 2]])
    bce_loss(model(x), y).backward()
    return {k: p.grad for k, p in model.named_parameters()}


def test_resnet_at_one_time_step_equals_contiguous_gradient():
    want, got = _resnet_grads(True), _resnet_grads(False)
    assert want.keys() == got.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
