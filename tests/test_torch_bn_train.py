"""Train-mode BatchNorm with its activation fused in (``ops/bn_train.py``):
the wrapper's routing, its plain version, the launch geometry, and the
kernels' names as the benchmark files them.

On the CPU the wrapper takes the plain version, ``F.batch_norm`` then the
activation, and launches nothing; the plain version is held bit for bit
to those two calls made by hand, values and gradients, with the running
statistics left alone while ``replaying``. The kernels themselves run on
a card only:

    python -m pytest --noconftest tests/test_torch_bn_train.py -m cuda

holds them to the plain version at 1e-5 of the largest reference value
(chip_smoke.py's ``F32_REL_BAR``), in both regimes (held and streamed),
both item widths and both activations.
"""

import math
import re
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark.work import kernel_group
from psla_tpu_torch.models.layers import BatchNorm, SameConv2d, conv_bn
from psla_tpu_torch.ops import bn_train

SOURCE = Path(bn_train.__file__).resolve().parents[1] / "csrc" / "bn_train.cu"
F32_REL_BAR = 1e-5
# B2's distinct (N, C, HW) at batch 100, T=1056 and at batch 24, T=3000
B2_SHAPES = [(100, c, hw) for c, hw in (
    (16, 33792), (32, 33792), (96, 33792), (24, 8448), (96, 8448), (144, 8448), (48, 2112),
    (144, 2112), (288, 2112), (88, 528), (120, 528), (288, 528), (528, 528), (720, 528),
    (208, 132), (352, 132), (720, 132), (1248, 132), (1408, 132), (2112, 132))] + [
    (24, c, hw) for c, hw in (
        (16, 96000), (32, 96000), (96, 96000), (24, 24000), (96, 24000), (144, 24000),
        (48, 6000), (144, 6000), (288, 6000), (88, 1504), (120, 1504), (288, 1504),
        (528, 1504), (720, 1504), (208, 376), (352, 376), (720, 376), (1248, 376),
        (1408, 376), (2112, 376))]


def _inputs(shape, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (torch.randn(shape, generator=g, dtype=dtype) * 2.0 + 0.5)
    dz = torch.randn(shape, generator=g, dtype=dtype)
    w = torch.rand(c, generator=g, dtype=dtype) + 0.5
    b = torch.randn(c, generator=g, dtype=dtype) * 0.1
    return x, dz, w, b


def _no_build():
    raise AssertionError("the CPU path must not build or launch the kernels")


@pytest.mark.parametrize("act", bn_train.ACTS)
def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(monkeypatch, act):
    monkeypatch.setattr(bn_train, "build", _no_build)
    before = (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW)
    x, dz, w, b = _inputs((3, 4, 5, 6), dtype=torch.float32)
    outs = []
    for fn in (bn_train.bn_act, bn_train.bn_act_plain):
        xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
        rm, rv = torch.zeros(4), torch.ones(4)
        z = fn(xr, rm, rv, wr, br, 0.01, 1e-3, act)
        z.backward(dz)
        outs.append([z.detach(), rm, rv, xr.grad, wr.grad, br.grad])
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    layer = BatchNorm(4).train()
    layer(x.requires_grad_(), act).backward(dz)
    assert (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW) == before == (0, 0)
    with pytest.raises(ValueError, match="fuses"):
        bn_train.bn_act(x, torch.zeros(4), torch.ones(4), w, b, 0.01, 1e-3, "relu")


@pytest.mark.parametrize("replaying", [False, True])
@pytest.mark.parametrize("act", ["silu", None, "relu6"])
def test_layer_equals_batch_norm_then_activation(act, replaying):
    """The layer in train mode, the activation passed in, against
    ``F.batch_norm`` then the activation written out: the same bits in the
    output, the running statistics and every gradient; while replaying the
    buffers stay as they were."""
    x, dz, w, b = _inputs((4, 3, 7, 5), seed=1)
    layer = BatchNorm(3, momentum=0.3).double().train()
    layer.replaying = replaying
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)
        layer.running_mean.copy_(torch.linspace(-1, 1, 3, dtype=torch.float64))
    rm, rv = layer.running_mean.clone(), layer.running_var.clone()
    xl, xr = x.clone().requires_grad_(), x.clone().requires_grad_()
    wr, br = w.clone().requires_grad_(), b.clone().requires_grad_()
    got = layer(xl, act)
    got.backward(dz)
    y = F.batch_norm(xr, rm, rv, wr, br, True, 0.3, layer.eps)
    want = {"silu": F.silu, "relu6": F.relu6, None: lambda t: t}[act](y)
    want.backward(dz)
    assert torch.equal(got, want)
    assert torch.equal(xl.grad, xr.grad)
    assert torch.equal(layer.weight.grad, wr.grad)
    assert torch.equal(layer.bias.grad, br.grad)
    if replaying:
        assert torch.equal(layer.running_mean, torch.linspace(-1, 1, 3, dtype=torch.float64))
        assert torch.equal(layer.running_var, torch.ones(3, dtype=torch.float64))
    else:
        assert torch.equal(layer.running_mean, rm)
        assert torch.equal(layer.running_var, rv)


def test_conv_bn_hands_its_activation_to_the_layer():
    """``conv_bn`` in train and eval mode: the conv, then the layer with the
    activation, the same bits as the three written out."""
    g = torch.Generator().manual_seed(2)
    conv = SameConv2d(3, 5, 3, 2)
    conv.reset_parameters(g)
    bn = BatchNorm(5)
    x = torch.randn(2, 3, 9, 8, generator=g)
    for train in (True, False):
        bn.train(train)
        outs = []
        for fn in (lambda: conv_bn(x, conv, bn, "silu"), lambda: F.silu(bn(conv(x)))):
            with torch.no_grad():
                bn.running_mean.fill_(0.25)
                bn.running_var.fill_(2.0)
            outs.append((fn(), bn.running_mean.clone(), bn.running_var.clone()))
        for got, want in zip(*outs):
            assert torch.equal(got, want)


def _global_names() -> list[str]:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                      SOURCE.read_text())


def test_kernel_names_fall_in_the_benchmark_batchnorm_groups():
    """Every ``__global__`` of csrc/bn_train.cu is filed under BatchNorm by
    the benchmark's kernel groups (``bn_share.train`` reads them): the
    forward under its forward, the backward under its backward."""
    names = _global_names()
    assert sorted(names) == ["psla_bn_bw_train", "psla_bn_fw_train"]
    for name in names:
        # as the profiler names an instantiation
        shown = f"void {name}<1, true, 4>(float const*, float*, int, int, int)"
        group = kernel_group(shown)
        assert group.startswith("BatchNorm")
        assert group == ("BatchNorm backward" if "bn_bw" in name else "BatchNorm forward")


def test_geometry_mirrors_the_kernels_limits():
    """``geometry``'s constants are the source's, and at every B2 layer
    shape of both recipes it gives a power-of-two cluster of at most
    ``MAX_CLUSTER`` whose held runs fit ``SMEM_CAP``; a run is streamed
    only where no cluster holds it."""
    src = SOURCE.read_text()
    consts = {k: math.prod(int(f) for f in v.split("*"))
              for k, v in re.findall(r"constexpr int (k\w+) = ([0-9 *]+);", src)}
    assert consts["kSmemCap"] == bn_train.SMEM_CAP
    assert consts["kMaxCluster"] == bn_train.MAX_CLUSTER
    held_seen = {True: 0, False: 0}
    for n, c, hw in B2_SHAPES:
        for operands in (1, 2):
            g, held = bn_train.geometry(n, c, hw, 4, operands, 132)
            assert g in (1, 2, 4, 8, 16)
            items = n * hw // 4
            run_bytes = -(-items // g) * 16 * operands
            if held:
                assert run_bytes <= bn_train.SMEM_CAP
            else:
                assert -(-items // bn_train.MAX_CLUSTER) * 16 * operands > bn_train.SMEM_CAP
            held_seen[held] += 1
    assert held_seen[True] and held_seen[False]  # both regimes on the main path


def test_geometry_at_the_main_paths_shapes():
    """The regimes the source note names: at batch 100 the layers at HW
    132, 528 and 2112 held both ways, 8448 and 33792 streamed; at batch 24
    376, 1504 and 6000 held, 24000 and 96000 streamed."""
    for n, c, hw in B2_SHAPES:
        small = hw <= (2112 if n == 100 else 6000)
        for operands in (1, 2):
            assert bn_train.geometry(n, c, hw, 4, operands, 132)[1] == small, (n, c, hw)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 12, 11), (4, 6, 33, 4), (24, 4, 94, 4),
                                   (16, 3, 256, 128), (3, 5, 7, 9)])
@pytest.mark.parametrize("act", bn_train.ACTS)
def test_kernels_match_the_plain_version(shape, act):
    """Held and streamed runs, 16-byte and 4-byte items (HW 63), both
    activations: z, the running statistics after two calls, dx, dweight
    and dbias within 1e-5 of the largest reference value."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    x, dz, w, b = (t.float().cuda() for t in _inputs(shape, seed=3))
    outs = []
    before = (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW)
    for fn in (bn_train.bn_act, bn_train.bn_act_plain):
        rm = torch.zeros(shape[1], device="cuda")
        rv = torch.ones(shape[1], device="cuda")
        for _ in range(2):
            xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
            z = fn(xr, rm, rv, wr, br, 0.1, 1e-3, act)
            z.backward(dz)
        outs.append([z.detach(), rm, rv, xr.grad, wr.grad, br.grad])
    torch.cuda.synchronize()
    assert (bn_train.LAUNCHES_FW, bn_train.LAUNCHES_BW) == (before[0] + 2, before[1] + 2)
    for name, got, want in zip(("z", "running_mean", "running_var", "dx", "dweight", "dbias"),
                               *outs):
        err = float((got - want).abs().max())
        assert err <= F32_REL_BAR * float(want.abs().max()), (name, err)
