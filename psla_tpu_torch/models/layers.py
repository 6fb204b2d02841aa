"""Shared building blocks: TF-SAME and torch-padded convolutions, BatchNorm,
drop-connect.

Port of ``psla_tpu/models/layers.py``. Layout is NCHW (PyTorch's), against
the JAX package's NHWC; the state_dict keeps the reference's
(efficientnet_pytorch) key names, so a conv and its BatchNorm are sibling
attributes of the block that owns them and ``conv_bn`` (the counterpart of
the JAX ``ConvBN`` module) is a function over the pair.

Parameters and BatchNorm statistics stay float32. A forward in bfloat16
casts each weight to the activation dtype at its use, as flax does with
``dtype=bfloat16``. ``for_inference`` makes the serving copy that holds
them cast once (and each eval BatchNorm's scale and shift folded once).
"""

from __future__ import annotations

import copy
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from psla_tpu_torch.models.pooling import HeadPool
from psla_tpu_torch.ops import bn_train
from psla_tpu_torch.ops.qsave import DwConvQ8Save, qdq
from psla_tpu_torch.parallel.distributed import gather_rows

BN_EPS = 1e-3
# torch's momentum convention (running = (1 - m) * running + m * batch):
# the JAX package's flax momentum 0.99, and the reference backbone's
# (efficientnet_pytorch) BatchNorm2d(momentum=0.01).
BN_MOMENTUM = 0.01


def round_filters(filters: int, width_coefficient: float, divisor: int = 8) -> int:
    """EfficientNet channel rounding (width scaling, snap to multiple of 8)."""
    filters *= width_coefficient
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:  # don't round down by more than 10%
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, depth_coefficient: float) -> int:
    """EfficientNet depth rounding (ceil)."""
    return int(math.ceil(depth_coefficient * repeats))


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of one spatial axis: asymmetric, with the
    extra element at the high end (efficientnet_pytorch's
    Conv2dStaticSamePadding, jax's 'SAME')."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _he_normal_fan_out_(conv: nn.Conv2d, generator: torch.Generator | None):
    """He-normal over fan-out (the JAX package's conv_kernel_init), zero bias."""
    fan_out = conv.out_channels * conv.kernel_size[0] * conv.kernel_size[1]
    nn.init.normal_(conv.weight, 0.0, math.sqrt(2.0 / fan_out), generator=generator)
    if conv.bias is not None:
        nn.init.zeros_(conv.bias)


class SameConv2d(nn.Conv2d):
    """Conv2d with TF-SAME padding computed from the input's extent."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, groups: int = 1, bias: bool = False):
        super().__init__(in_channels, out_channels, kernel, stride, 0,
                         groups=groups, bias=bias)

    def reset_parameters(self, generator: torch.Generator | None = None):
        _he_normal_fan_out_(self, generator)

    def pad_input(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """(the input, the conv's own padding): symmetric TF-SAME padding is
        left to the conv, asymmetric padding is applied here by ``F.pad``."""
        k, s = self.kernel_size[0], self.stride[0]
        ph = same_padding(x.shape[-2], k, s)
        pw = same_padding(x.shape[-1], k, s)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return x, (ph[0], pw[0])
        return F.pad(x, (pw[0], pw[1], ph[0], ph[1])), (0, 0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, padding = self.pad_input(x)
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, w, b, self.stride[0], padding, 1, self.groups)


class PadConv2d(nn.Conv2d):
    """Conv2d without bias, padded symmetrically by ``pad`` (torchvision's
    ResNet50 and MobileNetV2, ``nn.Conv(padding=((pad, pad), (pad, pad)))``
    in the JAX package), computing in ``dtype``: the input and the weight
    are cast to it at the point of use, as flax's ``nn.Conv(dtype=...)``
    does, whatever dtype the input arrives in."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, pad: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride, pad,
                         groups=groups, bias=False)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: torch.Generator | None = None):
        _he_normal_fan_out_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.compute_dtype), self.weight.to(self.compute_dtype),
                        None, self.stride, self.padding, 1, self.groups)


class BatchNorm(nn.Module):
    """BatchNorm2d (eps 1e-3 and momentum 0.01 by default, EfficientNet's):
    running statistics in eval mode (the mode it starts in), batch
    statistics in train mode.

    Keys match ``nn.BatchNorm2d`` (weight, bias, running_mean, running_var)
    without ``num_batches_tracked``, which ``convert.normalize_state_dict``
    drops from reference checkpoints. Statistics and affine parameters stay
    float32 whatever the activation dtype.

    Eval: an input in the parameters' dtype (float32) takes one ``addcmul``
    with the folded scale and shift; any other dtype is computed in float32
    in flax's order, ``(x - mean) * mul + bias``, and rounded once to the
    input's dtype, as
    ``flax.linen.normalization._normalize`` does (rounding the folded scale
    and shift first loses the result where ``x * mul`` and the shift
    cancel, as they do for large running means).

    Train (``psla_tpu.models.layers.ReferenceBatchNorm``): normalize with
    the biased batch variance; fold the unbiased one (x n/(n-1),
    n = B*H*W) into ``running_var`` with ``momentum`` (0.01 by default). That is
    ``F.batch_norm``'s own rule. A float32 input takes
    ``ops.bn_train.bn_act``: on a card one hand-written kernel each way,
    with the activation that follows (``act``, none or SiLU) fused in; on
    the CPU its plain version, ``F.batch_norm`` then the activation. flax's
    formula would be several passes and keep one more activation for
    backward. flax takes the batch variance as E[x^2] - E[x]^2 in float32
    (clipped at 0), ``F.batch_norm`` subtracts the mean first, which is the
    more exact: tests/test_torch_train.py holds the layer to the float64
    BatchNorm at 1e-6, and to ReferenceBatchNorm at 1e-6 plus flax's own
    rounding, which grows with n. While ``replaying``
    (the recomputed forward of a rematerialized block) the statistics are
    folded into copies, so a step updates the buffers once.

    A bfloat16 input in train mode: ``F.batch_norm`` (``bn_act_plain``, on
    a card too) takes the statistics
    in float32 and rounds the normalized output once to bfloat16, as flax's
    ``BatchNorm(dtype=bfloat16)`` does (tests/test_torch_bf16_train.py).

    ``float_out``: return the parameters' dtype, float32, whatever the
    input's (flax's ``BatchNorm(dtype=jnp.float32)``, as the JAX ResNet50
    and MobileNetV2 build it); in train mode the input is cast up first, so
    the normalized value is never rounded to the input's dtype.
    EfficientNet's BatchNorm rounds to the input's dtype
    (``dtype=self.dtype`` there).

    ``group``: a process group of several ranks, each holding an equal
    share of the batch (``train.state.replicate_state`` sets it for a
    data-parallel step). Train mode then takes the statistics of the
    global batch (``SyncBatchNormFn``), as GSPMD does for the JAX package's
    sharded batch. None is the one-process layer.

    ``forward(x, act)`` applies ``activation(., act)`` to the normalized
    value (``conv_bn`` passes its activation here, so that the train-mode
    kernels can fuse it).
    """

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM, float_out: bool = False):
        super().__init__()
        self.eps = eps
        self.momentum = momentum  # create_model(bn_momentum=...) sets EfficientNet's
        self.float_out = float_out
        self.replaying = False
        self.group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.train(False)  # eval until asked, like the model that holds it

    def forward(self, x: torch.Tensor, act: str | None = None) -> torch.Tensor:
        """The normalized ``x``, then ``activation(., act)``."""
        if not self.training:
            mul = self.eval_scale()
            return activation(_eval_normalize(
                x, mul[:, None, None], self.running_mean[:, None, None],
                self.bias[:, None, None], self.float_out), act)
        mean, var = self.running_mean, self.running_var
        if self.replaying:
            mean, var = mean.clone(), var.clone()
        if self.group is not None:
            if self.float_out:  # normalized in float32, never rounded to x's dtype
                x = x.to(self.weight.dtype)
            y, batch_mean, batch_var = SyncBatchNormFn.apply(
                x, self.weight, self.bias, self.eps, self.group)
            # F.batch_norm's rule, over the global count n
            n = x.numel() // x.shape[1] * dist.get_world_size(self.group)
            with torch.no_grad():
                m = self.momentum
                mean.mul_(1.0 - m).add_(batch_mean, alpha=m)
                var.mul_(1.0 - m).add_(batch_var * (n / (n - 1)), alpha=m)
            return activation(y, act)
        fused = act if act in bn_train.ACTS else None
        if x.dtype == torch.float32:  # the kernels on a card, their plain version here
            y = bn_train.bn_act(x, mean, var, self.weight, self.bias, self.momentum,
                                self.eps, fused)
        else:
            if self.float_out:
                x = x.to(self.weight.dtype)
            y = bn_train.bn_act_plain(x, mean, var, self.weight, self.bias, self.momentum,
                                      self.eps, fused)
        return y if fused == act else activation(y, act)

    def eval_scale(self) -> torch.Tensor:
        """[C] float32 scale of eval mode, weight / sqrt(running_var + eps)."""
        return self.weight * torch.rsqrt(self.running_var + self.eps)


def _eval_normalize(x: torch.Tensor, mul: torch.Tensor, mean: torch.Tensor,
                    bias: torch.Tensor, float_out: bool,
                    shift: torch.Tensor | None = None) -> torch.Tensor:
    """Eval-mode BatchNorm of NCHW ``x`` from [C, 1, 1] float32 ``mul``,
    running mean and bias (``shift``, bias - mean * mul, when it is held):
    one ``addcmul`` for an input in ``mul``'s dtype, else flax's order in
    float32, rounded once to the input's dtype unless ``float_out``."""
    if x.dtype == mul.dtype:
        if shift is None:
            shift = bias - mean * mul
        return torch.addcmul(shift, x, mul)
    y = (x.to(mul.dtype) - mean) * mul + bias
    return y if float_out else y.to(x.dtype)


class SyncBatchNormFn(torch.autograd.Function):
    """Train-mode batch normalization over a batch split evenly over the
    ranks of ``group``: the statistics, and the gradient through them, of
    the global batch, as one process computes them on the whole batch (up
    to the order of the sums).

    Forward: each rank's per-channel mean and biased variance, gathered
    (one collective), combined as equal-count groups (Chan's rule: the
    variance is the mean of the ranks' variances plus the variance of their
    means, which keeps the precision of a mean-first variance). Returns
    (y, mean, biased variance); the caller folds the unbiased variance,
    x n/(n-1) over the global count n, into its running statistics.

    Backward: one all-reduce of sum(dy) and sum(dy * x_hat), so that
    dx = w * invstd / n * (n * dy - sum(dy) - x_hat * sum(dy * x_hat)) is
    the gradient of every rank's loss through the global statistics; the
    weight's and bias's gradients stay this rank's sums, which the step
    averages over the ranks with the other gradients.
    ``torch.nn.SyncBatchNorm`` runs only on the card (its statistics
    kernels are CUDA's), so the port keeps its own.

    A bfloat16 input is computed in float32 both ways, as flax computes
    its statistics (``force_float32_reductions``): the statistics and the
    sums come from the input cast up, ``y`` and ``dx`` are rounded once to
    the input's dtype.
    """

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        world = dist.get_world_size(group)
        xf = _widened(x)
        var_l, mean_l = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        means, variances = gather_rows(torch.stack([mean_l, var_l]), group).unbind(1)
        mean = means.mean(0)
        var = (variances + (means - mean) ** 2).mean(0)
        invstd = torch.rsqrt(var + eps)
        y = ((xf - mean[:, None, None]) * (invstd * weight)[:, None, None]
             + bias[:, None, None])
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.group, ctx.n = group, x.numel() // x.shape[1] * world
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd = ctx.saved_tensors
        dy = _widened(dy)
        x_hat = (_widened(x) - mean[:, None, None]) * invstd[:, None, None]
        sum_dy = dy.sum((0, 2, 3))
        sum_dy_xhat = (dy * x_hat).sum((0, 2, 3))
        sums = torch.stack([sum_dy, sum_dy_xhat])
        dist.all_reduce(sums, group=ctx.group)
        n = ctx.n
        dx = (weight * invstd / n)[:, None, None] * (
            n * dy - sums[0][:, None, None] - x_hat * sums[1][:, None, None])
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None


def _widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in its own dtype where that is wider."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def set_batchnorm_group(model: nn.Module, group):
    """Point every ``BatchNorm`` of ``model`` at ``group`` (None: one
    process)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class FoldedBatchNorm(nn.Module):
    """An eval-mode ``BatchNorm`` whose scale ``mul`` and ``shift`` were
    computed once, by the expressions of ``BatchNorm.forward``, and are
    held as [C, 1, 1] float32 buffers beside the running mean and bias: the
    same bits as the layer in eval mode, with no per-call work on its
    parameters. Made by ``for_inference``; it has no train mode."""

    def __init__(self, bn: BatchNorm):
        super().__init__()
        self.float_out = bn.float_out
        with torch.no_grad():
            mul = bn.eval_scale()
            held = {"mul": mul, "shift": bn.bias - bn.running_mean * mul,
                    "mean": bn.running_mean, "bias": bn.bias}
            for name, t in held.items():
                self.register_buffer(name, t.detach()[:, None, None].clone())
        self.train(False)

    def train(self, mode: bool = True):
        if mode:
            raise RuntimeError("a serving copy (layers.for_inference) has no train mode: "
                               "train the source model and make a new copy")
        return super().train(False)

    def forward(self, x: torch.Tensor, act: str | None = None) -> torch.Tensor:
        return activation(
            _eval_normalize(x, self.mul, self.mean, self.bias, self.float_out, self.shift), act)


# the example batch [B, T, F] whose forward finds each weight's compute dtype
EXAMPLE_SHAPE = (1, 64, 64)


def for_inference(model: nn.Module, device: str | torch.device | None = None) -> nn.Module:
    """An eval-only copy of ``model`` (on ``device``, default the model's
    own) that computes the same bits as ``model.eval()`` in its compute
    dtype with no per-call work on its weights: each ``SameConv2d`` and
    ``PadConv2d`` holds its weight and bias in the dtype its forward casts
    them to, the pooling heads hold their stacked product in the dtype of
    their input (``HeadPool.freeze_projection``), and each ``BatchNorm`` is
    a ``FoldedBatchNorm``. Those dtypes come from one forward of an example
    batch with hooks, not from ``model.dtype``: ResNet50 and MobileNetV2
    feed float32 BatchNorm outputs to convolutions that compute in bf16,
    and MobileNetV2's classifier stays float32 in any dtype (it casts
    nothing, and is left as it is).

    The copy is frozen: ``train(True)`` raises, and new weights arrive by
    making a new copy from the trained model. Its state_dict is not the
    reference's layout."""
    serving = copy.deepcopy(model)
    if device is not None:
        serving.to(device)
    serving.eval().requires_grad_(False)
    dtypes = {}

    def record(mod, args):
        dtypes.setdefault(mod, mod.compute_dtype if isinstance(mod, PadConv2d)
                          else args[0].dtype)

    hooks = [m.register_forward_pre_hook(record) for m in serving.modules()
             if isinstance(m, (SameConv2d, PadConv2d, HeadPool))]
    try:
        with torch.no_grad():
            serving(torch.zeros(EXAMPLE_SHAPE, device=next(serving.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
    with torch.no_grad():
        for mod, dtype in dtypes.items():
            if isinstance(mod, HeadPool):
                mod.freeze_projection(dtype)
                continue
            mod.weight = nn.Parameter(mod.weight.to(dtype), requires_grad=False)
            if mod.bias is not None:
                mod.bias = nn.Parameter(mod.bias.to(dtype), requires_grad=False)
    for parent in list(serving.modules()):
        for name, child in list(parent.named_children()):
            if isinstance(child, BatchNorm):
                setattr(parent, name, FoldedBatchNorm(child))
    return serving


def drop_connect(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Stochastic depth (``psla_tpu.models.layers.drop_connect``): the whole
    residual branch of a sample is kept with probability 1 - rate and scaled
    by 1 / (1 - rate), or zeroed. ``keep`` is the [B] bool draw."""
    keep_prob = 1.0 - rate
    return torch.where(keep.view(-1, *(1,) * (x.dim() - 1)), x / keep_prob, 0.0)


def activation(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "relu":
        return F.relu(x)
    if act == "relu6":
        return F.relu6(x)
    if act is None:
        return x
    raise ValueError(f"unknown activation {act!r}")


ACT_COMPRESS = ("none", "q8save", "qdq")


def conv_bn(x: torch.Tensor, conv: SameConv2d, bn: BatchNorm,
            act: str | None = "silu", act_compress: str = "none") -> torch.Tensor:
    """Conv (no bias) + BatchNorm + optional activation.

    ``act_compress`` (ops/qsave.py; one of ``ACT_COMPRESS``, checked where
    the model is built) is passed for the depthwise conv only, as the JAX
    package's ``ConvBN`` applies it to grouped convs only: 'q8save' keeps
    the conv's input for backward as int8 (``DwConvQ8Save``, the same
    forward), 'qdq' feeds the conv the straight-through int8
    quantize-dequantize of its input."""
    if act_compress == "q8save":
        x, padding = conv.pad_input(x)
        x = DwConvQ8Save.apply(x, conv.weight.to(x.dtype), conv.stride[0], padding)
    else:
        x = conv(qdq(x, axis=1) if act_compress == "qdq" else x)
    return bn(x, act)
