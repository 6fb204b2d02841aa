"""EfficientNet-B{b} with multi-head attention pooling (PSLA's
EffNetAttention, Gong, Chung & Glass, TASLP 2021, src/models/Models.py),
written as plain functions of a flat dict of float32 tensors.

The keys are the reference implementation's (efficientnet_pytorch names
under ``effnet.``, per-head ``attention.att.{h}`` / ``attention.cla.{h}``
1x1 convolutions, ``attention.head_weight``). The architecture: a 3x3
stride-2 stem, the seven MBConv stages of EfficientNet-B0 scaled by the
variant's width and depth coefficients (expand 1x1, depthwise k3/k5,
squeeze-excite at a quarter of the block's input width, project 1x1, each
convolution followed by BatchNorm with eps 1e-3, swish after all but the
projection), a 1x1 head convolution, the mean over the frequency axis,
and H attention heads over time: per head sigmoid(att) clamped to [1e-7,
1 - 1e-7] and normalized over time, weighting sigmoid(cla); the heads
summed by ``head_weight``. Convolutions use TF-SAME padding (the extra
element at the high end).

Train mode normalizes with the batch's statistics (biased variance) and
drops each residual branch per clip from the keep masks it is given, the
kept ones scaled by 1 / (1 - rate), rate = 0.2 * block / blocks. Eval mode
normalizes with the running statistics, folded here into a scale and a
shift.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import float32_products, operand

BN_EPS = 1e-3
CLAMP = 1e-7
DROP_CONNECT = 0.2
# (kernel, stride, expand, in, out, repeats) of EfficientNet-B0's stages
STAGES = ((3, 1, 1, 32, 16, 1), (3, 2, 6, 16, 24, 2), (5, 2, 6, 24, 40, 2),
          (3, 2, 6, 40, 80, 3), (5, 1, 6, 80, 112, 3), (5, 2, 6, 112, 192, 4),
          (3, 1, 6, 192, 320, 1))
# variant -> (width, depth) coefficients
SCALING = {0: (1.0, 1.0), 1: (1.0, 1.1), 2: (1.1, 1.2), 3: (1.2, 1.4),
           4: (1.4, 1.8), 5: (1.6, 2.2), 6: (1.8, 2.6), 7: (2.0, 3.1)}


def _filters(n: int, width: float) -> int:
    n *= width
    out = max(8, int(n + 4) // 8 * 8)
    return int(out + 8 if out < 0.9 * n else out)


def blocks(b: int) -> list[dict]:
    """The variant's MBConv blocks in order: kernel, stride, expanded and
    squeeze widths, in and out widths, skip, drop rate."""
    width, depth = SCALING[b]
    total = sum(math.ceil(depth * s[5]) for s in STAGES)
    out = []
    for k, s, e, cin, cout, reps in STAGES:
        cin, cout = _filters(cin, width), _filters(cout, width)
        for r in range(math.ceil(depth * reps)):
            i = cin if r == 0 else cout
            stride = s if r == 0 else 1
            out.append(dict(kernel=k, stride=stride, expand=e, cin=i, cout=cout,
                            mid=i * e, se=max(1, int(i * 0.25)),
                            skip=stride == 1 and i == cout,
                            drop=DROP_CONNECT * len(out) / total))
    return out


def head_width(b: int) -> int:
    return _filters(1280, SCALING[b][0])


def shapes(config: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every tensor of the model: name -> (shape, kind). Kinds: 'conv'
    (a kernel, drawn over its fan-in), 'bn_weight', 'bn_branch_weight' (the
    scale of the last BatchNorm of a residual branch, one added to its
    block's input), 'bn_bias', 'bn_mean', 'bn_var', 'bias', 'att' (a pooling
    head's kernel), 'att_bias', 'head_weight'."""
    b, n_class, heads = config["eff_b"], config["n_class"], config["att_head"]
    out: dict[str, tuple[tuple[int, ...], str]] = {}

    def bn(prefix, c, scale="bn_weight"):
        for leaf, kind in (("weight", scale), ("bias", "bn_bias"),
                           ("running_mean", "bn_mean"), ("running_var", "bn_var")):
            out[f"{prefix}.{leaf}"] = ((c,), kind)

    stem = _filters(32, SCALING[b][0])
    out["effnet._conv_stem.weight"] = ((stem, 1, 3, 3), "conv")
    bn("effnet._bn0", stem)
    for i, blk in enumerate(blocks(b)):
        p = f"effnet._blocks.{i}"
        if blk["expand"] != 1:
            out[f"{p}._expand_conv.weight"] = ((blk["mid"], blk["cin"], 1, 1), "conv")
            bn(f"{p}._bn0", blk["mid"])
        k = blk["kernel"]
        out[f"{p}._depthwise_conv.weight"] = ((blk["mid"], 1, k, k), "conv")
        bn(f"{p}._bn1", blk["mid"])
        out[f"{p}._se_reduce.weight"] = ((blk["se"], blk["mid"], 1, 1), "conv")
        out[f"{p}._se_reduce.bias"] = ((blk["se"],), "bias")
        out[f"{p}._se_expand.weight"] = ((blk["mid"], blk["se"], 1, 1), "conv")
        out[f"{p}._se_expand.bias"] = ((blk["mid"],), "bias")
        out[f"{p}._project_conv.weight"] = ((blk["cout"], blk["mid"], 1, 1), "conv")
        bn(f"{p}._bn2", blk["cout"], "bn_branch_weight" if blk["skip"] else "bn_weight")
    head = head_width(b)
    out["effnet._conv_head.weight"] = ((head, blocks(b)[-1]["cout"], 1, 1), "conv")
    bn("effnet._bn1", head)
    out["attention.head_weight"] = ((heads,), "head_weight")
    for name in ("att", "cla"):
        for h in range(heads):
            out[f"attention.{name}.{h}.weight"] = ((n_class, head, 1, 1), "att")
            out[f"attention.{name}.{h}.bias"] = ((n_class,), "att_bias")
    return out


def _same(size: int, k: int, s: int) -> tuple[int, int]:
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride=1, groups=1, bias=None, precision="float32"):
    k = w.shape[-1]
    ph, pw = _same(x.shape[-2], k, stride), _same(x.shape[-1], k, stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        pad = (ph[0], pw[0])
    else:
        x, pad = F.pad(x, (pw[0], pw[1], ph[0], ph[1])), (0, 0)
    return F.conv2d(operand(x, precision), operand(w, precision), bias, stride, pad, 1, groups)


def batch_norm(x, w, prefix, train):
    weight, bias = w[f"{prefix}.weight"], w[f"{prefix}.bias"]
    if train == "calibrate":  # the batch's statistics become the running ones
        return F.batch_norm(x, w[f"{prefix}.running_mean"], w[f"{prefix}.running_var"],
                            weight, bias, True, 1.0, BN_EPS)
    if train:
        return F.batch_norm(x, None, None, weight, bias, True, 0.0, BN_EPS)
    scale = weight * torch.rsqrt(w[f"{prefix}.running_var"] + BN_EPS)
    shift = bias - w[f"{prefix}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def features(w: dict, x: torch.Tensor, config: dict, train: bool | str,
             keep: torch.Tensor | None = None, precision: str = "float32") -> torch.Tensor:
    """[B, 1, F, T] -> [B, C, F/32, T/32]. ``keep``: [len(drop blocks), B]
    bool keep masks, in block order, read in train mode (``train`` True, or
    'calibrate': ``calibrate``'s pass)."""
    x = F.silu(batch_norm(conv(x, w["effnet._conv_stem.weight"], 2, precision=precision),
                          w, "effnet._bn0", train))
    masks = iter(keep) if keep is not None else None
    for i, blk in enumerate(blocks(config["eff_b"])):
        p = f"effnet._blocks.{i}"
        inputs = x
        if blk["expand"] != 1:
            x = F.silu(batch_norm(conv(x, w[f"{p}._expand_conv.weight"],
                                       precision=precision), w, f"{p}._bn0", train))
        x = F.silu(batch_norm(conv(x, w[f"{p}._depthwise_conv.weight"], blk["stride"],
                                   blk["mid"], precision=precision), w, f"{p}._bn1", train))
        s = x.mean(dim=(2, 3), keepdim=True)
        s = F.silu(conv(s, w[f"{p}._se_reduce.weight"], bias=w[f"{p}._se_reduce.bias"],
                        precision=precision))
        s = conv(s, w[f"{p}._se_expand.weight"], bias=w[f"{p}._se_expand.bias"],
                 precision=precision)
        x = x * torch.sigmoid(s)
        x = batch_norm(conv(x, w[f"{p}._project_conv.weight"], precision=precision),
                       w, f"{p}._bn2", train)
        if blk["skip"]:
            if train and blk["drop"] > 0:
                kept = next(masks)
                x = torch.where(kept[:, None, None, None], x / (1.0 - blk["drop"]), 0.0)
            x = x + inputs
    return F.silu(batch_norm(conv(x, w["effnet._conv_head.weight"], precision=precision),
                             w, "effnet._bn1", train))


def calibrate(w: dict, logmel: torch.Tensor, config: dict):
    """Set every BatchNorm's running statistics, in place, to those of the
    batch ``logmel`` (the unbiased variance), as training leaves them in a
    model whose eval mode then normalizes what it sees. No block drops."""
    keep = torch.ones((len(drop_rates(config)), logmel.shape[0]), dtype=torch.bool,
                      device=logmel.device)
    with torch.no_grad(), float32_products():
        features(w, logmel.transpose(1, 2).unsqueeze(1), config, "calibrate", keep)


def forward(w: dict, logmel: torch.Tensor, config: dict, train: bool = False,
            keep: torch.Tensor | None = None, precision: str = "float32") -> torch.Tensor:
    """[B, T, F] normalized log-mel -> [B, n_class] probabilities, with
    the products in full float32 (``float32_products``)."""
    with float32_products():
        return _forward(w, logmel, config, train, keep, precision)


def _forward(w, logmel, config, train, keep, precision):
    x = logmel.transpose(1, 2).unsqueeze(1)
    feats = features(w, x, config, train, keep, precision).mean(dim=2).transpose(1, 2)
    out = 0.0
    for h in range(config["att_head"]):
        def head(name):
            wt = w[f"attention.{name}.{h}.weight"][:, :, 0, 0]
            return torch.sigmoid(F.linear(operand(feats, precision), operand(wt, precision),
                                          w[f"attention.{name}.{h}.bias"]))
        att = head("att").clamp(CLAMP, 1.0 - CLAMP)
        att = att / att.sum(dim=1, keepdim=True)
        out = out + (att * head("cla")).sum(dim=1) * w["attention.head_weight"][h]
    return out


def drop_rates(config: dict) -> list[float]:
    """The drop rate of each block that takes a keep mask, in block order."""
    return [b["drop"] for b in blocks(config["eff_b"]) if b["skip"] and b["drop"] > 0]


def is_parameter(name: str, kind: str) -> bool:
    """Whether the tensor is trained (the running statistics are not)."""
    return kind not in ("bn_mean", "bn_var")
