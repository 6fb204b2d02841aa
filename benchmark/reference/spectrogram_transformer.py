"""The Audio Spectrogram Transformer, AST-Base/16 (Gong, Chung & Glass,
Interspeech 2021, arXiv 2104.01778; github.com/YuanGongND/ast,
src/models/ast_models.py, ``ASTModel``, ``model_size='base384'``), written
as plain functions of a flat dict of float32 tensors.

The keys are AST's own (``v.`` the timm DeiT trunk, ``mlp_head.0`` its
LayerNorm, ``mlp_head.1`` its Linear). The architecture: the log-mel
``[B, T, F]`` as ``[B, 1, F, T]``; a 16x16 patch convolution at strides
(fstride, tstride), flattened frequency-major into tokens; a cls and a
dist token in front and ``pos_embed`` added; ``depth`` pre-LN blocks (timm's
``Block``): ``x += proj(softmax(Q K^T / sqrt(d)) V)`` over ``num_heads``
heads of d = embed_dim / num_heads on ``qkv(LN1(x))``, then ``x +=
fc2(GELU(fc1(LN2(x))))`` with the exact (erf) GELU, LayerNorms at eps 1e-6;
the final LayerNorm; the mean of the cls and dist tokens; ``mlp_head``
(a LayerNorm at nn.LayerNorm's eps 1e-5, then the Linear); and, departing
from AST's logits under ``BCEWithLogitsLoss``, the sigmoid: the recipe's
loss (``training.bce``) takes probabilities, as PSLA's does. AST trains
without dropout or drop-path, so train mode is eval mode.

Attention is written out as two products and a softmax. Every product
and the patch convolution read their operands through
``precision.operand``, so the TF32 control rounds them all.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.precision import float32_products, operand

PATCH = 16
LN_EPS = 1e-6  # timm's ViT norms
HEAD_LN_EPS = 1e-5  # mlp_head's nn.LayerNorm default


def tokens(config: dict) -> int:
    """N: the patches of the configuration's input grid (``num_mel_bins``
    by ``target_length``), plus cls and dist."""
    f = (config["num_mel_bins"] - PATCH) // config["fstride"] + 1
    t = (config["target_length"] - PATCH) // config["tstride"] + 1
    return f * t + 2


def shapes(config: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every tensor of the model, in the port's state_dict order: name ->
    (shape, kind) in ``benchmark/weights.py``'s kinds: 'conv' (the patch
    and Linear weights, drawn over their fan-in), 'bn_weight' (LayerNorm
    scales) and 'bias' (biases, LayerNorm shifts, the tokens, pos_embed)."""
    d = config["embed_dim"]
    hidden = int(d * config["mlp_ratio"])
    out: dict[str, tuple[tuple[int, ...], str]] = {
        "v.cls_token": ((1, 1, d), "bias"), "v.dist_token": ((1, 1, d), "bias"),
        "v.pos_embed": ((1, tokens(config), d), "bias"),
        "v.patch_embed.proj.weight": ((d, 1, PATCH, PATCH), "conv"),
        "v.patch_embed.proj.bias": ((d,), "bias")}

    def norm(prefix):
        out[f"{prefix}.weight"] = ((d,), "bn_weight")
        out[f"{prefix}.bias"] = ((d,), "bias")

    def linear(prefix, n_in, n_out):
        out[f"{prefix}.weight"] = ((n_out, n_in), "conv")
        out[f"{prefix}.bias"] = ((n_out,), "bias")

    for i in range(config["depth"]):
        p = f"v.blocks.{i}"
        norm(f"{p}.norm1")
        linear(f"{p}.attn.qkv", d, 3 * d)
        linear(f"{p}.attn.proj", d, d)
        norm(f"{p}.norm2")
        linear(f"{p}.mlp.fc1", d, hidden)
        linear(f"{p}.mlp.fc2", hidden, d)
    norm("v.norm")
    norm("mlp_head.0")
    linear("mlp_head.1", d, config["n_class"])
    return out


def _linear(x, w, prefix, precision):
    return F.linear(operand(x, precision), operand(w[f"{prefix}.weight"], precision),
                    w[f"{prefix}.bias"])


def _norm(x, w, prefix, eps=LN_EPS):
    return F.layer_norm(x, x.shape[-1:], w[f"{prefix}.weight"], w[f"{prefix}.bias"], eps)


def attention(x, heads: int, precision: str = "float32"):
    """softmax(Q K^T / sqrt(d)) V of the ``qkv`` output ``x`` [B, N, 3 D]
    (timm's layout: q, k, v, each head's d columns together) -> [B, N, D]."""
    b, n, three_d = x.shape
    d = three_d // 3 // heads
    q, k, v = x.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(operand(q, precision), operand(k.transpose(-2, -1), precision))
    probs = torch.softmax(scores * d ** -0.5, dim=-1)
    out = torch.matmul(operand(probs, precision), operand(v, precision))
    return out.transpose(1, 2).reshape(b, n, heads * d)


def forward(w: dict, logmel: torch.Tensor, config: dict, train: bool = False,
            keep: torch.Tensor | None = None, precision: str = "float32") -> torch.Tensor:
    """[B, T, F] normalized log-mel -> [B, n_class] probabilities, with the
    products in full float32 (``float32_products``). ``train`` and ``keep``
    change nothing: nothing drops."""
    with float32_products():
        return _forward(w, logmel, config, precision)


def _forward(w, logmel, config, precision):
    x = logmel.transpose(1, 2).unsqueeze(1)  # [B, 1, F, T]
    x = F.conv2d(operand(x, precision), operand(w["v.patch_embed.proj.weight"], precision),
                 w["v.patch_embed.proj.bias"], (config["fstride"], config["tstride"]))
    x = x.flatten(2).transpose(1, 2)  # [B, f * t, D], frequency-major
    b = x.shape[0]
    x = torch.cat((w["v.cls_token"].expand(b, -1, -1), w["v.dist_token"].expand(b, -1, -1),
                   x), dim=1) + w["v.pos_embed"]
    for i in range(config["depth"]):
        p = f"v.blocks.{i}"
        qkv = _linear(_norm(x, w, f"{p}.norm1"), w, f"{p}.attn.qkv", precision)
        x = x + _linear(attention(qkv, config["num_heads"], precision), w,
                        f"{p}.attn.proj", precision)
        hidden = F.gelu(_linear(_norm(x, w, f"{p}.norm2"), w, f"{p}.mlp.fc1", precision))
        x = x + _linear(hidden, w, f"{p}.mlp.fc2", precision)
    x = _norm(x, w, "v.norm")
    x = (x[:, 0] + x[:, 1]) / 2
    x = _norm(x, w, "mlp_head.0", HEAD_LN_EPS)
    return torch.sigmoid(_linear(x, w, "mlp_head.1", precision))


def attention_work(config: dict) -> dict:
    """The attention products' work in one clip's train step, over all
    blocks: ``flop``, the forward's Q K^T and P V (4 N^2 d a head and
    block) and the backward's four products (twice the forward's); and
    ``bytes``, each tensor the attention kernels need read or written once:
    forward q, k, v in and the output and its row statistics (one float a
    row and head) out; backward q, k, v, the output, its gradient and the
    statistics in, the gradients of q, k and v out. float32."""
    n, d = tokens(config), config["embed_dim"]
    per_block_forward = 4 * n * n * d  # over heads: 4 N^2 (D / H) H
    rows = n * config["num_heads"]
    nbytes = 4 * ((3 * n * d + n * d + rows) + (5 * n * d + rows + 3 * n * d))
    return {"flop": 3.0 * per_block_forward * config["depth"],
            "bytes": float(nbytes * config["depth"])}


def calibrate(w: dict, logmel: torch.Tensor, config: dict):
    """Nothing to calibrate: AST has no running statistics."""


def drop_rates(config: dict) -> list[float]:
    """No block drops: AST's recipe trains without drop-path."""
    return []


def is_parameter(name: str, kind: str) -> bool:
    """Every tensor is trained."""
    return True
