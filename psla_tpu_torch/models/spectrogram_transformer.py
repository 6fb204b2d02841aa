"""The Audio Spectrogram Transformer, AST-Base/16 (Gong, Chung & Glass,
Interspeech 2021, arXiv 2104.01778; github.com/YuanGongND/ast,
src/models/ast_models.py, ``ASTModel`` with ``model_size='base384'``).

fbank ``[B, T, F]`` -> ``[B, 1, F, T]`` -> a 16x16 patch convolution at
strides (fstride, tstride) (10 and 10: the patches overlap by 6) ->
``[B, f * t, D]`` tokens, frequency-major -> a cls and a dist token in front,
a learned ``pos_embed [1, f * t + 2, D]`` added -> ``depth`` pre-LN blocks
(timm's DeiT ``Block``: ``x += proj(MHSA(LN1(x)))``, ``x += fc2(GELU(fc1(
LN2(x))))``, LayerNorm eps 1e-6, ``qkv`` one Linear with bias, heads of
D / H, exact GELU, no dropout and no drop-path) -> the final LayerNorm ->
the mean of the cls and dist tokens -> ``mlp_head`` (a LayerNorm with
nn.LayerNorm's eps 1e-5, then Linear(D, label_dim)) -> sigmoid.

The output is probabilities in float32, as every model of the port returns
(the train step's BCE clamps them): AST itself returns logits to
``BCEWithLogitsLoss``, which differs only where a probability leaves
[1e-7, 1 - 1e-7].

The state_dict has AST's own keys (``v.cls_token``, ``v.dist_token``,
``v.pos_embed``, ``v.patch_embed.proj``, ``v.blocks.{i}.norm1``,
``.attn.qkv``, ``.attn.proj``, ``.norm2``, ``.mlp.fc1``, ``.mlp.fc2``,
``v.norm``, ``mlp_head.0``, ``mlp_head.1``). AST's checkpoints also hold
timm's unused ``v.head`` and ``v.head_dist`` (and DataParallel's
``module.`` prefix), which a loader drops.

Attention runs by ``F.scaled_dot_product_attention``; ``ATTENTION_CALLS``
counts its calls. In bfloat16 (``dtype``) the patch convolution, the
Linear layers, GELU and attention compute in bf16 on weights cast at their
use; the residual stream, every LayerNorm, the head's token mean and the
sigmoid stay float32, as under AST's float16 autocast. Parameters stay
float32. A model starts in eval mode; train mode changes nothing, as the
recipe trains without dropout.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from psla_tpu_torch.tracing import span

PATCH = 16
LN_EPS = 1e-6  # timm's ViT norms
INIT_STD = 0.02  # timm's trunc_normal_ for Linear weights, tokens and pos_embed

ATTENTION_CALLS = 0  # calls of F.scaled_dot_product_attention


def patch_grid(input_fdim: int, input_tdim: int, fstride: int = 10,
               tstride: int = 10) -> tuple[int, int]:
    """(f, t): the patches along frequency and time (ASTModel.get_shape)."""
    return (input_fdim - PATCH) // fstride + 1, (input_tdim - PATCH) // tstride + 1


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``layer`` at ``dtype``: input, weight and bias cast at the use."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, fstride: int, tstride: int):
        super().__init__()
        self.proj = nn.Conv2d(1, embed_dim, PATCH, stride=(fstride, tstride))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        global ATTENTION_CALLS
        b, n, c = x.shape
        qkv = _linear(self.qkv, x, dtype).view(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each [B, H, N, D / H]
        out = F.scaled_dot_product_attention(q, k, v)  # scale (D / H) ** -0.5
        ATTENTION_CALLS += 1
        return _linear(self.proj, out.transpose(1, 2).reshape(b, n, c), dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return _linear(self.fc2, F.gelu(_linear(self.fc1, x, dtype)), dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        with span("ast.attention"):
            x = x + self.attn(self.norm1(x), dtype).float()
        with span("ast.mlp"):
            return x + self.mlp(self.norm2(x), dtype).float()


class VisionTransformer(nn.Module):
    """The DeiT trunk AST keeps under ``v``: tokens, patches and blocks."""

    def __init__(self, tokens: int, embed_dim: int, depth: int, num_heads: int,
                 mlp_ratio: float, fstride: int, tstride: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, embed_dim))
        self.patch_embed = PatchEmbed(embed_dim, fstride, tstride)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class ASTModel(nn.Module):
    """AST; the widths' defaults are AST-Base/16's (DeiT-B/16 distilled)."""

    def __init__(self, label_dim: int = 527, fstride: int = 10, tstride: int = 10,
                 input_fdim: int = 128, input_tdim: int = 1024, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.label_dim = label_dim
        self.dtype = dtype  # compute dtype of the products; parameters stay float32
        f, t = patch_grid(input_fdim, input_tdim, fstride, tstride)
        self.v = VisionTransformer(f * t + 2, embed_dim, depth, num_heads, mlp_ratio,
                                   fstride, tstride)
        self.mlp_head = nn.Sequential(nn.LayerNorm(embed_dim), nn.Linear(embed_dim, label_dim))
        self.eval()

    def reset_parameters(self, generator: torch.Generator):
        """timm's ViT initialisation (Linear weights, tokens and
        ``pos_embed`` truncated normal, std 0.02; Linear biases 0;
        LayerNorms 1 and 0) and torch's default for the two layers AST makes
        itself, the patch convolution and ``mlp_head``'s Linear (uniform in
        +-1 / sqrt(fan-in)), drawn from ``generator``."""
        def trunc(t):
            nn.init.trunc_normal_(t, std=INIT_STD, generator=generator)

        def default(layer):
            bound = 1.0 / math.sqrt(layer.weight[0].numel())
            nn.init.uniform_(layer.weight, -bound, bound, generator=generator)
            nn.init.uniform_(layer.bias, -bound, bound, generator=generator)

        with torch.no_grad():
            for p in (self.v.cls_token, self.v.dist_token, self.v.pos_embed):
                trunc(p)
            for m in self.v.modules():
                if isinstance(m, nn.Linear):
                    trunc(m.weight)
                    m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
            default(self.v.patch_embed.proj)
            self.mlp_head[0].weight.fill_(1.0)
            self.mlp_head[0].bias.zero_()
            default(self.mlp_head[1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F] log-mel, T = ``input_tdim``, F = ``input_fdim`` ->
        [B, label_dim] probabilities (float32)."""
        v, dtype = self.v, self.dtype
        with span("ast.embed"):
            proj = v.patch_embed.proj
            x = F.conv2d(x.transpose(1, 2).unsqueeze(1).to(dtype), proj.weight.to(dtype),
                         proj.bias.to(dtype), proj.stride)
            x = x.flatten(2).transpose(1, 2).float()  # [B, f * t, D]
            b = x.shape[0]
            x = torch.cat((v.cls_token.expand(b, -1, -1), v.dist_token.expand(b, -1, -1), x),
                          dim=1) + v.pos_embed
        for blk in v.blocks:
            x = blk(x, dtype)
        with span("ast.head"):
            x = v.norm(x)
            x = (x[:, 0] + x[:, 1]) / 2
            logits = _linear(self.mlp_head[1], self.mlp_head[0](x), dtype)
            return torch.sigmoid(logits.float())
