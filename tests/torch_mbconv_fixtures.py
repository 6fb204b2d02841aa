"""Blocks and inputs for the tests of the port's fused MBConv ops.

Imports nothing of JAX, so the card tests in tests/test_torch_kernels.py can
use it where only the port is installed.
"""

from __future__ import annotations

import numpy as np
import torch

from psla_tpu_torch.models.efficientnet import MBConvBlock, efficientnet_arch


def random_block(kernel: int, stride: int, cin: int, cout: int, expand: int,
                 seed: int) -> MBConvBlock:
    """The port's MBConvBlock in eval mode with numpy-drawn weights: conv
    kernels normal over fan-in, BatchNorm mean N(0, 0.1), var U(0.5, 1.5),
    scale U(0.8, 1.2), biases N(0, 0.1)."""
    blk = MBConvBlock(kernel, stride, expand, cin, cout, 0.25, 0.0).eval()
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in blk.state_dict().items():
            leaf = name.rsplit(".", 1)[1]
            shape = tuple(t.shape)
            if leaf == "running_mean":
                x = rng.normal(0.0, 0.1, shape)
            elif leaf == "running_var":
                x = rng.uniform(0.5, 1.5, shape)
            elif leaf == "weight" and len(shape) == 4:
                x = rng.normal(0.0, np.sqrt(1.0 / np.prod(shape[1:])), shape)
            elif leaf == "weight":
                x = rng.uniform(0.8, 1.2, shape)
            else:
                x = rng.normal(0.0, 0.1, shape)
            t.copy_(torch.from_numpy(x.astype(np.float32)))
    return blk


def nhwc_input(b: int, h: int, w: int, c: int, seed: int) -> torch.Tensor:
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((b, h, w, c)).astype(np.float32))


def b2_stride1_blocks() -> list[tuple[int, int, int, int, int, int]]:
    """[(k, h, w, cin, ce, cout)] of EfficientNet-B2's 19 stride-1 blocks
    at the serving shape (64 x 528 after the stem)."""
    _, stages, _ = efficientnet_arch(2)
    h, w, out = 64, 528, []
    for args, repeats in stages:
        for r in range(repeats):
            stride = args.stride if r == 0 else 1
            cin = args.in_filters if r == 0 else args.out_filters
            if stride == 1:
                out.append((args.kernel, h, w, cin, cin * args.expand_ratio,
                            args.out_filters))
            h, w = -(-h // stride), -(-w // stride)
    return out
