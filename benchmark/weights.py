"""Seeded random weights of a configuration, made on the device in a few
large calls and handed to the program and to the reference alike.

The draws follow ``chip_smoke.seeded_state_dict``'s for this model: conv kernels
normal with variance 1.9 / fan-in (over fan-out the activations shrink
block by block and the output stops depending on the input; at 2 /
fan-in the forward turns chaotic); BatchNorm running means N(0, 0.1),
running variances U(0.5, 1.5), scales U(0.8, 1.2) (U(0.1, 0.3) on the last
BatchNorm of each residual branch), shifts N(0, 0.1);
pooling heads U(-a, a), a = sqrt(6 / fan-in), with zero-mean N(0, 0.1)
biases; head weights U(0.5, 1.5) normalized to sum to 1; other biases
N(0, 0.1). ImageNet initialisation is not used: weights cannot be
downloaded, and the speed does not depend on them.

The running statistics are then those of a seeded calibration batch
(``calibrate``), as training leaves them: with drawn ones the eval
forward's activations drift from zero mean and unit variance block by
block, and its output hardly depends on its input (the features of two
clips differ by about 2%), so a served answer would say little of the
path that made it. Once calibrated, residual branches at unit scale add up
over the blocks into a forward so sensitive that bfloat16's rounding moves
a probability by up to 0.26 on some seeds (as far as fp8's does on
others); trained residual networks carry small branch scales, and at
U(0.1, 0.3) bfloat16 stays an order of magnitude inside fp8.
"""

from __future__ import annotations

import math

import torch

from benchmark import traffic
from benchmark.reference import kaldi_fbank
from benchmark.reference.training import family

CALIBRATION_CLIPS = 16


def _fan_in(shape) -> int:
    return math.prod(shape[1:])


def make_weights(config: dict, seed: int, device: str | torch.device,
                 members: int = 1) -> list[dict[str, torch.Tensor]]:
    """``members`` independent weight sets of the configuration's model,
    float32 on ``device``, from ``seed``: one normal and one uniform draw
    for all of them, cut into the tensors, then calibrated."""
    fam = family(config["family"])
    shapes = fam.shapes(config)
    sizes = [math.prod(s) for s, _ in shapes.values()]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    normal = torch.randn(members, total, generator=gen, device=device)
    uniform = torch.rand(members, total, generator=gen, device=device)
    out = []
    for m in range(members):
        w, offset = {}, 0
        for (name, (shape, kind)), n in zip(shapes.items(), sizes):
            z = normal[m, offset:offset + n].view(shape)
            u = uniform[m, offset:offset + n].view(shape)
            offset += n
            if kind == "conv":
                t = z * math.sqrt(1.9 / _fan_in(shape))
            elif kind == "bn_weight":
                t = 0.8 + 0.4 * u
            elif kind == "bn_branch_weight":
                t = 0.1 + 0.2 * u
            elif kind == "bn_var":
                t = 0.5 + u
            elif kind == "att":
                a = math.sqrt(6.0 / _fan_in(shape))
                t = (2.0 * u - 1.0) * a
            elif kind == "head_weight":
                t = (0.5 + u) / (0.5 + u).sum()
            else:  # bn_bias, bn_mean, bias, att_bias
                t = 0.1 * z
            w[name] = t.contiguous()
        out.append(w)
    buffer = kaldi_fbank.buffer_length(config["target_length"], config["sample_rate"])
    clips = traffic.waveforms(CALIBRATION_CLIPS, buffer, int(seed) + 1, device)
    logmel = kaldi_fbank.eval_input(
        clips, torch.full((CALIBRATION_CLIPS,), buffer, device=device), config)
    for w in out:
        fam.calibrate(w, logmel, config)
    return out
