"""CLI: convert a checkpoint into the port's checkpoint file (port of
``psla_tpu/tools/convert_ckpt.py``).

    python -m psla_tpu_torch.tools.convert_ckpt \\
        --pth as_mdl_0.pth --n-class 527 --out as_mdl_0_port.pth

The input is a reference ``.pth`` (DataParallel ``module.`` prefixes, an
``_fc`` key), a training checkpoint of the port's trainer, or an ``.npz``
of the JAX package's variables (``/``-joined tree paths), of the model
``--model`` names (EfficientNet, ResNet50 or MobileNetV2). The output is
the port's checkpoint: a normalized state_dict in the reference key layout,
saved with ``torch.save``, which ``load_state_dict`` takes as it is. An
orbax directory is refused (``models.convert.load_variables`` says how to
export it to ``.npz``).
"""

from __future__ import annotations

import argparse

import torch

from psla_tpu_torch.models.convert import load_variables, model_family


def head_classes(state_dict: dict[str, torch.Tensor]) -> int:
    """The class count of a state_dict's pooling head (EffNetAttention,
    ResNetAttention) or classifier (MBNet)."""
    for key in ("attention.cla.bias", "attention.cla.0.bias", "model.classifier.bias"):
        if key in state_dict:
            return int(state_dict[key].shape[-1])
    raise ValueError("no pooling head or classifier in the checkpoint (a backbone-only "
                     "ImageNet file? the trainer takes those through --pretrained_ckpt)")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pth", "--ckpt", dest="ckpt", required=True,
                   help="reference .pth, training checkpoint, or .npz of JAX variables")
    p.add_argument("--model", default="efficientnet",
                   choices=["efficientnet", "resnet", "mbnet"])
    p.add_argument("--n-class", type=int, default=527)
    p.add_argument("--out", required=True, help="the port's .pth to write")
    args = p.parse_args(argv)

    sd = load_variables(args.ckpt)
    if model_family(sd) != args.model:
        raise ValueError(f"{args.ckpt} holds a {model_family(sd)} model, --model says "
                         f"{args.model}")
    n_class = head_classes(sd)
    if n_class != args.n_class:
        raise ValueError(f"head has {n_class} classes, expected {args.n_class}")
    torch.save(sd, args.out)
    n = sum(v.numel() for k, v in sd.items() if not k.endswith(("running_mean",
                                                                 "running_var")))
    print(f"converted {args.ckpt} ({n / 1e6:.2f}M params) -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
