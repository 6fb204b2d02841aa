"""ImageNet pretrained weights for ``impretrain=True``, the "P" of PSLA, from
local files (port of ``psla_tpu/models/pretrained.py``).

The reference loads ImageNet weights through
``EfficientNet.from_pretrained('efficientnet-b2', in_channels=1)``
(src/models/Models.py:69-72). Here, in order:

  1. an explicit ``--pretrained_ckpt`` always wins (the trainer's);
  2. the ``PSLA_TPU_IMAGENET_CKPT`` environment variable names a file;
  3. the cache directories are searched for the standard file names
     (``efficientnet-b{N}-*.pth`` of lukemelas/EfficientNet-PyTorch, or its
     AdvProp release; torchvision's ``resnet50-*.pth`` and
     ``mobilenet_v2-*.pth``), torch hub's cache included, so weights the
     reference or the JAX package already fetched are found here too;
  4. otherwise ``MissingPretrainedError`` says how to provide the file and
     names its canonical URL. The port downloads nothing, and never falls
     back to a random initialisation.
"""

from __future__ import annotations

import glob
import os
from typing import Mapping

import torch

from psla_tpu_torch.models.convert import (
    convert_imagenet_backbone,
    convert_imagenet_mbnet,
    convert_imagenet_resnet,
)

__all__ = [
    "MissingPretrainedError",
    "cache_dirs",
    "find_imagenet_checkpoint",
    "resolve_imagenet_checkpoint",
    "convert_imagenet_state_dict",
    "load_imagenet_variables",
]

CKPT_ENV = "PSLA_TPU_IMAGENET_CKPT"
CACHE_ENV = "PSLA_TPU_CACHE"

_EFFNET_RELEASE = (
    "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download"
)
# efficientnet_pytorch's url_map (the files Models.py:69-72 downloads) and
# torchvision's model zoo (Models.py:18, 51); named in the error, never fetched
IMAGENET_URLS = {
    ("efficientnet", 0): f"{_EFFNET_RELEASE}/1.0/efficientnet-b0-355c32eb.pth",
    ("efficientnet", 1): f"{_EFFNET_RELEASE}/1.0/efficientnet-b1-f1951068.pth",
    ("efficientnet", 2): f"{_EFFNET_RELEASE}/1.0/efficientnet-b2-8bb594d6.pth",
    ("efficientnet", 3): f"{_EFFNET_RELEASE}/1.0/efficientnet-b3-5fb5a3c3.pth",
    ("efficientnet", 4): f"{_EFFNET_RELEASE}/1.0/efficientnet-b4-6ed6700e.pth",
    ("efficientnet", 5): f"{_EFFNET_RELEASE}/1.0/efficientnet-b5-b6417697.pth",
    ("efficientnet", 6): f"{_EFFNET_RELEASE}/1.0/efficientnet-b6-c76e70fd.pth",
    ("efficientnet", 7): f"{_EFFNET_RELEASE}/1.0/efficientnet-b7-dcc49843.pth",
    ("resnet", None): "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    ("mbnet", None): "https://download.pytorch.org/models/mobilenet_v2-b0353104.pth",
}


class MissingPretrainedError(RuntimeError):
    """impretrain=True but no ImageNet weights could be resolved."""


def _patterns(model: str, eff_b: int) -> list[str]:
    if model == "efficientnet":
        # the standard and the AdvProp releases convert identically
        return [f"efficientnet-b{eff_b}-*.pth", f"adv-efficientnet-b{eff_b}-*.pth"]
    if model == "resnet":
        return ["resnet50-*.pth"]
    if model == "mbnet":
        return ["mobilenet_v2-*.pth"]
    raise ValueError(f"unknown model {model!r}")


def cache_dirs() -> list[str]:
    """The directories searched, in order: $PSLA_TPU_CACHE, the JAX
    package's cache, and torch hub's."""
    home = os.path.expanduser("~")
    dirs = []
    if os.environ.get(CACHE_ENV):
        dirs.append(os.environ[CACHE_ENV])
    dirs.append(os.path.join(home, ".cache", "psla_tpu"))
    dirs.append(os.path.join(home, ".cache", "torch", "hub", "checkpoints"))
    dirs.append(os.path.join(home, ".cache", "torch", "checkpoints"))
    return dirs


def find_imagenet_checkpoint(model: str, eff_b: int) -> str | None:
    """The environment variable's file, else the first cache match, else None."""
    patterns = _patterns(model, eff_b)
    env_path = os.environ.get(CKPT_ENV)
    if env_path:
        if not os.path.exists(env_path):
            raise MissingPretrainedError(f"{CKPT_ENV}={env_path} does not exist")
        return env_path
    for d in cache_dirs():
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(d, pat)))
            if hits:
                return hits[0]
    return None


def resolve_imagenet_checkpoint(model: str, eff_b: int = 2) -> str:
    """Return a path to ImageNet weights for ``model`` or raise with the
    ways to provide one."""
    found = find_imagenet_checkpoint(model, eff_b)
    if found:
        return found
    url = IMAGENET_URLS.get((model, eff_b if model == "efficientnet" else None),
                            "(no canonical URL for this model)")
    raise MissingPretrainedError(
        "impretrain=True but no ImageNet weights were found (the port downloads "
        "nothing).\nTo fix, one of:\n"
        f"  * download {url}\n"
        f"    into {cache_dirs()[0]} (any searched cache dir works: "
        + ", ".join(cache_dirs()) + ")\n"
        f"  * set {CKPT_ENV}=/path/to/checkpoint.pth\n"
        "  * pass --pretrained-ckpt /path/to/checkpoint.pth\n"
        "  * or pass --impretrain False to train from scratch "
        "(costs several mAP points)"
    )


def convert_imagenet_state_dict(state_dict: Mapping[str, torch.Tensor], model: str,
                                init_state_dict: Mapping[str, torch.Tensor]
                                ) -> dict[str, torch.Tensor]:
    """An ImageNet state dict over a fresh model's: the backbone from the
    file; the pooling head or classifier, and for ResNet and MBNet the
    1-channel stem, from ``init_state_dict``."""
    if model == "efficientnet":
        return convert_imagenet_backbone(state_dict, init_state_dict)
    if model == "resnet":
        return convert_imagenet_resnet(state_dict, init_state_dict)
    if model == "mbnet":
        return convert_imagenet_mbnet(state_dict, init_state_dict)
    raise ValueError(f"unknown model {model!r}")


def load_imagenet_variables(path: str, model: str,
                             init_state_dict: Mapping[str, torch.Tensor]
                             ) -> dict[str, torch.Tensor]:
    """``torch.load`` an ImageNet checkpoint and convert it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_imagenet_state_dict(sd, model, init_state_dict)
