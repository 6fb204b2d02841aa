"""Weights into the port: reference checkpoints and JAX-package variables.

The port's state_dict has the reference's key layout (efficientnet_pytorch
names plus the per-head pooling convs), the layout
``psla_tpu/models/convert.py`` reads. So:

  * a reference ``.pth`` loads with ``load_state_dict`` after
    ``normalize_state_dict`` (DataParallel prefixes stripped, the unused
    ``_fc`` and ``num_batches_tracked`` entries dropped);
  * ``from_jax_variables`` turns a ``{'params', 'batch_stats'}`` tree of
    numpy arrays from the JAX package into such a state_dict (the inverse of
    ``psla_tpu.models.convert.convert_effnet_attention``): HWIO kernels to
    OIHW, depthwise ``[k,k,1,C]`` to ``[C,1,k,k]``, the fused DenseGeneral
    head kernel ``[C, H, 2, n_out]`` to per-head ``att.{h}`` / ``cla.{h}``
    convs, BN scale/bias/mean/var to weight/bias/running_mean/running_var;
  * ``convert_imagenet_backbone`` puts an ImageNet efficientnet_pytorch
    backbone (3-channel stem, ``_fc`` classifier, no pooling head) over a
    fresh model's state_dict, the ``impretrain=True`` path.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def normalize_state_dict(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Strip DataParallel 'module.' prefixes; drop fc/num_batches keys."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if "_fc." in k or k.endswith("num_batches_tracked"):
            continue
        out[k] = torch.from_numpy(np.array(_np(v)))
    return out


def _oihw(kernel) -> np.ndarray:
    """flax HWIO (and depthwise [k,k,1,C]) -> torch OIHW ([C,1,k,k])."""
    return np.transpose(_np(kernel), (3, 2, 0, 1))


def _head_conv(w: np.ndarray) -> np.ndarray:
    """Dense kernel column block [C, n_out] -> 1x1 conv weight [n_out, C, 1, 1]."""
    return w.T[:, :, None, None]


def from_jax_variables(
    variables: Mapping[str, Any], label_dim: int
) -> dict[str, torch.Tensor]:
    """JAX EffNetAttention variables -> state_dict in the reference layout."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, np.ndarray] = {}

    def conv(key: str, p: Mapping):
        sd[f"{key}.weight"] = _oihw(p["kernel"])
        if "bias" in p:
            sd[f"{key}.bias"] = _np(p["bias"])

    def bn(key: str, p: Mapping, s: Mapping):
        sd[f"{key}.weight"] = _np(p["scale"])
        sd[f"{key}.bias"] = _np(p["bias"])
        sd[f"{key}.running_mean"] = _np(s["mean"])
        sd[f"{key}.running_var"] = _np(s["var"])

    ep, es = params["effnet"], stats["effnet"]
    conv("effnet._conv_stem", ep["stem"]["conv"])
    bn("effnet._bn0", ep["stem"]["bn"], es["stem"]["bn"])
    blocks = sorted(int(k[len("block_"):]) for k in ep if k.startswith("block_"))
    for i in blocks:
        bp, bs, t = ep[f"block_{i}"], es[f"block_{i}"], f"effnet._blocks.{i}"
        if "expand" in bp:
            conv(f"{t}._expand_conv", bp["expand"]["conv"])
            bn(f"{t}._bn0", bp["expand"]["bn"], bs["expand"]["bn"])
        conv(f"{t}._depthwise_conv", bp["depthwise"]["conv"])
        bn(f"{t}._bn1", bp["depthwise"]["bn"], bs["depthwise"]["bn"])
        if "se_reduce" in bp:
            conv(f"{t}._se_reduce", bp["se_reduce"])
            conv(f"{t}._se_expand", bp["se_expand"])
        conv(f"{t}._project_conv", bp["project"]["conv"])
        bn(f"{t}._bn2", bp["project"]["bn"], bs["project"]["bn"])
    conv("effnet._conv_head", ep["head"]["conv"])
    bn("effnet._bn1", ep["head"]["bn"], es["head"]["bn"])

    att = params["attention"]
    if "heads" in att:  # MultiHeadAttentionPool: kernel [C, H, 2, n_out]
        kernel, bias = _np(att["heads"]["kernel"]), _np(att["heads"]["bias"])
        for h in range(kernel.shape[1]):
            for j, part in enumerate(("att", "cla")):
                sd[f"attention.{part}.{h}.weight"] = _head_conv(kernel[:, h, j])
                sd[f"attention.{part}.{h}.bias"] = bias[h, j]
        sd["attention.head_weight"] = _np(att["head_weight"])
    elif "att_cla" in att:  # AttentionPool: kernel [C, 2, n_out]
        kernel, bias = _np(att["att_cla"]["kernel"]), _np(att["att_cla"]["bias"])
        for j, part in enumerate(("att", "cla")):
            sd[f"attention.{part}.weight"] = _head_conv(kernel[:, j])
            sd[f"attention.{part}.bias"] = bias[j]
    else:  # MeanPool: kernel [C, n_out]
        sd["attention.cla.weight"] = _head_conv(_np(att["cla"]["kernel"]))
        sd["attention.cla.bias"] = _np(att["cla"]["bias"])

    n_out = sd["attention.cla.bias" if "attention.cla.bias" in sd
               else "attention.cla.0.bias"].shape[-1]
    if n_out != label_dim:
        raise ValueError(f"head has {n_out} classes, expected {label_dim}")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


STEM = "effnet._conv_stem.weight"


def convert_imagenet_backbone(
    state_dict: Mapping[str, Any],
    init_state_dict: Mapping[str, torch.Tensor],
    stem: str = "sum",
) -> dict[str, torch.Tensor]:
    """ImageNet efficientnet_pytorch weights -> a state_dict of EffNetAttention
    (the counterpart of ``psla_tpu.models.convert.convert_imagenet_backbone``).

    Raw efficientnet_pytorch keys (``_conv_stem.weight``, ``_bn0.*``,
    ``_blocks.{i}.*``, ``_conv_head.weight``, ``_bn1.*``) are the port's
    backbone keys without their ``effnet.`` prefix, which is added;
    ``_fc`` is dropped. ``stem='sum'`` sums the RGB stem filters into one
    channel (a grayscale input then gives the stem response of the
    RGB-replicated image); ``stem='random'`` keeps the fresh stem, as
    efficientnet_pytorch's ``in_channels=1`` does. The pooling head comes
    from ``init_state_dict`` (a fresh model's).
    """
    if stem not in ("sum", "random"):
        raise ValueError(f"unknown stem strategy {stem!r}")
    sd = normalize_state_dict(state_dict)
    if not any(k.startswith("effnet.") for k in sd):
        sd = {f"effnet.{k}": v for k, v in sd.items()}
    if STEM in sd and sd[STEM].shape[1] == 3:
        if stem == "sum":
            sd[STEM] = sd[STEM].sum(dim=1, keepdim=True)
        else:
            sd[STEM] = init_state_dict[STEM]
    return _merge_into_init(init_state_dict,
                            {k: v for k, v in sd.items() if k.startswith("effnet.")})


def _merge_into_init(init_state_dict: Mapping[str, torch.Tensor],
                     backbone: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The fresh state_dict with every backbone entry replaced by the file's
    (anything else, the pooling head, stays fresh). A backbone entry the
    file lacks, or holds at another shape, raises: nothing of the backbone
    keeps its random initialisation."""
    out = dict(init_state_dict)
    missing, wrong = [], []
    for k, v in init_state_dict.items():
        if not k.startswith("effnet."):
            continue
        if k not in backbone:
            missing.append(k)
        elif tuple(backbone[k].shape) != tuple(v.shape):
            wrong.append(f"{k}: {tuple(backbone[k].shape)} for {tuple(v.shape)}")
        else:
            out[k] = backbone[k].to(v.dtype)
    if missing or wrong:
        raise ValueError(
            "the ImageNet checkpoint does not fit this backbone (another "
            f"EfficientNet size?): {len(missing)} entries missing {missing[:4]}, "
            f"{len(wrong)} of other shapes {wrong[:4]}")
    return out


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _label_dim(variables: Mapping) -> int:
    att = variables["params"]["attention"]
    part = att.get("heads") or att.get("att_cla") or att["cla"]
    return int(np.shape(part["bias"])[-1])


# the file a training checkpoint directory (models/{epoch_N,best,wa} of
# train/loop.Trainer) holds: {"step", "model", "optimizer"}
CHECKPOINT_FILE = "checkpoint.pth"


def load_variables(path: str) -> dict[str, torch.Tensor]:
    """Checkpoint file -> state_dict in the reference layout.

    Takes a ``.pth``/``.pt`` state_dict (a reference checkpoint or one saved
    from the port), a training checkpoint of the port's trainer (its
    directory or its ``checkpoint.pth``; the model's state_dict is taken),
    or an ``.npz`` of JAX variables whose keys are the ``/``-joined tree
    paths (``params/effnet/stem/conv/kernel``, ...).
    """
    if os.path.isdir(path):
        if not os.path.exists(os.path.join(path, CHECKPOINT_FILE)):
            raise ValueError(
                f"{path} is a directory without {CHECKPOINT_FILE} (an orbax "
                "checkpoint?): the port reads no orbax. Export the variables to "
                ".npz first: np.savez(out, **{'/'.join(path): leaf}) over the "
                "flattened {'params', 'batch_stats'} tree"
            )
        path = os.path.join(path, CHECKPOINT_FILE)
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "model" in sd and "optimizer" in sd:  # a training checkpoint
            sd = sd["model"]
        return normalize_state_dict(sd)
    if path.endswith(".npz"):
        with np.load(path) as z:
            variables = _unflatten({k: z[k] for k in z.files})
        return from_jax_variables(variables, _label_dim(variables))
    raise ValueError(f"unsupported checkpoint {path!r}: expected .pth, .pt or .npz")
