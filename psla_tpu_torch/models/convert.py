"""Weights into the port: reference checkpoints and JAX-package variables.

The port's state_dict has the reference's key layout (efficientnet_pytorch
names plus the per-head pooling convs; torchvision's resnet50 and
mobilenet_v2 names under ``model.``), the layout
``psla_tpu/models/convert.py`` reads. So:

  * a reference ``.pth`` loads with ``load_state_dict`` after
    ``normalize_state_dict`` (DataParallel prefixes stripped, the unused
    ``_fc`` and ``num_batches_tracked`` entries dropped);
  * ``from_jax_variables`` turns a ``{'params', 'batch_stats'}`` tree of
    numpy arrays from the JAX package into such a state_dict (the inverse of
    ``psla_tpu.models.convert``'s converters): HWIO kernels to
    OIHW, depthwise ``[k,k,1,C]`` to ``[C,1,k,k]``, the fused DenseGeneral
    head kernel ``[C, H, 2, n_out]`` to per-head ``att.{h}`` / ``cla.{h}``
    convs, BN scale/bias/mean/var to weight/bias/running_mean/running_var;
  * ``convert_imagenet_backbone`` puts an ImageNet efficientnet_pytorch
    backbone (3-channel stem, ``_fc`` classifier, no pooling head) over a
    fresh model's state_dict, the ``impretrain=True`` path;
    ``convert_imagenet_resnet`` and ``convert_imagenet_mbnet`` do the same
    with torchvision's resnet50 and mobilenet_v2 files.
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
    """JAX EffNetAttention, ResNetAttention or MBNet variables -> state_dict
    in the reference layout (the inverse of ``psla_tpu.models.convert``'s
    ``convert_effnet_attention``, ``convert_resnet_attention`` and
    ``convert_mbnet``). The family is read from the top-level ``params``
    keys: ``effnet``, ``resnet``, or ``stem`` with ``classifier``."""
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

    def conv_bn(conv_key: str, bn_key: str, p: Mapping, s: Mapping):
        """A flax ConvBN module's {conv, bn} pair."""
        conv(conv_key, p["conv"])
        bn(bn_key, p["bn"], s["bn"])

    if "effnet" in params:
        _effnet_backbone(params["effnet"], stats["effnet"], conv, bn)
    elif "resnet" in params:
        _resnet_backbone(params["resnet"], stats["resnet"], conv_bn)
    elif "stem" in params and "classifier" in params:
        _mbnet_backbone(params, stats, conv_bn)
        sd["model.classifier.weight"] = _np(params["classifier"]["kernel"]).T
        sd["model.classifier.bias"] = _np(params["classifier"]["bias"])
    else:
        raise ValueError(f"unknown variable tree: params holds {sorted(params)[:6]}")

    if "attention" in params:
        _attention_head(params["attention"], sd)
    n_out = _np(_head_bias(params)).shape[-1]
    if n_out != label_dim:
        raise ValueError(f"head has {n_out} classes, expected {label_dim}")
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _effnet_backbone(ep: Mapping, es: Mapping, conv, bn):
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


def _resnet_backbone(rp: Mapping, rs: Mapping, conv_bn):
    """torchvision's resnet50 keys: conv1/bn1 the stem, layer{s}.{j} for
    flax's layer{s}_{j}."""
    conv_bn("model.conv1", "model.bn1", rp["stem"], rs["stem"])
    for name in rp:
        if not name.startswith("layer"):
            continue
        stage, j = name[len("layer"):].split("_")
        t = f"model.layer{stage}.{j}"
        for c in (1, 2, 3):
            conv_bn(f"{t}.conv{c}", f"{t}.bn{c}", rp[name][f"conv{c}"], rs[name][f"conv{c}"])
        if "downsample" in rp[name]:
            conv_bn(f"{t}.downsample.0", f"{t}.downsample.1", rp[name]["downsample"],
                    rs[name]["downsample"])


def _mbnet_backbone(mp: Mapping, ms: Mapping, conv_bn):
    """torchvision's mobilenet_v2 keys: features.0 the stem, features.{i}
    for block i - 1, features.18 the head."""
    conv_bn("model.features.0.0", "model.features.0.1", mp["stem"], ms["stem"])
    blocks = sorted(int(k[len("block_"):]) for k in mp if k.startswith("block_"))
    for i in blocks:
        bp, bs, base = mp[f"block_{i}"], ms[f"block_{i}"], f"model.features.{i + 1}.conv"
        parts = (["expand"] if "expand" in bp else []) + ["depthwise"]
        for j, part in enumerate(parts):
            conv_bn(f"{base}.{j}.0", f"{base}.{j}.1", bp[part], bs[part])
        n = len(parts)
        conv_bn(f"{base}.{n}", f"{base}.{n + 1}", bp["project"], bs["project"])
    conv_bn(f"model.features.{len(blocks) + 1}.0", f"model.features.{len(blocks) + 1}.1",
            mp["head"], ms["head"])


def _attention_head(att: Mapping, sd: dict):
    """The fused pooling kernels -> the reference's per-head convs."""
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


def _head_bias(params: Mapping):
    """The bias of the layer that gives the classes: a pooling head's or
    MBNet's classifier's."""
    if "classifier" in params:
        return params["classifier"]["bias"]
    att = params["attention"]
    return (att.get("heads") or att.get("att_cla") or att["cla"])["bias"]


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
    return _merge_into_init(init_state_dict, sd, "effnet.")


def _torchvision_keys(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A torchvision ImageNet state_dict under the reference's ``model.``
    prefix (added where no key has it)."""
    sd = normalize_state_dict(state_dict)
    if not any(k.startswith("model.") for k in sd):
        sd = {f"model.{k}": v for k, v in sd.items()}
    return sd


def convert_imagenet_resnet(
    state_dict: Mapping[str, Any], init_state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Raw torchvision resnet50 ImageNet weights -> a state_dict of
    ResNetAttention (``psla_tpu.models.convert.convert_imagenet_resnet``).
    The reference swaps ``conv1`` for a fresh 1-channel conv (Models.py:18),
    so the stem comes from ``init_state_dict``, and so does the attention
    head; ``fc`` is dropped; the rest is the file's."""
    sd = _torchvision_keys(state_dict)
    return _merge_into_init(init_state_dict, sd, "model.", fresh=("model.conv1.weight",))


def convert_imagenet_mbnet(
    state_dict: Mapping[str, Any], init_state_dict: Mapping[str, torch.Tensor]
) -> dict[str, torch.Tensor]:
    """Raw torchvision mobilenet_v2 ImageNet weights -> a state_dict of MBNet
    (``psla_tpu.models.convert.convert_imagenet_mbnet``). The reference swaps
    ``features[0][0]`` for a fresh 1-channel conv and the classifier for a
    fresh Linear (Models.py:51-52): both come from ``init_state_dict``;
    torchvision's ``classifier.1`` is dropped; the rest is the file's."""
    sd = _torchvision_keys(state_dict)
    return _merge_into_init(init_state_dict, sd, "model.features.",
                            fresh=("model.features.0.0.weight",))


def _merge_into_init(init_state_dict: Mapping[str, torch.Tensor],
                     backbone: Mapping[str, torch.Tensor], prefix: str,
                     fresh: tuple[str, ...] = ()) -> dict[str, torch.Tensor]:
    """The fresh state_dict with every backbone entry (a key under ``prefix``
    that is not ``fresh``) replaced by the file's; anything else, the
    pooling head or the classifier, stays fresh. A backbone entry the file
    lacks, or holds at another shape, raises: nothing of the backbone keeps
    its random initialisation."""
    out = dict(init_state_dict)
    missing, wrong = [], []
    for k, v in init_state_dict.items():
        if not k.startswith(prefix) or k in fresh:
            continue
        if k not in backbone:
            missing.append(k)
        elif tuple(backbone[k].shape) != tuple(v.shape):
            wrong.append(f"{k}: {tuple(backbone[k].shape)} for {tuple(v.shape)}")
        else:
            out[k] = backbone[k].to(v.dtype)
    if missing or wrong:
        raise ValueError(
            "the ImageNet checkpoint does not fit this backbone (another model or "
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


def model_family(state_dict: Mapping[str, Any]) -> str:
    """The model (``create_model``'s name) a state_dict in the reference
    layout holds: its stem's key tells."""
    if "effnet._conv_stem.weight" in state_dict:
        return "efficientnet"
    if "model.conv1.weight" in state_dict:
        return "resnet"
    if "model.features.0.0.weight" in state_dict:
        return "mbnet"
    raise ValueError("no EfficientNet, ResNet50 or MobileNetV2 stem in the state_dict")


def _label_dim(variables: Mapping) -> int:
    return int(np.shape(_head_bias(variables["params"]))[-1])


# the file a training checkpoint directory (models/{epoch_N,best,wa} of
# train/loop.Trainer) holds: {"step", "model", "optimizer"}
CHECKPOINT_FILE = "checkpoint.pth"


def load_variables(path: str) -> dict[str, torch.Tensor]:
    """Checkpoint file -> state_dict in the reference layout.

    Takes a ``.pth``/``.pt`` state_dict (a reference checkpoint or one saved
    from the port), a training checkpoint of the port's trainer (its
    directory or its ``checkpoint.pth``; the model's state_dict is taken),
    or an ``.npz`` of JAX variables whose keys are the ``/``-joined tree
    paths (``params/effnet/stem/conv/kernel``, ...). An ensemble trainer's
    stacked checkpoint raises ``ValueError`` naming its per-seed extracts.
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
        if "seeds" in sd and "model" in sd:  # train/ensemble_loop's stacked checkpoint
            tag = os.path.basename(os.path.dirname(os.path.abspath(path)))
            raise ValueError(
                f"{path} is a stacked checkpoint of {sd['seeds']} ensemble members (the "
                f"resume and weight-averaging source); read one member's extract, "
                f"{tag}_seed0 .. {tag}_seed{sd['seeds'] - 1} beside it (saved for "
                "'best' and 'wa')")
        if "model" in sd and "optimizer" in sd:  # a training checkpoint
            sd = sd["model"]
        return normalize_state_dict(sd)
    if path.endswith(".npz"):
        with np.load(path) as z:
            variables = _unflatten({k: z[k] for k in z.files})
        return from_jax_variables(variables, _label_dim(variables))
    raise ValueError(f"unsupported checkpoint {path!r}: expected .pth, .pt or .npz")
