"""Fetch and convert the published PSLA model zoo in one command (port of
``psla_tpu/tools/fetch_pretrained.py``).

The reference publishes its trained checkpoints as Dropbox links in
pretrained_models/README.md (single model 0.440 mAP, weight-averaged
0.444, FSD50K 0.559/0.562) and tells users to download them by hand and
load them through torch. Here one command lands a zoo model as the port's
checkpoint file, ``{name}.pt``: the reference-layout state_dict normalized
as ``tools/convert_ckpt.py`` does (DataParallel ``module.`` prefixes
stripped, the ``_fc`` classifier dropped, the reference's own loading
normalization, src/ensemble/ensemble.py:35-38), which ``--pretrained-ckpt``,
``psla-torch-predict`` and ``tools/ensemble`` load:

    python -m psla_tpu_torch.tools.fetch_pretrained as_mdl_0 --out zoo/
    psla-torch-train ... --pretrained-ckpt zoo/as_mdl_0.pt

``--keep-pth`` also keeps the downloaded torch file; ``--list`` shows the
zoo; ``--url`` takes any scheme urllib opens (a mirror, or ``file://``).
"""

from __future__ import annotations

import argparse
import os
import urllib.request

import torch

from psla_tpu_torch.models.convert import load_variables
from psla_tpu_torch.tools.convert_ckpt import head_classes

# reference: pretrained_models/README.md (single-file models; the
# multi-checkpoint ensemble bundles are folder shares -- download those
# by hand and run convert_ckpt per file)
ZOO = {
    "as_mdl_0": dict(
        url="https://www.dropbox.com/s/d1z27wj30ew5qrs/as_mdl_0.pth?dl=1",
        n_class=527, map=0.440, target_length=1056,
        note="AudioSet single model, eval mAP 0.440",
    ),
    "as_mdl_0_wa": dict(
        url="https://www.dropbox.com/s/ieggie0ara4x26d/as_mdl_0_wa.pth?dl=1",
        n_class=527, map=0.444, target_length=1056,
        note="AudioSet weight-averaged, eval mAP 0.444",
    ),
    "fsd_mdl_best_single": dict(
        url="https://www.dropbox.com/s/stzrmfty2oyqnnj/fsd_mdl_best_single.pth?dl=1",
        n_class=200, map=0.559, target_length=3000,
        note="FSD50K single model, eval mAP 0.559",
    ),
    "fsd_mdl_wa": dict(
        url="https://www.dropbox.com/s/5fvybrbulvhsish/fsd_mdl_wa.pth?dl=1",
        n_class=200, map=0.562, target_length=3000,
        note="FSD50K weight-averaged, eval mAP 0.562",
    ),
}


def fetch_and_convert(
    name: str,
    out_dir: str,
    url: str | None = None,
    keep_pth: bool = False,
) -> str:
    """Download one zoo model and convert it to the port's ``{name}.pt``.
    Returns the checkpoint path. ``url`` overrides the zoo URL (any
    urllib-supported scheme, incl. file:// for mirrors and tests)."""
    entry = ZOO.get(name)
    if entry is None and url is None:
        raise KeyError(f"unknown model {name!r}; known: {sorted(ZOO)} (or pass --url)")
    url = url or entry["url"]
    n_class = entry["n_class"] if entry else 527
    os.makedirs(out_dir, exist_ok=True)
    ckpt = os.path.abspath(os.path.join(out_dir, f"{name}.pt"))
    if os.path.exists(ckpt):
        # idempotent re-run: the .pth is deleted after conversion by
        # default, so a second call must not download again
        print(f"{name}: already converted -> {ckpt}")
        return ckpt
    pth = os.path.join(out_dir, f"{name}.pth")
    if not os.path.exists(pth):
        print(f"downloading {url}")
        tmp = pth + ".part"
        urllib.request.urlretrieve(url, tmp)
        os.replace(tmp, pth)
    sd = load_variables(pth)
    if head_classes(sd) != n_class:
        raise ValueError(f"{name}: the head has {head_classes(sd)} classes, "
                         f"expected {n_class}")
    tmp = ckpt + ".part"
    torch.save(sd, tmp)
    os.replace(tmp, ckpt)
    if not keep_pth:
        os.remove(pth)
    print(f"{name}: converted -> {ckpt}")
    return ckpt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("models", nargs="*", help=f"zoo names: {sorted(ZOO)}")
    p.add_argument("--out", default="pretrained")
    p.add_argument("--url", default=None,
                   help="override the download URL (mirror / file://)")
    p.add_argument("--keep-pth", action="store_true")
    p.add_argument("--list", action="store_true")
    args = p.parse_args(argv)
    if args.list or not args.models:
        for k, v in ZOO.items():
            print(f"{k:22s} {v['note']}")
        return 0
    for name in args.models:
        fetch_and_convert(name, args.out, url=args.url, keep_pth=args.keep_pth)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
