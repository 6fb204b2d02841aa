"""Ontology-driven label enhancement (PSLA's "L"; port of
``psla_tpu/tools/label_enhancement.py``, host code that touches no card).

Reimplements the reference's offline label-fixing pipeline
(src/label_enhancement/fix_type1.py, fix_type2.py, merge_type_1_2.py,
check_label_error.py):

  * Type-I error: a clip labeled with a parent class is missing a true
    child label. Fix: add child c when the trained model's prediction
    pred[i, c] exceeds a per-class threshold derived from the score
    distribution on positive samples (fix_type1.py:31-81, 111-117).
  * Type-II error: a clip labeled with a child class is missing its
    ancestors. Fix: add ancestor a when pred[i, a] > threshold[a], with
    ancestors from a transitive closure over the ontology's child_ids
    (fix_type2.py:17-53, 56-106).
  * Merge: per-sample set-union of type-1 and type-2 enhanced labels
    (merge_type_1_2.py:25-44).

Thresholds menu (both scripts): mean / median / 25th / 10th / 5th
percentile of each class's scores over its positive samples.

The AudioSet ontology JSON (632 nodes with id/child_ids/restrictions) is a
public Google release; the port bundles a copy
(``psla_tpu_torch.assets.ontology_json()``, the CLI's default) and takes
another by path (the reference bundles one and partially hardcodes
absolute paths, fix_type2.py:18).

Deviation (deliberate): enhanced label lists are sorted for deterministic
output; the reference serializes an unordered set (fix_type1.py:75).
"""

from __future__ import annotations

import json
import os

import numpy as np

from psla_tpu_torch import assets
from psla_tpu_torch.data.datafiles import make_index_dict
from psla_tpu_torch.data.sampler import gen_weight_file

# FSD50K vocabulary entries absent from the AudioSet ontology
# (fix_type1.py:49); enhancement skips them for non-audioset datasets.
FSD_MIDS_NOT_IN_ONTOLOGY = (
    "/m/09l8g", "/m/0bm0k", "/t/dd00012", "/m/09hlz4", "/t/dd00071"
)

THRESHOLD_KINDS = ("mean", "median", "25", "10", "5")


def load_ontology(path: str) -> list[dict]:
    with open(path, encoding="utf8") as f:
        return json.load(f)


def child_map(ontology: list[dict]) -> dict[str, list[str]]:
    """id -> direct child ids, skipping abstract classes
    (fix_type1.py:18-29)."""
    return {
        node["id"]: list(node.get("child_ids") or [])
        for node in ontology
        if node.get("restrictions") != ["abstract"]
    }


def parent_map(ontology: list[dict]) -> dict[str, list[str]]:
    """id -> direct parent ids (fix_type2.py:17-35 semantics)."""
    parents: dict[str, list[str]] = {}
    for node in ontology:
        if node.get("restrictions") == ["abstract"]:
            continue
        parents.setdefault(node["id"], [])
        for child in node.get("child_ids") or []:
            parents.setdefault(child, []).append(node["id"])
    return parents


def ancestor_map(ontology: list[dict]) -> dict[str, list[str]]:
    """id -> ALL ancestors (transitive closure; fix_type2.py:37-53)."""
    direct = parent_map(ontology)
    out = {}
    for label in direct:
        seen: set[str] = set()
        stack = list(direct.get(label, []))
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            stack.extend(direct.get(cur, []))
        out[label] = sorted(seen)
    return out


def positive_score_thresholds(
    pred: np.ndarray, target: np.ndarray
) -> dict[str, np.ndarray]:
    """Per-class threshold menu from scores on positive samples
    (fix_type1.py:111-117)."""
    num_class = target.shape[1]
    out = {k: np.zeros(num_class) for k in THRESHOLD_KINDS}
    for c in range(num_class):
        pos = pred[target[:, c] == 1, c]
        if pos.size == 0:
            for k in THRESHOLD_KINDS:
                out[k][c] = np.inf  # never add labels for unseen classes
            continue
        out["mean"][c] = pos.mean()
        out["median"][c] = np.median(pos)
        out["25"][c] = np.percentile(pos, 25)
        out["10"][c] = np.percentile(pos, 10)
        out["5"][c] = np.percentile(pos, 5)
    return out


def enhance_labels(
    entries: list[dict],
    pred: np.ndarray,
    relation: dict[str, list[str]],
    index_dict: dict[str, int],
    thresholds: np.ndarray,
    dataset: str = "audioset",
) -> tuple[list[dict], int]:
    """Generic enhancement: for each clip label L, add related label R
    (child for type-1, ancestor for type-2) when R is in the vocabulary,
    not already present, and pred[i, idx(R)] > thresholds[idx(R)].

    Returns (new entries, number of labels added)."""
    skip = set() if dataset == "audioset" else set(FSD_MIDS_NOT_IN_ONTOLOGY)
    added = 0
    out = []
    for i, sample in enumerate(entries):
        labels = sample["labels"].split(",")
        new_labels = set(labels)
        for label in labels:
            if label in skip:
                continue
            for rel in relation.get(label) or []:
                if rel in index_dict and rel not in new_labels:
                    idx = index_dict[rel]
                    if pred[i, idx] > thresholds[idx]:
                        new_labels.add(rel)
                        added += 1
        out.append({**sample, "labels": ",".join(sorted(new_labels))})
    return out, added


def merge_entries(a: list[dict], b: list[dict]) -> list[dict]:
    """Per-sample label set-union (merge_type_1_2.py:25-44)."""
    assert len(a) == len(b)
    out = []
    for ea, eb in zip(a, b):
        union = set(ea["labels"].split(",")) | set(eb["labels"].split(","))
        out.append({**ea, "labels": ",".join(sorted(union))})
    return out


def check_label_cooccurrence(
    entries: list[dict], parent_mid: str, child_mids: list[str]
) -> tuple[int, int]:
    """Analysis helper (check_label_error.py): count samples having any of
    `child_mids` and how many of those also carry `parent_mid`."""
    with_child = with_both = 0
    for sample in entries:
        labels = set(sample["labels"].split(","))
        if labels & set(child_mids):
            with_child += 1
            if parent_mid in labels:
                with_both += 1
    return with_child, with_both


def run_enhancement(
    datafile_json: str,
    label_csv: str,
    ontology_json: str,
    pred_csv: str,
    target_csv: str,
    dataset: str = "audioset",
    threshold_kinds=THRESHOLD_KINDS,
    gen_weights: bool = True,
    kinds: tuple[str, ...] = ("type1", "type2", "type1_2"),
) -> dict[str, dict[str, str]]:
    """Offline pipeline: writes *_type1_{p}.json, *_type2_{p}.json,
    *_type1_2_{p}.json (+ weight files) for the requested `kinds`
    (the reference splits these across fix_type1.py / fix_type2.py /
    merge_type_1_2.py). Returns {kind: {p: path}}."""
    with open(datafile_json, encoding="utf8") as f:
        entries = json.load(f)["data"]
    index_dict = make_index_dict(label_csv)
    ontology = load_ontology(ontology_json)
    children = child_map(ontology)
    ancestors = ancestor_map(ontology)
    pred = np.loadtxt(pred_csv, delimiter=",")
    target = np.loadtxt(target_csv, delimiter=",")
    thresholds = positive_score_thresholds(pred, target)

    stem, ext = os.path.splitext(datafile_json)
    if ext.lower() != ".json":  # keep odd extensions in the stem
        stem = datafile_json
    written: dict[str, dict[str, str]] = {"type1": {}, "type2": {}, "type1_2": {}}
    need_t1 = "type1" in kinds or "type1_2" in kinds
    need_t2 = "type2" in kinds or "type1_2" in kinds
    for p in threshold_kinds:
        thr = thresholds[p]
        n1 = n2 = 0
        produced = {}
        if need_t1:
            t1, n1 = enhance_labels(
                entries, pred, children, index_dict, thr, dataset
            )
            produced["type1"] = t1
        if need_t2:
            t2, n2 = enhance_labels(
                entries, pred, ancestors, index_dict, thr, dataset
            )
            produced["type2"] = t2
        if "type1_2" in kinds:
            produced["type1_2"] = merge_entries(
                produced["type1"], produced["type2"]
            )
        for kind in kinds:
            path = f"{stem}_{kind}_{p}.json"
            with open(path, "w") as f:
                json.dump({"data": produced[kind]}, f, indent=1)
            written[kind][p] = path
            if gen_weights:
                gen_weight_file(path, label_csv)
        parts = [f"+{n1} type1 labels"] if need_t1 else []
        if need_t2:
            parts.append(f"+{n2} type2 labels")
        print(f"threshold={p}: " + ", ".join(parts))
    return {k: v for k, v in written.items() if k in kinds}


def main(argv=None):
    """CLI: offline label enhancement.

    --mode all     fix_type1 + fix_type2 + merge (default)
    --mode type1   child-label completion only        (fix_type1.py)
    --mode type2   ancestor-label completion only     (fix_type2.py)
    --mode merge   both fixes + per-sample set-union  (merge_type_1_2.py)
    --mode check   co-occurrence report for a parent class and its
                   ontology children (check_label_error.py) — needs only
                   --datafile/--ontology (+ optional --parent-mid)

    python -m psla_tpu_torch.tools.label_enhancement \
        --datafile tr.json --label-csv labels.csv --ontology ontology.json \
        --pred exp/.../predictions/predictions.csv \
        --target exp/.../predictions/target.csv --dataset fsd50k
    """
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--mode", default="all",
                   choices=["all", "type1", "type2", "merge", "check"])
    p.add_argument("--datafile", required=True)
    p.add_argument("--label-csv", default=None)
    p.add_argument("--ontology", default=None,
                   help="AudioSet ontology.json (default: the bundled "
                        "public Google release, psla_tpu_torch/assets)")
    p.add_argument("--pred", default=None,
                   help="model predictions CSV on the TRAIN set")
    p.add_argument("--target", default=None, help="target CSV (multi-hot)")
    p.add_argument("--dataset", default="audioset")
    p.add_argument("--thresholds", nargs="+", choices=list(THRESHOLD_KINDS),
                   default=list(THRESHOLD_KINDS))
    p.add_argument("--no-weights", action="store_true")
    p.add_argument("--parent-mid", default="/m/09x0r",
                   help="[check] parent class mid (default: Speech, the "
                        "reference's check_label_error.py case)")
    args = p.parse_args(argv)

    if args.ontology is None:
        args.ontology = assets.ontology_json()
    if args.label_csv is None and args.dataset:
        try:
            args.label_csv = assets.label_csv_for(args.dataset)
        except KeyError:
            pass  # caught by the required-flag check below

    if args.mode == "check":
        with open(args.datafile, encoding="utf8") as f:
            entries = json.load(f)["data"]
        children = child_map(load_ontology(args.ontology))
        kids = children.get(args.parent_mid) or []
        with_child, with_both = check_label_cooccurrence(
            entries, args.parent_mid, kids
        )
        print(
            f"{args.datafile}: {with_child} samples carry a child of "
            f"{args.parent_mid}; {with_both} of those also carry the "
            f"parent ({with_both / max(1, with_child):.1%})"
        )
        return 0

    for flag in ("label_csv", "pred", "target"):
        if getattr(args, flag) is None:
            p.error(f"--{flag.replace('_', '-')} is required for "
                    f"--mode {args.mode}")
    kinds = {
        "all": ("type1", "type2", "type1_2"),
        "type1": ("type1",),
        "type2": ("type2",),
        "merge": ("type1_2",),
    }[args.mode]
    run_enhancement(
        args.datafile, args.label_csv, args.ontology, args.pred, args.target,
        dataset=args.dataset, threshold_kinds=tuple(args.thresholds),
        gen_weights=not args.no_weights, kinds=kinds,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
