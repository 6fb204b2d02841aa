"""The port's label enhancement (``tools/label_enhancement.py``) on the
CPU: every label-enhancement case of tests/test_tools.py, run on both
packages, then the two held to each other: identical files from
``run_enhancement`` for every kind and threshold, identical ``--mode
check`` output, equal ontology maps on the bundled ontology, and the
bundled ontology itself.
"""

import filecmp
import json
import os

import numpy as np
import pytest

from psla_tpu import assets as jax_assets
from psla_tpu.tools import label_enhancement as jax_le
from psla_tpu_torch import assets
from psla_tpu_torch.tools import label_enhancement as port_le

# Toy ontology: root -> {speech -> {male, female}, music}; 'abstract' skipped
ONTOLOGY = [
    {"id": "/m/root", "child_ids": ["/m/speech", "/m/music", "/m/abs"],
     "restrictions": []},
    {"id": "/m/speech", "child_ids": ["/m/male", "/m/female"], "restrictions": []},
    {"id": "/m/music", "child_ids": [], "restrictions": []},
    {"id": "/m/male", "child_ids": [], "restrictions": []},
    {"id": "/m/female", "child_ids": [], "restrictions": []},
    {"id": "/m/abs", "child_ids": ["/m/male"], "restrictions": ["abstract"]},
]

VOCAB = ["/m/speech", "/m/music", "/m/male", "/m/female"]
IDX = {m: i for i, m in enumerate(VOCAB)}

PACKAGES = pytest.mark.parametrize("le", [jax_le, port_le], ids=["jax", "port"])


@PACKAGES
def test_child_and_parent_maps(le):
    c = le.child_map(ONTOLOGY)
    assert c["/m/speech"] == ["/m/male", "/m/female"]
    assert "/m/abs" not in c  # abstract skipped
    p = le.parent_map(ONTOLOGY)
    assert p["/m/male"] == ["/m/speech"]
    assert p["/m/speech"] == ["/m/root"]
    a = le.ancestor_map(ONTOLOGY)
    assert set(a["/m/male"]) == {"/m/speech", "/m/root"}


@PACKAGES
def test_threshold_menu(le):
    pred = np.array([[0.9, 0.1], [0.5, 0.2], [0.1, 0.9]])
    target = np.array([[1, 0], [1, 0], [0, 1]])
    thr = le.positive_score_thresholds(pred, target)
    assert abs(thr["mean"][0] - 0.7) < 1e-12
    assert abs(thr["median"][0] - 0.7) < 1e-12
    assert abs(thr["mean"][1] - 0.9) < 1e-12
    assert thr["5"][0] <= thr["25"][0] <= thr["median"][0]
    assert le.THRESHOLD_KINDS == ("mean", "median", "25", "10", "5")


@PACKAGES
def test_type1_adds_child_when_score_above_threshold(le):
    entries = [{"wav": "a.wav", "labels": "/m/speech"}]
    # male score 0.8 > thr 0.5 -> added; female 0.2 < 0.5 -> not
    pred = np.array([[0.9, 0.0, 0.8, 0.2]])
    thr = np.full(4, 0.5)
    out, added = le.enhance_labels(entries, pred, le.child_map(ONTOLOGY), IDX, thr)
    assert added == 1
    assert out[0]["labels"] == "/m/male,/m/speech"


@PACKAGES
def test_type2_adds_ancestor(le):
    entries = [{"wav": "a.wav", "labels": "/m/male"}]
    pred = np.array([[0.9, 0.0, 0.9, 0.0]])  # speech score high
    thr = np.full(4, 0.5)
    out, added = le.enhance_labels(entries, pred, le.ancestor_map(ONTOLOGY), IDX, thr)
    assert added == 1
    assert out[0]["labels"] == "/m/male,/m/speech"  # root not in vocab


@PACKAGES
def test_fsd_exclusion_list(le):
    entries = [{"wav": "a.wav", "labels": "/m/09l8g"}]
    rel = {"/m/09l8g": ["/m/male"]}
    pred = np.array([[0.9, 0.9, 0.9, 0.9]])
    thr = np.zeros(4)
    _, added_fsd = le.enhance_labels(entries, pred, rel, IDX, thr, dataset="fsd50k")
    _, added_as = le.enhance_labels(entries, pred, rel, IDX, thr, dataset="audioset")
    assert added_fsd == 0 and added_as == 1
    assert le.FSD_MIDS_NOT_IN_ONTOLOGY == jax_le.FSD_MIDS_NOT_IN_ONTOLOGY


@PACKAGES
def test_merge_union(le):
    a = [{"wav": "x", "labels": "/m/a,/m/b"}]
    b = [{"wav": "x", "labels": "/m/b,/m/c"}]
    assert le.merge_entries(a, b)[0]["labels"] == "/m/a,/m/b,/m/c"


@PACKAGES
def test_cooccurrence_counter(le):
    entries = [
        {"labels": "/m/male,/m/speech"},
        {"labels": "/m/male"},
        {"labels": "/m/music"},
    ]
    with_child, with_both = le.check_label_cooccurrence(
        entries, "/m/speech", ["/m/male", "/m/female"])
    assert (with_child, with_both) == (2, 1)


def toy_files(root, n=3):
    """The toy datafile, vocabulary, ontology and scores of
    tests/test_tools.py, in ``root``."""
    root.mkdir(parents=True, exist_ok=True)
    entries = [
        {"wav": "a.wav", "labels": "/m/speech"},
        {"wav": "b.wav", "labels": "/m/male"},
        {"wav": "c.wav", "labels": "/m/music"},
    ][:n]
    (root / "train.json").write_text(json.dumps({"data": entries}))
    (root / "labels.csv").write_text(
        "index,mid,display_name\n" + "".join(f"{i},{m},n{i}\n" for i, m in enumerate(VOCAB)))
    (root / "ontology.json").write_text(json.dumps(ONTOLOGY))
    pred = np.array([[0.9, 0.05, 0.95, 0.1], [0.95, 0.05, 0.9, 0.1],
                     [0.1, 0.9, 0.1, 0.1]])[:n]
    target = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0]])[:n]
    np.savetxt(root / "pred.csv", pred, delimiter=",")
    np.savetxt(root / "target.csv", target, delimiter=",")
    return {k: str(root / f) for k, f in (
        ("datafile", "train.json"), ("label_csv", "labels.csv"),
        ("ontology", "ontology.json"), ("pred", "pred.csv"), ("target", "target.csv"))}


@PACKAGES
def test_run_enhancement_end_to_end(le, tmp_path):
    f = toy_files(tmp_path)
    written = le.run_enhancement(f["datafile"], f["label_csv"], f["ontology"], f["pred"],
                                 f["target"], threshold_kinds=("mean", "5"))
    for kind in ("type1", "type2", "type1_2"):
        assert set(written[kind]) == {"mean", "5"}
    enhanced = json.loads(open(written["type1_2"]["5"]).read())["data"]
    # sample a (speech): male added via type1; sample b (male): speech via type2
    assert "/m/male" in enhanced[0]["labels"]
    assert "/m/speech" in enhanced[1]["labels"]
    assert (tmp_path / "train_type1_mean_weight.csv").exists()


@PACKAGES
def test_label_enhancement_cli_main(le, tmp_path):
    f = toy_files(tmp_path, n=2)
    rc = le.main(["--datafile", f["datafile"], "--label-csv", f["label_csv"],
                  "--ontology", f["ontology"], "--pred", f["pred"], "--target", f["target"],
                  "--thresholds", "mean", "--no-weights"])
    assert rc == 0
    out = json.loads((tmp_path / "train_type1_2_mean.json").read_text())
    assert "/m/male" in out["data"][0]["labels"]


@PACKAGES
def test_label_enhancement_cli_modes(le, tmp_path, capsys):
    """--mode type1/merge/check select the reference's per-script behaviors."""
    f = toy_files(tmp_path, n=2)
    common = ["--datafile", f["datafile"], "--label-csv", f["label_csv"],
              "--ontology", f["ontology"], "--pred", f["pred"], "--target", f["target"],
              "--thresholds", "mean", "--no-weights"]
    assert le.main(["--mode", "type1"] + common) == 0
    assert (tmp_path / "train_type1_mean.json").exists()
    assert not (tmp_path / "train_type2_mean.json").exists()

    assert le.main(["--mode", "merge"] + common) == 0
    out = json.loads((tmp_path / "train_type1_2_mean.json").read_text())
    assert "/m/male" in out["data"][0]["labels"]
    assert not (tmp_path / "train_type2_mean.json").exists()

    rc = le.main(["--mode", "check", "--datafile", f["datafile"],
                  "--ontology", f["ontology"], "--parent-mid", "/m/speech"])
    assert rc == 0
    assert "1 samples carry a child of /m/speech" in capsys.readouterr().out


# ------------------------------------------------ the port held to JAX


@pytest.mark.parametrize("mode,kinds", [("all", ("type1", "type2", "type1_2")),
                                        ("type1", ("type1",)), ("type2", ("type2",)),
                                        ("merge", ("type1_2",))])
def test_every_kind_and_threshold_writes_jax_files(tmp_path, capsys, mode, kinds):
    """Both CLIs on the same seeded scores over a real slice of the bundled
    ontology (fsd50k, so the exclusion list applies): the datafiles and
    weight CSVs of every kind and threshold are byte-identical, and so is
    what each prints."""
    rng = np.random.default_rng(4)
    vocab = [line.split(",")[1] for line in
             open(assets.fsd50k_label_csv()).read().splitlines()[1:]]
    n, c = 40, len(vocab)
    entries = []
    for i in range(n):
        pick = rng.choice(c, size=int(rng.integers(1, 3)), replace=False)
        entries.append({"wav": f"{i}.wav", "labels": ",".join(vocab[k] for k in pick)})
    entries[0]["labels"] = "/m/09l8g"  # on the exclusion list
    target = np.zeros((n, c))
    for i, e in enumerate(entries):
        target[i, [vocab.index(m) for m in e["labels"].split(",")]] = 1
    pred = np.clip(0.3 * target + 0.7 * rng.uniform(size=(n, c)), 0, 1)
    outs = {}
    for name, le in (("jax", jax_le), ("port", port_le)):
        d = tmp_path / name
        d.mkdir()
        (d / "tr.json").write_text(json.dumps({"data": entries}))
        np.savetxt(d / "pred.csv", pred, delimiter=",")
        np.savetxt(d / "target.csv", target, delimiter=",")
        capsys.readouterr()
        assert le.main(["--mode", mode, "--datafile", str(d / "tr.json"), "--dataset",
                        "fsd50k", "--pred", str(d / "pred.csv"),
                        "--target", str(d / "target.csv")]) == 0
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["jax"]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    want = {f"tr_{k}_{p}{ext}" for k in kinds for p in port_le.THRESHOLD_KINDS
            for ext in (".json", "_weight.csv")}
    assert want <= set(names)
    for f in names:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    assert "+0 type" not in outs["port"].split("threshold=5")[1]  # labels were added


def test_check_mode_output_equals_jax(tmp_path, capsys):
    f = toy_files(tmp_path)
    for parent in ("/m/speech", "/m/09x0r"):
        printed = []
        for le in (jax_le, port_le):
            assert le.main(["--mode", "check", "--datafile", f["datafile"],
                            "--ontology", f["ontology"], "--parent-mid", parent]) == 0
            printed.append(capsys.readouterr().out)
        assert printed[0] == printed[1]


def test_bundled_ontology_and_maps_equal_jax():
    """A byte copy of the JAX package's ontology, shipped as package data,
    the CLI's default; the maps the two packages build from it are equal."""
    assert filecmp.cmp(assets.ontology_json(), jax_assets.ontology_json(), shallow=False)
    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "pyproject.toml")) as f:
        assert '"assets/*.json"' in f.read().split("psla_tpu_torch = [")[1]
    onto = port_le.load_ontology(assets.ontology_json())
    assert len(onto) == 632
    for fn in ("child_map", "parent_map", "ancestor_map"):
        assert getattr(port_le, fn)(onto) == getattr(jax_le, fn)(onto), fn
