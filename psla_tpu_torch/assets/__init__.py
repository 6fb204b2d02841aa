"""Bundled public label vocabularies and the AudioSet ontology (the reference
ships the same files as egs/audioset/class_labels_indices.csv,
egs/fsd50k/class_labels_indices.csv and src/utilities/ontology.json)."""

from __future__ import annotations

import os

_HERE = os.path.dirname(os.path.abspath(__file__))


def audioset_label_csv() -> str:
    """527-class AudioSet vocabulary (index,mid,display_name)."""
    return os.path.join(_HERE, "audioset_class_labels_indices.csv")


def fsd50k_label_csv() -> str:
    """200-class FSD50K vocabulary."""
    return os.path.join(_HERE, "fsd50k_class_labels_indices.csv")


def ontology_json() -> str:
    """AudioSet ontology (632 nodes) for the label-enhancement tools."""
    return os.path.join(_HERE, "ontology.json")


def label_csv_for(dataset: str) -> str:
    """Default vocabulary for a dataset name (cli --dataset values)."""
    key = dataset.lower()
    if "fsd" in key:
        return fsd50k_label_csv()
    if "audioset" in key:
        return audioset_label_csv()
    raise KeyError(
        f"no bundled label vocabulary for dataset {dataset!r}; "
        "pass --label-csv explicitly"
    )
