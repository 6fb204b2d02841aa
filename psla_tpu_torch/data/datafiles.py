"""Datafile and label-vocabulary parsing (port of
``psla_tpu/data/datafiles.py``).

The reference's data contract (src/dataloaders/audioset_dataset.py:12-30,
47-58): a JSON datafile ``{"data": [{"wav": <path>, "labels":
"mid1,mid2,..."}]}`` and a label CSV with columns (index, mid,
display_name).
"""

from __future__ import annotations

import csv
import dataclasses
import json

import numpy as np


def load_label_csv(label_csv: str) -> list[dict]:
    with open(label_csv, newline="") as f:
        return list(csv.DictReader(f))


def make_index_dict(label_csv: str) -> dict[str, int]:
    """mid -> class index (audioset_dataset.py:12-20)."""
    return {row["mid"]: int(row["index"]) for row in load_label_csv(label_csv)}


def make_name_dict(label_csv: str) -> dict[int, str]:
    """class index -> display name (audioset_dataset.py:22-30)."""
    return {int(row["index"]): row["display_name"] for row in load_label_csv(label_csv)}


@dataclasses.dataclass
class Datafile:
    """Parsed datafile: wav paths and the label indices of each clip."""

    entries: list[dict]
    index_dict: dict[str, int]

    @property
    def num_classes(self) -> int:
        return len(self.index_dict)

    def __len__(self) -> int:
        return len(self.entries)

    def wav_path(self, i: int) -> str:
        return self.entries[i]["wav"]

    def label_indices(self, i: int) -> list[int]:
        return [self.index_dict[mid] for mid in self.entries[i]["labels"].split(",")]

    def label_matrix(self) -> np.ndarray:
        """[N, C] multi-hot matrix for the whole datafile."""
        out = np.zeros((len(self), self.num_classes), dtype=np.float32)
        for i in range(len(self)):
            out[i, self.label_indices(i)] = 1.0
        return out


def load_datafile(datafile_json: str, label_csv: str) -> Datafile:
    with open(datafile_json) as f:
        data = json.load(f)["data"]
    return Datafile(entries=data, index_dict=make_index_dict(label_csv))


def save_datafile(path: str, entries: list[dict]):
    with open(path, "w") as f:
        json.dump({"data": entries}, f, indent=1)
