"""AudioSet datafile preparation (port of ``psla_tpu/tools/prep_audioset.py``).

The reference assumes users already have AudioSet datafiles and only says
"prepare data like this" (README.md:143-160); it ships prep code for
FSD50K alone. Given the public AudioSet segments CSVs
(``balanced_train_segments.csv`` / ``unbalanced_train_segments.csv`` /
``eval_segments.csv``, schema ``YTID, start_seconds, end_seconds,
positive_labels`` under a 3-line ``#`` header) and a directory of
downloaded 16 kHz WAVs named ``{YTID}.wav`` (or ``Y{YTID}.wav``, a common
downloader convention), this writes the ``{"data": [{"wav", "labels"}]}``
datafile the trainer reads, skips missing clips and clips with no known
label with a report, and writes the balanced-sampling weight file. A WAV
that exists is kept without being decoded, as the JAX tool keeps it (its
docstring says undecodable clips are skipped; its code does not decode),
so both write the same datafile. Host code: it touches no card.

    python -m psla_tpu_torch.tools.prep_audioset \\
        --segments-csv balanced_train_segments.csv \\
        --wav-dir audioset/balanced --label-csv class_labels_indices.csv \\
        --out datafiles/balanced_train_data.json
"""

from __future__ import annotations

import argparse
import csv
import json
import os

from psla_tpu_torch.data.datafiles import make_index_dict, save_datafile
from psla_tpu_torch.data.sampler import gen_weight_file


def parse_segments_csv(path: str) -> list[tuple[str, str]]:
    """[(ytid, 'mid1,mid2'), ...] from an AudioSet segments CSV."""
    out = []
    with open(path, newline="") as f:
        for row in csv.reader(f, skipinitialspace=True):
            if not row or row[0].startswith("#"):
                continue
            labels = ",".join(m.strip().strip('"') for m in row[3:] if m.strip())
            out.append((row[0].strip(), labels))
    return out


def find_wav(wav_dir: str, ytid: str) -> str | None:
    """``{ytid}.wav`` or ``Y{ytid}.wav`` in ``wav_dir``, else None."""
    for name in (f"{ytid}.wav", f"Y{ytid}.wav"):
        p = os.path.join(wav_dir, name)
        if os.path.exists(p):
            return p
    return None


def build_datafile(
    segments_csv: str,
    wav_dir: str,
    label_csv: str,
    out_json: str,
    gen_weights: bool = True,
) -> dict:
    """Write the datafile (and its weight file); returns and prints the
    report: clips kept, WAVs missing, unknown mids dropped."""
    index_dict = make_index_dict(label_csv)
    entries = []
    missing = 0
    unknown_mids = 0
    for ytid, labels in parse_segments_csv(segments_csv):
        wav = find_wav(wav_dir, ytid)
        if wav is None:
            missing += 1
            continue
        mids = [m for m in labels.split(",") if m]  # '' -> zero labels
        known = [m for m in mids if m in index_dict]
        unknown_mids += len(mids) - len(known)
        if not known:
            continue
        entries.append({"wav": wav, "labels": ",".join(known)})
    os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
    save_datafile(out_json, entries)
    report = {
        "clips": len(entries),
        "missing_wavs": missing,
        "dropped_unknown_labels": unknown_mids,
    }
    if gen_weights and entries:
        report["weight_file"] = gen_weight_file(out_json, label_csv)
    print(json.dumps(report))
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--segments-csv", required=True)
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--label-csv", required=True)
    p.add_argument("--out", required=True, help="output datafile JSON path")
    p.add_argument("--no-weights", action="store_true")
    args = p.parse_args(argv)
    build_datafile(args.segments_csv, args.wav_dir, args.label_csv, args.out,
                   gen_weights=not args.no_weights)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
