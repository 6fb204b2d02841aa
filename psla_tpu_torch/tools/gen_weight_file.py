"""CLI: write the balanced-sampling weight file (reference:
src/gen_weight_file.py).

    python -m psla_tpu_torch.tools.gen_weight_file \
        --label_indices_path labels.csv --datafile_path data.json
"""

from __future__ import annotations

import argparse

from psla_tpu_torch.data.sampler import gen_weight_file


def main(argv=None) -> int:
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--label_indices_path", type=str, required=True)
    p.add_argument("--datafile_path", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args(argv)
    out = gen_weight_file(args.datafile_path, args.label_indices_path, args.out)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
