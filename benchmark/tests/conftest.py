"""The benchmark's tests import it as the package ``benchmark`` from the
repository's root, and keep PyTorch to a few threads."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)
