"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel source under ``psla_tpu_torch/csrc/`` has a plain C interface and
is compiled on its own into a shared library for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), at first use and again whenever
the source or a header under ``csrc/`` changes (the file name carries a
digest of both, ``source_digest``). The
libraries go into ``$PSLA_TPU_TORCH_BUILD_DIR`` if that is set, else into
``build/psla_tpu_torch/`` of the checkout the package lies in, else (an
installed package) into ``psla_tpu_torch`` under the user's cache directory.
Beside each library lies nvcc's report (``-Xptxas -v``: registers, shared
memory, spills) as a ``.log`` file of the same name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parent / "csrc"


def build_dir() -> Path:
    if os.environ.get("PSLA_TPU_TORCH_BUILD_DIR"):
        return Path(os.environ["PSLA_TPU_TORCH_BUILD_DIR"])
    root = Path(__file__).resolve().parents[1]
    if (root / "pyproject.toml").exists() and (root / "psla_tpu_torch").is_dir():
        return root / "build" / "psla_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "psla_tpu_torch"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source_digest(source: Path) -> str:
    """Digest of a kernel source and of every ``.cuh`` header beside it (by
    name and content), so that a header edit rebuilds the libraries."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    return h.hexdigest()[:16]


class CudaLibrary:
    """One source under ``csrc/``, built once per process and loaded.

    ``bind`` sets the ``argtypes``/``restype`` of the library's C functions.
    ``log`` holds nvcc's report for the library once it is loaded.
    """

    def __init__(self, source: str, stem: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.stem = stem
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self.log = ""

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is not None:
                return self._lib
            digest = source_digest(self.source)
            out_dir = build_dir()
            so = out_dir / f"lib{self.stem}_{digest}.so"
            log = so.with_suffix(".log")
            if not so.exists():
                out_dir.mkdir(parents=True, exist_ok=True)
                tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
                cmd = [
                    nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-Xptxas", "-v", "-o", str(tmp), str(self.source),
                ]
                proc = subprocess.run(cmd, capture_output=True, text=True)
                text = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source.name} ({proc.returncode}):\n{text}"
                    )
                tmp_log = log.with_name(f"{log.name}.{os.getpid()}.tmp")
                tmp_log.write_text(text)
                os.replace(tmp_log, log)
                os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
            self.log = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self._lib = lib
            return lib
