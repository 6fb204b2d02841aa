"""ctypes bindings for the native host runtime (``csrc/wavio.cc``,
``csrc/resample.cc``; port of ``psla_tpu/data/native.py`` with its own
copies of the C++).

The C++ batch decoder replaces the per-item torchaudio.load calls the
reference makes in its DataLoader worker processes
(src/dataloaders/audioset_dataset.py:91): one ctypes call decodes a whole
batch with an in-process C++ thread pool, releasing the GIL for the entire
batch. ``psla_tpu_torch/data/wav.py`` is the semantics golden.

The shared library is compiled with g++ at first use into the package's
build directory (``cuda_build.build_dir()``), its file name keyed by a
digest of the sources and the compiler flags. Without a compiler
``available()`` is False and the loader decodes with numpy on its thread
pool: both are host code, and neither touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from psla_tpu_torch.cuda_build import build_dir

_CSRC = os.path.join(os.path.dirname(__file__), "..", "csrc")
_SOURCES = ("wavio.cc", "resample.cc")
_HEADERS = ("wavio.h",)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


def _build_dir() -> str:
    d = str(build_dir())
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str | None:
    csrc = os.path.abspath(_CSRC)
    srcs = [os.path.join(csrc, s) for s in _SOURCES]
    deps = srcs + [os.path.join(csrc, h) for h in _HEADERS]
    if not all(os.path.exists(p) for p in deps):
        return None
    # no -march=native: a checkout (and its build directory) may be copied
    # to a host with another CPU, and the flags are part of the key
    flags = ["-O3", "-funroll-loops", "-std=c++17", "-shared", "-fPIC", "-pthread"]
    hasher = hashlib.sha256(" ".join(flags).encode())
    for p in deps:
        with open(p, "rb") as f:
            hasher.update(f.read())
    tag = hasher.hexdigest()[:16]
    out = os.path.join(_build_dir(), f"libpslawav-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    cmd = ["g++", *flags, *srcs, "-o", tmp]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if _TRIED:
            return _LIB
        path = _compile()
        if path is not None:
            try:
                lib = ctypes.CDLL(path)
                lib.psla_decode_wav.restype = ctypes.c_int
                lib.psla_decode_wav.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                ]
                lib.psla_decode_batch.restype = ctypes.c_int
                lib.psla_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int32,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32,
                ]
                lib.psla_decode_batch_i16.restype = ctypes.c_int
                lib.psla_decode_batch_i16.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int32,
                    ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int16),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32,
                ]
                lib.psla_resample_batch.restype = ctypes.c_int
                lib.psla_resample_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.c_char_p),
                    ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_int64,
                    ctypes.c_int32,
                    ctypes.c_int32,
                    ctypes.c_int32,
                    ctypes.c_int32,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.c_int32,
                ]
                _LIB = lib
            except OSError:
                _LIB = None
        _TRIED = True
        return _LIB


def available() -> bool:
    return _load() is not None


def decode_batch(
    paths: list[str], buffer_samples: int, n_threads: int = 8,
    wire: str = "float32",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch of WAVs -> (wav [B, buffer], mean [B], length [B]).

    ``wire='int16'`` fills raw PCM16 rows instead of float32 (the
    device-wire format, data/loader.py quantize_pcm16 semantics): PCM16
    sources are copied without any float conversion, so this path is
    cheaper than the float32 decode, not just half the bytes.

    Raises RuntimeError naming the failing file(s) if any clip fails.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav decoder unavailable")
    n = len(paths)
    # the C library zero-fills each row's padding tail itself
    i16 = wire == "int16"
    out = np.empty((n, buffer_samples), dtype=np.int16 if i16 else np.float32)
    means = np.zeros(n, dtype=np.float32)
    lengths = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    fn = lib.psla_decode_batch_i16 if i16 else lib.psla_decode_batch
    ptr_t = ctypes.c_int16 if i16 else ctypes.c_float
    failures = fn(
        arr,
        n,
        buffer_samples,
        out.ctypes.data_as(ctypes.POINTER(ptr_t)),
        means.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if failures:
        bad = [paths[i] for i in np.nonzero(status)[0][:5]]
        raise RuntimeError(f"native wav decode failed for {failures} clips, e.g. {bad}")
    return out, means, lengths


RATE_MISMATCH = -10  # csrc/resample.cc kErrRateMismatch


def resample_taps(up: int, down: int) -> np.ndarray:
    """FIR taps with scipy.signal.resample_poly's exact design (kaiser-5
    windowed sinc, half length 10*max(up,down), scaled by up) so the
    native path is filter-identical to the scipy fallback."""
    from scipy.signal import firwin

    m = max(up, down)
    half_len = 10 * m
    return np.asarray(
        firwin(2 * half_len + 1, 1.0 / m, window=("kaiser", 5.0)) * up,
        np.float64,
    )


def resample_batch(
    src_paths: list[str],
    dst_paths: list[str],
    in_rate: int,
    out_rate: int,
    n_threads: int = 8,
) -> np.ndarray:
    """Polyphase-resample WAV files src[i] -> dst[i] (PCM16 at out_rate)
    on the C++ thread pool. Returns the per-file status array: 0 = done,
    RATE_MISMATCH = file is not at in_rate (caller falls back per-file),
    other nonzero = decode/write failure."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native resampler unavailable")
    if len(src_paths) != len(dst_paths):
        raise ValueError(f"{len(src_paths)} sources for {len(dst_paths)} destinations")
    from math import gcd

    g = gcd(out_rate, in_rate)
    up, down = out_rate // g, in_rate // g
    taps = resample_taps(up, down)
    n = len(src_paths)
    status = np.zeros(n, dtype=np.int32)
    src = (ctypes.c_char_p * n)(*[p.encode() for p in src_paths])
    dst = (ctypes.c_char_p * n)(*[p.encode() for p in dst_paths])
    lib.psla_resample_batch(
        src, dst, n,
        taps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(taps), up, down, in_rate, out_rate,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return status


def decode_one(path: str, buffer_samples: int) -> tuple[np.ndarray, float, int, int]:
    """Decode one WAV -> (wav [buffer], full-clip mean, length, sample_rate)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native wav decoder unavailable")
    out = np.empty(buffer_samples, dtype=np.float32)
    mean = ctypes.c_float()
    length = ctypes.c_int32()
    rate = ctypes.c_int32()
    rc = lib.psla_decode_wav(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buffer_samples,
        ctypes.byref(mean),
        ctypes.byref(length),
        ctypes.byref(rate),
    )
    if rc != 0:
        raise RuntimeError(f"native wav decode failed ({rc}): {path}")
    return out, mean.value, length.value, rate.value
