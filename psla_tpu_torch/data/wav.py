"""Minimal RIFF/WAVE codec and resampler (numpy and scipy only).

Port of ``psla_tpu/data/wav.py`` (``read_wav``, ``decode_wav``,
``write_wav``) plus ``resample`` from ``psla_tpu/tools/prep_fsd.py``. Decodes PCM 8/16/24/32 and IEEE float32/64,
mono or multichannel, to float32 in [-1, 1] exactly like torchaudio
(int16 / 32768, ...). Multichannel files return the first channel, as the
reference always indexes channel 0.
"""

from __future__ import annotations

import struct
from math import gcd

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode a WAV file -> (waveform float32 [num_samples], sample_rate)."""
    with open(path, "rb") as f:
        return decode_wav(f.read(), name=path)


def decode_wav(data: bytes, name: str = "<bytes>") -> tuple[np.ndarray, int]:
    """Decode in-memory WAV bytes (e.g. an HTTP request body) ->
    (waveform float32 [num_samples], sample_rate)."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{name}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    fmt_body = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            if len(body) < 16:
                raise ValueError(f"{name}: fmt chunk too short ({len(body)})")
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif chunk_id == b"data":
            raw = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{name}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE and fmt_body is not None and len(fmt_body) >= 26:
        # WAVE_FORMAT_EXTENSIBLE: the real format code is the first two bytes
        # of the SubFormat GUID at offset 24 of the fmt chunk.
        (audio_format,) = struct.unpack("<H", fmt_body[24:26])

    if audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(raw, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(raw, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"{name}: unsupported float bit depth {bits}")
    elif audio_format == 1:
        if bits == 16:
            x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 8:
            x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 32:
            x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
                1 << 23
            )
        else:
            raise ValueError(f"{name}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{name}: unsupported WAV format code {audio_format}")

    if channels > 1:
        x = x[: (x.size // channels) * channels].reshape(-1, channels)[:, 0].copy()
    return x, sample_rate


def resample(wav: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (replaces the reference's `sox -r` shell-out)."""
    if sr == target_sr:
        return np.asarray(wav, np.float32)
    from scipy.signal import resample_poly

    g = gcd(target_sr, sr)
    return resample_poly(wav, target_sr // g, sr // g).astype(np.float32)


def write_wav(path: str, waveform: np.ndarray, sample_rate: int):
    """Write a mono float waveform as PCM16: clipped to [-1, 1], scaled by
    32767 and rounded half to even, byte for byte the JAX package's writer."""
    wav = np.clip(np.asarray(waveform, dtype=np.float64), -1.0, 1.0)
    raw = np.round(wav * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(raw)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", len(raw)))
        f.write(raw)
