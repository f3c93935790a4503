"""Minimal RIFF/WAV writer+reader for mono float32 PCM.

Mirrors the reference's writeWav (main.cpp:4821-4868): mono, 32-bit float,
IEEE-float format tag. Uses the native C++ encoder when built, else Python.
"""

from __future__ import annotations

import struct

import numpy as np

_WAVE_FORMAT_IEEE_FLOAT = 3


def wav_bytes(data: np.ndarray, sample_rate: int = 24000) -> bytes:
    data = np.asarray(data, dtype=np.float32).ravel()
    try:
        from tortoise_tpu_torch.native import wav_encode

        out = wav_encode(data, sample_rate)
        if out is not None:
            return out
    except Exception:
        pass
    payload = data.tobytes()
    n = len(payload)
    header = struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 36 + n, b"WAVE",
        b"fmt ", 16, _WAVE_FORMAT_IEEE_FLOAT, 1,
        sample_rate, sample_rate * 4, 4, 32,
        b"data", n,
    )
    return header + payload


def streaming_wav_header(sample_rate: int = 24000) -> bytes:
    """RIFF header for a stream whose length isn't known upfront.

    Same layout as wav_bytes (mono IEEE-float PCM) with the RIFF and
    data chunk sizes set to 0xFFFFFFFF — the de-facto streaming-WAV
    convention: players read samples until the transport ends. Append
    raw float32 frames after this header.
    """
    return struct.pack(
        "<4sI4s4sIHHIIHH4sI",
        b"RIFF", 0xFFFFFFFF, b"WAVE",
        b"fmt ", 16, _WAVE_FORMAT_IEEE_FLOAT, 1,
        sample_rate, sample_rate * 4, 4, 32,
        b"data", 0xFFFFFFFF,
    )


def write_wav(path: str, data: np.ndarray, sample_rate: int = 24000) -> None:
    with open(path, "wb") as f:
        f.write(wav_bytes(data, sample_rate))


def read_wav(path: str):
    """Read a mono float32 WAV written by write_wav. Returns (data, rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    rate, fmt, bits, _ch = None, None, None, None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        (size,) = struct.unpack_from("<I", raw, pos + 4)
        body = raw[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt, _ch, rate, _, _, bits = struct.unpack_from("<HHIIHH", body, 0)
        elif chunk_id == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if data is None or fmt != _WAVE_FORMAT_IEEE_FLOAT or bits != 32 \
            or _ch != 1:
        # the channel check matters: a stereo float WAV would otherwise
        # come back as interleaved L/R posing as double-length mono
        raise ValueError(f"{path}: unsupported WAV layout (fmt={fmt}, "
                         f"channels={_ch}, bits={bits})")
    return np.frombuffer(data, dtype=np.float32), rate
