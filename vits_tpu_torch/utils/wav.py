"""WAV encoding — capability parity with the reference CLI's writer
(reference/test/main.cpp:23-63): clamp to [-1, 1], 16-bit PCM, mono."""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np


def pcm16(audio: np.ndarray) -> np.ndarray:
    """float PCM in [-1, 1] -> int16 samples (clamped, like main.cpp:30-32)."""
    clipped = np.clip(np.asarray(audio, dtype=np.float32), -1.0, 1.0)
    return (clipped * 32767.0).astype(np.int16)


def write_wav(dest: str | BinaryIO, audio: np.ndarray, sample_rate: int = 16000) -> None:
    data = pcm16(audio).tobytes()
    header = b"RIFF"
    header += struct.pack("<I", 36 + len(data))
    header += b"WAVEfmt "
    header += struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
    header += b"data"
    header += struct.pack("<I", len(data))
    if isinstance(dest, str):
        with open(dest, "wb") as f:
            f.write(header)
            f.write(data)
    else:
        dest.write(header)
        dest.write(data)


def streaming_wav_header(sample_rate: int = 16000) -> bytes:
    """WAV header for a live stream of unknown length.

    RIFF/data sizes are set to 0xFFFFFFFF (the de-facto convention for
    streamed WAV: players read PCM until the transport closes); the fmt
    block matches :func:`write_wav` (16-bit mono).
    """
    header = b"RIFF"
    header += struct.pack("<I", 0xFFFFFFFF)
    header += b"WAVEfmt "
    header += struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16)
    header += b"data"
    header += struct.pack("<I", 0xFFFFFFFF)
    return header


def read_wav(source: str | bytes) -> tuple[np.ndarray, int]:
    """Minimal reader (path or raw bytes): returns (float32 audio, rate)."""
    if isinstance(source, (bytes, bytearray)):
        raw = bytes(source)
    else:
        with open(source, "rb") as f:
            raw = f.read()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    rate = None
    data = None
    while pos + 8 <= len(raw):
        chunk_id = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        body = raw[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            _, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[:16])
            if channels != 1 or bits != 16:
                raise ValueError("only 16-bit mono supported")
        elif chunk_id == b"data":
            data = np.frombuffer(body, dtype=np.int16)
        pos += 8 + size + (size & 1)
    if rate is None or data is None:
        raise ValueError("missing fmt/data chunk")
    return data.astype(np.float32) / 32767.0, rate
