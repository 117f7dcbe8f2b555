"""Reader/writer for the reference's ``.ggml`` VITS checkpoint format.

Binary layout (little-endian u32 length prefixes), as produced by
reference/scripts/export_vits.py:5-70 and parsed by
reference/src/vits_model_data.cpp:29-97 and
reference/src/vits_tokenizer.cpp:22-55:

    [tokenizer]  u32 vocab_size; {u32 key_len, key, u32 id}*; u32 add_blank;
                 u32 normalize; u32 pad_len, pad_token; u32 unk_len, unk_token
    [config]     u32 count; {u32 key_len, key, u32 val_len, val}*
    [tensors]    u32 count; {u32 name_len, name, u32 dtype (0=f32,1=f16),
                 u32 rank, u32 dims[rank] (reversed, ggml ne order),
                 u32 n_bytes, raw row-major data}*

The writer exists so this repo can (a) export HF VITS checkpoints exactly like the
reference's export pipeline and (b) generate self-contained test fixtures.

Extension beyond the reference: dtype code 2 = int8 (vits_tpu.io.quantize
weights, whose per-out-channel ``.scale`` rows ride as ordinary f32 tensors)
— quantized checkpoints round-trip to disk at ~1 byte/weight.  The reference
parser rejects code 2 (vits_model_data.cpp:80-85); int8 files are for this
engine only.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass
from typing import BinaryIO, Mapping

import numpy as np

_DTYPE_CODES = {0: np.float32, 1: np.float16, 2: np.int8}
_CODE_FOR_DTYPE = {
    np.dtype(np.float32): 0,
    np.dtype(np.float16): 1,
    np.dtype(np.int8): 2,
}


def _read_u32(f: BinaryIO) -> int:
    raw = f.read(4)
    if len(raw) != 4:
        raise EOFError("truncated ggml checkpoint")
    return struct.unpack("<I", raw)[0]


def _read_str(f: BinaryIO) -> str:
    n = _read_u32(f)
    if n > 1 << 20:
        raise ValueError(f"implausible string length {n}: not a ggml checkpoint?")
    try:
        return f.read(n).decode("utf-8")
    except UnicodeDecodeError as exc:
        raise ValueError(f"invalid UTF-8 in checkpoint: not a ggml file? ({exc})") from exc


def _write_u32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<I", v))


def _write_str(f: BinaryIO, s: str) -> None:
    raw = s.encode("utf-8")
    _write_u32(f, len(raw))
    f.write(raw)


@dataclass
class GgmlCheckpoint:
    vocab: dict[str, int]
    add_blank: bool
    normalize: bool
    pad_token: str
    unk_token: str
    config_kv: dict[str, str]
    tensors: dict[str, np.ndarray]  # torch-order shapes, f32/f16 as stored


def read_ggml(source: str | bytes | BinaryIO) -> GgmlCheckpoint:
    if isinstance(source, (str,)):
        f: BinaryIO = open(source, "rb")
        close = True
    elif isinstance(source, (bytes, bytearray)):
        f = io.BytesIO(source)
        close = False
    else:
        f = source
        close = False
    try:
        vocab_size = _read_u32(f)
        vocab = {}
        for _ in range(vocab_size):
            key = _read_str(f)
            vocab[key] = _read_u32(f)
        add_blank = bool(_read_u32(f))
        normalize = bool(_read_u32(f))
        pad_token = _read_str(f)
        unk_token = _read_str(f)

        config_kv = {}
        for _ in range(_read_u32(f)):
            key = _read_str(f)
            config_kv[key] = _read_str(f)

        tensors: dict[str, np.ndarray] = {}
        for _ in range(_read_u32(f)):
            name = _read_str(f)
            code = _read_u32(f)
            if code not in _DTYPE_CODES:
                raise ValueError(f"unsupported tensor dtype code {code} for {name}")
            rank = _read_u32(f)
            # dims stored reversed (ggml ne order, export_vits.py:64); reverse
            # back to the torch shape — raw bytes are already row-major for it.
            dims_rev = [_read_u32(f) for _ in range(rank)]
            shape = tuple(reversed(dims_rev))
            n_bytes = _read_u32(f)
            data = np.frombuffer(f.read(n_bytes), dtype=_DTYPE_CODES[code]).reshape(shape)
            tensors[name] = data
        return GgmlCheckpoint(
            vocab=vocab,
            add_blank=add_blank,
            normalize=normalize,
            pad_token=pad_token,
            unk_token=unk_token,
            config_kv=config_kv,
            tensors=tensors,
        )
    finally:
        if close:
            f.close()


def write_ggml(
    dest: str | BinaryIO,
    vocab: Mapping[str, int],
    add_blank: bool,
    normalize: bool,
    pad_token: str,
    unk_token: str,
    config_kv: Mapping[str, str],
    tensors: Mapping[str, np.ndarray],
) -> None:
    if isinstance(dest, str):
        f: BinaryIO = open(dest, "wb")
        close = True
    else:
        f = dest
        close = False
    try:
        _write_u32(f, len(vocab))
        for key, value in vocab.items():
            _write_str(f, key)
            _write_u32(f, int(value))
        _write_u32(f, int(add_blank))
        _write_u32(f, int(normalize))
        _write_str(f, pad_token)
        _write_str(f, unk_token)

        _write_u32(f, len(config_kv))
        for key, value in config_kv.items():
            _write_str(f, key)
            _write_str(f, str(value))

        _write_u32(f, len(tensors))
        for name, tensor in tensors.items():
            arr = np.asarray(tensor)
            if arr.dtype not in _CODE_FOR_DTYPE:
                arr = arr.astype(np.float32)
            _write_str(f, name)
            _write_u32(f, _CODE_FOR_DTYPE[arr.dtype])
            _write_u32(f, arr.ndim)
            for dim in reversed(arr.shape):
                _write_u32(f, int(dim))
            raw = arr.tobytes()
            _write_u32(f, len(raw))
            f.write(raw)
    finally:
        if close:
            f.close()
