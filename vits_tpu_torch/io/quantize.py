"""Int8 weight quantization (per-output-channel, symmetric).

The reference stores fp16 conv weights and nothing smaller (SURVEY.md §5:
"dtypes f32+f16 only, no quantization"); this adds the BASELINE stretch goal:
4x-smaller checkpoints and bandwidth-lean serving weights.

Two layers:
  * storage: ``quantize_params`` / ``dequantize_params`` — flat param dict
    <-> {name: int8 values, name+".scale": fp32 per-channel scales}; round-trip
    error is bounded by scale/2 per weight.
  * serving: ``QuantizedParams`` keeps int8 + scales on device and
    dequantizes lazily per parameter access inside jit (XLA fuses the
    int8->f32 multiply into the consuming conv, so HBM traffic for the big
    weights drops 4x while activations math stays fp32).

Quantized checkpoints serialize through the same .npz machinery as training
checkpoints (save_quantized / load_quantized).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np

# Per-channel axis for canonical layouts: conv (k, in, out) and linear
# (in, out) quantize per OUT channel (last axis); 1-D params stay fp32.
_MIN_QUANT_SIZE = 1024  # don't bother quantizing tiny params


def _should_quantize(name: str, arr: np.ndarray) -> bool:
    return (
        name.endswith(".weight")
        and arr.ndim >= 2
        and arr.size >= _MIN_QUANT_SIZE
        and not name.startswith("text_encoder.embed_tokens")
    )


def quantize_params(params: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Flat fp32 params -> mixed dict with int8 weights + .scale entries."""
    out: dict[str, np.ndarray] = {}
    for name, value in params.items():
        arr = np.asarray(value, dtype=np.float32)
        if not _should_quantize(name, arr):
            out[name] = arr
            continue
        axes = tuple(range(arr.ndim - 1))
        absmax = np.max(np.abs(arr), axis=axes, keepdims=True)
        scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        out[name] = q
        out[name + ".scale"] = scale.reshape(-1)
    return out


def dequantize_params(qparams: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Inverse of quantize_params (fp32 everywhere)."""
    out = {}
    for name, value in qparams.items():
        if name.endswith(".scale"):
            continue
        arr = np.asarray(value)
        if arr.dtype == np.int8:
            scale = np.asarray(qparams[name + ".scale"], dtype=np.float32)
            out[name] = arr.astype(np.float32) * scale.reshape(
                (1,) * (arr.ndim - 1) + (-1,)
            )
        else:
            out[name] = arr.astype(np.float32) if arr.dtype == np.float16 else arr
    return out


class QuantizedParams(dict):
    """Back-compat alias: a plain flat dict of int8 weights + ``.scale`` entries.

    The dequantize-on-access logic lives in ``ParamView.__getitem__``
    (vits_tpu_torch.io.params) — it must, because jit pytree flattening strips dict
    subclasses, so any behavior on this class would silently vanish inside a
    compiled function.  The output of ``quantize_params`` is therefore a
    drop-in params dict for every engine/model entry point (Synthesizer,
    synthesize, hifigan, ...), wrapped in this class or not.
    """


def save_quantized(path: str, qparams: Mapping[str, np.ndarray]) -> None:
    np.savez(path, **{k: np.asarray(v) for k, v in qparams.items()})


def load_quantized(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def quantization_error(params: Mapping[str, np.ndarray]) -> dict[str, float]:
    """Max abs round-trip error per quantized tensor (diagnostics)."""
    q = quantize_params(params)
    d = dequantize_params(q)
    return {
        name: float(np.max(np.abs(np.asarray(params[name]) - d[name])))
        for name in params
        if name in d and q[name].dtype == np.int8
    }
