"""JAX-package parameters <-> the port's tensors.

The port keeps the JAX package's canonical layouts (``vits_tpu/io/params.py``):
Linear ``(in, out)``, Conv1d ``(k, in/groups, out)``, ConvTranspose1d
``(k, in, out)`` spatially reversed. The CUDA kernels read those directly --
out-channels contiguous, so the threads that own neighbouring out-channels
load neighbouring weights -- and the plain ops hand PyTorch's convs a permuted
view (``ops/conv.py``). One layout serves both, with no second copy.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_jax_params(params: Mapping[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """Canonical-layout numpy parameters -> fp32 tensors on ``device``.

    Int8-quantized checkpoints (``.scale`` siblings, ``vits_tpu/io/quantize.py``)
    are not ported yet and raise ``NotImplementedError``.
    """
    device = torch.device(device)
    quantized = sorted(k for k, v in params.items() if np.asarray(v).dtype == np.int8)
    if quantized:
        raise NotImplementedError(
            f"int8-quantized parameters are not ported yet ({len(quantized)} tensors, "
            f"e.g. {quantized[0]!r})")
    out = {}
    for name, value in params.items():
        out[name] = torch.tensor(np.asarray(value, dtype=np.float32), device=device)
    return out


def to_jax_params(params: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The inverse of :func:`from_jax_params`: fp32 numpy arrays in the canonical layout.

    What checkpoints write and ``vits_tpu.io.loader.export_to_ggml`` reads.
    """
    return {name: np.ascontiguousarray(value.detach().to("cpu", torch.float32).numpy())
            for name, value in params.items()}


class ParamView:
    """Prefix-scoped read access to the flat parameter dict."""

    __slots__ = ("_params", "_prefix")

    def __init__(self, params: Mapping[str, torch.Tensor], prefix: str = ""):
        self._params = params
        self._prefix = prefix

    def sub(self, name: str) -> "ParamView":
        return ParamView(self._params, f"{self._prefix}{name}." if name else self._prefix)

    def __getitem__(self, name: str) -> torch.Tensor:
        key = self._prefix + name
        try:
            return self._params[key]
        except KeyError:
            raise KeyError(f"parameter not found: {key}") from None

    def __contains__(self, name: str) -> bool:
        return (self._prefix + name) in self._params
