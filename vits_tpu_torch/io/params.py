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


# Checkpoint (torch) layout <-> canonical layout, copied from the JAX
# package's io/params.py so that the loader does not import it.
# Substrings identifying nn.Linear weights (the only 2-D weights that need a
# transpose; embeddings and elementwise-affine params keep their torch layout).
_LINEAR_MARKERS = (".k_proj.", ".v_proj.", ".q_proj.", ".out_proj.")
# ConvTranspose1d lives only in the HiFiGAN upsampler.
_CONVTRANSPOSE_MARKER = ".upsampler."


def classify(name: str, ndim: int) -> str:
    """Return one of {'linear','conv','conv_transpose','plain'} for a torch param."""
    if name.endswith(".weight"):
        if ndim == 3:
            if _CONVTRANSPOSE_MARKER in name:
                return "conv_transpose"
            return "conv"
        if ndim == 2 and any(m in name for m in _LINEAR_MARKERS):
            return "linear"
    return "plain"


def from_torch_layout(name: str, value: np.ndarray) -> np.ndarray:
    kind = classify(name, value.ndim)
    if kind == "linear":
        return np.ascontiguousarray(value.T)
    if kind == "conv":
        return np.ascontiguousarray(value.transpose(2, 1, 0))
    if kind == "conv_transpose":
        # torch weight W[in, out, k]; the equivalent regular conv (after input
        # dilation) uses kernel[t, i, o] = W[i, o, K-1-t].
        return np.ascontiguousarray(np.flip(value.transpose(2, 0, 1), axis=0))
    return np.ascontiguousarray(value)


def to_torch_layout(name: str, value: np.ndarray) -> np.ndarray:
    """Exact inverse of :func:`from_torch_layout` (for export/round-trip)."""
    kind = classify(name, value.ndim)
    if kind == "linear":
        return np.ascontiguousarray(value.T)
    if kind == "conv":
        return np.ascontiguousarray(value.transpose(2, 1, 0))
    if kind == "conv_transpose":
        return np.ascontiguousarray(np.flip(value, axis=0).transpose(1, 2, 0))
    return np.ascontiguousarray(value)


def convert_state_dict(
    state_dict: Mapping[str, np.ndarray], dtype=np.float32
) -> dict[str, np.ndarray]:
    """Convert a full torch-layout state dict (numpy values) to canonical layout."""
    out = {}
    for name, value in state_dict.items():
        arr = np.asarray(value)
        if arr.dtype == np.int8:
            # quantized weights stay int8 (ParamView dequantizes at access
            # via the sibling .scale row); casting would bake the raw
            # integer levels in as weights
            out[name] = from_torch_layout(name, arr)
            continue
        if arr.dtype in (np.float16, np.float64):
            arr = arr.astype(np.float32)
        out[name] = from_torch_layout(name, arr).astype(dtype, copy=False)
    return out


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

    What checkpoints write and ``io/loader.py::export_to_ggml`` reads.
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
