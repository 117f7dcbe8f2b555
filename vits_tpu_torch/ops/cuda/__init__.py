"""Hand-written CUDA kernels for Hopper: build, load, launch and count.

The sources under ``vits_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` (one process per source, in parallel) and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use into ``vits_tpu_torch/_build/`` (git-ignored), keyed by a hash of
the sources and flags, so a fresh checkout
builds everything on its first kernel call and later processes reuse the
library. Nothing here runs at import: the CPU tests import every module.

Each kernel's wrapper (``ops/cuda/attention.py``, ``attention_grad.py``,
``flow.py``, ``resblock.py``, ``trio_grad.py``, ``stage.py``) takes its plain PyTorch
version for a tensor on the CPU and launches the kernel for a tensor on a
CUDA device, raising on anything the kernel does not take -- there is no
fallback and no switch. Each wrapper carries a plain-integer ``launches``
count, bumped only where it launches. The inference kernels write into fresh
buffers that autograd cannot see, so their CUDA branches raise under
autograd (:func:`no_autograd`); training goes through the autograd Functions
of ``attention_grad.py`` and ``trio_grad.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
COMPILE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
NVCC_FLAGS = (*COMPILE_FLAGS, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the exported functions (all return a cudaError_t as int).
_SIGNATURES = {
    "vk_rel_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "vk_rel_attention_bwd": [_P] * 14 + [_I, _I, _I, _I, _I, _P],
    "vk_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _P],
    "vk_upsample": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P],
    "vk_wave": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "vk_flow_coupling": [_P, _P, _P, _I, _P, _I, _P, _P, _P] + [_I] * 10 + [_P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build (0.0 = cached)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libvits_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless this source hash is already built.

    One ``nvcc -c`` per source, all started together, then one link.
    """
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = build_seconds or 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objects, procs = [], []
        for src in sorted(CSRC.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.PIPE, text=True)))
            objects.append(str(obj))
        failures = []
        for cmd, proc in procs:
            _, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{err}")
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        tmp_out = Path(tmp) / out.name
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_out), *objects]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{proc.stderr}")
        os.replace(tmp_out, out)
    build_seconds = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vk_error_string.argtypes = [ctypes.c_int]
            lib.vk_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = library().vk_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> bool:
    """True when every tensor is on one CUDA device; False when all are on the CPU.

    Raises for a mix of devices, a device that is neither, a non-contiguous
    tensor, or a dtype other than ``dtype`` on CUDA.
    """
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devices))}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name}: dtype {t.dtype}, the kernel takes {dtype}")
    return True


def no_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would record ``tensors``: the kernel's output has no grad_fn."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward; an input requires grad, so every "
            "parameter upstream would silently get no gradient (train through "
            "ops/cuda/attention_grad.py or trio_grad.py, or run under torch.no_grad())")


def cuda_lengths(lengths: torch.Tensor | None, batch: int, full: int,
                 device: torch.device) -> torch.Tensor:
    """Per-row valid lengths as a contiguous int32 tensor on ``device``."""
    if lengths is None:
        return torch.full((batch,), full, dtype=torch.int32, device=device)
    if lengths.shape != (batch,):
        raise ValueError(f"lengths shape {tuple(lengths.shape)} != ({batch},)")
    if lengths.device != device:
        raise ValueError(f"lengths on {lengths.device}, activations on {device}")
    return lengths.to(torch.int32).contiguous()
