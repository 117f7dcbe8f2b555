"""Hand-written CUDA kernels for Hopper: build, load, launch and count.

The sources under ``vits_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` (one process per source, in parallel) and linked into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use into the build directory (``vits_tpu_torch/_build/``, git-ignored,
unless :func:`use_build_dir` names another: ``EngineConfig.compilation_cache_dir``),
keyed by a digest of the sources and flags (:func:`source_digest`), so a fresh
checkout builds everything on its first kernel call and later processes reuse
the library. :func:`load_library` loads a built library from a given file (an
AOT bundle's, ``io/aot.py``) without building; one process loads one library,
of one digest. Nothing here runs at import: the CPU tests import every module.

Each kernel's wrapper (``ops/cuda/attention.py``, ``attention_grad.py``,
``flow.py``, ``resblock.py``, ``trio_grad.py``, ``stage.py``) takes its plain PyTorch
version for a tensor on the CPU and launches the kernel for a tensor on a
CUDA device, raising on anything the kernel does not take -- there is no
fallback and no switch. Every launch runs with its tensors' device current
(:func:`on_device`). Each wrapper carries a plain-integer ``launches``
count, bumped (:func:`count_launch`, under a lock: the server's threads
launch the same wrapper at once) only where it launches; a mesh engine's
replica books its launches under its own label too (:func:`booked_to`).
The inference kernels write into fresh buffers that autograd cannot see, so
their CUDA branches raise under autograd (:func:`no_autograd`); training
goes through the autograd Functions of ``attention_grad.py`` and
``trio_grad.py``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
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
    "vk_rel_attention": [_P] * 8 + [_I] * 7 + [_P],
    "vk_rel_attention_bwd": [_P] * 14 + [_I] * 7 + [_P],
    "vk_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _I, _I,
                _I, _I, _P, _I, _P, _P],
    "vk_upsample": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _I, _I, _I,
                    _P],
    "vk_wave": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P, _I, _P],
    "vk_flow_capture": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _P] + [_I] * 8 + [_P, _P, _P],
    "vk_flow_run": [_P] * 7 + [_I] * 4 + [_P, _I, _P],
    "vk_graph_destroy": [_P],
    "vk_conv_bf16": [_P] * 6 + [_I] * 7 + [_F, _I, _F, _I, _I, _I, _P],
    "vk_trio_backward": [_P, _I, _P, _I, _I, _I, _F, _I, _P],
    "vk_resblock_block": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _F, _I, _I,
                          _F, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_lib_path: Path | None = None  # the file the loaded library was opened from
_lib_digest: str | None = None  # and its source digest
_build_dir: Path = BUILD_DIR
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


def source_digest() -> str:
    """The digest of the sources and flags that names the library."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def library_name(digest: str) -> str:
    return f"libvits_kernels_{digest}.so"


def library_path() -> Path:
    return _build_dir / library_name(source_digest())


def loaded_library() -> Path | None:
    """The file this process's library was opened from (None before the first load)."""
    return _lib_path


def use_build_dir(path) -> Path:
    """Build the library into, and find it in, ``path`` from now on, in the
    whole process (the last caller wins, as JAX's one compilation cache).

    Nothing is built here. Where the library is already loaded from another
    directory, the loaded file is copied into ``path`` (unless it is there), so
    the next process finds it there and builds nothing."""
    global _build_dir
    path = Path(path).absolute()
    with _lock:
        _build_dir = path
        if _lib_path is not None and not (path / _lib_path.name).exists():
            # through a temporary file: a process that finds the library finds all of it
            path.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path)
            os.close(fd)
            shutil.copyfile(_lib_path, tmp)
            os.replace(tmp, path / _lib_path.name)
    return path


def build() -> Path:
    """Compile the kernels unless this source digest is already built.

    One ``nvcc -c`` per source, all started together, then one link.
    """
    global build_seconds
    out = library_path()
    if out.exists():
        build_seconds = build_seconds or 0.0
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
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


def _file_sha256(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _open(path: Path, digest: str) -> ctypes.CDLL:
    """``ctypes`` open of the library at ``path`` with every C signature set (under ``_lock``)."""
    global _lib, _lib_path, _lib_digest
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vk_error_string.argtypes = [ctypes.c_int]
    lib.vk_error_string.restype = ctypes.c_char_p
    _lib, _lib_path, _lib_digest = lib, Path(path), digest
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    with _lock:
        return _lib if _lib is not None else _open(build(), source_digest())


def load_library(path, digest: str) -> ctypes.CDLL:
    """Load the built library at ``path``, of source digest ``digest``, without
    building: this process's library from now on.

    Raises ``ValueError`` before anything is opened when a library of another
    digest is already loaded in this process (both digests named: a process
    never keeps the first library silently), or when ``digest`` or the file's
    name is not this checkout's :func:`source_digest` (the C signatures above
    match these sources only). A library of the same digest already loaded is
    returned as it is where its file holds the bytes of ``path``, and refused
    with ``ValueError`` where it does not (a build of the same sources elsewhere):
    the process would serve other bytes than the ones asked for."""
    global build_seconds
    path = Path(path)
    with _lock:
        if _lib is not None:
            if digest != _lib_digest:
                raise ValueError(f"kernel library of digest {digest} asked for, but this "
                                 f"process has loaded digest {_lib_digest} ({_lib_path})")
            if path.resolve() != _lib_path.resolve() and (
                    _file_sha256(path) != _file_sha256(_lib_path)):
                raise ValueError(f"kernel library {path} asked for, but this process has "
                                 f"loaded {_lib_path}, of the same digest and other bytes")
            return _lib
        want = source_digest()
        if digest != want or path.name != library_name(digest):
            raise ValueError(f"kernel library {path.name} (digest {digest}) was not built from "
                             f"these sources (digest {want})")
        if not path.is_file():
            raise FileNotFoundError(f"kernel library {path} does not exist")
        build_seconds = build_seconds or 0.0
        return _open(path, digest)


_COUNT_LOCK = threading.Lock()
_BOOK = threading.local()


@contextlib.contextmanager
def booked_to(label: str):
    """Book the launches this thread makes inside also under ``label`` (a mesh
    engine's replica and device) in each wrapper's ``replica_launches``."""
    outer = getattr(_BOOK, "label", None)
    _BOOK.label = label
    try:
        yield
    finally:
        _BOOK.label = outer


def current_book() -> str | None:
    """The label of the innermost :func:`booked_to` of this thread (None outside
    one): an autograd function keeps it for its backward, which autograd may run
    on another thread."""
    return getattr(_BOOK, "label", None)


def count_launch(wrapper, attr: str = "launches") -> None:
    """Add one to ``wrapper.<attr>`` (a bare ``+= 1`` from several threads can
    drop one) and, inside :func:`booked_to`, to ``wrapper.replica_launches``."""
    label = getattr(_BOOK, "label", None)
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
        if label is not None and attr == "launches":
            book = wrapper.__dict__.setdefault("replica_launches", {})
            book[label] = book.get(label, 0) + 1


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = library().vk_error_string(status).decode()
        raise RuntimeError(f"{what} failed: CUDA error {status} ({msg})")


@functools.lru_cache(maxsize=None)
def device_sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor) -> torch.cuda.device:
    """Make ``t``'s CUDA device current for the library calls inside.

    The C library keys its per-device state on ``cudaGetDevice``: the raised
    shared-memory ceilings (``common.cuh::vk_set_smem_once``), kernel 5's
    second stream and kernel 6's capture stream. Every host thread starts at
    device 0, so without this a tensor on ``cuda:1`` would be launched with
    device 0's state. Every call into :func:`library` but ``vk_error_string``
    runs inside it (``tests/test_torch_device_guard.py``).
    """
    return torch.cuda.device(t.device)


def on_cuda(name: str, *tensors: torch.Tensor, dtype=torch.float32) -> bool:
    """True when every tensor is on one CUDA device; False when all are on the CPU.

    Raises for a mix of devices, a device that is neither, a non-contiguous
    tensor, or a dtype other than ``dtype`` on CUDA (``dtype=None``: any; the
    caller checks the weight formats of a tier).
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
        if dtype is not None and t.dtype != dtype:
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
