"""Debug and verification toolkit: stage capture, shape checks, timing, traces.

Counterpart of ``vits_tpu/utils/debug.py``:

* :func:`stage_outputs` runs the port's text encoder and synthesis and returns
  every stage tensor the JAX package's ``stage_outputs`` returns, under the
  same names, as host numpy arrays (bf16 upcast to fp32), optionally at a
  compute dtype (``"bfloat16"``: the parameters cast as the engine casts them)
  and at the engine's kernel tiers; with :func:`compare_stages` it locates
  where two runs (the port's and the JAX package's, or two of the port's)
  part;
* :func:`save_stages` / :func:`load_stages` / :func:`compare_stages`: one
  ``.npy`` per stage and a shape manifest, max |diff| per stage, raising past
  ``atol``;
* :func:`assert_shape` (wildcard dims) and :func:`assert_starts_with`;
* :func:`stage_timer` (wall clock) and :func:`torch_trace`, a
  ``torch.profiler`` context writing a Chrome trace (the JAX package's
  ``xprof_trace``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Iterator, Optional

import numpy as np
import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView, dequantize_tensors
from vits_tpu_torch.models.encoder import text_encoder
from vits_tpu_torch.models.vits import Generators, NoiseOverride, synthesize
from vits_tpu_torch.ops.tiers import EXACT_TIERS, Tiers

_DTYPES = {None: None, "float32": torch.float32, "bfloat16": torch.bfloat16}


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


@torch.inference_mode()
def stage_outputs(
    params: dict,
    config: VitsConfig,
    input_ids,
    input_mask,
    num_frames: int,
    generator: Generators | None = None,
    noise: Optional[NoiseOverride] = None,
    speaker_id=None,
    compute_dtype: str | None = None,
    tiers: Tiers | None = None,
) -> dict[str, np.ndarray]:
    """Run synthesis and return every stage tensor (host numpy).

    ``params``: the port's parameter tensors (``io/params.py::from_jax_params``,
    on the device to run on); ``input_ids`` / ``input_mask``: (B, T_in) arrays
    or tensors; ``noise`` draws or ``generator``. ``compute_dtype="bfloat16"``
    casts every fp32 parameter, the mask and the noise to bf16 first, as the
    engine does at that compute dtype (and dequantizes int8 weights into bf16);
    ``tiers``: the kernels' (``Synthesizer.tiers``); by default the JAX engine's
    on the CPU: fp32 at the exact tier, or at bf16 ``Tiers.bf16_compute`` with
    kernels A and 6 off.
    """
    dtype = _DTYPES[compute_dtype]
    if tiers is None:
        tiers = (EXACT_TIERS if dtype in (None, torch.float32)
                 else Tiers.bf16_compute(None, attention=False, flow=False))
    device = next(iter(params.values())).device
    if dtype is not None:
        params = dequantize_tensors({k: v.to(dtype) if v.dtype == torch.float32 else v
                                     for k, v in params.items()})
    ids = torch.as_tensor(np.asarray(input_ids), dtype=torch.long, device=device)
    mask = torch.as_tensor(np.asarray(input_mask), dtype=dtype or torch.float32, device=device)
    if noise is not None and dtype is not None:
        noise = NoiseOverride(noise.duration.to(device, dtype), noise.prior.to(device, dtype))
    if speaker_id is not None:
        speaker_id = torch.as_tensor(np.asarray(speaker_id), device=device)
    enc = text_encoder(ParamView(params), config, ids, mask[..., None], tier=tiers.attention)
    out = synthesize(params, config, ids, mask, num_frames, generator=generator, noise=noise,
                     speaker_id=speaker_id, tiers=tiers)
    return {
        "text_encoder_output": _host(enc.last_hidden_state),
        "prior_means": _host(enc.prior_means),
        "prior_log_variances": _host(enc.prior_log_variances),
        "log_duration": _host(out.log_duration),
        "latents": _host(out.latents),
        "waveform": _host(out.waveform),
        "lengths": _host(out.lengths),
    }


def save_stages(directory: str, stages: dict[str, np.ndarray]) -> None:
    """One ``.npy`` per stage and a ``shapes.json`` manifest."""
    os.makedirs(directory, exist_ok=True)
    manifest = {}
    for name, arr in stages.items():
        np.save(os.path.join(directory, f"{name}.npy"), arr)
        manifest[name] = list(arr.shape)
    with open(os.path.join(directory, "shapes.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_stages(directory: str) -> dict[str, np.ndarray]:
    out = {}
    for fname in sorted(os.listdir(directory)):
        if fname.endswith(".npy"):
            out[fname[:-4]] = np.load(os.path.join(directory, fname))
    return out


def compare_stages(
    got: dict[str, np.ndarray],
    expected: dict[str, np.ndarray],
    atol: float = 1e-3,
    names: Optional[list[str]] = None,
) -> dict[str, float]:
    """Max |diff| per stage (the stages both have, or ``names``); raises an
    AssertionError naming every stage past ``atol`` or of another shape."""
    report = {}
    failures = []
    for name in names or sorted(set(got) & set(expected)):
        a, b = np.asarray(got[name]), np.asarray(expected[name])
        if a.shape != b.shape:
            failures.append(f"{name}: shape {a.shape} vs {b.shape}")
            continue
        diff = float(np.max(np.abs(a.astype(np.float64) - b.astype(np.float64)))) if a.size else 0.0
        report[name] = diff
        if diff > atol:
            failures.append(f"{name}: max|diff|={diff:.3e} > atol={atol}")
    if failures:
        raise AssertionError("stage mismatch:\n  " + "\n  ".join(failures))
    return report


def assert_shape(x, *expected, name: str = "tensor") -> None:
    """Shape check with wildcards: ``assert_shape(x, 192, None, 1)``."""
    shape = tuple(np.shape(x))
    if len(shape) != len(expected) or any(
        e is not None and e != s for e, s in zip(expected, shape)
    ):
        raise AssertionError(f"{name}: shape {shape} != expected {expected}")


def assert_starts_with(x, *prefix, atol: float = 1e-3, name: str = "tensor") -> None:
    """The first len(prefix) flat values of ``x`` equal ``prefix`` within ``atol``."""
    if isinstance(x, torch.Tensor):
        x = _host(x)
    flat = np.asarray(x).reshape(-1)[: len(prefix)]
    golden = np.asarray(prefix, dtype=np.float64)
    if not np.allclose(flat.astype(np.float64), golden, atol=atol):
        raise AssertionError(f"{name}: starts with {flat.tolist()} != {list(prefix)}")


@contextlib.contextmanager
def stage_timer(label: str, log=print) -> Iterator[None]:
    """Wall-clock a block (synchronize the device inside it to time device work)."""
    t0 = time.perf_counter()
    yield
    log(f"[vits_tpu_torch] {label}: {(time.perf_counter() - t0) * 1000:.2f} ms")


@contextlib.contextmanager
def torch_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (the CPU, and the card when one is
    visible), written as a Chrome trace to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
