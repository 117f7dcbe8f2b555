"""Training checkpoints: one directory per step, npz files and a JSON manifest.

Counterpart of ``vits_tpu/train/checkpoint.py``. ``step_<N>/`` holds
``gen_params.npz`` (and ``disc_params.npz``, ``gen_params_ema.npz``) keyed by
the JAX parameter names in the canonical layout -- the files the JAX package
writes, readable by its loaders and by ``export_to_ggml`` -- plus the
optimizer states (``gen_opt.npz``, ``disc_opt.npz``: Adam moments by
parameter name and the update count, ``VitsOptimizer.state_arrays()`` in
``train/schedule.py``; under ZeRO-1 that is a collective every rank calls,
so the caller gathers the states and only the primary process writes).
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional

import numpy as np
import torch

from vits_tpu_torch.io.params import to_jax_params


def _save(path: str, arrays: Mapping[str, np.ndarray]) -> None:
    np.savez(path, **arrays)


def _load(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def save_checkpoint(
    directory: str,
    step: int,
    gen_params: Mapping[str, torch.Tensor],
    gen_opt: Optional[Mapping[str, np.ndarray]] = None,  # the optimizers' state_arrays()
    disc_params: Optional[Mapping[str, torch.Tensor]] = None,
    disc_opt: Optional[Mapping[str, np.ndarray]] = None,
    ema_params: Optional[Mapping[str, torch.Tensor]] = None,
    metadata: Optional[dict] = None,
    keep: int = 3,
) -> str:
    """Write ``directory/step_<N>/``; prunes old steps beyond ``keep``."""
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(ckpt_dir, exist_ok=True)
    files = {"gen_params": to_jax_params(gen_params)}
    if gen_opt is not None:
        files["gen_opt"] = gen_opt
    if disc_params is not None:
        files["disc_params"] = to_jax_params(disc_params)
    if disc_opt is not None:
        files["disc_opt"] = disc_opt
    if ema_params is not None:
        files["gen_params_ema"] = to_jax_params(ema_params)
    for name, arrays in files.items():
        _save(os.path.join(ckpt_dir, f"{name}.npz"), arrays)
    manifest = {"step": step, "has_disc": disc_params is not None,
                "has_gen_opt": gen_opt is not None, "has_disc_opt": disc_opt is not None,
                "has_ema": ema_params is not None, "metadata": metadata or {}}
    with open(os.path.join(ckpt_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)

    if keep:
        steps = sorted(d for d in os.listdir(directory)
                       if d.startswith("step_") and os.path.isdir(os.path.join(directory, d)))
        for stale in steps[:-keep]:
            stale_dir = os.path.join(directory, stale)
            for name in os.listdir(stale_dir):
                os.remove(os.path.join(stale_dir, name))
            os.rmdir(stale_dir)
    return ckpt_dir


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and os.path.isdir(os.path.join(directory, d))]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """Dict of step, metadata and the numpy arrays of each file (None where absent):
    gen_params, gen_opt, disc_params, disc_opt, gen_params_ema."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt_dir = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    out = {"step": manifest["step"], "metadata": manifest.get("metadata", {})}
    for name, flag in (("gen_params", None), ("gen_opt", "has_gen_opt"),
                       ("disc_params", "has_disc"), ("disc_opt", "has_disc_opt"),
                       ("gen_params_ema", "has_ema")):
        present = flag is None or manifest.get(flag)
        out[name] = _load(os.path.join(ckpt_dir, f"{name}.npz")) if present else None
    return out
