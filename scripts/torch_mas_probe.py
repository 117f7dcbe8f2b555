#!/usr/bin/env python3
"""Monotonic Alignment Search on one NVIDIA GPU: the kernel against the loop it replaced.

    python3 scripts/torch_mas_probe.py [--out chiprun_out/mas_probe.json] [--plans-only]

At MMS-TTS width with random weights (seed 0) on ``chip_smoke.py``'s phase 7
batch (B=2, 512 and 300 tokens padded to 512, 1280 and 800 frames padded to
1280):

1. MAS alone on the likelihoods that the fp32 GAN step hands it: the kernel's
   event ms (median of 10) and device ms (the profiler's busy time per call,
   ``chip_smoke.py::host_and_device``), the plain loop's
   (``ops/cuda/align.py::monotonic_align_reference`` on the card) wall ms
   (median of 3, host clock to a synchronise), device ms and device
   operations per call, and the bound (the likelihoods read once and the
   alignment written once at 3.35 TB/s); the kernel's device ms at 1280 and
   2560 frames (T=512, B=2, random likelihoods) and their difference per frame:
   the chain's ns a frame.
2. The GAN step at fp32 and at bf16 with MAS as the loop ("plain", the step
   before the kernel) and as the kernel, in turns plain, kernel, kernel, plain
   on one step function per dtype: each turn one warm-up step, three timed
   steps (median wall ms, host clock to a synchronise), then one step under
   ``torch.profiler``: device busy ms, device operations, idle share of the
   steady step (1 - busy / median), and MAS's launches in the timed steps.
3. Where the kernel's time goes: its event ms (median of 10; one launch a
   call, so the kernel's time and a launch's) at B=2, 640 and 1280 frames and
   SWEEP_TOKENS tokens, for each plan of SWEEP_K tokens a lane on as many
   chain warps as cover T (``ops/cuda/align.py::mas_plan`` with ``K=`` and
   ``warps=``; the default plan marked), launched through
   ``ops/cuda/align.py::launch`` as the wrapper launches it, each alignment
   equal to the plain loop's; the chain's ns a frame of each (the difference
   over 640 frames).
   With ``--plans-only`` only this.

Prints each number as it comes, the card's name and power limit, and writes
everything as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TURNS = ("plain", "kernel", "kernel", "plain")
SWEEP_TOKENS = (512, 768, 1024)
SWEEP_FRAMES = (640, 1280)
SWEEP_K = (4, 16)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/mas_probe.json")
    parser.add_argument("--plans-only", action="store_true")
    args = parser.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.align import monotonic_align, monotonic_align_reference
    from vits_tpu_torch.train import step as step_module
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import draw_noise, make_gan_train_step

    if not torch.cuda.is_available():
        raise SystemExit("torch_mas_probe: no CUDA device is visible")
    card = cs.card_line()
    print(card, flush=True)
    kernels.library()
    device = torch.device("cuda")
    if args.plans_only:
        return plan_sweep(device, card, {"card": card}, args.out)
    config = VitsConfig()
    initial = {k: torch.as_tensor(v) for k, v in
               cs.random_weights(config, keep_training=True).items()}
    disc_np = init_discriminator_params(0)
    batch = cs.training_batch(config, device)
    noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(7))
    result = {"card": card}

    def step_fn(dtype):
        gen = {k: v.requires_grad_() for k, v in from_jax_params(initial, device).items()}
        disc = {k: v.requires_grad_() for k, v in from_jax_params(disc_np, device).items()}
        return make_gan_train_step(config, gen, disc, vits_optimizer(gen), vits_optimizer(disc),
                                   compute_dtype=dtype)

    # 1. MAS alone, on the likelihoods the fp32 step hands it
    seen = []

    def record(*a):
        seen.append(tuple(t.clone() for t in a))
        return monotonic_align(*a)

    fn = step_fn("float32")
    step_module.monotonic_align = record
    try:
        fn(batch, noise=noise)
    finally:
        step_module.monotonic_align = monotonic_align
    inputs = seen[0]
    B, S, T = inputs[0].shape
    if not torch.equal(monotonic_align(*inputs), monotonic_align_reference(*inputs)):
        raise RuntimeError("the kernel and the loop align the step's likelihoods differently")
    plain_walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        monotonic_align_reference(*inputs)
        torch.cuda.synchronize()
        plain_walls.append(1e3 * (time.perf_counter() - t0))
    kernel_dev = cs.host_and_device(lambda: monotonic_align(*inputs))
    plain_dev = cs.host_and_device(lambda: monotonic_align_reference(*inputs), calls=1)
    bound_ms = 1e3 * (2 * inputs[0].numel() * 4 + 4 * (B * S + B * T)) / cs.PEAK_HBM_BYTES
    alone = {"shape": [B, S, T], "kernel_event_ms": cs.median_ms(lambda: monotonic_align(*inputs)),
             "kernel_device_ms": kernel_dev["device_busy_ms"],
             "kernel_device_ops": kernel_dev["device_ops"],
             "plain_wall_ms": float(np.median(plain_walls)),
             "plain_device_ms": plain_dev["device_busy_ms"],
             "plain_device_ops": plain_dev["device_ops"], "bound_ms": bound_ms}
    rng = np.random.default_rng(0)
    per_frames = {}
    for frames in (1280, 2560):
        ll = torch.tensor((rng.standard_normal((2, frames, 512)) * 3 - 10).astype(np.float32),
                          device=device)
        masks = torch.ones((2, frames), device=device), torch.ones((2, 512), device=device)
        per_frames[frames] = cs.host_and_device(
            lambda: monotonic_align(ll, *masks))["device_busy_ms"]
    alone["device_ms_by_frames"] = per_frames
    alone["chain_ns_per_frame"] = 1e6 * (per_frames[2560] - per_frames[1280]) / 1280
    print(f"MAS alone at (B, S, T) = {(B, S, T)}: kernel {alone['kernel_event_ms']:.4f} ms "
          f"(device {alone['kernel_device_ms']:.4f} ms, {alone['kernel_device_ops']:.0f} ops), "
          f"plain loop {alone['plain_wall_ms']:.1f} ms wall (device "
          f"{alone['plain_device_ms']:.2f} ms, {alone['plain_device_ops']:.0f} ops), bound "
          f"{bound_ms:.4f} ms (bytes); kernel device ms at 1280 / 2560 frames "
          f"{per_frames[1280]:.4f} / {per_frames[2560]:.4f}: chain "
          f"{alone['chain_ns_per_frame']:.1f} ns a frame (difference over 1280 frames) ({card})",
          flush=True)
    result["alone"] = alone
    del fn

    # 2. the GAN step with the loop and with the kernel, in turns
    for dtype in ("float32", "bfloat16"):
        fn = step_fn(dtype)
        turns = []
        for mas in TURNS:
            step_module.monotonic_align = monotonic_align_reference if mas == "plain" \
                else monotonic_align
            try:
                fn(batch, noise=noise)  # warm-up
                torch.cuda.synchronize()
                monotonic_align.launches = 0
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn(batch, noise=noise)
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                launches = monotonic_align.launches
                _, events, busy = cs.profiled(lambda: fn(batch, noise=noise))
            finally:
                step_module.monotonic_align = monotonic_align
            steady = float(np.median(times))
            turns.append({"mas": mas, "step_ms": times, "steady_ms": steady, "busy_ms": busy,
                          "idle_share": 1.0 - busy / steady, "device_ops": len(events),
                          "mas_launches": launches})
            print(f"{dtype} GAN step, MAS {mas}: steady {steady:.1f} ms "
                  f"({[round(t, 1) for t in times]}), device busy {busy:.1f} ms, idle share "
                  f"{1.0 - busy / steady:.3f}, {len(events)} device operations, MAS launches "
                  f"{launches} in 3 steps ({card})", flush=True)
        result[dtype] = turns
        del fn
        torch.cuda.empty_cache()
    plan_sweep(device, card, result, args.out)


def plan_sweep(device, card: str, result: dict, out: str) -> None:
    """Section 3, then the JSON to ``out``."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from vits_tpu_torch.ops.cuda.align import (
        MAX_WARPS,
        MAX_WARPS_NARROW,
        launch,
        mas_plan,
        monotonic_align_reference,
    )

    sms = torch.cuda.get_device_properties(device).multi_processor_count

    rng = np.random.default_rng(1)
    plans = {}
    for T in SWEEP_TOKENS:
        default = mas_plan(SWEEP_FRAMES[-1], T, 2, sms)
        for K in SWEEP_K:
            warps = -(-T // (32 * K))
            if warps > (MAX_WARPS if K == 16 else MAX_WARPS_NARROW):
                continue
            name = f"T={T} K={K} x {warps} warps" + (
                " (the plan's)" if (K, warps) == (default.K, default.warps) else "")
            plan = plans.setdefault(name, {"K": K, "warps": warps})
            for frames in SWEEP_FRAMES:
                ll = torch.tensor((rng.standard_normal((2, frames, T)) * 3 - 10).astype(np.float32),
                                  device=device)
                masks = torch.ones((2, frames), device=device), torch.ones((2, T), device=device)
                how = mas_plan(frames, T, 2, sms, K, warps)
                if not torch.equal(launch(how, ll, *masks), monotonic_align_reference(ll, *masks)):
                    raise RuntimeError(f"{name} aligns differently from the loop")
                plan[frames] = cs.median_ms(lambda: launch(how, ll, *masks))
    lo, hi = SWEEP_FRAMES
    for name, ms in plans.items():
        ms["chain_ns_per_frame"] = 1e6 * (ms[hi] - ms[lo]) / (hi - lo)
        print(f"{name}: event ms at {lo} / {hi} frames {ms[lo]:.4f} / {ms[hi]:.4f}, chain "
              f"{ms['chain_ns_per_frame']:.1f} ns a frame (difference over {hi - lo} frames) "
              f"({card})", flush=True)
    result["plans"] = plans
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    print(card, flush=True)


if __name__ == "__main__":
    main()
