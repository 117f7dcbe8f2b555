#!/usr/bin/env python3
"""Kernel C's Hopper routes at the `fast` tier against the routes they replace, on the card.

    python3 scripts/torch_stage_probe.py [--out FILE]   # one CUDA card, nvcc

Builds the package's kernels (and prints ptxas' registers, shared memory and
spills for ``csrc/upsample_wgmma.cu`` and ``csrc/pair_wgmma.cu``), then at
kernel C's shapes for 320 frames (MMS-TTS's and VCTK's 128->64 and 64->32,
small_config's 32->16), bf16 packs, bf16 values:

- the upsampler on Hopper's route (``ops/cuda/stage.py::upsample`` with its
  plan) against ``upsample_reference``, writing fp32 and bf16, at B = 1 (the
  last row 37 steps short) and B = 4 (T_in = 700, lengths 700, 0, 37, 333);
- each 32-channel pair (k, dil) on the pair route (``resblock.py::pair``)
  against ``pair_reference`` in each epilogue mode (bf16 out; the running sum;
  the mean's scale; the mean into bf16), at the same two batches;
- held within the fast tier's bound, 0.03 x max(1, max |plain|);
- timed in this one call, each route beside the one it replaces on the same
  inputs: the device ms a call (the profiler's busy time, ``utils/devprofile.py``)
  and the median event ms of 20 calls, of the upsampler (stage.cu's with its
  fp32 cast of x, and Hopper's), of one stage's resblocks at C = 32
  (``run_pairs``, 18 ``mma.sync`` convs, and ``run_fused_pairs``, 9 pair
  launches), and of ``fused_stage`` at 64->32 + conv_post; and each launch's us
  of one call of either resblock route, by (k, dil).

Prints one line a case and a JSON summary (also written to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vits_tpu_torch.ops import cuda as kernels  # noqa: E402
from vits_tpu_torch.ops.cuda.resblock import (  # noqa: E402
    PAIR_C,
    conv,
    pair,
    pair_plan,
    pair_reference,
    run_fused_pairs,
    run_pairs,
)
from vits_tpu_torch.ops.cuda.stage import (  # noqa: E402
    fused_stage,
    stage_reference,
    stage_routes,
    upsample,
    upsample_plan,
    upsample_reference,
)
from vits_tpu_torch.ops.tiers import resolve_tier  # noqa: E402
from vits_tpu_torch.utils import devprofile  # noqa: E402

TIER = resolve_tier(None, "bfloat16")  # the engine's fast tier
TOL = 0.03
SLOPE = 0.1
FRAMES = 320
PAIRS = [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]
MODES = {"bf16 out": (False, 1.0, True), "running sum": (True, 1.0, False),
         "mean's scale": (True, 1.0 / 3, False), "mean into bf16": (True, 1.0 / 3, True)}


def ptxas_report() -> subprocess.Popen:
    """nvcc -Xptxas -v of the two new sources, started beside the build."""
    tmp = tempfile.mkdtemp()
    cmds = [f"{kernels._nvcc()} {' '.join(kernels.COMPILE_FLAGS)} -Xptxas -v -c "
            f"-o {tmp}/{src}.o {kernels.CSRC / src}" for src in ("upsample_wgmma.cu",
                                                                  "pair_wgmma.cu")]
    return subprocess.Popen(" & ".join(cmds) + " & wait", shell=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def device_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    return devprofile.read(lambda: [fn() for _ in range(5)], attempts=3).busy_ms / 5


def event_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def held(name: str, got: torch.Tensor, want: torch.Tensor, lens=None) -> float:
    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise RuntimeError(f"{name}: non-finite output")
    ratio = float((got - want).abs().max()) / (TOL * max(1.0, float(want.abs().max())))
    print(f"  {name:60s} {ratio:.3g} of tol", flush=True)
    if not ratio <= 1.0:
        raise RuntimeError(f"{name}: off by {ratio:.3g} times the tolerance")
    return ratio


def batches(rng, C, T, dev):
    """B = 1 (37 steps short) and B = 4 (T = 700, an empty row, rows short of a tile)."""
    for B, T_, lengths in ((1, T, [T - 37]), (4, 700, [700, 0, 37, 333])):
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        valid = (torch.arange(T_, device=dev)[None, :] < lens[:, None])[..., None]
        x = torch.tensor(rng.standard_normal((B, T_, C)), dtype=torch.float32, device=dev)
        yield f"B={B} T={T_}", (x * valid).to(torch.bfloat16), lens


def weights(rng, shape, dev, scale=0.05):
    return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32,
                        device=dev).to(torch.bfloat16)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_stage_probe: no CUDA device is visible")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    ptxas = ptxas_report()
    t0 = time.perf_counter()
    kernels.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    out, _ = ptxas.communicate()
    for line in out.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling entry", "error", "warning")):
            print("  ptxas:", line.strip(), flush=True)
    sms = kernels.device_sm_count(dev)
    rng = np.random.default_rng(21)
    summary = {"card": card, "checks": {}, "times": {}}

    # the upsampler at each C stage, both output dtypes
    for C_in, C_out, T_in in ((128, 64, 64 * FRAMES), (64, 32, 128 * FRAMES),
                              (32, 16, 256 * FRAMES)):
        w = weights(rng, (4, C_in, C_out), dev)
        bias = torch.tensor(rng.standard_normal(C_out) * 0.1, dtype=torch.float32, device=dev)
        for label, x, lens in batches(rng, C_in, T_in, dev):
            B, T = x.shape[:2]
            plan = upsample_plan(B, T, C_in, C_out, 4, 2, 1, sms)
            want = upsample_reference(x, w, bias, stride=2, up_padding=1, slope=SLOPE,
                                      lengths=lens, tier=TIER)
            for dtype in (torch.float32, torch.bfloat16):
                up = torch.empty((B, 2 * T, C_out), dtype=dtype, device=dev)
                upsample(x, up, w, bias, lens, stride=2, up_padding=1, slope=SLOPE, tier=TIER,
                         up_fmt=1, up_scale=None, plan=plan)
                torch.cuda.synchronize()
                name = f"upsample {C_in}->{C_out} {label} nw={plan.nw} -> {dtype}"
                summary["checks"][name] = held(name, up, want)
                for b, n in enumerate(lens.tolist()):
                    if float(up[b, 2 * n:].float().abs().sum()) != 0.0:
                        raise RuntimeError(f"{name}: row {b} not zero past its length")

    # each pair at C = 32, each epilogue mode
    for k, d in PAIRS:
        w1, w2 = weights(rng, (k, PAIR_C, PAIR_C), dev), weights(rng, (k, PAIR_C, PAIR_C), dev)
        b1, b2 = (torch.tensor(rng.standard_normal(PAIR_C) * 0.05, dtype=torch.float32,
                               device=dev) for _ in range(2))
        for label, x, lens in batches(rng, PAIR_C, 256 * FRAMES, dev):
            B, T = x.shape[:2]
            plan = pair_plan(B, T, PAIR_C, k, d, sms)
            prev = torch.tensor(rng.standard_normal((B, T, PAIR_C)), dtype=torch.float32,
                                device=dev)
            for mode, (acc, scale, to16) in MODES.items():
                if label.startswith("B=1") and mode not in ("bf16 out", "mean into bf16"):
                    continue
                out32 = prev.clone() if acc else None
                out16 = torch.empty_like(x) if to16 else None
                pair(x, out32, out16, w1, b1, w2, b2, lens, k, d, SLOPE, int(acc), scale, plan,
                     TIER, kernels.stream_of(x))
                torch.cuda.synchronize()
                want = pair_reference(x, w1, b1, w2, b2, lens, k, d, SLOPE, TIER,
                                      prev if acc else None, scale)
                name = f"pair k={k} d={d} {label} nw={plan.nw} {mode}"
                summary["checks"][name] = held(name, out16 if to16 else out32, want)

    # timings, each route beside the one it replaces, on the same inputs
    def timed(name, fn):
        summary["times"][name] = {"device_ms": device_ms(fn), "event_ms": event_ms(fn)}
        t = summary["times"][name]
        print(f"  {name:60s} device {t['device_ms']:.4f} ms  event {t['event_ms']:.3f} ms",
              flush=True)

    from vits_tpu_torch.config import VitsConfig

    config = VitsConfig()
    blocks = [dict(kernel_size=k, dilations=tuple(dils),
                   w1=[weights(rng, (k, PAIR_C, PAIR_C), dev) for _ in dils],
                   w2=[weights(rng, (k, PAIR_C, PAIR_C), dev) for _ in dils],
                   b1=[torch.tensor(rng.standard_normal(PAIR_C) * 0.05, dtype=torch.float32,
                                    device=dev) for _ in dils],
                   b2=[torch.tensor(rng.standard_normal(PAIR_C) * 0.05, dtype=torch.float32,
                                    device=dev) for _ in dils])
              for k, dils in zip(config.resblock_kernel_sizes, config.resblock_dilation_sizes)]
    for C_in, C_out, T_in in ((128, 64, 64 * FRAMES), (64, 32, 128 * FRAMES)):
        x = torch.tensor(rng.standard_normal((1, T_in, C_in)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16)
        lens = torch.tensor([T_in - 37], dtype=torch.int32, device=dev)
        w = weights(rng, (4, C_in, C_out), dev)
        bias = torch.tensor(rng.standard_normal(C_out) * 0.1, dtype=torch.float32, device=dev)
        plan = upsample_plan(1, T_in, C_in, C_out, 4, 2, 1, sms)
        up32 = torch.empty((1, 2 * T_in, C_out), dtype=torch.float32, device=dev)
        kw = dict(stride=2, up_padding=1, slope=SLOPE, tier=TIER, up_fmt=1, up_scale=None)
        timed(f"upsample {C_in}->{C_out} stage.cu (fp32 cast + tf32 mma.sync)",
              lambda: upsample(x, up32, w, bias, lens, plan=None, **kw))
        timed(f"upsample {C_in}->{C_out} wgmma, nw={plan.nw}",
              lambda: upsample(x, up32, w, bias, lens, plan=plan, **kw))
    T = 256 * FRAMES
    lens = torch.tensor([T - 74], dtype=torch.int32, device=dev)
    x16 = torch.tensor(rng.standard_normal((1, T, PAIR_C)), dtype=torch.float32,
                       device=dev).to(torch.bfloat16)
    x32, h = x16.float(), torch.empty((1, T, PAIR_C), dtype=torch.float32, device=dev)
    plans = tuple(tuple(pair_plan(1, T, PAIR_C, blk["kernel_size"], dd, sms)
                        for dd in blk["dilations"]) for blk in blocks)
    conv.mma_sync_launches = conv.pair_launches = 0
    timed("resblocks C=32 T=81920: run_pairs (18 mma.sync convs)",
          lambda: run_pairs(x32, h, blocks, lens, SLOPE, tier=TIER))
    timed("resblocks C=32 T=81920: run_fused_pairs (9 pair launches)",
          lambda: run_fused_pairs(x16, h, blocks, lens, SLOPE, plans, TIER))
    summary["launches"] = {"mma_sync": conv.mma_sync_launches, "pair": conv.pair_launches}
    # each launch of one trio call on both routes, by (k, dil): what a launch's time scales with
    for name, fn in (("run_pairs", lambda: run_pairs(x32, h, blocks, lens, SLOPE, tier=TIER)),
                     ("run_fused_pairs",
                      lambda: run_fused_pairs(x16, h, blocks, lens, SLOPE, plans, TIER))):
        fn()
        torch.cuda.synchronize()
        reading = devprofile.read(fn, attempts=3)
        durs = [round(e["dur"], 1) for e in reading.events if e["cat"] == "kernel"]
        summary["times"][f"{name} launches (us)"] = durs
        order = [(b["kernel_size"], d) for b in blocks for d in b["dilations"]]
        print(f"  {name}: launch us in order (k, dil: {order}) {durs}", flush=True)

    # the whole stage at 64->32 + conv_post, against its twin
    up_w = weights(rng, (4, 64, PAIR_C), dev)
    up_b = torch.tensor(rng.standard_normal(PAIR_C) * 0.1, dtype=torch.float32, device=dev)
    w_post = weights(rng, (7, PAIR_C, 1), dev, scale=0.3)
    xs = torch.tensor(rng.standard_normal((1, 128 * FRAMES, 64)), dtype=torch.float32,
                      device=dev).to(torch.bfloat16)
    slens = torch.tensor([128 * FRAMES - 37], dtype=torch.int32, device=dev)
    skw = dict(stride=2, up_padding=1, slope=SLOPE, lengths=slens, tier=TIER,
               final_conv=(w_post, 3))
    routes = stage_routes(1, 128 * FRAMES, 64, PAIR_C, 4, 2, 1, 1, blocks, TIER, sms)
    if routes.upsample is None or routes.pairs is None:
        raise RuntimeError(f"64->32 at fast on bf16 packs is not on the new routes: {routes}")
    summary["checks"]["fused_stage 64->32 +conv_post"] = held(
        "fused_stage 64->32 +conv_post", fused_stage(xs, up_w, up_b, blocks, **skw),
        stage_reference(xs, up_w, up_b, blocks, **skw))
    timed("fused_stage 64->32 +conv_post (new routes)",
          lambda: fused_stage(xs, up_w, up_b, blocks, **skw))
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))


if __name__ == "__main__":
    main()
