#!/usr/bin/env python3
"""The resblock conv's Hopper route against its mma.sync route, on the card.

    python3 scripts/torch_wgmma_probe.py [--sweep] [--lib PATH]   # one CUDA card, nvcc

For one conv launch at the `fast` tier with bf16 weights at each shape of
kernels B and C's resblocks (MMS-TTS's stages 0-2 for 320 frames, phase 7's
training segment) and each (k, dil) of the HiFi-GAN V1 resblocks: the max
error of ``vk_conv_wgmma`` (``csrc/conv_wgmma.cuh``, the plan of
``ops/cuda/resblock.py::wgmma_plan``) and of ``vk_conv`` (``conv_gemm.cuh``'s
bf16 ``mma.sync``, ``conv_plan``) against a float64 conv of the same bf16
operands, relative to the output's scale; the median ms of each (CUDA events
over 20 launches), its device ms (the profiler's busy time a call) and the
host's enqueue us a launch; the bound (the FLOPs at 989 TFLOP/s); and cuDNN's
bf16 ``F.conv1d`` of the same operands (the products alone: the library
yardstick). With ``--sweep`` the device ms of every tile width, warpgroup count
and split of the Hopper route at the ring and blocks an SM of ``wgmma_fits``
(the data ``wgmma_plan``'s cost model is fitted to). ``--lib`` loads a library
built from ``csrc/resblock_trio.cu`` and ``csrc/resblock_wgmma.cu`` alone (one
``nvcc ... -shared``) in place of the package's whole build.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vits_tpu_torch.ops import cuda as kernels  # noqa: E402
from vits_tpu_torch.utils import devprofile  # noqa: E402
from vits_tpu_torch.ops.cuda.resblock import (  # noqa: E402
    CONV_SPLITS,
    MAX_SMEM_BYTES,
    WGMMA_SHAPES,
    conv_plan,
    wgmma_fits,
    wgmma_plan,
)

# (C, T, B, length): B's MMS stages 0-1 and C's stage-2 resblocks for 320 frames
# (the last row 37 steps short, as chip_smoke.py's phase 3), a training segment.
SHAPES = ((256, 2560, 1, 2523), (128, 20480, 1, 20443), (64, 40960, 1, 40923),
          (256, 256, 4, 256))
TAPS = ((3, 1), (3, 3), (3, 5), (7, 1), (7, 3), (7, 5), (11, 1), (11, 3), (11, 5))
SLOPE = 0.1
PEAK_BF16 = 989e12
FAST = 1  # csrc/common.cuh TierMode kFast
W16 = 1  # WeightFormat kW16


def median_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def enqueue_us(fn, calls: int = 50) -> float:
    """Host microseconds to enqueue one launch (no synchronisation between them)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def device_ms(fn, calls: int = 10) -> float:
    """The profiler's device busy ms a call (``utils/devprofile.py``)."""
    fn()
    return devprofile.device_ms(lambda: [fn() for _ in range(calls)], attempts=3) / calls


def open_lib(path: str | None):
    if path is None:
        return kernels.library()
    lib = ctypes.CDLL(path)
    for name in ("vk_conv", "vk_conv_wgmma"):
        getattr(lib, name).argtypes = kernels._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.vk_error_string.argtypes = [ctypes.c_int]
    lib.vk_error_string.restype = ctypes.c_char_p
    return lib


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--lib", default=None)
    ap.add_argument("--quick", action="store_true", help="one (k, dil) a shape, no timing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_wgmma_probe: no CUDA device is visible")
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = open_lib(args.lib)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream

    def run(status, what):
        if status != 0:
            raise RuntimeError(f"{what}: CUDA error {status} ({lib.vk_error_string(status)})")

    gen = torch.Generator(device=dev).manual_seed(0)
    for C, T, B, length in SHAPES:
        x = torch.randn((B, T, C), device=dev, generator=gen)
        lens = torch.tensor([T] * (B - 1) + [length], dtype=torch.int32, device=dev)
        x[B - 1, length:] = 0.0
        res = torch.randn((B, T, C), device=dev, generator=gen)
        for k, dil in TAPS[-1:] if args.quick else TAPS:
            pad = dil * (k - 1) // 2
            w = (torch.randn((k, C, C), device=dev, generator=gen) / (k * C) ** 0.5).to(
                torch.bfloat16)
            bias = torch.randn((C,), device=dev, generator=gen) * 0.1
            # float64 of the same bf16 operands, the bias, the residual and the mask
            a = torch.nn.functional.leaky_relu(x, SLOPE).to(torch.bfloat16)
            ref = torch.nn.functional.conv1d(a.double().transpose(1, 2),
                                             w.double().permute(2, 1, 0), padding=pad,
                                             dilation=dil).transpose(1, 2)
            ref = ref + bias.double() + res.double()
            ref = ref * (torch.arange(T, device=dev)[None, :] < lens[:, None]).double()[..., None]
            scale = float(ref.abs().max())
            out = torch.empty_like(x)

            def new(plan):
                return lambda: run(lib.vk_conv_wgmma(
                    x.data_ptr(), out.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
                    lens.data_ptr(), B, T, C, C, k, dil, pad, SLOPE, 0, 1.0, *plan, 0, None,
                    stream), f"wgmma {plan}")

            def old(tile, split):
                return lambda: run(lib.vk_conv(
                    x.data_ptr(), out.data_ptr(), w.data_ptr(), bias.data_ptr(), res.data_ptr(),
                    lens.data_ptr(), B, T, C, C, k, dil, pad, SLOPE, 0, 1.0, tile, split, FAST,
                    W16, None, 0, None, stream), f"mma.sync {tile} {split}")

            def err(fn):
                out.fill_(float("nan"))
                fn()
                torch.cuda.synchronize()
                return float((out.double() - ref).abs().max()) / scale

            plan = wgmma_plan(B, T, C, C, k, dil, sms)
            tile, split, _ = conv_plan(B, T, C, C, k, sms)
            e_new, e_old = err(new(plan[:4])), err(old(tile, split))
            bound = 1e3 * 2 * (int(lens.sum()) * k * C * C) / PEAK_BF16
            line = (f"C={C} T={T} B={B} k={k} dil={dil}: wgmma {plan[:4]} per_sm {plan.per_sm} "
                    f"err {e_new:.2e}, "
                    f"mma.sync ({tile}, {split}) err {e_old:.2e}")
            if not args.quick:
                a_t, w_t = a.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
                cudnn = median_ms(lambda: torch.nn.functional.conv1d(
                    a_t, w_t, padding=pad, dilation=dil))
                line += (f"; ms wgmma {median_ms(new(plan[:4])):.4f} mma.sync "
                         f"{median_ms(old(tile, split)):.4f} cudnn bf16 {cudnn:.4f} "
                         f"bound {bound:.4f}; device ms wgmma {device_ms(new(plan[:4])):.4f} "
                         f"mma.sync {device_ms(old(tile, split)):.4f}; enqueue us wgmma "
                         f"{enqueue_us(new(plan[:4])):.1f} mma.sync "
                         f"{enqueue_us(old(tile, split)):.1f}")
            print(line, flush=True)
            if not e_new <= 1e-2:
                raise RuntimeError(f"wgmma conv off by {e_new:.3e} of the output's scale")
            if args.sweep:
                halo = (k - 1) * dil
                for bn, nc in WGMMA_SHAPES:
                    fit = wgmma_fits(bn, nc, halo) if C % bn == 0 else None
                    if fit is None:
                        continue
                    stages, per_sm = fit
                    for sp in CONV_SPLITS:
                        steps = k * C // 64
                        share = -(-steps // sp)
                        if (sp - 1) * share >= steps or 64 * nc % sp:
                            continue
                        blocks = -(-T // (64 * nc)) * (C // bn) * B * sp
                        ms = device_ms(new((bn, nc, stages, sp)))
                        mark = "*" if (bn, nc, stages, sp) == plan[:4] else " "
                        print(f"   {mark} bn={bn} nc={nc} stages={stages} per_sm={per_sm} "
                              f"split={sp} blocks={blocks} steps/block={share}: "
                              f"{ms:.4f} ms device", flush=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
