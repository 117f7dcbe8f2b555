#!/usr/bin/env python3
"""Kernel B's conv on the card: every tile and split at the main path's shapes.

    python3 scripts/torch_conv_probe.py     # from the repo root; one CUDA card, nvcc

For one conv launch (``vk_conv`` of ``vits_tpu_torch/csrc/resblock_trio.cu``)
at each shape the serving and training paths give it, and each (tile, split)
the kernel takes: its median ms (CUDA events over 20 launches), its TFLOP/s
of fp32 work, and its max error against a float64 reference relative to the
output's scale, beside cuDNN's fp32 convolution (TF32 off) on the same
inputs. ``*`` marks what ``conv_plan`` picks. Then it builds and runs
``scripts/torch_mma_ceiling.cu``: the rate of mma.sync TF32 itself.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from vits_tpu_torch.ops import cuda as kernels  # noqa: E402
from vits_tpu_torch.ops.conv import conv1d, leaky_relu  # noqa: E402
from vits_tpu_torch.ops.cuda.resblock import CONV_SPLITS, CONV_TILES, conv_plan  # noqa: E402

# (C, T, B): B's MMS stages 0-1, C's resblocks, kernel 5 at a 32-frame segment,
# batch 4 (C=256, 128), kernel 7 on HiFi-GAN V2's stages 0-1, batch 2
SHAPES = ((256, 2560, 1), (128, 20480, 1), (64, 40960, 1), (32, 81920, 1), (256, 256, 4),
          (128, 2048, 4), (64, 2560, 2), (32, 20480, 2))
TAPS = ((3, 1), (7, 3), (11, 5))
SLOPE = 0.1


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_conv_probe: no CUDA device is visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    lib = kernels.library()
    device = torch.device("cuda")
    sms = kernels.device_sm_count(device)
    stream = kernels.stream_of(torch.empty(1, device=device))
    rng = np.random.default_rng(0)
    for C, T, B in SHAPES:
        for k, dil in TAPS:
            x = torch.tensor(rng.standard_normal((B, T, C)), dtype=torch.float32, device=device)
            w = torch.tensor(rng.standard_normal((k, C, C)) * 0.05, dtype=torch.float32,
                             device=device)
            bias = torch.tensor(rng.standard_normal(C) * 0.05, dtype=torch.float32, device=device)
            lens = torch.full((B,), T, dtype=torch.int32, device=device)
            out = torch.empty_like(x)
            pad = dil * (k - 1) // 2
            exact = conv1d(leaky_relu(x.double(), SLOPE), w.double(), bias.double(), padding=pad,
                           dilation=dil)
            scale = float(exact.abs().max())

            def plain():
                return conv1d(leaky_relu(x, SLOPE), w, bias, padding=pad, dilation=dil)

            flops = 2 * B * T * k * C * C
            line = (f"C={C} T={T} B={B} k={k} dil={dil}: cuDNN {median_ms(plain):.4f} ms err "
                    f"{float((plain().double() - exact).abs().max()) / scale:.1e} |")
            plan = conv_plan(B, T, C, C, k, sms)
            steps = k * C // 32
            for tile, (bm, bn) in enumerate(CONV_TILES):
                for split in CONV_SPLITS:
                    if C % bn or steps % split:
                        continue

                    def call(tile=tile, split=split):
                        kernels.check(lib.vk_conv(
                            x.data_ptr(), out.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                            lens.data_ptr(), B, T, C, C, k, dil, pad, SLOPE, 0, 1.0, tile, split,
                            0, 0, None, 0, None, stream), "conv")

                    call()
                    torch.cuda.synchronize()
                    err = float((out.double() - exact).abs().max()) / scale
                    ms = median_ms(call)
                    mark = "*" if (tile, split) == (plan.tile, plan.split) else ""
                    line += (f" {mark}{bm}x{bn}/{split} {ms:.4f} ms {flops / ms / 1e9:.0f} TFLOP/s"
                             f" err {err:.1e};")
            print(line, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        exe = f"{tmp}/mma_ceiling"
        subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                        exe, str(ROOT / "scripts" / "torch_mma_ceiling.cu")], check=True)
        subprocess.run([exe], check=True)
    print(card, flush=True)


if __name__ == "__main__":
    main()
