#!/usr/bin/env python3
"""Kernel 7 (``csrc/resblock_block.cu``) at every plan, on one NVIDIA GPU.

    python3 scripts/torch_block_probe.py [--ptxas] [--out chiprun_out/block_probe.json]

For each shape kernel 7 meets (HiFi-GAN V2's stages 0-1 at 320 frames, batch
2 with a length-0 row, as ``chip_smoke.py`` phase 3 times them; the same
stages of one 576-frame request; kernel C's MMS resblock shape) and every
time tile and cluster that fits in shared memory: max |diff| against the
plain ``resblock_reference`` (tolerance 5e-5 x max(1, max|plain|)), device
ms per call (CUDA events around 10 back-to-back calls, one launch each, the
least of 3 such runs; the six-launch route under the profiler, its busy
time), and
``block_plan``'s modelled ms; beside them the device ms of the six-launch
route (B's conv, ``run_pairs``) on the same inputs. ``block_plan``'s pick is
marked. ``--ptxas`` first compiles the source with ``-Xptxas -v`` and prints
each kernel's registers, shared memory and spills. Writes every row to
``--out`` as JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

TOL = 5e-5
DILATIONS = (1, 3, 5)
# (name, B, T, C, lengths)
SHAPES = (
    ("V2 stage 0, 320 frames", 2, 2560, 64, (2523, 0)),
    ("V2 stage 1, 320 frames", 2, 20480, 32, (20443, 0)),
    ("V2 stage 0, 576 frames", 1, 4608, 64, (4608,)),
    ("V2 stage 1, 576 frames", 1, 36864, 32, (36864,)),
    ("MMS C resblock", 1, 40960, 64, (40923,)),
)


def ptxas(source: Path) -> None:
    from vits_tpu_torch.ops.cuda import COMPILE_FLAGS, _nvcc

    proc = subprocess.run([_nvcc(), *COMPILE_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
                           str(source)], capture_output=True, text=True, check=False)
    for line in proc.stderr.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print("  " + line.strip(), flush=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")


def kernel_ms(fn, calls: int = 5) -> float:
    """Device busy ms per call under the profiler (``chip_smoke.profiled``), over ``calls``."""
    from chip_smoke import profiled

    fn()
    torch.cuda.synchronize()
    return profiled(lambda: [fn() for _ in range(calls)])[2] / calls


def event_ms(fn, calls: int = 10, runs: int = 3) -> float:
    """ms per call from CUDA events around ``calls`` back-to-back calls, least of ``runs``."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ptxas", action="store_true")
    parser.add_argument("--out", default="chiprun_out/block_probe.json")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_block_probe: no CUDA device is visible")
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda import resblock as R

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    if args.ptxas:
        ptxas(kernels.CSRC / "resblock_block.cu")
    kernels.library()
    device = torch.device("cuda")
    sms = kernels.device_sm_count(device)
    rng = np.random.default_rng(0)
    rows, failures = [], []
    for name, B, T, C, lengths in SHAPES:
        x = rng.standard_normal((B, T, C)).astype(np.float32)
        x *= (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[..., None]
        x = torch.tensor(x, device=device)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        for k in (3, 7, 11):
            blk = dict(kernel_size=k, dilations=DILATIONS, **{
                n: torch.tensor(rng.standard_normal(shape) * 0.05, dtype=torch.float32,
                                device=device)
                for n, shape in (("w1", (3, k, C, C)), ("b1", (3, C)),
                                 ("w2", (3, k, C, C)), ("b2", (3, C)))})
            want = R.resblock_reference(x, blk, slope=0.1, lengths=lens)
            scale = max(1.0, float(want.abs().max()))
            out = torch.empty_like(x)
            six = kernel_ms(lambda: R.run_pairs(x, out, [blk], lens, 0.1))
            plan = R.block_plan(B, T, C, k, DILATIONS, sms)
            print(f"{name} C={C} B={B} T={T} k={k}: six launches {six:.4f} ms; plan "
                  f"bm={plan.bm} cluster={plan.cluster}", flush=True)
            weights = R.pair_weights([blk])
            pointers = (R.ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
            dil = (R.ctypes.c_int * 3)(*DILATIONS)
            lib = kernels.library()
            stream = kernels.stream_of(x)
            for cluster in R.BLOCK_CLUSTERS:
                if C % cluster or C // cluster < 8:
                    continue
                for bm in R.BLOCK_TILES:
                    if R.block_smem(bm, C, k, DILATIONS, cluster) > R.MAX_SMEM_BYTES:
                        break

                    def call():
                        kernels.check(lib.vk_resblock_block(
                            x.data_ptr(), out.data_ptr(), lens.data_ptr(), pointers, dil, 3,
                            B, T, C, k, 0.1, bm, cluster, 0, 1.0, 0, 0, 1.0, 0, stream),
                            "resblock kernel")

                    call()
                    err = float((out - want).abs().max()) / scale
                    ms = event_ms(call)
                    model = R.block_cost(B, T, C, k, DILATIONS, sms, bm, cluster) / 1e6
                    picked = (bm, cluster) == (plan.bm, plan.cluster)
                    rows.append(dict(shape=name, B=B, T=T, C=C, k=k, bm=bm, cluster=cluster,
                                     device_ms=ms, model_ms=model, six_launch_ms=six,
                                     err_over_tol=err / TOL, picked=picked, card=card))
                    print(f"  bm={bm:4d} cluster={cluster}  {ms:.4f} ms  model {model:.4f}  "
                          f"err/tol {err / TOL:.3f}{'  <- plan' if picked else ''}", flush=True)
                    if not err <= TOL:
                        failures.append(f"{name} k={k} bm={bm} cluster={cluster}: "
                                        f"{err / TOL:.3g} x the tolerance")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    if failures:
        raise SystemExit("past the tolerance:\n" + "\n".join(failures))


if __name__ == "__main__":
    main()
