#!/usr/bin/env python3
"""Kernel C's narrow stages and kernel 7 of two checkouts, side by side on one NVIDIA GPU.

    python3 scripts/torch_narrow_ab.py ROOT LABEL

Imports ``vits_tpu_torch`` and ``chip_smoke.py`` from the checkout at ROOT
(building its kernels into ROOT's ``vits_tpu_torch/_build/``) and prints one
line, ``LABEL {json}``: the device ms per call (the profiler's busy time,
``chip_smoke.py::host_and_device``, 10 calls) of ``fused_stage`` at 32 -> 16
and 16 -> 8 + conv_post (HiFi-GAN V2's stages 2-3, B=2, T_in 20480 and 40960)
and 128 -> 64 (MMS stage 2), each narrow stage also split by launch family
(upsample, resblock convs, conv_post), and of ``fused_resblock`` at C=64, k=11
(B=2, T=2560), at the "highest" and "fast" tiers, on seeded random inputs and
weights. To compare two trees, run it in one chip call in the order A, B, B,
A (each process builds its own tree once):

    for r in "parent /path/to/parent" "change ."; do ...; done
"""

from __future__ import annotations

import json
import sys


def main() -> None:
    root, label = sys.argv[1], sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock
    from vits_tpu_torch.ops.cuda.stage import fused_stage
    from vits_tpu_torch.ops.tiers import resolve_tier

    kernels.library()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def tensor(*shape, scale=0.1):
        return torch.tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)

    def blocks(C):
        return [dict(kernel_size=k, dilations=(1, 3, 5),
                     w1=[tensor(k, C, C) for _ in range(3)], b1=[tensor(C) for _ in range(3)],
                     w2=[tensor(k, C, C) for _ in range(3)], b2=[tensor(C) for _ in range(3)])
                for k in (3, 7, 11)]

    out = {}
    for name in ("highest", "fast"):
        tier = resolve_tier(None if name == "fast" else name,
                            "bfloat16" if name == "fast" else None)
        for c_in, c_out, T_in, final in ((32, 16, 20480, False), (16, 8, 40960, True),
                                         (128, 64, 20480, False)):
            x = tensor(2, T_in, c_in, scale=1.0).to(tier.value_dtype)
            lens = torch.tensor([T_in - 37, T_in // 3], dtype=torch.int32, device=dev)
            up_w, up_b, w_post = tensor(4, c_in, c_out), tensor(c_out), tensor(7, c_out, 1)
            blk = blocks(c_out)

            def stage():
                return fused_stage(x, up_w, up_b, blk, stride=2, up_padding=1, slope=0.1,
                                   lengths=lens, tier=tier, chain=not final,
                                   final_conv=(w_post, 3) if final else None)
            stage()
            torch.cuda.synchronize()
            out[f"C {name} {c_in}->{c_out}"] = cs.host_and_device(stage, calls=10)["device_busy_ms"]
            if c_in <= 32:
                for family, ms in cs.launch_device_ms(stage, cs.STAGE_LAUNCHES, calls=10).items():
                    out[f"C {name} {c_in}->{c_out} {family}"] = ms
        x = tensor(2, 2560, 64, scale=1.0)
        lens = torch.tensor([2523, 0], dtype=torch.int32, device=dev)
        block = blocks(64)[2]

        def resblock():
            return fused_resblock(x, block, slope=0.1, lengths=lens, tier=tier)
        resblock()
        torch.cuda.synchronize()
        out[f"7 {name} C=64 k=11"] = cs.host_and_device(resblock, calls=10)["device_busy_ms"]
    print(label, json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
