#!/usr/bin/env python3
"""Where kernel 6 (the reverse flow) and kernel 5's backward spend their device time.

    python3 scripts/torch_flow_trio_probe.py        # one CUDA card; about a minute

At ``chip_smoke.py``'s shapes, with random weights (seed 0): the flow at VCTK
width (B=1, T=320; B=3, T=320 with lengths 320, 137, 0; B=8, T=640; B=16,
T=1280; speaker conditioning on) and the trio's backward alone on MMS
stages 0-1 (B=4: C=256, T=256 and C=128, T=2048), each under
``torch.profiler``: device busy ms per call, device ms per launch family
(the flow's pre / gate / res-skip / post products; the backward's input- and
weight-gradient launches), and the host's enqueue ms per call. Then the same
calls under other plans, to compare within this run: each flow product's
(tile, split) in turn over the tiles and splits ``conv_plan`` allows, and
the weight-gradient split. Prints the card and its power limit first, and
one JSON line of every number last.
"""

from __future__ import annotations

import ctypes
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

FLOW_SHAPES = ((320, (320,)), (320, (320, 137, 0)), (640, (640,) * 8), (1280, (1280,) * 16))
FLOW_FAMILIES = (("pre", ("FlowEpi<0>",)), ("gate", ("FlowEpi<1>",)),
                 ("res/skip", ("FlowEpi<2>",)), ("post", ("FlowEpi<3>",)))
TRIO_FAMILIES = (("input grads", ("conv_kernel",)), ("weight grads", ("wgrad_kernel",)))
PRODUCTS = ("pre", "gate", "res/skip", "post")


def device_ms(fn, families, calls: int = 5) -> dict:
    torch.cuda.synchronize()
    _, device, busy = chip_smoke.profiled(lambda: [fn() for _ in range(calls)])
    found = chip_smoke.by_family(device, families)
    return {"busy": busy / calls, **{k: v[0] / calls for k, v in found.items()}}


def flow_probe(results: dict) -> None:
    from vits_tpu_torch.config import VitsConfig
    from vits_tpu_torch.io import random_params
    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.ops.cuda import device_sm_count
    from vits_tpu_torch.ops.cuda import flow as flow_mod
    from vits_tpu_torch.ops.cuda.resblock import CONV_SPLITS, CONV_TILES

    config = VitsConfig(num_speakers=109, speaker_embedding_size=256)
    params = from_jax_params({k: v for k, v in random_params(config, seed=0).items()
                              if k.startswith("flow.") or k == "embed_speaker.weight"}, "cuda")
    p = ParamView(params)
    packed = flow_mod.pack_flow_weights(p, config)
    rng = np.random.default_rng(4)
    default_plan = flow_mod.flow_plan
    sms = device_sm_count(torch.device("cuda"))
    half, hidden, k = config.flow_size // 2, config.hidden_size, config.wavenet_kernel_size
    for T, lengths in FLOW_SHAPES:
        B = len(lengths)
        x = torch.tensor(rng.standard_normal((B, T, config.flow_size)), dtype=torch.float32,
                         device="cuda")
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        x = x * (torch.arange(T, device="cuda")[None, :] < lens[:, None])[..., None]
        emb = params["embed_speaker.weight"][torch.arange(B, device="cuda") * 53 % 109][:, None]

        def call():
            return flow_mod.fused_flow(x, p, config, lengths=lens, speaker_embeddings=emb,
                                       packed=packed)

        base = list(default_plan(B, T, half, hidden, k, sms))
        entry = {"plan": base, "default": device_ms(call, FLOW_FAMILIES),
                 "enqueue_ms": chip_smoke.host_and_device(call)["enqueue_ms"],
                 "event_ms": chip_smoke.median_ms(call), "alternatives": []}
        print(f"flow B={B} T={T}: plan {base} {entry['default']} enqueue "
              f"{entry['enqueue_ms']:.3f} event {entry['event_ms']:.3f}", flush=True)
        # each product's tile and split in turn, the others at the default plan
        for i, (tile, split) in itertools.product(range(4), itertools.product(
                range(len(CONV_TILES)), CONV_SPLITS)):
            plan = list(base)
            if plan[2 * i: 2 * i + 2] == [tile, split]:
                continue
            plan[2 * i: 2 * i + 2] = [tile, split]
            flow_mod.flow_plan = lambda *a, plan=plan: (ctypes.c_int * 8)(*plan)
            packed._workspaces.clear()  # captured anew under this plan
            try:
                ms = device_ms(call, FLOW_FAMILIES, calls=3)
            except RuntimeError:  # a split the kernel refuses (a block with no steps)
                continue
            finally:
                flow_mod.flow_plan = default_plan
                packed._workspaces.clear()
            entry["alternatives"].append({"product": PRODUCTS[i], "tile": tile, "split": split,
                                          "ms": ms.get(PRODUCTS[i]), "busy": ms["busy"]})
        best = {}
        for alt in entry["alternatives"]:
            if alt["ms"] is not None and alt["ms"] < best.get(alt["product"], (9e9,))[0]:
                best[alt["product"]] = (alt["ms"], alt["tile"], alt["split"])
        print(f"  best alternative per product (ms, tile, split): {best}", flush=True)
        results["flow"][f"B={B} T={T}"] = entry


def trio_probe(results: dict) -> None:
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io import random_params
    from vits_tpu_torch.io.params import ParamView, from_jax_params
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda import trio_grad

    config = VitsConfig()
    params = from_jax_params({k: v for k, v in random_params(config, seed=0).items()
                              if k.startswith("decoder.")}, "cuda")
    decoder = ParamView(params).sub("decoder")
    rng = np.random.default_rng(2)
    default_split = trio_grad.wgrad_split
    for i, T in ((0, 256), (1, 2048)):
        blocks = _stage_resblocks(decoder, config, i)
        C = blocks[0]["w1"][0].shape[-1]
        x = torch.tensor(rng.standard_normal((4, T, C)), dtype=torch.float32, device="cuda")
        g = torch.tensor(rng.standard_normal((4, T, C)), dtype=torch.float32, device="cuda")
        with torch.no_grad():
            _, acts = trio_grad.trio_forward_with_acts(x, blocks, slope=config.leaky_relu_slope)
        saved = trio_grad.flat_acts(acts)

        def call():
            with torch.no_grad():
                return trio_grad.trio_backward(g, x, blocks, saved,
                                               slope=config.leaky_relu_slope)

        entry = {"default": device_ms(call, TRIO_FAMILIES),
                 "enqueue_ms": chip_smoke.host_and_device(call)["enqueue_ms"],
                 "event_ms": chip_smoke.median_ms(call), "splits": {}}
        print(f"trio backward C={C} T={T}: {entry['default']} enqueue "
              f"{entry['enqueue_ms']:.3f} event {entry['event_ms']:.3f}", flush=True)
        for split in (1, 2, 4, 8):
            trio_grad.wgrad_split = lambda *a, split=split: split
            try:
                entry["splits"][split] = device_ms(call, TRIO_FAMILIES, calls=3)
            except RuntimeError:
                pass
            finally:
                trio_grad.wgrad_split = default_split
        print(f"  by weight-gradient split: {entry['splits']}", flush=True)
        results["trio_backward"][f"C={C} T={T}"] = entry


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("torch_flow_trio_probe: no CUDA device is visible")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(card, flush=True)
    results = {"card": card, "flow": {}, "trio_backward": {}}
    flow_probe(results)
    trio_probe(results)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
