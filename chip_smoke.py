#!/usr/bin/env python3
"""Run the PyTorch port (vits_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from a checkout; needs one CUDA card

Phases, in order; any failure raises, and the script exits non-zero without
printing its result line:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: nvcc builds the kernels from ``vits_tpu_torch/csrc`` (one process
   per source, in parallel; seconds);
3. kernels vs plain: each hand-written kernel against its plain PyTorch
   version on the card, max |diff| against the stated tolerance, the median
   ms of both (CUDA events) and the kernel's bound (the larger of its FLOPs at
   67 TFLOP/s fp32 and its bytes at 3.35 TB/s, from this run's shapes and
   valid lengths). Serving kernels A, B, C at the shapes of a 128-token MMS
   request (320 frames); training kernels: A's logsumexp and the attention
   backward (kernel 4) at B=2, L=512, lengths (507, 0), and the trainable
   trio (kernel 5: output and saved activations; its backward alone on the
   plain forward's activations; forward and backward together, with the
   count of saved activations the two forwards round to opposite signs) at
   the decoded-segment shapes of a 32-frame segment, batch 4; kernel 6 (the
   reverse flow) at VCTK width with speaker conditioning, at B=1 and at B=3
   with lengths (320, 137, 0) for T=320, and at B=8, T=640 and B=16,
   T=1280, with the B=1 call's host enqueue ms and its device busy ms under
   ``torch.profiler``, kernel and plain; kernel 7 (one resblock) and kernel
   C at C_out 16 and 8 at the shapes of HiFi-GAN V2's stages for 320 frames;
4. serving: ``vits_tpu_torch.load_model`` of a full-width MMS-TTS model
   (``VitsConfig()``, random weights from ``vits_tpu_torch.io.random_params``,
   seed 0) on ``cuda``; three single requests, then one batch of three texts with
   per-row seeds. Audio is finite, in [-1, 1], of positive length; every
   kernel's launch count rose during those requests; each batch row equals
   its solo run; a repeated seed gives identical audio; and one dispatch on
   the card agrees with the same dispatch through the plain versions on the
   CPU, given the same noise;
5. multi-speaker serving at the published VCTK width (109 speakers, 256-wide
   embeddings, random weights with the posterior encoder, seed 0) with
   ``EngineConfig(use_pallas_flow=True)``: as phase 4 with speakers 0, 17 and
   108 and per-row speakers in the batch, kernels A, B, C and 6 launched,
   speakers 0 and 17 differing on the same text and seed, and the ms per
   request with the flow kernel on and off; then voice conversion of a
   synthesized utterance from speaker 0 to 17 (posterior mean: finite,
   frames x hop long, identical on a second call, card vs CPU);
6. the narrow vocoder: one request at HiFi-GAN V2's decoder (MMS text side,
   ``upsample_initial_channel=128``) through kernels 7 and C at C_out 16 and
   8, and the card-vs-CPU check;
7. training at full MMS width (random weights with the training modules,
   seed 0; the discriminator at seed 0): the inference kernels refuse
   autograd; a warm-up GAN step, then three on a batch of 512 and 300 tokens
   (padded to 512) over 1280 frames -- losses finite, every parameter with a
   finite gradient and moved, kernels A-with-lse, 4 and 5 launched and B, C
   not -- with ms per step and peak memory; one step with each call site
   timed between synchronisations and one under ``torch.profiler`` (device
   busy time, idle share, device ms per kernel family); one ``generator_loss``
   and its gradients at the weights the steps started from, on the card vs
   the plain CPU path with the same noise (equal MAS durations; losses, and
   gradients by relative L2 error per module and per tensor, within a
   multiple of the CPU's own noise floor: the largest movement when every
   weight is perturbed by 1e-7, over three perturbations); and ``train()``
   on a synthetic micro-corpus for 4 steps with checkpoints, resumed to
   step 6.

Each path's launch counts are set to 0 just before it and read just after.
Then one JSON line of the kernels' numbers (``ms``/``plain_ms``/``bound_ms``:
the sums over the kernel's timed shapes; ``launches``: the count over the
paths that run the kernel, the serving paths for A, B, C, 6, 7 and training
for 4 and 5; ``library_ms`` is null: no single PyTorch call computes any of
these functions), and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import io
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

# Kernel-vs-plain tolerance: max |diff| <= KERNEL_TOL * max(1, max |plain|).
# fp32 on both sides, sums in another order over up to 126 taps x C inputs.
KERNEL_TOL = 5e-5
# Gradients are held per tensor by relative L2 error ||got - plain|| / ||plain||.
# The trio's backward alone, run on the plain forward's saved activations,
# differs from plain autograd only in summation order: GRAD_RTOL.
GRAD_RTOL = 1e-5
# The whole trainable trio (kernel forward, then the backward on the kernel's
# activations): leaky's derivative steps at 0, so a saved pre-activation that
# kernel and plain round to opposite signs moves one entry of dy by 0.9 |dh|,
# and |dh| reaches hundreds at random MMS weights. The script counts those
# entries; with none the bound is GRAD_RTOL, with some it is FLIP_GRAD_RTOL.
FLIP_GRAD_RTOL = 1e-2
# Card vs CPU: a gradient tensor that a 1e-7 relative weight perturbation
# moves by more than this share of its norm is rounding noise on the CPU.
NOISY_GRAD = 1e-2
TENSOR_FLOOR_FACTOR = 30
# Card vs CPU: the noise floor is the largest movement over this many perturbations.
FLOOR_SAMPLES = 3
# Card vs CPU for one whole dispatch. Random weights inflate the activations
# (latents reach ~255; most samples saturate the final tanh), so fp32 noise
# is larger than on trained weights: on the CPU, perturbing every weight by
# 1e-7 relative moves this dispatch's latents by 4.7e-4 and its waveform by
# 1.6e-4. A wrong kernel moves them by O(1).
LATENT_RTOL = 1e-5  # max |diff| <= LATENT_RTOL * max |latents|
WAVE_ATOL = 1e-3
# Batch row vs solo run: one int16 PCM step (1/32767) of transfer rounding
# plus the plain convs' batch-size-dependent summation order.
BATCH_ATOL = 2e-3
# The card's peaks for a kernel's bound (NVIDIA H100 SXM data sheet): fp32
# outside the tensor cores, and HBM.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SINGLE_TEXTS = (
    "hello world.",
    "the quick brown fox jumps over the lazy dog.",
    "speech synthesis on a graphics card runs the text encoder, the duration "
    "predictor, the flow and the vocoder.",
)
BATCH_TEXTS = ("good morning.", "how are you today?", "see you soon, my friend.")
BATCH_SEEDS = (11, 22, 33)
VOCAB = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
SINGLE_SPEAKERS = (0, 17, 108)
BATCH_SPEAKERS = (5, 17, 0)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return proc.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def conv_flops(steps: int, k: int, c_in: int, c_out: int) -> int:
    return 2 * steps * k * c_in * c_out


def steps_of(x: torch.Tensor, lens: torch.Tensor | None) -> int:
    """Valid time steps over the batch: the work this run's data needs."""
    return x.shape[0] * x.shape[1] if lens is None else int(lens.sum())


def resblocks_flops(steps: int, C: int, blocks) -> int:
    return sum(2 * len(blk["dilations"]) * conv_flops(steps, blk["kernel_size"], C, C)
               for blk in blocks)


def attention_flops(lengths, heads: int, d: int, window: int, backward: bool = False) -> int:
    """QK^T and PV (and their relative-position terms) over each row's valid keys;
    the backward recomputes the scores and takes five such products."""
    products = 5 if backward else 2
    return sum(heads * products * (2 * n * n * d + 2 * n * (2 * window + 1) * d)
               for n in lengths)


def compare(name: str, shape: str, kernel, plain, grad_rtol: float | None = None,
            timed: bool = True, work: tuple[int, int] | None = None) -> dict:
    """Kernel vs plain on the same inputs (a tensor or a tuple of tensors each);
    raises past the tolerance, per tensor: max |diff| <= KERNEL_TOL x
    max(1, max|plain|), or with ``grad_rtol`` relative L2 error <= grad_rtol.
    ``work`` = (FLOPs, bytes) of the call gives its bound: the larger of the
    FLOPs at PEAK_FP32_FLOPS and the bytes (each input read once, each output
    written once) at PEAK_HBM_BYTES."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, (tuple, list)) else [(got, want)]
    err = worst = 0.0
    for i, (g, w) in enumerate(pairs):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name} {shape}: non-finite output {i}")
        e = float((g - w).abs().max())
        if grad_rtol is None:
            ratio = e / (KERNEL_TOL * max(1.0, float(w.abs().max())))
        else:
            ratio = float(torch.linalg.vector_norm(g - w)
                          / torch.linalg.vector_norm(w).clamp_min(1e-30)) / grad_rtol
        if not ratio <= 1.0:
            raise RuntimeError(f"{name} {shape}: output {i} of {len(pairs)} off by {ratio:.3g} "
                               f"times the tolerance (max|diff| {e})")
        err, worst = max(err, e), max(worst, ratio)
    ms, plain_ms = (median_ms(kernel), median_ms(plain)) if timed else (None, None)
    times = f"kernel {ms:.3f} ms  plain {plain_ms:.3f} ms" if timed else "(not timed)"
    result = {"shape": shape, "max_abs_err": err, "err_over_tol": worst, "ms": ms,
              "plain_ms": plain_ms, "library_ms": None}
    if timed and work is not None:
        ops_ms, bytes_ms = (1e3 * work[0] / PEAK_FP32_FLOPS, 1e3 * work[1] / PEAK_HBM_BYTES)
        result.update(flops=work[0], bytes=work[1], ops_ms=ops_ms, bytes_ms=bytes_ms,
                      bound_ms=max(ops_ms, bytes_ms),
                      bound_by="operations" if ops_ms >= bytes_ms else "bytes")
        times += (f"  bound {result['bound_ms']:.4f} ms ({result['bound_by']})"
                  "  library: none (no one PyTorch call computes it)")
    print(f"  {name:24s} {shape:34s} max|diff| {err:.3e} ({worst:.3g} of tol)  {times}",
          flush=True)
    return result


def kernels_vs_plain(params: dict, config, device) -> dict:
    """Phase 3 at the shapes of one 128-token request (F = 320 frames)."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_reference
    from vits_tpu_torch.ops.cuda.resblock import (
        fused_resblock_trio,
        pair_weights,
        resblock_trio_reference,
    )

    rng = np.random.default_rng(0)
    decoder = ParamView(params).sub("decoder")
    slope = config.leaky_relu_slope
    frames = 320

    def activ(T, C, length):
        x = torch.tensor(rng.standard_normal((1, T, C)), dtype=torch.float32, device=device)
        x[:, length:] = 0.0
        return x, torch.tensor([length], dtype=torch.int32, device=device)

    results = {"fused_resblock_trio": [], "fused_stage": [], "flash_rel_attention": []}
    # B: MMS stages 0 and 1 (C = 256 at 8F steps, C = 128 at 64F steps)
    for i, T in ((0, 8 * frames), (1, 64 * frames)):
        C = decoder[f"upsampler.{i}.weight"].shape[2]
        x, lens = activ(T, C, T - 37)
        blocks = _stage_resblocks(decoder, config, i)
        results["fused_resblock_trio"].append(compare(
            "fused_resblock_trio", f"C={C} T={T}",
            lambda: fused_resblock_trio(x, blocks, slope=slope, lengths=lens),
            lambda: resblock_trio_reference(x, blocks, slope=slope, lengths=lens),
            work=(resblocks_flops(steps_of(x, lens), C, blocks),
                  nbytes(x, x, lens, *pair_weights(blocks)))))
    # C: MMS stage 2 (128->64) and terminal stage 3 (64->32 + conv_post)
    for i, T_in in ((2, 64 * frames), (3, 128 * frames)):
        results["fused_stage"].append(compare_stage(decoder, config, i, activ(
            T_in, decoder[f"upsampler.{i}.weight"].shape[1], T_in - 37)))
    # A: encoder attention, H=2, d=96, w=4; the second row is padding (length 0)
    layer = ParamView(params).sub("text_encoder.encoder.layers.0.attention")
    heads, d, w = config.num_attention_heads, config.head_dim, config.window_size
    for L in (128, 512):
        q, k, v = (torch.tensor(rng.standard_normal((2, heads, L, d)) * 0.5,
                                dtype=torch.float32, device=device) for _ in range(3))
        rel = (layer["emb_rel_k"][0], layer["emb_rel_v"][0])
        lens = torch.tensor([L - 5, 0], dtype=torch.int32, device=device)
        results["flash_rel_attention"].append(compare(
            "flash_rel_attention", f"B=2 H={heads} L={L} d={d} len=({L - 5},0)",
            lambda: flash_rel_attention(q, k, v, *rel, window=w, lengths=lens),
            lambda: rel_attention_reference(q, k, v, *rel, window=w, lengths=lens),
            work=(attention_flops((L - 5, 0), heads, d, w), nbytes(q, k, v, q, *rel, lens))))
    return results


def compare_stage(decoder, config, i: int, x_lens) -> dict:
    """Kernel C against its plain version on stage i of ``decoder``."""
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.resblock import pair_weights
    from vits_tpu_torch.ops.cuda.stage import fused_stage, stage_reference

    x, lens = x_lens
    up_w = decoder[f"upsampler.{i}.weight"]
    (k_up, c_in, c_out), rate = up_w.shape, config.upsample_rates[i]
    final = i == len(config.upsample_rates) - 1
    blocks = _stage_resblocks(decoder, config, i)
    kw = dict(stride=rate, up_padding=(config.upsample_kernel_sizes[i] - rate) // 2,
              slope=config.leaky_relu_slope, lengths=lens,
              final_conv=(decoder["conv_post.weight"], 3) if final else None)
    args = (x, up_w, decoder[f"upsampler.{i}.bias"], blocks)
    steps = steps_of(x, lens)
    flops = conv_flops(steps, k_up, c_in, c_out) + resblocks_flops(steps * rate, c_out, blocks)
    weights = [up_w, args[2], *pair_weights(blocks)]
    if final:
        flops += conv_flops(steps * rate, decoder["conv_post.weight"].shape[0], c_out, 1)
        weights.append(decoder["conv_post.weight"])
    out_bytes = 4 * x.shape[0] * x.shape[1] * rate * (1 if final else c_out)
    return compare("fused_stage", f"{c_in}->{c_out} B={x.shape[0]} T_in={x.shape[1]}"
                   + (" +conv_post" if final else ""),
                   lambda: fused_stage(*args, **kw), lambda: stage_reference(*args, **kw),
                   work=(flops, nbytes(x, lens, *weights) + out_bytes))


def slice_kernels_vs_plain(vctk, narrow, device) -> dict:
    """Phase 3, the multi-speaker and narrow-vocoder kernels at the shapes of 320
    frames: kernel 6 at VCTK width with per-row speakers (B=1 and B=3 with
    lengths 320, 137, 0 at 320 frames; B=8 at 640 and B=16 at 1280 frames,
    batches that fill the card), kernel 7
    on HiFi-GAN V2's stages 0-1 (C=64 at 8F steps, C=32 at 64F) and kernel C on its
    stages 2-3 (32->16, 16->8 + conv_post), each with a length-0 row."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.flow import flow_reference, fused_flow
    from vits_tpu_torch.ops.cuda.resblock import (
        fused_resblock,
        pair_weights,
        resblock_reference,
    )

    rng = np.random.default_rng(4)
    frames = 320
    results = {"fused_flow": [], "fused_resblock": [], "fused_stage": []}

    def activ(T, C, length):
        x = torch.tensor(rng.standard_normal((2, T, C)), dtype=torch.float32, device=device)
        x[0, length:] = 0.0
        x[1] = 0.0
        return x, torch.tensor([length, 0], dtype=torch.int32, device=device)

    # 6: the reverse flow at VCTK width, per-row speakers
    config, params = vctk.config, vctk.params
    p = ParamView(params)
    half, hidden = config.flow_size // 2, config.hidden_size
    nl, k, n = (config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size,
                config.prior_encoder_num_flows)
    per_frame = 2 * (half * hidden + nl * k * hidden * 2 * hidden
                     + (nl - 1) * hidden * 2 * hidden + hidden * hidden + hidden * half)
    flow_weights = [v for name, v in params.items() if name.startswith("flow.")]
    for T, lengths in ((frames, (frames,)), (frames, (frames, 137, 0)),
                       (2 * frames, (2 * frames,) * 8), (4 * frames, (4 * frames,) * 16)):
        B = len(lengths)
        x = torch.tensor(rng.standard_normal((B, T, config.flow_size)), dtype=torch.float32,
                         device=device)
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        x = x * (torch.arange(T, device=device)[None, :] < lens[:, None])[..., None]
        speakers = torch.arange(B, device=device) * 53 % config.num_speakers
        emb = params["embed_speaker.weight"][speakers][:, None]
        kw = dict(lengths=lens, speaker_embeddings=emb)
        kernel = lambda: fused_flow(x, p, config, **kw)  # noqa: E731
        plain = lambda: flow_reference(x, p, config, **kw)  # noqa: E731
        results["fused_flow"].append(compare(
            "fused_flow", f"B={B} T={T} len={lengths[:3]} +speaker", kernel, plain,
            work=(n * per_frame * sum(lengths), nbytes(x, x, lens, emb, *flow_weights))))
        if B == 1:  # a single request's flow: bound by the host's enqueue or the device?
            split = {"kernel": host_and_device(kernel), "plain": host_and_device(plain)}
            results["fused_flow"][-1]["host_device"] = split
            print("  fused_flow B=1 host vs device: " + "; ".join(
                f"{name} enqueue {v['enqueue_ms']:.3f} ms/call, {v['device_ops']} device ops "
                f"busy {v['device_busy_ms']:.3f} ms" for name, v in split.items()), flush=True)

    # 7 and C at HiFi-GAN V2's stages
    config = narrow.config
    decoder = ParamView(narrow.params).sub("decoder")
    slope = config.leaky_relu_slope
    for i, T in ((0, 8 * frames), (1, 64 * frames)):
        x, lens = activ(T, decoder[f"upsampler.{i}.weight"].shape[2], T - 37)
        C = x.shape[-1]
        for j, blk in enumerate(_stage_resblocks(decoder, config, i)):
            results["fused_resblock"].append(compare(
                "fused_resblock", f"C={C} B=2 T={T} k={blk['kernel_size']} len=({T - 37},0)",
                lambda: fused_resblock(x, blk, slope=slope, lengths=lens),
                lambda: resblock_reference(x, blk, slope=slope, lengths=lens),
                work=(resblocks_flops(steps_of(x, lens), C, [blk]),
                      nbytes(x, x, lens, *pair_weights([blk])))))
    for i, T_in in ((2, 64 * frames), (3, 128 * frames)):
        results["fused_stage"].append(compare_stage(decoder, config, i, activ(
            T_in, decoder[f"upsampler.{i}.weight"].shape[1], T_in - 37)))
    return results


def training_kernels_vs_plain(params: dict, config, device) -> dict:
    """Phase 3, training kernels: kernel A's lse and kernel 4 at B=2, L=512 (lengths
    507 and 0), kernel 5 at the decoded-segment shapes of 32 frames, batch 4."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_reference
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )
    from vits_tpu_torch.ops.cuda.resblock import pair_weights
    from vits_tpu_torch.ops.cuda.trio_grad import (
        flat_acts,
        trainable_trio,
        trio_backward,
        trio_forward_with_acts,
        trio_forward_with_acts_reference,
    )

    rng = np.random.default_rng(2)
    results = {"flash_rel_attention": [], "trainable_rel_attention": [], "trainable_trio": []}
    layer = ParamView(params).sub("text_encoder.encoder.layers.0.attention")
    heads, d, w, L = config.num_attention_heads, config.head_dim, config.window_size, 512
    q, k, v, dout = (torch.tensor(rng.standard_normal((2, heads, L, d)) * 0.5,
                                  dtype=torch.float32, device=device) for _ in range(4))
    rel = (layer["emb_rel_k"][0], layer["emb_rel_v"][0])
    lens = torch.tensor([L - 5, 0], dtype=torch.int32, device=device)
    shape = f"B=2 H={heads} L={L} d={d} len=({L - 5},0)"
    out, lse = flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True)
    if not bool(torch.isfinite(lse).all()):
        raise RuntimeError("kernel A: non-finite lse (a length-0 row must stay finite)")
    results["flash_rel_attention"].append(compare(
        "flash_rel_attention+lse", shape + " lse row 0",
        lambda: flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True)[1][0],
        lambda: rel_attention_reference(q, k, v, *rel, window=w, lengths=lens,
                                        return_lse=True)[1][0],
        work=(attention_flops((L - 5, 0), heads, d, w), nbytes(q, k, v, out, lse, *rel, lens))))

    def valid(grads):  # row 0 up to its length, the length-0 row whole, the rel tables
        return (*(g[0, :, :L - 5] for g in grads[:3]), *(g[1] for g in grads[:3]), *grads[3:])
    args = (q, k, v, *rel, lse, dout, out)
    results["trainable_rel_attention"].append(compare(
        "rel_attention_bwd", shape + " valid region",
        lambda: valid(rel_attention_bwd(*args, window=w, lengths=lens)),
        lambda: valid(rel_attention_bwd_reference(*args, window=w, lengths=lens)),
        work=(attention_flops((L - 5, 0), heads, d, w, backward=True),
              nbytes(*args, lens, q, k, v, *rel))))

    decoder = ParamView(params).sub("decoder")
    slope = config.leaky_relu_slope
    for i, T in ((0, 256), (1, 2048)):
        blocks = [{**blk, **{n: [t.detach().clone().requires_grad_() for t in blk[n]]
                             for n in ("w1", "b1", "w2", "b2")}}
                  for blk in _stage_resblocks(decoder, config, i)]
        C = blocks[0]["w1"][0].shape[-1]
        x = torch.tensor(rng.standard_normal((4, T, C)), dtype=torch.float32, device=device)
        g = torch.tensor(rng.standard_normal((4, T, C)), dtype=torch.float32, device=device)
        shape = f"B=4 C={C} T={T}"

        def flat(out_acts):
            return (out_acts[0], *flat_acts(out_acts[1]))

        fwd_flops = resblocks_flops(steps_of(x, None), C, blocks)
        n_acts = sum(2 * len(blk["dilations"]) - 1 for blk in blocks)
        with torch.no_grad():
            results["trainable_trio"].append(compare(
                "trio_forward_with_acts", shape + " out+acts",
                lambda: flat(trio_forward_with_acts(x, blocks, slope=slope)),
                lambda: flat(trio_forward_with_acts_reference(x, blocks, slope=slope)),
                work=(fwd_flops, nbytes(x, *pair_weights(blocks)) + nbytes(x) * (1 + n_acts))))
            kernel_acts = flat_acts(trio_forward_with_acts(x, blocks, slope=slope)[1])
            plain_acts = flat_acts(trio_forward_with_acts_reference(x, blocks, slope=slope)[1])
            flips = sum(int(((a >= 0) != (b >= 0)).sum()) for a, b in zip(kernel_acts, plain_acts))
        print(f"  saved activations of opposite sign, kernel vs plain: {flips} of "
              f"{sum(a.numel() for a in plain_acts)}", flush=True)
        xg = x.clone().requires_grad_()
        leaves = [xg, *pair_weights(blocks)]

        def plain_grads():
            out = trio_forward_with_acts_reference(xg, blocks, slope=slope)[0]
            return torch.autograd.grad((out * g).sum(), leaves)

        def backward_on_plain_acts():
            with torch.no_grad():
                dx, dweights = trio_backward(g, x, blocks, plain_acts, slope=slope)
            return (dx, *dweights)

        # the backward alone, on the activations plain autograd saves itself
        results["trainable_trio"].append(compare(
            "trio_backward", shape + " grads on plain acts", backward_on_plain_acts,
            plain_grads, grad_rtol=GRAD_RTOL, timed=False))
        results["trainable_trio"].append(compare(
            "trainable_trio fwd+bwd", shape + " grads",
            lambda: torch.autograd.grad((trainable_trio(xg, blocks, slope=slope) * g).sum(),
                                        leaves),
            plain_grads, grad_rtol=FLIP_GRAD_RTOL if flips else GRAD_RTOL,
            work=(3 * fwd_flops, 2 * nbytes(*leaves) + nbytes(g))))
    return results


def make_model(device, config=None, engine_config=None, keep_training: bool = False):
    """A model with random weights (seed 0), loaded as a user would: MMS-TTS at full
    width unless ``config`` says otherwise."""
    import vits_tpu_torch
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml, random_params

    config = config or VitsConfig()
    params = random_params(config, seed=0, keep_training=keep_training)
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(VOCAB)},
                              pad_token="k", unk_token="z")
    checkpoint = io.BytesIO()
    export_to_ggml(checkpoint, config, tokenizer, params, fp16_convs=False)
    return vits_tpu_torch.load_model(checkpoint.getvalue(), engine_config, device=device)


def check_audio(audio: np.ndarray, what: str) -> None:
    if audio.size == 0:
        raise RuntimeError(f"{what}: empty audio")
    if not np.isfinite(audio).all() or np.abs(audio).max() > 1.0:
        raise RuntimeError(f"{what}: audio not finite or outside [-1, 1]")


def run_slice(model, card: str, wrappers, single_speakers=None, batch_speakers=None) -> dict:
    """Phases 4-5: the requests, with the launch counts of ``wrappers`` over them."""
    rate = model.config.sampling_rate
    single_speakers = single_speakers or (None,) * len(SINGLE_TEXTS)

    t0 = time.perf_counter()
    check_audio(model.synthesize(SINGLE_TEXTS[0], seed=0, speaker_id=single_speakers[0]),
                "warm-up request")
    print(f"  warm-up request: {1e3 * (time.perf_counter() - t0):.1f} ms wall "
          f"(first use of cuDNN/cuBLAS)", flush=True)

    for fn in wrappers:
        fn.launches = 0
    requests = [([text], [seed], None if spk is None else [spk]) for seed, (text, spk)
                in enumerate(zip(SINGLE_TEXTS, single_speakers), start=1)]
    requests.append((list(BATCH_TEXTS), list(BATCH_SEEDS), batch_speakers))
    batch_out = None
    for n, (texts, seeds, speakers) in enumerate(requests, start=1):
        tokens = [len(model.tokenizer.encode(t)) for t in texts]
        t0 = time.perf_counter()
        out = model.synthesize_raw(texts, seed=seeds, speaker_id=speakers)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        for i in range(len(texts)):
            check_audio(out.waveform[i, : out.lengths[i]], f"request {n} row {i}")
        audio_s = float(out.lengths.sum()) / rate
        capacity = out.waveform.shape[1] // model.config.total_upsample
        print(f"  request {n}: rows={len(texts)} tokens={tokens} speakers={speakers} "
              f"frames={out.frame_lengths.tolist()} capacity={capacity} "
              f"audio {audio_s:.3f} s  wall {wall_ms:.1f} ms  "
              f"xRT {audio_s / (wall_ms / 1e3):.1f}  ({card})", flush=True)
        batch_out = out
    launches = {fn.__name__: fn.launches for fn in wrappers}
    print(f"  launches over the requests: {launches}  stats: {model.stats}", flush=True)
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"kernel {name} was never launched on the main path")

    worst = 0.0
    batch_speakers = batch_speakers or (None,) * len(BATCH_TEXTS)
    for i, (text, seed, spk) in enumerate(zip(BATCH_TEXTS, BATCH_SEEDS, batch_speakers)):
        solo = model.synthesize_raw([text], seed=[seed], speaker_id=spk)
        if solo.frame_lengths[0] != batch_out.frame_lengths[i]:
            raise RuntimeError(f"batch row {i}: {batch_out.frame_lengths[i]} frames, "
                               f"solo run {solo.frame_lengths[0]}")
        n = solo.lengths[0]
        worst = max(worst, float(np.abs(batch_out.waveform[i, :n] - solo.waveform[0, :n]).max()))
        if np.abs(batch_out.waveform[i, n:]).max() != 0.0:
            raise RuntimeError(f"batch row {i}: audio past its length")
    print(f"  batch rows vs solo runs: equal frames, max|diff| {worst:.3e} "
          f"(atol {BATCH_ATOL})", flush=True)
    if not worst <= BATCH_ATOL:
        raise RuntimeError(f"batch rows differ from solo runs by {worst}")

    speakers = None if batch_speakers[0] is None else list(batch_speakers)
    again = model.synthesize(list(BATCH_TEXTS), seed=list(BATCH_SEEDS), speaker_id=speakers)
    for i, audio in enumerate(again):
        if not np.array_equal(audio, batch_out.waveform[i, : batch_out.lengths[i]]):
            raise RuntimeError(f"repeated seed {BATCH_SEEDS[i]} gave different audio")
    print("  repeated seeds: identical audio", flush=True)
    return launches


def check_close(what: str, gpu: dict, cpu: dict) -> None:
    """Card vs CPU plain path: equal frame counts (where there are any), latents
    within LATENT_RTOL of their scale, waveform within WAVE_ATOL."""
    lat_err = float(np.abs(gpu["latents"] - cpu["latents"]).max())
    lat_tol = LATENT_RTOL * float(np.abs(cpu["latents"]).max())
    wave_err = float(np.abs(gpu["waveform"] - cpu["waveform"]).max())
    frames = ""
    if "frame_lengths" in cpu:
        frames = f"frames {gpu['frame_lengths'].tolist()} / {cpu['frame_lengths'].tolist()}, "
    print(f"  card vs CPU plain path, {what}: {frames}latents max|diff| {lat_err:.3e} "
          f"(tol {lat_tol:.3e}), waveform max|diff| {wave_err:.3e} (atol {WAVE_ATOL})",
          flush=True)
    if "frame_lengths" in cpu and not np.array_equal(gpu["frame_lengths"], cpu["frame_lengths"]):
        raise RuntimeError(f"{what}: card and CPU predict different frame counts")
    if not (lat_err <= lat_tol and wave_err <= WAVE_ATOL):
        raise RuntimeError(f"{what}: card and CPU disagree past the tolerance")


def card_vs_cpu(model, speaker_id=None) -> None:
    """One dispatch on the card vs the same dispatch through the plain versions."""
    from vits_tpu_torch.models.vits import NoiseOverride, synthesize

    config = model.config
    encoded = [model.tokenizer.encode(t) for t in BATCH_TEXTS]
    ids, mask = model.tokenizer.pad(encoded, pad_to=64)
    num_frames = model.engine.frame_bucket(64)
    rng = np.random.default_rng(1)
    dur = rng.standard_normal((len(encoded), 64, 2)).astype(np.float32)
    prior = rng.standard_normal((len(encoded), num_frames, config.flow_size)).astype(np.float32)
    outs = {}
    for device, params in ((model.device, model.params),
                           ("cpu", {k: v.cpu() for k, v in model.params.items()})):
        with torch.inference_mode():
            out = synthesize(
                params, config, torch.tensor(ids, dtype=torch.long, device=device),
                torch.tensor(mask, dtype=torch.float32, device=device), num_frames,
                noise=NoiseOverride(torch.tensor(dur, device=device),
                                    torch.tensor(prior, device=device)),
                speaker_id=None if speaker_id is None else torch.tensor(speaker_id,
                                                                        device=device),
                use_pallas_flow=model.engine.use_pallas_flow)
        outs[device] = {k: getattr(out, k).cpu().numpy()
                        for k in ("waveform", "latents", "frame_lengths")}
    check_close(f"3 rows x {num_frames} frames" + ("" if speaker_id is None
                                                   else f", speakers {list(speaker_id)}"),
                outs[model.device], outs["cpu"])


def flow_on_off(model, card: str, reps: int = 4) -> dict:
    """ms per request with the flow kernel (use_pallas_flow) on and off, in turns."""
    times = {True: [], False: []}
    for flag in (True, False, False, True) * (reps // 2):
        model.engine = dataclasses.replace(model.engine, use_pallas_flow=flag)
        t0 = time.perf_counter()
        model.synthesize_raw([SINGLE_TEXTS[1]], seed=[5], speaker_id=[17])
        times[flag].append(1e3 * (time.perf_counter() - t0))
    model.engine = dataclasses.replace(model.engine, use_pallas_flow=True)
    medians = {("on" if k else "off"): float(np.median(v)) for k, v in times.items()}
    print(f"  one request ({len(model.tokenizer.encode(SINGLE_TEXTS[1]))} tokens, speaker 17), "
          f"median of {reps} each, flow kernel on {medians['on']:.1f} ms, off "
          f"{medians['off']:.1f} ms wall ({card}); all: {times}", flush=True)
    return medians


def voice_conversion(model, card: str) -> None:
    """Phase 5: an utterance of speaker 0 converted to speaker 17, card vs CPU."""
    from vits_tpu_torch.models.vits import voice_convert
    from vits_tpu_torch.train.data import linear_spectrogram

    hop = model.config.total_upsample
    audio = model.synthesize(SINGLE_TEXTS[1], seed=3, speaker_id=0)
    t0 = time.perf_counter()
    first = model.convert_voice(audio, source_speaker=0, target_speaker=17)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    again = model.convert_voice(audio, source_speaker=0, target_speaker=17)
    frames = len(audio) // hop
    check_audio(first, "voice conversion")
    if first.shape != (frames * hop,):
        raise RuntimeError(f"voice conversion: {first.shape} samples, want {frames} x {hop}")
    if not np.array_equal(first, again):
        raise RuntimeError("voice conversion at noise_scale=0 is not deterministic")
    print(f"  voice conversion 0 -> 17: {frames} frames, {wall_ms:.1f} ms wall, a second call "
          f"identical ({card})", flush=True)
    n_fft = 2 * (model.config.spectrogram_bins - 1)
    spec = linear_spectrogram(audio[: frames * hop], n_fft, hop)[None, :frames]
    outs = {}
    for device, params in ((model.device, model.params),
                           ("cpu", {k: v.cpu() for k, v in model.params.items()})):
        with torch.inference_mode():
            out = voice_convert(params, model.config, torch.tensor(spec, device=device),
                                torch.ones((1, frames), device=device),
                                torch.tensor([0], device=device),
                                torch.tensor([17], device=device))
        outs[device] = {k: getattr(out, k).cpu().numpy() for k in ("waveform", "latents")}
    check_close(f"voice conversion, {frames} frames", outs[model.device], outs["cpu"])


def training_batch(config, device, token_lengths=(512, 300), frame_lengths=(1280, 800)):
    """A seeded batch padded to 512 tokens (so kernels A-with-lse and 4 run) and 1280 frames."""
    from vits_tpu_torch.train.data import linear_spectrogram
    from vits_tpu_torch.train.step import TrainBatch, batch_to

    rng = np.random.default_rng(3)
    B, T, S, up = len(token_lengths), max(token_lengths), max(frame_lengths), config.total_upsample
    ids = np.zeros((B, T), np.int64)
    token_mask = np.zeros((B, T), np.float32)
    spec = np.zeros((B, S, config.spectrogram_bins), np.float32)
    frame_mask = np.zeros((B, S), np.float32)
    audio = np.zeros((B, S * up), np.float32)
    for b, (t, f) in enumerate(zip(token_lengths, frame_lengths)):
        ids[b, :t] = rng.integers(1, config.vocab_size, t)
        token_mask[b, :t] = 1.0
        audio[b, : f * up] = (rng.standard_normal(f * up) * 0.1).astype(np.float32)
        spec[b, :f] = linear_spectrogram(audio[b, : f * up], 2 * (config.spectrogram_bins - 1),
                                         up)[:f]
        frame_mask[b, :f] = 1.0
    return batch_to(TrainBatch(ids, token_mask, spec, frame_mask, audio), device)


def gan_steps(config, device, card: str) -> dict:
    """Phase 5a: three GAN steps at full MMS width; the launch counts over them."""
    from vits_tpu_torch.io import random_params
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage
    from vits_tpu_torch.ops.cuda.trio_grad import trio_forward_with_acts
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import make_gan_train_step

    gen = {k: v.requires_grad_() for k, v in
           from_jax_params(random_params(config, seed=0, keep_training=True), device).items()}
    disc = {k: v.requires_grad_() for k, v in
            from_jax_params(init_discriminator_params(0), device).items()}
    n_gen, n_disc = (sum(p.numel() for p in ps.values()) for ps in (gen, disc))
    step_fn = make_gan_train_step(config, gen, disc, vits_optimizer(gen), vits_optimizer(disc))
    batch = training_batch(config, device)
    before = {k: p.detach().clone() for k, p in {**gen, **disc}.items()}

    # the inference kernels refuse autograd (their output would carry no grad_fn)
    x = torch.zeros((1, 64, 256), device=device, requires_grad=True)
    blocks = [{"kernel_size": 3, "dilations": (1,), "w1": [gen["decoder.resblocks.0.convs1.0.weight"]],
               "b1": [gen["decoder.resblocks.0.convs1.0.bias"]],
               "w2": [gen["decoder.resblocks.0.convs2.0.weight"]],
               "b2": [gen["decoder.resblocks.0.convs2.0.bias"]]}]
    try:
        fused_resblock_trio(x, blocks, slope=config.leaky_relu_slope)
    except RuntimeError as err:
        if "no backward" not in str(err):
            raise
    else:
        raise RuntimeError("kernel B ran under autograd instead of refusing")
    print("  kernel B under autograd: refused (no backward), as it must", flush=True)

    torch.cuda.reset_peak_memory_stats()
    noise_gen = torch.Generator(device=device).manual_seed(0)
    t0 = time.perf_counter()
    step_fn(batch, noise_gen)
    torch.cuda.synchronize()
    print(f"  warm-up GAN step: {1e3 * (time.perf_counter() - t0):.1f} ms (first use of "
          "cuDNN/cuBLAS at these shapes)", flush=True)

    wrappers = (flash_rel_attention, rel_attention_bwd, trio_forward_with_acts,
                fused_resblock_trio, fused_stage)
    for fn in wrappers:
        fn.launches = 0
    flash_rel_attention.lse_launches = 0
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        metrics = step_fn(batch, noise_gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        values = {k: float(v) for k, v in metrics._asdict().items()}
        print(f"  GAN step {i + 1}: {times[-1]:.1f} ms  "
              + " ".join(f"{k}={v:.4g}" for k, v in values.items()), flush=True)
        if not all(np.isfinite(v) for v in values.values()):
            raise RuntimeError(f"GAN step {i + 1}: non-finite loss {values}")
    launches = {fn.__name__: fn.launches for fn in wrappers}
    launches["flash_rel_attention_lse"] = flash_rel_attention.lse_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"  launches over the 3 steps: {launches}", flush=True)
    print(f"  median {float(np.median(times)):.1f} ms per step after the warm-up (B=2, 512 "
          f"tokens, 1280 frames, {n_gen / 1e6:.1f} M generator + {n_disc / 1e6:.1f} M "
          f"discriminator parameters), peak {peak_gib:.2f} GiB allocated ({card})", flush=True)
    for name in ("flash_rel_attention_lse", "rel_attention_bwd", "trio_forward_with_acts"):
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was never launched on the training path")
    for name in ("fused_resblock_trio", "fused_stage"):
        if launches[name]:
            raise RuntimeError(f"inference kernel {name} launched on the training path")
    if launches["flash_rel_attention"] != launches["flash_rel_attention_lse"]:
        raise RuntimeError("kernel A launched without lse on the training path")
    for name, p in {**gen, **disc}.items():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise RuntimeError(f"parameter {name}: no finite gradient")
        if torch.equal(p.detach(), before[name]):
            raise RuntimeError(f"parameter {name} did not move in 3 steps")
    print(f"  all {len(gen)} generator and {len(disc)} discriminator parameters have finite "
          "gradients and moved", flush=True)
    profile = profile_step(step_fn, batch, noise_gen, float(np.median(times)), card)
    initial = {k: before[k].requires_grad_() for k in gen}
    return {"launches": launches, "step_ms": times, "peak_gib": peak_gib, "gen": initial,
            "batch": batch, "profile": profile}


# Call sites of one GAN step, names in ``vits_tpu_torch.train.step``.
STEP_SITES = ("text_encoder", "posterior_encoder", "residual_coupling_forward",
              "prior_log_likelihood", "monotonic_align", "stochastic_duration_predictor_nll",
              "hifigan", "log_mel_spectrogram", "discriminate", "gradients", "_apply")
# Device kernel families, by the first pattern their name contains.
KERNEL_FAMILIES = (
    ("port kernels A, 4, 5", ("rel_attention_kernel", "dq_kernel", "dkv_kernel",
                              "conv_kernel<")),
    ("elementwise", ("elementwise",)),
    ("reductions", ("reduce",)),
    ("FFT", ("fft",)),
    ("cuDNN convolutions", ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm", "conv")),
    ("matmul (cuBLAS)", ("gemm", "cutlass")),
)


def profiled(fn) -> tuple[float, list, float]:
    """One call of ``fn`` under ``torch.profiler``: its wall ms (host clock to a
    synchronise), its device events (kernels, memcpy, memset) and the device
    busy ms (the union of their intervals)."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            events = json.load(f)["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        raise RuntimeError("the profiler saw no device activity")
    busy_ms, end = 0.0, -np.inf
    for e in sorted(device, key=lambda e: e["ts"]):  # union of the intervals, in us
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy_ms += max(0.0, stop - max(start, end)) / 1e3
        end = max(end, stop)
    return wall_ms, device, busy_ms


def host_and_device(fn, calls: int = 5) -> dict:
    """Host ms to enqueue one call of ``fn`` (the mean over ``calls`` with no
    synchronisation between them), and its device operations and busy ms from
    one profiled call: which of the two bounds the call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    _, device, busy_ms = profiled(fn)
    return {"enqueue_ms": enqueue_ms, "device_ops": len(device), "device_busy_ms": busy_ms}


def profile_step(step_fn, batch, noise_gen, steady_ms: float, card: str) -> dict:
    """Phase 5: where one GAN step's time goes.

    One step with a synchronisation before and after each call site of the
    step, timed on the host clock. Then one step under ``torch.profiler``:
    device busy time (the union of its kernel, memcpy and memset intervals),
    launches and device ms per kernel family, and the device idle share of the
    steady step (1 - busy / median ms).
    """
    from vits_tpu_torch.train import step as step_module

    spent = dict.fromkeys(STEP_SITES, 0.0)
    originals = {name: getattr(step_module, name) for name in STEP_SITES}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent[name] += 1e3 * (time.perf_counter() - start)
            return out
        return call

    try:
        for name, fn in originals.items():
            setattr(step_module, name, timed(name, fn))
        t0 = time.perf_counter()
        step_fn(batch, noise_gen)
        torch.cuda.synchronize()
        sites_wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for name, fn in originals.items():
            setattr(step_module, name, fn)
    print(f"  call sites of one GAN step, each between synchronisations ({sites_wall_ms:.1f} ms "
          f"wall; {card}):", flush=True)
    for name, ms in sorted(spent.items(), key=lambda kv: -kv[1]):
        print(f"    {name:34s} {ms:8.2f} ms", flush=True)

    wall_ms, device, busy_ms = profiled(lambda: step_fn(batch, noise_gen))
    families: dict[str, list] = {}
    for e in device:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        family = next((fam for fam, keys in KERNEL_FAMILIES if any(k in name for k in keys)),
                      "memcpy/memset" if e["cat"] != "kernel" else "other")
        entry = families.setdefault(family, [0.0, 0])
        entry[0] += e["dur"] / 1e3
        entry[1] += 1
    idle = 1.0 - busy_ms / steady_ms
    print(f"  profiled GAN step: {wall_ms:.1f} ms wall under the profiler, {len(device)} device "
          f"operations, device busy {busy_ms:.1f} ms, idle share of the {steady_ms:.1f} ms "
          f"steady step {idle:.3f} ({card})", flush=True)
    for family, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {family:24s} {ms:8.2f} ms  {n:6d} launches", flush=True)
    return {"sites_ms": spent, "sites_wall_ms": sites_wall_ms, "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": idle, "device_ops": len(device),
            "families_ms": {k: v[0] for k, v in families.items()}}


def train_card_vs_cpu(config, gen: dict, batch) -> None:
    """Phase 5b: one generator_loss and its gradients on the card vs the plain CPU path.

    ``gen`` are the weights the GAN steps started from: the weights after the
    steps differ between runs (cuDNN's backward is not bit-reproducible), and
    so would the bounds.
    """
    from vits_tpu_torch.train.step import (
        TrainBatch,
        TrainNoise,
        draw_noise,
        generator_forward,
        gradients,
    )

    noise = draw_noise(config, batch,
                       torch.Generator(device=batch.input_ids.device).manual_seed(1))

    def run(params, batch, noise):
        out = generator_forward(params, config, batch, noise)
        return out, [g.detach().cpu() for g in gradients(out.loss, params)]

    card_out, card_g = run(gen, batch, noise)
    cpu = lambda t: None if t is None else t.detach().cpu()  # noqa: E731
    cpu_batch, cpu_noise = TrainBatch(*map(cpu, batch)), TrainNoise(*map(cpu, noise))
    rng = torch.Generator().manual_seed(2)
    runs = []
    # the CPU result, then its noise floor: every weight moved by 1e-7, FLOOR_SAMPLES times
    for rel in (0.0,) + (1e-7,) * FLOOR_SAMPLES:
        params = {k: (p.detach().cpu() * (1 + rel * torch.randn(p.shape, generator=rng)))
                  .requires_grad_() for k, p in gen.items()}
        t0 = time.perf_counter()
        runs.append(run(params, cpu_batch, cpu_noise))
        print(f"  CPU generator_loss + gradients: {time.perf_counter() - t0:.1f} s", flush=True)
    (cpu_out, cpu_g), perts = runs[0], runs[1:]
    if not torch.equal(card_out.durations.cpu(), cpu_out.durations):
        raise RuntimeError("card and CPU MAS durations differ")
    if not all(torch.equal(out.durations, cpu_out.durations) for out, _ in perts):
        raise RuntimeError("a 1e-7 weight perturbation changed the CPU MAS durations")
    for name in cpu_out.metrics._fields:
        c, g = (float(getattr(o.metrics, name).detach()) for o in (cpu_out, card_out))
        floor = max(abs(float(getattr(o.metrics, name).detach()) - c) for o, _ in perts)
        bound = 10 * floor + 1e-6 * max(1.0, abs(c))
        print(f"  {name}: card {g:.7g}  CPU {c:.7g}  |diff| {abs(g - c):.3e}  "
              f"(noise floor {floor:.3e}, bound {bound:.3e})", flush=True)
        if not abs(g - c) <= bound:
            raise RuntimeError(f"card and CPU {name} differ past the bound")
    # Relative L2 error of the card's gradients against the CPU's, beside the
    # same measure of the CPU's noise floor: per module (all its tensors) within
    # 10x the module's floor, and per tensor within TENSOR_FLOOR_FACTOR x the
    # larger of its own and its module's floor (a tensor's floor is a noisy
    # estimate, and the worst of ~700 tensors reached 6.6x a one-sample floor on
    # an H100; a wrong or missing tensor is off by ~1, far past that bound).
    # A tensor whose own floor passes NOISY_GRAD is rounding noise (the
    # attention key biases: their exact gradient is 0, softmax being shift-
    # invariant), and is held in its module's units against the module's bound.
    def rel(a, b, scale):
        return float(torch.linalg.vector_norm(a - b)) / scale

    groups: dict[str, list] = {}
    for i, name in enumerate(gen):
        groups.setdefault(name.split(".")[0], []).append(
            (name, card_g[i], cpu_g[i], [grads[i] for _, grads in perts]))
    for module, items in groups.items():
        g, c = (torch.cat([t[i].flatten() for t in items]) for i in (1, 2))
        norm = float(torch.linalg.vector_norm(c))
        err = rel(g, c, norm)
        floor = max(rel(torch.cat([t[3][j].flatten() for t in items]), c, norm)
                    for j in range(FLOOR_SAMPLES))
        bound = 10 * floor + 1e-6
        worst, worst_name, noisy = 0.0, items[0][0], []
        for name, tg, tc, tps in items:
            scale = float(torch.linalg.vector_norm(tc)) or norm
            t_floor = max(rel(tp, tc, scale) for tp in tps)
            if t_floor > NOISY_GRAD:
                noisy.append(name)
                t_err, t_bound = rel(tg, tc, norm), bound
            else:
                t_err = rel(tg, tc, scale)
                t_bound = TENSOR_FLOOR_FACTOR * max(t_floor, floor) + 1e-6
            if not t_err <= t_bound:
                raise RuntimeError(f"card and CPU gradients of {name} differ: relative L2 "
                                   f"{t_err:.3e} > {t_bound:.3e}")
            if t_err / t_bound > worst:
                worst, worst_name = t_err / t_bound, name
        print(f"  gradients of {module} ({len(items)} tensors): card vs CPU relative L2 "
              f"{err:.3e}, max|diff| {float((g - c).abs().max()):.3e} of max "
              f"{float(c.abs().max()):.3e} (noise floor {floor:.3e}, bound {bound:.3e}); "
              f"worst tensor {worst_name} at {worst:.3f} of its bound; rounding noise on the "
              f"CPU: {noisy or 'none'}", flush=True)
        if not err <= bound:
            raise RuntimeError(f"card and CPU gradients of {module} differ past the bound")
    print(f"  card vs CPU: equal MAS durations ({int(cpu_out.durations.sum())} frames), "
          "losses and gradients within bounds", flush=True)


def train_loop(card: str) -> None:
    """Phase 5c: ``train()`` on a synthetic micro-corpus, checkpoints, then a resume."""
    import tempfile

    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml, random_params
    from vits_tpu_torch.train.data import corpus_vocab, generate_micro_corpus
    from vits_tpu_torch.train.loop import train

    config = VitsConfig()
    with tempfile.TemporaryDirectory() as tmp:
        corpus, model, out_dir = f"{tmp}/corpus", f"{tmp}/model.ggml", f"{tmp}/run"
        generate_micro_corpus(corpus, n_utts=16)
        tokenizer = VitsTokenizer(vocab=corpus_vocab(), pad_token="_", unk_token="?")
        export_to_ggml(model, config, tokenizer, random_params(config, seed=0,
                                                               keep_training=True),
                       fp16_convs=False)
        for steps in (4, 6):
            logs, rates = [], []
            t0 = time.perf_counter()
            gen = train(corpus, model, out_dir, steps=steps, batch_size=4, checkpoint_every=2,
                        log_every=1, log=logs.append, device="cuda",
                        metrics_hook=lambda step, values, rate: rates.append(rate))
            torch.cuda.synchronize()
            for line in logs:
                print(f"    {line}", flush=True)
            if not all(bool(torch.isfinite(p).all()) for p in gen.values()):
                raise RuntimeError("train(): non-finite parameters")
            print(f"  train(steps={steps}): {time.perf_counter() - t0:.1f} s wall, median "
                  f"{float(np.median(rates)):.2f} it/s ({card})", flush=True)
        expected = ("resumed from step 4", "restored EMA weights", "checkpointed step 6")
        if not all(e in logs for e in expected):
            raise RuntimeError(f"resume to step 6 did not run as expected: {logs}")


def narrow_vocoder(model, card: str, wrappers) -> dict:
    """Phase 6: one request through HiFi-GAN V2's decoder (kernels 7 and C at 16, 8)."""
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio

    check_audio(model.synthesize(SINGLE_TEXTS[0], seed=0), "warm-up request")
    for fn in (*wrappers, fused_resblock_trio):
        fn.launches = 0
    t0 = time.perf_counter()
    out = model.synthesize_raw([SINGLE_TEXTS[1]], seed=[4])
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    check_audio(out.waveform[0, : out.lengths[0]], "narrow-vocoder request")
    print(f"  request: frames={out.frame_lengths.tolist()} {wall_ms:.1f} ms wall, launches "
          f"{launches}, kernel B {fused_resblock_trio.launches} ({card})", flush=True)
    if any(count == 0 for count in launches.values()) or fused_resblock_trio.launches:
        raise RuntimeError("the narrow vocoder did not run kernels 7 and C (and not B)")
    card_vs_cpu(model)
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    device = torch.device("cuda")
    card = card_line()
    print("[1/7] card (nvidia-smi name, power limit):", flush=True)
    print(card, flush=True)
    print(f"      torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    from vits_tpu_torch import EngineConfig, VitsConfig
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.flow import fused_flow
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage

    t0 = time.perf_counter()
    kernels.library()
    print(f"[2/7] build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds:.1f} s) "
          f"-> {kernels.library_path().name}", flush=True)

    t0 = time.perf_counter()
    model = make_model(device)
    # the published VCTK VITS (jaywalnut310/vits configs/vctk_base.json), random weights
    # with the posterior encoder for voice conversion
    vctk = make_model(device, VitsConfig(num_speakers=109, speaker_embedding_size=256,
                                         sampling_rate=22050),
                      EngineConfig(use_pallas_flow=True), keep_training=True)
    # MMS-TTS's text side with HiFi-GAN V2's decoder (jik876/hifi-gan config_v2.json)
    narrow = make_model(device, VitsConfig(upsample_initial_channel=128))
    print(f"      models (MMS, VCTK, HiFi-GAN V2 decoder) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 must be off on the main path")
    print(f"[3/7] kernels vs plain on the card ({card}), tolerance "
          f"{KERNEL_TOL} x max(1, max|plain|) per output:", flush=True)
    measured = kernels_vs_plain(model.params, model.config, device)
    for runs in (training_kernels_vs_plain(model.params, model.config, device),
                 slice_kernels_vs_plain(vctk, narrow, device)):
        for name, shapes in runs.items():
            measured.setdefault(name, []).extend(shapes)

    print(f"[4/7] the slice at MMS-TTS width, random weights ({card}):", flush=True)
    paths = {"mms": run_slice(model, card, (flash_rel_attention, fused_resblock_trio,
                                            fused_stage))}
    card_vs_cpu(model)

    print(f"[5/7] multi-speaker serving at VCTK width, use_pallas_flow=True ({card}):",
          flush=True)
    paths["vctk"] = run_slice(vctk, card, (flash_rel_attention, fused_resblock_trio,
                                           fused_stage, fused_flow),
                              SINGLE_SPEAKERS, BATCH_SPEAKERS)
    a, b = (vctk.synthesize(SINGLE_TEXTS[0], seed=1, speaker_id=s) for s in (0, 17))
    if a.shape == b.shape and np.allclose(a, b):
        raise RuntimeError("speakers 0 and 17 gave the same audio")
    print("  speakers 0 and 17 on the same text and seed: different audio", flush=True)
    card_vs_cpu(vctk, speaker_id=BATCH_SPEAKERS)
    flow_ms = flow_on_off(vctk, card)
    voice_conversion(vctk, card)

    print(f"[6/7] narrow vocoder: HiFi-GAN V2 decoder at upsample_initial_channel=128 "
          f"({card}):", flush=True)
    paths["narrow"] = narrow_vocoder(narrow, card, (flash_rel_attention, fused_resblock,
                                                    fused_stage))

    print(f"[7/7] training at MMS-TTS width, random weights ({card}):", flush=True)
    config = model.config
    del model, vctk, narrow
    trained = gan_steps(config, device, card)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 must be off on the training path")
    train_card_vs_cpu(config, trained["gen"], trained["batch"])
    del trained["gen"], trained["batch"]
    train_loop(card)

    train_launches = trained["launches"]
    serving = {name: sum(path.get(name, 0) for path in paths.values())
               for name in ("flash_rel_attention", "fused_resblock_trio", "fused_stage",
                            "fused_flow", "fused_resblock")}
    sources = {
        "flash_rel_attention": ("vits_tpu_torch/csrc/rel_attention.cu",
                                "vits_tpu/ops/pallas/attention.py:97"),
        "fused_resblock_trio": ("vits_tpu_torch/csrc/resblock_trio.cu",
                                "vits_tpu/ops/pallas/resblock.py:238"),
        "fused_stage": ("vits_tpu_torch/csrc/stage.cu", "vits_tpu/ops/pallas/stage.py:379"),
        "trainable_rel_attention": ("vits_tpu_torch/csrc/rel_attention_bwd.cu",
                                    "vits_tpu/ops/pallas/attention_grad.py:262"),
        "trainable_trio": ("vits_tpu_torch/csrc/resblock_trio.cu",
                           "vits_tpu/ops/pallas/trio_grad.py:183"),
        "fused_flow": ("vits_tpu_torch/csrc/flow.cu", "vits_tpu/ops/pallas/flow.py:230"),
        "fused_resblock": ("vits_tpu_torch/csrc/resblock_trio.cu",
                           "vits_tpu/ops/pallas/resblock.py:629"),
    }
    launches = {**serving, "trainable_rel_attention": train_launches["rel_attention_bwd"],
                "trainable_trio": train_launches["trio_forward_with_acts"]}
    report = {"kernels": []}
    for name, runs in measured.items():
        timed = [r for r in runs if r["ms"] is not None]
        ops_ms, bytes_ms = (sum(r[k] for r in timed) for k in ("ops_ms", "bytes_ms"))
        report["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": sources[name][0],
            "replaces": sources[name][1],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in runs),
            "ms": sum(r["ms"] for r in timed),
            "plain_ms": sum(r["plain_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "launches_by_path": {path: counts.get(name) for path, counts in paths.items()},
            "shapes": runs,
        })
    for entry in report["kernels"]:
        if entry["name"] == "flash_rel_attention":
            entry["lse_launches_training"] = train_launches["flash_rel_attention_lse"]
    report["serving"] = {"flow_kernel_on_off_ms": flow_ms, "card": card}
    report["training"] = {"step_ms": trained["step_ms"], "peak_gib": trained["peak_gib"],
                          "profile": trained["profile"], "card": card}
    print(card, flush=True)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
