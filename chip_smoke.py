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
   ms of both (CUDA events), the device ms of both (the profiler's busy time
   per call: what the kernels take, where the event ms of a short call is the
   host's) and the kernel's bound (the larger of its FLOPs at 165 TFLOP/s, the
   fp32-accurate 3xTF32 tensor-core rate, and its bytes at 3.35 TB/s, from
   this run's shapes and valid lengths). Serving kernels A, B, C at the
   shapes of a 128-token MMS request (320 frames), each kernel C row with its
   device ms split by launch (upsample, resblock convs, conv_post) beside the
   device ms of cuDNN's ``F.conv_transpose1d`` and ``F.conv1d`` for the same
   upsampler and conv_post (a yardstick for that launch; the port never calls
   them); training kernels: A's logsumexp and the attention backward (kernel 4)
   at B=2, L=512, lengths (507, 0), kernel 4 also at lengths (512, 300) (the
   training batch of phase 7), and the trainable
   trio (kernel 5: output and saved activations; its backward alone on the
   plain forward's activations, against plain autograd and, timed, against
   its plain twin ``trio_backward_reference``; forward and backward together, with the
   count of saved activations the two forwards round to opposite signs) at
   the decoded-segment shapes of a 32-frame segment, batch 4; kernel 6 (the
   reverse flow) at VCTK width with speaker conditioning, at B=1 and at B=3
   with lengths (320, 137, 0) for T=320, and at B=8, T=640 and B=16,
   T=1280, with the B=1 call's host enqueue ms and its device busy ms under
   ``torch.profiler``, kernel and plain (the kernel on weights packed once, as
   the engine keeps them); kernel 7 (one resblock, one launch: the profiler
   must see one device operation a call) at the shapes of HiFi-GAN V2's stages
   0-1 for 320 frames, beside the six-launch route it replaced (B's conv twice
   per pair, ``run_pairs``) timed in the same call, and once at kernel C's MMS
   resblock shape (C=64, T=40960, B=1, k=11) as a probe; kernel C at C_out 16
   and 8 at HiFi-GAN V2's stages 2-3;
4. serving: ``vits_tpu_torch.load_model`` of a full-width MMS-TTS model
   (``VitsConfig()``, random weights from ``vits_tpu_torch.io.random_params``,
   seed 0) on ``cuda``; ``Synthesizer.warmup`` (every token bucket at batch 1
   and 3, per-row seeds, one re-dispatch rung: its seconds), three single
   requests (the first one's wall ms beside its steady median), then one
   batch of three texts with per-row seeds. Audio is finite, in [-1, 1], of
   positive length; every kernel's launch count rose during those requests;
   each batch row equals its solo run; a repeated seed gives identical audio;
   the batch through ``batch_buckets=(1, 4)`` dispatches only bucket sizes and
   its rows equal their solo runs; one dispatch on the card agrees with the
   same dispatch through the plain versions on the CPU, given the same noise;
   and one request of the second text under ``torch.profiler``: device busy
   ms, idle share, device ms of the resblock convs (kernels B, C) and of
   kernel A;
5. multi-speaker serving at the published VCTK width (109 speakers, 256-wide
   embeddings, random weights with the posterior encoder, seed 0) with
   ``EngineConfig(use_pallas_flow=True)``: as phase 4 with speakers 0, 17 and
   108 and per-row speakers in the batch, kernels A, B, C and 6 launched,
   every flow graph the warmup captured kept and reused by the requests,
   speakers 0 and 17 differing on the same text and seed, and the ms per
   request with the flow kernel on and off; then voice conversion of a
   synthesized utterance from speaker 0 to 17 (posterior mean: finite,
   frames x hop long, identical on a second call, card vs CPU);
6. the narrow vocoder: warmup, then one request at HiFi-GAN V2's decoder (MMS
   text side, ``upsample_initial_channel=128``) through kernels 7 and C at
   C_out 16 and 8, the card-vs-CPU check, and the request's profile (device
   busy ms, idle share, device ms of kernels 7 and C) beside its wall ms;
7. training at full MMS width (random weights with the training modules,
   seed 0; the discriminator at seed 0): the inference kernels refuse
   autograd; a warm-up GAN step, then three on a batch of 512 and 300 tokens
   (padded to 512) over 1280 frames -- losses finite, every parameter with a
   finite gradient and moved, kernels A-with-lse, 4 and 5 (forward and
   backward) launched and B, C
   not -- with ms per step and peak memory; one step with each call site
   timed between synchronisations and one under ``torch.profiler`` (device
   busy time, idle share, device ms per kernel family); one ``generator_loss``
   and its gradients at the weights the steps started from, on the card vs
   the plain CPU path with the same noise (equal MAS durations; losses, and
   gradients by relative L2 error per module and per tensor, within a
   multiple of the CPU's own noise floor: the largest movement when every
   weight is perturbed by 1e-7, over three perturbations); and ``train()``
   on a synthetic micro-corpus for 4 steps with checkpoints, resumed to
   step 6;
8. streaming and HTTP serving (``engine/streaming.py``, ``engine/mux.py``,
   ``engine/server.py``), full widths, random weights, seed 0, after warmup:
   (a) at MMS-TTS width with ``EngineConfig(transfer_int16=False,
   adaptive_capacity=False)``, the 211-token text streamed (its 640-frame
   capacity overflows at random weights, so the speculative first window is
   discarded and the prior runs again at 1280 frames): TTFA, stream ms,
   windows, audio s per wall s, kernels A, B, C launched; the stream within
   STREAM_ATOL of the one-shot decode and zero margins far outside it; one
   window under ``torch.profiler`` (device busy ms, idle share) and against
   the CPU plain path on the same prior slice; (b) at VCTK width with the
   flow kernel, warmed as the server's ``main`` warms it, four concurrent
   streams (speakers 0, 17, 108, 5) through ``MultiplexedStreamingDecoder(
   max_batch=8)``: each within STREAM_ATOL of its solo stream, fewer
   dispatches than windows, kernel 6 launched, no flow graph captured after
   warmup, and kernel 6 from 4 threads x 25 calls bit-identical to
   single-thread calls; (c) ``serve(model, max_batch=8, streamer=mux)``
   in-process under 5 s of closed-loop load over loopback (4 /synthesize
   clients, 2 /stream clients, per-request seeds and speakers): no client
   error, no 429, queue depth 0, ``/metrics`` counting what the clients
   saw, latency p95 and stream TTFA p99 under 2 s (percentiles printed);
   then one /convert from speaker 0 to 17 within one int16 step of
   ``convert_voice``;
9. the precision tiers (``vits_tpu_torch/ops/tiers.py``; phases 4-8 pin the
   exact tier, ``exact_engine``, since their bounds assume fp32): each of A,
   B, C, 7 and 6 at "fast", "high" and "highest", and B and C with bf16 and
   int8 packs, against the plain twin at the same tier on the card at phase
   3's shapes (bounds 0.03 / 1e-4 / KERNEL_TOL; the bound at the tier's peak:
   bf16 for "fast", a third of it for "high", 3xTF32 for "highest", bytes at
   the formats' widths); the 87-token MMS request at each fidelity tier
   (``EngineConfig.fidelity_kwargs``: fast, glue32, high, exact) and at fast
   on the same weights quantized: its frames, steady wall ms, device busy ms,
   idle share and launches, and its flow and vocoder at the exact tier's
   durations with mel-L1 against exact; a fast-tier stream against its
   one-shot decode (mel-L1); the CLI's ``main`` with its defaults
   (``--device cuda --fidelity fast``);
10. bf16 training (``compute_dtype="bfloat16"``, ``ops/tiers.py::
   BF16_TRAIN_TIER``) at phase 7's shapes, in a process of its own as phase
   9 (``--bf16-training-phase``; in the main process the profiler lost kernel
   A's bf16 records after phases 3-8): (a) kernels A with lse, 4, and 5
   (forward with acts, backward) on bf16 storage against their plain twins
   at the same tier (A, 4 within two bf16 ulps; 5 by relative L2 2e-2, and
   its distance to the twin under 0.75 of an fp32 control's that rounds once
   at the end), the bound at the bf16 rate (989 TFLOP/s, 2 bytes an
   entry); (b) three GAN
   steps at bf16 and at fp32 from the same weights on the same batch and
   noise: steady ms, device busy ms, idle share, peak memory, master
   parameters fp32 and moved, every kernel call of the bf16 steps on bf16
   storage (the C entry points' arguments), and one generator loss's
   gradients at bf16 against fp32 by cosine (>= 0.97, the CPU tests'
   bound, over all and for the text encoder, the decoder and the posterior
   encoder; the flow and the duration predictor follow MAS's durations and
   are reported, as is each tensor); (c) a speaker-conditioned GAN step at
   VCTK width (speakers 108
   and 17), then its generator loss and gradients on the card against the
   CPU's plain path (phase 7's bounds, ``embed_speaker.weight`` included);
   (d) ``reuse_forward=False`` against the single forward (losses 1e-5,
   parameters after one AdamW step rtol 1e-4, atol 1e-6); (e)
   ``python -m vits_tpu_torch.train.loop --dtype bfloat16`` on the
   synthetic corpus, 2 steps with checkpoints, resumed to 3;
11. bf16 serving (``EngineConfig(compute_dtype="bfloat16")``, ``ops/tiers.py::
   Tiers.bf16_compute``), in a process of its own as phases 9 and 10
   (``--bf16-serving-phase``): (a) each kernel's bf16 serving mode against
   its plain twin on the card at phase 3's shapes -- B (MMS stages 0-1), C
   (stages 2-3, conv_post on the last) and 7 (HiFi-GAN V2's C=64, k=11) by
   relative L2 2e-2 (XLA's bf16 graph, rounded after every step), A at each
   tier and 6 (VCTK width, speaker 17) within two bf16 ulps -- the bound at
   the bf16 rate; (b) MMS at bf16: warmup, the 87-token request's profile
   beside the fast tier's (fp32 engine) in the same process, card vs the
   CPU's plain bf16 path on one NoiseOverride (the text encoder by relative
   L2, frame counts within 10% in total, the decode of the CPU's prior by
   mel-L1), a batch of three against solo runs, a stream against its
   one-shot decode, the flow and vocoder at the exact tier's durations by
   mel-L1 against exact; VCTK at bf16 with ``use_pallas_flow``: a request of
   speaker 17 and a conversion 0 -> 17; HiFi-GAN V2's decoder at bf16: a
   request through kernels 7 and C, profiled;
12. data-parallel training (``vits_tpu_torch/parallel``, ``train/step.py``'s
   ``data_parallel``, ZeRO-1), in a process of its own as phases 9-11
   (``--data-parallel-phase``), at MMS width with random weights: (a) a
   one-rank NCCL group (``parallel/distributed.py::initialize``): the
   data-parallel GAN step at phase 7's batch against the plain one-process
   step from the same weights and noise (losses, clipped gradients and the
   parameters after AdamW within DP_SPREAD_FACTOR x the plain step's own
   run-to-run spread over three runs, cuDNN pinned to deterministic
   algorithms for the comparison; bit-equal where it repeats itself),
   kernels A with lse, 4 and 5 launched by it, the steady step ms of both and
   the gradient all-reduce alone per network, and ``train(zero1=True)`` for 4
   steps with a resume to 6; (b) two gloo ranks sharing the card (NCCL refuses
   two ranks on one GPU; each a grandchild, ``--data-parallel-rank``) at B=4,
   two rows a rank, against the one-process B=4 step: equal MAS durations,
   both ranks' metrics and gradients bit-identical, losses within
   DP_LOSS_RTOL relative (or 10x their noise floor where larger), gradients
   within phase 7's noise-floor bounds (the floor of the one-process step on
   the card); ZeRO-1 on and off after two steps within the replicated run's
   spread; the steady step ms and gloo's all-reduce ms through the host;
13. multi-device serving (``parallel/mesh.py::make_mesh``, ``Synthesizer(mesh=)``,
   ``engine/sp.py``), in a process of its own (``--multi-device-phase``), over
   ``make_mesh(devices=[cuda:0, cuda:0])``: two replicas that share the card,
   each with its own weights, packs and host thread: (a) MMS-TTS at full width
   at the exact tier, five texts of 23-211 tokens at per-row seeds on the mesh
   against the single engine at the same padded rows (equal frames, BATCH_ATOL),
   kernels A, B and C launched on each replica (booked where each wrapper
   counts its launch, :func:`replica_book`); (b) VCTK width with kernel 6:
   the batch of three with its speaker list tail-filled over the padded rows, and ``convert_voice`` 0 -> 17, against the
   single engine; (c) ``ShardedDecoder`` with 2 and 3 shards on the 211-token
   text and on the 87-token one at ``speaking_rate=0.5`` (it overflows the
   ladder) against the one-shot decode within STREAM_ATOL; (d) ``serve(...)``
   in-process on the mesh engine, MESH_CLIENTS /synthesize clients for
   MESH_LOAD_S s: requests, errors, 429s, latency percentiles (p95 under 2 s);
   (e) a batch of eight 87-token requests on the single engine and on the mesh,
   and the 211-token text one-shot and over ``ShardedDecoder(2)``: wall ms,
   device busy ms, idle share (two replicas on one card: what the threads cost
   or buy, not a multi-card figure); (f) where more than one card is visible,
   (a) over distinct cards with device 0 current, else a line saying it did
   not run;
14. model-parallel training (``parallel/pipeline.py``, the model axis of
   ``parallel/mesh.py`` and ``parallel/tensor.py``), in a process of its own
   (``--model-parallel-phase``), at MMS width with random weights, B=4 at 512
   tokens (one row 300) over 1280 frames, cuDNN pinned to deterministic
   algorithms: kernels A with lse and 4 at a pipeline microbatch (B=2, both
   heads) and at one rank's head (B=4, H=1), and 5 at the decoded-segment
   shapes of B=4, against their plain twins; (a) ``pipeline_text_encoder`` on
   ``make_pipe_mesh(2 | 3, devices=[cuda:0] * n)`` at microbatches 2 and 4,
   remat off and on, against ``text_encoder`` (outputs ENCODER_RTOL, the stage
   blocks' gradients PP_GRAD_RTOL), A and 4 booked to every stage (backward
   included); ``make_pp_train_step`` against ``make_train_step`` from the same
   weights and noise (losses within DP_LOSS_RTOL or 10x their noise floor,
   gradients within phase 7's noise-floor bounds), each stage's block,
   gradient and moments on its device, steady ms of both; (b) two gloo ranks
   sharing the card as ``data=1 x model=2`` (``--model-parallel-rank``
   grandchildren) against the one-process B=4 GAN step (the same bounds, the
   ranks' slices reassembled), one head a rank, A, 4 and 5 launched on each,
   each rank's bytes of parameters and moments, its steady step ms and the
   time inside gloo's all-reduces; (c) pp x dp on ``make_pipe_mesh(2, data=2,
   devices=[cuda:0] * 4)`` against ``text_encoder``;
15. what the JAX package runs and the port once refused, in a process of its
   own (``--refusals-phase``): (a) kernels A and 4 against their plain twins at
   head_dim 160, 192, 256 by window 4, 16, 32 (B=2, H=2, L=512, lengths 507 and
   300), in every mode (A on fp32 values at each tier, on bf16 storage with and
   without lse, its bf16 serving mode; 4 at exact on fp32 and at fast on bf16),
   each within its tier's bound, with device, event and plain ms and the bound;
   (b) MMS-TTS at full width with random weights in two variants, one head of
   192 at window 16 (A, A with lse and 4 launched) and no window (neither
   launched): the 87-token request at "exact" and "fast" through the engine and
   on one NoiseOverride against the CPU plain path (phase 4's bounds at exact;
   at fast equal frame counts, the latents within TIER_TOL and the waveform's
   mel-L1 within FAST_STREAM_MEL_L1), one GAN step (after a warm-up) on phase 7's batch and one generator loss card vs
   CPU within phase 7's bounds; (c) two gloo ranks sharing the card at six rows
   and grad_accum=2 (microbatches of three over two ranks) against the
   one-process step at grad_accum=2, within phase 12b's bounds;
16. the serving start-up artifacts, in a process of its own (``--startup-phase``),
   on MMS-TTS at full width with random weights (seed 0) at ``fast``: (a) an AOT
   bundle (``io/aot.py``) of batch 1 and 4 at the 87-token request's bucket, both
   rng layouts, no speaker, from the library phase 2 built (no second nvcc), and
   an engine with ``compilation_cache_dir`` set to an empty directory, which the
   loaded library is copied into; (b) a process with nvcc hidden (off PATH, no
   CUDA_HOME, any build raising; ``--startup-child``) serving the 87-token request
   and batches of 4 and 3 from the bundle: every row bit-identical to the
   exporting engine's, build_seconds 0.0, 2 hits and 1 miss (the batch of 3),
   A, B and C launched, its seconds from process start to first audio; (c) the
   same from the library cache; (d) the bundle refused by an ``exact`` engine,
   and a copy with one byte of its library flipped refused before any library
   load; (e) ``utils/devprofile.py``'s ``device_ms`` of the 87-token request (the
   median of three readings, each through devprofile's lost-record check: a
   device record for every host call that put work on the card, and no fewer
   records of a wrapper's own kernel than its count; a session that lost a
   record is taken again, up to three sessions a reading) within
   DEVPROFILE_RTOL of phase 9's reading of the same call in another process
   (``profiled``, which reads through devprofile too).

Each path's launch counts are set to 0 just before it and read just after.
Then one JSON line of the kernels' numbers (``ms``/``plain_ms``/``device_ms``/
``plain_device_ms``/``bound_ms``: the sums over the kernel's timed shapes;
``launches``: the count over the paths that run the kernel, the serving
paths (phases 4-6 and 8) for A, B, C, 6, 7 and training for 4 and 5, kernel 5's backward
apart as ``backward_launches``; phase 10's bf16 kernels as ``*_bf16`` entries with the
launches of its three bf16 steps, phase 11's bf16 serving modes as ``*_bf16_serve``
entries with the launches of its request paths; ``library_ms`` is null:
no single PyTorch call computes any of these functions; ``tiers``: phase 9's
sums per tier and weight format, ``tier_launches`` its requests' launches per
fidelity tier; ``data_parallel_launches``: phase 12's counts for A with lse, 4
and 5, its world-1 step and 12b's rank 0; ``multi_device_launches``: phase 13's
calls of A, B, C and 6 by path, replica and device; ``multi_device``: phase 13's
numbers; phase 14's kernel shapes as ``*_mp`` entries with the launches of 14a's
pipelined steps and 14b's rank 0, ``model_parallel_launches`` by path and
``stage_launches`` by stage; ``model_parallel``: phase 14's numbers; phase 15a's
shapes as ``*_wide`` entries with the launches of 15b's head_dim-192 variant;
``refusals``: phase 15's numbers; ``startup_launches`` phase 16's children's launches of
A, B and C; ``startup``: phase 16's numbers), and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import io
import json
import subprocess
import sys
import threading
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
# The card's peaks for a kernel's bound (NVIDIA H100 SXM data sheet). An
# fp32-accurate product on the tensor cores is three TF32 products (3xTF32:
# hi*hi + hi*lo + lo*hi), so the least time for fp32 work is its FLOPs at a
# third of the 495 TFLOP/s TF32 rate -- faster than the 67 TFLOP/s of fp32
# outside the tensor cores. And HBM.
PEAK_FP32_ACCURATE_FLOPS = 495e12 / 3
PEAK_HBM_BYTES = 3.35e12
# Profiler sessions of this run, those run again because CUPTI lost a record,
# and readings kept although every session of theirs lost one.
PROFILER_SESSIONS = {"sessions": 0, "rerun": 0, "kept_lost": 0}

SINGLE_TEXTS = (
    "hello world.",
    "the quick brown fox jumps over the lazy dog.",
    "speech synthesis on a graphics card runs the text encoder, the duration "
    "predictor, the flow and the vocoder.",
)
BATCH_TEXTS = ("good morning.", "how are you today?", "see you soon, my friend.")
BATCH_SEEDS = (11, 22, 33)
VOCAB = "kzyuvdheswm' ablcfgijnopqrtx0123456789_-"
# The published VCTK VITS (jaywalnut310/vits configs/vctk_base.json): every other
# width as MMS-TTS's.
VCTK = dict(num_speakers=109, speaker_embedding_size=256, sampling_rate=22050)
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
            timed: bool = True, work: tuple[int, int] | None = None, tol: float = KERNEL_TOL,
            peak: float = None) -> dict:
    """Kernel vs plain on the same inputs (a tensor or a tuple of tensors each);
    raises past the tolerance, per tensor: max |diff| <= KERNEL_TOL x
    max(1, max|plain|), or with ``grad_rtol`` relative L2 error <= grad_rtol.
    ``work`` = (FLOPs, bytes) of the call gives its bound: the larger of the
    FLOPs at ``peak`` (default PEAK_FP32_ACCURATE_FLOPS) and the bytes (each
    input read once, each output written once) at PEAK_HBM_BYTES; ``tol``
    replaces KERNEL_TOL (a precision tier's bound). Timed calls also get their device
    ms, kernel and plain: the profiler's busy time per call (``host_and_device``),
    what the kernels themselves take; the CUDA-event ms of a call of tens of us
    is mostly the host's launch path."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    pairs = list(zip(got, want)) if isinstance(got, (tuple, list)) else [(got, want)]
    pairs = [(g.float(), w.float()) for g, w in pairs]
    err = worst = 0.0
    for i, (g, w) in enumerate(pairs):
        if not bool(torch.isfinite(g).all()):
            raise RuntimeError(f"{name} {shape}: non-finite output {i}")
        e = float((g - w).abs().max())
        if grad_rtol is None:
            ratio = e / (tol * max(1.0, float(w.abs().max())))
        else:
            ratio = float(torch.linalg.vector_norm(g - w)
                          / torch.linalg.vector_norm(w).clamp_min(1e-30)) / grad_rtol
        if not ratio <= 1.0:
            raise RuntimeError(f"{name} {shape}: output {i} of {len(pairs)} off by {ratio:.3g} "
                               f"times the tolerance (max|diff| {e})")
        err, worst = max(err, e), max(worst, ratio)
    ms, plain_ms = (median_ms(kernel), median_ms(plain)) if timed else (None, None)
    device_ms = plain_device_ms = None
    if timed:
        device_ms = host_and_device(kernel)["device_busy_ms"]
        plain_device_ms = host_and_device(plain)["device_busy_ms"]
        times = (f"kernel {ms:.3f} ms (device {device_ms:.4f})  plain {plain_ms:.3f} ms "
                 f"(device {plain_device_ms:.4f})")
    else:
        times = "(not timed)"
    result = {"shape": shape, "max_abs_err": err, "err_over_tol": worst, "ms": ms,
              "plain_ms": plain_ms, "device_ms": device_ms, "plain_device_ms": plain_device_ms,
              "library_ms": None}
    if timed and work is not None:
        ops_ms, bytes_ms = (1e3 * work[0] / (peak or PEAK_FP32_ACCURATE_FLOPS),
                            1e3 * work[1] / PEAK_HBM_BYTES)
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
    result = compare("fused_stage", f"{c_in}->{c_out} B={x.shape[0]} T_in={x.shape[1]}"
                     + (" +conv_post" if final else ""),
                     lambda: fused_stage(*args, **kw), lambda: stage_reference(*args, **kw),
                     work=(flops, nbytes(x, lens, *weights) + out_bytes))
    split = launch_device_ms(lambda: fused_stage(*args, **kw), STAGE_LAUNCHES)
    # cuDNN on the same upsampler and conv_post, channels-first: a yardstick for
    # those launches only (the port never calls them)
    xt = x.transpose(1, 2).contiguous()
    wt = up_w.flip(0).permute(1, 2, 0).contiguous()
    yard = {"upsample": host_and_device(lambda: torch.nn.functional.conv_transpose1d(
        xt, wt, args[2], stride=rate, padding=kw["up_padding"]))["device_busy_ms"]}
    if final:
        ht = torch.zeros((x.shape[0], c_out, x.shape[1] * rate), device=x.device)
        wp = decoder["conv_post.weight"].permute(2, 1, 0).contiguous()
        yard["conv_post"] = host_and_device(
            lambda: torch.nn.functional.conv1d(ht, wp, padding=3))["device_busy_ms"]
    print("    device ms by launch: " + ", ".join(
        f"{name} {ms:.4f}" + (f" (cuDNN yardstick {yard[name]:.4f})" if name in yard else "")
        for name, ms in split.items()), flush=True)
    result.update(launch_device_ms=split, cudnn_yardstick_ms=yard)
    return result


def slice_kernels_vs_plain(vctk, narrow, device) -> dict:
    """Phase 3, the multi-speaker and narrow-vocoder kernels at the shapes of 320
    frames: kernel 6 at VCTK width with per-row speakers (B=1 and B=3 with
    lengths 320, 137, 0 at 320 frames; B=8 at 640 and B=16 at 1280 frames,
    batches that fill the card), kernel 7
    on HiFi-GAN V2's stages 0-1 (C=64 at 8F steps, C=32 at 64F) and kernel C on its
    stages 2-3 (32->16, 16->8 + conv_post), each with a length-0 row."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.flow import flow_reference, fused_flow, pack_flow_weights

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
    packed = pack_flow_weights(p, config)  # once per parameter set, as the engine keeps it
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
        kernel = lambda: fused_flow(x, p, config, packed=packed, **kw)  # noqa: E731
        plain = lambda: flow_reference(x, p, config, **kw)  # noqa: E731
        results["fused_flow"].append(compare(
            "fused_flow", f"B={B} T={T} len={lengths[:3]} +speaker", kernel, plain,
            work=(n * per_frame * sum(lengths), nbytes(x, x, lens, emb, *flow_weights))))
        if B == 1:  # a single request's flow: bound by the host's enqueue or the device?
            split = {"kernel": host_and_device(kernel), "plain": host_and_device(plain)}
            results["fused_flow"][-1]["host_device"] = split
            print("  fused_flow B=1 host vs device: " + "; ".join(
                f"{name} enqueue {v['enqueue_ms']:.3f} ms/call, {v['device_ops']:g} device ops "
                f"busy {v['device_busy_ms']:.3f} ms" for name, v in split.items()), flush=True)

    # 7 and C at HiFi-GAN V2's stages
    config = narrow.config
    decoder = ParamView(narrow.params).sub("decoder")
    slope = config.leaky_relu_slope
    for i, T in ((0, 8 * frames), (1, 64 * frames)):
        x, lens = activ(T, decoder[f"upsampler.{i}.weight"].shape[2], T - 37)
        for blk in _stage_resblocks(decoder, config, i):
            results["fused_resblock"].append(compare_resblock(
                x, lens, blk, slope, f"B=2 T={T} len=({T - 37},0)"))
    for i, T_in in ((2, 64 * frames), (3, 128 * frames)):
        results["fused_stage"].append(compare_stage(decoder, config, i, activ(
            T_in, decoder[f"upsampler.{i}.weight"].shape[1], T_in - 37)))
    return results


def compare_resblock(x, lens, blk, slope: float, shape: str) -> dict:
    """Kernel 7 against its plain version, and beside it the six-launch route it
    replaces (B's conv twice per pair, ``run_pairs``, which stays kernel B's
    route) timed on the same inputs in the same call; one call must be one
    device launch."""
    from vits_tpu_torch.ops.cuda.resblock import (
        block_plan,
        fused_resblock,
        pair_weights,
        resblock_reference,
        run_pairs,
    )

    B, T, C = x.shape
    k, dilations = blk["kernel_size"], tuple(blk["dilations"])
    plan = block_plan(B, T, C, k, dilations, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    kernel = lambda: fused_resblock(x, blk, slope=slope, lengths=lens)  # noqa: E731
    result = compare("fused_resblock", f"C={C} {shape} k={k}", kernel,
                     lambda: resblock_reference(x, blk, slope=slope, lengths=lens),
                     work=(resblocks_flops(steps_of(x, lens), C, [blk]),
                           nbytes(x, x, lens, *pair_weights([blk]))))
    out = torch.empty_like(x)
    six = lambda: run_pairs(x, out, [blk], lens, slope)  # noqa: E731
    ops = host_and_device(kernel)["device_ops"]
    earlier = {"ms": median_ms(six), "device_ms": host_and_device(six)["device_busy_ms"]}
    if ops != 1:
        raise RuntimeError(f"kernel 7 at C={C} {shape}: {ops} device launches a call, not 1")
    verdict = "at or below" if result["device_ms"] <= earlier["device_ms"] else "ABOVE"
    print(f"    plan bm={plan.bm} cluster={plan.cluster}; 1 device launch a call; the six-launch "
          f"route {earlier['ms']:.3f} ms (device {earlier['device_ms']:.4f}): kernel 7 {verdict} "
          "it", flush=True)
    result.update(plan={"bm": plan.bm, "cluster": plan.cluster}, device_ops=ops,
                  six_launch_ms=earlier["ms"], six_launch_device_ms=earlier["device_ms"])
    return result


def block_probe_at_stage_shape(params: dict, config, device) -> dict:
    """Kernel 7 at kernel C's MMS resblock shape (C=64, T=40960, B=1, k=11: stage 2's
    third resblock for 320 frames), against the six-launch route. A measurement
    for the roadmap: kernel C keeps its own route."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, resblock_reference, run_pairs

    rng = np.random.default_rng(5)
    blk = _stage_resblocks(ParamView(params).sub("decoder"), config, 2)[-1]
    x = torch.tensor(rng.standard_normal((1, 40960, 64)), dtype=torch.float32, device=device)
    x[:, 40923:] = 0.0
    lens = torch.tensor([40923], dtype=torch.int32, device=device)
    slope = config.leaky_relu_slope
    got = fused_resblock(x, blk, slope=slope, lengths=lens)
    want = resblock_reference(x, blk, slope=slope, lengths=lens)
    err = float((got - want).abs().max()) / (KERNEL_TOL * max(1.0, float(want.abs().max())))
    out = torch.empty_like(x)
    probe = {"kernel_device_ms": host_and_device(
                 lambda: fused_resblock(x, blk, slope=slope, lengths=lens))["device_busy_ms"],
             "six_launch_device_ms": host_and_device(
                 lambda: run_pairs(x, out, [blk], lens, slope))["device_busy_ms"],
             "err_over_tol": err}
    print(f"  kernel 7 probe at kernel C's MMS resblock shape (C=64 T=40960 B=1 k=11): device "
          f"{probe['kernel_device_ms']:.4f} ms, the six-launch route "
          f"{probe['six_launch_device_ms']:.4f} ms, {err:.3g} of tol (C keeps its route)",
          flush=True)
    if not err <= 1.0:
        raise RuntimeError(f"kernel 7 at kernel C's shape: off by {err:.3g} times the tolerance")
    return probe


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
        trio_backward_reference,
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

    def valid(grads, lengths):  # each row up to its length (a length-0 row whole), rel tables
        return (*(g[b, :, :n or L] for g in grads[:3] for b, n in enumerate(lengths)),
                *grads[3:])
    # (507, 0): a padding row; (512, 300): phase 7's training batch, no length-0 shortcut
    for lengths in ((L - 5, 0), (L, 300)):
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        out, lse = flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True)
        args = (q, k, v, *rel, lse, dout, out)
        results["trainable_rel_attention"].append(compare(
            "rel_attention_bwd", f"B=2 H={heads} L={L} d={d} len={lengths} valid region",
            lambda: valid(rel_attention_bwd(*args, window=w, lengths=lens), lengths),
            lambda: valid(rel_attention_bwd_reference(*args, window=w, lengths=lens), lengths),
            work=(attention_flops(lengths, heads, d, w, backward=True),
                  nbytes(*args, lens, q, k, v, *rel))))

    def rounding_control(name, got, twin, control):
        """Kernel-vs-twin against control-vs-twin, relative L2 over all outputs."""
        def dist(a):
            return float(sum(float((x.float() - y.float()).norm()) ** 2 for x, y in zip(a, twin))
                         / sum(float(y.float().norm()) ** 2 for y in twin)) ** 0.5
        kernel_d, control_d = dist(got), dist(control)
        print(f"    {name} rounding points: kernel vs twin {kernel_d:.3e}, fp32 control (one "
              f"rounding) vs twin {control_d:.3e}; share {kernel_d / control_d:.3f} (bound "
              f"{ROUNDING_SHARE})", flush=True)
        if not kernel_d <= ROUNDING_SHARE * control_d:
            raise RuntimeError(f"{name} at bf16: as far from its twin as a kernel that rounds "
                               f"once ({kernel_d:.3e} against {control_d:.3e})")
        return {"kernel_vs_twin": kernel_d, "control_vs_twin": control_d}

    def fp32_blocks(blocks):
        return [{**blk, **{n: [t.float() for t in blk[n]] for n in ("w1", "b1", "w2", "b2")}}
                for blk in blocks]

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

        def reference_on_plain_acts():
            with torch.no_grad():
                dx, dweights = trio_backward_reference(g, x, blocks, plain_acts, slope=slope)
            return (dx, *dweights)

        # the backward alone, on the activations plain autograd saves itself: against
        # plain autograd, then timed against its plain twin (cuDNN's conv gradients and
        # the elementwise glue) on the same activations
        results["trainable_trio"].append(compare(
            "trio_backward", shape + " grads on plain acts", backward_on_plain_acts,
            plain_grads, grad_rtol=GRAD_RTOL, timed=False))
        weights = pair_weights(blocks)
        results["trainable_trio"].append(compare(
            "trio_backward", shape + " bwd alone vs its plain twin", backward_on_plain_acts,
            reference_on_plain_acts, grad_rtol=GRAD_RTOL,
            work=(2 * fwd_flops, nbytes(x, g, *plain_acts, *weights) + nbytes(x, *weights))))
        results["trainable_trio"].append(compare(
            "trainable_trio fwd+bwd", shape + " grads",
            lambda: torch.autograd.grad((trainable_trio(xg, blocks, slope=slope) * g).sum(),
                                        leaves),
            plain_grads, grad_rtol=FLIP_GRAD_RTOL if flips else GRAD_RTOL,
            work=(3 * fwd_flops, 2 * nbytes(*leaves) + nbytes(g))))
    return results


# A directory the main process makes for the run (removed at its exit); its child
# processes inherit the variable and share the random weights saved there.
WEIGHTS_ENV = "CHIP_SMOKE_WEIGHTS"


def random_weights(config, keep_training: bool = True) -> dict:
    """``vits_tpu_torch.io.random_params(config, seed=0, keep_training)``, made
    once per run: saved as an .npz under the directory ``CHIP_SMOKE_WEIGHTS``
    names and loaded from there by every later call in any process of the run
    (each child would otherwise import transformers and initialise the model
    again). Without the variable (a phase run alone) it calls ``random_params``."""
    import hashlib
    import os

    from vits_tpu_torch.io import random_params

    root = os.environ.get(WEIGHTS_ENV)
    if root is None:
        return random_params(config, seed=0, keep_training=keep_training)
    key = hashlib.sha256(repr((config, keep_training)).encode()).hexdigest()[:16]
    path = Path(root) / f"{key}.npz"
    if path.exists():
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    params = random_params(config, seed=0, keep_training=keep_training)
    tmp = Path(root) / f"{key}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **params)
    os.replace(tmp, path)
    return params


@functools.lru_cache(maxsize=None)
def checkpoint(config, keep_training: bool) -> bytes:
    """The .ggml bytes of a model with random weights (seed 0), made once per config."""
    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml

    params = random_weights(config, keep_training)
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(VOCAB)},
                              pad_token="k", unk_token="z")
    buf = io.BytesIO()
    export_to_ggml(buf, config, tokenizer, params, fp16_convs=False)
    return buf.getvalue()


def exact_engine(**kw):
    """An EngineConfig at the exact tier (``fidelity_kwargs("exact")``): the
    phases whose bounds assume fp32 -- card vs the CPU's fp32 plain path (equal
    frame counts, latents within LATENT_RTOL), batch rows vs solo runs,
    STREAM_ATOL, the mux's and the HTTP load's re-runs -- pin it; the default
    on the card is the fast tier (phase 9)."""
    from vits_tpu_torch import EngineConfig

    return EngineConfig(**kw, **EngineConfig.fidelity_kwargs("exact"))


def make_model(device, config=None, engine_config=None, keep_training: bool = False):
    """A model with random weights (seed 0), loaded as a user would: MMS-TTS at full
    width unless ``config`` says otherwise."""
    import vits_tpu_torch
    from vits_tpu_torch import VitsConfig

    return vits_tpu_torch.load_model(checkpoint(config or VitsConfig(), keep_training),
                                     engine_config, device=device)


def check_audio(audio: np.ndarray, what: str) -> None:
    if audio.size == 0:
        raise RuntimeError(f"{what}: empty audio")
    if not np.isfinite(audio).all() or np.abs(audio).max() > 1.0:
        raise RuntimeError(f"{what}: audio not finite or outside [-1, 1]")


# Synthesizer.warmup before the requests of phases 4-6: every token bucket at batch
# 1 and 3 (the batch request's rows), per-row seeds (the requests pass seed lists),
# and the first re-dispatch rung.
WARMUP = dict(batch_sizes=(1, 3), per_row_seeds=True, overflow_ladder=1)


def warm(model, card: str) -> dict:
    """``model.warmup(**WARMUP)``: its seconds, and kernel 6's workspaces after it."""
    t0 = time.perf_counter()
    model.warmup(**WARMUP)
    seconds = time.perf_counter() - t0
    pack = model._flow_pack()
    print(f"  warmup{tuple(WARMUP.values())}: {seconds:.2f} s wall, "
          f"{model.stats['compiled_shapes']} dispatch shapes"
          + ("" if pack is None else f", {len(pack._workspaces)} flow graphs captured")
          + f" ({card})", flush=True)
    return {"seconds": seconds, "flow_graphs": {} if pack is None else dict(pack._workspaces)}


def run_slice(model, card: str, wrappers, single_speakers=None, batch_speakers=None) -> dict:
    """Phases 4-5: warmup, the requests (the first one's wall ms beside its steady
    median), with the launch counts of ``wrappers`` over them; batch rows vs solo
    runs; repeated seeds; and one batch through batch buckets (1, 4)."""
    rate = model.config.sampling_rate
    single_speakers = single_speakers or (None,) * len(SINGLE_TEXTS)
    warmed = warm(model, card)

    for fn in wrappers:
        fn.launches = 0
    requests = [([text], [seed], None if spk is None else [spk]) for seed, (text, spk)
                in enumerate(zip(SINGLE_TEXTS, single_speakers), start=1)]
    requests.append((list(BATCH_TEXTS), list(BATCH_SEEDS), batch_speakers))
    batch_out, walls = None, []
    for n, (texts, seeds, speakers) in enumerate(requests, start=1):
        tokens = [len(model.tokenizer.encode(t)) for t in texts]
        t0 = time.perf_counter()
        out = model.synthesize_raw(texts, seed=seeds, speaker_id=speakers)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        walls.append(wall_ms)
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
    first_ms = first_request_after_warmup(model, card, walls[0], single_speakers[0])
    check_flow_graphs_kept(model, warmed["flow_graphs"])

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
    batch_buckets(model, batch_speakers)
    return {"launches": launches, "warmup_s": warmed["seconds"], "first_request_ms": first_ms}


def first_request_after_warmup(model, card: str, first_ms: float, speaker, reps: int = 3):
    """The first request after warmup again, ``reps`` times: its steady median."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model.synthesize_raw([SINGLE_TEXTS[0]], seed=[1], speaker_id=None if speaker is None
                             else [speaker])
        walls.append(1e3 * (time.perf_counter() - t0))
    steady = float(np.median(walls))
    print(f"  first request after warmup: {first_ms:.1f} ms wall; the same request again, "
          f"median of {reps}: {steady:.1f} ms ({card})", flush=True)
    return {"first_ms": first_ms, "steady_ms": steady}


def check_flow_graphs_kept(model, warmed: dict) -> None:
    """Every flow graph warmup captured is still the one the pack holds: the
    requests of warmed shapes captured none anew."""
    pack = model._flow_pack()
    if pack is None:
        return
    lost = [key for key, ws in warmed.items() if pack._workspaces.get(key) is not ws]
    if lost:
        raise RuntimeError(f"flow graphs of warmed shapes captured again: {lost}")
    new = [key for key in pack._workspaces if key not in warmed]
    print(f"  flow graphs: all {len(warmed)} warmed ones kept and reused; {len(new)} shapes "
          f"the warmup did not cover captured during the requests {new}", flush=True)


def batch_buckets(model, batch_speakers) -> None:
    """The batch of three texts through ``batch_buckets=(1, 4)`` (padded to 4 rows):
    rows equal their solo runs within BATCH_ATOL, and every dispatch shape has a
    bucket's rows."""
    engine = model.engine
    model.engine = dataclasses.replace(engine, batch_buckets=(1, 4))
    model._dispatch_shapes.clear()
    try:
        speakers = None if batch_speakers[0] is None else list(batch_speakers)
        batch = model.synthesize(list(BATCH_TEXTS), seed=list(BATCH_SEEDS), speaker_id=speakers)
        worst = 0.0
        for i, (text, seed) in enumerate(zip(BATCH_TEXTS, BATCH_SEEDS)):
            solo = model.synthesize(text, seed=[seed], speaker_id=None if speakers is None
                                    else [speakers[i]])
            if solo.shape != batch[i].shape:
                raise RuntimeError(f"batch buckets: row {i} {batch[i].shape}, solo {solo.shape}")
            worst = max(worst, float(np.abs(batch[i] - solo).max()))
        rows = {shape[0] for shape in model._dispatch_shapes}
    finally:
        model.engine = engine
    print(f"  batch_buckets=(1, 4): 3 texts dispatched at rows {sorted(rows)}; rows vs solo "
          f"runs max|diff| {worst:.3e} (atol {BATCH_ATOL})", flush=True)
    if not worst <= BATCH_ATOL or not rows <= {1, 4}:
        raise RuntimeError("batch buckets: rows differ from solo runs or a dispatch is "
                           "outside the buckets")


# The launches of one kernel C call, by the first pattern their name contains.
STAGE_LAUNCHES = (
    ("upsample", ("upsample_kernel",)),
    ("resblock convs", ("conv_kernel",)),  # conv_kernel<...> and narrow_conv_kernel<...>
    ("conv_post", ("wave_kernel",)),
)


def launch_device_ms(fn, families, calls: int = 5) -> dict[str, float]:
    """Device ms per call of each family of ``fn``'s launches (``calls`` calls
    under one profiler)."""
    torch.cuda.synchronize()
    _, device, _ = profiled(lambda: [fn() for _ in range(calls)])
    found = by_family(device, families)
    return {name: found[name][0] / calls for name, _ in families if name in found}


# Device kernel families of a serving request, by the first pattern their name contains.
REQUEST_FAMILIES = (
    ("kernel 6", ("FlowEpi",)),
    ("resblock convs (kernels B, C)", ("conv_kernel",)),
    ("kernel A", ("rel_attention_kernel",)),
    ("kernel C upsample, conv_post", ("upsample_kernel", "wave_kernel")),
    ("cuDNN convolutions", ("cudnn", "fprop", "implicit_gemm", "conv")),
    ("matmul (cuBLAS)", ("gemm", "cutlass")),
    ("elementwise", ("elementwise",)),
    ("reductions", ("reduce",)),
)


def request_profile(model, card: str, reps: int = 3, families=REQUEST_FAMILIES) -> dict:
    """One request of the second text (87 tokens): the
    steady wall ms (median of ``reps``, host clock to a synchronise), then one
    request under ``torch.profiler``: device busy ms, the idle share of the
    steady request, and device ms per kernel family of ``families``."""
    def request():
        return model.synthesize_raw([SINGLE_TEXTS[1]], seed=[5])

    out = request()
    frames = int(out.frame_lengths[0])
    capacity = out.waveform.shape[1] // model.config.total_upsample
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    steady_ms = float(np.median(walls))
    wall_ms, device, busy_ms = profiled(request)
    families = by_family(device, families)
    idle = 1.0 - busy_ms / steady_ms
    tokens = len(model.tokenizer.encode(SINGLE_TEXTS[1]))
    print(f"  one {tokens}-token request ({frames} frames at capacity {capacity}): steady "
          f"{steady_ms:.1f} ms wall (median of {reps}; "
          f"all {[round(w, 1) for w in walls]}), {wall_ms:.1f} ms under the profiler, "
          f"{len(device)} device operations, device busy {busy_ms:.2f} ms, idle share "
          f"{idle:.3f} ({card})", flush=True)
    for family, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {family:30s} {ms:8.3f} ms  {n:5d} launches  "
              f"{1e3 * ms / capacity:7.3f} us per frame of capacity", flush=True)
    return {"tokens": tokens, "frames": frames, "capacity": capacity, "steady_ms": steady_ms,
            "walls_ms": walls, "device_busy_ms": busy_ms, "idle_share": idle,
            "device_ops": len(device),
            "families_ms": {k: v[0] for k, v in families.items()}}


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


def gan_steps(config, device, card: str, attention_kernels: bool = True,
              profile: bool = True, steps: int = 3) -> dict:
    """Phase 5a: ``steps`` GAN steps at full MMS width; the launch counts over them.
    Without ``attention_kernels`` (a model with no relative window) kernels A and
    4 must launch no time; without ``profile`` no profiled step."""
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage
    from vits_tpu_torch.ops.cuda.trio_grad import trio_backward, trio_forward_with_acts
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import make_gan_train_step

    gen = {k: v.requires_grad_() for k, v in
           from_jax_params(random_weights(config, keep_training=True), device).items()}
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

    wrappers = (flash_rel_attention, rel_attention_bwd, trio_forward_with_acts, trio_backward,
                fused_resblock_trio, fused_stage)
    for fn in wrappers:
        fn.launches = 0
    flash_rel_attention.lse_launches = 0
    times = []
    for i in range(steps):
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
    print(f"  launches over the {steps} steps: {launches}", flush=True)
    print(f"  median {float(np.median(times)):.1f} ms per step after the warm-up (B=2, 512 "
          f"tokens, 1280 frames, {n_gen / 1e6:.1f} M generator + {n_disc / 1e6:.1f} M "
          f"discriminator parameters), peak {peak_gib:.2f} GiB allocated ({card})", flush=True)
    attention = ("flash_rel_attention_lse", "rel_attention_bwd")
    for name in attention + ("trio_forward_with_acts", "trio_backward"):
        if name in attention and not attention_kernels:
            if launches[name] or launches["flash_rel_attention"]:
                raise RuntimeError(f"kernel {name} launched for a model without a window")
        elif launches[name] == 0:
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
            raise RuntimeError(f"parameter {name} did not move in {steps} steps")
    print(f"  all {len(gen)} generator and {len(disc)} discriminator parameters have finite "
          "gradients and moved", flush=True)
    if profile:
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
    ("port kernels A, 4, 5", ("rel_attention_kernel", "rel_attention_bwd_kernel",
                              "conv_kernel<", "wgrad_kernel")),
    ("elementwise", ("elementwise",)),
    ("reductions", ("reduce",)),
    ("FFT", ("fft",)),
    ("cuDNN convolutions", ("cudnn", "fprop", "dgrad", "wgrad", "implicit_gemm", "conv")),
    ("matmul (cuBLAS)", ("gemm", "cutlass")),
)


def profiled(fn, attempts: int = 3) -> tuple[float, list, float]:
    """One call of ``fn`` under ``torch.profiler`` through ``utils/devprofile.py``
    (``read``): its wall ms (host clock to a synchronise), its device events
    (kernels, memcpy, memset) and the device busy ms (the union of their
    intervals). A session that lost a record is taken again, up to
    ``attempts`` sessions; where every one lost a record, the fullest is kept
    and what it lost is printed."""
    from vits_tpu_torch.utils import devprofile

    reading = devprofile.read(fn, attempts=attempts)
    PROFILER_SESSIONS["sessions"] += reading.sessions
    PROFILER_SESSIONS["rerun"] += reading.sessions - (0 if reading.lost else 1)
    if reading.lost:
        PROFILER_SESSIONS["kept_lost"] += 1
        print(f"  profiler: every one of {attempts} sessions lost records; the fullest kept "
              f"({'; '.join(reading.lost)})", flush=True)
    return reading.wall_ms, reading.events, reading.busy_ms


def by_family(device: list, families) -> dict[str, list]:
    """Device ms and launches per family of ``families`` ((name, patterns) pairs:
    the first whose pattern the event's name contains); memcpy/memset and other
    kernels apart."""
    out: dict[str, list] = {}
    for e in device:
        name = e["name"] if e["cat"] == "kernel" else e["cat"]
        family = next((fam for fam, keys in families if any(k in name for k in keys)),
                      "memcpy/memset" if e["cat"] != "kernel" else "other")
        entry = out.setdefault(family, [0.0, 0])
        entry[0] += e["dur"] / 1e3
        entry[1] += 1
    return out


def host_and_device(fn, calls: int = 5) -> dict:
    """Host ms to enqueue one call of ``fn`` (the mean over ``calls`` with no
    synchronisation between them), and its device operations and busy ms per
    call from ``calls`` calls under one profiler: which of the two bounds the
    call."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    _, device, busy_ms = profiled(lambda: [fn() for _ in range(calls)])
    return {"enqueue_ms": enqueue_ms, "device_ops": len(device) / calls,
            "device_busy_ms": busy_ms / calls}


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
    families = by_family(device, KERNEL_FAMILIES)
    idle = 1.0 - busy_ms / steady_ms
    print(f"  profiled GAN step: {wall_ms:.1f} ms wall under the profiler, {len(device)} device "
          f"operations, device busy {busy_ms:.1f} ms, idle share of the {steady_ms:.1f} ms "
          f"steady step {idle:.3f} ({card})", flush=True)
    for family, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {family:24s} {ms:8.2f} ms  {n:6d} launches", flush=True)
    return {"sites_ms": spent, "sites_wall_ms": sites_wall_ms, "wall_ms_profiled": wall_ms,
            "device_busy_ms": busy_ms, "idle_share": idle, "device_ops": len(device),
            "families_ms": {k: v[0] for k, v in families.items()}}


def hold_gradients(names, got, want, floors, label: str) -> None:
    """Hold gradients ``got`` against ``want`` (lists of tensors in ``names``' order)
    by relative L2 error, per module and per tensor, within a multiple of the
    noise floor ``floors``: the gradients of ``want``'s computation with every
    weight moved by 1e-7, FLOOR_SAMPLES times.

    Per module (all its tensors) within 10x the module's floor, and per tensor
    within TENSOR_FLOOR_FACTOR x the larger of its own and its module's floor (a
    tensor's floor is a noisy estimate, and the worst of ~700 tensors reached
    6.6x a one-sample floor on an H100; a wrong or missing tensor is off by ~1,
    far past that bound). A tensor whose own floor passes NOISY_GRAD is
    rounding noise (the attention key biases: their exact gradient is 0, softmax
    being shift-invariant), and is held in its module's units against the
    module's bound."""
    def rel(a, b, scale):
        return float(torch.linalg.vector_norm(a - b)) / scale

    groups: dict[str, list] = {}
    for i, name in enumerate(names):
        groups.setdefault(name.split(".")[0], []).append(
            (name, got[i], want[i], [grads[i] for grads in floors]))
    for module, items in groups.items():
        g, c = (torch.cat([t[i].flatten() for t in items]) for i in (1, 2))
        norm = float(torch.linalg.vector_norm(c))
        err = rel(g, c, norm)
        floor = max(rel(torch.cat([t[3][j].flatten() for t in items]), c, norm)
                    for j in range(len(floors)))
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
                raise RuntimeError(f"{label}: gradients of {name} differ: relative L2 "
                                   f"{t_err:.3e} > {t_bound:.3e}")
            if t_err / t_bound > worst:
                worst, worst_name = t_err / t_bound, name
        print(f"  gradients of {module} ({len(items)} tensors): {label} relative L2 "
              f"{err:.3e}, max|diff| {float((g - c).abs().max()):.3e} of max "
              f"{float(c.abs().max()):.3e} (noise floor {floor:.3e}, bound {bound:.3e}); "
              f"worst tensor {worst_name} at {worst:.3f} of its bound; rounding noise: "
              f"{noisy or 'none'}", flush=True)
        if not err <= bound:
            raise RuntimeError(f"{label}: gradients of {module} differ past the bound")


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
    hold_gradients(list(gen), card_g, cpu_g, [grads for _, grads in perts], "card vs CPU")
    print(f"  card vs CPU: equal MAS durations ({int(cpu_out.durations.sum())} frames), "
          "losses and gradients within bounds", flush=True)


def train_loop(card: str, zero1: bool = False) -> None:
    """Phase 5c: ``train()`` on a synthetic micro-corpus, checkpoints, then a resume
    (phase 12a: with ``zero1``, over a one-rank NCCL group)."""
    import tempfile

    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml
    from vits_tpu_torch.train.data import corpus_vocab, generate_micro_corpus
    from vits_tpu_torch.train.loop import train

    config = VitsConfig()
    with tempfile.TemporaryDirectory() as tmp:
        corpus, model, out_dir = f"{tmp}/corpus", f"{tmp}/model.ggml", f"{tmp}/run"
        generate_micro_corpus(corpus, n_utts=16)
        tokenizer = VitsTokenizer(vocab=corpus_vocab(), pad_token="_", unk_token="?")
        export_to_ggml(model, config, tokenizer, random_weights(config, keep_training=True),
                       fp16_convs=False)
        for steps in (2, 3):
            logs, rates = [], []
            t0 = time.perf_counter()
            gen = train(corpus, model, out_dir, steps=steps, batch_size=4, checkpoint_every=2,
                        log_every=1, log=logs.append, device="cuda", zero1=zero1,
                        metrics_hook=lambda step, values, rate: rates.append(rate))
            torch.cuda.synchronize()
            for line in logs:
                print(f"    {line}", flush=True)
            if not all(bool(torch.isfinite(p).all()) for p in gen.values()):
                raise RuntimeError("train(): non-finite parameters")
            print(f"  train(steps={steps}): {time.perf_counter() - t0:.1f} s wall, median "
                  f"{float(np.median(rates)):.2f} it/s ({card})", flush=True)
        expected = ("resumed from step 2", "restored EMA weights", "checkpointed step 3")
        if not all(e in logs for e in expected):
            raise RuntimeError(f"resume to step 6 did not run as expected: {logs}")


# Device kernel families of a HiFi-GAN V2 request: kernel 7, kernel C's own kernels and
# its narrow resblock convs, then the rest as in REQUEST_FAMILIES.
NARROW_FAMILIES = (
    ("kernel 7", ("block_kernel",)),
    ("kernel C", ("upsample_kernel", "narrow_conv_kernel", "wave_kernel", "conv_kernel")),
    *REQUEST_FAMILIES[2:],
)


def narrow_vocoder(model, card: str, wrappers) -> dict:
    """Phase 6: one request through HiFi-GAN V2's decoder (kernels 7 and C at 16, 8),
    after warmup; its profile with kernels 7 and C by family."""
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio

    warm(model, card)
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
    return {"launches": launches, "request_ms": wall_ms,
            "profile": request_profile(model, card, families=NARROW_FAMILIES)}


# Phase 8: streaming, the window multiplexer and the HTTP server.
# Stream vs one-shot decode on the card, and a mux stream vs its solo stream:
# the kernels pick tiles and K splits per (B, T) (conv_plan, block_plan,
# flow_plan) and cuDNN its algorithms per shape, so a 184-frame window and a
# 1280-frame utterance (or a window at batch 4 and at batch 1) sum in different
# orders -- the class of difference of the card against the CPU plain path, and
# held to that check's waveform bound. A window decoded without its margins is
# off at its edges by orders of magnitude more.
STREAM_ATOL = WAVE_ATOL
ZERO_MARGIN_FACTOR = 10  # zero margins must miss the one-shot decode by 10 x STREAM_ATOL
# Phase 8b: four concurrent streams through the mux, (text, seed and speaker).
MUX_STREAMS = ((SINGLE_TEXTS[1], 0), (SINGLE_TEXTS[2], 17), (BATCH_TEXTS[2], 108),
               (SINGLE_TEXTS[0], 5))
# Phase 8c: closed-loop clients over loopback for LOAD_S seconds, each request with
# its own seed and speaker, on texts of the token buckets the server warms (64, 128).
LOAD_S = 5.0
SYNTH_CLIENTS, STREAM_CLIENTS = 4, 2
LOAD_TEXTS = (SINGLE_TEXTS[0], SINGLE_TEXTS[1], *BATCH_TEXTS)
# The tripwires of tests/test_serving_load.py:70-71 (latency p95), TTFA held at p99.
LATENCY_P95_S = TTFA_P99_S = 2.0
INT16_STEP = 1.5 / 32767  # one int16 PCM step, and the truncation of the WAV writer
# Phase 8c's served audio run again alone: this many requests and streams, spread
# evenly over the load.
REPLAY_SYNTH, REPLAY_STREAMS = 24, 8


def decode_window(params, config, latents, mask3, emb=None, use_pallas=False,
                  pack=None) -> dict:
    """One window through the flow and the vocoder, as a stream decodes it:
    its flow latents and waveform on the host."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import hifigan
    from vits_tpu_torch.models.vits import latents_from_prior

    with torch.inference_mode():
        lat = latents_from_prior(params, config, latents, mask3, emb, use_pallas=use_pallas,
                                 flow_pack=pack)
        wave = hifigan(ParamView(params), config, lat, mask3, emb)
    return {"latents": lat.cpu().numpy(), "waveform": wave.cpu().numpy()}


def stream_mms(device, card: str, wrappers) -> dict:
    """Phase 8a: the 211-token text streamed at MMS-TTS width after warmup (its
    speculative first window discarded: random weights overflow the 640-frame
    capacity), against the one-shot decode and against zero margins; one window
    under the profiler and against the CPU plain path."""
    from vits_tpu_torch import EngineConfig
    from vits_tpu_torch.engine.streaming import StreamingDecoder
    from vits_tpu_torch.engine.synthesizer import _next_bucket

    # adaptive_capacity=False: the prior's noise is drawn at the frame capacity, and
    # the stream keeps the static frame_bucket; so must the one-shot request.
    model = make_model(device, engine_config=exact_engine(transfer_int16=False,
                                                          adaptive_capacity=False))
    warm(model, card)
    streamer = StreamingDecoder(model)
    t0 = time.perf_counter()
    streamer.warmup(overflow_ladder=1)
    print(f"  StreamingDecoder.warmup(every token bucket, one rung): "
          f"{time.perf_counter() - t0:.2f} s, shapes {sorted(streamer._dispatch_shapes)}",
          flush=True)

    text, seed, rate = SINGLE_TEXTS[2], 7, model.config.sampling_rate
    for fn in wrappers:
        fn.launches = 0
    chunks, ttfa_ms = [], None
    t0 = time.perf_counter()
    for pcm in streamer.stream(text, seed=seed):
        if ttfa_ms is None:
            ttfa_ms = 1e3 * (time.perf_counter() - t0)
        chunks.append(pcm)
    stream_ms = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    streamed = np.concatenate(chunks)
    check_audio(streamed, "stream")
    audio_s = len(streamed) / rate
    tokens = len(model.tokenizer.encode(text))
    print(f"  stream of {tokens} tokens: TTFA {ttfa_ms:.1f} ms, whole stream {stream_ms:.1f} ms, "
          f"{len(chunks)} windows, audio {audio_s:.3f} s, {audio_s / (stream_ms / 1e3):.1f} "
          f"audio s / wall s, launches {launches} ({card})", flush=True)
    if any(count == 0 for count in launches.values()):
        raise RuntimeError(f"the stream did not launch every kernel: {launches}")

    out = model.synthesize_raw(text, seed=seed)
    oneshot = out.waveform[0, : out.lengths[0]]
    capacity = out.waveform.shape[1] // model.config.total_upsample
    zero = StreamingDecoder(model, margin_frames=0, flow_margin_frames=0)
    loose = zero.synthesize_streaming(text, seed=seed)
    if streamed.shape != oneshot.shape or loose.shape != oneshot.shape:
        raise RuntimeError(f"stream {streamed.shape} / zero margins {loose.shape} vs one-shot "
                           f"{oneshot.shape}")
    diff = float(np.abs(streamed - oneshot).max())
    zero_diff = float(np.abs(loose - oneshot).max())
    print(f"  stream vs one-shot ({out.frame_lengths[0]} frames at capacity {capacity}, "
          f"{model.stats['redispatches']} re-dispatches so far): max|diff| {diff:.3e} "
          f"(STREAM_ATOL {STREAM_ATOL}); zero margins {zero_diff:.3e} (must pass "
          f"{ZERO_MARGIN_FACTOR} x STREAM_ATOL)", flush=True)
    if not diff <= STREAM_ATOL:
        raise RuntimeError(f"stream differs from the one-shot decode by {diff}")
    if not zero_diff > ZERO_MARGIN_FACTOR * STREAM_ATOL:
        raise RuntimeError(f"zero margins differ from the one-shot decode by only {zero_diff}")

    encoded = model.tokenizer.encode(text)
    ids, mask = model.tokenizer.pad([encoded], pad_to=_next_bucket(
        model.engine.token_buckets, len(encoded)))
    prior = streamer._prior(ids, mask, capacity, seed, None, model._controls(None, None, None))
    window = streamer.chunk_frames + 2 * streamer.total_margin
    lo = 4 * streamer.chunk_frames - streamer.total_margin  # the fifth chunk's window

    def one_window():
        return streamer._resolve(streamer._dispatch_window(prior.latents, prior.mask3, None,
                                                           lo, window))

    one_window()
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_window()
        walls.append(1e3 * (time.perf_counter() - t0))
    steady_ms = float(np.median(walls))
    wall_ms, events, busy_ms = profiled(one_window)
    families = by_family(events, REQUEST_FAMILIES)
    idle = 1.0 - busy_ms / steady_ms
    print(f"  one {window}-frame window (frames {lo}-{lo + window}): steady {steady_ms:.2f} ms "
          f"wall (median of 5), {wall_ms:.2f} ms under the profiler, {len(events)} device "
          f"operations, device busy {busy_ms:.3f} ms, idle share {idle:.3f} ({card})",
          flush=True)
    for family, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
        print(f"    {family:30s} {ms:8.3f} ms  {n:5d} launches", flush=True)
    latents, mask3 = prior.latents[:, lo: lo + window], prior.mask3[:, lo: lo + window]
    cpu_params = {k: v.cpu() for k, v in model.params.items()}
    check_close(f"one {window}-frame stream window",
                decode_window(model.params, model.config, latents, mask3),
                decode_window(cpu_params, model.config, latents.cpu(), mask3.cpu()))
    return {"launches": launches, "tokens": tokens, "ttfa_ms": ttfa_ms, "stream_ms": stream_ms,
            "windows": len(chunks), "audio_s": audio_s, "capacity": capacity,
            "stream_vs_oneshot": diff, "zero_margins_vs_oneshot": zero_diff,
            "window": {"frames": window, "steady_ms": steady_ms, "walls_ms": walls,
                       "device_busy_ms": busy_ms, "idle_share": idle,
                       "device_ops": len(events),
                       "families_ms": {k: v[0] for k, v in families.items()}}}


def flow_from_threads(model, T: int, card: str, threads: int = 4, calls: int = 25) -> None:
    """Kernel 6 from ``threads`` threads at once, ``calls`` calls each, on the warmed
    (1, T, speakers) workspace, each thread with its own input, lengths and speaker:
    every output bit-identical to its single-thread output."""
    import threading

    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.ops.cuda.flow import fused_flow

    config, pack, p = model.config, model._flow_pack(), ParamView(model.params)
    rng = np.random.default_rng(5)
    inputs = []
    for i in range(threads):
        x = torch.tensor(rng.standard_normal((1, T, config.flow_size)), dtype=torch.float32,
                         device=model.device)
        lens = torch.tensor([T - 11 * i], dtype=torch.int32, device=model.device)
        emb = model.params["embed_speaker.weight"][[MUX_STREAMS[i][1]]][:, None].contiguous()
        inputs.append((x, lens, emb))

    def call(x, lens, emb):
        return fused_flow(x, p, config, lengths=lens, speaker_embeddings=emb, packed=pack)

    want = [call(*args) for args in inputs]
    torch.cuda.synchronize()
    outs, errors = [[] for _ in inputs], []

    def run(i):
        try:
            for _ in range(calls):
                outs[i].append(call(*inputs[i]))
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    workers = [threading.Thread(target=run, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    torch.cuda.synchronize()
    if errors or any(w.is_alive() for w in workers):
        raise RuntimeError(f"kernel 6 from threads: {errors or 'a thread hung'}")
    mismatched = sum(not torch.equal(out, want[i]) for i, o in enumerate(outs) for out in o)
    print(f"  kernel 6 from {threads} threads x {calls} calls on (1, {T}, speakers): "
          f"{mismatched} of {threads * calls} outputs differ from the single-thread ones "
          f"({card})", flush=True)
    if mismatched or sum(len(o) for o in outs) != threads * calls:
        raise RuntimeError("kernel 6 is not safe for concurrent callers")


def stream_prior(streamer, text: str, seed: int, speaker: int):
    """The prior a stream of ``text`` decodes (its capacity doubled past the
    predicted length, as ``StreamingDecoder.stream`` does) and its valid frames."""
    from vits_tpu_torch.engine.synthesizer import _next_bucket

    model = streamer.synth
    encoded = model.tokenizer.encode(text)
    bucket = _next_bucket(model.engine.token_buckets, len(encoded))
    ids, mask = model.tokenizer.pad([encoded], pad_to=bucket)
    frames, controls = model.engine.frame_bucket(bucket), model._controls(None, None, None)
    while True:
        prior = streamer._prior(ids, mask, frames, seed, np.asarray([speaker], np.int64),
                                controls)
        predicted = int(prior.total_duration.cpu()[0])
        if predicted <= frames:
            return prior, predicted
        while frames < predicted:
            frames *= 2


def windows_vs_plain(model, streamer, wrappers) -> None:
    """The windows the mux decodes, through kernels 6, B and C on the card against
    the plain versions on the CPU: at B=1 (a middle window of the 211-token text,
    speaker 17) and at the mux's B=8 (the first and the last window of each of
    MUX_STREAMS' streams and the 211-token text's middle one; a short utterance
    mask-padded to the window and the batch filled with row 0, as the mux pads
    them), each row with its own speaker."""
    window = streamer.chunk_frames + 2 * streamer.total_margin
    rows, middle = [], None
    for text, spk in MUX_STREAMS:
        prior, valid = stream_prior(streamer, text, spk, spk)
        frames = prior.latents.shape[1]
        if frames <= window:
            pad = (0, 0, 0, window - frames)
            rows.append((torch.nn.functional.pad(prior.latents, pad),
                         torch.nn.functional.pad(prior.mask3, pad), prior.speaker_embeddings))
            continue
        offsets = [0, min(max(valid - window // 2, 0), frames - window)]
        if text == SINGLE_TEXTS[2]:
            offsets.insert(1, min(valid // 2, frames - window))
        for lo in offsets:
            rows.append((prior.latents[:, lo: lo + window], prior.mask3[:, lo: lo + window],
                         prior.speaker_embeddings))
            if len(offsets) == 3 and lo == offsets[1]:
                middle = rows[-1]
    rows = (rows + [rows[0]] * 8)[:8]
    cpu_params = {k: v.cpu() for k, v in model.params.items()}
    before = {fn.__name__: fn.launches for fn in wrappers}
    for what, picked in (("1 window, speaker 17", [middle]),
                         (f"{len(rows)} windows, speakers {[s for _, s in MUX_STREAMS]}", rows)):
        lat, mask3, emb = (torch.cat([r[i] for r in picked]).contiguous() for i in range(3))
        check_close(f"{what}, {window} frames, kernel 6",
                    decode_window(model.params, model.config, lat, mask3, emb,
                                  use_pallas=True, pack=model._flow_pack()),
                    decode_window(cpu_params, model.config, lat.cpu(), mask3.cpu(), emb.cpu()))
    ran = {name: fn.launches - before[name] for name, fn in
           ((fn.__name__, fn) for fn in wrappers)}
    if any(n < 2 for n in ran.values()):
        raise RuntimeError(f"the window checks did not launch every kernel twice: {ran}")


def mux_vctk(device, card: str, wrappers) -> dict:
    """Phase 8b: the VCTK-width model warmed as the server's ``main`` warms it
    (``--max-batch 8 --warm-overflow 1 --stream-mux 8``, every token bucket for the
    streams), four concurrent streams through the mux against their solo streams,
    no flow graph captured after warmup, the mux's windows against the plain
    versions, and kernel 6 from four threads."""
    import threading

    from vits_tpu_torch import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.mux import MultiplexedStreamingDecoder
    from vits_tpu_torch.engine.streaming import StreamingDecoder

    model = make_model(device, VitsConfig(**VCTK), exact_engine(
        use_pallas_flow=True, batch_buckets=(1, 2, 4, 8), adaptive_capacity_align=True),
        keep_training=True)
    t0 = time.perf_counter()
    model.warmup(batch_sizes=(1,), token_buckets=model.engine.token_buckets[:2],
                 per_row_seeds=True, overflow_ladder=1)
    solo = StreamingDecoder(model)
    solo.warmup(overflow_ladder=1)
    mux = MultiplexedStreamingDecoder(model, max_batch=8)
    mux.warmup(overflow_ladder=1)
    pack = model._flow_pack()
    warmed = {} if pack is None else dict(pack._workspaces)
    print(f"  engine, solo and mux warmups: {time.perf_counter() - t0:.2f} s, "
          f"{len(warmed)} flow graphs ({card})", flush=True)

    for fn in wrappers:
        fn.launches = 0
    results, ttfa, errors = [None] * len(MUX_STREAMS), [None] * len(MUX_STREAMS), []

    def run(i):
        text, spk = MUX_STREAMS[i]
        try:
            chunks, t0 = [], time.perf_counter()
            for pcm in mux.stream(text, seed=spk, speaker_id=spk):
                if not chunks:
                    ttfa[i] = 1e3 * (time.perf_counter() - t0)
                chunks.append(pcm)
            results[i] = np.concatenate(chunks)
        except Exception as exc:  # surfaced below
            errors.append(repr(exc))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(MUX_STREAMS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    stats = dict(mux.stats)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"mux streams failed: {errors or 'a stream hung'}")
    audio_s = sum(len(r) for r in results) / model.config.sampling_rate
    print(f"  {len(MUX_STREAMS)} concurrent streams (speakers {[s for _, s in MUX_STREAMS]}): "
          f"{wall_ms:.1f} ms wall, {audio_s:.3f} s of audio, TTFA "
          f"{[round(t, 1) for t in ttfa]} ms, mux stats {stats}, launches {launches} ({card})",
          flush=True)
    if not (stats["dispatches"] < stats["windows"] and stats["max_rows"] >= 2):
        raise RuntimeError(f"the mux did not batch windows: {stats}")
    if any(count == 0 for count in launches.values()):
        raise RuntimeError(f"the mux streams did not launch every kernel: {launches}")
    worst = 0.0
    for (text, spk), got in zip(MUX_STREAMS, results):
        check_audio(got, f"mux stream, speaker {spk}")
        want = solo.synthesize_streaming(text, seed=spk, speaker_id=spk)
        if got.shape != want.shape:
            raise RuntimeError(f"mux stream {got.shape} vs solo stream {want.shape}")
        worst = max(worst, float(np.abs(got - want).max()))
    print(f"  mux streams vs solo streams: max|diff| {worst:.3e} (STREAM_ATOL {STREAM_ATOL})",
          flush=True)
    if not worst <= STREAM_ATOL:
        raise RuntimeError(f"mux streams differ from solo streams by {worst}")
    new = [] if pack is None else [key for key, ws in pack._workspaces.items()
                                   if warmed.get(key) is not ws]
    print(f"  flow graphs captured after warmup: {new}", flush=True)
    if new:
        raise RuntimeError(f"flow graphs captured after warmup: {new}")
    windows_vs_plain(model, solo, wrappers[1:])
    flow_from_threads(model, mux._window, card)
    return {"launches": launches, "model": model, "mux": mux, "solo": solo, "wall_ms": wall_ms,
            "ttfa_ms": ttfa, "stats": stats, "mux_vs_solo": worst}


def percentiles(values) -> dict:
    p50, p95, p99 = np.percentile(np.asarray(values), [50, 95, 99])
    return {"p50": float(p50), "p95": float(p95), "p99": float(p99), "n": len(values)}


def replay(model, solo, served) -> dict:
    """A sample of the audio the HTTP load served, spread over the load, against
    the same requests run again: /synthesize against ``model.synthesize`` (per-row
    seeds, as the batching worker passes them) within BATCH_ATOL and /stream
    against a solo ``StreamingDecoder`` within STREAM_ATOL, each plus the WAV
    writer's one int16 step. A row's noise is drawn at its batch's token bucket,
    and the worker may have batched a 64-bucket text with a 128-bucket one: such a
    request is run alone and beside LOAD_TEXTS' longest text, and held to the
    closer of the two."""
    from vits_tpu_torch.engine.synthesizer import _next_bucket
    from vits_tpu_torch.utils.wav import read_wav

    def bucket(text):
        return _next_bucket(model.engine.token_buckets, len(model.tokenizer.encode(text)))

    longest = max(LOAD_TEXTS, key=bucket)
    worst = {}
    for stream, limit, atol in ((False, REPLAY_SYNTH, BATCH_ATOL), (True, REPLAY_STREAMS,
                                                                   STREAM_ATOL)):
        kind = [s for s in served if s[0] == stream]
        picked = kind[:: max(1, len(kind) // limit)][:limit]
        worst[stream], beside = 0.0, 0
        for _, payload, body in picked:
            text, seed, spk = payload["text"], payload["seed"], payload["speaker_id"]
            if stream:  # the streaming header's sizes are unknown: the PCM follows it
                got = np.frombuffer(body[44:], dtype="<i2").astype(np.float32) / 32767.0
                wants = [solo.synthesize_streaming(text, seed=seed, speaker_id=spk)]
            else:
                got = read_wav(body)[0]
                wants = [model.synthesize([text], seed=[seed], speaker_id=[spk])[0]]
                if bucket(text) < bucket(longest):
                    wants.append(model.synthesize([text, longest], seed=[seed, 0],
                                                  speaker_id=[spk, 0])[0])
            diffs = [float(np.abs(got - want).max()) for want in wants
                     if want.shape == got.shape]
            if not diffs:
                raise RuntimeError(f"served {'stream' if stream else 'request'} {payload}: "
                                   f"{got.shape} samples, run again {[w.shape for w in wants]}")
            beside += diffs.index(min(diffs)) > 0 or len(diffs) < len(wants)
            worst[stream] = max(worst[stream], min(diffs))
        print(f"  {len(picked)} of {len(kind)} served {'streams' if stream else 'requests'} "
              f"run again{'' if stream else f' ({beside} beside the longest text)'}: "
              f"max|diff| {worst[stream]:.3e} (atol {atol} + one int16 step)", flush=True)
        if not worst[stream] <= atol + INT16_STEP:
            raise RuntimeError("served audio differs from the same request run again")
    return {"synth_vs_again": worst[False], "stream_vs_again": worst[True]}


def http_load(model, mux, solo, card: str, wrappers) -> dict:
    """Phase 8c: ``serve(model, max_batch=8, streamer=mux)`` in-process, closed-loop
    /synthesize and /stream clients for LOAD_S seconds, a sample of what they were
    served against the same requests run alone; then one /convert."""
    import http.client
    import threading
    import urllib.request

    from vits_tpu_torch.engine.server import serve
    from vits_tpu_torch.utils.wav import read_wav, write_wav

    server, worker = serve(model, port=0, max_batch=8, streamer=mux)
    # Handler threads, the batching worker and the mux's worker run CUDA work:
    # all are joined before the phase returns (server_close joins non-daemon
    # handlers), so none is alive when the interpreter shuts down.
    server.daemon_threads = False
    serving = threading.Thread(target=server.serve_forever)
    serving.start()
    hostport = f"127.0.0.1:{server.server_address[1]}"
    try:
        for fn in wrappers:
            fn.launches = 0
        latency, ttfa, errors, counts = [], [], [], {"synth": 0, "stream": 0}
        served = []  # (stream, payload, body) of every answered request
        lock = threading.Lock()
        stop_at = time.perf_counter() + LOAD_S

        def client(i):
            stream, n = i >= SYNTH_CLIENTS, 0
            while time.perf_counter() < stop_at:
                payload = {"text": LOAD_TEXTS[(i + n) % len(LOAD_TEXTS)], "seed": 1000 * i + n,
                           "speaker_id": (37 * i + 11 * n) % model.config.num_speakers}
                n += 1
                try:
                    conn = http.client.HTTPConnection(hostport, timeout=60)
                    t0 = time.perf_counter()
                    conn.request("POST", "/stream" if stream else "/synthesize",
                                 body=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    if stream:  # the 44-byte WAV header is the first chunk; then PCM
                        body = resp.read(44) + resp.read(1)
                        first = time.perf_counter() - t0
                        body += resp.read()
                    else:
                        body = resp.read()
                    seconds = time.perf_counter() - t0
                    conn.close()
                    if resp.status != 200 or body[:4] != b"RIFF" or len(body) <= 44:
                        raise RuntimeError(f"HTTP {resp.status}, {len(body)} bytes")
                except Exception as exc:  # counted: the pin is zero
                    with lock:
                        errors.append(f"client {i}: {exc!r}")
                    continue
                with lock:
                    served.append((stream, payload, body))
                    if stream:
                        ttfa.append(first)
                        counts["stream"] += 1
                    else:
                        latency.append(seconds)
                        counts["synth"] += 1

        clients = [threading.Thread(target=client, args=(i,))
                   for i in range(SYNTH_CLIENTS + STREAM_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=LOAD_S + 120)
        launches = {fn.__name__: fn.launches for fn in wrappers}
        if any(c.is_alive() for c in clients):
            raise RuntimeError("an HTTP client hung")
        for _ in range(50):  # a handler counts its stream just after the last chunk
            with urllib.request.urlopen(f"http://{hostport}/metrics", timeout=30) as resp:
                metrics = dict(line.split(" ", 1) for line in resp.read().decode().splitlines()
                               if line and not line.startswith("#") and "{" not in line)
            if float(metrics["vits_streams_total"]) >= counts["stream"]:
                break
            time.sleep(0.02)
        lat_p, ttfa_p = percentiles(latency or [np.inf]), percentiles(ttfa or [np.inf])
        print(f"  HTTP load, {SYNTH_CLIENTS} /synthesize + {STREAM_CLIENTS} /stream clients for "
              f"{LOAD_S:g} s: {counts} completed, {len(errors)} errors, /metrics requests "
              f"{metrics['vits_requests_total']} batches {metrics['vits_batches_total']} "
              f"streams {metrics['vits_streams_total']} rejected "
              f"{metrics['vits_rejected_total']} queue {metrics['vits_queue_depth']}; launches "
              f"{launches} ({card})", flush=True)
        print("  latency ms p50/p95/p99 " + "/".join(f"{1e3 * lat_p[k]:.1f}" for k in
                                                     ("p50", "p95", "p99"))
              + ", stream TTFA ms p50/p95/p99 " + "/".join(f"{1e3 * ttfa_p[k]:.1f}" for k in
                                                           ("p50", "p95", "p99"))
              + f" ({card})", flush=True)
        if errors:
            raise RuntimeError(f"HTTP client errors: {errors[:5]}")
        if (float(metrics["vits_rejected_total"]) or float(metrics["vits_queue_depth"])
                or float(metrics["vits_requests_total"]) != counts["synth"]
                or float(metrics["vits_streams_total"]) != counts["stream"]
                or not counts["synth"] or not counts["stream"]):
            raise RuntimeError(f"/metrics disagrees with the clients: {metrics} vs {counts}")
        if not (lat_p["p95"] < LATENCY_P95_S and ttfa_p["p99"] < TTFA_P99_S):
            raise RuntimeError(f"latency p95 {lat_p['p95']} s or TTFA p99 {ttfa_p['p99']} s "
                               f"past {LATENCY_P95_S} s")
        if any(count == 0 for count in launches.values()):
            raise RuntimeError(f"the HTTP load did not launch every kernel: {launches}")
        replayed = replay(model, solo, served)

        rate = model.config.sampling_rate
        buf = io.BytesIO()
        write_wav(buf, model.synthesize(SINGLE_TEXTS[1], seed=3, speaker_id=0), rate)
        req = urllib.request.Request(f"http://{hostport}/convert?source_speaker=0&"
                                     "target_speaker=17", data=buf.getvalue(),
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            got, got_rate = read_wav(resp.read())
        want = model.convert_voice(read_wav(buf.getvalue())[0], source_speaker=0,
                                   target_speaker=17)
        diff = float(np.abs(got - want).max()) if got.shape == want.shape else np.inf
        print(f"  /convert 0 -> 17: {len(got)} samples at {got_rate} Hz, vs convert_voice "
              f"max|diff| {diff:.3e} (one int16 step {INT16_STEP:.3e})", flush=True)
        if got_rate != rate or not diff <= INT16_STEP:
            raise RuntimeError("/convert differs from convert_voice")
    finally:
        worker.stop()
        worker._thread.join(timeout=30)
        server.shutdown()
        serving.join(timeout=30)
        server.server_close()
        mux.stop()
    return {"launches": launches, "requests": counts, "latency_s": lat_p, "ttfa_s": ttfa_p,
            "replayed": replayed,
            "metrics": {k: float(v) for k, v in metrics.items()
                        if k.startswith("vits_") and k.endswith(("_total", "_depth"))}}


def serving_layer(device, card: str, wrappers) -> dict:
    """Phase 8: streaming (8a), the mux (8b) and the HTTP server (8c); each path's
    launch counts are set to 0 just before it and read just after."""
    t0 = time.perf_counter()
    print(f"  [8a] streaming at MMS-TTS width ({card}):", flush=True)
    stream = stream_mms(device, card, wrappers[:3])
    print(f"  [8b] the mux at VCTK width, use_pallas_flow=True, max_batch=8 ({card}):",
          flush=True)
    mux = mux_vctk(device, card, wrappers)
    print(f"  [8c] the HTTP server at VCTK width, in-process ({card}):", flush=True)
    http = http_load(mux.pop("model"), mux.pop("mux"), mux.pop("solo"), card, wrappers)
    seconds = time.perf_counter() - t0
    print(f"  phase 8: {seconds:.1f} s ({card})", flush=True)
    return {"stream": stream, "mux": mux, "server": http, "seconds": seconds}


# --------------------------------------------------------------------------- #
# Phase 9: the precision tiers (vits_tpu_torch/ops/tiers.py) on the card.
# --------------------------------------------------------------------------- #

# Kernel vs plain twin at a tier, max |diff| <= bound x max(1, max|plain|): the
# bounds of tests/test_torch_precision.py (the JAX package's own: 0.03 with bf16
# values, 1e-4 for bf16x3, fp32's KERNEL_TOL).
TIER_TOL = {"fast": 0.03, "high": 1e-4, "highest": KERNEL_TOL}
# The least time at a tier: bf16 dense tensor-core peak for "fast", a third of it
# for "high" (three bf16 passes), 3xTF32 for "highest" (NVIDIA H100 SXM data sheet).
PEAK_BF16_FLOPS = 989e12
TIER_PEAK = {"fast": PEAK_BF16_FLOPS, "high": PEAK_BF16_FLOPS / 3,
             "highest": PEAK_FP32_ACCURATE_FLOPS}
# (tier, vocoder weight format) of kernels B and C: the engine's fast tier on a
# checkpoint (bf16 packs) and on a quantized one (int8), high and exact (fp32), and
# int8 weights at fp32 values.
VOCODER_TIER_CASES = (("fast", "bfloat16"), ("fast", "int8"), ("high", "float32"),
                      ("highest", "float32"), ("highest", "int8"))
FIDELITY_TIERS = ("fast", "glue32", "high", "exact")
# A fast-tier stream against its own one-shot decode, by mel-L1 (as
# tests/test_torch_precision.py holds the fast engine, there under 0.15): at bf16 a
# rounding that flips between a window's summation order and the utterance's is
# amplified by the random weights' saturating vocoder (fast against exact differ
# by max|diff| ~0.6 at mel-L1 ~0.02 on one decode), so max|diff| is printed only.
FAST_STREAM_MEL_L1 = 0.1


def kernel_tier(name: str):
    from vits_tpu_torch.ops.tiers import resolve_tier

    return resolve_tier(None if name == "fast" else name,
                        "bfloat16" if name == "fast" else None)


def tier_blocks(decoder, config, i: int, fmt: str, packs: dict) -> list[dict]:
    """Stage i's resblocks in a weight format: the engine's packs, or the fp32 parameters."""
    from vits_tpu_torch.models.hifigan import _stage_resblocks

    return packs[fmt][i]["blocks"] if fmt != "float32" else _stage_resblocks(decoder, config, i)


def tier_kernels_vs_plain(model, vctk, narrow, device) -> dict:
    """Each of A, B, C, 7 and 6 at fast, high and highest, and B and C with int8
    (and bf16) weights, against the plain twin at the same tier on the card, at
    phase 3's shapes (320 frames); bound at the tier's peak, bytes at the
    formats' widths. Returns {kernel: {tier label: [results]}}."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks, precompute_vocoder_packs
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_reference
    from vits_tpu_torch.ops.cuda.flow import flow_packed_reference, fused_flow, pack_flow_weights
    from vits_tpu_torch.ops.cuda.resblock import (
        fused_resblock,
        fused_resblock_trio,
        pair_scales,
        pair_weights,
        resblock_reference,
        resblock_trio_reference,
    )
    from vits_tpu_torch.ops.cuda.stage import fused_stage, stage_reference
    from vits_tpu_torch.ops.tiers import resolve_tier

    rng = np.random.default_rng(9)
    config, decoder = model.config, ParamView(model.params).sub("decoder")
    slope, frames = config.leaky_relu_slope, 320
    packs = {fmt: precompute_vocoder_packs(ParamView(model.params), config, fmt)
             for fmt in ("bfloat16", "int8")}
    out = {name: {} for name in ("fused_resblock_trio", "fused_stage", "flash_rel_attention",
                                 "fused_resblock", "fused_flow")}

    def activ(T, C, length, dtype=torch.float32, B=1):
        x = torch.tensor(rng.standard_normal((B, T, C)), dtype=torch.float32, device=device)
        x[:, length:] = 0.0
        return x.to(dtype), torch.tensor([length] * B, dtype=torch.int32, device=device)

    def record(kernel, label, result):
        out[kernel].setdefault(label, []).append(result)

    for name, fmt in VOCODER_TIER_CASES:
        tier, label = kernel_tier(name), f"{name} {fmt}"
        for i, T in ((0, 8 * frames), (1, 64 * frames)):  # B: MMS stages 0 and 1
            C = decoder[f"upsampler.{i}.weight"].shape[2]
            x, lens = activ(T, C, T - 37, tier.value_dtype)
            blocks = tier_blocks(decoder, config, i, fmt, packs)
            record("fused_resblock_trio", label, compare(
                "fused_resblock_trio", f"{label} C={C} T={T}",
                lambda: fused_resblock_trio(x, blocks, slope=slope, lengths=lens, tier=tier),
                lambda: resblock_trio_reference(x, blocks, slope=slope, lengths=lens, tier=tier),
                work=(resblocks_flops(steps_of(x, lens), C, blocks),
                      nbytes(x, x, lens, *pair_weights(blocks), *pair_scales(blocks))),
                tol=TIER_TOL[name], peak=TIER_PEAK[name]))
        for i, T_in in ((2, 64 * frames), (3, 128 * frames)):  # C: MMS stages 2 and 3
            up_w = decoder[f"upsampler.{i}.weight"]
            (k_up, c_in, c_out), rate = up_w.shape, config.upsample_rates[i]
            final = i == len(config.upsample_rates) - 1
            pack = packs[fmt][i] if fmt != "float32" else {}
            x, lens = activ(T_in, c_in, T_in - 37, tier.value_dtype)
            blocks = tier_blocks(decoder, config, i, fmt, packs)
            w_post = decoder["conv_post.weight"]
            kw = dict(stride=rate, up_padding=(config.upsample_kernel_sizes[i] - rate) // 2,
                      slope=slope, lengths=lens, tier=tier, up_scale=pack.get("su"),
                      chain=not final,
                      final_conv=pack.get("post", (w_post, 3)) if final else None)
            args = (x, pack.get("up_w", up_w), decoder[f"upsampler.{i}.bias"], blocks)
            steps = steps_of(x, lens)
            flops = conv_flops(steps, k_up, c_in, c_out) + resblocks_flops(steps * rate, c_out,
                                                                           blocks)
            weights = [args[1], args[2], *pair_weights(blocks), *pair_scales(blocks)]
            if final:
                flops += conv_flops(steps * rate, w_post.shape[0], c_out, 1)
                weights.append(kw["final_conv"][0])
            out_bytes = (4 if final else x.element_size() * c_out) * x.shape[1] * rate
            record("fused_stage", label, compare(
                "fused_stage", f"{label} {c_in}->{c_out} T_in={T_in}"
                + (" +conv_post" if final else ""),
                lambda: fused_stage(*args, **kw), lambda: stage_reference(*args, **kw),
                work=(flops, nbytes(x, lens, *weights) + out_bytes),
                tol=TIER_TOL[name], peak=TIER_PEAK[name]))

    layer = ParamView(model.params).sub("text_encoder.encoder.layers.0.attention")
    heads, d, w = config.num_attention_heads, config.head_dim, config.window_size
    L = 512
    q, k, v = (torch.tensor(rng.standard_normal((2, heads, L, d)) * 0.5, dtype=torch.float32,
                            device=device) for _ in range(3))
    rel = (layer["emb_rel_k"][0], layer["emb_rel_v"][0])
    alens = torch.tensor([L - 5, 0], dtype=torch.int32, device=device)
    vconfig, vp = vctk.config, ParamView(vctk.params)
    packed = pack_flow_weights(vp, vconfig)
    half, hidden = vconfig.flow_size // 2, vconfig.hidden_size
    nl, kw_, n = (vconfig.prior_encoder_num_wavenet_layers, vconfig.wavenet_kernel_size,
                  vconfig.prior_encoder_num_flows)
    per_frame = 2 * (half * hidden + nl * kw_ * hidden * 2 * hidden
                     + (nl - 1) * hidden * 2 * hidden + hidden * hidden + hidden * half)
    fx = torch.tensor(rng.standard_normal((1, frames, vconfig.flow_size)), dtype=torch.float32,
                      device=device)
    flens = torch.tensor([frames], dtype=torch.int32, device=device)
    ndecoder = ParamView(narrow.params).sub("decoder")
    nblk = _stage_resblocks(ndecoder, narrow.config, 0)[-1]  # C=64, k=11
    nx, nlens = activ(8 * frames, 64, 8 * frames - 37, B=2)
    nlens[1] = 0
    nx[1] = 0.0
    for name in ("fast", "high", "highest"):
        tier = resolve_tier(None if name == "fast" else name)
        record("flash_rel_attention", name, compare(
            "flash_rel_attention", f"{name} B=2 L={L} len=({L - 5},0)",
            lambda: flash_rel_attention(q, k, v, *rel, window=w, lengths=alens, tier=tier),
            lambda: rel_attention_reference(q, k, v, *rel, window=w, lengths=alens, tier=tier),
            work=(attention_flops((L - 5, 0), heads, d, w), nbytes(q, k, v, q, *rel, alens)),
            tol=TIER_TOL[name], peak=TIER_PEAK[name]))
        record("fused_flow", name, compare(
            "fused_flow", f"{name} B=1 T={frames} (VCTK width)",
            lambda: fused_flow(fx, vp, vconfig, lengths=flens, packed=packed, tier=tier),
            lambda: flow_packed_reference(fx, packed, vconfig, lengths=flens, tier=tier),
            work=(n * per_frame * frames, nbytes(fx, fx, flens, packed.buffer)),
            tol=max(TIER_TOL[name], 1e-4), peak=TIER_PEAK[name]))
        vtier = kernel_tier(name)  # the vocoder's: bf16 values at "fast"
        record("fused_resblock", name, compare(
            "fused_resblock", f"{name} C=64 B=2 T={8 * frames} k=11 (HiFi-GAN V2 stage 0)",
            lambda: fused_resblock(nx, nblk, slope=slope, lengths=nlens, tier=vtier),
            lambda: resblock_reference(nx, nblk, slope=slope, lengths=nlens, tier=vtier),
            work=(resblocks_flops(steps_of(nx, nlens), 64, [nblk]),
                  nbytes(nx, nx, nlens, *pair_weights([nblk]))),
            tol=TIER_TOL[name], peak=TIER_PEAK[name]))
    return out


def mel_l1(a: np.ndarray, b: np.ndarray, rate: int) -> float:
    """Mean |log-mel(a) - log-mel(b)| over the common length (the JAX package's
    ``utils/mel.py::mel_l1``, 80 mels, n_fft 1024, hop 256)."""
    from vits_tpu_torch.utils.mel import log_mel_spectrogram

    n = min(a.shape[-1], b.shape[-1])
    ma = log_mel_spectrogram(torch.tensor(a[..., :n]), sample_rate=rate)
    mb = log_mel_spectrogram(torch.tensor(b[..., :n]), sample_rate=rate)
    return float((ma - mb).abs().mean())


def tier_requests(device, card: str, wrappers) -> dict:
    """The 87-token MMS request at each fidelity tier (EngineConfig.fidelity_kwargs),
    and at "fast" on the same weights quantized (io/quantize.py): each engine's
    own request (frames, steady wall ms, device busy ms, idle share, the kernels'
    launches over its requests) and, at the exact tier's durations (one prior,
    drawn once at "exact"), the flow and vocoder at the tier: mel-L1 against
    "exact". Then a fast-tier stream against its own one-shot decode."""
    import vits_tpu_torch
    from vits_tpu_torch import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.streaming import StreamingDecoder
    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.io.quantize import quantize_params
    from vits_tpu_torch.models.hifigan import hifigan
    from vits_tpu_torch.models.vits import NoiseOverride, latents_from_prior, text_to_prior

    config = VitsConfig()
    params = random_weights(config, keep_training=False)
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(VOCAB)}, pad_token="k",
                              unk_token="z")
    blobs = {}
    for label, p in (("float", params), ("int8", quantize_params(params))):
        buf = io.BytesIO()
        export_to_ggml(buf, config, tokenizer, p, fp16_convs=False)
        blobs[label] = buf.getvalue()
    cases = [(tier, "float") for tier in FIDELITY_TIERS] + [("fast", "int8")]
    models = {case: vits_tpu_torch.load_model(
        blobs[case[1]], EngineConfig(**EngineConfig.fidelity_kwargs(case[0])), device=device)
        for case in cases}
    text = SINGLE_TEXTS[1]
    ids, mask = tokenizer.pad([tokenizer.encode(text)], pad_to=128)
    ids_t = torch.tensor(ids, dtype=torch.long, device=device)
    mask_t = torch.tensor(mask, dtype=torch.float32, device=device)
    rng = np.random.default_rng(2)
    num_frames = 1024  # room for the 87 tokens' frames at random weights
    noise = NoiseOverride(
        torch.tensor(rng.standard_normal((1, 128, 2)), dtype=torch.float32, device=device),
        torch.tensor(rng.standard_normal((1, num_frames, config.flow_size)), dtype=torch.float32,
                     device=device))
    exact = models[("exact", "float")]
    with torch.inference_mode():
        prior = text_to_prior(exact.params, config, ids_t, mask_t, num_frames, noise=noise,
                              attention_tier=exact.tiers.attention)
    frames = min(int(prior.total_duration[0]), num_frames)
    mask3 = prior.frame_mask[..., None]

    def decode(model):
        with torch.inference_mode():
            lat = latents_from_prior(model.params, config, prior.prior_latents, mask3,
                                     use_pallas=model.engine.use_pallas_flow,
                                     flow_pack=model._flow_pack(), tier=model.tiers.flow)
            wave = hifigan(ParamView(model.params), config, lat, mask3, tiers=model.tiers,
                           packs=model._vocoder_packs())
        return wave[0, : frames * config.total_upsample].cpu().numpy()

    reference = decode(exact)
    results = {}
    for case in cases:
        model, label = models[case], f"{case[0]}" + (" int8" if case[1] == "int8" else "")
        model.synthesize_raw([text], seed=[5])  # cuDNN's algorithms, the packs
        for fn in wrappers:
            fn.launches = 0
        profile = request_profile(model, card)
        launches = {fn.__name__: fn.launches for fn in wrappers}
        for name in ("flash_rel_attention", "fused_resblock_trio", "fused_stage"):
            if launches[name] == 0:
                raise RuntimeError(f"{label}: kernel {name} was never launched")
        wave = decode(model)
        check_audio(wave, f"{label} at the exact tier's durations")
        mel = mel_l1(wave[None], reference[None], config.sampling_rate)
        results[label] = {**profile, "launches": launches, "mel_l1_vs_exact": mel,
                          "max_abs_vs_exact": float(np.abs(wave - reference).max()),
                          "weight_format": model._weight_format}
        print(f"  {label:10s}: {profile['frames']} frames, steady {profile['steady_ms']:.1f} ms "
              f"wall, device busy {profile['device_busy_ms']:.2f} ms, idle "
              f"{profile['idle_share']:.3f}; at exact's {frames} frames mel-L1 vs exact "
              f"{mel:.3e}, max|diff| {results[label]['max_abs_vs_exact']:.3e}; launches "
              f"{launches} ({card})", flush=True)
    if results["exact"]["mel_l1_vs_exact"] != 0.0:
        raise RuntimeError("the exact tier's decode is not deterministic")
    for label in ("fast", "high"):
        if not results[label]["mel_l1_vs_exact"] > 0.0:
            raise RuntimeError(f"the {label} tier computed what exact computes")

    fast = vits_tpu_torch.load_model(blobs["float"], EngineConfig(
        transfer_int16=False, adaptive_capacity=False), device=device)
    streamer = StreamingDecoder(fast)
    streamer.warmup(token_buckets=fast.engine.token_buckets[:2])
    for fn in wrappers:
        fn.launches = 0
    streamed = streamer.synthesize_streaming(text, seed=4)
    stream_launches = {fn.__name__: fn.launches for fn in wrappers}
    oneshot = fast.synthesize(text, seed=4)
    if streamed.shape != oneshot.shape:
        raise RuntimeError(f"fast-tier stream of {streamed.shape}, one-shot {oneshot.shape}")
    err = float(np.abs(streamed - oneshot).max())
    mel = mel_l1(streamed[None], oneshot[None], config.sampling_rate)
    print(f"  fast-tier stream vs its one-shot decode: {streamed.shape[0]} samples, mel-L1 "
          f"{mel:.3e} (bound {FAST_STREAM_MEL_L1}), max|diff| {err:.3e}; launches "
          f"{stream_launches} ({card})", flush=True)
    if not mel <= FAST_STREAM_MEL_L1:
        raise RuntimeError(f"fast-tier stream differs from its one-shot decode: mel-L1 {mel}")
    results["fast_stream"] = {"mel_l1": mel, "max_abs": err, "launches": stream_launches}
    return results


def default_cli_run(card: str, wrappers) -> dict:
    """``python -m vits_tpu_torch.cli``'s main with its defaults (``--device cuda``,
    ``--fidelity fast``) on an MMS checkpoint (random weights, seed 0), in this
    process: it writes a WAV through kernels A, B and C."""
    import tempfile

    from vits_tpu_torch import VitsConfig, cli
    from vits_tpu_torch.utils.wav import read_wav

    with tempfile.TemporaryDirectory() as tmp:
        model_path, wav = Path(tmp) / "mms.ggml", Path(tmp) / "out.wav"
        model_path.write_bytes(checkpoint(VitsConfig(), keep_training=False))
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        code = cli.main(["--model", str(model_path), "--text", SINGLE_TEXTS[0],
                         "--out", str(wav)])
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        if code != 0 or not wav.exists():
            raise RuntimeError(f"the CLI's default run exited {code}")
        audio, rate = read_wav(str(wav))
    check_audio(audio, "the CLI's default run")
    print(f"  CLI defaults (--device cuda --fidelity fast): {audio.shape[0] / rate:.2f} s of "
          f"audio in {seconds:.2f} s (load and build included); launches {launches} ({card})",
          flush=True)
    if not all(launches[name] > 0 for name in ("flash_rel_attention", "fused_resblock_trio",
                                               "fused_stage")):
        raise RuntimeError(f"the CLI's default run missed a kernel: {launches}")
    return {"launches": launches, "seconds": seconds}


# Phase 10: bf16 training. Kernels on bf16 storage against their twins at the same
# tier: A and 4 within two bf16 ulps of max(1, |plain|) (the same fp32 arithmetic on
# bf16 values, sums in another order: a stored value may land an ulp away), kernel 5
# by relative L2 error per tensor (its bf16 rounding after every step lets an ulp
# travel; the CPU tests' bound for its twin against JAX's plain resblocks).
BF16_KERNEL_TOL = 2.0**-7
BF16_GRAD_RTOL = 2e-2
BF16_COSINE = 0.97  # bf16 vs fp32 gradients, tests/test_torch_train_bf16.py (JAX's own bound)
# Kernel 5 at bf16 rounds where XLA's bf16 graph rounds. Its distance to its bf16 plain twin
# (relative L2 over all outputs of a call) must stay under this share of the distance of a
# control that computes the same in fp32 on the bf16 inputs and rounds once at the end:
# on the CPU a twin with the kernel's rounding points and another summation order reads
# 0.18-0.33 of the control, a twin that leaves out one rounding point (the bias add) 1.11;
# the kernel on the H100 reads 0.35-0.52.
ROUNDING_SHARE = 0.75
# Modules whose bf16 generator gradients are held to BF16_COSINE one by one. The flow's and
# the duration predictor's follow MAS's durations, which bf16 prior statistics move (the
# run prints whether they moved), so those two are printed only.
COSINE_MODULES = ("text_encoder", "decoder", "posterior_encoder")
REUSE_LOSS_RTOL, REUSE_PARAM_RTOL, REUSE_PARAM_ATOL = 1e-5, 1e-4, 1e-6  # test_torch_train_speaker


def bf16_kernels_vs_plain(params: dict, config, device) -> dict:
    """Phase 10a: kernels A with lse, 4 and 5 (forward with acts, backward) on bf16
    storage at phase 7's shapes (B=2, L=512 with lengths (512, 300); the decoded
    32-frame segment's wide stages), each against its plain twin at the same tier;
    kernel 5's distance to its twin also against an fp32 control's
    (ROUNDING_SHARE); the bound at the bf16 rate, 2 bytes an entry."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_plain
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )
    from vits_tpu_torch.ops.cuda.resblock import pair_weights
    from vits_tpu_torch.ops.cuda.trio_grad import (
        flat_acts,
        trio_backward,
        trio_backward_reference,
        trio_forward_with_acts,
        trio_forward_with_acts_reference,
    )
    from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER as tier

    bf = torch.bfloat16
    rng = np.random.default_rng(10)
    results = {"flash_rel_attention_bf16": [], "trainable_rel_attention_bf16": [],
               "trainable_trio_bf16": []}
    layer = ParamView(params).sub("text_encoder.encoder.layers.0.attention")
    heads, d, w, L = config.num_attention_heads, config.head_dim, config.window_size, 512
    q, k, v, dout = (torch.tensor(rng.standard_normal((2, heads, L, d)) * 0.5,
                                  device=device).to(bf) for _ in range(4))
    rel = (layer["emb_rel_k"][0].to(bf), layer["emb_rel_v"][0].to(bf))
    lengths = (L, 300)
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    shape = f"B=2 H={heads} L={L} d={d} len={lengths} bf16"
    out, lse = flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True,
                                   tier=tier)
    if out.dtype != bf or lse.dtype != torch.float32:
        raise RuntimeError(f"kernel A at bf16 wrote {out.dtype} / {lse.dtype}")
    results["flash_rel_attention_bf16"].append(compare(
        "flash_rel_attention+lse", shape,
        lambda: flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True,
                                    tier=tier),
        lambda: rel_attention_plain(q, k, v, *rel, window=w, lengths=lens, return_lse=True,
                                    tier=tier),
        work=(attention_flops(lengths, heads, d, w), nbytes(q, k, v, out, lse, *rel, lens)),
        tol=BF16_KERNEL_TOL, peak=PEAK_BF16_FLOPS))
    args = (q, k, v, *rel, lse, dout, out)

    def valid(grads):
        return (*(g[b, :, :n] for g in grads[:3] for b, n in enumerate(lengths)), *grads[3:])
    grads = rel_attention_bwd(*args, window=w, lengths=lens, tier=tier)
    if any(g.dtype != bf for g in grads):
        raise RuntimeError("kernel 4 at bf16 wrote another dtype than bf16")
    results["trainable_rel_attention_bf16"].append(compare(
        "rel_attention_bwd", shape + " valid region",
        lambda: valid(rel_attention_bwd(*args, window=w, lengths=lens, tier=tier)),
        lambda: valid(rel_attention_bwd_reference(*args, window=w, lengths=lens, tier=tier)),
        work=(attention_flops(lengths, heads, d, w, backward=True),
              nbytes(*args, lens, *grads)), tol=BF16_KERNEL_TOL, peak=PEAK_BF16_FLOPS))

    def rounding_control(name, got, twin, control):
        """Kernel-vs-twin against control-vs-twin, relative L2 over all outputs."""
        def dist(a):
            return float(sum(float((x.float() - y.float()).norm()) ** 2 for x, y in zip(a, twin))
                         / sum(float(y.float().norm()) ** 2 for y in twin)) ** 0.5
        kernel_d, control_d = dist(got), dist(control)
        print(f"    {name} rounding points: kernel vs twin {kernel_d:.3e}, fp32 control (one "
              f"rounding) vs twin {control_d:.3e}; share {kernel_d / control_d:.3f} (bound "
              f"{ROUNDING_SHARE})", flush=True)
        if not kernel_d <= ROUNDING_SHARE * control_d:
            raise RuntimeError(f"{name} at bf16: as far from its twin as a kernel that rounds "
                               f"once ({kernel_d:.3e} against {control_d:.3e})")
        return {"kernel_vs_twin": kernel_d, "control_vs_twin": control_d}

    def fp32_blocks(blocks):
        return [{**blk, **{n: [t.float() for t in blk[n]] for n in ("w1", "b1", "w2", "b2")}}
                for blk in blocks]

    decoder = ParamView(params).sub("decoder")
    slope = config.leaky_relu_slope
    for i, T in ((0, 256), (1, 2048)):
        blocks = [{**blk, **{n: [t.detach().to(bf) for t in blk[n]]
                             for n in ("w1", "b1", "w2", "b2")}}
                  for blk in _stage_resblocks(decoder, config, i)]
        C = blocks[0]["w1"][0].shape[-1]
        x, g = (torch.tensor(rng.standard_normal((2, T, C)), device=device).to(bf)
                for _ in range(2))
        shape = f"B=2 C={C} T={T} bf16"
        fwd_flops = resblocks_flops(2 * T, C, blocks)
        n_acts = sum(2 * len(blk["dilations"]) - 1 for blk in blocks)
        with torch.no_grad():
            out, acts = trio_forward_with_acts(x, blocks, slope=slope, tier=tier)
            if out.dtype != bf or any(a.dtype != bf for a in flat_acts(acts)):
                raise RuntimeError("kernel 5's forward at bf16 wrote another dtype than bf16")
            results["trainable_trio_bf16"].append(compare(
                "trio_forward_with_acts", shape + " out+acts",
                lambda: (lambda o: (o[0], *flat_acts(o[1])))(
                    trio_forward_with_acts(x, blocks, slope=slope, tier=tier)),
                lambda: (lambda o: (o[0], *flat_acts(o[1])))(
                    trio_forward_with_acts_reference(x, blocks, slope=slope)),
                grad_rtol=BF16_GRAD_RTOL,
                work=(fwd_flops, nbytes(x, *pair_weights(blocks)) + nbytes(x) * (1 + n_acts)),
                peak=PEAK_BF16_FLOPS))
            o, a = trio_forward_with_acts(x, blocks, slope=slope, tier=tier)
            o_ref, a_ref = trio_forward_with_acts_reference(x, blocks, slope=slope)
            o32, a32 = trio_forward_with_acts_reference(x.float(), fp32_blocks(blocks),
                                                        slope=slope)
            results["trainable_trio_bf16"][-1]["rounding"] = rounding_control(
                "trio_forward_with_acts", (o, *flat_acts(a)), (o_ref, *flat_acts(a_ref)),
                [t.to(bf) for t in (o32, *flat_acts(a32))])
            saved = flat_acts(a_ref)
            weights = pair_weights(blocks)
            results["trainable_trio_bf16"].append(compare(
                "trio_backward", shape + " bwd vs its plain twin",
                lambda: (lambda r: (r[0], *r[1]))(
                    trio_backward(g, x, blocks, saved, slope=slope, tier=tier)),
                lambda: (lambda r: (r[0], *r[1]))(
                    trio_backward_reference(g, x, blocks, saved, slope=slope)),
                grad_rtol=BF16_GRAD_RTOL,
                work=(2 * fwd_flops, nbytes(x, g, *saved, *weights) + nbytes(x, *weights)),
                peak=PEAK_BF16_FLOPS))
            dx, dw = trio_backward(g, x, blocks, saved, slope=slope, tier=tier)
            dx_ref, dw_ref = trio_backward_reference(g, x, blocks, saved, slope=slope)
            dx32, dw32 = trio_backward_reference(g.float(), x.float(), fp32_blocks(blocks),
                                                 [t.float() for t in saved], slope=slope)
            results["trainable_trio_bf16"][-1]["rounding"] = rounding_control(
                "trio_backward", (dx, *dw), (dx_ref, *dw_ref),
                [t.to(bf) for t in (dx32, *dw32)])
    return results


# The training kernels' C entry points, and whether a call's arguments say bf16 storage:
# A's and 4's bf16 flag, kernel 5's forward conv (vk_conv_bf16; B's fp32 vk_conv is not)
# and its backward's mode (1: the fast tier on bf16).
BF16_CALLS = {"vk_rel_attention": lambda a: a[14] == 1,
              "vk_rel_attention_bwd": lambda a: a[20] == 1,
              "vk_conv_bf16": lambda a: True, "vk_conv": lambda a: False,
              "vk_trio_backward": lambda a: a[7] == 1}


def record_bf16_calls(seen: list) -> list:
    """Route the kernel library's training entry points through a recorder that
    appends (name, bf16 storage?) per call; returns what to restore."""
    from vits_tpu_torch.ops.cuda import library

    lib = library()
    restore = []
    for name, is_bf16 in BF16_CALLS.items():
        original = getattr(lib, name)

        def call(*args, _name=name, _original=original, _is_bf16=is_bf16):
            seen.append((_name, bool(_is_bf16(args))))
            return _original(*args)
        setattr(lib, name, call)
        restore.append((lib, name, original))
    return restore


def bf16_vs_fp32_steps(config, device, card: str) -> dict:
    """Phase 10b: GAN steps at bf16 and at fp32 from the same weights, on the same
    batch and noise: steady ms, busy ms, idle share and peak memory; master
    parameters fp32 and moved; the launches of the bf16 steps, each kernel call
    on bf16 tensors; the gradients of one bf16 generator loss against fp32 by
    cosine, held over all and per module for COSINE_MODULES, printed for the
    other modules and per tensor."""
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.ops.cuda.trio_grad import trio_backward, trio_forward_with_acts
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import (
        draw_noise,
        generator_forward,
        gradients,
        make_gan_train_step,
    )

    initial = {k: torch.as_tensor(v) for k, v in
               random_weights(config, keep_training=True).items()}
    disc_np = init_discriminator_params(0)
    batch = training_batch(config, device)
    noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(7))
    wrappers = (flash_rel_attention, rel_attention_bwd, trio_forward_with_acts, trio_backward)
    runs = {}
    for dtype in ("bfloat16", "float32"):
        gen = {k: v.requires_grad_() for k, v in from_jax_params(initial, device).items()}
        disc = {k: v.requires_grad_() for k, v in
                from_jax_params(disc_np, device).items()}
        before = {k: p.detach().clone() for k, p in gen.items()}
        step_fn = make_gan_train_step(config, gen, disc, vits_optimizer(gen),
                                      vits_optimizer(disc), compute_dtype=dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step_fn(batch, noise=noise)  # warm-up
        torch.cuda.synchronize()
        seen: list = []
        restore = record_bf16_calls(seen)
        for fn in wrappers:
            fn.launches = 0
        times = []
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                metrics = step_fn(batch, noise=noise)
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t0))
        finally:
            for lib, name, fn in restore:
                setattr(lib, name, fn)
        launches = {fn.__name__: fn.launches for fn in wrappers}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        values = {k: float(v) for k, v in metrics._asdict().items()}
        if not all(np.isfinite(v) for v in values.values()):
            raise RuntimeError(f"{dtype} GAN step: non-finite loss {values}")
        for name, p in {**gen, **disc}.items():
            if p.dtype != torch.float32 or p.grad is None or p.grad.dtype != torch.float32:
                raise RuntimeError(f"{dtype} step: master parameter {name} or its grad not fp32")
        if not all(not torch.equal(p.detach(), before[k]) for k, p in gen.items()):
            raise RuntimeError(f"{dtype} step: a generator parameter did not move")
        if dtype == "bfloat16":
            if not seen or not all(ok for _, ok in seen):
                bad = sorted({name for name, ok in seen if not ok})
                raise RuntimeError(f"bf16 steps: kernel calls without bf16 storage: {bad}")
            print(f"  bf16 steps: all {len(seen)} kernel calls on bf16 storage "
                  f"({sorted({name for name, _ in seen})})", flush=True)
            if any(n == 0 for n in launches.values()):
                raise RuntimeError(f"bf16 steps: a training kernel never launched {launches}")
        steady = float(np.median(times))
        wall_ms, device_events, busy_ms = profiled(lambda: step_fn(batch, noise=noise))
        families = by_family(device_events, KERNEL_FAMILIES)
        runs[dtype] = {"step_ms": times, "steady_ms": steady, "busy_ms": busy_ms,
                       "idle_share": 1.0 - busy_ms / steady, "peak_gib": peak_gib,
                       "launches": launches,
                       "launches_per_step": {k: v / 3 for k, v in launches.items()},
                       "families_ms": {k: v[0] for k, v in families.items()},
                       "losses": values}
        print(f"  {dtype} GAN step: steady {steady:.1f} ms (steps {[round(t, 1) for t in times]}),"
              f" device busy {busy_ms:.1f} ms, idle share {1.0 - busy_ms / steady:.3f}, peak "
              f"{peak_gib:.2f} GiB allocated; launches per step {runs[dtype]['launches_per_step']}"
              f"; master params fp32 and moved ({card})", flush=True)
        for family, (ms, n) in sorted(families.items(), key=lambda kv: -kv[1][0]):
            print(f"    {family:24s} {ms:8.2f} ms  {n:6d} launches", flush=True)
        del gen, disc, step_fn
        torch.cuda.empty_cache()

    # gradients of one generator loss at the initial weights, bf16 against fp32: over all,
    # and per module for COSINE_MODULES (per tensor only reported)
    grads, outs = {}, {}
    for dtype in ("float32", "bfloat16"):
        gen = {k: v.requires_grad_() for k, v in from_jax_params(initial, device).items()}
        out = generator_forward(gen, config, batch, noise, compute_dtype=dtype)
        grads[dtype] = dict(zip(gen, (g.detach().double() for g in gradients(out.loss, gen))))
        outs[dtype] = out.durations.detach()
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))  # noqa: E731
    total = cos(torch.cat([g.flatten() for g in grads["bfloat16"].values()]),
                torch.cat([g.flatten() for g in grads["float32"].values()]))
    modules: dict = {}
    for name in grads["float32"]:
        modules.setdefault(name.split(".")[0], []).append(name)
    worst, per_module = [], {}
    for module, names in modules.items():
        a, b = (torch.cat([grads[dt][n].flatten() for n in names])
                for dt in ("bfloat16", "float32"))
        per_module[module] = cos(a, b)
        norm = float(b.norm())
        for n in names:  # tensors whose fp32 gradient is rounding noise (exact 0) aside
            ref = grads["float32"][n]
            if float(ref.norm()) > 1e-6 * norm:
                worst.append((cos(grads["bfloat16"][n].flatten(), ref.flatten()), n))
    worst.sort()
    same_durations = bool(torch.equal(outs["bfloat16"], outs["float32"]))
    print(f"  bf16 vs fp32 gradients: cosine {total:.5f} over all, bound {BF16_COSINE} over all "
          f"and for {', '.join(COSINE_MODULES)}; per module " + ", ".join(f"{m} {c:.4f}" for m, c in per_module.items())
          + f"; median tensor {float(np.median([c for c, _ in worst])):.4f}, lowest "
          f"{[(n, round(c, 4)) for c, n in worst[:3]]}; MAS durations "
          f"{'equal' if same_durations else 'differ'}", flush=True)
    off = {m: c for m, c in per_module.items() if m in COSINE_MODULES and not c >= BF16_COSINE}
    if not total >= BF16_COSINE:
        off["all"] = total
    if off:
        raise RuntimeError(f"bf16 gradients off the fp32 ones past cosine {BF16_COSINE}: {off}")
    return {**runs, "cosine": total, "cosine_per_module": per_module,
            "median_tensor_cosine": float(np.median([c for c, _ in worst])),
            "lowest_tensor_cosines": worst[:5], "same_durations": same_durations, "card": card}


def speaker_gan_step(device, card: str) -> None:
    """Phase 10c: a speaker-conditioned GAN step at VCTK width (109 speakers): losses
    finite and the kernels launched; then its generator loss and gradients on the
    card against the CPU's plain path (phase 7's noise-floor bounds), embed_speaker
    included."""
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import make_gan_train_step

    config = VitsConfig(**VCTK)
    initial = random_weights(config, keep_training=True)
    gen = {k: v.requires_grad_() for k, v in from_jax_params(initial, device).items()}
    disc = {k: v.requires_grad_() for k, v in
            from_jax_params(init_discriminator_params(0), device).items()}
    batch = training_batch(config, device, frame_lengths=(480, 320))
    batch = batch._replace(speaker_id=torch.tensor([108, 17], device=device))
    step_fn = make_gan_train_step(config, gen, disc, vits_optimizer(gen), vits_optimizer(disc))
    t0 = time.perf_counter()
    metrics = step_fn(batch, torch.Generator(device=device).manual_seed(3))
    torch.cuda.synchronize()
    values = {k: float(v) for k, v in metrics._asdict().items()}
    if not all(np.isfinite(v) for v in values.values()):
        raise RuntimeError(f"speaker GAN step: non-finite loss {values}")
    emb_grad = gen["embed_speaker.weight"].grad
    if not (bool((emb_grad[[108, 17]].abs().sum(dim=1) > 0).all())
            and float(emb_grad[0].abs().sum()) == 0.0):
        raise RuntimeError("speaker GAN step: embed_speaker's gradient not on the batch's rows")
    print(f"  speaker GAN step (speakers 108, 17; 512/300 tokens, 480/320 frames): "
          f"{1e3 * (time.perf_counter() - t0):.1f} ms, " + " ".join(
              f"{k}={v:.4g}" for k, v in values.items()) + f"; embed_speaker rows 108, 17 "
          f"have gradient, row 0 none ({card})", flush=True)
    train_card_vs_cpu(config, {k: v.requires_grad_() for k, v in
                               from_jax_params(initial, device).items()}, batch)


def reuse_forward_on_card(config, device) -> None:
    """Phase 10d: the two-forward GAN step (reuse_forward=False) against the single
    forward on the card, the CPU test's bounds (losses, and every parameter after
    one AdamW step); cuDNN pinned to deterministic algorithms for the comparison."""
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.train.step import draw_noise, make_gan_train_step

    initial = random_weights(config, keep_training=True)
    disc_np = init_discriminator_params(0)
    batch = training_batch(config, device)
    noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(9))
    results = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for reuse in (True, False):
            gen = {k: v.requires_grad_() for k, v in from_jax_params(initial, device).items()}
            disc = {k: v.requires_grad_() for k, v in from_jax_params(disc_np, device).items()}
            step_fn = make_gan_train_step(
                config, gen, disc, torch.optim.AdamW(list(gen.values()), 2e-4),
                torch.optim.AdamW(list(disc.values()), 2e-4), reuse_forward=reuse)
            t0 = time.perf_counter()
            metrics = step_fn(batch, noise=noise)
            torch.cuda.synchronize()
            results.append((metrics, gen, disc, 1e3 * (time.perf_counter() - t0)))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (m_a, g_a, d_a, ms_a), (m_b, g_b, d_b, ms_b) = results
    worst_loss = max(abs(float(getattr(m_b, n)) - float(getattr(m_a, n)))
                     / max(abs(float(getattr(m_a, n))), 1e-30) for n in m_a._fields)
    worst_param = 0.0
    for a, b in ((g_a, g_b), (d_a, d_b)):
        for name in a:
            diff = (b[name] - a[name]).detach().abs()
            bound = REUSE_PARAM_ATOL + REUSE_PARAM_RTOL * a[name].detach().abs()
            worst_param = max(worst_param, float((diff / bound).max()))
    print(f"  reuse_forward=False vs True: {ms_b:.1f} vs {ms_a:.1f} ms (first steps); worst "
          f"loss relative difference {worst_loss:.2e} (bound {REUSE_LOSS_RTOL}), worst "
          f"parameter at {worst_param:.3f} of its bound (rtol {REUSE_PARAM_RTOL}, atol "
          f"{REUSE_PARAM_ATOL})", flush=True)
    if not worst_loss <= REUSE_LOSS_RTOL or not worst_param <= 1.0:
        raise RuntimeError("reuse_forward=False and True differ past the CPU test's bounds")


def train_cli_bf16(card: str) -> None:
    """Phase 10e: ``python -m vits_tpu_torch.train.loop --dtype bfloat16`` (its default
    device, the card) on the synthetic micro-corpus at MMS width: 2 steps in a
    process of its own (a checkpoint at the last), then the same ``main`` in this
    process resumed to 3 (a second process would repeat ~30 s of start-up)."""
    import contextlib
    import tempfile

    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml
    from vits_tpu_torch.train import loop
    from vits_tpu_torch.train.data import corpus_vocab, generate_micro_corpus

    config = VitsConfig()
    with tempfile.TemporaryDirectory() as tmp:
        corpus, model, out_dir = f"{tmp}/corpus", f"{tmp}/model.ggml", f"{tmp}/run"
        generate_micro_corpus(corpus, n_utts=16)
        export_to_ggml(model, config, VitsTokenizer(vocab=corpus_vocab(), pad_token="_",
                                                    unk_token="?"),
                       random_weights(config, keep_training=True), fp16_convs=False)
        args = ["--corpus", corpus, "--model", model, "--out", out_dir, "--dtype", "bfloat16",
                "--batch-size", "4", "--steps"]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vits_tpu_torch.train.loop", *args, "2"],
                              capture_output=True, text=True, timeout=600, check=False,
                              cwd=str(Path(__file__).resolve().parent))
        for line in proc.stdout.splitlines():
            print(f"    {line}", flush=True)
        if proc.returncode != 0:
            raise RuntimeError(f"train.loop --dtype bfloat16 failed ({proc.returncode}):\n"
                               f"{proc.stderr[-3000:]}")
        print(f"  train.loop --dtype bfloat16 --steps 2: {time.perf_counter() - t0:.1f} s wall "
              f"({card})", flush=True)
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = loop.main([*args, "3"])
        lines = out.getvalue().splitlines()
        for line in lines:
            print(f"    {line}", flush=True)
        print(f"  train.loop's main --steps 3 in this process: {time.perf_counter() - t0:.1f} s "
              f"wall ({card})", flush=True)
        expected = ("resumed from step 2", "restored EMA weights", "checkpointed step 3")
        if code != 0 or not all(e in lines for e in expected):
            raise RuntimeError(f"the bf16 loop's resume to step 3 did not run as expected "
                               f"(exit {code}): {lines}")


TIERS_FLAG = "--tiers-phase"  # the child's argument
TIERS_RESULT = "tiers-phase result: "  # the prefix of the child's result line


def tiers_phase(device) -> dict:
    """Phase 9's work (a child of :func:`run_child`)."""
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.flow import fused_flow
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage

    card = card_line()
    kernels.library()
    wrappers = (flash_rel_attention, fused_resblock_trio, fused_stage, fused_flow,
                fused_resblock)
    model = make_model(device, engine_config=exact_engine())
    vctk = make_model(device, VitsConfig(**VCTK), exact_engine(use_pallas_flow=True))
    narrow = make_model(device, VitsConfig(upsample_initial_channel=128), exact_engine())
    measured = tier_kernels_vs_plain(model, vctk, narrow, device)
    del model, vctk, narrow
    return {"kernels": measured, "requests": tier_requests(device, card, wrappers),
            "cli": default_cli_run(card, wrappers), "profiler_sessions": PROFILER_SESSIONS}


TRAINING_FLAG = "--bf16-training-phase"
TRAINING_RESULT = "bf16-training-phase result: "


def bf16_training_phase(device) -> dict:
    """Phase 10's work (a child of :func:`run_child`)."""
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.io.params import from_jax_params
    from vits_tpu_torch.ops import cuda as kernels

    card = card_line()
    kernels.library()
    config = VitsConfig()
    t0 = time.perf_counter()
    measured = bf16_kernels_vs_plain(from_jax_params(random_weights(config), device),
                                     config, device)
    run = bf16_vs_fp32_steps(config, device, card)
    speaker_gan_step(device, card)
    reuse_forward_on_card(config, device)
    train_cli_bf16(card)
    print(f"  phase 10: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": measured, "run": run, "profiler_sessions": PROFILER_SESSIONS}


# --------------------------------------------------------------------------- #
# Phase 11: bf16 serving (EngineConfig(compute_dtype="bfloat16"), ops/tiers.py::
# Tiers.bf16_compute), in a process of its own as phases 9 and 10.
# --------------------------------------------------------------------------- #

# B, C and 7 compute XLA's bf16 graph, rounding to bf16 after every step; their twins
# compute it in bf16 PyTorch ops on the card (cuDNN's and cuBLAS's sums in other
# orders: a rounded step may land an ulp away and travel), held by relative L2 error
# per output (BF16_GRAD_RTOL); A and 6 stage fp32 on bf16 inputs and round their
# output once, held within two bf16 ulps of the twin at the same tier.
SERVE16_KERNELS = ("flash_rel_attention", "fused_resblock_trio", "fused_stage", "fused_flow",
                   "fused_resblock")
# A batch row (or a stream) against its solo run (one-shot decode) at bf16: the plain
# glue's and the kernels' sums run in another order per shape, and bf16 rounding
# turns that into bf16-level differences; held by mel-L1 as the fast tier's stream.
BF16_ROW_MEL_L1 = FAST_STREAM_MEL_L1
# The bf16 duration predictor is chaotic: its spline's root solve in bf16 turns a
# one-ulp difference of its input into up to ~0.5 of log duration (the JAX package's
# own jitted and eager bf16 engines differ by 0.35 on the fixture). On the card
# cuBLAS and cuDNN sum in other orders than the CPU, and 0.02-0.03% of a bf16
# matmul's or conv's outputs land one ulp away (scripts/torch_bf16_spread.py), so
# card and CPU, or a batch row and its solo run, predict different frame counts on
# some texts. Those
# are held within DURATION_RTOL of each other in total (the JAX package's bound for
# a precision variant's durations, tests/test_precision_variants.py), the text
# encoder by relative L2 (BF16_GRAD_RTOL), and the decode on one prior: the card's
# flow and vocoder on the CPU's prior against the CPU's, by mel-L1.
DURATION_RTOL = 0.1


def serve16_kernels_vs_plain(model, vctk, narrow, device) -> dict:
    """Phase 11a: each kernel's bf16 serving mode against its plain twin on the card
    at phase 3's shapes (320 frames; bf16 activations and the engines' bf16
    parameters): B at MMS stages 0-1, C at 2-3, 7 at HiFi-GAN V2's stage 0 (C=64,
    k=11), A at L=512 at each tier, 6 at VCTK width (B=1, speaker 17, the fast
    tier); the bound at the bf16 rate (989 TFLOP/s; A and 6 at their tier's
    rate), 2 bytes an entry."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.hifigan import _stage_resblocks
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_plain
    from vits_tpu_torch.ops.cuda.flow import (
        flow_compute16_reference,
        fused_flow,
        pack_flow_weights,
    )
    from vits_tpu_torch.ops.cuda.resblock import (
        fused_resblock,
        fused_resblock_trio,
        pair_weights,
        resblock_reference,
        resblock_trio_reference,
    )
    from vits_tpu_torch.ops.cuda.stage import fused_stage, stage_reference
    from vits_tpu_torch.ops.tiers import BF16_COMPUTE_TIER as tier
    from vits_tpu_torch.ops.tiers import Tier, resolve_tier

    bf = torch.bfloat16
    rng = np.random.default_rng(11)
    config, decoder = model.config, ParamView(model.params).sub("decoder")
    slope, frames = config.leaky_relu_slope, 320
    out = {name + "_bf16_serve": [] for name in SERVE16_KERNELS}

    def activ(T, C, length, B=1):
        x = torch.tensor(rng.standard_normal((B, T, C)), dtype=torch.float32, device=device)
        x[:, length:] = 0.0
        return x.to(bf), torch.tensor([length] * B, dtype=torch.int32, device=device)

    for i, T in ((0, 8 * frames), (1, 64 * frames)):  # B: MMS stages 0 and 1
        C = decoder[f"upsampler.{i}.weight"].shape[2]
        x, lens = activ(T, C, T - 37)
        blocks = _stage_resblocks(decoder, config, i)
        out["fused_resblock_trio_bf16_serve"].append(compare(
            "fused_resblock_trio", f"bf16 serving C={C} T={T}",
            lambda: fused_resblock_trio(x, blocks, slope=slope, lengths=lens, tier=tier),
            lambda: resblock_trio_reference(x, blocks, slope=slope, lengths=lens, tier=tier),
            grad_rtol=BF16_GRAD_RTOL,
            work=(resblocks_flops(steps_of(x, lens), C, blocks),
                  nbytes(x, x, lens, *pair_weights(blocks))), peak=PEAK_BF16_FLOPS))
    for i, T_in in ((2, 64 * frames), (3, 128 * frames)):  # C: MMS stages 2 and 3
        up_w, up_b = decoder[f"upsampler.{i}.weight"], decoder[f"upsampler.{i}.bias"]
        (k_up, c_in, c_out), rate = up_w.shape, config.upsample_rates[i]
        final = i == len(config.upsample_rates) - 1
        x, lens = activ(T_in, c_in, T_in - 37)
        blocks = _stage_resblocks(decoder, config, i)
        w_post = decoder["conv_post.weight"]
        kw = dict(stride=rate, up_padding=(config.upsample_kernel_sizes[i] - rate) // 2,
                  slope=slope, lengths=lens, tier=tier, final_conv=(w_post, 3) if final else None)
        steps = steps_of(x, lens)
        flops = conv_flops(steps, k_up, c_in, c_out) + resblocks_flops(steps * rate, c_out,
                                                                       blocks)
        weights = [up_w, up_b, *pair_weights(blocks)] + ([w_post] if final else [])
        if final:
            flops += conv_flops(steps * rate, w_post.shape[0], c_out, 1)
        out_bytes = 2 * (1 if final else c_out) * x.shape[1] * rate
        out["fused_stage_bf16_serve"].append(compare(
            "fused_stage", f"bf16 serving {c_in}->{c_out} T_in={T_in}"
            + (" +conv_post" if final else ""),
            lambda: fused_stage(x, up_w, up_b, blocks, **kw),
            lambda: stage_reference(x, up_w, up_b, blocks, **kw),
            grad_rtol=BF16_GRAD_RTOL, work=(flops, nbytes(x, lens, *weights) + out_bytes),
            peak=PEAK_BF16_FLOPS))
    ndecoder = ParamView(narrow.params).sub("decoder")
    nblk = _stage_resblocks(ndecoder, narrow.config, 0)[-1]  # C=64, k=11
    nx, nlens = activ(8 * frames, 64, 8 * frames - 37, B=2)
    nlens[1] = 0
    nx[1] = 0.0
    out["fused_resblock_bf16_serve"].append(compare(
        "fused_resblock", f"bf16 serving C=64 B=2 T={8 * frames} k=11 (HiFi-GAN V2 stage 0)",
        lambda: fused_resblock(nx, nblk, slope=slope, lengths=nlens, tier=tier),
        lambda: resblock_reference(nx, nblk, slope=slope, lengths=nlens, tier=tier),
        grad_rtol=BF16_GRAD_RTOL,
        work=(resblocks_flops(steps_of(nx, nlens), 64, [nblk]),
              nbytes(nx, nx, nlens, *pair_weights([nblk]))), peak=PEAK_BF16_FLOPS))
    layer = ParamView(model.params).sub("text_encoder.encoder.layers.0.attention")
    heads, d, w, L = config.num_attention_heads, config.head_dim, config.window_size, 512
    q, k, v = (torch.tensor(rng.standard_normal((2, heads, L, d)) * 0.5,
                            device=device).to(bf) for _ in range(3))
    rel = (layer["emb_rel_k"][0], layer["emb_rel_v"][0])
    alens = torch.tensor([L - 5, 0], dtype=torch.int32, device=device)
    for name in ("fast", "high", "highest"):
        mode = resolve_tier(None if name == "fast" else name).mode
        out["flash_rel_attention_bf16_serve"].append(compare(
            "flash_rel_attention", f"bf16 serving {name} B=2 L={L} len=({L - 5},0)",
            lambda: flash_rel_attention(q, k, v, *rel, window=w, lengths=alens,
                                        tier=Tier(mode, False, True)),
            lambda: rel_attention_plain(q, k, v, *rel, window=w, lengths=alens,
                                        tier=Tier(mode)),
            work=(attention_flops((L - 5, 0), heads, d, w), nbytes(q, k, v, q, *rel, alens)),
            tol=BF16_KERNEL_TOL, peak=TIER_PEAK[name]))
    vconfig, vp = vctk.config, ParamView(vctk.params)
    packed = pack_flow_weights(vp, vconfig)
    half, hidden = vconfig.flow_size // 2, vconfig.hidden_size
    nl, kw_, n = (vconfig.prior_encoder_num_wavenet_layers, vconfig.wavenet_kernel_size,
                  vconfig.prior_encoder_num_flows)
    per_frame = 2 * (half * hidden + nl * kw_ * hidden * 2 * hidden
                     + (nl - 1) * hidden * 2 * hidden + hidden * hidden + hidden * half)
    fx = torch.tensor(rng.standard_normal((1, frames, vconfig.flow_size)),
                      device=device).to(bf)
    flens = torch.tensor([frames], dtype=torch.int32, device=device)
    spk = vp["embed_speaker.weight"][17][None, None, :].contiguous()
    ftier = vctk.tiers.flow
    out["fused_flow_bf16_serve"].append(compare(
        "fused_flow", f"bf16 serving fast B=1 T={frames} speaker 17 (VCTK width)",
        lambda: fused_flow(fx, vp, vconfig, lengths=flens, speaker_embeddings=spk,
                           packed=packed, tier=ftier),
        lambda: flow_compute16_reference(fx, packed, vp, vconfig, lengths=flens,
                                         speaker_embeddings=spk, tier=ftier),
        work=(n * per_frame * frames, nbytes(fx, fx, flens, spk) + 2 * packed.buffer.numel()),
        tol=BF16_KERNEL_TOL, peak=TIER_PEAK["fast"]))
    return out


def serve16_requests(device, card: str, wrappers) -> dict:
    """Phase 11b: the bf16 engines' main path. MMS: warmup, the 87-token request's
    profile beside the fast tier's (fp32 engine) in this process, every kernel
    launched; its frame counts on one NoiseOverride equal to the CPU's plain bf16
    path; a batch of three whose rows match their solo runs; a stream against its
    one-shot decode; the flow and vocoder at the exact tier's durations, by mel-L1
    against exact. VCTK with use_pallas_flow: a request of speaker 17 through
    kernels A, B, C and 6 and a conversion 0 -> 17. HiFi-GAN V2's decoder: a
    request through kernels 7 and C. Each path's counts set to 0 just before it."""
    from vits_tpu_torch import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.streaming import StreamingDecoder
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.encoder import text_encoder
    from vits_tpu_torch.models.hifigan import hifigan
    from vits_tpu_torch.models.vits import NoiseOverride, latents_from_prior, text_to_prior

    bf = torch.bfloat16
    engine16 = EngineConfig(compute_dtype="bfloat16")
    model = make_model(device, engine_config=engine16)
    fast = make_model(device)  # EngineConfig(): the fast tier, fp32 engine
    if model.compute_dtype != bf or model._vocoder_packs():
        raise RuntimeError("the bf16 engine is not bf16 or made vocoder packs")
    results, launches = {}, {}

    def path(name, fn):
        for w in wrappers:
            w.launches = 0
        value = fn()
        launches[name] = {w.__name__: w.launches for w in wrappers}
        print(f"    {name} launches {launches[name]}", flush=True)
        return value

    results["warmup"] = path("warmup", lambda: warm(model, card)["seconds"])
    results["fast_request"] = request_profile(fast, card)
    results["bf16_request"] = path("bf16_request", lambda: request_profile(model, card))
    for name in ("flash_rel_attention", "fused_resblock_trio", "fused_stage"):
        if launches["bf16_request"][name] == 0:
            raise RuntimeError(f"the bf16 request never launched {name}")
    print(f"  87-token request: bf16 busy {results['bf16_request']['device_busy_ms']:.2f} ms, "
          f"steady {results['bf16_request']['steady_ms']:.1f} ms wall; fast (fp32 engine) busy "
          f"{results['fast_request']['device_busy_ms']:.2f} ms, steady "
          f"{results['fast_request']['steady_ms']:.1f} ms ({card})", flush=True)

    # card vs the CPU's plain bf16 path (the same tiers' twins) on one NoiseOverride
    tok, config = model.tokenizer, model.config
    ids, mask = tok.pad([tok.encode(SINGLE_TEXTS[1])], pad_to=128)
    rng = np.random.default_rng(2)
    num_frames = 1024
    dur = torch.tensor(rng.standard_normal((1, 128, 2)), dtype=torch.float32).to(bf)
    prior_noise = torch.tensor(rng.standard_normal((1, num_frames, config.flow_size)),
                               dtype=torch.float32).to(bf)
    cpu_params = {k: v.cpu() for k, v in model.params.items()}
    outs = {}
    for dev, params in ((device, model.params), ("cpu", cpu_params)):
        with torch.inference_mode():
            ids_d = torch.tensor(ids, dtype=torch.long, device=dev)
            mask_d = torch.tensor(mask, device=dev).to(bf)
            enc = text_encoder(ParamView(params), config, ids_d, mask_d[..., None],
                               tier=model.tiers.attention)
            prior = text_to_prior(params, config, ids_d, mask_d, num_frames,
                                  noise=NoiseOverride(dur.to(dev), prior_noise.to(dev)),
                                  attention_tier=model.tiers.attention)
        outs[str(dev)] = {"hidden": enc.last_hidden_state, "prior": prior}
    gpu, cpu = outs[str(device)], outs["cpu"]
    hidden_rel = float((gpu["hidden"].float().cpu() - cpu["hidden"].float()).norm()
                       / cpu["hidden"].float().norm())
    frames = [int(min(o["prior"].total_duration[0], num_frames)) for o in (gpu, cpu)]
    ld_err = float((gpu["prior"].log_duration.float().cpu()
                    - cpu["prior"].log_duration.float()).abs().max())
    # the decode on the CPU's prior, card against CPU
    waves = {}
    for dev, params in ((device, model.params), ("cpu", cpu_params)):
        p = cpu["prior"]
        mask3 = p.frame_mask[..., None].to(dev)
        with torch.inference_mode():
            lat = latents_from_prior(params, config, p.prior_latents.to(dev), mask3,
                                     tier=model.tiers.flow)
            wave = hifigan(ParamView(params), config, lat, mask3, tiers=model.tiers)
        waves[str(dev)] = wave[0, : frames[1] * config.total_upsample].float().cpu().numpy()
    check_audio(waves[str(device)], "bf16 decode of the CPU's prior")
    wave_mel = mel_l1(waves[str(device)][None], waves["cpu"][None], config.sampling_rate)
    print(f"  card vs CPU plain bf16 path: text encoder rel L2 {hidden_rel:.3e} (bound "
          f"{BF16_GRAD_RTOL}), log_duration max|diff| {ld_err:.3e}, frames {frames[0]} / "
          f"{frames[1]} (bound {DURATION_RTOL} relative); decode of the CPU's prior mel-L1 "
          f"{wave_mel:.3e} (bound {BF16_ROW_MEL_L1}) ({card})", flush=True)
    if not hidden_rel <= BF16_GRAD_RTOL:
        raise RuntimeError(f"bf16: the card's text encoder is off the CPU's by {hidden_rel}")
    if not abs(frames[0] - frames[1]) <= DURATION_RTOL * frames[1]:
        raise RuntimeError(f"bf16: card and CPU frame counts {frames} differ past the bound")
    if not wave_mel <= BF16_ROW_MEL_L1:
        raise RuntimeError(f"bf16: the card's decode is off the CPU's by mel-L1 {wave_mel}")
    results["card_vs_cpu"] = {"frames": frames, "frames_equal": frames[0] == frames[1],
                              "text_encoder_rel_l2": hidden_rel,
                              "log_duration_max_abs": ld_err, "decode_mel_l1": wave_mel}

    # a batch of three against solo runs
    def batch():
        return model.synthesize_raw(list(BATCH_TEXTS), seed=list(BATCH_SEEDS))
    out = path("bf16_batch", batch)
    rows = []
    solo_frames = []
    for r, (text, seed) in enumerate(zip(BATCH_TEXTS, BATCH_SEEDS)):
        solo = model.synthesize_raw([text], seed=[seed])
        a, b = int(out.frame_lengths[r]), int(solo.frame_lengths[0])
        solo_frames.append(b)
        if not abs(a - b) <= DURATION_RTOL * b:
            raise RuntimeError(f"bf16 batch row {r}: {a} frames, solo {b}")
        m = min(out.lengths[r], solo.lengths[0])
        check_audio(out.waveform[r, :out.lengths[r]], f"bf16 batch row {r}")
        if a == b:  # equal durations: the same audio up to bf16 rounding
            rows.append(mel_l1(out.waveform[r:r + 1, :m], solo.waveform[:, :m],
                               config.sampling_rate))
    print(f"  batch of 3 at bf16: frames {out.frame_lengths[:3].tolist()}, solo "
          f"{solo_frames} (bound {DURATION_RTOL} relative); mel-L1 of the rows with equal "
          f"frames {[f'{v:.2e}' for v in rows]} (bound {BF16_ROW_MEL_L1})", flush=True)
    if rows and not max(rows) <= BF16_ROW_MEL_L1:
        raise RuntimeError(f"bf16 batch rows differ from their solo runs: {rows}")
    results["batch"] = {"frames": out.frame_lengths[:3].tolist(), "solo_frames": solo_frames,
                        "rows_mel_l1": rows}

    # a stream against its one-shot decode, at one frame capacity
    streaming = make_model(device, engine_config=EngineConfig(
        compute_dtype="bfloat16", transfer_int16=False, adaptive_capacity=False))
    streamer = StreamingDecoder(streaming)
    streamer.warmup(token_buckets=streaming.engine.token_buckets[:2])
    t0 = time.perf_counter()
    streamed = path("bf16_stream", lambda: streamer.synthesize_streaming(SINGLE_TEXTS[1],
                                                                         seed=4))
    stream_s = time.perf_counter() - t0
    oneshot = streaming.synthesize(SINGLE_TEXTS[1], seed=4)
    if streamed.shape != oneshot.shape or streamed.dtype != np.float32:
        raise RuntimeError(f"bf16 stream of {streamed.shape}, one-shot {oneshot.shape}")
    stream_mel = mel_l1(streamed[None], oneshot[None], config.sampling_rate)
    print(f"  bf16 stream vs its one-shot decode: {streamed.shape[0]} samples in "
          f"{stream_s:.2f} s, mel-L1 {stream_mel:.3e} (bound {BF16_ROW_MEL_L1}) ({card})",
          flush=True)
    if not stream_mel <= BF16_ROW_MEL_L1:
        raise RuntimeError(f"bf16 stream differs from its one-shot decode: {stream_mel}")
    results["stream"] = {"mel_l1": stream_mel, "seconds": stream_s}
    del streaming, streamer

    # the flow and vocoder at the exact tier's durations: mel-L1 against exact
    exact = make_model(device, engine_config=exact_engine())
    noise = NoiseOverride(dur.float().to(device), prior_noise.float().to(device))
    ids_t = torch.tensor(ids, dtype=torch.long, device=device)
    with torch.inference_mode():
        prior = text_to_prior(exact.params, config, ids_t,
                              torch.tensor(mask, device=device), num_frames, noise=noise,
                              attention_tier=exact.tiers.attention)
    frames = min(int(prior.total_duration[0]), num_frames)
    waves = {}
    for label, m in (("exact", exact), ("bfloat16", model)):
        mask3 = prior.frame_mask[..., None].to(m.compute_dtype)
        with torch.inference_mode():
            lat = latents_from_prior(m.params, config, prior.prior_latents.to(m.compute_dtype),
                                     mask3, tier=m.tiers.flow)
            wave = hifigan(ParamView(m.params), config, lat, mask3, tiers=m.tiers)
        waves[label] = wave[0, : frames * config.total_upsample].float().cpu().numpy()
    check_audio(waves["bfloat16"], "bf16 at the exact tier's durations")
    mel = mel_l1(waves["bfloat16"][None], waves["exact"][None], config.sampling_rate)
    print(f"  bf16 at exact's {frames} frames: mel-L1 vs exact {mel:.3e} ({card})", flush=True)
    results["mel_l1_vs_exact"] = mel
    del exact

    # VCTK with the flow kernel: a request of speaker 17, a conversion 0 -> 17
    vctk = make_model(device, VitsConfig(**VCTK), EngineConfig(
        compute_dtype="bfloat16", use_pallas_flow=True), keep_training=True)
    warm(vctk, card)

    def vctk_path():
        audio = vctk.synthesize(SINGLE_TEXTS[1], seed=3, speaker_id=17)
        converted = vctk.convert_voice(audio, source_speaker=0, target_speaker=17)
        return audio, converted
    audio, converted = path("bf16_vctk", vctk_path)
    check_audio(audio, "bf16 VCTK request")
    check_audio(converted, "bf16 voice conversion")
    if converted.shape != audio.shape or launches["bf16_vctk"]["fused_flow"] == 0:
        raise RuntimeError("bf16 VCTK: conversion of another length, or kernel 6 not run")
    print(f"  VCTK at bf16: speaker 17 {audio.shape[0]} samples, conversion 0 -> 17 "
          f"{converted.shape[0]} samples ({card})", flush=True)
    del vctk

    # HiFi-GAN V2's decoder: kernels 7 and C
    narrow = make_model(device, VitsConfig(upsample_initial_channel=128), engine16)
    warm(narrow, card)
    out = path("bf16_narrow", lambda: narrow.synthesize_raw([SINGLE_TEXTS[1]], seed=[4]))
    check_audio(out.waveform[0, : out.lengths[0]], "bf16 narrow-vocoder request")
    if launches["bf16_narrow"]["fused_resblock"] == 0 or launches["bf16_narrow"][
            "fused_stage"] == 0:
        raise RuntimeError("the bf16 narrow vocoder did not run kernels 7 and C")
    results["narrow_request"] = request_profile(narrow, card, families=NARROW_FAMILIES)
    for name in SERVE16_KERNELS:
        if not sum(counts[name] for p, counts in launches.items() if p != "warmup"):
            raise RuntimeError(f"bf16 serving never launched {name}")
    results["launches"] = launches
    return results


SERVE16_FLAG = "--bf16-serving-phase"
SERVE16_RESULT = "bf16-serving-phase result: "


def bf16_serving_phase(device) -> dict:
    """Phase 11's work (a child of :func:`run_child`)."""
    from vits_tpu_torch import EngineConfig, VitsConfig
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.flow import fused_flow
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage

    card = card_line()
    kernels.library()
    t0 = time.perf_counter()
    wrappers = (flash_rel_attention, fused_resblock_trio, fused_stage, fused_flow,
                fused_resblock)
    engine16 = EngineConfig(compute_dtype="bfloat16")
    model = make_model(device, engine_config=engine16)
    vctk = make_model(device, VitsConfig(**VCTK), EngineConfig(
        compute_dtype="bfloat16", use_pallas_flow=True), keep_training=True)
    narrow = make_model(device, VitsConfig(upsample_initial_channel=128), engine16)
    measured = serve16_kernels_vs_plain(model, vctk, narrow, device)
    del model, vctk, narrow
    requests = serve16_requests(device, card, wrappers)
    print(f"  phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"kernels": measured, "requests": requests, "profiler_sessions": PROFILER_SESSIONS}


# --------------------------------------------------------------------------- #
# Phase 12: data-parallel training (vits_tpu_torch/parallel; train/step.py's
# data_parallel; ZeRO-1 in train/schedule.py), in a process of its own.
# --------------------------------------------------------------------------- #

DP_FLAG = "--data-parallel-phase"
DP_RESULT = "data-parallel-phase result: "
DP_RANK_FLAG = "--data-parallel-rank"  # a rank of 12b: the flag, its rank, the port, a directory
# 12b: phase 7's shapes at four rows, two a rank, padded to 512 tokens (kernels A with lse
# and 4) and 1280 frames; unequal lengths, so the global normalizers matter
DP_TOKENS = (512, 300, 448, 256)
DP_FRAMES = (1280, 800, 1100, 640)
# 12b's losses: within this relative bound of the one-process step's, or within 10x
# their noise floor where that is larger (phase 7's loss bound: the largest movement of
# the one-process loss when every weight moves by 1e-7). At random MMS weights the
# adversarial term through the AdamW-updated discriminator moved 1.2e-5 relative.
DP_LOSS_RTOL = 1e-5
# 12a and ZeRO-1 on/off: a step's results against the plain step's, within this multiple
# of the plain step's own run-to-run spread over three runs (on the H100 two runs of one
# GAN step differ in the last bits, its losses included: some reductions sum in a
# run-dependent order; bit-equal where the plain step repeats itself bit for bit)
DP_SPREAD_FACTOR = 4
TRAINING_KERNELS = ("flash_rel_attention_lse", "rel_attention_bwd", "trio_forward_with_acts",
                    "trio_backward")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def training_launches() -> dict:
    """The launch counts of the training kernels (A with lse, 4, 5's forward and backward)."""
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.ops.cuda.trio_grad import trio_backward, trio_forward_with_acts

    return {"flash_rel_attention_lse": flash_rel_attention.lse_launches,
            "rel_attention_bwd": rel_attention_bwd.launches,
            "trio_forward_with_acts": trio_forward_with_acts.launches,
            "trio_backward": trio_backward.launches}


def zero_training_launches() -> None:
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.ops.cuda.trio_grad import trio_backward, trio_forward_with_acts

    for fn in (flash_rel_attention, rel_attention_bwd, trio_forward_with_acts, trio_backward):
        fn.launches = 0
    flash_rel_attention.lse_launches = 0


def leaves_on(arrays: dict, device) -> dict:
    return {k: torch.tensor(v, device=device, requires_grad=True) for k, v in arrays.items()}


def gan_step_once(config, gen_np, disc_np, batch, noise, device, data_parallel=None,
                  zero1=False, steps: int = 1, grad_accum: int = 1):
    """``steps`` GAN steps from fresh copies of the parameters, each on ``batch``
    and ``noise``, with the AdamW recipe (``train/schedule.py``; ``zero1`` under
    data parallelism), at ``grad_accum``. Returns the last step's metrics, and
    the (clipped) gradients and the parameters after it."""
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import make_gan_train_step

    gen, disc = leaves_on(gen_np, device), leaves_on(disc_np, device)
    shard = data_parallel if zero1 else None
    opts = vits_optimizer(gen, zero1=shard), vits_optimizer(disc, zero1=shard)
    step_fn = make_gan_train_step(config, gen, disc, *opts, data_parallel=data_parallel,
                                  grad_accum=grad_accum)
    for _ in range(steps):
        metrics = step_fn(batch, noise=noise)
    params = list(gen.values()) + list(disc.values())
    return (torch.stack(list(metrics)).detach(), [p.grad.detach().clone() for p in params],
            [p.detach().clone() for p in params])


def max_diff(a, b) -> float:
    if torch.is_tensor(a):
        return float((a - b).abs().max())
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def within_spread(what: str, got, runs) -> dict:
    """``got`` against ``runs[0]`` within DP_SPREAD_FACTOR x the spread of ``runs``
    (the same computation run again: the largest max|diff| of any two)."""
    err = max_diff(got, runs[0])
    spread = max(max_diff(a, b) for i, a in enumerate(runs) for b in runs[i + 1:])
    print(f"    {what}: max|diff| {err:.3e}, the plain step against itself {spread:.3e}"
          f"{' (bit-equal)' if err == 0 else ''}", flush=True)
    if not err <= DP_SPREAD_FACTOR * spread:
        raise RuntimeError(f"{what}: max|diff| {err:.3e} > {DP_SPREAD_FACTOR} x the plain "
                           f"step's own spread {spread:.3e}")
    return {"max_abs_diff": err, "spread": spread}


def timed_steps(step_fns: dict, batch, noise, rounds: int = 3) -> dict:
    """Steady wall ms per step of each step function, in turns (a, b, b, a, ...)
    after one warm-up each, host clock to a synchronise."""
    times = {name: [] for name in step_fns}
    for fn in step_fns.values():
        fn(batch, noise=noise)
    torch.cuda.synchronize()
    order = list(step_fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            step_fns[name](batch, noise=noise)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
    return {name: float(np.median(t)) for name, t in times.items()}


def all_reduce_ms(gen: dict, disc: dict, reps: int = 5) -> dict:
    """Wall ms of one all_reduce_ (one collective over a flat fp32 buffer) of the
    generator's and of the discriminator's gradients, alone."""
    from vits_tpu_torch.parallel.mesh import all_reduce_

    out = {}
    for name, params in (("generator", gen), ("discriminator", disc)):
        grads = [p.grad for p in params.values()]
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_(grads)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        out[name] = {"ms": float(np.median(times[1:])), "mib": 4 * sum(
            g.numel() for g in grads) / 2**20}
    return out


def dp_world_one(config, gen_np, disc_np, device, card: str) -> dict:
    """Phase 12a: a one-rank NCCL group; the data-parallel GAN step at phase 7's batch
    against the plain one-process step; step ms; the gradient all-reduce alone;
    ``train(zero1=True)`` with a resume."""
    from vits_tpu_torch.parallel.distributed import initialize
    from vits_tpu_torch.parallel.mesh import data_axis
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import draw_noise, make_gan_train_step

    initialize(f"localhost:{free_port()}", 1, 0, device=device)
    try:
        dp = data_axis()
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
        if torch.distributed.get_backend() != backend or (dp.world, dp.rank) != (1, 0):
            raise RuntimeError(f"expected a one-rank {backend} group, got "
                               f"{torch.distributed.get_backend()} {dp}")
        batch = training_batch(config, device)
        noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(1))
        # cuDNN pinned to deterministic algorithms for the comparison, as phase 10d
        # pins it: with cuDNN's free choice three plain steps can repeat themselves
        # bit for bit while a fourth lands one ulp away (a generator loss of ~130
        # moved 1.526e-5), and a spread of 0 then fails a step equal to the plain one
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            gan_step_once(config, gen_np, disc_np, batch, noise, device)  # warm-up
            zero_training_launches()
            got = gan_step_once(config, gen_np, disc_np, batch, noise, device, dp)
            launches = training_launches()
            plain = [gan_step_once(config, gen_np, disc_np, batch, noise, device)
                     for _ in range(3)]
        finally:
            torch.backends.cudnn.deterministic = deterministic
        print(f"  data-parallel GAN step at world 1 (NCCL), B=2, 512 tokens, 1280 frames: "
              f"launches {launches}", flush=True)
        for name, n in launches.items():
            if not n:
                raise RuntimeError(f"kernel {name} was not launched by the data-parallel step")
        print("  against the plain one-process step from the same parameters and noise (run "
              "three times):", flush=True)
        held = {what: within_spread(what, got[i], [run[i] for run in plain])
                for i, what in enumerate(("losses", "gradients", "parameters after AdamW"))}
        # the same pair under cuDNN's free choice (the main path's setting), shown
        # beside the pinned check: a divergence outside the pinned algorithms
        free = (gan_step_once(config, gen_np, disc_np, batch, noise, device, dp),
                gan_step_once(config, gen_np, disc_np, batch, noise, device))
        unpinned = {what: max_diff(free[0][i], free[1][i])
                    for i, what in enumerate(("losses", "gradients", "parameters after AdamW"))}
        print("  unpinned cuDNN, one world-1 step against one plain step: max|diff| "
              + ", ".join(f"{what} {d:.3e}" for what, d in unpinned.items()), flush=True)

        gen, disc = leaves_on(gen_np, device), leaves_on(disc_np, device)
        gen1, disc1 = leaves_on(gen_np, device), leaves_on(disc_np, device)
        fns = {"one process": make_gan_train_step(config, gen1, disc1, vits_optimizer(gen1),
                                                  vits_optimizer(disc1)),
               "world 1": make_gan_train_step(config, gen, disc, vits_optimizer(gen),
                                              vits_optimizer(disc), data_parallel=dp)}
        step_ms = timed_steps(fns, batch, noise)
        reduce_ms = all_reduce_ms(gen, disc)
        del fns, gen, disc, gen1, disc1
        print(f"  steady GAN step: one process {step_ms['one process']:.1f} ms, world 1 over "
              f"NCCL {step_ms['world 1']:.1f} ms; gradient all-reduce alone: generator "
              f"{reduce_ms['generator']['ms']:.2f} ms ({reduce_ms['generator']['mib']:.0f} MiB), "
              f"discriminator {reduce_ms['discriminator']['ms']:.2f} ms "
              f"({reduce_ms['discriminator']['mib']:.0f} MiB) ({card})", flush=True)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        train_loop(card, zero1=True)
        loop_s = time.perf_counter() - t0
    finally:
        torch.distributed.destroy_process_group()
    return {"launches": launches, "held": held, "unpinned_max_abs_diff": unpinned,
            "step_ms": step_ms, "all_reduce": reduce_ms, "train_zero1_s": loop_s}


def dp_two_ranks(config, gen_np, disc_np, device, card: str, tokens=DP_TOKENS,
                 frames=DP_FRAMES, grad_accum: int = 1, full: bool = True) -> dict:
    """Phase 12b: two gloo ranks on the one card (NCCL refuses two ranks on one
    GPU) against the one-process step on the same rows (B=4) at ``grad_accum``:
    equal MAS durations, losses within DP_LOSS_RTOL, gradients within phase 7's
    noise-floor bounds (the floor of the one-process step on the card); with
    ``full`` also ZeRO-1 on and off, step ms and gloo's all-reduce ms (phase
    15c: six rows at grad_accum=2, without them)."""
    import tempfile

    from vits_tpu_torch.train.step import draw_noise, generator_forward

    batch = training_batch(config, device, tokens, frames)
    noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(2))
    with torch.no_grad():
        durations = generator_forward(leaves_on(gen_np, device), config, batch,
                                      noise).durations.cpu()
    want_metrics, want, _ = gan_step_once(config, gen_np, disc_np, batch, noise, device,
                                          grad_accum=grad_accum)
    want = [g.cpu() for g in want]
    rng = np.random.default_rng(3)
    floors, floor_metrics = [], []
    for _ in range(FLOOR_SAMPLES):  # every weight moved by 1e-7, relative
        moved = [{k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(np.float32)
                  for k, v in arrays.items()} for arrays in (gen_np, disc_np)]
        metrics, grads, _ = gan_step_once(config, *moved, batch, noise, device,
                                          grad_accum=grad_accum)
        floors.append([g.cpu() for g in grads])
        floor_metrics.append(metrics.tolist())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        Path(f"{tmp}/setup.json").write_text(json.dumps(
            {"config": dataclasses.asdict(config), "device": str(device),
             "grad_accum": grad_accum, "full": full}))
        np.savez(f"{tmp}/inputs.npz", **{f"gen.{k}": v for k, v in gen_np.items()},
                 **{f"disc.{k}": v for k, v in disc_np.items()},
                 **{f"batch.{k}": v.cpu().numpy() for k, v in batch._asdict().items()
                    if v is not None},
                 **{f"noise.{k}": v.cpu().numpy() for k, v in noise._asdict().items()})
        port = free_port()
        logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), DP_RANK_FLAG,
                                   str(r), str(port), tmp], stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            for log in logs:
                log.close()
        for r, p in enumerate(procs):
            with open(f"{tmp}/rank{r}.log") as f:
                text = f.read()
            if p.returncode != 0:
                raise RuntimeError(f"phase 12b rank {r} failed (exit {p.returncode}):\n"
                                   f"{text[-4000:]}")
        reports = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(2)]
        with np.load(f"{tmp}/grads0.npz") as f:
            got = [torch.from_numpy(f[str(i)]) for i in range(len(want))]
    a, b = reports
    B = len(tokens)
    if full:
        print(f"  two gloo ranks on one card: steady GAN step {a['step_ms']:.1f} ms (B={B}, "
              f"{B // 2} rows a rank), gradient all-reduce through the host: generator "
              f"{a['all_reduce']['generator']['ms']:.2f} ms, discriminator "
              f"{a['all_reduce']['discriminator']['ms']:.2f} ms ({card})", flush=True)
        print(f"  ZeRO-1 on vs off, 2 AdamW steps: parameters max|diff| "
              f"{max(r['zero1']['max_abs_diff'] for r in reports):.3e} (the replicated run, "
              f"three times, against itself {max(r['zero1']['spread'] for r in reports):.3e});"
              f" rank moments {[round(r['zero1']['moment_share'], 3) for r in reports]} of the "
              f"optimizer state", flush=True)
    print(f"  launches of rank 0's step at grad_accum={grad_accum}: {a['launches']}", flush=True)
    for r, rep in enumerate(reports):
        if rep["durations"] != durations[rep["rows"]].tolist():
            raise RuntimeError(f"rank {r}: MAS durations differ from the one-process step's")
        if full and rep["zero1"]["max_abs_diff"] > DP_SPREAD_FACTOR * rep["zero1"]["spread"]:
            raise RuntimeError(f"ZeRO-1 on and off: parameters differ by "
                               f"{rep['zero1']['max_abs_diff']:.3e}, past {DP_SPREAD_FACTOR} x "
                               f"the replicated run's own spread {rep['zero1']['spread']:.3e}")
    if a["metrics"] != b["metrics"] or a["grad_digest"] != b["grad_digest"]:
        raise RuntimeError("the two ranks hold different metrics or gradients")
    for i, (name, g, w) in enumerate(zip(GAN_FIELDS, a["metrics"], want_metrics.tolist())):
        floor = max(abs(m[i] - w) for m in floor_metrics)
        bound = max(DP_LOSS_RTOL * max(1.0, abs(w)), 10 * floor)
        print(f"    {name}: two ranks {g:.7g}, one process {w:.7g}, |diff| {abs(g - w):.3e} "
              f"(noise floor {floor:.3e}, bound {bound:.3e})", flush=True)
        if not abs(g - w) <= bound:
            raise RuntimeError(f"two ranks and one process: {name} differs past {bound:.3e}")
    print(f"  two gloo ranks on one card vs the one-process B={B} step at grad_accum="
          f"{grad_accum}: equal MAS durations ({int(durations.sum())} frames), equal metrics "
          f"and gradients on both ranks, losses within {DP_LOSS_RTOL} relative or 10x their "
          f"noise floor", flush=True)
    hold_gradients(list(gen_np) + list(disc_np), got, want, floors, "two ranks vs one process")
    return {"ranks": reports, "launches": a["launches"]}


# the kernels entries of the JSON line that phase 12's path launches, and their counters
DP_KERNEL_ENTRIES = {"flash_rel_attention": ("flash_rel_attention_lse",),
                     "trainable_rel_attention": ("rel_attention_bwd",),
                     "trainable_trio": ("trio_forward_with_acts", "trio_backward")}
GAN_FIELDS = ("gen_loss", "disc_loss", "kl", "duration", "mel", "adversarial",
              "feature_matching")


def tuples(value):
    """A JSON value with its lists as tuples (a VitsConfig field read back)."""
    return tuple(map(tuples, value)) if isinstance(value, list) else value


def dp_rank(rank: int, port: int, tmp: str) -> None:
    """A rank of phase 12b (a child of :func:`dp_two_ranks`): its MAS durations, one
    GAN step (metrics and gradients to ``tmp``), step and all-reduce ms, and
    ZeRO-1 on and off."""
    import hashlib

    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.parallel.distributed import initialize
    from vits_tpu_torch.parallel.mesh import data_axis, rank_rows, zero1_owners
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import (
        RowShare, TrainBatch, TrainNoise, generator_forward, make_gan_train_step)

    setup = json.loads(Path(f"{tmp}/setup.json").read_text())
    device = torch.device(setup["device"])
    initialize(f"localhost:{port}", 2, rank, device=device, backend="gloo")
    try:
        config = VitsConfig(**{k: tuples(v) for k, v in setup["config"].items()})
        with np.load(f"{tmp}/inputs.npz") as f:
            arrays = {k: f[k] for k in f.files}
        part = {prefix: {k[len(prefix) + 1:]: v for k, v in arrays.items()
                         if k.startswith(prefix + ".")} for prefix in ("gen", "disc", "batch",
                                                                      "noise")}
        gen_np, disc_np = part["gen"], part["disc"]
        batch = TrainBatch(*(None if k not in part["batch"] else
                             torch.tensor(part["batch"][k], device=device)
                             for k in TrainBatch._fields))
        noise = TrainNoise(*(torch.tensor(part["noise"][k], device=device)
                             for k in TrainNoise._fields))
        dp = data_axis()
        rows = rank_rows(batch.input_ids.shape[0], 2, rank)
        idx = torch.as_tensor(rows, device=device)
        with torch.no_grad():
            durations = generator_forward(
                leaves_on(gen_np, device), config, TrainBatch(*(None if t is None else t[idx]
                                                                for t in batch)),
                TrainNoise(*(t[idx] for t in noise)),
                share=RowShare(batch.frame_mask.sum(), batch.token_mask.sum(), 0.5)).durations
        grad_accum, full = setup.get("grad_accum", 1), setup.get("full", True)
        zero_training_launches()
        metrics, grads, _ = gan_step_once(config, gen_np, disc_np, batch, noise, device, dp,
                                          grad_accum=grad_accum)
        launches = training_launches()
        digest = hashlib.sha256()
        for g in grads:
            digest.update(g.cpu().numpy().tobytes())
        if rank == 0:
            np.savez(f"{tmp}/grads0.npz", **{str(i): g.cpu().numpy() for i, g in
                                             enumerate(grads)})
        del grads
        report = {"rows": rows.tolist(), "durations": durations.cpu().tolist(),
                  "metrics": metrics.tolist(), "grad_digest": digest.hexdigest(),
                  "launches": launches}
        if not full:
            Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(report))
            return

        gen, disc = leaves_on(gen_np, device), leaves_on(disc_np, device)
        step_fn = make_gan_train_step(config, gen, disc, vits_optimizer(gen),
                                      vits_optimizer(disc), data_parallel=dp)
        step_ms = timed_steps({"two ranks": step_fn}, batch, noise)["two ranks"]
        reduce_ms = all_reduce_ms(gen, disc)
        del step_fn, gen, disc
        torch.cuda.empty_cache()
        # ZeRO-1 on and off: two AdamW steps each; the replicated run twice for its spread
        _, _, on = gan_step_once(config, gen_np, disc_np, batch, noise, device, dp, zero1=True,
                                 steps=2)
        off = [gan_step_once(config, gen_np, disc_np, batch, noise, device, dp, steps=2)[2]
               for _ in range(3)]
        numels = [v.size for v in {**gen_np, **disc_np}.values()]
        owned = sum(n for n, owner in zip(numels, zero1_owners(numels, 2)) if owner == rank)
        report.update({"step_ms": step_ms, "all_reduce": reduce_ms,
                       "zero1": {"max_abs_diff": max_diff(on, off[0]),
                                 "spread": max(max_diff(x, y) for i, x in enumerate(off)
                                               for y in off[i + 1:]),
                                 "moment_share": owned / sum(numels)}})
        Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(report))
    finally:
        torch.distributed.destroy_process_group()


def data_parallel_phase(device) -> dict:
    """Phase 12's work (a child of :func:`run_child`)."""
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops import cuda as kernels

    card = card_line()
    kernels.library()
    t0 = time.perf_counter()
    config = VitsConfig()
    gen_np = random_weights(config, keep_training=True)
    disc_np = init_discriminator_params(0)
    world_one = dp_world_one(config, gen_np, disc_np, device, card)
    two_ranks = dp_two_ranks(config, gen_np, disc_np, device, card)
    print(f"  phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    return {"world_one": world_one, "two_ranks": two_ranks, "card": card,
            "profiler_sessions": PROFILER_SESSIONS}


# --------------------------------------------------------------------------- #
# Phase 13: multi-device serving (Synthesizer(mesh=), engine/sp.py, serve() on a
# mesh engine), in a process of its own, over replicas that share the card.
# --------------------------------------------------------------------------- #

MULTI_FLAG = "--multi-device-phase"
MULTI_RESULT = "multi-device-phase result: "
# 13a: five texts of 23-211 tokens at per-row seeds: a data=2 mesh pads them to six rows
MESH_TEXTS = (SINGLE_TEXTS[0], BATCH_TEXTS[1], BATCH_TEXTS[2], SINGLE_TEXTS[1], SINGLE_TEXTS[2])
MESH_SEEDS = (41, 42, 43, 44, 45)
# 13d: closed-loop /synthesize clients over loopback on the mesh engine
MESH_LOAD_S, MESH_CLIENTS = 5.0, 4
# 13e: a batch of eight 87-token requests
TIMED_ROWS = 8
def reset_counts(wrappers) -> None:
    """Each wrapper's ``launches`` to 0 and its per-replica book emptied."""
    for fn in wrappers:
        fn.launches = 0
        fn.replica_launches = {}


def replica_book(wrappers, kernels, replicas: int, what: str) -> dict:
    """The launches each wrapper booked to each replica since :func:`reset_counts`
    (``ops/cuda::booked_to``: a mesh's replica books, on its own thread, where the
    wrapper counts its launch), by "kernel | replica i | device". Fails unless every
    kernel of ``kernels`` launched on each of ``replicas`` replicas."""
    by = {f"{fn.__name__} | {label}": n for fn in wrappers
          for label, n in sorted(fn.replica_launches.items())}
    missing = [(k, i) for k in kernels for i in range(replicas)
               if not any(key.startswith(f"{k} | replica {i} |") for key in by)]
    print(f"  {what}: launches by kernel, replica and device {by}", flush=True)
    if missing:
        raise RuntimeError(f"{what}: kernels not launched on a replica: {missing}")
    return by


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def steady_and_busy(fn, reps: int = 3) -> dict:
    """``fn`` once to warm it, its steady wall ms (median of ``reps``, host clock
    to a synchronise of every card), and one call under ``torch.profiler``: the
    device busy ms and the idle share of the steady wall."""
    fn()
    walls = []
    for _ in range(reps):
        sync_all()
        t0 = time.perf_counter()
        fn()
        sync_all()
        walls.append(1e3 * (time.perf_counter() - t0))
    steady = float(np.median(walls))
    _, device, busy = profiled(fn)
    return {"wall_ms": steady, "walls_ms": walls, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / steady, "device_ops": len(device)}


def rows_vs(got, want, rows: int, what: str) -> float:
    """Equal frame lengths, and the largest |diff| of the valid samples, row by row."""
    if not np.array_equal(got.frame_lengths[:rows], want.frame_lengths[:rows]):
        raise RuntimeError(f"{what}: frames {got.frame_lengths[:rows].tolist()} against "
                           f"{want.frame_lengths[:rows].tolist()}")
    worst = 0.0
    for i in range(rows):
        n = want.lengths[i]
        check_audio(got.waveform[i, :n], f"{what} row {i}")
        worst = max(worst, float(np.abs(got.waveform[i, :n] - want.waveform[i, :n]).max()))
    return worst


def mesh_mms(device, mesh, card: str, wrappers, label: str) -> dict:
    """13a (and 13f): MMS-TTS at full width on ``mesh``, the five texts at per-row
    seeds against the single engine at the same padded rows."""
    import vits_tpu_torch
    from vits_tpu_torch import VitsConfig

    single = make_model(device, engine_config=exact_engine())
    model = vits_tpu_torch.load_model(checkpoint(VitsConfig(), False), exact_engine(), mesh=mesh)
    rows = -(-len(MESH_TEXTS) // mesh.shape["data"]) * mesh.shape["data"]
    reset_counts(wrappers)
    t0 = time.perf_counter()
    got = model.synthesize_raw(list(MESH_TEXTS), seed=list(MESH_SEEDS))
    wall_ms = 1e3 * (time.perf_counter() - t0)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    by = replica_book(wrappers, ("flash_rel_attention", "fused_resblock_trio", "fused_stage"),
                      mesh.shape["data"], f"{label} the mesh's dispatch")
    want = single.synthesize_raw(list(MESH_TEXTS), seed=list(MESH_SEEDS), pad_to_batch=rows)
    worst = rows_vs(got, want, len(MESH_TEXTS), f"{label} mesh vs single")
    tokens = [len(model.tokenizer.encode(t)) for t in MESH_TEXTS]
    print(f"  {label} {mesh}: {len(MESH_TEXTS)} texts of {tokens} tokens on {rows} rows, "
          f"frames {got.frame_lengths[:len(MESH_TEXTS)].tolist()} (equal to the single "
          f"engine's at pad_to_batch={rows}), waveforms max|diff| {worst:.3e} "
          f"(atol {BATCH_ATOL}), first dispatch {wall_ms:.1f} ms, launches {launches}, "
          f"stats {model.stats} ({card})", flush=True)
    if not worst <= BATCH_ATOL:
        raise RuntimeError(f"{label}: the mesh's rows differ from the single engine's")
    return {"model": model, "single": single, "max_abs_diff": worst, "launches": launches,
            "per_replica": by, "first_ms": wall_ms}


def mesh_vctk(device, mesh, card: str, wrappers) -> dict:
    """13b: VCTK width with kernel 6 on the mesh: the batch of three with its
    speaker list (the mesh pads it to four rows), and a conversion 0 -> 17, each
    against the single engine."""
    import vits_tpu_torch
    from vits_tpu_torch import VitsConfig

    config, engine = VitsConfig(**VCTK), exact_engine(use_pallas_flow=True)
    single = make_model(device, config, engine, keep_training=True)
    model = vits_tpu_torch.load_model(checkpoint(config, True), engine, mesh=mesh)
    rows = -(-len(BATCH_TEXTS) // mesh.shape["data"]) * mesh.shape["data"]
    audio = single.synthesize(SINGLE_TEXTS[1], seed=3, speaker_id=0)  # the conversion's input
    reset_counts(wrappers)  # from here on only the mesh engine runs, until the counts are read
    pending = model.submit(list(BATCH_TEXTS), seed=list(BATCH_SEEDS),
                           speaker_id=list(BATCH_SPEAKERS))
    if pending.speaker.tolist() != [*BATCH_SPEAKERS] + [0] * (rows - len(BATCH_SPEAKERS)):
        raise RuntimeError(f"13b: speakers {pending.speaker.tolist()} not tail-filled")
    got = model.collect(pending)
    converted = model.convert_voice(audio, source_speaker=0, target_speaker=17)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    by = replica_book(wrappers, ("flash_rel_attention", "fused_resblock_trio", "fused_stage",
                                 "fused_flow"), mesh.shape["data"], "13b VCTK on the mesh")
    want = single.synthesize_raw(list(BATCH_TEXTS), seed=list(BATCH_SEEDS),
                                 speaker_id=list(BATCH_SPEAKERS), pad_to_batch=rows)
    worst = rows_vs(got, want, len(BATCH_TEXTS), "13b mesh vs single")
    solo = single.convert_voice(audio, source_speaker=0, target_speaker=17)
    check_audio(converted, "13b conversion")
    conv = float(np.abs(converted - solo).max()) if converted.shape == solo.shape else np.inf
    print(f"  13b VCTK, use_pallas_flow=True: 3 texts, speakers {list(BATCH_SPEAKERS)} tail-"
          f"filled over {rows} rows, frames {got.frame_lengths[:3].tolist()} (equal), max|diff| "
          f"{worst:.3e}; convert_voice 0 -> 17 ({len(converted)} samples) max|diff| {conv:.3e} "
          f"(atol {BATCH_ATOL}); launches {launches} ({card})", flush=True)
    if not (worst <= BATCH_ATOL and conv <= BATCH_ATOL):
        raise RuntimeError("13b: the mesh differs from the single engine")
    return {"max_abs_diff": worst, "convert_max_abs_diff": conv, "launches": launches,
            "per_replica": by}


def sharded_decode(device, card: str, wrappers) -> dict:
    """13c: ``ShardedDecoder`` with 2 and 3 shards on replicas sharing the card,
    the 211-token text (its 640-frame capacity overflows to 1280 at random
    weights) and the 87-token one at ``speaking_rate=0.5`` against the one-shot
    decode, within STREAM_ATOL. Each decoder's first call builds its window shapes."""
    from vits_tpu_torch.engine.sp import ShardedDecoder
    from vits_tpu_torch.parallel.mesh import make_mesh

    one = make_model(device, engine_config=exact_engine(transfer_int16=False,
                                                        adaptive_capacity=False))
    cases = ((SINGLE_TEXTS[2], 7, {}), (SINGLE_TEXTS[1], 8, {"speaking_rate": 0.5}))
    refs = []  # (the one-shot decode, its re-dispatches)
    for text, seed, kw in cases:
        before = one.stats["redispatches"]
        ref = one.synthesize(text, seed=seed, **kw)
        refs.append((ref, one.stats["redispatches"] - before))
    results, decoders = {}, {}
    for n in (2, 3):
        sp = decoders[n] = ShardedDecoder(one, mesh=make_mesh(devices=[device] * n))
        reset_counts(wrappers)
        got = [sp.synthesize(text, seed=seed, **kw) for text, seed, kw in cases]
        launches = {fn.__name__: fn.launches for fn in wrappers}
        by = replica_book(wrappers, ("fused_resblock_trio", "fused_stage"), n,
                          f"13c {n} shards")
        diffs = []
        for (text, _, kw), g, (ref, redispatches) in zip(cases, got, refs):
            check_audio(g, f"13c {n} shards")
            diffs.append(float(np.abs(g - ref).max()) if g.shape == ref.shape else np.inf)
            print(f"  13c ShardedDecoder({n}): {len(one.tokenizer.encode(text))} tokens {kw}, "
                  f"{len(g)} samples (one-shot {len(ref)}, {redispatches} re-dispatch), "
                  f"max|diff| {diffs[-1]:.3e} (atol {STREAM_ATOL})", flush=True)
        print(f"  13c launches {launches} ({card})", flush=True)
        if not max(diffs) <= STREAM_ATOL or refs[1][1] == 0:
            raise RuntimeError(f"13c: {n} shards differ from the one-shot decode, or the "
                               "speaking_rate=0.5 text did not overflow")
        results[n] = {"max_abs_diff": diffs, "launches": launches, "per_replica": by}
    return {"one": one, "decoders": decoders, "results": results}


def mesh_http(model, card: str, wrappers) -> dict:
    """13d: ``serve(model, max_batch=8)`` in-process on the mesh engine (warmed as
    the server's ``main`` warms it), MESH_CLIENTS closed-loop /synthesize clients
    for MESH_LOAD_S seconds: requests, errors, 429s and the latency percentiles."""
    import http.client
    import threading

    from vits_tpu_torch.engine.server import serve

    model.warmup(batch_sizes=(1,), token_buckets=model.engine.token_buckets[:2],
                 per_row_seeds=True)
    server, worker = serve(model, port=0, max_batch=8, streaming=False)
    server.daemon_threads = False
    serving = threading.Thread(target=server.serve_forever)
    serving.start()
    hostport = f"127.0.0.1:{server.server_address[1]}"
    latency, errors, statuses = [], [], {}
    lock = threading.Lock()
    try:
        reset_counts(wrappers)
        stop_at = time.perf_counter() + MESH_LOAD_S

        def client(i):
            n = 0
            while time.perf_counter() < stop_at:
                payload = {"text": LOAD_TEXTS[(i + n) % len(LOAD_TEXTS)], "seed": 1000 * i + n}
                n += 1
                try:
                    conn = http.client.HTTPConnection(hostport, timeout=60)
                    t0 = time.perf_counter()
                    conn.request("POST", "/synthesize", body=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    body = resp.read()
                    seconds = time.perf_counter() - t0
                    conn.close()
                except Exception as exc:  # counted: the pin is zero
                    with lock:
                        errors.append(f"client {i}: {exc!r}")
                    continue
                with lock:
                    statuses[resp.status] = statuses.get(resp.status, 0) + 1
                    if resp.status == 200 and body[:4] == b"RIFF" and len(body) > 44:
                        latency.append(seconds)
                    elif resp.status != 429:
                        errors.append(f"client {i}: HTTP {resp.status}, {len(body)} bytes")

        clients = [threading.Thread(target=client, args=(i,)) for i in range(MESH_CLIENTS)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=MESH_LOAD_S + 120)
        if any(c.is_alive() for c in clients):
            raise RuntimeError("13d: an HTTP client hung")
        launches = {fn.__name__: fn.launches for fn in wrappers}
        by = replica_book(wrappers, ("flash_rel_attention", "fused_resblock_trio",
                                     "fused_stage"), model.mesh.shape["data"], "13d HTTP load")
        lat = percentiles(latency or [np.inf])
        with worker.stats_lock:
            stats = dict(worker.stats)
        print(f"  13d HTTP load on the mesh engine, {MESH_CLIENTS} /synthesize clients for "
              f"{MESH_LOAD_S:g} s: {len(latency)} requests, {len(errors)} errors, "
              f"{statuses.get(429, 0)} 429s, {stats['batches']} batches; latency ms "
              f"p50/p95/p99 " + "/".join(f"{1e3 * lat[k]:.1f}" for k in ("p50", "p95", "p99"))
              + f"; launches {launches} ({card})", flush=True)
        if errors or statuses.get(429) or not latency or not lat["p95"] < LATENCY_P95_S:
            raise RuntimeError(f"13d: errors {errors[:5]}, statuses {statuses}, p95 "
                               f"{lat['p95']} s")
    finally:
        worker.stop()
        worker._thread.join(timeout=30)
        server.shutdown()
        serving.join(timeout=30)
        server.server_close()
    return {"requests": len(latency), "errors": len(errors), "rejected": statuses.get(429, 0),
            "batches": stats["batches"], "latency_s": lat, "launches": launches,
            "per_replica": by}


def mesh_timings(mms: dict, sp: dict, card: str) -> dict:
    """13e: a batch of TIMED_ROWS 87-token requests on the single engine and on
    the two-replica mesh, and the 211-token text one-shot against
    ``ShardedDecoder(2)``: wall ms, device busy ms, idle share. Both replicas
    share one card: this is what the threads and the shared card cost or buy,
    not a multi-card figure."""
    texts, seeds = [SINGLE_TEXTS[1]] * TIMED_ROWS, list(range(TIMED_ROWS))
    one, sp2 = sp["one"], sp["decoders"][2]
    runs = {
        "batch8_single": lambda: mms["single"].synthesize_raw(texts, seed=seeds),
        "batch8_mesh2": lambda: mms["model"].synthesize_raw(texts, seed=seeds),
        "text211_oneshot": lambda: one.synthesize(SINGLE_TEXTS[2], seed=7),
        "text211_sharded2": lambda: sp2.synthesize(SINGLE_TEXTS[2], seed=7),
    }
    out = {}
    for name, fn in runs.items():
        out[name] = steady_and_busy(fn)
        r = out[name]
        print(f"  13e {name:17s}: wall {r['wall_ms']:.1f} ms (median of 3: "
              f"{[round(w, 1) for w in r['walls_ms']]}), device busy {r['device_busy_ms']:.2f} "
              f"ms, idle share {r['idle_share']:.3f}, {r['device_ops']} device operations "
              f"({card})", flush=True)
    return out


def multi_device_phase(device) -> dict:
    """Phase 13's work (a child of :func:`run_child`)."""
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.flow import fused_flow
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage
    from vits_tpu_torch.parallel.mesh import make_mesh

    card = card_line()
    kernels.library()
    t0 = time.perf_counter()
    wrappers = (flash_rel_attention, fused_resblock_trio, fused_stage, fused_flow)
    shared = make_mesh(devices=[device, device])
    print(f"  [13a] MMS-TTS at full width on {shared}, exact tier ({card}):", flush=True)
    mms = mesh_mms(device, shared, card, wrappers[:3], "13a")
    print(f"  [13b] VCTK width with kernel 6 on {shared} ({card}):", flush=True)
    vctk = mesh_vctk(device, shared, card, wrappers)
    print(f"  [13c] ShardedDecoder over 2 and 3 replicas on the card ({card}):", flush=True)
    sp = sharded_decode(device, card, wrappers[:3])
    print(f"  [13d] serve() on the two-replica mesh engine ({card}):", flush=True)
    served = mesh_http(mms["model"], card, wrappers[:3])
    print(f"  [13e] timings, two replicas sharing one card ({card}):", flush=True)
    timings = mesh_timings(mms, sp, card)
    distinct = None
    if torch.cuda.device_count() > 1:
        torch.cuda.set_device(0)
        print(f"  [13f] 13a over distinct cards, device 0 current ({card}):", flush=True)
        cards = make_mesh(devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
        run = mesh_mms(device, cards, card, wrappers[:3], "13f")
        distinct = {k: run[k] for k in ("max_abs_diff", "launches", "per_replica", "first_ms")}
    else:
        print(f"  [13f] one card present ({torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}): 13f (distinct cards) did not run", flush=True)
    seconds = time.perf_counter() - t0
    print(f"  phase 13: {seconds:.1f} s", flush=True)
    return {
        "mesh_mms": {k: mms[k] for k in ("max_abs_diff", "launches", "per_replica", "first_ms")},
        "mesh_vctk": vctk,
        "sharded": {str(n): r for n, r in sp["results"].items()},
        "http": served, "timings": timings, "distinct_cards": distinct, "seconds": seconds,
        "card": card, "profiler_sessions": PROFILER_SESSIONS}


MULTI_KERNELS = ("flash_rel_attention", "fused_resblock_trio", "fused_stage", "fused_flow")


# --------------------------------------------------------------------------- #
# Phase 14: model-parallel training (parallel/pipeline.py, the model axis), in a
# process of its own; the pipeline's stages and the tensor-parallel ranks share
# the card.
# --------------------------------------------------------------------------- #

MP_FLAG = "--model-parallel-phase"
MP_RESULT = "model-parallel-phase result: "
MP_RANK_FLAG = "--model-parallel-rank"  # a rank of 14b: the flag, its rank, the port, a directory
# four rows padded to 512 tokens (kernels A with lse and 4), one of 300, over 1280 frames
MP_TOKENS = (512, 300, 512, 512)
MP_FRAMES = (1280, 800, 1280, 1100)
# 14a: (stages, microbatches, remat) of the pipelined encoder; the steps run the first
# and the last
PP_CASES = ((2, 2, False), (2, 4, True), (3, 2, True), (3, 4, False))
# the pipelined encoder against the plain one on the card: outputs max|diff| within
# ENCODER_RTOL x max(1, max|plain|) (the port's encoder bound), its stage blocks'
# gradients (of a whole-batch abs-sum) within PP_GRAD_RTOL relative L2 (fp32 sums of
# microbatches in another order; JAX's own test holds them at 1e-3 elementwise)
ENCODER_RTOL = 1e-5
PP_GRAD_RTOL = 1e-4


def stage_books(wrappers, mesh) -> dict:
    """Each wrapper's launches booked to each stage of the pipeline ``mesh``
    (``parallel/pipeline.py`` books a stage's launches, backward included, under
    ``stage s | device``); raises where a stage launched one of them no time."""
    books = {}
    stages = mesh.devices.reshape(mesh.shape["pipe"], -1)
    for fn in wrappers:
        for s in range(len(stages)):
            n = getattr(fn, "replica_launches", {}).get(f"stage {s} | {stages[s, 0]}", 0)
            if not n:
                raise RuntimeError(f"{fn.__name__} was not launched in pipeline stage {s}")
            books[f"{fn.__name__} | stage {s}"] = n
    return books


def clear_books(wrappers) -> None:
    for fn in wrappers:
        fn.replica_launches = {}


def max_rel(got, want) -> float:
    """max|diff| over max(1, max|want|), the worst over pairs of tensors."""
    return max(float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
               for g, w in zip(got, want))


def mp_kernels_vs_plain(params: dict, config, device) -> dict:
    """Phase 14's kernel shapes against the plain twins: A with lse and 4 on a
    pipeline microbatch (B=2, both heads, lengths (512, 300)) and on one
    tensor-parallel rank's head (B=4, H=1, MP_TOKENS); 5 on the gathered
    weights at the decoded-segment shapes of B=4 (its forward with acts, and
    its backward alone on the plain forward's activations)."""
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
        trio_backward,
        trio_backward_reference,
        trio_forward_with_acts,
        trio_forward_with_acts_reference,
    )

    rng = np.random.default_rng(14)
    params = {k: v.detach() for k, v in params.items()}  # the kernels without autograd
    results = {"flash_rel_attention_mp": [], "trainable_rel_attention_mp": [],
               "trainable_trio_mp": []}
    layer = ParamView(params).sub("text_encoder.encoder.layers.0.attention")
    d, w, L = config.head_dim, config.window_size, 512
    rel = (layer["emb_rel_k"][0], layer["emb_rel_v"][0])
    for what, heads, lengths in (("pipeline microbatch", config.num_attention_heads,
                                  (512, 300)),
                                 ("one rank's head", 1, MP_TOKENS)):
        B = len(lengths)
        q, k, v, dout = (torch.tensor(rng.standard_normal((B, heads, L, d)) * 0.5,
                                      dtype=torch.float32, device=device) for _ in range(4))
        lens = torch.tensor(lengths, dtype=torch.int32, device=device)
        shape = f"B={B} H={heads} L={L} d={d} {what}"
        out, lse = flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True)
        results["flash_rel_attention_mp"].append(compare(
            "flash_rel_attention+lse", shape,
            lambda: flash_rel_attention(q, k, v, *rel, window=w, lengths=lens, return_lse=True),
            lambda: rel_attention_reference(q, k, v, *rel, window=w, lengths=lens,
                                            return_lse=True),
            work=(attention_flops(lengths, heads, d, w), nbytes(q, k, v, out, lse, *rel, lens))))
        args = (q, k, v, *rel, lse, dout, out)
        results["trainable_rel_attention_mp"].append(compare(
            "rel_attention_bwd", shape,
            lambda: rel_attention_bwd(*args, window=w, lengths=lens),
            lambda: rel_attention_bwd_reference(*args, window=w, lengths=lens),
            work=(attention_flops(lengths, heads, d, w, backward=True),
                  nbytes(*args, lens, q, k, v, *rel))))
    decoder = ParamView(params).sub("decoder")
    slope = config.leaky_relu_slope
    for i, T in ((0, 256), (1, 2048)):
        blocks = _stage_resblocks(decoder, config, i)
        C = blocks[0]["w1"][0].shape[-1]
        x, g = (torch.tensor(rng.standard_normal((4, T, C)), dtype=torch.float32, device=device)
                for _ in range(2))
        shape = f"B=4 C={C} T={T} gathered weights"
        fwd_flops = resblocks_flops(steps_of(x, None), C, blocks)
        n_acts = sum(2 * len(blk["dilations"]) - 1 for blk in blocks)
        weights = pair_weights(blocks)
        with torch.no_grad():
            results["trainable_trio_mp"].append(compare(
                "trio_forward_with_acts", shape + " out+acts",
                lambda: (lambda o: (o[0], *flat_acts(o[1])))(
                    trio_forward_with_acts(x, blocks, slope=slope)),
                lambda: (lambda o: (o[0], *flat_acts(o[1])))(
                    trio_forward_with_acts_reference(x, blocks, slope=slope)),
                work=(fwd_flops, nbytes(x, *weights) + nbytes(x) * (1 + n_acts))))
            acts = flat_acts(trio_forward_with_acts_reference(x, blocks, slope=slope)[1])
            results["trainable_trio_mp"].append(compare(
                "trio_backward", shape + " bwd alone",
                lambda: (lambda r: (r[0], *r[1]))(trio_backward(g, x, blocks, acts, slope=slope)),
                lambda: (lambda r: (r[0], *r[1]))(trio_backward_reference(g, x, blocks, acts,
                                                                          slope=slope)),
                grad_rtol=GRAD_RTOL,
                work=(2 * fwd_flops, nbytes(x, g, *acts, *weights) + nbytes(x, *weights))))
    return results


def pp_encoder(config, params: dict, batch, device, card: str) -> dict:
    """14a/14c, the encoder: the pipelined encoder at each of PP_CASES (and pp x dp
    on a ('pipe', 'data') mesh of 2 x 2) against ``text_encoder`` on the same card,
    outputs and the stage blocks' gradients; kernels A and 4 booked to every
    stage."""
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.encoder import text_encoder
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.parallel.pipeline import (
        layer_suffixes,
        make_pipe_mesh,
        pipeline_text_encoder,
        stack_pipeline_params,
    )

    wrappers = (flash_rel_attention, rel_attention_bwd)
    mask3 = batch.token_mask[..., None]
    plain = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    ref = text_encoder(ParamView(plain), config, batch.input_ids, mask3, trainable=True)
    ref.last_hidden_state.abs().sum().backward()
    out = {}
    for stages, data, M, remat in [(s, 1, m, r) for s, m, r in PP_CASES] + [(2, 2, 2, False)]:
        mesh = make_pipe_mesh(stages, data=data, devices=[device] * (stages * data))
        pp = {k: v.requires_grad_() for k, v in stack_pipeline_params(
            {k: v.detach() for k, v in params.items()}, config, stages, mesh=mesh).items()}
        want = stack_pipeline_params({k: p.grad for k, p in plain.items() if p.grad is not None},
                                     config, stages)
        clear_books(wrappers)
        got = pipeline_text_encoder(pp, config, batch.input_ids, mask3, mesh, microbatches=M,
                                    remat=remat)
        got.last_hidden_state.abs().sum().backward()
        torch.cuda.synchronize()
        books = stage_books(wrappers, mesh)
        err = max_rel([t.detach() for t in got], [t.detach() for t in ref])
        names = [k for k in want if k.startswith("text_encoder.encoder.pipeline.")]
        g = torch.cat([pp[k].grad.flatten() for k in names])
        c = torch.cat([want[k].flatten() for k in names])
        grad_err = float(torch.linalg.vector_norm(g - c) / torch.linalg.vector_norm(c))
        label = f"pipe={stages}" + (f" x data={data}" if data > 1 else "") + f", M={M}" + (
            ", remat" if remat else "")
        print(f"    {label}: outputs max|diff| {err:.3e} of max(1, |plain|) (bound "
              f"{ENCODER_RTOL}); stage blocks' gradients relative L2 {grad_err:.3e} (bound "
              f"{PP_GRAD_RTOL}); {len(layer_suffixes(params))} tensors a layer; launches "
              f"{books}", flush=True)
        if not err <= ENCODER_RTOL or not grad_err <= PP_GRAD_RTOL:
            raise RuntimeError(f"pipelined encoder {label}: differs from text_encoder")
        out[label] = {"max_rel_err": err, "grad_rel_l2": grad_err, "launches": books}
    return out


def pp_step(config, gen_np: dict, batch, device, card: str) -> dict:
    """14a, the step: ``make_pp_train_step`` at PP_CASES' first and last against
    ``make_train_step`` from the same weights and noise: losses within
    DP_LOSS_RTOL or 10x their noise floor, the (clipped) gradients within phase
    7's noise-floor bounds, restacked; kernels A, 4 and 5 launched (A and 4 in
    every stage); steady ms of both; each stage block, its gradient and moments
    on its stage's device."""
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd
    from vits_tpu_torch.parallel.pipeline import (
        make_pipe_mesh,
        make_pp_train_step,
        stack_pipeline_params,
    )
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import draw_noise, make_train_step

    noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(4))

    def plain_step(arrays):
        gen = leaves_on(arrays, device)
        metrics = make_train_step(config, gen, vits_optimizer(gen))(batch, noise=noise)
        return torch.stack(list(metrics)).detach(), {k: p.grad for k, p in gen.items()}

    want_metrics, want = plain_step(gen_np)
    rng = np.random.default_rng(5)
    floors, floor_metrics = [], []
    for _ in range(FLOOR_SAMPLES):  # every weight moved by 1e-7, relative
        metrics, grads = plain_step({k: (v * (1 + 1e-7 * rng.standard_normal(v.shape)))
                                    .astype(np.float32) for k, v in gen_np.items()})
        floors.append(grads)
        floor_metrics.append(metrics.tolist())
    out = {}
    for stages, M, remat in (PP_CASES[0], PP_CASES[-1]):
        mesh = make_pipe_mesh(stages, devices=[device] * stages)
        pp = {k: v.requires_grad_() for k, v in stack_pipeline_params(
            leaves_on(gen_np, device), config, stages, mesh=mesh).items()}
        opt = vits_optimizer(pp)
        fn = make_pp_train_step(config, pp, opt, mesh, microbatches=M, remat=remat)
        zero_training_launches()
        clear_books((flash_rel_attention, rel_attention_bwd))
        metrics = torch.stack(list(fn(batch, noise=noise))).detach()
        torch.cuda.synchronize()
        launches = training_launches()
        books = stage_books((flash_rel_attention, rel_attention_bwd), mesh)
        for name, n in launches.items():
            if not n:
                raise RuntimeError(f"kernel {name} was not launched by the pipelined step")
        label = f"pipe={stages}, M={M}" + (", remat" if remat else "")
        print(f"  [14a] make_pp_train_step {label} against make_train_step, same weights and "
              f"noise: launches {launches}, by stage {books}", flush=True)
        for i, (name, g, w) in enumerate(zip(("loss", "kl", "duration", "mel"),
                                             metrics.tolist(), want_metrics.tolist())):
            floor = max(abs(m[i] - w) for m in floor_metrics)
            bound = max(DP_LOSS_RTOL * max(1.0, abs(w)), 10 * floor)
            print(f"    {name}: pipelined {g:.7g}, plain {w:.7g}, |diff| {abs(g - w):.3e} "
                  f"(noise floor {floor:.3e}, bound {bound:.3e})", flush=True)
            if not abs(g - w) <= bound:
                raise RuntimeError(f"pipelined step: {name} differs past {bound:.3e}")
        stacked = [stack_pipeline_params(grads, config, stages)
                   for grads in (want, *floors)]
        names = list(pp)
        hold_gradients(names, [pp[k].grad for k in names], [stacked[0][k] for k in names],
                       [[s[k] for k in names] for s in stacked[1:]], f"pipelined ({label})")
        for s in range(stages):
            block = pp[f"text_encoder.encoder.pipeline.{s}.attention.q_proj.weight"]
            state = opt.adamw.state[block]
            if not block.device == block.grad.device == state["exp_avg"].device == \
                    mesh.devices[s]:
                raise RuntimeError(f"stage {s}'s block, gradient or moments off its device")
        gen = leaves_on(gen_np, device)
        step_ms = timed_steps({"plain": make_train_step(config, gen, vits_optimizer(gen)),
                               "pipelined": fn}, batch, noise)
        print(f"    steady generator step: plain {step_ms['plain']:.1f} ms, pipelined "
              f"{step_ms['pipelined']:.1f} ms (stages in turn on one card) ({card})",
              flush=True)
        out[label] = {"launches": launches, "stage_launches": books, "step_ms": step_ms,
                      "metrics": metrics.tolist(), "plain_metrics": want_metrics.tolist()}
        del fn, pp, opt, gen
        torch.cuda.empty_cache()
    return out


def mp_two_ranks(config, gen_np, disc_np, device, card: str) -> dict:
    """Phase 14b: two gloo ranks sharing the card as ``data=1 x model=2`` (each a
    grandchild, ``--model-parallel-rank``) against the one-process GAN step at B=4:
    losses within DP_LOSS_RTOL or 10x their noise floor, the clipped gradients,
    the ranks' slices reassembled, within phase 7's noise-floor bounds; A and 4
    on one head a rank, 5 on the gathered weights; each rank's bytes of
    parameters and moments; step ms split into compute and gloo."""
    import tempfile

    from vits_tpu_torch.parallel.mesh import shard_index, split_plan
    from vits_tpu_torch.train.step import draw_noise

    batch = training_batch(config, device, MP_TOKENS, MP_FRAMES)
    noise = draw_noise(config, batch, torch.Generator(device=device).manual_seed(6))
    want_metrics, want, _ = gan_step_once(config, gen_np, disc_np, batch, noise, device)
    want = [g.cpu() for g in want]
    rng = np.random.default_rng(7)
    floors, floor_metrics = [], []
    for _ in range(FLOOR_SAMPLES):
        moved = [{k: (v * (1 + 1e-7 * rng.standard_normal(v.shape))).astype(np.float32)
                  for k, v in arrays.items()} for arrays in (gen_np, disc_np)]
        metrics, grads, _ = gan_step_once(config, *moved, batch, noise, device)
        floors.append([g.cpu() for g in grads])
        floor_metrics.append(metrics.tolist())
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        Path(f"{tmp}/setup.json").write_text(json.dumps(
            {"config": dataclasses.asdict(config), "device": str(device)}))
        np.savez(f"{tmp}/inputs.npz", **{f"gen.{k}": v for k, v in gen_np.items()},
                 **{f"disc.{k}": v for k, v in disc_np.items()},
                 **{f"batch.{k}": v.cpu().numpy() for k, v in batch._asdict().items()
                    if v is not None},
                 **{f"noise.{k}": v.cpu().numpy() for k, v in noise._asdict().items()})
        port = free_port()
        logs = [open(f"{tmp}/rank{r}.log", "w") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), MP_RANK_FLAG,
                                   str(r), str(port), tmp], stdout=logs[r],
                                  stderr=subprocess.STDOUT) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=600)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            for log in logs:
                log.close()
        for r, p in enumerate(procs):
            text = Path(f"{tmp}/rank{r}.log").read_text()
            if p.returncode != 0:
                raise RuntimeError(f"phase 14b rank {r} failed (exit {p.returncode}):\n"
                                   f"{text[-4000:]}")
        reports = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(2)]
        slices = []
        for r in range(2):
            with np.load(f"{tmp}/grads{r}.npz") as f:
                slices.append({k: f[k] for k in f.files})
    plan = split_plan(gen_np, 2)
    names = list(gen_np) + list(disc_np)
    got = []
    for name in names:
        if name not in plan:
            got.append(torch.from_numpy(slices[0][name]))
            continue
        split, shape = plan[name], gen_np[name].shape
        whole = np.zeros(shape, np.float32)
        for r in range(2):
            index = [slice(None)] * len(shape)
            index[split.dim] = shard_index(split, shape[split.dim], 2, r)
            whole[tuple(index)] = slices[r][name]
        got.append(torch.from_numpy(whole))
    a, b = reports
    if a["metrics"] != b["metrics"] or a["replicated_digest"] != b["replicated_digest"]:
        raise RuntimeError(f"the two model ranks hold different metrics ({a['metrics']} and "
                           f"{b['metrics']}) or replicated gradients")
    for r, rep in enumerate(reports):
        if rep["local_heads"] != 1:
            raise RuntimeError(f"rank {r} computes {rep['local_heads']} heads, not one")
        for name, n in rep["launches"].items():
            if not n:
                raise RuntimeError(f"rank {r} did not launch kernel {name}")
    for i, (name, g, w) in enumerate(zip(GAN_FIELDS, a["metrics"], want_metrics.tolist())):
        floor = max(abs(m[i] - w) for m in floor_metrics)
        bound = max(DP_LOSS_RTOL * max(1.0, abs(w)), 10 * floor)
        print(f"    {name}: two model ranks {g:.7g}, one process {w:.7g}, |diff| "
              f"{abs(g - w):.3e} (noise floor {floor:.3e}, bound {bound:.3e})", flush=True)
        if not abs(g - w) <= bound:
            raise RuntimeError(f"model ranks and one process: {name} differs past {bound:.3e}")
    hold_gradients(names, got, want, floors, "two model ranks vs one process")
    whole_bytes = 4 * sum(v.size for v in gen_np.values())
    for r, rep in enumerate(reports):
        print(f"  rank {r}: one head of {config.num_attention_heads}, launches {rep['launches']};"
              f" generator parameters {rep['param_bytes'] / 2**20:.1f} MiB, moments "
              f"{rep['moment_bytes'] / 2**20:.1f} MiB (one process {whole_bytes / 2**20:.1f} / "
              f"{2 * whole_bytes / 2**20:.1f} MiB); steady GAN step {rep['step_ms']:.1f} ms: "
              f"gloo {rep['gloo_ms']:.1f} ms in {rep['collectives']} all-reduces, compute "
              f"{rep['step_ms'] - rep['gloo_ms']:.1f} ms ({card})", flush=True)
    gen, disc = leaves_on(gen_np, device), leaves_on(disc_np, device)
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import make_gan_train_step

    one_ms = timed_steps({"one process": make_gan_train_step(
        config, gen, disc, vits_optimizer(gen), vits_optimizer(disc))}, batch, noise)
    print(f"  one process, the same B=4 GAN step: {one_ms['one process']:.1f} ms ({card})",
          flush=True)
    return {"ranks": reports, "one_process_step_ms": one_ms["one process"],
            "one_process_param_bytes": whole_bytes, "launches": a["launches"]}


def mp_rank(rank: int, port: int, tmp: str) -> None:
    """A rank of phase 14b (a child of :func:`mp_two_ranks`): one GAN step on its
    slices (clipped gradients to ``tmp``), its launches, bytes, and steady step
    ms with the time inside gloo's all-reduces."""
    import hashlib

    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.parallel import mesh as mesh_module
    from vits_tpu_torch.parallel.distributed import initialize
    from vits_tpu_torch.parallel.mesh import model_axis, shard_params
    from vits_tpu_torch.parallel.tensor import tensor_parallel
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import TrainBatch, TrainNoise, make_gan_train_step

    setup = json.loads(Path(f"{tmp}/setup.json").read_text())
    device = torch.device(setup["device"])
    # the replicated layers run on both ranks: deterministic algorithms keep their
    # gradients bit-identical, as the parent pins cuDNN for the comparison
    torch.backends.cudnn.deterministic = True
    initialize(f"localhost:{port}", 2, rank, device=device, backend="gloo")
    try:
        config = VitsConfig(**{k: tuples(v) for k, v in setup["config"].items()})
        with np.load(f"{tmp}/inputs.npz") as f:
            arrays = {k: f[k] for k in f.files}
        part = {prefix: {k[len(prefix) + 1:]: v for k, v in arrays.items()
                         if k.startswith(prefix + ".")} for prefix in ("gen", "disc", "batch",
                                                                      "noise")}
        gen_np, disc_np = part["gen"], part["disc"]
        batch = TrainBatch(*(None if k not in part["batch"] else
                             torch.tensor(part["batch"][k], device=device)
                             for k in TrainBatch._fields))
        noise = TrainNoise(*(torch.tensor(part["noise"][k], device=device)
                             for k in TrainNoise._fields))
        mp = model_axis(2)
        # data=1 x model=2: no data axis to sum over (gloo would copy every gradient
        # through the host to sum it over one rank)
        dp = None
        tp = tensor_parallel(gen_np, mp)

        def step_fn():
            gen = leaves_on(shard_params(gen_np, mp), device)
            disc = leaves_on(disc_np, device)
            opts = vits_optimizer(gen, model_parallel=tp), vits_optimizer(disc)
            return gen, disc, opts[0], make_gan_train_step(config, gen, disc, *opts,
                                                           data_parallel=dp, model_parallel=tp)

        gen, disc, opt, fn = step_fn()
        zero_training_launches()
        metrics = fn(batch, noise=noise)
        torch.cuda.synchronize()
        launches = training_launches()
        np.savez(f"{tmp}/grads{rank}.npz", **{k: p.grad.cpu().numpy()
                                             for k, p in {**gen, **disc}.items()})
        digest = hashlib.sha256()
        for k, p in {**gen, **disc}.items():
            if k not in tp.plan:
                digest.update(p.grad.cpu().numpy().tobytes())
        param_bytes = 4 * sum(p.numel() for p in gen.values())
        moment_bytes = 4 * sum(s["exp_avg"].numel() + s["exp_avg_sq"].numel()
                               for s in opt.adamw.state.values())
        # the time inside gloo's all-reduces (synchronised on each side) of a steady step
        gloo = {"ms": 0.0, "calls": 0}
        all_reduce = mesh_module.dist.all_reduce

        def timed_all_reduce(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = all_reduce(*args, **kwargs)
            torch.cuda.synchronize()
            gloo["ms"] += 1e3 * (time.perf_counter() - t0)
            gloo["calls"] += 1
            return result

        mesh_module.dist.all_reduce = timed_all_reduce
        try:
            times, glooms = [], []
            for i in range(4):
                gloo.update(ms=0.0, calls=0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(batch, noise=noise)
                torch.cuda.synchronize()
                if i:  # the first is a warm-up
                    times.append(1e3 * (time.perf_counter() - t0))
                    glooms.append(gloo["ms"])
        finally:
            mesh_module.dist.all_reduce = all_reduce
        report = {"metrics": [float(v) for v in metrics], "launches": launches,
                  "replicated_digest": digest.hexdigest(),
                  "local_heads": gen["text_encoder.encoder.layers.0.attention.q_proj.weight"]
                  .shape[1] // config.head_dim,
                  "param_bytes": param_bytes, "moment_bytes": moment_bytes,
                  "step_ms": float(np.median(times)), "gloo_ms": float(np.median(glooms)),
                  "collectives": gloo["calls"]}
        Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(report))
    finally:
        torch.distributed.destroy_process_group()


def model_parallel_phase(device) -> dict:
    """Phase 14's work (a child of :func:`run_child`)."""
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.train.step import fp32_backends

    card = card_line()
    kernels.library()
    t0 = time.perf_counter()
    config = VitsConfig()
    gen_np = random_weights(config, keep_training=True)
    disc_np = init_discriminator_params(0)
    params = leaves_on(gen_np, device)
    fp32_backends(params)  # the plain twins and the steps in fp32, as the training path
    print(f"  [14] kernels A with lse, 4 and 5 at phase 14's shapes against their plain "
          f"twins ({card}):", flush=True)
    measured = mp_kernels_vs_plain(params, config, device)
    batch = training_batch(config, device, MP_TOKENS, MP_FRAMES)
    # cuDNN pinned to deterministic algorithms for the comparisons, as 10d and 12a pin it
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        print(f"  [14a, 14c] the pipelined encoder on stages sharing the card, B=4 at 512 "
              f"tokens, against text_encoder ({card}):", flush=True)
        encoder = pp_encoder(config, params, batch, device, card)
        del params
        pipelined = pp_step(config, gen_np, batch, device, card)
        print(f"  [14b] tensor parallel: two gloo ranks sharing the card, data=1 x model=2, "
              f"B=4 ({card}):", flush=True)
        two_ranks = mp_two_ranks(config, gen_np, disc_np, device, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    seconds = time.perf_counter() - t0
    print(f"  phase 14: {seconds:.1f} s", flush=True)
    return {"kernels": measured, "encoder": encoder, "pipelined": pipelined,
            "two_ranks": two_ranks, "seconds": seconds, "card": card,
            "profiler_sessions": PROFILER_SESSIONS}


# the kernels entries of the JSON line that phase 14's paths launch, and their counters
MP_KERNEL_ENTRIES = {"flash_rel_attention_mp": ("flash_rel_attention_lse",),
                     "trainable_rel_attention_mp": ("rel_attention_bwd",),
                     "trainable_trio_mp": ("trio_forward_with_acts", "trio_backward")}


# --------------------------------------------------------------------------- #
# Phase 15: what vits_tpu runs that the port once refused -- kernels A and 4 past
# head_dim 128 and window 15, attention with no relative window, grad_accum
# microbatches that do not divide over the data ranks -- in a process of its own.
# --------------------------------------------------------------------------- #

REFUSALS_FLAG = "--refusals-phase"
REFUSALS_RESULT = "refusals-phase result: "
# 15a: kernels A and 4 at every head width and window pair of these, B=2, H=2, L=512
WIDE_HEAD_DIMS = (160, 192, 256)
WIDE_WINDOWS = (4, 16, 32)  # 2w+1 = 9, 33 (the first past a 32-lane chunk), 65
WIDE_LENGTHS = (507, 300)
# 15b: MMS-TTS at full width in two variants no checkpoint of the repo reaches: one
# head of 192 at window 16 (kernels A and 4 past their former ceiling), and no window
# (no kernel A or 4 at all: JAX's plain attention)
VARIANTS = {"head_dim 192, window 16": dict(num_attention_heads=1, window_size=16),
            "window 0": dict(window_size=0)}
# 15c: six rows at grad_accum=2: microbatches of three over two ranks (two and one)
UNEVEN_TOKENS = (512, 300, 448, 256, 384, 200)
UNEVEN_FRAMES = (1280, 800, 1100, 640, 960, 500)
WIDE_VARIANT = "head_dim 192, window 16"  # the variant whose path launches A and 4


def wide_kernels_vs_plain(device) -> dict:
    """15a: kernels A and 4 against their plain twins at d in WIDE_HEAD_DIMS x w in
    WIDE_WINDOWS, B=2, H=2, L=512, lengths WIDE_LENGTHS, in every mode they have: A
    on fp32 values at fast, high and highest (TIER_TOL); A on bf16 storage without
    and with lse (the serving fast tier and bf16 training), A's bf16 serving mode at
    high and highest (its fast mode is the bf16 storage route), within two bf16 ulps
    (BF16_KERNEL_TOL); 4 at exact on fp32 (KERNEL_TOL) and at fast on bf16 storage
    (BF16_KERNEL_TOL), each row over its valid length."""
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_plain
    from vits_tpu_torch.ops.cuda.attention_grad import (
        rel_attention_bwd,
        rel_attention_bwd_reference,
    )
    from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER, EXACT_TIER, Tier, resolve_tier

    rng = np.random.default_rng(15)
    B, H, L = 2, 2, 512
    lens = torch.tensor(WIDE_LENGTHS, dtype=torch.int32, device=device)
    results = {"flash_rel_attention_wide": [], "trainable_rel_attention_wide": []}

    def valid(grads):
        return (*(g[b, :, :n] for g in grads[:3] for b, n in enumerate(WIDE_LENGTHS)),
                *grads[3:])

    for d in WIDE_HEAD_DIMS:
        for w in WIDE_WINDOWS:
            f32 = [torch.tensor(rng.standard_normal(shape) * 0.5, dtype=torch.float32,
                                device=device) for shape in ((B, H, L, d),) * 4
                   + ((2 * w + 1, d),) * 2]
            bf16 = [t.to(torch.bfloat16) for t in f32]
            shape = f"d={d} w={w} B=2 H=2 L=512 len={WIDE_LENGTHS}"
            flops = attention_flops(WIDE_LENGTHS, H, d, w)
            bwd_flops = attention_flops(WIDE_LENGTHS, H, d, w, backward=True)
            modes = [(name, f32, resolve_tier(None if name == "fast" else name), False,
                      TIER_TOL[name], TIER_PEAK[name]) for name in ("fast", "high", "highest")]
            modes += [("bf16 storage", bf16, BF16_TRAIN_TIER, False, BF16_KERNEL_TOL,
                       PEAK_BF16_FLOPS),
                      ("bf16 storage+lse", bf16, BF16_TRAIN_TIER, True, BF16_KERNEL_TOL,
                       PEAK_BF16_FLOPS)]
            modes += [(f"bf16 serving {name}", bf16,
                       resolve_tier(name)._replace(bf16_compute=True), False, BF16_KERNEL_TOL,
                       TIER_PEAK[name]) for name in ("high", "highest")]
            for label, (q, k, v, _, rel_k, rel_v), tier, lse, tol, peak in modes:
                plain_tier = tier._replace(bf16_compute=False)
                args = (q, k, v, rel_k, rel_v)
                out = flash_rel_attention(*args, window=w, lengths=lens, tier=tier)
                results["flash_rel_attention_wide"].append(compare(
                    "flash_rel_attention", f"{shape} {label}",
                    lambda: flash_rel_attention(*args, window=w, lengths=lens, return_lse=lse,
                                                tier=tier),
                    lambda: rel_attention_plain(*args, window=w, lengths=lens, return_lse=lse,
                                                tier=plain_tier),
                    tol=tol, peak=peak, work=(flops, nbytes(*args, lens, out) + (
                        4 * B * H * L if lse else 0))))
            for label, (q, k, v, dout, rel_k, rel_v), tier, tol, peak in (
                    ("exact", f32, EXACT_TIER, KERNEL_TOL, PEAK_FP32_ACCURATE_FLOPS),
                    ("bf16 storage", bf16, BF16_TRAIN_TIER, BF16_KERNEL_TOL, PEAK_BF16_FLOPS)):
                out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                               return_lse=True, tier=tier)
                args = (q, k, v, rel_k, rel_v, lse, dout, out)
                results["trainable_rel_attention_wide"].append(compare(
                    "rel_attention_bwd", f"{shape} {label} valid region",
                    lambda: valid(rel_attention_bwd(*args, window=w, lengths=lens, tier=tier)),
                    lambda: valid(rel_attention_bwd_reference(*args, window=w, lengths=lens,
                                                              tier=tier)),
                    tol=tol, peak=peak,
                    work=(bwd_flops, nbytes(*args, lens, q, k, v, rel_k, rel_v))))
    return results


def attention_launches() -> dict:
    """Kernel A's (all, and with lse) and kernel 4's launch counts."""
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.attention_grad import rel_attention_bwd

    return {"flash_rel_attention": flash_rel_attention.launches,
            "flash_rel_attention_lse": flash_rel_attention.lse_launches,
            "rel_attention_bwd": rel_attention_bwd.launches}


def rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def variant_requests(config, label: str, device, card: str) -> dict:
    """15b: the 87-token request through the engine at "exact" and at "fast" (its
    frames, steady ms, device busy ms and the kernels' launches), then the same text
    on one NoiseOverride on the card and through the CPU plain path at the same
    tier. At "exact" phase 4's bounds: equal frame counts, LATENT_RTOL, WAVE_ATOL.
    At "fast" the kernels round their operands where the JAX kernels do, not where
    their twins do (kernel A rounds a running softmax weight, its twin the
    normalised one: TIER_TOL), and the card's fp32 sums in another order put values
    on the other side of a bf16 rounding, which the saturating random-weight
    vocoder amplifies; so fp32's bounds do not apply there. It is held with equal
    frame counts, the latents within the fast tier's kernel bound (TIER_TOL, of
    max(1, max|plain|)), the waveform's mel-L1 within phase 9's fast-tier bound
    (FAST_STREAM_MEL_L1), and a waveform other than exact's (the tier in effect)."""
    import vits_tpu_torch
    from vits_tpu_torch import EngineConfig
    from vits_tpu_torch.models.vits import NoiseOverride, synthesize
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage

    blob = checkpoint(config, False)
    rng = np.random.default_rng(5)
    num_frames = 1024  # room for the 87 tokens' frames at random weights
    dur = rng.standard_normal((1, 128, 2)).astype(np.float32)
    prior = rng.standard_normal((1, num_frames, config.flow_size)).astype(np.float32)
    windowed = bool(config.window_size)

    def run(m) -> dict:
        """The text on the NoiseOverride through ``m`` (the engine's tiers and packs)."""
        ids, mask = m.tokenizer.pad([m.tokenizer.encode(SINGLE_TEXTS[1])], pad_to=128)
        dev = m.device
        with torch.inference_mode():
            out = synthesize(
                m.params, config, torch.tensor(ids, dtype=torch.long, device=dev),
                torch.tensor(mask, dtype=torch.float32, device=dev), num_frames,
                noise=NoiseOverride(torch.tensor(dur, device=dev),
                                    torch.tensor(prior, device=dev)),
                use_pallas_flow=m.engine.use_pallas_flow, flow_pack=m._flow_pack(),
                tiers=m.tiers, vocoder_packs=m._vocoder_packs())
        return {k: getattr(out, k).float().cpu().numpy()
                for k in ("waveform", "latents", "frame_lengths")}

    results, outs = {}, {}
    for tier in ("exact", "fast"):
        kw = EngineConfig.fidelity_kwargs(tier)
        model = vits_tpu_torch.load_model(blob, EngineConfig(**kw), device=device)
        model.synthesize_raw([SINGLE_TEXTS[1]], seed=[5])  # cuDNN's algorithms, the packs
        for fn in (fused_resblock_trio, fused_stage):
            fn.launches = 0
        zero_training_launches()
        profile = request_profile(model, card, reps=2)
        launches = {**attention_launches(), "fused_resblock_trio": fused_resblock_trio.launches,
                    "fused_stage": fused_stage.launches}
        if windowed != (launches["flash_rel_attention"] > 0) or not launches["fused_stage"]:
            raise RuntimeError(f"{label} at {tier}: kernel launches {launches}")
        print(f"  {label} at {tier}: launches {launches} ({card})", flush=True)
        outs["card", tier] = run(model)
        outs["cpu", tier] = run(vits_tpu_torch.load_model(blob, EngineConfig(
            use_pallas_vocoder=True, use_pallas_attention=True, **kw), device="cpu"))
        check_audio(outs["card", tier]["waveform"][0], f"{label} at {tier}")
        results[tier] = {**profile, "launches": launches}
    check_close(f"{label}, 87 tokens at exact", outs["card", "exact"], outs["cpu", "exact"])
    card_out, cpu_out = outs["card", "fast"], outs["cpu", "fast"]
    frames = int(cpu_out["frame_lengths"][0])
    latent_err = float(np.abs(card_out["latents"] - cpu_out["latents"]).max())
    latent_tol = TIER_TOL["fast"] * max(1.0, float(np.abs(cpu_out["latents"]).max()))
    wave = [o["waveform"][0, : frames * config.total_upsample] for o in (card_out, cpu_out)]
    mel = mel_l1(wave[0][None], wave[1][None], config.sampling_rate)
    print(f"  card vs CPU plain path, {label} at fast: frames "
          f"{card_out['frame_lengths'].tolist()} / {cpu_out['frame_lengths'].tolist()}, latents "
          f"max|diff| {latent_err:.3e} (tol {latent_tol:.3e}), relative L2 "
          f"{rel_l2(card_out['latents'], cpu_out['latents']):.3e}; waveform mel-L1 {mel:.3e} "
          f"(bound {FAST_STREAM_MEL_L1})", flush=True)
    if not np.array_equal(card_out["frame_lengths"], cpu_out["frame_lengths"]):
        raise RuntimeError(f"{label} at fast: card and CPU predict different frame counts")
    if not (latent_err <= latent_tol and mel <= FAST_STREAM_MEL_L1):
        raise RuntimeError(f"{label} at fast: card and CPU differ past the bound")
    if np.array_equal(card_out["waveform"], outs["card", "exact"]["waveform"]):
        raise RuntimeError(f"{label}: the fast tier computed what exact computes")
    results["fast"].update(latents_max_abs_vs_cpu=latent_err, mel_l1_vs_cpu=mel)
    return results


def refusals_phase(device) -> dict:
    """Phase 15's work (a child of :func:`run_child`)."""
    from vits_tpu_torch import VitsConfig
    from vits_tpu_torch.models.discriminator import init_discriminator_params
    from vits_tpu_torch.ops import cuda as kernels

    card = card_line()
    kernels.library()
    t0 = time.perf_counter()
    print(f"  [15a] kernels A and 4 past head_dim 128 and window 15 against their plain twins "
          f"({card}):", flush=True)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    measured = wide_kernels_vs_plain(device)
    print(f"  15a: {time.perf_counter() - t0:.1f} s", flush=True)
    variants = {}
    for label, fields in VARIANTS.items():
        config = dataclasses.replace(VitsConfig(), **fields)
        print(f"  [15b] MMS-TTS width, {label} (head_dim {config.head_dim}), random weights "
              f"({card}):", flush=True)
        variants[label] = variant_requests(config, label, device, card)
        # one step after the warm-up (phase 7 times three): keeps the script inside its
        # time with phase 16
        trained = gan_steps(config, device, card, attention_kernels=bool(config.window_size),
                            profile=False, steps=1)
        train_card_vs_cpu(config, trained["gen"], trained["batch"])
        variants[label]["training"] = {"launches": trained["launches"],
                                       "step_ms": trained["step_ms"]}
        del trained
        torch.cuda.empty_cache()
    print(f"  [15c] two gloo ranks sharing the card, six rows at grad_accum=2 (microbatches "
          f"of three over two ranks) ({card}):", flush=True)
    config = VitsConfig()
    uneven = dp_two_ranks(config, random_weights(config, keep_training=True),
                          init_discriminator_params(0), device, card, UNEVEN_TOKENS,
                          UNEVEN_FRAMES, grad_accum=2, full=False)
    seconds = time.perf_counter() - t0
    print(f"  phase 15: {seconds:.1f} s", flush=True)
    return {"kernels": measured, "variants": variants,
            "uneven": {"launches": uneven["launches"],
                       "metrics": [r["metrics"] for r in uneven["ranks"]]},
            "seconds": seconds, "card": card, "profiler_sessions": PROFILER_SESSIONS}



STARTUP_FLAG = "--startup-phase"
STARTUP_RESULT = "startup-phase result: "
# A server started from an artifact: the flag, its mode ("bundle" or "cache"), the
# checkpoint, the artifact's directory, the frame ratio (cache), an output .npz and
# the parent's clock at the start (time.time()).
STARTUP_CHILD_FLAG = "--startup-child"
STARTUP_CHILD_RESULT = "startup-child result: "
# 16's requests, every one at the 87-token request's bucket and with per-row seeds:
# that request alone, a batch of four (both exported) and a batch of three (a miss).
STARTUP_REQUESTS = {
    "one": ((SINGLE_TEXTS[1],), (5,)),
    "four": ((SINGLE_TEXTS[1],) + BATCH_TEXTS, (5,) + BATCH_SEEDS),
    "three": ((SINGLE_TEXTS[1],) + BATCH_TEXTS[:2], (5,) + BATCH_SEEDS[:2]),
}
DEVPROFILE_RTOL = 0.02  # devprofile's busy ms of the 87-token request against phase 9's
DEVPROFILE_READINGS = 3  # the median of this many device_ms readings
DEVPROFILE_ATTEMPTS = 3  # profiler sessions a reading may take for a lost record


def startup_requests(model, first_audio=None) -> dict:
    """STARTUP_REQUESTS through ``model.synthesize`` in order: each row's audio,
    checked; ``first_audio()`` is called once the first request's audio is back."""
    out = {}
    for name, (texts, seeds) in STARTUP_REQUESTS.items():
        waves = model.synthesize(list(texts), seed=list(seeds))
        if first_audio is not None and not out:
            first_audio()
        for i, wave in enumerate(waves):
            check_audio(wave, f"startup request {name} row {i}")
            out[f"{name}_{i}"] = wave
    return out


def _no_nvcc():
    raise RuntimeError("nvcc is hidden from this process: a build was attempted")


def startup_child(device, mode: str, ckpt: str, artifact: str, ratio: float, out: str,
                  t_start: float) -> None:
    """16b/16c: a fresh process with nvcc hidden (off PATH, no CUDA_HOME, and any
    build raising) that serves STARTUP_REQUESTS from the bundle (``mode`` "bundle")
    or the library cache ("cache"); prints its result line."""
    import vits_tpu_torch
    from vits_tpu_torch import EngineConfig
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
    from vits_tpu_torch.ops.cuda.resblock import fused_resblock_trio
    from vits_tpu_torch.ops.cuda.stage import fused_stage

    kernels._nvcc = _no_nvcc
    wrappers = (flash_rel_attention, fused_resblock_trio, fused_stage)
    engine = (EngineConfig(aot_bundle_dir=artifact) if mode == "bundle"
              else EngineConfig(compilation_cache_dir=artifact, frames_per_token=ratio))
    model = vits_tpu_torch.load_model(ckpt, engine, device=device)
    for fn in wrappers:
        fn.launches = 0
    first = {}
    waves = startup_requests(model, lambda: first.setdefault("s", time.time() - t_start))
    np.savez(out, **waves)
    print(STARTUP_CHILD_RESULT + json.dumps({
        "mode": mode, "first_audio_s": first["s"], "build_seconds": kernels.build_seconds,
        "library": str(kernels.loaded_library()),
        "launches": {fn.__name__: fn.launches for fn in wrappers},
        **{k: v for k, v in model.stats.items() if k.startswith("aot_")}}), flush=True)


def run_startup_child(mode: str, ckpt: str, artifact: str, ratio: float, tmp: str) -> dict:
    """:func:`startup_child` in a process of its own, with nvcc off PATH and no
    CUDA_HOME; its result and its audio."""
    import os
    import shutil

    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    if shutil.which("nvcc", path=env["PATH"]) is not None:
        raise RuntimeError("nvcc is still on the child's PATH")
    out = str(Path(tmp) / f"{mode}.npz")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), STARTUP_CHILD_FLAG, mode, ckpt,
         artifact, repr(ratio), out, repr(time.time())],
        capture_output=True, text=True, timeout=300, check=False, env=env)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(STARTUP_CHILD_RESULT):
            result = json.loads(line[len(STARTUP_CHILD_RESULT):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or result is None:
        raise RuntimeError(f"16 {mode} child failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    with np.load(out) as f:
        result["audio"] = {k: f[k] for k in f.files}
    return result


def same_audio(what: str, got: dict, want: dict) -> None:
    """Every row bit-identical to the exporting engine's."""
    if got.keys() != want.keys():
        raise RuntimeError(f"{what}: rows {sorted(got)} != {sorted(want)}")
    for key in want:
        if got[key].shape != want[key].shape or not np.array_equal(got[key], want[key]):
            diff = (float(np.abs(got[key] - want[key]).max())
                    if got[key].shape == want[key].shape else None)
            raise RuntimeError(f"{what}: row {key} differs from the exporting engine's "
                               f"(shapes {got[key].shape}, {want[key].shape}; max|diff| {diff})")


def startup_phase(device) -> dict:
    """Phase 16's work (a child of :func:`run_child`)."""
    import hashlib
    import shutil
    import tempfile

    import vits_tpu_torch
    from vits_tpu_torch import EngineConfig, VitsConfig
    from vits_tpu_torch.io.aot import MANIFEST, export_bundle
    from vits_tpu_torch.ops import cuda as kernels
    from vits_tpu_torch.utils import devprofile

    card = card_line()
    t0 = time.perf_counter()
    kernels.library()  # phase 2's build, found in the build directory
    if kernels.build_seconds != 0.0:
        raise RuntimeError(f"16 built the library again ({kernels.build_seconds} s of nvcc)")
    tmp = tempfile.mkdtemp(prefix="startup_")
    try:
        ckpt = str(Path(tmp) / "mms.ggml")
        Path(ckpt).write_bytes(checkpoint(VitsConfig(), keep_training=False))
        bundle, cache = str(Path(tmp) / "bundle"), str(Path(tmp) / "cache")

        print(f"  [16a] export a fast bundle of MMS-TTS (random weights) at the 87-token "
              f"request's bucket, batch 1 and 4 ({card}):", flush=True)
        model = vits_tpu_torch.load_model(ckpt, EngineConfig(), device=device)
        for _ in range(4):  # raise the frame ratio until these requests fit it
            redispatches = model.stats["redispatches"]
            startup_requests(model)
            if model.stats["redispatches"] == redispatches:
                break
        else:
            raise RuntimeError("16a: the requests still overflow after four passes")
        bucket = next(b for b in model.engine.token_buckets
                      if b >= len(model.tokenizer.encode(SINGLE_TEXTS[1])))
        t_export = time.perf_counter()
        manifest = export_bundle(model, bundle, batch_sizes=(1, 4), token_buckets=(bucket,),
                                 per_row_seeds=(False, True), with_speaker=False)
        export_s = time.perf_counter() - t_export
        ratio = manifest["frames_per_token"]
        redispatches = model.stats["redispatches"]
        want = startup_requests(model)
        if model.stats["redispatches"] != redispatches:
            raise RuntimeError("16a: a request overflowed the exported frame capacity")
        lib = manifest["library"]
        bundle_bytes = sum(f.stat().st_size for f in Path(bundle).iterdir())
        signatures = [(e["batch"], e["tokens"], e["frames"], e["rng_rows"])
                      for e in manifest["programs"]]
        print(f"  bundle: {len(signatures)} signatures {signatures}, frames_per_token "
              f"{ratio}, library {lib['file']} (sha256 {lib['sha256'][:16]}...), "
              f"{bundle_bytes} bytes, exported in {export_s:.2f} s ({card})", flush=True)
        if lib["file"] != kernels.loaded_library().name:
            raise RuntimeError("the bundle's library is not the loaded one")
        vits_tpu_torch.load_model(ckpt, EngineConfig(compilation_cache_dir=cache), device=device)
        cached = Path(cache) / lib["file"]
        if hashlib.sha256(cached.read_bytes()).hexdigest() != lib["sha256"]:
            raise RuntimeError(f"compilation_cache_dir did not receive the loaded library")
        print(f"  compilation_cache_dir {cache}: the loaded library copied in", flush=True)

        children = {}
        for mode, artifact in (("bundle", bundle), ("cache", cache)):
            print(f"  [16{'b' if mode == 'bundle' else 'c'}] a process with nvcc hidden "
                  f"serving from the {mode} ({card}):", flush=True)
            run = run_startup_child(mode, ckpt, artifact, ratio, tmp)
            same_audio(f"16 {mode} child", run.pop("audio"), want)
            if run["build_seconds"] != 0.0 or Path(run["library"]).parent != Path(artifact):
                raise RuntimeError(f"16 {mode} child did not load the {mode}'s library: {run}")
            if not all(run["launches"].values()):
                raise RuntimeError(f"16 {mode} child missed a kernel: {run['launches']}")
            if mode == "bundle" and (run["aot_hits"], run["aot_misses"]) != (2, 1):
                raise RuntimeError(f"16 bundle child: hits {run['aot_hits']}, misses "
                                   f"{run['aot_misses']}, not 2 and 1 (batch 3 a miss)")
            children[mode] = run
            print(f"  {mode}: first audio {run['first_audio_s']:.2f} s after the process "
                  f"started, build_seconds {run['build_seconds']}, "
                  + (f"hits {run['aot_hits']} misses {run['aot_misses']}, " if mode == "bundle"
                     else "") + f"launches {run['launches']}; every row bit-identical to "
                  f"the exporting engine's ({card})", flush=True)

        print(f"  [16d] refusals ({card}):", flush=True)
        refusals = {}
        try:
            vits_tpu_torch.load_model(ckpt, EngineConfig(
                aot_bundle_dir=bundle, **EngineConfig.fidelity_kwargs("exact")), device=device)
        except ValueError as exc:
            refusals["exact engine"] = str(exc)[:200]
        tampered = str(Path(tmp) / "tampered")
        shutil.copytree(bundle, tampered)
        lib_file = Path(tampered) / lib["file"]
        data = bytearray(lib_file.read_bytes())
        data[len(data) // 2] ^= 0x01
        lib_file.write_bytes(bytes(data))
        loads, real_load = [], kernels.load_library
        kernels.load_library = lambda *a: loads.append(a) or real_load(*a)
        try:
            vits_tpu_torch.load_model(ckpt, EngineConfig(aot_bundle_dir=tampered), device=device)
        except ValueError as exc:
            refusals["one byte flipped"] = str(exc)[:200]
        finally:
            kernels.load_library = real_load
        if len(refusals) != 2 or loads:
            raise RuntimeError(f"16d: refused {sorted(refusals)}, library loads {loads}")
        for what, msg in refusals.items():
            print(f"    {what}: ValueError: {msg}", flush=True)
        if json.loads(Path(bundle, MANIFEST).read_text()) != manifest:
            raise RuntimeError("16d changed the bundle")

        print(f"  [16e] devprofile.device_ms of the 87-token request at fast ({card}):",
              flush=True)
        fast = vits_tpu_torch.load_model(ckpt, EngineConfig(), device=device)

        def request():
            return fast.synthesize_raw([SINGLE_TEXTS[1]], seed=[5])

        request()  # as phase 9: one call, then the measured one
        sessions = PROFILER_SESSIONS["sessions"]
        readings = []
        for _ in range(DEVPROFILE_READINGS):
            reading = devprofile.read(request, attempts=DEVPROFILE_ATTEMPTS)
            PROFILER_SESSIONS["sessions"] += reading.sessions
            PROFILER_SESSIONS["rerun"] += reading.sessions - (0 if reading.lost else 1)
            if reading.lost:
                raise devprofile.LostRecords("; ".join(reading.lost))
            readings.append(reading)
        busy = float(np.median([r.busy_ms for r in readings]))
        first = readings[0]
        print(f"    busy {busy:.4f} ms (median of {[r.busy_ms for r in readings]}); "
              f"{first.host_calls} host calls that put work on the card, each with its "
              f"device record; {first.port_held} of the {len(first.invocations)} records of "
              f"the port's kernels have their host call in the trace; "
              f"{PROFILER_SESSIONS['sessions'] - sessions} sessions for "
              f"{DEVPROFILE_READINGS} readings ({card})", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    print(f"  phase 16: {seconds:.1f} s", flush=True)
    return {"bundle": {"signatures": signatures, "frames_per_token": ratio,
                       "bytes": bundle_bytes, "library": lib["file"], "export_s": export_s},
            "children": children, "refusals": refusals,
            "devprofile": {"busy_ms": busy, "readings_ms": [r.busy_ms for r in readings],
                           "host_calls": readings[0].host_calls,
                           "port_records": len(readings[0].invocations),
                           "port_records_held": readings[0].port_held,
                           "sessions": [r.sessions for r in readings]},
            "seconds": seconds, "card": card, "profiler_sessions": PROFILER_SESSIONS}


def run_child(flag: str, prefix: str, phase: int) -> dict:
    """A phase in a child process: after phases 3-8 in one process,
    torch.profiler loses every device record of kernel A's sessions (phase 9's
    fast tier, three times over; phase 10's bf16 calls); a fresh process
    profiles them. The child's lines are printed here; it fails
    the run if it fails."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag],
                          capture_output=True, text=True, timeout=900, check=False)
    result = None
    for line in proc.stdout.splitlines():
        if line.startswith(prefix):
            result = json.loads(line[len(prefix):])
        else:
            print(line, flush=True)
    if proc.returncode != 0 or result is None:
        raise RuntimeError(f"phase {phase} failed (exit {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    for key in PROFILER_SESSIONS:
        PROFILER_SESSIONS[key] += result["profiler_sessions"][key]
    return result


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is visible")
    device = torch.device("cuda")
    if sys.argv[1:] == [TIERS_FLAG]:
        print(TIERS_RESULT + json.dumps(tiers_phase(device)), flush=True)
        return
    if sys.argv[1:] == [TRAINING_FLAG]:
        print(TRAINING_RESULT + json.dumps(bf16_training_phase(device)), flush=True)
        return
    if sys.argv[1:] == [SERVE16_FLAG]:
        print(SERVE16_RESULT + json.dumps(bf16_serving_phase(device)), flush=True)
        return
    if sys.argv[1:] == [DP_FLAG]:
        print(DP_RESULT + json.dumps(data_parallel_phase(device)), flush=True)
        return
    if sys.argv[1:2] == [DP_RANK_FLAG]:
        dp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if sys.argv[1:] == [MULTI_FLAG]:
        print(MULTI_RESULT + json.dumps(multi_device_phase(device)), flush=True)
        return
    if sys.argv[1:] == [MP_FLAG]:
        print(MP_RESULT + json.dumps(model_parallel_phase(device)), flush=True)
        return
    if sys.argv[1:2] == [MP_RANK_FLAG]:
        mp_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        return
    if sys.argv[1:] == [REFUSALS_FLAG]:
        print(REFUSALS_RESULT + json.dumps(refusals_phase(device)), flush=True)
        return
    if sys.argv[1:] == [STARTUP_FLAG]:
        print(STARTUP_RESULT + json.dumps(startup_phase(device)), flush=True)
        return
    if sys.argv[1:2] == [STARTUP_CHILD_FLAG]:
        mode, ckpt, artifact, ratio, out, t_start = sys.argv[2:]
        startup_child(device, mode, ckpt, artifact, float(ratio), out, float(t_start))
        return
    import atexit
    import os
    import shutil
    import tempfile

    t_run = time.perf_counter()
    weights = tempfile.mkdtemp(prefix="chip_smoke_weights_")
    os.environ[WEIGHTS_ENV] = weights  # random_weights: shared with the child phases
    atexit.register(shutil.rmtree, weights, True)
    card = card_line()
    print("[1/16] card (nvidia-smi name, power limit):", flush=True)
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
    print(f"[2/16] build: {time.perf_counter() - t0:.1f} s (nvcc {kernels.build_seconds:.1f} s) "
          f"-> {kernels.library_path().name}", flush=True)

    t0 = time.perf_counter()
    model = make_model(device, engine_config=exact_engine())
    # the published VCTK VITS (jaywalnut310/vits configs/vctk_base.json), random weights
    # with the posterior encoder for voice conversion
    vctk = make_model(device, VitsConfig(**VCTK), exact_engine(use_pallas_flow=True),
                      keep_training=True)
    # MMS-TTS's text side with HiFi-GAN V2's decoder (jik876/hifi-gan config_v2.json)
    narrow = make_model(device, VitsConfig(upsample_initial_channel=128), exact_engine())
    print(f"      models (MMS, VCTK, HiFi-GAN V2 decoder) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 must be off on the main path")
    print(f"[3/16] kernels vs plain on the card ({card}), tolerance "
          f"{KERNEL_TOL} x max(1, max|plain|) per output:", flush=True)
    measured = kernels_vs_plain(model.params, model.config, device)
    for runs in (training_kernels_vs_plain(model.params, model.config, device),
                 slice_kernels_vs_plain(vctk, narrow, device)):
        for name, shapes in runs.items():
            measured.setdefault(name, []).extend(shapes)
    stage_probe = block_probe_at_stage_shape(model.params, model.config, device)

    print(f"[4/16] the slice at MMS-TTS width, random weights ({card}):", flush=True)
    paths = {"mms": run_slice(model, card, (flash_rel_attention, fused_resblock_trio,
                                            fused_stage))}
    card_vs_cpu(model)
    mms_request = request_profile(model, card)

    print(f"[5/16] multi-speaker serving at VCTK width, use_pallas_flow=True ({card}):",
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

    print(f"[6/16] narrow vocoder: HiFi-GAN V2 decoder at upsample_initial_channel=128 "
          f"({card}):", flush=True)
    narrow_run = narrow_vocoder(narrow, card, (flash_rel_attention, fused_resblock, fused_stage))
    paths["narrow"] = narrow_run

    print(f"[7/16] training at MMS-TTS width, random weights ({card}):", flush=True)
    config = model.config
    del model, vctk, narrow
    trained = gan_steps(config, device, card)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 must be off on the training path")
    train_card_vs_cpu(config, trained["gen"], trained["batch"])
    del trained["gen"], trained["batch"]
    train_loop(card)

    print(f"[8/16] streaming and HTTP serving ({card}):", flush=True)
    serving_layer_run = serving_layer(device, card, (flash_rel_attention, fused_resblock_trio,
                                                     fused_stage, fused_flow))
    for path in ("stream", "mux", "server"):
        paths[path] = serving_layer_run[path]

    print(f"[9/16] the precision tiers, in a process of its own ({card}):", flush=True)
    tiers = run_child(TIERS_FLAG, TIERS_RESULT, 9)
    tier_measured, tiers_run, cli_run = tiers["kernels"], tiers["requests"], tiers["cli"]

    print(f"[10/16] bf16 training at MMS-TTS width, random weights, in a process of its own "
          f"({card}):", flush=True)
    training = run_child(TRAINING_FLAG, TRAINING_RESULT, 10)
    measured.update(training["kernels"])
    bf16_run = training["run"]

    print(f"[11/16] bf16 serving (compute_dtype=\"bfloat16\") at MMS-TTS, VCTK and HiFi-GAN V2 "
          f"width, random weights, in a process of its own ({card}):", flush=True)
    serving16 = run_child(SERVE16_FLAG, SERVE16_RESULT, 11)
    measured.update(serving16["kernels"])
    serve16_run = serving16["requests"]

    print(f"[12/16] data-parallel training at MMS-TTS width, random weights, in a process of "
          f"its own ({card}):", flush=True)
    data_parallel = run_child(DP_FLAG, DP_RESULT, 12)

    print(f"[13/16] multi-device serving: a mesh engine, ShardedDecoder and serve() over "
          f"replicas sharing the card, in a process of its own ({card}):", flush=True)
    multi = run_child(MULTI_FLAG, MULTI_RESULT, 13)

    print(f"[14/16] model-parallel training: the GPipe encoder over stages and two "
          f"tensor-parallel ranks sharing the card, in a process of its own ({card}):",
          flush=True)
    model_parallel = run_child(MP_FLAG, MP_RESULT, 14)
    measured.update(model_parallel["kernels"])

    print(f"[15/16] what the port once refused: kernels A and 4 past head_dim 128 and window "
          f"15, attention without a window, uneven grad_accum microbatches over two ranks, in "
          f"a process of its own ({card}):", flush=True)
    refusals = run_child(REFUSALS_FLAG, REFUSALS_RESULT, 15)
    measured.update(refusals["kernels"])

    print(f"[16/16] serving start-up artifacts: an AOT bundle and the library cache, each "
          f"served by a process with nvcc hidden, their refusals, and devprofile, in a "
          f"process of its own ({card}):", flush=True)
    startup = run_child(STARTUP_FLAG, STARTUP_RESULT, 16)
    phase9_busy = tiers_run["fast"]["device_busy_ms"]
    startup["devprofile"]["phase9_busy_ms"] = phase9_busy
    rel = abs(startup["devprofile"]["busy_ms"] - phase9_busy) / phase9_busy
    print(f"  devprofile's busy ms {startup['devprofile']['busy_ms']:.4f} against phase 9's "
          f"{phase9_busy:.4f}: {100 * rel:.2f}% apart (bound {100 * DEVPROFILE_RTOL:.0f}%); "
          f"first audio with nvcc's build of phase 2 ({kernels.build_seconds:.1f} s) ahead of "
          f"the cache child's {startup['children']['cache']['first_audio_s']:.2f} s: "
          f"{kernels.build_seconds + startup['children']['cache']['first_audio_s']:.1f} s "
          f"({card})", flush=True)
    if not rel <= DEVPROFILE_RTOL:
        raise RuntimeError(f"devprofile's busy ms is {100 * rel:.2f}% from phase 9's")

    train_launches = trained["launches"]
    serving = {name: sum(path["launches"].get(name, 0) for path in paths.values())
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
        "fused_resblock": ("vits_tpu_torch/csrc/resblock_block.cu",
                           "vits_tpu/ops/pallas/resblock.py:629"),
    }
    # phase 10: the same kernels on bf16 storage, their launches over its three bf16 steps
    for name in ("flash_rel_attention", "trainable_rel_attention", "trainable_trio"):
        sources[name + "_bf16"] = sources[name]
    # phase 11: the serving kernels' bf16 serving mode, their launches over its request
    # paths (warmup apart)
    for name in SERVE16_KERNELS:
        sources[name + "_bf16_serve"] = sources[name]
    # phase 14: A with lse and 4 at a pipeline microbatch and one rank's head, 5 on the
    # gathered weights; their launches over 14a's pipelined steps and 14b's rank 0
    for name in MP_KERNEL_ENTRIES:
        sources[name] = sources[name[:-len("_mp")]]
    # phase 15: A and 4 past head_dim 128 and window 15; their launches over 15b's
    # head_dim-192, window-16 variant (its requests at both tiers and three GAN steps)
    wide = refusals["variants"][WIDE_VARIANT]
    for name in ("flash_rel_attention_wide", "trainable_rel_attention_wide"):
        sources[name] = sources[name[:-len("_wide")]]
    mp_paths = {f"14a_pp_step {label}": run["launches"]
                for label, run in model_parallel["pipelined"].items()}
    mp_paths["14b_rank0"] = model_parallel["two_ranks"]["launches"]
    bf16_launches = bf16_run["bfloat16"]["launches"]
    launches = {**serving, "trainable_rel_attention": train_launches["rel_attention_bwd"],
                "trainable_trio": train_launches["trio_forward_with_acts"],
                "flash_rel_attention_bf16": bf16_launches["flash_rel_attention"],
                "trainable_rel_attention_bf16": bf16_launches["rel_attention_bwd"],
                "trainable_trio_bf16": bf16_launches["trio_forward_with_acts"],
                **{name + "_bf16_serve": sum(counts[name] for path, counts in
                                             serve16_run["launches"].items() if path != "warmup")
                   for name in SERVE16_KERNELS},
                **{name: sum(counts[counters[0]] for counts in mp_paths.values())
                   for name, counters in MP_KERNEL_ENTRIES.items()},
                "flash_rel_attention_wide": sum(wide[t]["launches"]["flash_rel_attention"]
                                                for t in ("exact", "fast"))
                + wide["training"]["launches"]["flash_rel_attention"],
                "trainable_rel_attention_wide": wide["training"]["launches"]["rel_attention_bwd"]}
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
            "device_ms": sum(r["device_ms"] for r in timed),
            "plain_device_ms": sum(r["plain_device_ms"] for r in timed),
            "bound_ms": sum(r["bound_ms"] for r in timed),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "launches_by_path": {path: run["launches"].get(name) for path, run in paths.items()},
            # the queue's order: launches x the mean over the timed shapes of (device ms - bound)
            "priority": launches[name] * sum(r["device_ms"] - r["bound_ms"] for r in timed)
            / len(timed),
            "shapes": runs,
            # phase 9: each tier's sums over its shapes, and the launches of each
            # fidelity tier's requests
            "tiers": {label: {
                key: sum(r[key] for r in tier_runs) for key in
                ("device_ms", "ms", "plain_ms", "plain_device_ms", "bound_ms")} | {
                "max_abs_err": max(r["max_abs_err"] for r in tier_runs),
                "bound_by": "operations" if sum(r["ops_ms"] for r in tier_runs)
                >= sum(r["bytes_ms"] for r in tier_runs) else "bytes"}
                for label, tier_runs in tier_measured.get(name, {}).items()},
            "tier_launches": {label: run["launches"].get(name) for label, run in
                              {**tiers_run, "cli_default": cli_run}.items()},
        })
        print(f"  {name:24s} launches {launches[name]:4d} x mean (device ms - bound ms) = "
              f"{report['kernels'][-1]['priority']:.2f}", flush=True)
    for entry in report["kernels"]:
        if entry["name"] == "flash_rel_attention":
            entry["lse_launches_training"] = train_launches["flash_rel_attention_lse"]
        if entry["name"] == "trainable_trio":  # the forward's launches above; the backward's here
            entry["backward_launches"] = train_launches["trio_backward"]
            entry["backward_source"] = "vits_tpu_torch/csrc/trio_grad.cu"
        if entry["name"] in DP_KERNEL_ENTRIES:  # phase 12's path: world 1 (NCCL), 12b's rank 0
            counts = DP_KERNEL_ENTRIES[entry["name"]]
            entry["data_parallel_launches"] = {
                "world_one": {c: data_parallel["world_one"]["launches"][c] for c in counts},
                "two_ranks_rank0": {c: data_parallel["two_ranks"]["launches"][c] for c in counts}}
        if entry["name"] in MULTI_KERNELS:  # phase 13's paths, by kernel, replica and device
            entry["multi_device_launches"] = {
                path: {key: n for key, n in run["per_replica"].items()
                       if key.startswith(entry["name"] + " |")}
                for path, run in (("13a_mesh", multi["mesh_mms"]), ("13b_vctk", multi["mesh_vctk"]),
                                  ("13c_sharded2", multi["sharded"]["2"]),
                                  ("13c_sharded3", multi["sharded"]["3"]),
                                  ("13d_http", multi["http"]))}
        if entry["name"] == "trainable_trio_bf16":
            entry["backward_launches"] = bf16_launches["trio_backward"]
            entry["backward_source"] = "vits_tpu_torch/csrc/trio_grad.cu"
        if entry["name"] in MP_KERNEL_ENTRIES:  # phase 14's paths, by path and counter
            counters = MP_KERNEL_ENTRIES[entry["name"]]
            entry["model_parallel_launches"] = {
                path: {c: counts[c] for c in counters} for path, counts in mp_paths.items()}
            wrapper = {"flash_rel_attention_mp": "flash_rel_attention",
                       "trainable_rel_attention_mp": "rel_attention_bwd"}.get(entry["name"])
            if wrapper is not None:  # A's and 4's launches booked to each pipeline stage
                entry["stage_launches"] = {
                    label: {k: n for k, n in run["stage_launches"].items()
                            if k.startswith(wrapper + " |")}
                    for label, run in model_parallel["pipelined"].items()}
        if entry["name"] == "flash_rel_attention_wide":
            entry["lse_launches_training"] = wide["training"]["launches"][
                "flash_rel_attention_lse"]
        if entry["name"] in ("flash_rel_attention", "fused_resblock_trio", "fused_stage"):
            entry["startup_launches"] = {mode: run["launches"][entry["name"]]
                                         for mode, run in startup["children"].items()}
        if entry["name"] == "trainable_trio_mp":
            entry["backward_launches"] = sum(c["trio_backward"] for c in mp_paths.values())
            entry["backward_source"] = "vits_tpu_torch/csrc/trio_grad.cu"
    report["serving"] = {"flow_kernel_on_off_ms": flow_ms, "mms_request": mms_request,
                         "warmup": {path: {k: run[k] for k in ("warmup_s", "first_request_ms")}
                                    for path, run in paths.items() if "warmup_s" in run},
                         "narrow_request": narrow_run["profile"],
                         "kernel7_at_stage_shape": stage_probe, "card": card}
    report["streaming"] = {
        "stream": serving_layer_run["stream"],
        "mux": {k: v for k, v in serving_layer_run["mux"].items() if k != "launches"},
        "server": {k: v for k, v in serving_layer_run["server"].items() if k != "launches"},
        "seconds": serving_layer_run["seconds"], "card": card}
    report["tiers"] = {label: {k: v for k, v in run.items() if k not in ("launches", "walls_ms")}
                       for label, run in tiers_run.items()} | {"cli_default_s": cli_run["seconds"],
                                                                "card": card}
    report["training"] = {"step_ms": trained["step_ms"], "peak_gib": trained["peak_gib"],
                          "profile": trained["profile"], "card": card}
    report["training_bf16"] = bf16_run
    report["serving_bf16"] = {k: v for k, v in serve16_run.items() if k != "launches"} | {
        "launches_by_path": serve16_run["launches"], "card": card}
    report["data_parallel"] = {
        "world_one": {k: v for k, v in data_parallel["world_one"].items() if k != "launches"},
        "two_ranks": [{k: v for k, v in r.items() if k not in ("durations", "rows")}
                      for r in data_parallel["two_ranks"]["ranks"]], "card": card}
    report["multi_device"] = {k: multi[k] for k in ("mesh_mms", "mesh_vctk", "sharded", "http",
                                                     "timings", "distinct_cards", "seconds",
                                                     "card")}
    report["model_parallel"] = {k: model_parallel[k] for k in ("encoder", "pipelined",
                                                              "seconds", "card")} | {
        "two_ranks": {k: v for k, v in model_parallel["two_ranks"].items() if k != "launches"}}
    report["refusals"] = {k: refusals[k] for k in ("variants", "uneven", "seconds", "card")}
    report["startup"] = {k: startup[k] for k in ("bundle", "children", "refusals", "devprofile",
                                                 "seconds", "card")} | {
        "nvcc_seconds_phase2": kernels.build_seconds}
    report["profiler_sessions"] = PROFILER_SESSIONS
    print(f"  profiler sessions {PROFILER_SESSIONS['sessions']}, run again for a lost device "
          f"record {PROFILER_SESSIONS['rerun']}, kept with a lost record "
          f"{PROFILER_SESSIONS['kept_lost']}", flush=True)
    report["seconds"] = time.perf_counter() - t_run
    print(f"  chip_smoke: {report['seconds']:.1f} s from the card query to the report",
          flush=True)
    print(card, flush=True)
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
