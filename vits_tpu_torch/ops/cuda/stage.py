"""Kernel C: one narrow HiFiGAN stage, and on the last stage the waveform.

Replaces ``vits_tpu/ops/pallas/stage.py::fused_stage``: leaky ->
ConvTranspose1d + bias -> zero outside [0, len*stride) -> mean of the
resblocks; with ``final_conv`` it goes on: leaky(0.01) -> conv_post -> tanh
-> zero outside [0, len*stride), and returns the waveform. The CUDA side is
``vits_tpu_torch/csrc/stage.cu`` (upsampler and terminal conv_post) plus the
resblock conv kernels of ``resblock_trio.cu`` (two launches per pair). The
128-lane time packing of the TPU kernel is not carried over, but its domain
is: every C_in, C_out that divide 128 with 128 / C_out = stride * 128 / C_in
(HiFi-GAN V2's tail runs at C_out 16 and 8). The plain PyTorch twin is
:func:`stage_reference`.

Hopper's routes at the fast tier (:func:`stage_routes`, the one rule; no
switch, no fallback). With bf16 values (not bf16 serving) and a bf16
upsampler, the upsampler is ``csrc/upsample_wgmma.cu`` (:func:`upsample`,
TMA and wgmma on the bf16 input as it is, no fp32 cast) wherever C_in is a
multiple of 16 up to 256, C_out is 16, 32 or 64 and the window fits one TMA
box (:func:`upsample_plan`): MMS's and VCTK's 128->64 and 64->32,
small_config's 64->32 and 32->16, HiFi-GAN V2's 32->16; its output is bf16
where the pairs read it and fp32 where the next launch stages fp32. Where it
is on that route and the resblocks are bf16 packs at C = 32 (the 64->32
stages), each pair is one launch of ``csrc/pair_wgmma.cu`` with y1 kept on
chip (``resblock.py::run_fused_pairs``, ``pair_plan``). Off those domains the
routes above stay: stage.cu's upsampler at ``high``, ``exact``, on int8
packs, fp32 values and C_out 8 (V2's 16->8), and the resblocks of
``run_pairs`` (at 64 channels on ``conv_wgmma.cuh`` at this tier). conv_post
stays ``wave_kernel``. The twins of the launches are
:func:`upsample_reference` and ``resblock.py::pair_reference``.

The upsampler kernel is polyphase. With pe = k - 1 - padding, output row
v = stride * t + phi takes only the taps j = j_phi + stride * i of the
loader's reversed kernel, i < n_phi, applied to input row t + i - o_phi:

    j_phi = (pe - phi) mod stride,   n_phi = ceil((k - j_phi) / stride),
    o_phi = (pe - phi - j_phi) / stride,

so each phase is a plain Conv1d over the input steps (:func:`upsample_phases`
gives the table, :func:`polyphase_upsample` the plain PyTorch form), and the
mask v < len * stride is t < len.

Precision tiers (``ops/tiers.py``) as the JAX kernel's ``precision``,
``value_dtype`` and ``pack_stage_arrays`` weight formats: the upsampler's,
the resblocks' and conv_post's weights may be bf16 or int8 (``up_scale``,
the blocks' ``s1``/``s2``, ``final_conv``'s third entry: per-out-channel
scales, one for conv_post); with bf16 values the input is bf16, the
upsampler's output and each pair's output are rounded to bf16, and with
``chain`` (the next stage is a stage kernel too) the output is bf16.

bf16 serving (``Tier.bf16_compute``): the JAX package runs no stage kernel at
``compute_dtype="bfloat16"``; kernel C computes XLA's masked bf16 graph of the
plain stage (:func:`stage_bf16`, its twin): leaky at the bf16 slope, the
per-phase transposed conv on bf16 weights (each tap's product rounded, the
taps added in JAX's order) where k % stride == 0, + bias, the mask, the
resblocks' bf16 mean (``resblock.py::resblocks_mean_bf16``), and on the last
stage leaky(0.01), conv_post, tanh and the mask, all bf16 in and out.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from vits_tpu_torch.ops.conv import conv1d, conv_transpose1d, leaky_relu
from vits_tpu_torch.ops.tiers import (
    EXACT_TIER,
    FAST,
    Tier,
    carry,
    carry_slope,
    tier_conv1d,
    tier_conv_transpose1d,
    weight_format,
)
from vits_tpu_torch.ops.cuda import (
    check,
    count_launch,
    cuda_lengths,
    device_sm_count,
    library,
    no_autograd,
    on_cuda,
    on_device,
    stream_of,
)
from vits_tpu_torch.ops.cuda.resblock import (
    MAX_SMEM_BYTES,
    SM_SMEM_BYTES,
    PairPlan,
    _round1024,
    _trio_mean,
    check_weights,
    length_mask,
    pair_plan,
    pair_scales,
    pair_weights,
    resblocks_mean_bf16,
    run_fused_pairs,
    run_pairs,
)

# The vocoder's final activation uses torch's default slope, not leaky_relu_slope.
FINAL_SLOPE = 0.01


class UpsamplePhase(NamedTuple):
    first_tap: int  # j_phi: the phase's first tap of the (reversed) kernel
    taps: int  # n_phi: taps first_tap, first_tap + stride, ...
    offset: int  # o_phi: tap i reads input row t + i - offset


def upsample_phases(k: int, stride: int, padding: int) -> tuple[UpsamplePhase, ...]:
    """The polyphase table of a ConvTranspose1d (k, stride, padding), phase by phase.

    ``csrc/stage.cu::phase_of`` computes the same per block.
    """
    pe = k - 1 - padding
    phases = []
    for phi in range(stride):
        j = (pe - phi) % stride
        phases.append(UpsamplePhase(j, -(-(k - j) // stride), (pe - phi - j) // stride))
    return tuple(phases)


def polyphase_upsample(
    x: torch.Tensor,  # (B, T_in, C_in), pre-leaky
    weight: torch.Tensor,  # (k, C_in, C_out), spatially reversed (loader layout)
    bias: torch.Tensor,
    *,
    stride: int,
    padding: int,
    slope: float,
    lengths: torch.Tensor | None = None,  # (B,) valid INPUT steps
) -> torch.Tensor:
    """Plain PyTorch: the upsampler as the kernel computes it, one Conv1d per phase.

    Equals ``conv_transpose1d(leaky(x))`` + bias, zeroed at output rows
    >= lengths * stride, when k - 2 * padding == stride.
    """
    B, T_in, _ = x.shape
    h = leaky_relu(x, slope)
    phases = []
    for j, taps, offset in upsample_phases(weight.shape[0], stride, padding):
        acc = bias.expand(B, T_in, -1).clone()
        for i in range(taps):
            shift = i - offset  # output row t reads input row t + shift
            lo, hi = max(0, -shift), min(T_in, T_in - shift)
            if lo < hi:
                acc[:, lo:hi] += h[:, lo + shift:hi + shift] @ weight[j + stride * i]
        phases.append(acc)
    y = torch.stack(phases, dim=2).reshape(B, T_in * stride, -1)  # row stride * t + phi
    mask = length_mask(None if lengths is None else lengths * stride, y.shape[1], y.dtype)
    return y if mask is None else y * mask


# Kernel C's upsampler on Hopper (csrc/upsample_wgmma.cu): at the fast tier on bf16
# packs with bf16 values, C_in a multiple of 16 (at most 256) and C_out one of
# UPSAMPLE_WGMMA_COLS (a weight row of 32, 64 or 128 bytes: a TMA swizzle's span);
# blocks of nw warpgroups (UPSAMPLE_WGMMA_NWS) of 64 input rows, every phase and
# column, an SM running up to UPSAMPLE_BLOCKS_PER_SM of them (the kernel's
# __launch_bounds__) where shared memory allows.
UPSAMPLE_WGMMA_COLS = (16, 32, 64)
UPSAMPLE_WGMMA_NWS = (1, 2)
UPSAMPLE_BLOCKS_PER_SM = {1: 4, 2: 2}
UPSAMPLE_MAX_WINDOW = 256  # the x window is one TMA box (a chunk of channels)


class UpsamplePlan(NamedTuple):
    nw: int  # warpgroups of a block: 64 * nw input rows
    window: int  # rows of its x window
    smem: int  # dynamic shared memory of a block, bytes
    blocks: int  # grid size
    per_sm: int  # blocks an SM runs at once


def upsample_reach(k: int, stride: int, padding: int) -> tuple[int, int]:
    """(lo, hi): output step t of any phase reads input rows t + lo .. t + hi."""
    phases = upsample_phases(k, stride, padding)
    return (min(0, *(-p.offset for p in phases)),
            max(0, *(p.taps - 1 - p.offset for p in phases)))


def upsample_smem(C_in: int, C_out: int, k: int, window: int) -> int:
    """Shared memory of one block of csrc/upsample_wgmma.cu (stage_wgmma.cuh's
    ``UpSmem``): 1 KB for the mbarrier, the k taps' (C_in x C_out) bf16 weight
    slabs and the window's C_in / KC chunks of KC = min(C_in, 64) channels, each
    1 KB aligned, plus 1 KB to align the base to the swizzle's atoms."""
    kc = min(C_in, 64)
    return (1024 + k * _round1024(C_in * C_out * 2) + (C_in // kc) * _round1024(window * kc * 2)
            + 1024)


def upsample_tensor_maps(B: int, T_in: int, C_in: int, C_out: int, k: int, stride: int,
                         padding: int, nw: int) -> dict:
    """The two TMA tensor maps of one upsampler launch, as csrc/upsample_wgmma.cu::launch
    encodes them (``dims`` and ``box`` innermost first, ``strides`` in bytes, the
    innermost left out; ``swizzle`` the span in bytes). x, bf16: (C_in, T_in, B), a
    box one chunk of the window (KC channels x 64 * nw + the phases' reach x one
    row); w, bf16: (C_out, k * C_in), a box one tap's (C_in x C_out) slab; each
    with the swizzle of its box row."""
    lo, hi = upsample_reach(k, stride, padding)
    kc = min(C_in, 64)
    return {
        "x": {"dims": (C_in, T_in, B), "strides": (C_in * 2, T_in * C_in * 2),
              "box": (kc, 64 * nw + hi - lo, 1), "elem_bytes": 2, "swizzle": 2 * kc},
        "w": {"dims": (C_out, k * C_in), "strides": (C_out * 2,), "box": (C_out, C_in),
              "elem_bytes": 2, "swizzle": 2 * C_out},
    }


@functools.lru_cache(maxsize=1024)
def upsample_plan(B: int, T_in: int, C_in: int, C_out: int, k: int, stride: int, padding: int,
                  sm_count: int) -> UpsamplePlan | None:
    """The block shape of one upsampler launch on Hopper's route, or None off its
    grid (C_in not a multiple of 16 or past 256, C_out not in
    UPSAMPLE_WGMMA_COLS, or no block shape whose window fits one TMA box and
    whose shared memory fits a block), which keeps stage.cu's upsampler.

    Among the shapes of UPSAMPLE_WGMMA_NWS, the fewest waves of ``per_sm``
    blocks an SM, each as long as a block's rows (64 * nw); on a tie the wider
    block, which loads the weights for more rows."""
    if C_in % 16 or not 16 <= C_in <= 256 or C_out not in UPSAMPLE_WGMMA_COLS:
        return None
    lo, hi = upsample_reach(k, stride, padding)
    best = None
    for nw in UPSAMPLE_WGMMA_NWS:
        window = 64 * nw + hi - lo
        smem = upsample_smem(C_in, C_out, k, window)
        if window > UPSAMPLE_MAX_WINDOW or smem > MAX_SMEM_BYTES:
            continue
        per_sm = min(UPSAMPLE_BLOCKS_PER_SM[nw], SM_SMEM_BYTES // (smem + 1024))
        blocks = -(-T_in // (64 * nw)) * B
        cost = -(-blocks // (sm_count * per_sm)) * nw
        if best is None or cost <= best[0]:
            best = (cost, UpsamplePlan(nw, window, smem, blocks, per_sm))
    return None if best is None else best[1]


class StageRoutes(NamedTuple):
    """Kernel C's Hopper routes for one stage call: the upsampler's plan (None:
    stage.cu's upsampler) and each resblock's pair plans (None: run_pairs)."""

    upsample: UpsamplePlan | None
    pairs: tuple[tuple[PairPlan, ...], ...] | None


def stage_routes(B: int, T_in: int, C_in: int, C_out: int, k_up: int, stride: int,
                 up_padding: int, up_fmt: int, resblocks: Sequence[dict], tier: Tier,
                 sm_count: int) -> StageRoutes:
    """The one rule that routes kernel C's own launches. At the fast tier with bf16
    values (not bf16 serving) and a bf16 upsampler: the upsampler takes Hopper's
    route where :func:`upsample_plan` has a plan; and where it does and the
    resblocks are bf16 too, they take the pair route where :func:`pair_plan` has a
    plan for every pair (C = 32). Everything else keeps the routes of
    stage.cu and :func:`run_pairs` (whose convs at C % 64 == 0 take
    resblock.py::conv's Hopper route at this tier). No switch, no fallback."""
    if tier.mode != FAST or tier.bf16_compute or not tier.bf16_values or up_fmt != 1:
        return StageRoutes(None, None)
    up = upsample_plan(B, T_in, C_in, C_out, k_up, stride, up_padding, sm_count)
    if up is None or check_weights("stage kernel", resblocks, tier) != 1:
        return StageRoutes(up, None)
    T = T_in * stride
    pairs = tuple(tuple(pair_plan(B, T, C_out, blk["kernel_size"], d, sm_count)
                        for d in blk["dilations"]) for blk in resblocks)
    if any(plan is None for plans in pairs for plan in plans):
        return StageRoutes(up, None)
    return StageRoutes(up, pairs)


def upsample_reference(
    x: torch.Tensor,  # (B, T_in, C_in), pre-leaky
    up_weight: torch.Tensor,
    up_bias: torch.Tensor,
    *,
    stride: int,
    up_padding: int,
    slope: float,
    lengths: torch.Tensor | None = None,
    tier: Tier = EXACT_TIER,
    up_scale: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch: the upsampler's launch as the kernels write it (fp32): the
    steps of :func:`stage_reference` up to the mask, then the tier's value carry."""
    h = tier_conv_transpose1d(leaky_relu(carry(x.float(), tier), carry_slope(slope, tier)),
                              up_weight, up_bias, tier, up_scale, stride=stride,
                              padding=up_padding)
    mask = length_mask(None if lengths is None else lengths * stride, h.shape[1], torch.float32)
    return carry(h if mask is None else h * mask, tier)


def upsample(x: torch.Tensor, up: torch.Tensor, up_weight: torch.Tensor, up_bias: torch.Tensor,
             lens: torch.Tensor, *, stride: int, up_padding: int, slope: float, tier: Tier,
             up_fmt: int, up_scale: torch.Tensor | None, plan: UpsamplePlan | None) -> None:
    """One upsampler launch of x (B, T_in, C_in) into up: with a plan, Hopper's
    route (``vk_upsample_wgmma``) on the bf16 x as it is, up fp32 or bf16; else
    stage.cu's (``vk_upsample``), which stages fp32 (x cast first), up fp32."""
    B, T_in, C_in = x.shape
    k_up, _, C_out = up_weight.shape
    stream = stream_of(x)
    lib = library()
    if plan is not None:
        if x.dtype != torch.bfloat16 or x.data_ptr() % 16 or up.data_ptr() % 16:
            raise ValueError("stage upsample kernel takes 16-byte aligned bf16 x")
        with on_device(x):
            check(lib.vk_upsample_wgmma(
                x.data_ptr(), up.data_ptr(), int(up.dtype == torch.bfloat16),
                up_weight.data_ptr(), up_bias.data_ptr(), lens.data_ptr(), B, T_in, C_in, C_out,
                k_up, stride, up_padding, carry_slope(slope, tier), int(tier.bf16_values),
                plan.nw, stream), "stage upsample kernel (wgmma)")
        count_launch(upsample, "wgmma_launches")
        return
    xf = x.float()  # the kernel stages fp32 (bf16 values stay bf16-exact)
    with on_device(x):
        check(lib.vk_upsample(
            xf.data_ptr(), up.data_ptr(), up_weight.data_ptr(), up_bias.data_ptr(),
            lens.data_ptr(), B, T_in, C_in, C_out, k_up, stride, up_padding,
            carry_slope(slope, tier), tier.mode, up_fmt,
            None if up_scale is None else up_scale.data_ptr(), int(tier.bf16_values), 0, 0,
            stream), "stage upsample kernel")
    count_launch(upsample, "mma_sync_launches")


# Launches of each upsampler route: Hopper's, and stage.cu's tf32 mma.sync tile
upsample.wgmma_launches = 0
upsample.mma_sync_launches = 0


def _post(final_conv: tuple) -> tuple:
    """``final_conv`` as (weight, padding, scale or None)."""
    return (*final_conv, None) if len(final_conv) == 2 else tuple(final_conv)


def per_tap(k: int, stride: int, padding: int) -> bool:
    """Whether the JAX decoder runs this upsampler in its per-phase form (one
    rounded matmul a tap; else one conv): ``method="phases"``'s geometry."""
    return k % stride == 0 and 2 * padding == k - stride


def stage_bf16(
    x: torch.Tensor,  # (B, T_in, C_in) bf16, pre-leaky
    up_weight: torch.Tensor,
    up_bias: torch.Tensor,
    resblocks: Sequence[dict],
    *,
    stride: int,
    up_padding: int,
    slope: float,
    lengths: torch.Tensor | None = None,
    final_conv: tuple | None = None,
) -> torch.Tensor:
    """Plain PyTorch: XLA's masked bf16 graph of the stage (bf16 serving), in
    bf16 ops; the stage's bf16 output or the bf16 waveform."""
    b16 = lambda t: t.to(torch.bfloat16)  # noqa: E731
    k = up_weight.shape[0]
    h = conv_transpose1d(leaky_relu(x, slope), b16(up_weight), b16(up_bias), stride=stride,
                         padding=up_padding,
                         method="phases" if per_tap(k, stride, up_padding) else None)
    mask = length_mask(None if lengths is None else lengths * stride, h.shape[1],
                       torch.bfloat16)
    if mask is not None:
        h = h * mask
    h = resblocks_mean_bf16(h, resblocks, slope, mask)
    if final_conv is None:
        return h
    w_post, pad, _ = _post(final_conv)
    wave = torch.tanh(conv1d(leaky_relu(h, FINAL_SLOPE), b16(w_post), None, padding=pad))
    if mask is not None:
        wave = wave * mask
    return wave[..., 0]


def stage_reference(
    x: torch.Tensor,  # (B, T_in, C_in), pre-leaky
    up_weight: torch.Tensor,  # (k_up, C_in, C_out), spatially reversed (loader layout)
    up_bias: torch.Tensor,
    resblocks: Sequence[dict],
    *,
    stride: int,
    up_padding: int,
    slope: float,
    lengths: torch.Tensor | None = None,  # (B,) valid INPUT steps
    final_conv: tuple | None = None,  # (conv_post weight (k, C_out, 1), padding[, scale])
    tier: Tier = EXACT_TIER,
    up_scale: torch.Tensor | None = None,
    chain: bool = False,
) -> torch.Tensor:
    """Plain PyTorch: the stage's module math at ``tier`` (the JAX kernel's
    rounding points: the value carry, the operands of every product); bf16
    serving: :func:`stage_bf16`."""
    if tier.bf16_compute:
        if x.dtype != torch.bfloat16:
            raise ValueError(f"stage: bf16 serving takes bf16 activations, not {x.dtype}")
        return stage_bf16(x, up_weight, up_bias, resblocks, stride=stride,
                          up_padding=up_padding, slope=slope, lengths=lengths,
                          final_conv=final_conv)
    h = tier_conv_transpose1d(leaky_relu(carry(x.float(), tier), carry_slope(slope, tier)),
                              up_weight, up_bias,
                              tier, up_scale, stride=stride, padding=up_padding)
    len_out = None if lengths is None else lengths * stride
    mask = length_mask(len_out, h.shape[1], torch.float32)
    if mask is not None:
        h = h * mask
    h = _trio_mean(h, resblocks, slope, mask, tier)
    if final_conv is None:
        return h.to(tier.value_dtype) if chain else h
    w_post, pad, post_scale = _post(final_conv)
    wave = torch.tanh(tier_conv1d(leaky_relu(h, FINAL_SLOPE), w_post, None, tier, post_scale,
                                  padding=pad))
    if mask is not None:
        wave = wave * mask
    return wave[..., 0]


def fused_stage(
    x: torch.Tensor,
    up_weight: torch.Tensor,
    up_bias: torch.Tensor,
    resblocks: Sequence[dict],
    *,
    stride: int,
    up_padding: int,
    slope: float,
    lengths: torch.Tensor | None = None,
    final_conv: tuple | None = None,
    tier: Tier = EXACT_TIER,
    up_scale: torch.Tensor | None = None,
    chain: bool = False,
) -> torch.Tensor:
    """(B, T_in*stride, C_out) stage output (fp32; with ``chain`` in the
    tier's value dtype), or the (B, T_in*stride) fp32 waveform with
    ``final_conv``, at ``tier``.

    CPU tensors take :func:`stage_reference`; CUDA tensors launch the kernels
    (x in the tier's value dtype, weights fp32, bf16 or int8 with scales,
    contiguous, no autograd, the JAX kernel's channel domain and
    k_up - 2*up_padding == stride, so that the stage makes T_in*stride steps;
    bf16 serving: bf16 x, weights and biases, no scales) or raise.
    """
    post = None if final_conv is None else _post(final_conv)
    tensors = [x, up_weight, up_bias, *pair_weights(resblocks), *pair_scales(resblocks)]
    tensors += [t for t in (up_scale,) + (post[0::2] if post else ()) if t is not None]
    if not on_cuda("fused_stage", *tensors, dtype=None):
        return stage_reference(
            x, up_weight, up_bias, resblocks, stride=stride, up_padding=up_padding,
            slope=slope, lengths=lengths, final_conv=final_conv, tier=tier, up_scale=up_scale,
            chain=chain)
    on_cuda("fused_stage", x, dtype=tier.value_dtype)
    if not tier.bf16_compute:  # fp32 biases and scales (bf16 serving: checked below)
        on_cuda("fused_stage", up_bias,
                *(t for t in (up_scale, post and post[2]) if t is not None))
    no_autograd("fused_stage", *tensors)
    B, T_in, C_in = x.shape
    k_up, w_in, C_out = up_weight.shape
    if w_in != C_in or up_bias.shape != (C_out,):
        raise ValueError(f"upsampler {tuple(up_weight.shape)} does not fit input C={C_in}")
    if k_up - 2 * up_padding != stride:
        raise ValueError("stage kernel needs k_up - 2*up_padding == stride "
                         f"(got k={k_up}, padding={up_padding}, stride={stride})")
    if 128 % C_in or 128 % C_out or 128 // C_out != stride * (128 // C_in):
        raise ValueError("stage kernel needs C_in and C_out dividing 128 with "
                         f"128/C_out == stride*128/C_in (got {C_in}->{C_out}, stride {stride})")
    if up_weight.data_ptr() % 16:
        raise ValueError("stage kernel needs a 16-byte aligned upsampler weight")
    up_fmt = weight_format(up_weight)
    if (up_fmt == 2) != (up_scale is not None):
        raise ValueError("stage kernel: an int8 upsampler needs its scales, and only it")
    lib = library()
    stream = stream_of(x)
    lens = cuda_lengths(lengths, B, T_in, x.device)
    T_out = T_in * stride
    if tier.bf16_compute:
        return _stage_bf16_kernels(x, up_weight, up_bias, resblocks, lens, post, stride=stride,
                                   up_padding=up_padding, slope=slope, tier=tier)
    routes = stage_routes(B, T_in, C_in, C_out, k_up, stride, up_padding, up_fmt, resblocks,
                          tier, device_sm_count(x.device))
    up = torch.empty((B, T_out, C_out), device=x.device,
                     dtype=torch.bfloat16 if routes.pairs else torch.float32)
    upsample(x, up, up_weight, up_bias, lens, stride=stride, up_padding=up_padding, slope=slope,
             tier=tier, up_fmt=up_fmt, up_scale=up_scale, plan=routes.upsample)
    h = torch.empty((B, T_out, C_out), dtype=torch.float32, device=x.device)
    h16 = (torch.empty((B, T_out, C_out), dtype=torch.bfloat16, device=x.device)
           if chain and final_conv is None and tier.bf16_values else None)
    if routes.pairs:
        run_fused_pairs(up, h, resblocks, lens * stride, slope, routes.pairs, tier, out16=h16)
    else:
        run_pairs(up, h, resblocks, lens * stride, slope, tier=tier, out16=h16)
    if final_conv is None:
        count_launch(fused_stage)
        return h if h16 is None else h16
    w_post, pad, post_scale = post
    k_post = w_post.shape[0]
    if w_post.shape != (k_post, C_out, 1):
        raise ValueError(f"conv_post weight {tuple(w_post.shape)} != (k, {C_out}, 1)")
    post_fmt = weight_format(w_post)
    if (post_fmt == 2) != (post_scale is not None):
        raise ValueError("stage kernel: an int8 conv_post needs its scale, and only it")
    wave = torch.empty((B, T_out), dtype=torch.float32, device=x.device)
    with on_device(x):
        check(lib.vk_wave(
            h.data_ptr(), wave.data_ptr(), w_post.data_ptr(), lens.data_ptr(), B, T_out,
            C_out, k_post, pad, stride, FINAL_SLOPE, tier.mode, post_fmt,
            None if post_scale is None else post_scale.data_ptr(), 0, stream),
            "stage conv_post kernel")
    count_launch(fused_stage)
    return wave


def _stage_bf16_kernels(x, up_weight, up_bias, resblocks, lens, post, *, stride, up_padding,
                        slope, tier):
    """Kernel C at bf16 serving: the bf16 upsampler, the resblocks' bf16 convs
    (``vk_conv_bf16``) and the bf16 conv_post, every buffer bf16."""
    B, T_in, C_in = x.shape
    k_up, _, C_out = up_weight.shape
    T_out = T_in * stride
    tensors = [up_weight, up_bias, *pair_weights(resblocks)] + ([post[0]] if post else [])
    if any(t.dtype != torch.bfloat16 for t in tensors) or (post and post[2] is not None):
        raise ValueError("stage kernel: bf16 serving takes bf16 weights and biases")
    lib = library()
    stream = stream_of(x)
    up = torch.empty((B, T_out, C_out), dtype=torch.bfloat16, device=x.device)
    with on_device(x):
        check(lib.vk_upsample(
            x.data_ptr(), up.data_ptr(), up_weight.data_ptr(), up_bias.data_ptr(), lens.data_ptr(),
            B, T_in, C_in, C_out, k_up, stride, up_padding, carry_slope(slope, tier), tier.mode, 1,
            None, 0, 1, int(per_tap(k_up, stride, up_padding)), stream),
            "stage upsample kernel (bf16)")
    h = torch.empty_like(up)
    run_pairs(up, h, resblocks, lens * stride, slope, tier=tier)
    if post is None:
        count_launch(fused_stage)
        return h
    w_post, pad, _ = post
    k_post = w_post.shape[0]
    if w_post.shape != (k_post, C_out, 1):
        raise ValueError(f"conv_post weight {tuple(w_post.shape)} != (k, {C_out}, 1)")
    wave = torch.empty((B, T_out), dtype=torch.bfloat16, device=x.device)
    with on_device(x):
        check(lib.vk_wave(
            h.data_ptr(), wave.data_ptr(), w_post.data_ptr(), lens.data_ptr(), B, T_out, C_out,
            k_post, pad, stride, carry_slope(FINAL_SLOPE, tier), tier.mode, 1, None, 1, stream),
            "stage conv_post kernel (bf16)")
    count_launch(fused_stage)
    return wave


fused_stage.launches = 0
