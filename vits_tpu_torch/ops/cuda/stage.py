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

from typing import NamedTuple, Sequence

import torch

from vits_tpu_torch.ops.conv import conv1d, conv_transpose1d, leaky_relu
from vits_tpu_torch.ops.tiers import (
    EXACT_TIER,
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
    library,
    no_autograd,
    on_cuda,
    on_device,
    stream_of,
)
from vits_tpu_torch.ops.cuda.resblock import (
    _trio_mean,
    length_mask,
    pair_scales,
    pair_weights,
    resblocks_mean_bf16,
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
    xf = x.float()  # the kernels stage fp32 (bf16 values stay bf16-exact)
    up = torch.empty((B, T_out, C_out), dtype=torch.float32, device=x.device)
    with on_device(x):
        check(lib.vk_upsample(
            xf.data_ptr(), up.data_ptr(), up_weight.data_ptr(), up_bias.data_ptr(),
            lens.data_ptr(), B, T_in, C_in, C_out, k_up, stride, up_padding,
            carry_slope(slope, tier), tier.mode, up_fmt,
            None if up_scale is None else up_scale.data_ptr(), int(tier.bf16_values), 0, 0, stream),
            "stage upsample kernel")
    h = torch.empty_like(up)
    h16 = (torch.empty((B, T_out, C_out), dtype=torch.bfloat16, device=x.device)
           if chain and final_conv is None and tier.bf16_values else None)
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
