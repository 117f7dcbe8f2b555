"""Kernel C: one narrow HiFiGAN stage, and on the last stage the waveform.

Replaces ``vits_tpu/ops/pallas/stage.py::fused_stage``: leaky ->
ConvTranspose1d + bias -> zero outside [0, len*stride) -> mean of the
resblocks; with ``final_conv`` it goes on: leaky(0.01) -> conv_post -> tanh
-> zero outside [0, len*stride), and returns the waveform. The CUDA side is
``vits_tpu_torch/csrc/stage.cu`` (upsampler and terminal conv_post) plus the
resblock conv kernel of ``resblock_trio.cu`` (two launches per pair). The 128-lane time packing of
the TPU kernel is not carried over. The plain PyTorch twin is
:func:`stage_reference`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vits_tpu_torch.ops.conv import conv1d, conv_transpose1d, leaky_relu
from vits_tpu_torch.ops.cuda import (
    check,
    cuda_lengths,
    library,
    no_autograd,
    on_cuda,
    stream_of,
)
from vits_tpu_torch.ops.cuda.resblock import (
    length_mask,
    pair_weights,
    resblock_trio_reference,
    run_pairs,
)

# The vocoder's final activation uses torch's default slope, not leaky_relu_slope.
FINAL_SLOPE = 0.01


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
    final_conv: tuple | None = None,  # (conv_post weight (k, C_out, 1), padding)
) -> torch.Tensor:
    """Plain PyTorch: the stage's module math."""
    h = conv_transpose1d(leaky_relu(x, slope), up_weight, up_bias,
                         stride=stride, padding=up_padding)
    len_out = None if lengths is None else lengths * stride
    mask = length_mask(len_out, h.shape[1], h.dtype)
    if mask is not None:
        h = h * mask
    h = resblock_trio_reference(h, resblocks, slope=slope, lengths=len_out)
    if final_conv is None:
        return h
    w_post, pad = final_conv
    wave = torch.tanh(conv1d(leaky_relu(h, FINAL_SLOPE), w_post, None, padding=pad))
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
) -> torch.Tensor:
    """(B, T_in*stride, C_out) stage output, or the (B, T_in*stride) waveform
    with ``final_conv``.

    CPU tensors take :func:`stage_reference`; CUDA tensors launch the kernels
    (fp32, contiguous, k_up - 2*up_padding == stride, no autograd) or raise.
    """
    tensors = [x, up_weight, up_bias, *pair_weights(resblocks)]
    if final_conv is not None:
        tensors.append(final_conv[0])
    if not on_cuda("fused_stage", *tensors):
        return stage_reference(
            x, up_weight, up_bias, resblocks, stride=stride, up_padding=up_padding,
            slope=slope, lengths=lengths, final_conv=final_conv)
    no_autograd("fused_stage", *tensors)
    B, T_in, C_in = x.shape
    k_up, w_in, C_out = up_weight.shape
    if w_in != C_in or up_bias.shape != (C_out,):
        raise ValueError(f"upsampler {tuple(up_weight.shape)} does not fit input C={C_in}")
    if k_up - 2 * up_padding != stride:
        raise ValueError("stage kernel needs k_up - 2*up_padding == stride "
                         f"(got k={k_up}, padding={up_padding}, stride={stride})")
    if C_out < 32 or C_out > 512 or C_out & (C_out - 1) or up_weight.data_ptr() % 16:
        raise ValueError(f"stage kernel needs C_out a power of two in [32, 512], got {C_out}")
    lib = library()
    stream = stream_of(x)
    lens = cuda_lengths(lengths, B, T_in, x.device)
    T_out = T_in * stride
    up = torch.empty((B, T_out, C_out), dtype=x.dtype, device=x.device)
    check(lib.vk_upsample(
        x.data_ptr(), up.data_ptr(), up_weight.data_ptr(), up_bias.data_ptr(),
        lens.data_ptr(), B, T_in, C_in, C_out, k_up, stride, up_padding, slope, stream),
        "stage upsample kernel")
    h = torch.empty_like(up)
    run_pairs(up, h, resblocks, lens * stride, slope)
    if final_conv is None:
        fused_stage.launches += 1
        return h
    w_post, pad = final_conv
    k_post = w_post.shape[0]
    if w_post.shape != (k_post, C_out, 1):
        raise ValueError(f"conv_post weight {tuple(w_post.shape)} != (k, {C_out}, 1)")
    wave = torch.empty((B, T_out), dtype=x.dtype, device=x.device)
    check(lib.vk_wave(
        h.data_ptr(), wave.data_ptr(), w_post.data_ptr(), lens.data_ptr(), B, T_out,
        C_out, k_post, pad, stride, FINAL_SLOPE, stream), "stage conv_post kernel")
    fused_stage.launches += 1
    return wave


fused_stage.launches = 0
