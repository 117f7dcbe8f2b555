"""Kernel B: the HiFiGAN resblock trio of a wide vocoder stage.

Replaces ``vits_tpu/ops/pallas/resblock.py::fused_resblock_trio``: the mean
over the stage's resblocks, each a chain of masked (dilated conv, conv)
pairs. The CUDA kernel is the conv of ``vits_tpu_torch/csrc/resblock_trio.cu``,
launched twice per pair (18 launches for MMS); the last pair of each resblock
folds its output into the mean in place. The plain PyTorch twin is
:func:`resblock_trio_reference`.

A block is ``{kernel_size, dilations, w1, b1, w2, b2}`` with ``w1[i]``,
``w2[i]`` the pair's (k, C, C) kernels and ``b1[i]``, ``b2[i]`` its (C,)
biases -- a stacked (pairs, ...) tensor or a per-pair list.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vits_tpu_torch.ops.conv import conv1d, leaky_relu
from vits_tpu_torch.ops.cuda import (
    check,
    cuda_lengths,
    library,
    no_autograd,
    on_cuda,
    stream_of,
)


def length_mask(lengths: torch.Tensor | None, T: int, dtype) -> torch.Tensor | None:
    """(B,) lengths -> (B, T, 1) 0/1 mask, or None."""
    if lengths is None:
        return None
    steps = torch.arange(T, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(dtype)[..., None]


def resblock_trio_reference(
    x: torch.Tensor,  # (B, T, C); zero at and past each row's length
    blocks: Sequence[dict],
    *,
    slope: float,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch: mean_j resblock_j(x), re-zeroing [len, T) after every conv."""
    mask = length_mask(lengths, x.shape[1], x.dtype)
    total = None
    for blk in blocks:
        k = blk["kernel_size"]
        h = x
        for i, d in enumerate(blk["dilations"]):
            y = conv1d(leaky_relu(h, slope), blk["w1"][i], blk["b1"][i],
                       padding=(k * d - d) // 2, dilation=d)
            if mask is not None:
                y = y * mask
            y = conv1d(leaky_relu(y, slope), blk["w2"][i], blk["b2"][i],
                       padding=(k - 1) // 2)
            h = h + y
            if mask is not None:
                h = h * mask
        total = h if total is None else total + h
    return total * (1.0 / len(blocks))


def pair_weights(blocks: Sequence[dict]) -> list[torch.Tensor]:
    return [blk[name][i] for blk in blocks for i in range(len(blk["dilations"]))
            for name in ("w1", "b1", "w2", "b2")]


def run_pairs(x: torch.Tensor, out: torch.Tensor, blocks: Sequence[dict],
              lengths: torch.Tensor, slope: float, acts: Sequence | None = None) -> None:
    """Launch two conv kernels per pair of every block; ``out`` gets the mean.

    ``x`` is left untouched; y1 and the pair outputs go through three
    scratch buffers. Shared by kernel B and the stage kernel (kernel C).
    With ``acts`` -- per block ``(y1s, xs)``, ``pairs`` and ``pairs - 1``
    (B, T, C) buffers -- each pair's y1 and each later pair's input land there
    instead, saved for the backward (kernel 5, ``ops/cuda/trio_grad.py``).
    """
    lib = library()
    B, T, C = x.shape
    if C % 32:
        raise ValueError(f"resblock conv kernel needs C % 32 == 0, got C={C}")
    stream = stream_of(x)
    if acts is None:
        y1 = torch.empty_like(x)
        scratch = (torch.empty_like(x), torch.empty_like(x))
    n = len(blocks)
    for j, blk in enumerate(blocks):
        k = blk["kernel_size"]
        if k % 2 == 0:
            raise ValueError(f"resblock conv kernel needs an odd kernel size, got {k}")
        src = x
        dilations = tuple(blk["dilations"])
        for i, d in enumerate(dilations):
            w1, b1, w2, b2 = blk["w1"][i], blk["b1"][i], blk["w2"][i], blk["b2"][i]
            for w in (w1, w2):
                if w.shape != (k, C, C) or w.data_ptr() % 16:
                    raise ValueError(f"resblock conv weight {tuple(w.shape)} != ({k}, {C}, {C})"
                                     " or not 16-byte aligned")
            for bias in (b1, b2):
                if bias.shape != (C,) or bias.data_ptr() % 16:
                    raise ValueError(f"resblock conv bias {tuple(bias.shape)} != ({C},)"
                                     " or not 16-byte aligned")
            last = i == len(dilations) - 1
            if acts is not None:
                y1 = acts[j][0][i]
                dst = out if last else acts[j][1][i]
            else:
                dst = out if last else scratch[i % 2]
            accumulate = int(last and j > 0)
            scale = 1.0 / n if last and j == n - 1 else 1.0
            # y1 = mask(dilated conv(leaky(src)) + b1)
            check(lib.vk_conv(
                src.data_ptr(), y1.data_ptr(), w1.data_ptr(), b1.data_ptr(), None,
                lengths.data_ptr(), B, T, C, C, k, d, d * (k - 1) // 2, slope, 0, 1.0,
                stream), "resblock conv1 kernel")
            # dst = mask(src + conv(leaky(y1)) + b2), folded into the mean on the last pair
            check(lib.vk_conv(
                y1.data_ptr(), dst.data_ptr(), w2.data_ptr(), b2.data_ptr(), src.data_ptr(),
                lengths.data_ptr(), B, T, C, C, k, 1, (k - 1) // 2, slope, accumulate, scale,
                stream), "resblock conv2 kernel")
            src = dst


def fused_resblock_trio(
    x: torch.Tensor,  # (B, T, C)
    blocks: Sequence[dict],
    *,
    slope: float,
    lengths: torch.Tensor | None = None,  # (B,) valid steps; None = all T
) -> torch.Tensor:
    """mean_j resblock_j(x) with per-row length masking.

    CPU tensors take :func:`resblock_trio_reference`; CUDA tensors launch the
    kernel (fp32, contiguous, no autograd) or raise.
    """
    if not on_cuda("fused_resblock_trio", x, *pair_weights(blocks)):
        return resblock_trio_reference(x, blocks, slope=slope, lengths=lengths)
    no_autograd("fused_resblock_trio", x, *pair_weights(blocks))
    B, T, _ = x.shape
    out = torch.empty_like(x)
    run_pairs(x, out, blocks, cuda_lengths(lengths, B, T, x.device), slope)
    fused_resblock_trio.launches += 1
    return out


fused_resblock_trio.launches = 0
