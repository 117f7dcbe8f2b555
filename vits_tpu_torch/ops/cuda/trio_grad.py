"""Kernel 5: the resblock trio of a wide vocoder stage, trainable.

Replaces ``vits_tpu/ops/pallas/trio_grad.py::make_trainable_trio``.
:func:`trainable_trio` is a ``torch.autograd.Function``. Its forward,
:func:`trio_forward_with_acts`, is kernel B's conv (``vits_tpu_torch/csrc/
resblock_trio.cu``, lengths = T: training segments are unmasked) writing each
pair's pre-activation ``y1_i`` and each later pair's input ``x_i`` into
buffers of their own; its plain twin is :func:`trio_forward_with_acts_reference`.
The backward, :func:`trio_backward`, is the exact reverse chain of the JAX package's
(``trio_grad.py:217-265``) on PyTorch's conv gradients over the saved
activations, with no recompute of the forward convs -- the JAX package runs
that chain in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from vits_tpu_torch.ops.conv import conv1d, leaky_relu
from vits_tpu_torch.ops.cuda import cuda_lengths, on_cuda
from vits_tpu_torch.ops.cuda.resblock import pair_weights, run_pairs


def _blocks_of(metas: Sequence[tuple[int, tuple[int, ...]]], weights: Sequence[torch.Tensor]):
    """Per-pair (w1, b1, w2, b2) flat list -> kernel block dicts."""
    blocks, pos = [], 0
    for k, dilations in metas:
        n = len(dilations)
        quads = [weights[pos + 4 * i: pos + 4 * i + 4] for i in range(n)]
        pos += 4 * n
        blocks.append(dict(kernel_size=k, dilations=dilations,
                           w1=[q[0] for q in quads], b1=[q[1] for q in quads],
                           w2=[q[2] for q in quads], b2=[q[3] for q in quads]))
    return blocks


def trio_forward_with_acts_reference(x: torch.Tensor, blocks: Sequence[dict], *, slope: float):
    """Plain PyTorch: (mean of the unmasked resblocks, per block (y1s, xs))."""
    total, acts = None, []
    for blk in blocks:
        k = blk["kernel_size"]
        h, y1s, xs = x, [], []
        for i, d in enumerate(blk["dilations"]):
            if i > 0:
                xs.append(h)
            y1 = conv1d(leaky_relu(h, slope), blk["w1"][i], blk["b1"][i],
                        padding=(k * d - d) // 2, dilation=d)
            y1s.append(y1)
            h = h + conv1d(leaky_relu(y1, slope), blk["w2"][i], blk["b2"][i],
                           padding=(k - 1) // 2)
        acts.append((y1s, xs))
        total = h if total is None else total + h
    return total * (1.0 / len(blocks)), acts


def trio_forward_with_acts(x: torch.Tensor, blocks: Sequence[dict], *, slope: float):
    """(mean_j resblock_j(x), per block (y1s, xs)), unmasked.

    CPU tensors take :func:`trio_forward_with_acts_reference`; CUDA tensors
    launch the kernel (fp32, contiguous, C % 32 == 0, odd kernel sizes) or raise.
    """
    if not on_cuda("trio_forward_with_acts", x, *pair_weights(blocks)):
        return trio_forward_with_acts_reference(x, blocks, slope=slope)
    B, T, _ = x.shape
    acts = [([torch.empty_like(x) for _ in blk["dilations"]],
             [torch.empty_like(x) for _ in blk["dilations"][1:]]) for blk in blocks]
    out = torch.empty_like(x)
    run_pairs(x, out, blocks, cuda_lengths(None, B, T, x.device), slope, acts=acts)
    trio_forward_with_acts.launches += 1
    return out, acts


trio_forward_with_acts.launches = 0


def _conv_grads(dy, h, w, padding, dilation, need_input):
    """(d h, d w) of conv1d(h, w, padding, dilation) for output grad dy; (B, T, C) layouts."""
    # the backward op takes what the forward would have saved: contiguous
    # channels-first tensors (strided views are not normalised here)
    grad_in, grad_w, _ = torch.ops.aten.convolution_backward(
        dy.transpose(1, 2).contiguous(), F.pad(h.transpose(1, 2), (padding, padding)).contiguous(),
        w.permute(2, 1, 0).contiguous(), None, [1], [0], [dilation], False, [0], 1,
        [need_input, True, False])
    if need_input:  # drop the grad of the padding
        grad_in = grad_in[..., padding: grad_in.shape[-1] - padding].transpose(1, 2)
    return grad_in, grad_w.permute(2, 1, 0)


def _leaky_grad(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, slope)


def flat_acts(acts) -> list[torch.Tensor]:
    """Per block (y1s, xs) -> the flat list :func:`trio_backward` takes."""
    return [a for y1s, xs in acts for a in (*y1s, *xs)]


def trio_backward(g: torch.Tensor, x: torch.Tensor, blocks: Sequence[dict],
                  saved: Sequence[torch.Tensor], *, slope: float, need_x: bool = True):
    """(dx or None, [dw1, db1, dw2, db2] per pair in :func:`pair_weights` order) of
    mean_j resblock_j(x) for output grad ``g``, from the saved activations
    (:func:`flat_acts`) with no recompute of the forward convs."""
    inv = 1.0 / len(blocks)
    dx_total, dweights, a_pos = None, [], 0
    for blk in blocks:
        k, dilations = blk["kernel_size"], blk["dilations"]
        n = len(dilations)
        y1s, xs = saved[a_pos: a_pos + n], saved[a_pos + n: a_pos + 2 * n - 1]
        a_pos += 2 * n - 1
        block_grads = [None] * (4 * n)
        dx = g * inv  # d(mean)/d(block output)
        for i in reversed(range(n)):
            x_in = x if i == 0 else xs[i - 1]
            y1 = y1s[i]
            # x_out = x_in + conv2(leaky(y1)) + b2
            dh2, dw2 = _conv_grads(dx, leaky_relu(y1, slope), blk["w2"][i], (k - 1) // 2, 1,
                                   True)
            dy1 = dh2 * _leaky_grad(y1, slope)
            # y1 = conv1(leaky(x_in)) + b1
            need_in = i > 0 or need_x
            dh1, dw1 = _conv_grads(dy1, leaky_relu(x_in, slope), blk["w1"][i],
                                   dilations[i] * (k - 1) // 2, dilations[i], need_in)
            block_grads[4 * i: 4 * i + 4] = [dw1, dy1.sum(dim=(0, 1)), dw2, dx.sum(dim=(0, 1))]
            if need_in:
                dx = dx + dh1 * _leaky_grad(x_in, slope)
        dweights += block_grads
        if need_x:
            dx_total = dx if dx_total is None else dx_total + dx
    return dx_total, dweights


class _TrainableTrio(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, metas, *weights):
        out, acts = trio_forward_with_acts(x, _blocks_of(metas, weights), slope=slope)
        ctx.slope, ctx.metas = slope, metas
        ctx.save_for_backward(x, *weights, *flat_acts(acts))
        return out

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        n_w = sum(4 * len(d) for _, d in ctx.metas)
        dx, dweights = trio_backward(g, x, _blocks_of(ctx.metas, rest[:n_w]), rest[n_w:],
                                     slope=ctx.slope, need_x=ctx.needs_input_grad[0])
        return (dx, None, None,
                *(gw if need else None for gw, need in zip(dweights, ctx.needs_input_grad[3:])))


def trainable_trio(x: torch.Tensor, blocks: Sequence[dict], *, slope: float) -> torch.Tensor:
    """mean_j resblock_j(x), unmasked, differentiable in x and every weight.

    ``blocks`` as :func:`vits_tpu_torch.ops.cuda.resblock.fused_resblock_trio`
    takes them (per-pair weight lists).
    """
    metas = tuple((blk["kernel_size"], tuple(blk["dilations"])) for blk in blocks)
    return _TrainableTrio.apply(x, slope, metas, *pair_weights(blocks))
