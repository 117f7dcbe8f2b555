"""Kernel 5: the resblock trio of a wide vocoder stage, trainable.

Replaces ``vits_tpu/ops/pallas/trio_grad.py::make_trainable_trio``.
:func:`trainable_trio` is a ``torch.autograd.Function``. Its forward,
:func:`trio_forward_with_acts`, is kernel B's conv (``vits_tpu_torch/csrc/
resblock_trio.cu``, lengths = T: training segments are unmasked) writing each
pair's pre-activation ``y1_i`` and each later pair's input ``x_i`` into
buffers of their own; its plain twin is :func:`trio_forward_with_acts_reference`.
The backward, :func:`trio_backward`, is the exact reverse chain of the JAX
package's VJP (``trio_grad.py:217-265``, run there in XLA outside any Pallas
kernel) over the saved activations, with no recompute of the forward convs:
per pair two weight-gradient launches and two input-gradient launches of
``vits_tpu_torch/csrc/trio_grad.cu`` (the conv reading the weights flipped
in time and transposed, leaky's derivative in its epilogue; the weight
gradients a 3xTF32 GEMM over the frames, split over a cluster and summed in
a fixed order, so a repeated backward is bit-identical). Its plain twin,
which CPU tensors take, is :func:`trio_backward_reference`: PyTorch's conv
gradients and elementwise ops.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from vits_tpu_torch.ops.conv import conv1d, leaky_relu
from vits_tpu_torch.ops.cuda import (
    check,
    count_launch,
    cuda_lengths,
    device_sm_count,
    library,
    on_cuda,
    stream_of,
)
from vits_tpu_torch.ops.cuda.resblock import conv_plan, pair_weights, run_pairs

# The weight-gradient tile (csrc/trio_grad.cu): C_in x C_out channels per block,
# and the frames of one step.
WGRAD_TILE = 64
WGRAD_FRAMES = 32


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
    count_launch(trio_forward_with_acts)
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


def trio_backward_reference(g: torch.Tensor, x: torch.Tensor, blocks: Sequence[dict],
                            saved: Sequence[torch.Tensor], *, slope: float,
                            need_x: bool = True):
    """Plain PyTorch: (dx or None, [dw1, db1, dw2, db2] per pair in
    :func:`pair_weights` order) of mean_j resblock_j(x) for output grad ``g``,
    from the saved activations (:func:`flat_acts`) with no recompute of the
    forward convs."""
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


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """(k, C_in, C_out) -> (k, C_out, C_in), flipped in time: the weights of a
    conv's input gradient, flipT(w)[tap][o][i] = w[k-1-tap][i][o]. The kernel
    reads w this way in its tile loader; this is the plain form."""
    return w.flip(0).transpose(1, 2)


def wgrad_split(B: int, T: int, C: int, k: int, sm_count: int) -> int:
    """Blocks of a cluster sharing one weight-gradient tile's frames: the least
    split (1, 2, 4, 8) whose grid puts two blocks on every SM, short of one that
    would leave a block without frames."""
    tiles = (C // WGRAD_TILE) ** 2 * k
    steps = -(-B * T // WGRAD_FRAMES)
    best = 1
    for split in (2, 4, 8):
        if tiles * best >= 2 * sm_count or (split - 1) * -(-steps // split) >= steps:
            break
        best = split
    return best


class TrioPair(ctypes.Structure):
    """One pair of the backward as ``csrc/trio_grad.cu::vk_trio_backward`` takes it."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "w1", "w2", "y1", "x_in", "dx_in", "dy1", "dx_out", "dw1", "db1", "dw2", "db2")]
        + [(name, ctypes.c_int) for name in (
            "k", "dil", "tile", "split", "wsplit", "need_in", "accumulate")])


def trio_backward(g: torch.Tensor, x: torch.Tensor, blocks: Sequence[dict],
                  saved: Sequence[torch.Tensor], *, slope: float, need_x: bool = True):
    """(dx or None, [dw1, db1, dw2, db2] per pair in :func:`pair_weights` order) of
    mean_j resblock_j(x) for output grad ``g``, from the saved activations
    (:func:`flat_acts`).

    CPU tensors take :func:`trio_backward_reference`; CUDA tensors launch the
    kernels (fp32, contiguous, C a multiple of 64, odd kernel sizes) or raise.
    """
    weights = pair_weights(blocks)
    if not on_cuda("trio_backward", g, x, *weights):
        return trio_backward_reference(g, x, blocks, saved, slope=slope, need_x=need_x)
    saved = [a.contiguous() for a in saved]  # the kernel forward's already are
    on_cuda("trio_backward", x, *saved)
    B, T, C = x.shape
    if C % WGRAD_TILE or g.shape != x.shape:
        raise ValueError(f"trio backward kernel needs C % {WGRAD_TILE} == 0 and g of x's "
                         f"shape (got x {tuple(x.shape)}, g {tuple(g.shape)})")
    sms = device_sm_count(x.device)
    lens = cuda_lengths(None, B, T, x.device)
    dx_total = torch.empty_like(x) if need_x else None
    g_inv = g * (1.0 / len(blocks))  # d(mean)/d(block output)
    # every pair its own dy1 and dx buffers: the second stream's weight
    # gradients read them while later pairs run
    buffers = x.new_empty((2 * sum(len(blk["dilations"]) for blk in blocks), B, T, C))
    buf, step = buffers.data_ptr(), 4 * B * T * C
    pairs, dweights, a_pos = [], [], 0
    for j, blk in enumerate(blocks):
        k, dilations = blk["kernel_size"], blk["dilations"]
        n = len(dilations)
        if k % 2 == 0:
            raise ValueError(f"trio backward kernel needs an odd kernel size, got {k}")
        for w in (*blk["w1"], *blk["w2"]):
            if w.shape != (k, C, C):
                raise ValueError(f"trio backward: weight {tuple(w.shape)} != ({k}, {C}, {C})")
        y1s, xs = saved[a_pos: a_pos + n], saved[a_pos + n: a_pos + 2 * n - 1]
        a_pos += 2 * n - 1
        tile, split, _ = conv_plan(B, T, C, C, k, sms)
        wsplit = wgrad_split(B, T, C, k, sms)
        dws = x.new_empty((2 * n, k, C, C)).unbind(0)  # dw1 of each pair, then dw2
        dbs = x.new_empty((2 * n, C)).unbind(0)
        dx = g_inv.data_ptr()
        for i in reversed(range(n)):
            need_in = i > 0 or need_x
            # the last pair adds its block's dx into the sum over blocks
            dx_out = (dx_total.data_ptr() if i == 0 else buf + step) if need_in else None
            pairs.append(TrioPair(
                blk["w1"][i].data_ptr(), blk["w2"][i].data_ptr(), y1s[i].data_ptr(),
                (x if i == 0 else xs[i - 1]).data_ptr(), dx, buf, dx_out, dws[i].data_ptr(),
                dbs[i].data_ptr(), dws[n + i].data_ptr(), dbs[n + i].data_ptr(), k,
                dilations[i], tile, split, wsplit, int(need_in), int(i == 0 and j > 0)))
            buf += 2 * step
            dx = dx_out
        dweights += [t for i in range(n) for t in (dws[i], dbs[i], dws[n + i], dbs[n + i])]
    table = (TrioPair * len(pairs))(*pairs)
    check(library().vk_trio_backward(table, len(pairs), lens.data_ptr(), B, T, C, slope,
                                     stream_of(x)), "trio backward kernels")
    count_launch(trio_backward)
    return dx_total, dweights


trio_backward.launches = 0


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
        dx, dweights = trio_backward(g.contiguous(), x, _blocks_of(ctx.metas, rest[:n_w]),
                                     rest[n_w:], slope=ctx.slope,
                                     need_x=ctx.needs_input_grad[0])
        return (dx, None, None,
                *(gw if need else None for gw, need in zip(dweights, ctx.needs_input_grad[3:])))


def trainable_trio(x: torch.Tensor, blocks: Sequence[dict], *, slope: float) -> torch.Tensor:
    """mean_j resblock_j(x), unmasked, differentiable in x and every weight.

    ``blocks`` as :func:`vits_tpu_torch.ops.cuda.resblock.fused_resblock_trio`
    takes them (per-pair weight lists).
    """
    metas = tuple((blk["kernel_size"], tuple(blk["dilations"])) for blk in blocks)
    return _TrainableTrio.apply(x, slope, metas, *pair_weights(blocks))
