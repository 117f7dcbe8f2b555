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

Tiers (``ops/tiers.py``, as ``make_trainable_trio(precision=...)``): the
exact tier on fp32 tensors (fp32 training), and ``BF16_TRAIN_TIER`` on bf16
tensors (bf16 training). JAX's bf16 training does not reach its trio kernel
(``vits_tpu/models/hifigan.py:356-357`` requires fp32): it runs the plain
resblocks in XLA's bf16 graph, so here kernel 5 computes that graph
(``hifigan.py:29-57, 425-434``): every tensor bf16 storage, the products
bf16 with fp32 sums, and a rounding to bf16 wherever XLA rounds -- each conv's
output, the bias add, leaky's product with the bf16 slope, the residual add,
the sum over the blocks and its division by their count, and in the backward
the same steps of the reverse chain (the weight gradients summed in fp32 over
the frames, rounded once). The forward is B's conv at the fast tier on bf16
(``run_pairs`` through ``vk_conv_bf16``), the backward the same C call as
fp32 at ``mode`` fast. The plain twins compute it in bf16 PyTorch ops.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from vits_tpu_torch.ops.conv import conv1d, leaky_relu
from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER, EXACT_TIER, TRAIN_TIERS, Tier, carry_slope
from vits_tpu_torch.ops.cuda import (
    booked_to,
    check,
    count_launch,
    current_book,
    cuda_lengths,
    device_sm_count,
    library,
    on_cuda,
    on_device,
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


def check_tier(name: str, tier: Tier, *tensors: torch.Tensor) -> None:
    """Raise unless ``tier`` is one of :data:`TRAIN_TIERS` and every tensor has its
    value dtype (fp32 at the exact tier, bf16 at the bf16 one)."""
    if tier not in TRAIN_TIERS:
        raise ValueError(f"{name}: kernel 5 runs the exact tier on fp32 or the fast tier on "
                         f"bf16 values, not {tier.name}")
    if any(t.dtype != tier.value_dtype for t in tensors):
        raise ValueError(f"{name}: the {tier.name} tier takes {tier.value_dtype} tensors, got "
                         f"{sorted({str(t.dtype) for t in tensors})}")


def _mean(total: torch.Tensor, n: int) -> torch.Tensor:
    """The mean's scaling of a sum over n blocks: XLA's bf16 division, or the fp32
    kernels' multiply by 1/n."""
    return total / n if total.dtype == torch.bfloat16 else total * (1.0 / n)


def trio_forward_with_acts_reference(x: torch.Tensor, blocks: Sequence[dict], *, slope: float):
    """Plain PyTorch: (mean of the unmasked resblocks, per block (y1s, xs)), in the
    dtype of x and the weights (bf16: XLA's bf16 graph)."""
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
    return _mean(total, len(blocks)), acts


def trio_forward_with_acts(x: torch.Tensor, blocks: Sequence[dict], *, slope: float,
                           tier: Tier = EXACT_TIER):
    """(mean_j resblock_j(x), per block (y1s, xs)), unmasked, at ``tier`` (one of
    :data:`TRAIN_TIERS`; x, weights and biases in its value dtype).

    CPU tensors take :func:`trio_forward_with_acts_reference`; CUDA tensors
    launch the kernel (contiguous, C % 32 == 0, odd kernel sizes) or raise.
    """
    weights = pair_weights(blocks)
    check_tier("trio_forward_with_acts", tier, x, *weights)
    if not on_cuda("trio_forward_with_acts", x, *weights, dtype=tier.value_dtype):
        return trio_forward_with_acts_reference(x, blocks, slope=slope)
    B, T, _ = x.shape
    acts = [([torch.empty_like(x) for _ in blk["dilations"]],
             [torch.empty_like(x) for _ in blk["dilations"][1:]]) for blk in blocks]
    out = torch.empty_like(x)
    run_pairs(x, out, blocks, cuda_lengths(None, B, T, x.device), slope, acts=acts, tier=tier)
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


def _leaky_vjp(g: torch.Tensor, x: torch.Tensor, slope: float) -> torch.Tensor:
    """g times leaky's derivative at x (on bf16: the rounded product with the bf16
    slope, as XLA's VJP of ``where(x >= 0, x, x * slope)``)."""
    if g.dtype == torch.bfloat16:
        return torch.where(x >= 0, g, g * carry_slope(slope, BF16_TRAIN_TIER))
    return g * torch.where(x >= 0, 1.0, slope)


def flat_acts(acts) -> list[torch.Tensor]:
    """Per block (y1s, xs) -> the flat list :func:`trio_backward` takes."""
    return [a for y1s, xs in acts for a in (*y1s, *xs)]


def trio_backward_reference(g: torch.Tensor, x: torch.Tensor, blocks: Sequence[dict],
                            saved: Sequence[torch.Tensor], *, slope: float,
                            need_x: bool = True):
    """Plain PyTorch: (dx or None, [dw1, db1, dw2, db2] per pair in
    :func:`pair_weights` order) of mean_j resblock_j(x) for output grad ``g``,
    from the saved activations (:func:`flat_acts`) with no recompute of the
    forward convs; on bf16 tensors XLA's bf16 VJP, step by step."""
    dx_total, dweights, a_pos = None, [], 0
    for blk in blocks:
        k, dilations = blk["kernel_size"], blk["dilations"]
        n = len(dilations)
        y1s, xs = saved[a_pos: a_pos + n], saved[a_pos + n: a_pos + 2 * n - 1]
        a_pos += 2 * n - 1
        block_grads = [None] * (4 * n)
        dx = _mean(g, len(blocks))  # d(mean)/d(block output)
        for i in reversed(range(n)):
            x_in = x if i == 0 else xs[i - 1]
            y1 = y1s[i]
            # x_out = x_in + conv2(leaky(y1)) + b2
            dh2, dw2 = _conv_grads(dx, leaky_relu(y1, slope), blk["w2"][i], (k - 1) // 2, 1,
                                   True)
            dy1 = _leaky_vjp(dh2, y1, slope)
            # y1 = conv1(leaky(x_in)) + b1
            need_in = i > 0 or need_x
            dh1, dw1 = _conv_grads(dy1, leaky_relu(x_in, slope), blk["w1"][i],
                                   dilations[i] * (k - 1) // 2, dilations[i], need_in)
            block_grads[4 * i: 4 * i + 4] = [dw1, dy1.sum(dim=(0, 1)), dw2, dx.sum(dim=(0, 1))]
            if need_in:
                dx = dx + _leaky_vjp(dh1, x_in, slope)
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
                  saved: Sequence[torch.Tensor], *, slope: float, need_x: bool = True,
                  tier: Tier = EXACT_TIER):
    """(dx or None, [dw1, db1, dw2, db2] per pair in :func:`pair_weights` order) of
    mean_j resblock_j(x) for output grad ``g``, from the saved activations
    (:func:`flat_acts`), at ``tier`` (one of :data:`TRAIN_TIERS`; every tensor in
    its value dtype, and the gradients with it).

    CPU tensors take :func:`trio_backward_reference`; CUDA tensors launch the
    kernels (contiguous, C a multiple of 64, odd kernel sizes) or raise.
    """
    weights = pair_weights(blocks)
    check_tier("trio_backward", tier, g, x, *weights, *saved)
    if not on_cuda("trio_backward", g, x, *weights, dtype=tier.value_dtype):
        return trio_backward_reference(g, x, blocks, saved, slope=slope, need_x=need_x)
    saved = [a.contiguous() for a in saved]  # the kernel forward's already are
    on_cuda("trio_backward", x, *saved, dtype=tier.value_dtype)
    B, T, C = x.shape
    if C % WGRAD_TILE or g.shape != x.shape:
        raise ValueError(f"trio backward kernel needs C % {WGRAD_TILE} == 0 and g of x's "
                         f"shape (got x {tuple(x.shape)}, g {tuple(g.shape)})")
    sms = device_sm_count(x.device)
    lens = cuda_lengths(None, B, T, x.device)
    dx_total = torch.empty_like(x) if need_x else None
    g_inv = _mean(g, len(blocks)).contiguous()  # d(mean)/d(block output)
    # every pair its own dy1 and dx buffers: the second stream's weight
    # gradients read them while later pairs run
    buffers = x.new_empty((2 * sum(len(blk["dilations"]) for blk in blocks), B, T, C))
    buf, step = buffers.data_ptr(), buffers.element_size() * B * T * C
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
    with on_device(x):
        check(library().vk_trio_backward(table, len(pairs), lens.data_ptr(), B, T, C,
                                         carry_slope(slope, tier), tier.mode, stream_of(x)),
              "trio backward kernels")
    count_launch(trio_backward)
    return dx_total, dweights


trio_backward.launches = 0


class _TrainableTrio(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, slope, metas, tier, *weights):
        out, acts = trio_forward_with_acts(x, _blocks_of(metas, weights), slope=slope, tier=tier)
        ctx.slope, ctx.metas, ctx.tier, ctx.book = slope, metas, tier, current_book()
        ctx.save_for_backward(x, *weights, *flat_acts(acts))
        return out

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        n_w = sum(4 * len(d) for _, d in ctx.metas)
        with booked_to(ctx.book):  # the forward's label
            dx, dweights = trio_backward(g.contiguous(), x, _blocks_of(ctx.metas, rest[:n_w]),
                                         rest[n_w:], slope=ctx.slope,
                                         need_x=ctx.needs_input_grad[0], tier=ctx.tier)
        return (dx, None, None, None,
                *(gw if need else None for gw, need in zip(dweights, ctx.needs_input_grad[4:])))


def trainable_trio(x: torch.Tensor, blocks: Sequence[dict], *, slope: float,
                   tier: Tier = EXACT_TIER) -> torch.Tensor:
    """mean_j resblock_j(x), unmasked, differentiable in x and every weight, at
    ``tier`` (one of :data:`TRAIN_TIERS`).

    ``blocks`` as :func:`vits_tpu_torch.ops.cuda.resblock.fused_resblock_trio`
    takes them (per-pair weight lists).
    """
    metas = tuple((blk["kernel_size"], tuple(blk["dilations"])) for blk in blocks)
    return _TrainableTrio.apply(x, slope, metas, tier, *pair_weights(blocks))
