"""Kernels B and 7: the HiFiGAN resblocks of a vocoder stage.

Kernel B replaces ``vits_tpu/ops/pallas/resblock.py::fused_resblock_trio``:
the mean over a wide stage's resblocks, each a chain of masked (dilated conv,
conv) pairs. It is the conv of ``vits_tpu_torch/csrc/resblock_trio.cu``,
launched twice per pair by :func:`run_pairs` (18 launches for a trio); the
last pair of each resblock folds its output into the mean in place. The conv
takes every channel count the JAX kernels take: a tensor-core path
(``csrc/conv_gemm.cuh``, mma.sync) for C % 32 == 0 and a narrow one (3xTF32
on n8 tiles, ``csrc/narrow_gemm.cuh``) for other C, :func:`conv_plan` picking
the path, the tile and the split of each launch; at the fast tier on bf16
weights, C % 64 == 0, Hopper's route (``csrc/conv_wgmma.cuh``: TMA, an
mbarrier ring, wgmma), planned by :func:`wgmma_plan`. :func:`conv` launches
one conv on its route; :func:`conv_reference` is its plain twin. Kernel C's
resblocks at C = 32 on that tier (bf16 packs, bf16 values; the rule is
``stage.py::stage_routes``) take a route of their own: one launch a pair
(``csrc/pair_wgmma.cu``, :func:`pair`, :func:`pair_plan`), y1 kept on chip,
the outputs between resblocks in bf16 buffers (:func:`run_fused_pairs`; twins
:func:`pair_reference`, :func:`fused_pairs_reference`); B's launches stay.

Kernel 7 replaces ``fused_resblock`` of the same file: ONE resblock, which
the JAX package runs on the narrow stages that fail the stage kernel's check
(HiFi-GAN V2's C = 64 and 32; the caller sums the blocks and divides). At C
in :data:`BLOCK_CHANNELS` it is one launch of ``csrc/resblock_block.cu``:
each block loads one x window with the halo of every pair and runs all six
convs in shared memory, the out-channels split over a thread-block cluster;
:func:`block_plan` picks the time tile and the cluster.
:func:`resblock_tiled` is that algorithm in plain PyTorch. Other widths (C =
1, 2, 4) take B's conv, six launches. The 128-lane time packing of the
narrow TPU kernel is not carried over. The plain PyTorch twins are
:func:`resblock_trio_reference` and :func:`resblock_reference`.

A block is ``{kernel_size, dilations, w1, b1, w2, b2}`` with ``w1[i]``,
``w2[i]`` the pair's (k, C, C) kernels and ``b1[i]``, ``b2[i]`` its (C,)
biases -- a stacked (pairs, ...) tensor or a per-pair list. The kernels
fp32, bf16, or int8 with ``s1[i]``, ``s2[i]``: the (C,) per-out-channel
scales each conv's sum is multiplied by before its bias (the vocoder packs of
``models/hifigan.py::precompute_vocoder_packs``).

Precision tiers (``ops/tiers.py``): every wrapper takes a ``tier``; the
plain twins emulate it (bf16-rounded operands, the bf16x3 split, the value
carry rounded to bf16 where the JAX kernels cast to their value dtype), and
the kernels compute it (``csrc/common.cuh`` TierMode). With bf16 values
kernel B takes and returns bf16 activations (the vocoder's carry between
kernels); the kernels stage them as fp32.

bf16 serving (``Tier.bf16_compute``, ``ops/tiers.py::BF16_COMPUTE_TIER``): the
JAX package runs no resblock kernel at ``compute_dtype="bfloat16"``, but XLA's
masked bf16 graph of the plain resblocks (``vits_tpu/models/hifigan.py:29-57``,
the mean ``:425-433``), and B and 7 compute that graph on bf16 activations,
weights and biases, rounding to bf16 after each step (B: ``vk_conv_bf16``,
kernel 5's bf16 forward with the mask; 7: ``vk_resblock_block`` with io16).
Their twin is :func:`resblocks_mean_bf16`, the graph in bf16 PyTorch ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from vits_tpu_torch.ops.conv import conv1d, leaky_relu
from vits_tpu_torch.ops.tiers import (
    EXACT,
    EXACT_TIER,
    FAST,
    HIGH,
    Tier,
    carry,
    carry_slope,
    tier_conv1d,
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

# Block tiles (time steps, out-channels) of the tensor-core conv, by the id
# resblock_trio.cu::vk_conv takes.
CONV_TILES = ((128, 64), (64, 64), (128, 32), (64, 32))
CONV_CHUNK = 32  # input channels per K step
CONV_SPLITS = (1, 2, 4, 8)  # cluster sizes that may share one tile's K steps
# The plan's cost model, fitted to scripts/torch_conv_probe.py on an H100
# (every tile and split at the main paths' shapes): each tile's rate relative
# to the 128 x 64 tile, and a block's fixed cost (prologue, cluster reduction,
# epilogue) in K steps.
CONV_TILE_RATES = (1.0, 0.9, 0.85, 0.7)
CONV_BLOCK_STEPS = 2
# The narrow path's block (csrc/narrow_gemm.cuh): time steps, and out-channels
# in n8 MMA tiles of at most NARROW_COLS.
NARROW_ROWS = 64
NARROW_COLS = 64
# Kernel 7's one-launch resblock (csrc/resblock_block.cu): the widths it takes,
# its most pairs, its warps, the window rows past bm + 2H that a partial m16
# tile may read, and the shared memory one block may use (227 KB).
BLOCK_CHANNELS = (8, 16, 32, 64)
BLOCK_MAX_PAIRS = 4
BLOCK_WARPS = 16
BLOCK_MARGIN = 16
MAX_SMEM_BYTES = 232448
BLOCK_TILES = tuple(range(32, 1024 + 1, 16))  # the time tiles block_plan weighs
BLOCK_CLUSTERS = (1, 2, 4, 8)
# block_plan's cost model, fitted (non-negative least squares, median error
# 15%) to scripts/torch_block_probe.py's sweep on an H100 of every tile and
# cluster at kernel 7's shapes: ns a block, ns a conv's cluster barrier, ns a
# warp round of one conv per tap x input channel (its A fragments) and per
# tap x input channel x n8 tile of a unit (weights and MMAs), ns per float a
# block stores into its peers' windows; and the share of sm_count / cluster
# clusters of 4 or 8 that run at once (a GPC's SMs are no multiple of them).
BLOCK_FIXED_NS = 5862.0
BLOCK_SYNC_NS = 259.0
BLOCK_TAP_NS = 5.955
BLOCK_TILE_NS = 6.152
BLOCK_PUSH_NS = 0.0272
BLOCK_CLUSTER_FILL = 0.91


# Hopper's route of the conv (csrc/conv_wgmma.cuh): at the fast tier with bf16
# weights and fp32 activations, every conv with C_in and C_out multiples of
# WGMMA_CHUNK and a window of at most 64 * nc + WGMMA_MAX_HALO rows (one TMA
# box). Blocks of nc consumer warpgroups (64 output steps each) x bn
# out-channels (WGMMA_SHAPES), a ring of 2-8 weight stages, K steps of
# WGMMA_CHUNK input channels x one tap.
WGMMA_CHUNK = 64
# (bn, nc) built, and the blocks an SM each is built for by its registers (csrc's
# kBlocksPerSm): nc = 2, two consumer warpgroups and a producer one (setmaxnreg),
# one an SM; nc = 1, one and a producer warp, three an SM. A plan runs that many
# where their shared memory (and the 1 KB the card reserves a block) fits the
# SM's 228 KB, else fewer. (64, 2) and (256, 1) measured no faster than these at
# any shape of B and C (scripts/torch_wgmma_probe.py --sweep).
WGMMA_SHAPES = {(128, 2): 1, (256, 2): 1, (64, 1): 3, (128, 1): 3}
WGMMA_MAX_HALO = 128
WGMMA_STAGES = range(2, 9)
WGMMA_A_STRIDE = WGMMA_CHUNK + 8  # bf16 window row, values
SM_SMEM_BYTES = 233472
# wgmma_plan's cost model (ns), fitted to scripts/torch_wgmma_probe.py --sweep on
# an H100 at B's and C's MMS shapes: a wave's fixed cost (its windows, the
# cluster reduction, the epilogue: the activations' bytes, mostly), a K step's
# own and per out-channel of a 128-row tile; the blocks of a wave on one SM
# share the steps' time.
WGMMA_BLOCK_NS = 4000.0
WGMMA_STEP_NS = 100.0
WGMMA_COL_NS = 2.0


class WgmmaPlan(NamedTuple):
    bn: int  # out-channels of a block's tile
    nc: int  # consumer warpgroups of a block: 64 * nc output steps
    stages: int  # weight slots of the ring
    split: int  # blocks of a cluster, each summing ceil(steps / split) of the K steps
    smem: int  # dynamic shared memory of a block, bytes
    blocks: int  # grid size, counting every block of a cluster
    per_sm: int  # blocks an SM runs at once


def wgmma_smem(bn: int, stages: int, halo: int, nc: int) -> int:
    """Shared memory of one block of csrc/conv_wgmma.cuh (its ``Smem``): 1 KB of
    mbarriers, the ring of (WGMMA_CHUNK x bn) bf16 stages, the raw fp32 window of
    64 * nc + halo rows, a bf16 window of 64 + halo rows a consumer warpgroup;
    the staged fp32 output tile (rows of bn + 8) reuses it from the ring on; plus
    1 KB to align the base to the 128-byte swizzle's 1 KB atoms."""
    ring = 1024
    pipe = (ring + stages * WGMMA_CHUNK * bn * 2 + (64 * nc + halo) * WGMMA_CHUNK * 4
            + nc * (64 + halo) * WGMMA_A_STRIDE * 2)
    tile = ring + 64 * nc * (bn + 8) * 4
    return max(pipe, tile) + 1024


def wgmma_tensor_maps(B: int, T: int, C_in: int, C_out: int, k: int, dil: int,
                      nc: int) -> dict:
    """The two TMA tensor maps of one conv on Hopper's route, as
    csrc/conv_wgmma.cuh::launch encodes them: ``dims`` and ``box`` innermost
    first, ``strides`` in bytes (the innermost dimension's left out), ``swizzle`` the
    span of a swizzled map in bytes. x, fp32:
    (C_in, T, B), a box a chunk's raw window (WGMMA_CHUNK channels x 64 * nc +
    (k - 1) * dil steps x one row). w, bf16, 128-byte swizzle: (C_out, k *
    C_in), a box 64 out-channels (128 bytes) x WGMMA_CHUNK rows."""
    return {
        "x": {"dims": (C_in, T, B), "strides": (C_in * 4, T * C_in * 4),
              "box": (WGMMA_CHUNK, 64 * nc + (k - 1) * dil, 1), "elem_bytes": 4},
        "w": {"dims": (C_out, k * C_in), "strides": (C_out * 2,), "box": (64, WGMMA_CHUNK),
              "elem_bytes": 2, "swizzle": 128},
    }


def wgmma_fits(bn: int, nc: int, halo: int) -> tuple[int, int] | None:
    """(stages, blocks an SM) of one block shape: the most blocks its registers allow
    (WGMMA_SHAPES) whose shared memory fits the SM, at the deepest ring that
    lets them; None when no ring fits a block."""
    for per_sm in range(WGMMA_SHAPES[bn, nc], 0, -1):
        fits = [s for s in WGMMA_STAGES if wgmma_smem(bn, s, halo, nc) <= MAX_SMEM_BYTES
                and per_sm * (wgmma_smem(bn, s, halo, nc) + 1024) <= SM_SMEM_BYTES]
        if fits:
            return fits[-1], per_sm
    return None


@functools.lru_cache(maxsize=1024)
def wgmma_plan(B: int, T: int, C_in: int, C_out: int, k: int, dil: int,
               sm_count: int) -> WgmmaPlan | None:
    """Tile width, warpgroups, ring depth and K split of one conv on Hopper's
    route, or None for a shape off its grid (C_in or C_out not a multiple of
    WGMMA_CHUNK, or (k - 1) * dil past WGMMA_MAX_HALO), which keeps
    :func:`conv_plan`'s route.

    Each (bn, nc) takes :func:`wgmma_fits`' ring and blocks an SM; among them
    and the splits (1, 2, 4, 8; every block of a cluster with K steps) the least
    modelled time: waves of ``per_sm`` blocks an SM, each a fixed cost plus
    ``per_sm`` shares of the steps at (WGMMA_STEP_NS + WGMMA_COL_NS * bn) x
    64 * nc / 128 each."""
    halo = (k - 1) * dil
    if C_in % WGMMA_CHUNK or C_out % WGMMA_CHUNK or halo > WGMMA_MAX_HALO:
        return None
    steps = k * (C_in // WGMMA_CHUNK)
    best = None
    for bn, nc in WGMMA_SHAPES:
        fit = wgmma_fits(bn, nc, halo) if C_out % bn == 0 else None
        if fit is None:
            continue
        stages, per_sm = fit
        tiles = -(-T // (64 * nc)) * (C_out // bn) * B
        for split in CONV_SPLITS:
            share = -(-steps // split)
            if (split - 1) * share >= steps or 64 * nc % split:
                continue
            blocks = tiles * split
            cost = -(-blocks // (sm_count * per_sm)) * (
                WGMMA_BLOCK_NS + per_sm * share * (WGMMA_STEP_NS + WGMMA_COL_NS * bn) * nc / 2)
            plan = WgmmaPlan(bn, nc, stages, split, wgmma_smem(bn, stages, halo, nc), blocks,
                             per_sm)
            if best is None or cost < best[0]:
                best = (cost, plan)
    return None if best is None else best[1]


# Kernel C's 32-channel pairs on Hopper (csrc/pair_wgmma.cu): at the fast tier on
# bf16 packs with bf16 values, one launch a pair at C = PAIR_C. A tile of nw
# warpgroups (PAIR_NWS) computes y1 over 64 * nw rows and the output over the
# 64 * nw - (k - 1) rows in their middle; persistent blocks, up to
# PAIR_BLOCKS_PER_SM an SM (the kernel's __launch_bounds__) where shared memory
# allows, walk the (batch row, tile) items, each block loading the weights once.
PAIR_C = 32
PAIR_NWS = (1, 2)
PAIR_BLOCKS_PER_SM = {1: 6, 2: 3}
PAIR_MAX_WINDOW = 256  # the src window is one TMA box
PAIR_Y_ROW = (PAIR_C + 8) * 2  # bytes of a y1 window row


class PairPlan(NamedTuple):
    nw: int  # warpgroups of a block: y1 over 64 * nw rows a tile
    rows: int  # output rows of a tile, 64 * nw - (k - 1)
    window: int  # rows of the src window, 64 * nw + (k - 1) * dil
    smem: int  # dynamic shared memory of a block, bytes
    blocks: int  # grid size: persistent blocks, at most one a (batch row, tile) item
    per_sm: int  # blocks an SM runs at once


def _round1024(n: int) -> int:
    return -(-n // 1024) * 1024


def pair_smem(k: int, dil: int, nw: int) -> int:
    """Shared memory of one block of csrc/pair_wgmma.cu (stage_wgmma.cuh's
    ``PairSmem``): 1 KB of mbarriers, conv1's and conv2's k (32 x 32) bf16 weight
    slabs, the src window (64 * nw + (k - 1) * dil rows of 64 bytes, 1 KB
    aligned), the y1 window (64 * nw + k - 1 rows of PAIR_Y_ROW bytes), plus 1 KB
    to align the base to the swizzle's atoms."""
    slabs = 2 * k * PAIR_C * PAIR_C * 2
    window = _round1024((64 * nw + (k - 1) * dil) * PAIR_C * 2)
    return 1024 + slabs + window + (64 * nw + k - 1) * PAIR_Y_ROW + 1024


def pair_tensor_maps(B: int, T: int, k: int, dil: int, nw: int) -> dict:
    """The three TMA tensor maps of one pair launch, as csrc/pair_wgmma.cu::launch
    encodes them (``dims`` and ``box`` innermost first, ``strides`` in bytes, the
    innermost left out; ``swizzle`` the span in bytes). src, bf16: (32, T, B), a
    box the window (32 channels x 64 * nw + (k - 1) * dil steps x one row); w1 and
    w2, bf16: (32, k * 32), a box one tap's (32 x 32) slab; all with the 64-byte
    swizzle (a row of 32 bf16)."""
    w = {"dims": (PAIR_C, k * PAIR_C), "strides": (PAIR_C * 2,), "box": (PAIR_C, PAIR_C),
         "elem_bytes": 2, "swizzle": 64}
    return {
        "x": {"dims": (PAIR_C, T, B), "strides": (PAIR_C * 2, T * PAIR_C * 2),
              "box": (PAIR_C, 64 * nw + (k - 1) * dil, 1), "elem_bytes": 2, "swizzle": 64},
        "w1": w, "w2": dict(w),
    }


@functools.lru_cache(maxsize=1024)
def pair_plan(B: int, T: int, C: int, k: int, dil: int, sm_count: int) -> PairPlan | None:
    """The block shape and grid of one pair launch on kernel C's pair route, or None
    off its grid (C != PAIR_C, an even k, or no block shape whose src window fits
    one TMA box and whose shared memory fits a block), which keeps
    :func:`run_pairs`.

    Each shape of PAIR_NWS runs ``per_sm`` blocks an SM (the kernel's register
    bound, fewer where shared memory runs out), a grid of at most that many on
    every SM. The wider tile (half the y1 rows recomputed at tile edges, half the
    weight loads an SM) where its (batch row, tile) items fill that grid; else
    the narrower, whose items spread over more of the card."""
    if C != PAIR_C or k % 2 == 0:
        return None
    plans = []
    for nw in PAIR_NWS:
        window = 64 * nw + (k - 1) * dil
        smem = pair_smem(k, dil, nw)
        if window > PAIR_MAX_WINDOW or 64 * nw <= k - 1 or smem > MAX_SMEM_BYTES:
            continue
        per_sm = min(PAIR_BLOCKS_PER_SM[nw], SM_SMEM_BYTES // (smem + 1024))
        rows = 64 * nw - (k - 1)
        work = -(-T // rows) * B
        plans.append((work >= sm_count * per_sm,
                      PairPlan(nw, rows, window, smem, min(work, sm_count * per_sm), per_sm)))
    if not plans:
        return None
    filled = [plan for full, plan in plans if full]
    return filled[-1] if filled else plans[0][1]


class ConvPlan(NamedTuple):
    tile: int  # index into CONV_TILES; -1 = the narrow path
    split: int  # blocks of a cluster, each summing 1/split of the K steps
    blocks: int  # grid size, counting every block of a cluster


@functools.lru_cache(maxsize=1024)
def conv_plan(B: int, T: int, C_in: int, C_out: int, k: int, sm_count: int,
              uneven: bool = False) -> ConvPlan:
    """Tile and K split of one conv launch.

    Channels off the tensor-core path's grid (C_in % 32 or C_out % 32) take
    the narrow path (tile -1: NARROW_ROWS steps x up to NARROW_COLS
    out-channels per block). Otherwise, among the tiles and splits (dividing the
    k * C_in / 32 steps; with ``uneven``, any split whose last block still gets
    steps, each block taking ceil(steps / split)) whose grid puts two blocks on
    every SM, the one of least modelled time: waves of one block per SM, each
    as long as a block's share of the steps plus its fixed cost, scaled by the
    tile's area over its rate. When no grid is that large, the largest grid.
    """
    if C_in % CONV_CHUNK or C_out % 32:
        return ConvPlan(-1, 1, -(-T // NARROW_ROWS) * -(-C_out // NARROW_COLS) * B)
    steps = k * (C_in // CONV_CHUNK)
    plans = []
    for tile, (bm, bn) in enumerate(CONV_TILES):
        if C_out % bn:
            continue
        tiles = -(-T // bm) * (C_out // bn) * B
        for split in CONV_SPLITS:
            share = -(-steps // split)
            if (steps % split) if not uneven else (split - 1) * share >= steps:
                continue
            blocks = tiles * split
            cost = (-(-blocks // sm_count) * (share + CONV_BLOCK_STEPS) * bm * bn
                    / CONV_TILE_RATES[tile])
            plans.append((blocks >= 2 * sm_count, -cost, ConvPlan(tile, split, blocks)))
    full = [p for p in plans if p[0]]
    if full:
        return max(full, key=lambda p: p[1])[2]
    return max(plans, key=lambda p: p[2].blocks)[2]


def length_mask(lengths: torch.Tensor | None, T: int, dtype) -> torch.Tensor | None:
    """(B,) lengths -> (B, T, 1) 0/1 mask, or None."""
    if lengths is None:
        return None
    steps = torch.arange(T, device=lengths.device)
    return (steps[None, :] < lengths[:, None]).to(dtype)[..., None]


def _pair_scale(blk: dict, name: str, i: int) -> torch.Tensor | None:
    return blk[name][i] if name in blk else None


def _trio_mean(x: torch.Tensor, blocks: Sequence[dict], slope: float,
               mask: torch.Tensor | None, tier: Tier) -> torch.Tensor:
    """fp32 mean_j resblock_j(x) at ``tier``: each conv's operands and the
    pair outputs as the JAX kernels round them (``_trio_kernel``,
    ``_run_pairs``)."""
    x = carry(x.float(), tier)
    x_slope = carry_slope(slope, tier)
    total = None
    for blk in blocks:
        k = blk["kernel_size"]
        h = x
        for i, d in enumerate(blk["dilations"]):
            y = tier_conv1d(leaky_relu(h, x_slope), blk["w1"][i], blk["b1"][i], tier,
                            _pair_scale(blk, "s1", i), padding=(k * d - d) // 2, dilation=d)
            if mask is not None:
                y = y * mask
            y = tier_conv1d(leaky_relu(y, slope), blk["w2"][i], blk["b2"][i], tier,
                            _pair_scale(blk, "s2", i), padding=(k - 1) // 2)
            h = h + y
            if mask is not None:
                h = h * mask
            h = carry(h, tier)
        total = h if total is None else total + h
    return total * (1.0 / len(blocks))


def resblocks_mean(x: torch.Tensor, blocks: Sequence[dict], slope: float,
                   mask: torch.Tensor | None) -> torch.Tensor:
    """The JAX vocoder's plain masked resblocks (``hifigan.py:29-57``) and their
    mean (the sum in order, then the division), in the dtype of x and the
    blocks: on bf16 XLA's bf16 graph, each op rounded, the slopes bf16
    constants."""
    total = None
    for blk in blocks:
        k, h = blk["kernel_size"], x
        for i, d in enumerate(blk["dilations"]):
            y = conv1d(leaky_relu(h, slope), blk["w1"][i], blk["b1"][i],
                       padding=(k * d - d) // 2, dilation=d)
            if mask is not None:
                y = y * mask
            y = conv1d(leaky_relu(y, slope), blk["w2"][i], blk["b2"][i], padding=(k - 1) // 2)
            if mask is not None:
                y = y * mask
            h = y + h
        total = h if total is None else total + h
    return total / len(blocks)


def resblocks_mean_bf16(x: torch.Tensor, blocks: Sequence[dict], slope: float,
                        mask: torch.Tensor | None) -> torch.Tensor:
    """:func:`resblocks_mean` at bf16 (the blocks' tensors cast to bf16): the
    twin of B, C's resblocks and 7 at bf16 serving."""
    b16 = [{k: [t.to(torch.bfloat16) for t in v] if k in ("w1", "b1", "w2", "b2") else v
            for k, v in blk.items()} for blk in blocks]
    return resblocks_mean(x, b16, slope, mask)


def _check_bf16(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name}: bf16 serving takes bf16 activations, not {x.dtype}")


def resblock_trio_reference(
    x: torch.Tensor,  # (B, T, C); zero at and past each row's length
    blocks: Sequence[dict],
    *,
    slope: float,
    lengths: torch.Tensor | None = None,
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """Plain PyTorch: mean_j resblock_j(x), re-zeroing [len, T) after every
    conv, at ``tier``; the result in x's dtype. bf16 serving:
    :func:`resblocks_mean_bf16`."""
    if tier.bf16_compute:
        _check_bf16("resblock_trio_reference", x)
        return resblocks_mean_bf16(x, blocks, slope,
                                   length_mask(lengths, x.shape[1], torch.bfloat16))
    mask = length_mask(lengths, x.shape[1], torch.float32)
    return _trio_mean(x, blocks, slope, mask, tier).to(x.dtype)


def pair_weights(blocks: Sequence[dict]) -> list[torch.Tensor]:
    return [blk[name][i] for blk in blocks for i in range(len(blk["dilations"]))
            for name in ("w1", "b1", "w2", "b2")]


def pair_scales(blocks: Sequence[dict]) -> list[torch.Tensor]:
    """The int8 kernels' (C,) scales, every pair's s1 and s2 (none for fp32, bf16)."""
    return [blk[name][i] for blk in blocks if "s1" in blk
            for i in range(len(blk["dilations"])) for name in ("s1", "s2")]


# The (tier mode, weight format) pairs B's conv is built for (resblock_trio.cu::launch_conv):
# fp32 weights at every tier, int8 at the exact tier (fp32 values) and fast, bf16 at fast.
CONV_FORMATS = {(m, 0) for m in (EXACT, FAST, HIGH)} | {(EXACT, 2), (FAST, 2), (FAST, 1)}


def check_weights(name: str, blocks: Sequence[dict], tier: Tier) -> int:
    """The blocks' one weight format (ops/tiers.py::weight_format); raises on a
    mix, on int8 without scales, or on a format the tier's kernels do not take."""
    formats = {weight_format(w) for w in pair_weights(blocks)[0::2]}
    if len(formats) != 1:
        raise ValueError(f"{name}: resblock weights of several formats")
    fmt = formats.pop()
    if any(("s1" in blk) != (fmt == 2) for blk in blocks):
        raise ValueError(f"{name}: int8 weights need their s1/s2 scales, and only they")
    if (tier.mode, fmt) not in CONV_FORMATS:
        raise ValueError(f"{name}: the {tier.name} tier's kernels do not take weight format "
                         f"{fmt} (0 fp32, 1 bf16, 2 int8)")
    return fmt


def conv_reference(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   residual: torch.Tensor | None, lengths: torch.Tensor, k: int, dil: int,
                   slope: float, tier: Tier, prev: torch.Tensor | None = None,
                   scale: float = 1.0, round_: bool = False) -> torch.Tensor:
    """Plain PyTorch: one resblock conv as :func:`conv` launches it (fp32 x and
    result), at ``tier``: mask(conv(leaky(x)) + bias [+ residual]), rounded to the
    tier's carry with ``round_``, added to ``prev`` (accumulate), times ``scale``
    (the steps of :func:`_trio_mean`)."""
    y = tier_conv1d(leaky_relu(x, slope), w, bias, tier, None, padding=dil * (k - 1) // 2,
                    dilation=dil)
    mask = length_mask(lengths, x.shape[1], torch.float32)
    y = y * mask
    if residual is not None:
        y = (y + residual) * mask
    if round_:
        y = carry(y, tier)
    if prev is not None:
        y = prev + y
    return y * scale


def conv(x: torch.Tensor, out: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
         residual: torch.Tensor | None, wscale: torch.Tensor | None, lengths: torch.Tensor,
         k: int, dil: int, slope: float, accumulate: int, scale: float, round_: int,
         out16: torch.Tensor | None, tile: int, split: int, tier: Tier, wfmt: int, stream: int,
         what: str) -> None:
    """One resblock conv of fp32 x (B, T, C) into out: Hopper's route
    (``vk_conv_wgmma``, :func:`wgmma_plan`) at the fast tier on bf16 weights for
    the shapes on its grid, else ``vk_conv`` with conv_plan's tile and split."""
    B, T, C = x.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    plan = (wgmma_plan(B, T, C, C, k, dil, device_sm_count(x.device))
            if tier.mode == FAST and wfmt == 1 else None)
    lib = library()
    with on_device(x):
        if plan is not None:
            check(lib.vk_conv_wgmma(
                x.data_ptr(), out.data_ptr(), w.data_ptr(), bias.data_ptr(), ptr(residual),
                lengths.data_ptr(), B, T, C, C, k, dil, dil * (k - 1) // 2, slope, accumulate,
                scale, plan.bn, plan.nc, plan.stages, plan.split, round_, ptr(out16), stream),
                what)
            count_launch(conv, "wgmma_launches")
            return
        check(lib.vk_conv(
            x.data_ptr(), out.data_ptr(), w.data_ptr(), bias.data_ptr(), ptr(residual),
            lengths.data_ptr(), B, T, C, C, k, dil, dil * (k - 1) // 2, slope, accumulate, scale,
            tile, split, tier.mode, wfmt, ptr(wscale), round_, ptr(out16), stream), what)
    count_launch(conv, "mma_sync_launches")


# Launches of each route (the resblock wrappers count their calls): Hopper's and
# conv_gemm.cuh's mma.sync, one a conv; kernel C's pair route, one a pair (two convs)
conv.wgmma_launches = 0
conv.mma_sync_launches = 0
conv.pair_launches = 0


def pair_reference(src: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, lengths: torch.Tensor, k: int, dil: int, slope: float,
                   tier: Tier, prev: torch.Tensor | None = None,
                   scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch: one launch of kernel C's pair route (:func:`pair`), fp32 result:
    the two :func:`conv_reference` launches of :func:`run_pairs` chained -- y1 at the
    carry's slope, then conv2 with the residual, the bf16 carry, ``prev`` (the
    running sum) and ``scale``."""
    y1 = conv_reference(src.float(), w1, b1, None, lengths, k, dil, carry_slope(slope, tier),
                        tier)
    return conv_reference(y1, w2, b2, src.float(), lengths, k, 1, slope, tier, prev, scale,
                          round_=True)


def fused_pairs_reference(x: torch.Tensor, blocks: Sequence[dict], *, slope: float,
                          lengths: torch.Tensor, tier: Tier,
                          out16: bool = False) -> torch.Tensor:
    """Plain PyTorch: kernel C's resblocks on the pair route as :func:`run_fused_pairs`
    chains them, one :func:`pair_reference` a pair: the pairs' outputs between
    resblocks stored in bf16 buffers, the running mean fp32 (bf16 with ``out16``)."""
    n, total = len(blocks), None
    for j, blk in enumerate(blocks):
        src, k = x.to(torch.bfloat16), blk["kernel_size"]
        for i, d in enumerate(blk["dilations"]):
            last = i == len(blk["dilations"]) - 1
            y = pair_reference(src, blk["w1"][i], blk["b1"][i], blk["w2"][i], blk["b2"][i],
                               lengths, k, d, slope, tier,
                               prev=total if last and j > 0 else None,
                               scale=1.0 / n if last and j == n - 1 else 1.0)
            if last:
                total = y
            else:
                src = y.to(torch.bfloat16)
    return total.to(torch.bfloat16) if out16 else total


def pair(src: torch.Tensor, out32: torch.Tensor | None, out16: torch.Tensor | None,
         w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
         lengths: torch.Tensor, k: int, dil: int, slope: float, accumulate: int, scale: float,
         plan: PairPlan, tier: Tier, stream: int) -> None:
    """One resblock pair of bf16 src (B, T, 32) in one launch of kernel C's pair
    route (``vk_pair_wgmma``, :func:`pair_plan`): into out16 (bf16) where given,
    else out32 (fp32); with ``accumulate`` the running sum is read from out32."""
    B, T, C = src.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with on_device(src):
        check(library().vk_pair_wgmma(
            src.data_ptr(), ptr(out32), ptr(out16), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), lengths.data_ptr(), B, T, C, k, dil, carry_slope(slope, tier), slope,
            accumulate, scale, plan.nw, plan.blocks, stream), "resblock pair kernel")
    count_launch(conv, "pair_launches")


def run_fused_pairs(x: torch.Tensor, out: torch.Tensor, blocks: Sequence[dict],
                    lengths: torch.Tensor, slope: float, plans: Sequence[Sequence[PairPlan]],
                    tier: Tier, out16: torch.Tensor | None = None) -> None:
    """Kernel C's route of its resblocks at C = 32 (fast tier, bf16 packs, bf16
    values; ``stage.py::stage_routes`` decides): one :func:`pair` launch a pair,
    ``plans[j][i]`` its :func:`pair_plan`. ``x`` (B, T, 32) is bf16 (the
    upsampler's rounded output); the pairs' outputs between resblocks go through
    two bf16 scratch buffers (bf16-exact at this tier), the last pair of each
    resblock folds into ``out``'s fp32 running sum, and the last of all writes the
    mean into ``out16`` (bf16) where given, else ``out``. Its plain twin is
    :func:`fused_pairs_reference`."""
    if x.dtype != torch.bfloat16 or out.dtype != torch.float32:
        raise ValueError("resblock pair kernel takes bf16 activations and an fp32 mean")
    check_weights("resblock pair kernel", blocks, tier)
    stream = stream_of(x)
    scratch = (torch.empty_like(x), torch.empty_like(x))
    n = len(blocks)
    for j, blk in enumerate(blocks):
        k, src = blk["kernel_size"], x
        dilations = tuple(blk["dilations"])
        for i, d in enumerate(dilations):
            w1, b1, w2, b2 = blk["w1"][i], blk["b1"][i], blk["w2"][i], blk["b2"][i]
            for w in (w1, w2):
                if (w.shape != (k, PAIR_C, PAIR_C) or w.dtype != torch.bfloat16
                        or w.data_ptr() % 16):
                    raise ValueError(f"resblock pair kernel weight {tuple(w.shape)} {w.dtype} "
                                     f"!= ({k}, {PAIR_C}, {PAIR_C}) bf16, 16-byte aligned")
            for vec in (b1, b2):
                if vec.shape != (PAIR_C,) or vec.dtype != torch.float32 or vec.data_ptr() % 16:
                    raise ValueError(f"resblock pair kernel bias {tuple(vec.shape)} != "
                                     f"({PAIR_C},) fp32, 16-byte aligned")
            last, final = i == len(dilations) - 1, i == len(dilations) - 1 and j == n - 1
            dst16 = out16 if final else None if last else scratch[i % 2]
            pair(src, out if last else None, dst16, w1, b1, w2, b2, lengths, k, d, slope,
                 int(last and j > 0), 1.0 / n if final else 1.0, plans[j][i], tier, stream)
            src = dst16


def run_pairs(x: torch.Tensor, out: torch.Tensor, blocks: Sequence[dict],
              lengths: torch.Tensor, slope: float, acts: Sequence | None = None,
              tier: Tier = EXACT_TIER, out16: torch.Tensor | None = None) -> None:
    """Launch two conv kernels per pair of every block; ``out`` gets the mean.

    ``x`` (fp32) is left untouched; y1 and the pair outputs go through three
    scratch buffers. Shared by kernel B and the stage kernel (kernel C).
    With ``acts`` -- per block ``(y1s, xs)``, ``pairs`` and ``pairs - 1``
    (B, T, C) buffers -- each pair's y1 and each later pair's input land there
    instead, saved for the backward (kernel 5, ``ops/cuda/trio_grad.py``).
    At ``tier`` (bf16 values: each pair's output rounded to bf16); with
    ``out16`` (B, T, C) bf16 the mean is written there, ``out`` holding the
    running sum over the blocks. On bf16 ``x`` (kernel 5's forward at the bf16
    training tier, and bf16 serving's B and C; every buffer bf16) each launch is
    ``vk_conv_bf16``: XLA's bf16 graph of the pair, masked, both leakys at the
    bf16 slope, and the last launch divides the sum by the blocks' count; the
    biases fp32 or bf16 (read as they are), any channel count (the narrow path
    below 32).
    """
    lib = library()
    B, T, C = x.shape
    stream = stream_of(x)
    sms = device_sm_count(x.device)
    wfmt = check_weights("resblock conv kernel", blocks, tier)
    if x.data_ptr() % 16 or out.data_ptr() % 16 or (out16 is not None and out16.data_ptr() % 16):
        raise ValueError("resblock conv kernel needs 16-byte aligned activations")
    if acts is None:
        y1 = torch.empty_like(x)
        scratch = (torch.empty_like(x), torch.empty_like(x))
    x_slope = carry_slope(slope, tier)  # conv1's leaky of the carry; conv2's of y1 is fp32
    bf16 = x.dtype == torch.bfloat16
    n = len(blocks)
    with on_device(x):
        for j, blk in enumerate(blocks):
            k = blk["kernel_size"]
            if k % 2 == 0:
                raise ValueError(f"resblock conv kernel needs an odd kernel size, got {k}")
            src = x
            dilations = tuple(blk["dilations"])
            tile, split, _ = conv_plan(B, T, C, C, k, sms)
            for i, d in enumerate(dilations):
                w1, b1, w2, b2 = blk["w1"][i], blk["b1"][i], blk["w2"][i], blk["b2"][i]
                s1, s2 = _pair_scale(blk, "s1", i), _pair_scale(blk, "s2", i)
                for w in (w1, w2):
                    if w.shape != (k, C, C) or w.data_ptr() % 16:
                        raise ValueError(f"resblock conv weight {tuple(w.shape)} != ({k}, {C}, {C})"
                                         " or not 16-byte aligned")
                bias_dtypes = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
                for vec in (b1, b2) + ((s1, s2) if s1 is not None else ()):
                    if vec.shape != (C,) or vec.data_ptr() % 16 or vec.dtype not in bias_dtypes:
                        raise ValueError(f"resblock conv bias or scale {tuple(vec.shape)} != "
                                         f"({C},), of another dtype or not 16-byte aligned")
                last = i == len(dilations) - 1
                if acts is not None:
                    y1 = acts[j][0][i]
                    dst = out if last else acts[j][1][i]
                else:
                    dst = out if last else scratch[i % 2]
                accumulate = int(last and j > 0)
                if bf16:
                    check(lib.vk_conv_bf16(
                        src.data_ptr(), y1.data_ptr(), w1.data_ptr(), b1.data_ptr(), None,
                        lengths.data_ptr(), B, T, C, C, k, d, d * (k - 1) // 2, x_slope, 0, 1.0,
                        tile, split, int(b1.dtype == torch.bfloat16), stream),
                        "resblock conv1 kernel (bf16)")
                    check(lib.vk_conv_bf16(
                        y1.data_ptr(), dst.data_ptr(), w2.data_ptr(), b2.data_ptr(), src.data_ptr(),
                        lengths.data_ptr(), B, T, C, C, k, 1, (k - 1) // 2, x_slope, accumulate,
                        float(n) if last and j == n - 1 else 1.0, tile, split,
                        int(b2.dtype == torch.bfloat16), stream), "resblock conv2 kernel (bf16)")
                    src = dst
                    continue
                scale = 1.0 / n if last and j == n - 1 else 1.0
                final16 = out16 if last and j == n - 1 else None
                # y1 = mask(dilated conv(leaky(src)) (* s1) + b1)
                conv(src, y1, w1, b1, None, s1, lengths, k, d, x_slope, 0, 1.0, 0, None, tile,
                     split, tier, wfmt, stream, "resblock conv1 kernel")
                # dst = carry(mask(src + conv(leaky(y1)) (* s2) + b2)), folded into the mean on the
                # last pair
                conv(y1, dst, w2, b2, src, s2, lengths, k, 1, slope, accumulate, scale,
                     int(tier.bf16_values), final16, tile, split, tier, wfmt, stream,
                     "resblock conv2 kernel")
                src = dst


def fused_resblock_trio(
    x: torch.Tensor,  # (B, T, C)
    blocks: Sequence[dict],
    *,
    slope: float,
    lengths: torch.Tensor | None = None,  # (B,) valid steps; None = all T
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """mean_j resblock_j(x) with per-row length masking, at ``tier``.

    CPU tensors take :func:`resblock_trio_reference`; CUDA tensors launch the
    kernel (x in the tier's value dtype, weights fp32, bf16 or int8 with
    scales, fp32 biases; bf16 serving: bf16 x, weights and biases; contiguous,
    no autograd) or raise. The result has x's dtype.
    """
    weights = pair_weights(blocks) + pair_scales(blocks)
    if tier.bf16_compute:
        _check_bf16("fused_resblock_trio", x)
    if not on_cuda("fused_resblock_trio", x, *weights, dtype=None):
        return resblock_trio_reference(x, blocks, slope=slope, lengths=lengths, tier=tier)
    on_cuda("fused_resblock_trio", x, dtype=tier.value_dtype)
    no_autograd("fused_resblock_trio", x, *weights)
    B, T, _ = x.shape
    if tier.bf16_compute:  # XLA's bf16 graph, every buffer bf16
        out = torch.empty_like(x)
        run_pairs(x, out, blocks, cuda_lengths(lengths, B, T, x.device), slope, tier=tier)
        count_launch(fused_resblock_trio)
        return out
    xf = x.float()  # the kernel stages fp32 (bf16 values stay bf16-exact)
    out = torch.empty_like(xf)
    out16 = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    run_pairs(xf.contiguous(), out, blocks, cuda_lengths(lengths, B, T, x.device), slope,
              tier=tier, out16=out16)
    count_launch(fused_resblock_trio)
    return out if out16 is None else out16


fused_resblock_trio.launches = 0


def resblock_reference(
    x: torch.Tensor,  # (B, T, C); zero at and past each row's length
    block: dict,
    *,
    slope: float,
    lengths: torch.Tensor | None = None,
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """Plain PyTorch: one resblock, re-zeroing [len, T) after every conv, at
    ``tier`` (bf16 serving: :func:`resblocks_mean_bf16` of one block)."""
    return resblock_trio_reference(x, [block], slope=slope, lengths=lengths, tier=tier)


def total_halo(k: int, dilations: Sequence[int]) -> int:
    """Input steps a resblock's output step reads on each side: every conv's reach."""
    return sum(d * (k - 1) // 2 + (k - 1) // 2 for d in dilations)


def block_smem(bm: int, C: int, k: int, dilations: Sequence[int], cluster: int) -> int:
    """Shared memory of one block of kernel 7: the x and leaky(y1) windows of
    bm + 2H + BLOCK_MARGIN rows of C + 4 floats, and two buffers of one
    conv's (k, C, C / cluster) weight columns."""
    window = bm + 2 * total_halo(k, dilations) + BLOCK_MARGIN
    return 4 * (2 * window * (C + 4) + 2 * k * C * (C // cluster))


class BlockPlan(NamedTuple):
    bm: int  # output time steps of a block
    cluster: int  # blocks splitting the out-channels of every conv
    smem: int  # shared memory of a block, bytes
    blocks: int  # grid size, counting every block of a cluster


def block_ns(C: int, k: int, dilations: Sequence[int], bm: int, cluster: int) -> float:
    """Modelled ns of one block of kernel 7: its fixed cost and, per conv, the
    warp rounds its units take (a unit: one m16 tile of the conv's rows x up
    to four n8 tiles of the block's columns; BLOCK_WARPS warps), the barrier
    and the outputs it stores into its cluster peers."""
    nt = C // cluster // 8
    ntw = min(nt, 4)
    window = bm + 2 * total_halo(k, dilations)
    ns, edge = BLOCK_FIXED_NS, 0
    for d in dilations:
        for reach in (d * (k - 1) // 2, (k - 1) // 2):
            edge += reach
            rows = window - 2 * edge
            units = -(-rows // 16) * (nt // ntw)
            ns += -(-units // BLOCK_WARPS) * k * C * (BLOCK_TAP_NS + BLOCK_TILE_NS * ntw)
            if cluster > 1:
                ns += BLOCK_SYNC_NS + BLOCK_PUSH_NS * rows * C * (cluster - 1)
    return ns


def block_cost(B: int, T: int, C: int, k: int, dilations: Sequence[int], sm_count: int,
               bm: int, cluster: int) -> float:
    """Modelled ns of kernel 7 with tile bm and this cluster, in waves of the
    clusters that run at once (one block an SM). The plan cannot see the
    lengths, and a tile past its row's length costs nothing: it weighs a batch
    whose rows are all full and one whose first row alone is, equally."""
    at_once = sm_count // cluster
    if cluster >= 4:
        at_once = int(sm_count * BLOCK_CLUSTER_FILL / cluster)
    tiles = -(-T // bm)
    waves = -(-B * tiles // at_once) + -(-tiles // at_once)
    return waves * block_ns(C, k, dilations, bm, cluster) / 2


@functools.lru_cache(maxsize=1024)
def block_plan(B: int, T: int, C: int, k: int, dilations: tuple[int, ...],
               sm_count: int) -> BlockPlan:
    """Time tile and cluster of one kernel 7 launch: among the tiles of
    BLOCK_TILES and the clusters of BLOCK_CLUSTERS (C / cluster >= 8 columns
    a block) whose shared memory fits, the least :func:`block_cost`."""
    best = None
    for cluster in BLOCK_CLUSTERS:
        if C % cluster or C // cluster < 8:
            continue
        for bm in BLOCK_TILES:
            smem = block_smem(bm, C, k, dilations, cluster)
            if smem > MAX_SMEM_BYTES:
                break  # larger tiles only take more
            cost = block_cost(B, T, C, k, dilations, sm_count, bm, cluster)
            if best is None or cost < best[0]:
                best = (cost, BlockPlan(bm, cluster, smem, B * -(-T // bm) * cluster))
    if best is None:
        raise ValueError(f"resblock kernel: no tile fits C={C}, k={k}, dilations={dilations}")
    return best[1]


def resblock_tiled(
    x: torch.Tensor,  # (B, T, C)
    block: dict,
    *,
    slope: float,
    lengths: torch.Tensor | None = None,
    bm: int,
) -> torch.Tensor:
    """Plain PyTorch: one resblock the way kernel 7 computes it, tile by tile.

    Each tile of bm output steps reads one window of x, [t0 - H, t0 + bm + H)
    (zero outside [0, T)), and runs every pair on it: conv1 over the window
    shrunk by d*(k-1)/2 on each side, zero outside [0, len) in global
    coordinates, conv2 shrunk by (k-1)/2, the residual from the same steps of
    x, the mask again; the window's centre is the tile's output.
    """
    B, T, C = x.shape
    k, dilations = block["kernel_size"], block["dilations"]
    H = total_halo(k, dilations)
    lens = torch.full((B,), T) if lengths is None else lengths.to(torch.long).cpu()
    padded = torch.nn.functional.pad(x, (0, 0, H, H + bm))
    out = torch.zeros_like(x)
    for t0 in range(0, T, bm):
        h = padded[:, t0: t0 + bm + 2 * H]
        steps = torch.arange(t0 - H, t0 + bm + H, device=x.device)
        valid = ((steps[None, :] >= 0) & (steps[None, :] < lens[:, None].to(x.device)))
        valid = valid.to(x.dtype)[..., None]
        edge = 0
        for i, d in enumerate(dilations):
            reach = d * (k - 1) // 2
            y = conv1d(leaky_relu(h, slope), block["w1"][i], block["b1"][i], dilation=d)
            edge += reach
            y = y * valid[:, edge: valid.shape[1] - edge]
            y = conv1d(leaky_relu(y, slope), block["w2"][i], block["b2"][i])
            edge += (k - 1) // 2
            h = (h[:, reach + (k - 1) // 2: h.shape[1] - reach - (k - 1) // 2] + y)
            h = h * valid[:, edge: valid.shape[1] - edge]
        n = min(bm, T - t0)
        out[:, t0: t0 + n] = h[:, :n]
    return out


def fused_resblock(
    x: torch.Tensor,  # (B, T, C)
    block: dict,
    *,
    slope: float,
    lengths: torch.Tensor | None = None,  # (B,) valid steps; None = all T
    into: torch.Tensor | None = None,
    scale: float = 1.0,
    tier: Tier = EXACT_TIER,
    divisor: float = 1.0,
) -> torch.Tensor:
    """One masked resblock, ``{kernel_size, dilations, w1, b1, w2, b2}``, at ``tier``.

    CPU tensors take :func:`resblock_reference`; CUDA tensors (fp32 x and
    weights -- the JAX package runs this kernel on weights dequantized to
    fp32 and on the fp32 activations of its narrow stages, casting them to its
    value dtype inside; contiguous, no autograd) launch kernel 7 once at C in
    :data:`BLOCK_CHANNELS` (at most BLOCK_MAX_PAIRS pairs, a slope in [0, 1]),
    B's conv twice per pair at other C, or raise. With ``into`` (B, T, C), a tensor other
    than ``x``, the result is ``(into + resblock(x)) * scale`` written into
    ``into``: a stage's sum over its resblocks and the division by their
    number in the kernel's epilogue; else ``resblock(x) * scale``.

    bf16 serving (``tier.bf16_compute``): x, ``into``, the weights and biases
    bf16, the launch XLA's bf16 graph of the resblock; the mean's last step is
    ``divisor`` (``(into + resblock(x)) / divisor`` in bf16, as XLA divides)
    instead of ``scale``, which is then 1.
    """
    weights = pair_weights([block])
    extra = () if into is None else (into,)
    compute16 = tier.bf16_compute
    if compute16:
        _check_bf16("fused_resblock", x)
        if scale != 1.0:
            raise ValueError("fused_resblock: bf16 serving divides (divisor), scale must be 1")
    elif divisor != 1.0:
        raise ValueError("fused_resblock: a divisor is bf16 serving's (tier.bf16_compute)")
    if not on_cuda("fused_resblock", x, *weights, *extra, dtype=None):
        out = resblock_reference(x, block, slope=slope, lengths=lengths, tier=tier)
        if into is not None:
            out = into.add_(out)
        if divisor != 1.0:
            out = out.div_(divisor)
        return out if scale == 1.0 else out.mul_(scale)
    on_cuda("fused_resblock", x, *weights, *extra, dtype=x.dtype if compute16 else torch.float32)
    no_autograd("fused_resblock", x, *weights, *extra)
    B, T, C = x.shape
    k, dilations = block["kernel_size"], tuple(block["dilations"])
    if into is not None and (into.shape != x.shape or into.data_ptr() == x.data_ptr()):
        raise ValueError(f"fused_resblock: into {tuple(into.shape)} must be a (B, T, C) "
                         "tensor other than x")
    if C not in BLOCK_CHANNELS:  # C = 1, 2, 4: B's conv
        out = torch.empty_like(x)
        run_pairs(x if compute16 else carry(x, tier), out, [block],
                  cuda_lengths(lengths, B, T, x.device), slope, tier=tier)
        if into is not None:
            out = into.add_(out)
        if divisor != 1.0:
            out = out.div_(divisor)
        count_launch(fused_resblock)
        return out if scale == 1.0 else out.mul_(scale)
    if len(dilations) > BLOCK_MAX_PAIRS or k % 2 == 0 or not 0.0 <= slope <= 1.0:
        raise ValueError(f"resblock kernel takes an odd kernel size, at most "
                         f"{BLOCK_MAX_PAIRS} pairs and a leaky slope in [0, 1], got k={k}, "
                         f"dilations={dilations}, slope={slope}")
    for w in weights[0::2]:
        if w.shape != (k, C, C):
            raise ValueError(f"resblock kernel weight {tuple(w.shape)} != ({k}, {C}, {C})")
    for bias in weights[1::2]:
        if bias.shape != (C,):
            raise ValueError(f"resblock kernel bias {tuple(bias.shape)} != ({C},)")
    plan = block_plan(B, T, C, k, dilations, device_sm_count(x.device))
    out = torch.empty_like(x) if into is None else into
    lens = None if lengths is None else cuda_lengths(lengths, B, T, x.device)
    pointers = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    with on_device(x):
        check(library().vk_resblock_block(
            x.data_ptr(), out.data_ptr(), None if lens is None else lens.data_ptr(), pointers,
            (ctypes.c_int * len(dilations))(*dilations), len(dilations), B, T, C, k, slope,
            plan.bm, plan.cluster, int(into is not None), scale, tier.mode,
            int(tier.bf16_values and not compute16), float(divisor), int(compute16),
            stream_of(x)), "resblock kernel")
    count_launch(fused_resblock)
    return out


fused_resblock.launches = 0
