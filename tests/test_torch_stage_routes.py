"""Kernel C's Hopper routes at the fast tier on bf16 packs, held on the CPU.

``vits_tpu_torch/ops/cuda/stage.py::stage_routes`` sends kernel C's upsampler
to ``csrc/upsample_wgmma.cu`` (:func:`upsample_plan`) and its 32-channel
resblock pairs to ``csrc/pair_wgmma.cu``, one launch a pair
(``resblock.py::pair_plan``, ``run_fused_pairs``). The kernels run only on
the card; here: their plans fit an H100 at every shape MMS-TTS, VCTK and
small_config give them, their TMA maps keep TMA's limits, the route is fixed
by tier, format and shape, the kernels' tiling (windows, halos, the y1 rows
recomputed at tile edges, the length mask) computed in plain PyTorch equals
the launches' plain twins, and the twins chained as the routes chain them are
the stage's twin bit for bit and JAX's kernel within the fast tier's bound.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_conv_plan import FAST_BATCHES, H100_SMS, _hold_tma_limits
from vits_tpu.ops.pallas.stage import fused_stage as jax_fused_stage
from vits_tpu_torch.ops.conv import leaky_relu
from vits_tpu_torch.ops.cuda import resblock, stage
from vits_tpu_torch.ops.cuda.resblock import (
    MAX_SMEM_BYTES,
    PAIR_C,
    PAIR_MAX_WINDOW,
    SM_SMEM_BYTES,
    fused_pairs_reference,
    pair_plan,
    pair_reference,
    pair_smem,
    pair_tensor_maps,
    resblock_trio_reference,
)
from vits_tpu_torch.ops.cuda.stage import (
    FINAL_SLOPE,
    UPSAMPLE_MAX_WINDOW,
    UPSAMPLE_WGMMA_COLS,
    stage_reference,
    upsample_phases,
    upsample_plan,
    upsample_reach,
    upsample_reference,
    upsample_smem,
    upsample_tensor_maps,
)
from vits_tpu_torch.ops.tiers import (
    BF16_COMPUTE_TIER,
    EXACT,
    FAST,
    HIGH,
    Tier,
    carry,
    carry_slope,
    resolve_tier,
    round_bf16,
    tier_conv1d,
)

SLOPE = 0.1
FAST_TIER = resolve_tier(None, "bfloat16")  # the fast tier's bf16 values, as the engine runs it
BF16_BOUND = 0.03  # the fast tier's bound against the JAX kernel (test_torch_precision.py)


def _c_stages() -> list[tuple[int, int, int, int, int]]:
    """(C_in, C_out, k_up, stride, padding) of every stage kernel C runs in MMS-TTS,
    VCTK (MMS's vocoder), small_config (upsample_initial_channel 256) and
    HiFi-GAN V2 (128)."""
    from vits_tpu_torch.config import VitsConfig
    from vits_tpu_torch.models.hifigan import _stage_fusable

    stages = set()
    for config in (VitsConfig(), VitsConfig(num_speakers=109, speaker_embedding_size=256),
                   VitsConfig(upsample_initial_channel=256),
                   VitsConfig(upsample_initial_channel=128)):
        c_in = config.upsample_initial_channel
        for rate, k in zip(config.upsample_rates, config.upsample_kernel_sizes):
            c_out = c_in // 2
            if _stage_fusable(c_in, c_out, rate):
                stages.add((c_in, c_out, k, rate, (k - rate) // 2))
            c_in = c_out
    return sorted(stages)


def _pair_convs() -> list[tuple[int, int]]:
    """(k, dil) of every pair of kernel C's 32-channel resblocks (MMS, VCTK, small_config)."""
    from vits_tpu_torch.config import VitsConfig

    config = VitsConfig()
    return sorted({(k, d) for k, dils in zip(config.resblock_kernel_sizes,
                                             config.resblock_dilation_sizes) for d in dils})


C_STAGES = _c_stages()
PAIR_CONVS = _pair_convs()


def test_c_stages_cover_the_configs():
    """MMS's and VCTK's 128->64 and 64->32, small_config's 64->32 and 32->16,
    HiFi-GAN V2's 32->16 and 16->8, all ConvTranspose1d(4, stride 2, padding 1);
    the pairs at k 3, 7, 11 by dilations 1, 3, 5."""
    assert C_STAGES == [(16, 8, 4, 2, 1), (32, 16, 4, 2, 1), (64, 32, 4, 2, 1),
                        (128, 64, 4, 2, 1)]
    assert PAIR_CONVS == [(k, d) for k in (3, 7, 11) for d in (1, 3, 5)]


@pytest.mark.parametrize("B,frames", FAST_BATCHES)
@pytest.mark.parametrize("C_in,C_out,k,stride,pad", C_STAGES)
def test_upsample_plan_fits_the_card(C_in, C_out, k, stride, pad, B, frames):
    """Every C stage with C_out in UPSAMPLE_WGMMA_COLS gets a plan: shared memory
    within a block's 232,448 bytes, its blocks an SM (each with the card's 1 KB)
    within the SM's 228 KB, a window of one TMA box, a grid of every 64 * nw input
    rows. C_out = 8 (HiFi-GAN V2's 16->8) has none and keeps stage.cu's route."""
    T_in = {128: 64, 64: 128, 32: 256, 16: 512}[C_in] * frames
    plan = upsample_plan(B, T_in, C_in, C_out, k, stride, pad, H100_SMS)
    if C_out not in UPSAMPLE_WGMMA_COLS:
        assert plan is None
        return
    lo, hi = upsample_reach(k, stride, pad)
    assert plan.window == 64 * plan.nw + hi - lo <= UPSAMPLE_MAX_WINDOW
    assert plan.smem == upsample_smem(C_in, C_out, k, plan.window) <= MAX_SMEM_BYTES
    assert 1 <= plan.per_sm and plan.per_sm * (plan.smem + 1024) <= SM_SMEM_BYTES
    assert plan.blocks == -(-T_in // (64 * plan.nw)) * B


@pytest.mark.parametrize("B,frames", FAST_BATCHES)
@pytest.mark.parametrize("k,dil", PAIR_CONVS)
def test_pair_plan_fits_the_card(k, dil, B, frames):
    """Every 32-channel pair of kernel C gets a plan: its src window one TMA box,
    shared memory within a block's and the SM's, tiles of 64 * nw - (k - 1) output
    rows (the y1 halo recomputed), a persistent grid of at most the blocks the card
    holds at once and one a (batch row, tile) item; off C = 32 there is none."""
    T = 256 * frames
    plan = pair_plan(B, T, PAIR_C, k, dil, H100_SMS)
    assert plan.window == 64 * plan.nw + (k - 1) * dil <= PAIR_MAX_WINDOW
    assert plan.smem == pair_smem(k, dil, plan.nw) <= MAX_SMEM_BYTES
    assert 1 <= plan.per_sm and plan.per_sm * (plan.smem + 1024) <= SM_SMEM_BYTES
    assert plan.rows == 64 * plan.nw - (k - 1) > 0
    assert plan.blocks == min(-(-T // plan.rows) * B, H100_SMS * plan.per_sm)
    assert pair_plan(B, T, 64, k, dil, H100_SMS) is None
    assert pair_plan(B, T, 16, k, dil, H100_SMS) is None


@pytest.mark.parametrize("C_in,C_out,k,stride,pad", C_STAGES)
def test_upsample_tensor_maps_fit_tma(C_in, C_out, k, stride, pad):
    """Both maps of the upsampler keep TMA's limits, and each swizzled box's row
    is its swizzle's span: C_out * 2 bytes of weights, min(C_in, 64) * 2 of x."""
    if C_out not in UPSAMPLE_WGMMA_COLS:
        return
    for nw in (1, 2):
        maps = upsample_tensor_maps(4, 2560, C_in, C_out, k, stride, pad, nw)
        _hold_tma_limits(maps)
        assert maps["w"]["swizzle"] == 2 * C_out and maps["x"]["swizzle"] == 2 * min(C_in, 64)


@pytest.mark.parametrize("k,dil", PAIR_CONVS)
def test_pair_tensor_maps_fit_tma(k, dil):
    """The pair's three maps keep TMA's limits with the 64-byte swizzle (32 bf16 a
    row) at every block shape whose window is one box."""
    for nw in (1, 2):
        if 64 * nw + (k - 1) * dil > PAIR_MAX_WINDOW:
            continue
        maps = pair_tensor_maps(4, 2560, k, dil, nw)
        _hold_tma_limits(maps)
        assert {m["swizzle"] for m in maps.values()} == {64}


class _Lib:
    """Records which C entry each launch takes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


def _weights(rng, shape, fmt):
    w = torch.tensor(rng.standard_normal(shape) * 0.05, dtype=torch.float32)
    if fmt == "int8":
        return (w * 100).clamp(-127, 127).to(torch.int8)
    return w.to(getattr(torch, fmt))


def _stage_args(rng, C_in, C_out, fmt, T_in=40, B=2, bf16_biases=False):
    """A stage's input, upsampler and three resblocks of MMS's kernel sizes, in one
    weight format (int8 with its scales)."""
    bias = lambda n: torch.tensor(rng.standard_normal(n) * 0.05,  # noqa: E731
                                  dtype=torch.bfloat16 if bf16_biases else torch.float32)
    blocks = []
    for k in (3, 7, 11):
        blk = dict(kernel_size=k, dilations=(1, 3, 5),
                   w1=[_weights(rng, (k, C_out, C_out), fmt) for _ in range(3)],
                   w2=[_weights(rng, (k, C_out, C_out), fmt) for _ in range(3)],
                   b1=[bias(C_out) for _ in range(3)], b2=[bias(C_out) for _ in range(3)])
        if fmt == "int8":
            blk["s1"] = [torch.full((C_out,), 0.01) for _ in range(3)]
            blk["s2"] = [torch.full((C_out,), 0.01) for _ in range(3)]
        blocks.append(blk)
    x = torch.tensor(rng.standard_normal((B, T_in, C_in)), dtype=torch.float32)
    return x, _weights(rng, (4, C_in, C_out), fmt), bias(C_out), blocks


OLD_TRIO = ["vk_conv"] * 18
ROUTE_CASES = {
    # MMS's (VCTK's) last stage at the fast tier on bf16 packs: both new routes
    "fast bf16 64->32 +conv_post": (64, 32, "fast", "bfloat16", True,
                                    ["vk_upsample_wgmma"] + ["vk_pair_wgmma"] * 9 + ["vk_wave"]),
    # MMS's 128->64: the upsampler's route, the resblocks on conv_wgmma.cuh's
    "fast bf16 128->64 chained": (128, 64, "fast", "bfloat16", False,
                                  ["vk_upsample_wgmma"] + ["vk_conv_wgmma"] * 18),
    # small_config's 32->16: the upsampler's route, the narrow path below 32 channels
    "fast bf16 32->16": (32, 16, "fast", "bfloat16", False, ["vk_upsample_wgmma"] + OLD_TRIO),
    # HiFi-GAN V2's 16->8: C_out 8 is off the upsampler's grid
    "fast bf16 16->8": (16, 8, "fast", "bfloat16", False, ["vk_upsample"] + OLD_TRIO),
    "fast int8 64->32": (64, 32, "fast", "int8", True, ["vk_upsample"] + OLD_TRIO + ["vk_wave"]),
    "high fp32 64->32": (64, 32, "high", "float32", True,
                         ["vk_upsample"] + OLD_TRIO + ["vk_wave"]),
    "exact fp32 64->32": (64, 32, "highest", "float32", True,
                          ["vk_upsample"] + OLD_TRIO + ["vk_wave"]),
    # fast products on fp32 values (no bf16 carry): the pair outputs are not bf16-exact
    "fast fp32 values 64->32": (64, 32, "fast fp32", "bfloat16", True,
                                ["vk_upsample"] + OLD_TRIO + ["vk_wave"]),
    "bf16 serving 64->32": (64, 32, "bf16 serving", "bfloat16", True,
                            ["vk_upsample"] + ["vk_conv_bf16"] * 18 + ["vk_wave"]),
}
TIER_OF = {"fast": FAST_TIER, "high": Tier(HIGH), "highest": Tier(EXACT),
           "fast fp32": Tier(FAST, False), "bf16 serving": BF16_COMPUTE_TIER}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_stage_route_is_fixed_by_tier_format_and_shape(monkeypatch, case):
    """The stated rule (stage.py::stage_routes), with no switch: at the fast tier
    with bf16 values on bf16 packs the upsampler launches vk_upsample_wgmma (on
    the bf16 input as it is) where C_out is 16, 32 or 64, and at C = 32 the
    resblocks launch vk_pair_wgmma once a pair on a bf16 input; every other tier,
    format and shape keeps stage.cu's upsampler and run_pairs' two convs a pair.
    The new routes book their launches on their counters."""
    C_in, C_out, tier_name, fmt, final, want = ROUTE_CASES[case]
    tier = TIER_OF[tier_name]
    lib = _Lib()
    for module in (stage, resblock):
        monkeypatch.setattr(module, "library", lambda: lib)
        monkeypatch.setattr(module, "on_device", lambda t: contextlib.nullcontext())
        monkeypatch.setattr(module, "stream_of", lambda t: 0)
        monkeypatch.setattr(module, "device_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(stage, "on_cuda", lambda *a, **kw: True)
    rng = np.random.default_rng(1)
    x, up_w, up_b, blocks = _stage_args(rng, C_in, C_out, fmt,
                                        bf16_biases=tier.bf16_compute)
    x = x.to(tier.value_dtype)
    kw = {}
    if fmt == "int8":
        kw["up_scale"] = torch.full((C_out,), 0.01)
    post = None
    if final:
        post = (_weights(rng, (7, C_out, 1), fmt), 3) + ((torch.ones(()),) if fmt == "int8"
                                                          else ())
    counts = (stage.upsample.wgmma_launches, stage.upsample.mma_sync_launches,
              resblock.conv.pair_launches)
    stage.fused_stage(x, up_w, up_b, blocks, stride=2, up_padding=1, slope=SLOPE,
                      lengths=torch.tensor([40, 23], dtype=torch.int32), final_conv=post,
                      tier=tier, chain=not final, **kw)
    assert [name for name, _ in lib.calls] == want
    new = (stage.upsample.wgmma_launches - counts[0], stage.upsample.mma_sync_launches - counts[1],
           resblock.conv.pair_launches - counts[2])
    if not tier.bf16_compute:
        assert new == (want.count("vk_upsample_wgmma"), want.count("vk_upsample"),
                       want.count("vk_pair_wgmma"))
    if "vk_pair_wgmma" in want:  # every pair reads a bf16 input; the last writes the mean
        up = lib.calls[0][1]
        assert up[2] == 1  # the upsampler writes bf16 for the pairs
        pairs = [args for name, args in lib.calls if name == "vk_pair_wgmma"]
        assert pairs[0][0] == up[1]  # the first pair reads the upsampler's output
        last = [p for i, p in enumerate(pairs) if i % 3 == 2]
        assert [p[15] for p in last] == [0, 1, 1]  # accumulate from the second resblock on
        assert [p[16] for p in last] == [1.0, 1.0, 1.0 / 3]  # the mean's scale on the last
        assert all(p[2] is not None for i, p in enumerate(pairs) if i % 3 != 2)  # bf16 scratch
    elif "vk_upsample_wgmma" in want:  # the next launch stages fp32
        assert lib.calls[0][1][2] == 0


def pair_tiled(src, w1, b1, w2, b2, lengths, k, dil, slope, tier, nw, prev=None, scale=1.0):
    """Plain PyTorch: one pair the way csrc/pair_wgmma.cu computes it, tile by tile.

    A tile of nw warpgroups holds the src window of 64 * nw + (k - 1) * dil rows
    from t0 - h2 - h1 (zero outside [0, T)), computes y1 over the 64 * nw rows
    from t0 - h2 (zero outside [0, len)) and the output over the 64 * nw - (k - 1)
    rows from t0; the y1 rows past 64 * nw that conv2's last rows would read are
    NaN here (the kernel leaves them unwritten), so no stored row may read them."""
    B, T, C = src.shape
    R, h2 = 64 * nw, (k - 1) // 2
    h1, rows_out = dil * h2, R - (k - 1)
    w1r, w2r = round_bf16(w1.float()), round_bf16(w2.float())
    out = torch.empty(B, T, C)
    for b in range(B):
        n = int(lengths[b])
        for t0 in range(0, T, rows_out):
            rows = min(rows_out, T - t0)
            y = torch.zeros(rows, C)
            if t0 < n:
                pos = torch.arange(t0 - h2 - h1, t0 - h2 - h1 + R + 2 * h1)
                inside = ((pos >= 0) & (pos < T))[:, None]
                win = torch.where(inside, src[b, pos.clamp(0, T - 1)].float(), 0.0)
                res = win[h1 + h2: h1 + h2 + rows]
                a1 = round_bf16(leaky_relu(win, carry_slope(slope, tier)))
                y1 = sum(a1[tap * dil: tap * dil + R] @ w1r[tap] for tap in range(k)) + b1
                p1 = torch.arange(t0 - h2, t0 - h2 + R)
                y1 = torch.where(((p1 >= 0) & (p1 < n))[:, None], y1, 0.0)
                a2 = torch.cat([round_bf16(leaky_relu(y1, slope)),
                                torch.full((k - 1, C), float("nan"))])
                y2 = sum(a2[tap: tap + R] @ w2r[tap] for tap in range(k))[:rows]
                valid = (torch.arange(t0, t0 + rows) < n)[:, None]
                y = torch.where(valid, round_bf16(y2 + b2 + res), 0.0)
            if prev is not None:
                y = prev[b, t0: t0 + rows] + y
            out[b, t0: t0 + rows] = y * scale
    return out


def upsample_tiled(x, w, bias, lengths, stride, padding, slope, tier, nw):
    """Plain PyTorch: the upsampler the way csrc/upsample_wgmma.cu computes it, block
    by block: a window of 64 * nw + hi - lo rows from t0 + lo (zero outside
    [0, T_in)), leaky and bf16 on it once, then each phase's taps at their row
    shift i - o - lo, + bias, zero at and past the length, the bf16 carry."""
    B, T_in, _ = x.shape
    k, _, C_out = w.shape
    lo, hi = upsample_reach(k, stride, padding)
    M = 64 * nw
    wr = round_bf16(w.float())
    out = torch.zeros(B, T_in * stride, C_out)
    for b in range(B):
        n = int(lengths[b])
        for t0 in range(0, min(T_in, n), M):
            rows = min(M, T_in - t0)
            pos = torch.arange(t0 + lo, t0 + M + hi)
            inside = ((pos >= 0) & (pos < T_in))[:, None]
            win = torch.where(inside, x[b, pos.clamp(0, T_in - 1)].float(), 0.0)
            a = round_bf16(leaky_relu(carry(win, tier), carry_slope(slope, tier)))
            t = torch.arange(t0, t0 + rows)
            for phi, (j, taps, o) in enumerate(upsample_phases(k, stride, padding)):
                acc = sum(a[i - o - lo: i - o - lo + M] @ wr[j + stride * i]
                          for i in range(taps))[:rows]
                y = torch.where((t < n)[:, None], acc + bias, 0.0)
                out[b, stride * t + phi] = carry(y, tier)
    return out


def _close_in_bf16_ulps(got, want, ulps=2):
    """Within ``ulps`` bf16 steps of max(1, |want|): the same rounded operands, fp32
    sums in another order, and the output rounded to bf16 once."""
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= ulps * 2.0 ** -8 * scale


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("k,dil", [(3, 1), (7, 3), (11, 5)])
def test_pair_tiling_is_the_pair_twin(k, dil, nw):
    """The pair kernel's tiling (tile edges that cut y1's halo, a row of length 0,
    one ending mid-tile, T off the tile) gives pair_reference, the twin of one
    launch, with the running sum and the mean's scale."""
    rng = np.random.default_rng(7)
    B, T = 3, 161
    lens = torch.tensor([161, 0, 70], dtype=torch.int32)
    valid = (torch.arange(T)[None, :] < lens[:, None])[..., None]
    src = (torch.tensor(rng.standard_normal((B, T, PAIR_C)), dtype=torch.float32)
           * valid).to(torch.bfloat16)
    w1, w2 = (_weights(rng, (k, PAIR_C, PAIR_C), "bfloat16") for _ in range(2))
    b1, b2 = (torch.tensor(rng.standard_normal(PAIR_C) * 0.05, dtype=torch.float32)
              for _ in range(2))
    prev = torch.tensor(rng.standard_normal((B, T, PAIR_C)), dtype=torch.float32)
    for kw in ({}, {"prev": prev, "scale": 1.0 / 3}):
        want = pair_reference(src, w1, b1, w2, b2, lens, k, dil, SLOPE, FAST_TIER, **kw)
        got = pair_tiled(src, w1, b1, w2, b2, lens, k, dil, SLOPE, FAST_TIER, nw, **kw)
        assert bool(torch.isfinite(got).all())
        _close_in_bf16_ulps(got, want)
        if not kw:
            assert float(got[1].abs().max()) == 0.0 and float(got[2, 70:].abs().max()) == 0.0


@pytest.mark.parametrize("nw", [1, 2])
@pytest.mark.parametrize("C_in,C_out", [(128, 64), (64, 32), (32, 16)])
def test_upsample_tiling_is_the_upsample_twin(C_in, C_out, nw):
    """The upsampler kernel's blocks (both phases from one window, its reach at the
    edges, a row of length 0, T_in off the block) give upsample_reference."""
    rng = np.random.default_rng(8)
    B, T_in = 3, 150
    lens = torch.tensor([150, 0, 77], dtype=torch.int32)
    valid = (torch.arange(T_in)[None, :] < lens[:, None])[..., None]
    x = (torch.tensor(rng.standard_normal((B, T_in, C_in)), dtype=torch.float32)
         * valid).to(torch.bfloat16)
    w = _weights(rng, (4, C_in, C_out), "bfloat16")
    bias = torch.tensor(rng.standard_normal(C_out) * 0.05, dtype=torch.float32)
    want = upsample_reference(x, w, bias, stride=2, up_padding=1, slope=SLOPE, lengths=lens,
                              tier=FAST_TIER)
    got = upsample_tiled(x, w, bias, lens, 2, 1, SLOPE, FAST_TIER, nw)
    _close_in_bf16_ulps(got, want)
    assert float(got[1].abs().max()) == 0.0 and float(got[2, 154:].abs().max()) == 0.0


def _bf16_blocks(rng, C, ks=(3, 7, 11)):
    return [dict(kernel_size=k, dilations=(1, 3, 5),
                 w1=[_weights(rng, (k, C, C), "bfloat16") for _ in range(3)],
                 w2=[_weights(rng, (k, C, C), "bfloat16") for _ in range(3)],
                 b1=[torch.tensor(rng.standard_normal(C) * 0.05, dtype=torch.float32)
                     for _ in range(3)],
                 b2=[torch.tensor(rng.standard_normal(C) * 0.05, dtype=torch.float32)
                     for _ in range(3)]) for k in ks]


@pytest.mark.parametrize("out16", [False, True])
def test_pairs_twin_is_the_trio_twin_bit_for_bit(out16):
    """fused_pairs_reference (one pair a launch, the outputs between resblocks in
    bf16 buffers, as run_fused_pairs chains the pair kernel) is
    resblock_trio_reference at the fast tier, bit for bit: at this tier each pair's
    output is bf16-exact, so storing it in bf16 loses nothing."""
    rng = np.random.default_rng(5)
    B, T = 3, 100
    lens = torch.tensor([100, 0, 57], dtype=torch.int32)
    valid = (torch.arange(T)[None, :] < lens[:, None])[..., None]
    x = (torch.tensor(rng.standard_normal((B, T, PAIR_C)), dtype=torch.float32)
         * valid).to(torch.bfloat16)
    blocks = _bf16_blocks(rng, PAIR_C)
    got = fused_pairs_reference(x, blocks, slope=SLOPE, lengths=lens, tier=FAST_TIER,
                                out16=out16)
    want = resblock_trio_reference(x.float(), blocks, slope=SLOPE, lengths=lens,
                                   tier=FAST_TIER)
    assert torch.equal(got, want.to(torch.bfloat16) if out16 else want)


def _routes_twin(x, up_w, up_b, blocks, lens, w_post):
    """The plain twins chained as fused_stage chains kernel C's Hopper routes at the
    fast tier: the upsampler's launch into a bf16 buffer, the pairs, conv_post."""
    up = upsample_reference(x, up_w, up_b, stride=2, up_padding=1, slope=SLOPE, lengths=lens,
                            tier=FAST_TIER).to(torch.bfloat16)
    h = fused_pairs_reference(up, blocks, slope=SLOPE, lengths=lens * 2, tier=FAST_TIER,
                              out16=w_post is None)
    if w_post is None:
        return h
    wave = torch.tanh(tier_conv1d(leaky_relu(h, FINAL_SLOPE), w_post, None, FAST_TIER,
                                  padding=3))
    mask = (torch.arange(h.shape[1])[None, :] < (lens * 2)[:, None]).float()
    return (wave[..., 0] * mask)


def _ragged_stage(seed):
    rng = np.random.default_rng(seed)
    B, T_in = 3, 40  # T_in off the 64-row blocks; a row of length 0
    lens = torch.tensor([40, 0, 23], dtype=torch.int32)
    valid = (torch.arange(T_in)[None, :] < lens[:, None])[..., None]
    x = (torch.tensor(rng.standard_normal((B, T_in, 64)), dtype=torch.float32) * valid)
    up_w = _weights(rng, (4, 64, PAIR_C), "bfloat16")
    up_b = torch.tensor(rng.standard_normal(PAIR_C) * 0.1, dtype=torch.float32)
    blocks = _bf16_blocks(rng, PAIR_C)
    w_post = _weights(rng, (7, PAIR_C, 1), "bfloat16") * 6
    return x.to(torch.bfloat16), up_w, up_b, blocks, lens, w_post


@pytest.mark.parametrize("final", [False, True])
def test_routes_twin_is_the_stage_twin_bit_for_bit(final):
    """At 64->32 the routes' twins, chained, are stage_reference bit for bit: the
    same function, with or without conv_post."""
    x, up_w, up_b, blocks, lens, w_post = _ragged_stage(6)
    got = _routes_twin(x, up_w, up_b, blocks, lens, w_post if final else None)
    want = stage_reference(x, up_w, up_b, blocks, stride=2, up_padding=1, slope=SLOPE,
                           lengths=lens, tier=FAST_TIER, chain=not final,
                           final_conv=(w_post, 3) if final else None)
    assert torch.equal(got, want)


def test_routes_twin_matches_jax_kernel():
    """At 64->32 with conv_post, ragged rows (one of length 0) and T_in off the
    tile, the routes' twins chained are JAX's fused_stage at the fast tier (bf16
    values, interpret mode) within the fast bound."""
    x, up_w, up_b, blocks, lens, w_post = _ragged_stage(6)
    f32 = lambda t: jnp.asarray(t.float().numpy())  # noqa: E731
    want = jax_fused_stage(
        f32(x), f32(up_w), f32(up_b), stride=2, up_padding=1,
        resblocks=[{k: (f32(torch.stack(v)) if k in ("w1", "b1", "w2", "b2") else v)
                    for k, v in blk.items()} for blk in blocks],
        slope=SLOPE, tile_t=64, lengths=jnp.asarray(lens.numpy()), interpret=True,
        precision=None, value_dtype=jnp.bfloat16, final_conv=(f32(w_post), 3))
    got = _routes_twin(x, up_w, up_b, blocks, lens, w_post)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) / scale <= BF16_BOUND
    assert float(got[1].abs().max()) == 0.0
