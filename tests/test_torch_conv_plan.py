"""The conv kernel's launch plans, and the exactness of kernel A's early stop.

``conv_plan`` (``vits_tpu_torch/ops/cuda/resblock.py``) is plain Python: it
picks the tile and the K split of every conv launch of kernels B, C and 5
(``csrc/conv_gemm.cuh``; kernel 7 takes it below 8 channels, and
``chip_smoke.py`` times the six-launch route it replaced beside kernel 7), and
``ops/cuda/flow.py::flow_plan`` those of
kernel 6's products. ``wgmma_plan`` plans the Hopper route of B's and C's
resblock convs at the fast tier (``csrc/conv_wgmma.cuh``), and ``conv`` picks
the route. Pinned here at the shapes the main paths give them, on an H100's
132 SMs. Kernel A (``csrc/rel_attention.cu``) stops its key
loop at a row's length; the argument that this is exact is held against the
plain version, ``rel_attention_reference``.
"""

import contextlib

import numpy as np
import pytest
import torch

from vits_tpu_torch.ops.cuda.attention import rel_attention_reference
from vits_tpu_torch.ops.cuda.resblock import (
    CONV_CHUNK,
    CONV_TILES,
    SM_SMEM_BYTES,
    WGMMA_CHUNK,
    WGMMA_SHAPES,
    conv_plan,
    wgmma_plan,
    wgmma_smem,
    wgmma_tensor_maps,
)

H100_SMS = 132

# (B, T, C): kernel B's MMS stages 0-1 for 320 frames; kernel C's resblocks
# (stages 2-3); kernel 5 at a 32-frame segment, batch 4; the six-launch route
# at HiFi-GAN V2's stages 0-1, batch 2 (kernel 7's shapes).
MAIN_PATH_SHAPES = {
    "B serving C=256": (1, 2560, 256),
    "B serving C=128": (1, 20480, 128),
    "C resblocks C=64": (1, 40960, 64),
    "C resblocks C=32": (1, 81920, 32),
    "5 forward C=256": (4, 256, 256),
    "7 C=64": (2, 2560, 64),
    "7 C=32": (2, 20480, 32),
}


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("name", sorted(MAIN_PATH_SHAPES))
def test_plan_fills_two_blocks_per_sm(name, k):
    B, T, C = MAIN_PATH_SHAPES[name]
    plan = conv_plan(B, T, C, C, k, H100_SMS)
    bm, bn = CONV_TILES[plan.tile]
    assert plan.blocks == -(-T // bm) * (C // bn) * B * plan.split
    assert plan.blocks >= 2 * H100_SMS


@pytest.mark.parametrize("B,T,C", [(1, 2560, 256), (4, 256, 256), (2, 2560, 64), (2, 160, 256),
                                   (3, 17, 128), (1, 5, 32)])
@pytest.mark.parametrize("k", [1, 3, 7, 11])
def test_plan_split_divides_the_steps(B, T, C, k):
    plan = conv_plan(B, T, C, C, k, H100_SMS)
    assert plan.tile >= 0 and C % CONV_TILES[plan.tile][1] == 0
    assert (k * C // CONV_CHUNK) % plan.split == 0
    assert CONV_TILES[plan.tile][0] % plan.split == 0


@pytest.mark.parametrize("C_in,C_out", [(16, 16), (8, 8), (32, 16), (16, 8), (24, 32), (1, 32)])
def test_plan_routes_narrow_channels_to_the_direct_path(C_in, C_out):
    plan = conv_plan(2, 300, C_in, C_out, 3, H100_SMS)
    assert plan.tile == -1 and plan.split == 1


@pytest.mark.parametrize("length", [64, 37, 1, 0])
def test_keys_past_length_weigh_exactly_zero(length):
    """The softmax weights of the plain version, read out exactly through
    one-hot values: a key at or past a row's length gets weight exactly 0, so
    a key loop that stops at ceil(len / 16) * 16 keys is exact; a length-0 row
    gets exactly uniform weights over all L keys."""
    rng = np.random.default_rng(length)
    L, w = 64, 4
    q, k = (torch.tensor(rng.standard_normal((1, 1, L, L)) * 2.0, dtype=torch.float32)
            for _ in range(2))
    v = torch.eye(L, dtype=torch.float32)[None, None]  # out[i, j] = weight of key j
    rel_k = torch.tensor(rng.standard_normal((2 * w + 1, L)), dtype=torch.float32)
    rel_v = torch.zeros((2 * w + 1, L), dtype=torch.float32)
    weights = rel_attention_reference(q, k, v, rel_k, rel_v, window=w,
                                      lengths=torch.tensor([length]))[0, 0]
    assert bool(torch.isfinite(weights).all())
    if length:
        assert torch.count_nonzero(weights[:, length:]) == 0
        assert float(weights[:, :length].min()) >= 0.0
        torch.testing.assert_close(weights.sum(-1), torch.ones(L), rtol=0, atol=1e-5)
    else:
        assert bool((weights == weights[0, 0]).all())
        assert float(weights[0, 0]) == pytest.approx(1.0 / L, rel=1e-6)


# Kernel 6 at chip_smoke.py's shapes (VCTK width: half 96, hidden 192, k=5), and
# a narrow model's (half 16, hidden 64).
FLOW_SHAPES = [(1, 320, 96, 192), (3, 320, 96, 192), (8, 640, 96, 192), (16, 1280, 96, 192),
               (3, 160, 16, 64)]


@pytest.mark.parametrize("B,T,half,hidden", FLOW_SHAPES)
def test_flow_plan_gives_every_block_steps(B, T, half, hidden):
    """flow_plan's (tile, split) per product: a known tile, a split of at most 8 that
    divides the tile's rows, and no block of a cluster left without K steps."""
    from vits_tpu_torch.ops.cuda.flow import flow_plan

    plan = list(flow_plan(B, T, half, hidden, 5, H100_SMS))
    for (tile, split), (c_in, taps) in zip(zip(plan[0::2], plan[1::2]),
                                           ((half, 1), (hidden, 5), (hidden, 1), (hidden, 1))):
        assert 0 <= tile < len(CONV_TILES) and split in (1, 2, 4, 8)
        assert CONV_TILES[tile][0] % split == 0
        steps = taps * -(-c_in // CONV_CHUNK)
        assert (split - 1) * -(-steps // split) < steps


def test_flow_plan_splits_short_sequences_and_not_long_ones():
    """The gate's 30 K steps go to 8-block clusters for one 320-frame row (4 steps a
    block) and stay whole at B=16, T=1280, where the 128 x 64 tiles fill the card;
    res/skip runs unsplit at B=16 (the fits of scripts/torch_flow_trio_probe.py)."""
    from vits_tpu_torch.ops.cuda.flow import flow_plan

    short, long = (list(flow_plan(B, T, 96, 192, 5, H100_SMS)) for B, T in ((1, 320), (16, 1280)))
    assert short[2:4] == [1, 8] and long[2:4] == [0, 1]
    assert long[4:6] == [1, 1]


@pytest.mark.parametrize("steps", [3, 6, 30, 33])
def test_uneven_split_leaves_no_block_idle(steps):
    """conv_plan(uneven=True) may split K steps unevenly (ceil(steps / split) a
    block), never so that a block of the cluster gets none."""
    plan = conv_plan(1, 320, CONV_CHUNK * steps, 384, 1, H100_SMS, uneven=True)
    assert (plan.split - 1) * -(-steps // plan.split) < steps


# Hopper's route of the resblock conv (csrc/conv_wgmma.cuh, wgmma_plan): every
# conv kernels B and C launch at the fast tier in the three configurations the
# port runs: MMS-TTS (VitsConfig()), VCTK (its vocoder is MMS's) and
# scripts/torch_train_convergence.py's small_config.
def _fast_tier_convs() -> list[tuple[str, int, int, int]]:
    """(kernel, C, k, dil) of every resblock conv of B (stages with C_out % 128
    == 0) and C's resblocks (the stages ``_stage_fusable`` sends to kernel C):
    conv1 at each dilation, conv2 at 1."""
    from vits_tpu_torch.config import VitsConfig
    from vits_tpu_torch.models.hifigan import _stage_fusable

    small = dict(upsample_initial_channel=256)  # small_config's vocoder
    convs = set()
    for config in (VitsConfig(), VitsConfig(num_speakers=109, speaker_embedding_size=256),
                   VitsConfig(**small)):
        c_in = config.upsample_initial_channel
        for rate in config.upsample_rates:
            c_out = c_in // 2
            kernel = ("B" if c_out % 128 == 0 else
                      "C" if _stage_fusable(c_in, c_out, rate) else None)
            if kernel:
                for k, dils in zip(config.resblock_kernel_sizes, config.resblock_dilation_sizes):
                    convs |= {(kernel, c_out, k, d) for d in (*dils, 1)}
            c_in = c_out
    return sorted(convs)


FAST_CONVS = _fast_tier_convs()
# (B, frames): a 23-token request's frames, the 128-token request of chip_smoke.py's
# phase 3, a batch of 4, and a long utterance; B's first stage runs at 8 x frames,
# its second at 64 x, C's at 128 x and 256 x
FAST_BATCHES = [(1, 23), (1, 320), (4, 320), (1, 2048)]


def test_fast_tier_convs_cover_b_and_c():
    """B at C = 256 and 128, C's resblocks at 64 (MMS, VCTK), 32 and 16
    (small_config), three kernel sizes, dilations 1, 3, 5."""
    assert {(kern, C) for kern, C, _, _ in FAST_CONVS} == {("B", 256), ("B", 128), ("C", 64),
                                                          ("C", 32), ("C", 16)}
    assert {(k, d) for _, _, k, d in FAST_CONVS} == {(k, d) for k in (3, 7, 11) for d in (1, 3, 5)}


@pytest.mark.parametrize("B,frames", FAST_BATCHES)
@pytest.mark.parametrize("kernel,C,k,dil", FAST_CONVS)
def test_wgmma_plan_fits_the_card(kernel, C, k, dil, B, frames):
    """Every fast-tier conv on the 64-channel grid gets a plan: shared memory within a
    block's 232,448 bytes, and its blocks an SM (each with the card's 1 KB) within the
    SM's 228 KB and the registers' count; an N that wgmma takes (a multiple of 8, at
    most 256) dividing C_out; a block shape that is built; a ring of 2-8 stages;
    and a split (1, 2, 4, 8) of the block's rows that leaves no block of a cluster
    without K steps. Off the grid (C = 32, 16) there is no plan."""
    T = {256: 8, 128: 64, 64: 128, 32: 256, 16: 512}[C] * frames
    plan = wgmma_plan(B, T, C, C, k, dil, H100_SMS)
    if C % WGMMA_CHUNK:
        assert plan is None
        return
    assert plan.smem == wgmma_smem(plan.bn, plan.stages, (k - 1) * dil, plan.nc) <= 232448
    assert 1 <= plan.per_sm <= WGMMA_SHAPES[plan.bn, plan.nc]
    assert plan.per_sm * (plan.smem + 1024) <= SM_SMEM_BYTES
    assert plan.bn % 8 == 0 and plan.bn <= 256 and C % plan.bn == 0
    assert 2 <= plan.stages <= 8 and plan.split in (1, 2, 4, 8)
    steps = k * C // WGMMA_CHUNK
    assert (plan.split - 1) * -(-steps // plan.split) < steps
    rows = 64 * plan.nc
    assert rows % plan.split == 0
    assert plan.blocks == -(-T // rows) * (C // plan.bn) * B * plan.split


@pytest.mark.parametrize("kernel,C,k,dil", FAST_CONVS)
def test_wgmma_tensor_maps_fit_tma(kernel, C, k, dil):
    """TMA's limits on both maps: each box dimension at most 256, the strides
    multiples of 16 bytes, the swizzled weight box's rows 128 bytes (the 128-byte
    swizzle's span), the raw window's rows whole 16-byte units."""
    if C % WGMMA_CHUNK:
        return
    for nc in (1, 2):
        maps = wgmma_tensor_maps(4, 2560, C, C, k, dil, nc)
        _hold_tma_limits(maps)
        assert maps["w"]["box"][0] * maps["w"]["elem_bytes"] == maps["w"]["swizzle"] == 128


def _hold_tma_limits(maps):
    for name, m in maps.items():
        assert all(1 <= b <= 256 for b in m["box"]), (name, m["box"])
        assert all(s % 16 == 0 for s in m["strides"]), (name, m["strides"])
        assert m["box"][0] * m["elem_bytes"] % 16 == 0
        assert all(b <= d for b, d in zip(m["box"][:1], m["dims"]))
        if "swizzle" in m:  # a swizzled box's row is its swizzle's span
            assert m["box"][0] * m["elem_bytes"] == m["swizzle"] in (32, 64, 128), (name, m)


class _Lib:
    """Records which C entry a conv launch takes."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("C,k,dil,mode,wfmt,route", [
    (256, 11, 5, 1, 1, "vk_conv_wgmma"),  # B at fast on bf16 packs
    (128, 3, 1, 1, 1, "vk_conv_wgmma"),
    (64, 7, 3, 1, 1, "vk_conv_wgmma"),  # C's resblocks (MMS)
    (32, 3, 5, 1, 1, "vk_conv"),  # off the 64 grid: C's resblocks (small_config)
    (16, 3, 1, 1, 1, "vk_conv"),  # the narrow path
    (64, 17, 9, 1, 1, "vk_conv"),  # a window past one TMA box: (k - 1) * dil > 128
    (256, 11, 5, 1, 2, "vk_conv"),  # int8 packs at fast
    (256, 11, 5, 2, 0, "vk_conv"),  # high
    (256, 11, 5, 0, 0, "vk_conv"),  # exact
])
def test_conv_route_is_fixed_by_tier_format_and_shape(monkeypatch, C, k, dil, mode, wfmt,
                                                      route):
    """The stated rule, with no runtime switch: the fast tier with bf16 weights on
    the 64-channel grid (and a window of one TMA box) launches vk_conv_wgmma at
    wgmma_plan's bn, stages and split; everything else vk_conv."""
    from vits_tpu_torch.ops.cuda import resblock
    from vits_tpu_torch.ops.tiers import Tier

    lib = _Lib()
    monkeypatch.setattr(resblock, "device_sm_count", lambda device: H100_SMS)
    monkeypatch.setattr(resblock, "library", lambda: lib)
    monkeypatch.setattr(resblock, "on_device", lambda t: contextlib.nullcontext())
    B, T = 1, 640
    x, out = torch.zeros(B, T, C), torch.zeros(B, T, C)
    w, bias = torch.zeros(k, C, C), torch.zeros(C)
    lengths = torch.full((B,), T, dtype=torch.int32)
    resblock.conv(x, out, w, bias, None, None, lengths, k, dil, 0.1, 0, 1.0, 0, None, 0, 1,
                  Tier(mode, mode == 1), wfmt, 0, "conv")
    assert [name for name, _ in lib.calls] == [route]
    if route == "vk_conv_wgmma":
        plan = wgmma_plan(B, T, C, C, k, dil, H100_SMS)
        assert lib.calls[0][1][16:20] == (plan.bn, plan.nc, plan.stages, plan.split)


@pytest.mark.parametrize("fmt", ["bfloat16", "float32"])
def test_conv_reference_chained_as_run_pairs_is_the_trio_twin(fmt):
    """conv_reference, the plain twin of one launch of either route, chained as
    run_pairs launches it (conv1 at the carry's slope; conv2 with the residual,
    the bf16 carry, the running sum of the later blocks and the mean's scale)
    gives resblock_trio_reference at the fast tier, which tests/test_torch_kernels.py
    holds against the JAX kernel."""
    from vits_tpu_torch.ops.cuda.resblock import conv_reference, resblock_trio_reference
    from vits_tpu_torch.ops.tiers import carry, carry_slope, resolve_tier

    tier = resolve_tier(None, "bfloat16")
    rng = np.random.default_rng(3)
    B, T, C, slope = 2, 40, 16, 0.1
    lens = torch.tensor([40, 23], dtype=torch.int32)
    x = torch.tensor(rng.standard_normal((B, T, C)), dtype=torch.float32)
    x = carry(x * (torch.arange(T)[None, :, None] < lens[:, None, None]), tier)
    dtype = getattr(torch, fmt)
    blocks = [dict(kernel_size=k, dilations=(1, 3, 5),
                   **{n: [torch.tensor(rng.standard_normal((k, C, C)) * 0.1,
                                       dtype=torch.float32).to(dtype) for _ in range(3)]
                      for n in ("w1", "w2")},
                   **{n: [torch.tensor(rng.standard_normal(C) * 0.1, dtype=torch.float32)
                          for _ in range(3)] for n in ("b1", "b2")})
              for k in (3, 5)]
    out = None
    for j, blk in enumerate(blocks):
        src, k = x, blk["kernel_size"]
        for i, d in enumerate(blk["dilations"]):
            last = i == len(blk["dilations"]) - 1
            y1 = conv_reference(src, blk["w1"][i], blk["b1"][i], None, lens, k, d,
                                carry_slope(slope, tier), tier)
            src = conv_reference(y1, blk["w2"][i], blk["b2"][i], src, lens, k, 1, slope, tier,
                                 prev=out if last and j > 0 else None,
                                 scale=1 / len(blocks) if last and j == len(blocks) - 1 else 1.0,
                                 round_=True)
        out = src
    want = resblock_trio_reference(x, blocks, slope=slope, lengths=lens, tier=tier)
    torch.testing.assert_close(out, want, rtol=0, atol=1e-6)
