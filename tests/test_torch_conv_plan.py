"""The conv kernel's launch plan, and the exactness of kernel A's early stop.

``conv_plan`` (``vits_tpu_torch/ops/cuda/resblock.py``) is plain Python: it
picks the tile and the K split of every conv launch of kernels B, C and 5
(``csrc/conv_gemm.cuh``; kernel 7 takes it below 8 channels, and
``chip_smoke.py`` times the six-launch route it replaced beside kernel 7), and
``ops/cuda/flow.py::flow_plan`` those of
kernel 6's products. Pinned here at the shapes the main paths give them, on
an H100's 132 SMs. Kernel A (``csrc/rel_attention.cu``) stops its key
loop at a row's length; the argument that this is exact is held against the
plain version, ``rel_attention_reference``.
"""

import numpy as np
import pytest
import torch

from vits_tpu_torch.ops.cuda.attention import rel_attention_reference
from vits_tpu_torch.ops.cuda.resblock import CONV_CHUNK, CONV_TILES, conv_plan

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
