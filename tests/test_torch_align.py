"""The port's Monotonic Alignment Search against the JAX package's, on the CPU.

Identical seeded numpy inputs go through ``vits_tpu.ops.align.monotonic_align``
(two ``lax.scan``s) and the port's ``monotonic_align`` on CPU tensors (its
plain twin, the loop that the CUDA kernel ``csrc/align.cu`` is held equal to on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``). The two do the
same fp32 add and compare per cell, so the alignments must be equal. The
kernel's launch plan (``mas_plan``: tokens a lane, warps, ring, cluster, where
the choices live) is pure Python and is pinned here with its byte counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.ops import align as jax_align
from vits_tpu_torch.ops import align
from vits_tpu_torch.ops.cuda import align as cuda_align


# jitted: one compile a shape (eagerly each op around the scans compiles on its own)
_jax_align = jax.jit(jax_align.monotonic_align)

# ops/cuda/align.py's MAS_CASES up to the training shape (the rest are the card's)
_CPU_CASES = list(cuda_align.MAS_CASES)[:list(cuda_align.MAS_CASES).index("training") + 1]


@pytest.mark.parametrize("case", sorted(_CPU_CASES))
def test_alignment_equals_jax(case):
    ll, fmask, tmask = cuda_align.mas_case(case)
    want = np.asarray(_jax_align(jnp.asarray(ll), jnp.asarray(fmask), jnp.asarray(tmask)))
    got = align.monotonic_align(torch.tensor(ll), torch.tensor(fmask), torch.tensor(tmask))
    assert got.dtype == torch.float32 and got.shape == ll.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # each valid frame on exactly one valid token
    np.testing.assert_array_equal(got.sum(dim=2).numpy(), fmask * (tmask.sum(1) > 0)[:, None])


def test_the_step_goes_through_the_wrapper():
    from vits_tpu_torch.train import step

    assert align.monotonic_align is cuda_align.monotonic_align
    assert step.monotonic_align is cuda_align.monotonic_align


def test_wrapper_never_takes_the_loop_off_the_cpu():
    """A tensor on another device than the CPU launches the kernel or raises;
    here (no card) a device that is neither raises, and nothing is counted."""
    before = cuda_align.monotonic_align.launches
    ll = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_align.monotonic_align(ll, torch.ones((1, 4), device="meta"),
                                   torch.ones((1, 3), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        cuda_align.monotonic_align(torch.zeros((1, 4, 3)), torch.ones((1, 4), device="meta"),
                                   torch.ones((1, 3)))
    assert cuda_align.monotonic_align.launches == before


# (B, S, T) -> K tokens a lane, chain warps, strips, frames a chunk, chunks, cluster
# blocks, where the choices live, shared memory a block
PLANS = {
    # the training shape: K = 4 on 4 warps (512 tokens); chunks of 16 frames as they
    # lie in memory (16 x 512 + 4 floats a slot), 4 slots: 131,136 ring bytes after
    # 4,480 (mbarriers, lengths, 4 x 128 exchange slots), then 1279 choice rows of
    # 16 words: 135,616 + 81,856
    (2, 1280, 512): (4, 4, 1, 16, 4, 4, "shared", 217472),
    (16, 1280, 512): (4, 4, 1, 16, 4, 4, "shared", 217472),
    # 64 rows of clusters of 4 would pass the 132 SMs: a writer block a row
    (64, 1280, 512): (4, 4, 1, 16, 4, 2, "shared", 217472),
    # 2999 rows of 22 words (263,912 bytes): block 0 holds 1328, block 1 the rest;
    # 8.4 MB of output: 7 writer blocks
    (2, 3000, 700): (4, 6, 1, 8, 5, 8, "cluster", 232448),
    (1, 1, 1): (4, 1, 1, 32, 2, 2, "shared", 1696),  # one frame: no choice rows
    (2, 23, 7): (4, 1, 1, 32, 2, 2, "shared", 3320),
    # K = 4: a warp each 128 tokens, the last token of a warp count and the next
    (1, 30, 128): (4, 1, 1, 32, 2, 2, "shared", 34672),
    (1, 30, 129): (4, 2, 1, 32, 2, 2, "shared", 36068),
    (1, 30, 256): (4, 2, 1, 32, 2, 2, "shared", 68928),
    (1, 30, 257): (4, 3, 1, 24, 3, 2, "shared", 78564),
    (1, 30, 512): (4, 4, 1, 16, 4, 2, "shared", 137472),
    (1, 30, 513): (4, 5, 1, 8, 7, 2, "shared", 119940),
    # K = 4's widest (8 warps), then K = 16, a warp each 512 tokens
    (1, 30, 1024): (4, 8, 1, 8, 4, 2, "shared", 139328),
    (1, 30, 1025): (16, 3, 1, 6, 5, 2, "shared", 128100),
    (1, 30, 2048): (16, 4, 1, 4, 4, 2, "shared", 139968),
    (1, 30, 2049): (16, 5, 1, 2, 7, 2, "shared", 123476),
    # the widest strip (16 x 24 warps): a ring of 2 slots of 2 rows of 12,288 floats;
    # 22 choice rows of 384 words beside it, then 150 a block of the cluster ...
    (1, 23, 12288): (16, 24, 1, 2, 2, 3, "shared", 232352),
    (1, 24, 12288): (16, 24, 1, 2, 2, 3, "cluster", 232448),
    (1, 1073, 12288): (16, 24, 1, 2, 2, 8, "cluster", 232448),
    # ... and past 22 + 7 x 150 rows, device scratch
    (1, 1074, 12288): (16, 24, 1, 2, 2, 8, "scratch", 198560),
    (1, 60, 13000): (16, 24, 2, 2, 2, 4, "cluster", 232448),  # two strips
    (1, 2000, 20000): (16, 24, 2, 2, 2, 8, "scratch", 198624),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: f"B{s[0]}-S{s[1]}-T{s[2]}")
def test_launch_plan(shape):
    """The plan, and the bounds that vk_monotonic_align checks it against before
    it launches (align.cu takes the layout as given)."""
    B, S, T = shape
    plan = cuda_align.mas_plan(S, T, B)
    assert (plan.K, plan.warps, plan.strips, plan.frames, plan.chunks, plan.cluster,
            plan.choices, plan.smem_bytes) == PLANS[shape]
    G, W, rows = 32 // plan.K, -(-T // 32), S - 1
    assert plan.choice_bytes == 4 * rows * W
    assert plan.strips == -(-T // (32 * plan.K * plan.warps))
    assert plan.frames % G == 0 and plan.frames <= 32 and 2 <= plan.chunks <= 8
    assert plan.slots > plan.chunks * plan.frames and plan.slots & (plan.slots - 1) == 0
    # one strip: a chunk's rows as they lie in memory; strips: a row a frame, from
    # a ragged start (up to 3 floats) with the strip's 32 K warps tokens after it
    assert plan.row_floats == (T if plan.strips == 1 else 32 * plan.K * plan.warps + 4)
    assert plan.slot_floats % 4 == 0 and plan.slot_floats >= plan.frames * plan.row_floats + 4
    # block 0: mbarriers and lengths, the exchange, the ring (128-byte aligned), choices
    assert plan.xs_off % 16 == 0 and plan.xs_off >= 16 * plan.chunks + 4 * 64 + 4 * 2
    assert plan.ring_off % 128 == 0 and plan.ring_off >= plan.xs_off + 8 * plan.warps * plan.slots
    assert plan.base_off >= plan.ring_off + 4 * plan.chunks * plan.slot_floats
    assert plan.base_off <= plan.smem_bytes <= 232448
    assert 2 <= plan.cluster <= 8 and plan.warps <= (24 if plan.K == 16 else 8)
    assert plan.strips == 1 or plan.K == 16
    if plan.choices == "shared":
        assert plan.smem_bytes == plan.base_off + 4 * rows * W and plan.rows0 == rows
    elif plan.choices == "cluster":  # whole groups of G rows a block, every row held
        assert plan.rows0 % G == 0 and plan.rows1 % G == 0 and plan.rows1 >= G
        assert plan.base_off + 4 * W * plan.rows0 <= 232448 and 4 * W * plan.rows1 <= 232448
        assert plan.rows0 + (plan.cluster - 1) * plan.rows1 >= rows
    else:
        assert plan.smem_bytes == plan.base_off and plan.rows0 == plan.rows1 == 0
        assert (232448 - plan.base_off) // (4 * W) // G * G + 7 * (232448 // (4 * W) // G * G) \
            < rows


def test_plan_refuses_an_empty_alignment():
    with pytest.raises(ValueError, match="S=0"):
        cuda_align.mas_plan(0, 5)


def test_plan_refuses_what_the_kernel_does_not_take():
    """K is 4 or 16, only K = 16 runs its tokens in strips, and a block keeps its
    warps."""
    with pytest.raises(ValueError, match="only K=16"):
        cuda_align.mas_plan(30, 1024, K=4, warps=4)
    with pytest.raises(ValueError, match="9 warps at K=4"):
        cuda_align.mas_plan(30, 1024, K=4, warps=9)
    with pytest.raises(ValueError, match="K=8 is not 4 or 16"):
        cuda_align.mas_plan(30, 96, K=8)
