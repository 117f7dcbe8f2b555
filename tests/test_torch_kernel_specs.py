"""The arithmetic that kernels C, 4 and 7 (``csrc/stage.cu``, ``narrow_gemm.cuh``,
``rel_attention_bwd.cu``, ``resblock_block.cu``) rest on, held on the CPU.

- The upsampler kernel is polyphase: each phase of a stride-s ConvTranspose1d
  is a plain Conv1d over the input steps (``ops/cuda/stage.py``). Its plain
  form, ``polyphase_upsample``, is held against ``conv_transpose1d(leaky(x))``
  + bias + mask; tolerance 1e-5 x max(1, max|ref|) (fp32 sums in another
  order).
- Kernel 4 skips every key at or past a row's length and writes zeros for a
  length-0 row. ``rel_attention_bwd_reference`` shows both exact: p and ds are
  exactly 0 there, so keys past the length that hold anything at all leave the
  gradients as they were (rtol 1e-6: only the summation order may move).
- Kernel 7 computes a resblock tile by tile from one halo window, shrinking
  it conv by conv and masking in global coordinates. Its plain form,
  ``resblock_tiled``, is held against ``resblock_reference`` (tolerance 1e-5
  x max(1, max|ref|): the same convs over a window instead of the whole row).
- The pure-Python plan functions (``upsample_phases``, the narrow path of
  ``conv_plan``, ``block_plan``) are pinned at the shapes the main paths give
  them.
"""

import numpy as np
import pytest
import torch

from vits_tpu_torch.ops.conv import conv_transpose1d, leaky_relu
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
from vits_tpu_torch.ops.cuda.attention_grad import (
    rel_attention_bwd_reference,
    rel_attention_bwd_terms,
)
from vits_tpu_torch.ops.cuda.resblock import (
    BLOCK_CHANNELS,
    MAX_SMEM_BYTES,
    NARROW_COLS,
    NARROW_ROWS,
    block_plan,
    block_smem,
    conv_plan,
    resblock_reference,
    resblock_tiled,
)
from vits_tpu_torch.ops.cuda.stage import polyphase_upsample, upsample_phases

H100_SMS = 132
SLOPE = 0.1


@pytest.mark.parametrize("lengths", [None, (13, 0), (1, 17)])
@pytest.mark.parametrize("stride,k,pad,C_in,C_out", [
    (2, 4, 1, 16, 8),  # the MMS stages' upsampler (128->64, 64->32), narrowed
    (8, 16, 4, 8, 2),  # the MMS stages 0-1 upsampler shape (k=16, s=8)
    (4, 6, 1, 8, 4),  # phases of unequal tap counts: 2, 1, 1, 2
])
def test_polyphase_upsample_equals_conv_transpose(stride, k, pad, C_in, C_out, lengths):
    rng = np.random.default_rng(stride * 100 + k)
    B, T_in = 2, 17
    x = torch.tensor(rng.standard_normal((B, T_in, C_in)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((k, C_in, C_out)), dtype=torch.float32)
    bias = torch.tensor(rng.standard_normal(C_out), dtype=torch.float32)
    lens = None if lengths is None else torch.tensor(lengths)
    want = conv_transpose1d(leaky_relu(x, SLOPE), w, bias, stride=stride, padding=pad)
    if lens is not None:
        want = want * (torch.arange(T_in * stride)[None, :] < lens[:, None] * stride)[..., None]
    got = polyphase_upsample(x, w, bias, stride=stride, padding=pad, slope=SLOPE, lengths=lens)
    assert got.shape == want.shape == (B, T_in * stride, C_out)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)
    if lengths is not None and 0 in lengths:
        assert float(got[lengths.index(0)].abs().max()) == 0.0


@pytest.mark.parametrize("stride,k,pad,want", [
    (2, 4, 1, ((0, 2, 1), (1, 2, 0))),
    (4, 6, 1, ((0, 2, 1), (3, 1, 0), (2, 1, 0), (1, 2, 0))),
    (8, 16, 4, ((3, 2, 1), (2, 2, 1), (1, 2, 1), (0, 2, 1),
                (7, 2, 0), (6, 2, 0), (5, 2, 0), (4, 2, 0))),
])
def test_upsample_phases_cover_every_tap_once(stride, k, pad, want):
    phases = upsample_phases(k, stride, pad)
    assert tuple(tuple(p) for p in phases) == want
    taps = sorted(p.first_tap + stride * i for p in phases for i in range(p.taps))
    assert taps == list(range(k))


@pytest.mark.parametrize("B,T,C_in,C_out", [(2, 40960, 16, 16), (2, 81920, 8, 8),
                                            (1, 300, 24, 24), (3, 17, 1, 1), (2, 300, 16, 128)])
def test_conv_plan_counts_the_narrow_blocks(B, T, C_in, C_out):
    """Narrow channels: NARROW_ROWS steps x up to NARROW_COLS out-channels a block."""
    plan = conv_plan(B, T, C_in, C_out, 11, H100_SMS)
    assert plan.tile == -1 and plan.split == 1
    assert plan.blocks == -(-T // NARROW_ROWS) * -(-C_out // NARROW_COLS) * B


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("C", BLOCK_CHANNELS)
def test_resblock_tiled_equals_reference(C, k):
    """Kernel 7's tiling: 32-step tiles of T = 100 with lengths 0, 37 (mid-tile)
    and 64 (on a tile boundary); the length-0 row and every step past a length
    exactly 0."""
    rng = np.random.default_rng(C * 100 + k)
    B, T, bm, lengths = 3, 100, 32, (0, 37, 64)
    x = rng.standard_normal((B, T, C)) * (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[
        ..., None]
    x = torch.tensor(x, dtype=torch.float32)
    block = dict(kernel_size=k, dilations=(1, 3, 5), **{
        name: torch.tensor(rng.standard_normal(shape) * 0.1, dtype=torch.float32)
        for name, shape in (("w1", (3, k, C, C)), ("b1", (3, C)), ("w2", (3, k, C, C)),
                            ("b2", (3, C)))})
    lens = torch.tensor(lengths)
    want = resblock_reference(x, block, slope=SLOPE, lengths=lens)
    got = resblock_tiled(x, block, slope=SLOPE, lengths=lens, bm=bm)
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got / scale, want / scale, rtol=0, atol=1e-5)
    for b, n in enumerate(lengths):
        assert torch.count_nonzero(got[b, n:]) == 0


# (B, T, C): kernel 7 at chip_smoke.py phase 3's shapes (HiFi-GAN V2's stages 0-1
# for 320 frames, batch 2), one 576-frame request's, and kernel C's MMS resblock shape.
BLOCK_SHAPES = [(2, 2560, 64), (2, 20480, 32), (1, 4608, 64), (1, 36864, 32), (1, 40960, 64)]


@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("B,T,C", BLOCK_SHAPES)
def test_block_plan_covers_every_tile_and_fits(B, T, C, k):
    plan = block_plan(B, T, C, k, (1, 3, 5), H100_SMS)
    assert plan.bm % 16 == 0 and C % plan.cluster == 0 and C // plan.cluster >= 8
    assert plan.blocks == B * -(-T // plan.bm) * plan.cluster  # the grid covers every tile
    assert plan.smem == block_smem(plan.bm, C, k, (1, 3, 5), plan.cluster) <= MAX_SMEM_BYTES


def _attention_case(lengths, L=48, H=2, d=8, w=4, seed=0):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    q, k, v, dout = (torch.tensor(rng.standard_normal((B, H, L, d)) * 0.5, dtype=torch.float32)
                     for _ in range(4))
    rel_k, rel_v = (torch.tensor(rng.standard_normal((2 * w + 1, d)) * 0.5, dtype=torch.float32)
                    for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32)
    out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=w, lengths=lens,
                                   return_lse=True)
    return (q, k, v, rel_k, rel_v, lse, dout, out), dict(window=w, lengths=lens)


@pytest.mark.parametrize("lengths", [(48, 0), (37, 5), (1, 48)])
def test_backward_terms_vanish_past_the_length(lengths):
    """Every p and ds of a key at or past its row's length is exactly 0."""
    args, kw = _attention_case(lengths)
    p, ds = rel_attention_bwd_terms(*args, **kw)
    H = args[0].shape[1]
    for b, n in enumerate(lengths):
        rows = slice(b * H, (b + 1) * H)
        assert torch.count_nonzero(p[rows, :, n:]) == 0
        assert torch.count_nonzero(ds[rows, :, n:]) == 0
        assert bool(torch.isfinite(p[rows]).all())


@pytest.mark.parametrize("lengths", [(48, 0), (37, 5), (20, 33)])
def test_keys_past_the_length_leave_the_gradients(lengths):
    """Keys and values past each row's length replaced by other numbers: the
    gradients stay (so a kernel that never reads those keys is exact), and the
    keys past the length get dk = dv = 0 exactly."""
    args, kw = _attention_case(lengths, seed=1)
    q, k, v, rel_k, rel_v, lse, dout, out = args
    want = rel_attention_bwd_reference(*args, **kw)
    rng = np.random.default_rng(2)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, :, n:] = torch.tensor(rng.standard_normal(k2[b, :, n:].shape) * 3.0)
        v2[b, :, n:] = torch.tensor(rng.standard_normal(v2[b, :, n:].shape) * 3.0)
    got = rel_attention_bwd_reference(q, k2, v2, rel_k, rel_v, lse, dout, out, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6 * max(1.0, float(w.abs().max())))
    for b, n in enumerate(lengths):
        for grad in got[1:3]:  # dk, dv
            assert torch.count_nonzero(grad[b, :, n:]) == 0


def test_length_zero_row_contributes_nothing():
    """A len = 0 row: its dq, dk, dv are exactly 0, and the rel-table gradients
    of the batch equal those of its other row alone, bit for bit."""
    args, kw = _attention_case((41, 0), seed=3)
    both = rel_attention_bwd_reference(*args, **kw)
    for grad in both[:3]:
        assert torch.count_nonzero(grad[1]) == 0
    q, k, v, rel_k, rel_v, lse, dout, out = args
    alone = rel_attention_bwd_reference(q[:1], k[:1], v[:1], rel_k, rel_v, lse[:1], dout[:1],
                                        out[:1], window=kw["window"],
                                        lengths=kw["lengths"][:1])
    for g_both, g_alone in zip(both, alone):
        if g_both.dim() == 4:
            g_both = g_both[:1]
        assert torch.equal(g_both, g_alone)
