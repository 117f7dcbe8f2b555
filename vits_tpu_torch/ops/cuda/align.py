"""Monotonic Alignment Search (MAS): the training step's hot-path scan as one kernel.

Replaces no Pallas kernel: the JAX package runs MAS as two ``lax.scan``s in
XLA (the Viterbi forward at ``vits_tpu/ops/align.py:51``, the backtrace at
``:70``), over every frame of every training step. The CUDA kernel is
``vits_tpu_torch/csrc/align.cu``; its plain twin is
:func:`monotonic_align_reference`, the Python loop over frames. Both compute
JAX's arithmetic cell for cell (one fp32 add and one compare), so their
alignments are equal, not close.

What bounds it on an H100 is the chain: S - 1 dependent frames a row, each
needing all of the frame before. Its bytes (the likelihoods read once and the
alignment written once, at 3.35 TB/s: 3.1 us at B=2, 1280 x 512) are small
beside that chain at the training batch. The design answers it so
(:func:`mas_plan` picks the numbers):

- each lane of a chain warp holds K consecutive tokens in registers; a frame is
  one warp shuffle and K independent max-adds, and the warps run as a skewed
  wavefront that hands each frame's last value on through tagged slots in
  shared memory, with no block barrier inside the frame loop;
- a producer warp brings the likelihoods in chunks of frames by TMA bulk copies
  into a ring in shared memory, each chunk's mbarrier waited on by the chain
  (a row's ragged edge by 4-byte ``cp.async`` on the same mbarrier);
- the choice bits are packed by each lane and transposed by shuffles into
  32-bit words a frame, kept in block 0's shared memory, else in the
  cluster's distributed shared memory, else (past what 8 blocks hold) in
  device scratch;
- the backtrace resolves 32 frames at a time from registers;
- each batch row is a cluster of blocks: block 0 runs the chain and the
  backtrace, the others write the row's masked zeros while the chain runs,
  and block 0 then writes the ones.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vits_tpu_torch.ops.cuda import (
    check,
    count_launch,
    device_sm_count,
    library,
    on_cuda,
    on_device,
    stream_of,
)

_NEG_INF = -1e9

# sm_90's most dynamic shared memory a block may use (common.cuh kMaxSmemBytes)
SMEM_BYTES = 232448
# align.cu's kMaxWarps (chain warps of a block at K = 16; kMaxWarpsNarrow at K = 4,
# whose lanes keep more of a group's likelihoods in registers) and kMaxCluster
# (the portable cluster size)
MAX_WARPS = 24
MAX_WARPS_NARROW = 8
MAX_CLUSTER = 8
# K (tokens a lane): 4 on a warp each 128 tokens up to 1,024 tokens, else 16 on a
# warp each 512 tokens up to MAX_WARPS, then strips. Measured on an H100
# (scripts/torch_mas_probe.py, B=2, 1,280 frames): at 512-1,024 tokens K = 4 ran
# 3.1-3.4x faster than K = 16, whose lane issues ~100 instructions a frame.
NARROW_TOKENS = 32 * 4 * MAX_WARPS_NARROW
# a chunk's bytes aimed at, the frames the ring aims to hold in flight, and
# the ring's most bytes (at least two chunks whatever their size)
CHUNK_BYTES = 32768
RING_FRAMES = 64
RING_BYTES = 131072
# output bytes a writer block takes while the chain runs (the cluster's size)
WRITER_BYTES = 1 << 20
# an H100's SMs: the cluster shrinks where B rows of clusters would pass them
H100_SMS = 132


class MasPlan(NamedTuple):
    """How ``vk_monotonic_align`` runs a (B, S, T) alignment."""

    K: int  # tokens a lane
    warps: int  # chain warps of block 0 (and one producer warp)
    strips: int  # token strips of 32 K warps tokens, run one after another
    frames: int  # frames a chunk of the likelihood ring (a multiple of 32 / K)
    chunks: int  # chunks of the ring
    row_floats: int  # floats a frame in the ring: T (one strip), else 32 K warps + 4
    slot_floats: int  # floats a chunk's slot: frames x row_floats + 4, to 16 bytes
    slots: int  # exchange slots a warp (a power of two past chunks x frames)
    cluster: int  # blocks a batch row: block 0 the chain, the others its zeros
    xs_off: int  # block 0's bytes before its exchange slots (mbarriers, lengths)
    ring_off: int  # and before its likelihood ring (128-byte aligned)
    base_off: int  # and before its choice rows: its shared memory besides them
    rows0: int  # choice rows in block 0's shared memory
    rows1: int  # and in each other block's (0: all in block 0, or in scratch)
    choices: str  # "shared" (block 0), "cluster" (distributed) or "scratch" (device)
    smem_bytes: int  # each block's dynamic shared memory
    choice_bytes: int  # (S - 1) * ceil(T / 32) * 4: one bit a cell


def _up(x: int, a: int) -> int:
    return -(-x // a) * a


def mas_plan(S: int, T: int, B: int = 1, sms: int = H100_SMS, K: int | None = None,
             warps: int | None = None) -> MasPlan:
    """The launch of a (B, S, T) alignment and block 0's shared-memory layout,
    which align.cu takes as given and only bounds-checks. ``K`` and ``warps``
    override the rule (K = 4 up to NARROW_TOKENS, else 16) for a sweep; the rest
    follows from them."""
    if S < 1 or T < 1:
        raise ValueError(f"monotonic_align needs a frame and a token, got S={S}, T={T}")
    if K is None:
        K = 4 if T <= NARROW_TOKENS else 16
    if K not in (4, 16):
        raise ValueError(f"monotonic_align: K={K} is not 4 or 16")
    most = MAX_WARPS if K == 16 else MAX_WARPS_NARROW
    if warps is None:
        warps = min(most, -(-T // (32 * K)))
    if not 1 <= warps <= most:
        raise ValueError(f"monotonic_align: {warps} warps at K={K}, not 1..{most}")
    G = 32 // K  # frames a lane packs into one word
    Ts = 32 * K * warps
    strips = -(-T // Ts)
    if strips > 1 and K != 16:
        raise ValueError(f"monotonic_align: {T} tokens pass K={K} x {warps} warps; only K=16 "
                         "runs in strips")
    # one strip: a chunk's frames as they lie in memory; strips: a row a frame
    row_floats = T if strips == 1 else Ts + 4
    frame_bytes = 4 * row_floats
    frames = G * max(1, min(32 // G, CHUNK_BYTES // (frame_bytes * G)))
    chunks = min(8, max(2, -(-RING_FRAMES // frames)))
    while chunks > 2 and chunks * frames * frame_bytes > RING_BYTES:
        chunks -= 1
    slot_floats = _up(frames * row_floats + 4, 4)  # + a ragged start
    slots = 1 << (chunks * frames).bit_length()  # a power of two past chunks x frames
    xs = _up(16 * chunks + 4 * 64 + 4 * 2, 16)
    ring = _up(xs + 8 * warps * slots, 128)
    base = ring + 4 * chunks * slot_floats
    if base > SMEM_BYTES:
        raise ValueError(f"monotonic_align: K={K} x {warps} warps at T={T} needs {base} "
                         f"bytes of shared memory before its choices")
    row_bytes = 4 * -(-T // 32)
    rows = S - 1
    need = 1
    if rows * row_bytes <= SMEM_BYTES - base:
        choices, smem, rows0, rows1 = "shared", base + rows * row_bytes, rows, 0
    else:
        rows0 = (SMEM_BYTES - base) // row_bytes // G * G
        rows1 = SMEM_BYTES // row_bytes // G * G
        need = 1 + -(-(rows - rows0) // rows1) if rows1 else MAX_CLUSTER + 1
        if need <= MAX_CLUSTER:
            choices, smem = "cluster", SMEM_BYTES
        else:
            choices, smem, rows0, rows1, need = "scratch", base, 0, 0, 1
    writers = min(MAX_CLUSTER - 1, max(1, -(-4 * S * T // WRITER_BYTES)))
    cluster = max(need, min(1 + writers, max(2, sms // max(B, 1))))
    return MasPlan(K, warps, strips, frames, chunks, row_floats, slot_floats, slots, cluster,
                   xs, ring, base, rows0, rows1, choices, smem, rows * row_bytes)


# The shapes the kernel is held equal to its plain loop at (tests/test_torch_cuda.py,
# chip_smoke.py) and, up to "training", the loop to JAX's on the CPU
# (tests/test_torch_align.py): (B, S, T, frame lengths, token lengths). The
# comments name the plan (K tokens a lane x chain warps) where a case is an edge.
MAS_CASES = {
    "tied": (2, 23, 7, (23, 15), (7, 4)),  # every likelihood 0: every path tied
    "empty_rows": (4, 19, 6, (19, 0, 0, 19), (0, 6, 0, 6)),  # no valid token / frame / both
    "one_token": (3, 17, 1, (17, 9, 1), (1, 1, 1)),
    "one_frame": (3, 1, 8, (1, 1, 0), (8, 3, 1)),
    "fewer_frames": (2, 5, 40, (5, 3), (40, 12)),  # S < T
    "padded": (3, 61, 37, (61, 44, 20), (37, 30, 9)),
    "random": (3, 300, 97, (300, 211, 150), (97, 64, 33)),  # 97 of 4 x 1's 128 tokens
    "odd_row": (2, 40, 301, (40, 31), (301, 188)),  # odd T: unaligned rows, 4 x 3
    "two_warps_widest": (2, 30, 256, (30, 19), (256, 170)),  # 4 x 2
    "three_warps_narrowest": (2, 30, 257, (30, 26), (257, 257)),  # 4 x 3
    "four_warps_widest": (1, 30, 512, (30,), (500,)),  # 4 x 4
    "five_warps_narrowest": (1, 30, 513, (30,), (513,)),  # 4 x 5
    "k16_narrowest": (2, 24, 1025, (24, 20), (1025, 800)),  # 16 x 3
    "training": (2, 1280, 512, (1280, 800), (512, 300)),  # chip_smoke.py's phase 7 batch; 4 x 4
    "training_b16": (16, 1280, 512, tuple(range(1280, 480, -50)), tuple(range(512, 192, -20))),
    "k4_widest": (2, 640, 1024, (640, 500), (1024, 700)),  # 4 x 8
    "k16_four_warps": (1, 120, 2048, (120,), (2000,)),  # 16 x 4
    "k16_five_warps": (1, 200, 2049, (200,), (2049,)),  # 16 x 5
    "choices_in_cluster": (2, 3000, 700, (3000, 2100), (700, 450)),  # 264 KB of choices; 4 x 6
    "k16_ten_warps": (2, 40, 5000, (40, 31), (5000, 4100)),
    "k16_eighteen_warps": (1, 400, 9000, (400,), (8999,)),  # choices in a cluster of 3
    # 16 x 24, the widest strip: block 0 holds 22 choice rows beside its ring
    "one_block_full": (1, 23, 12288, (23,), (12288,)),
    "one_block_past": (1, 24, 12288, (24,), (12000,)),  # 23 rows: the cluster's
    "cluster_full": (1, 1073, 12288, (1073,), (12288,)),  # 22 + 7 x 150 rows
    "cluster_past": (1, 1074, 12288, (1000,), (12288,)),  # choices in device scratch
    "strips": (2, 60, 13000, (60, 41), (13000, 12500)),  # two strips of 12,288 tokens
}


def mas_case(case: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A MAS_CASES case's fp32 likelihoods (B, S, T) and 1/0 masks (B, S), (B, T),
    seeded by the case's place in the table."""
    B, S, T, frames, tokens = MAS_CASES[case]
    rng = np.random.default_rng(list(MAS_CASES).index(case))
    ll = (rng.standard_normal((B, S, T)) * 3.0 - 10.0).astype(np.float32)
    if case == "tied":
        ll[:] = 0.0
    fmask = (np.arange(S)[None, :] < np.asarray(frames)[:, None]).astype(np.float32)
    tmask = (np.arange(T)[None, :] < np.asarray(tokens)[:, None]).astype(np.float32)
    return ll, fmask, tmask


@torch.no_grad()
def monotonic_align_reference(
    log_likelihood: torch.Tensor,  # (B, S_frames, T_tokens)
    frame_mask: torch.Tensor,  # (B, S_frames) 1/0
    token_mask: torch.Tensor,  # (B, T_tokens) 1/0
) -> torch.Tensor:
    """Best monotonic path -> one-hot alignment (B, S_frames, T_tokens), no gradient.

    The Viterbi forward pass is a Python loop over frames, vectorised over batch
    and tokens, and the backtrace a second loop over the recorded choices. The
    contract points, kept exactly: the ``>=`` tie-break toward the diagonal
    move, the finite ``-1e9`` of invalid cells, and a backtrace that holds each
    padded frame at its row's last token. A row with no valid token walks
    below token 0: ``jax.nn.one_hot`` makes each such frame a zero row, and
    so does this. The walk never climbs back, so every earlier frame's row is
    zero whatever choice it reads there (JAX wraps or fills the index; this
    reads token 0's).
    """
    B, S, T = log_likelihood.shape
    s_len = frame_mask.sum(dim=-1).to(torch.int64)
    t_len = token_mask.sum(dim=-1).to(torch.int64)
    ll = torch.where(token_mask.bool()[:, None, :], log_likelihood,
                     torch.full_like(log_likelihood, _NEG_INF))

    # forward: val[b, t] = best score of any path ending at (s, t)
    neg = ll.new_full((B, 1), _NEG_INF)
    val = torch.where(torch.arange(T, device=ll.device)[None, :] == 0, ll[:, 0, :],
                      neg.expand(B, T))
    choices = torch.empty((max(S - 1, 0), B, T), dtype=torch.bool, device=ll.device)
    for s in range(1, S):
        shifted = torch.cat([neg, val[:, :-1]], dim=1)
        choices[s - 1] = shifted >= val  # True = came from t-1 (diagonal move)
        val = ll[:, s, :] + torch.maximum(val, shifted)

    # backtrace from frame S-1 down to 1; padded frames hold the end token
    end_token = torch.clamp(t_len - 1, min=0)
    rows = torch.arange(B, device=ll.device)
    path = torch.empty((B, S), dtype=torch.int64, device=ll.device)
    t_cur = end_token
    for s in range(S - 1, 0, -1):
        t_here = torch.where(s == s_len - 1, end_token, t_cur)
        path[:, s] = t_here
        take_diag = choices[s - 1][rows, t_here.clamp(min=0)].to(torch.int64)
        t_cur = torch.where(s <= s_len - 1, t_here - take_diag, t_here)
    path[:, 0] = t_cur

    attn = (path[..., None] == torch.arange(T, device=ll.device)).to(log_likelihood.dtype)
    return attn * frame_mask[..., None] * token_mask[:, None, :]


def monotonic_align(
    log_likelihood: torch.Tensor,  # (B, S_frames, T_tokens) fp32
    frame_mask: torch.Tensor,  # (B, S_frames) 1/0 fp32
    token_mask: torch.Tensor,  # (B, T_tokens) 1/0 fp32
) -> torch.Tensor:
    """Best monotonic path -> one-hot alignment (B, S_frames, T_tokens) in the
    likelihood's dtype, no gradient (a constant target, as in VITS).

    CPU tensors take :func:`monotonic_align_reference`. CUDA tensors launch the
    kernel once: fp32 likelihoods and masks (the training step's), contiguous,
    on one device, any S and T (:func:`mas_plan`), or raise.
    """
    if not on_cuda("monotonic_align", log_likelihood, frame_mask, token_mask):
        return monotonic_align_reference(log_likelihood, frame_mask, token_mask)
    if log_likelihood.dim() != 3:
        raise ValueError(f"monotonic_align: likelihoods of shape {tuple(log_likelihood.shape)}, "
                         "not (B, S, T)")
    B, S, T = log_likelihood.shape
    if frame_mask.shape != (B, S) or token_mask.shape != (B, T):
        raise ValueError(f"monotonic_align: masks {tuple(frame_mask.shape)} and "
                         f"{tuple(token_mask.shape)} for likelihoods {(B, S, T)}")
    if B == 0:
        return torch.empty_like(log_likelihood)
    out = launch(mas_plan(S, T, B, device_sm_count(log_likelihood.device)), log_likelihood,
                 frame_mask, token_mask)
    count_launch(monotonic_align)
    return out


def launch(plan: MasPlan, log_likelihood: torch.Tensor, frame_mask: torch.Tensor,
           token_mask: torch.Tensor) -> torch.Tensor:
    """One launch of ``mas_wavefront`` by ``plan`` on checked CUDA tensors, not
    counted: :func:`monotonic_align` counts its own, and the probe's sweep
    (``scripts/torch_mas_probe.py``) launches other plans through this."""
    B, S, T = log_likelihood.shape
    out = torch.empty_like(log_likelihood)
    scratch = torch.empty((B, plan.choice_bytes // 4), dtype=torch.int32, device=out.device) \
        if plan.choices == "scratch" else None
    column = torch.empty((B, 2, S), dtype=torch.float32, device=out.device) \
        if plan.strips > 1 else None
    with on_device(log_likelihood):
        check(library().vk_monotonic_align(
            log_likelihood.data_ptr(), frame_mask.data_ptr(), token_mask.data_ptr(),
            out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            None if column is None else column.data_ptr(), B, S, T, plan.K, plan.warps,
            plan.frames, plan.chunks, plan.slot_floats, plan.slots, plan.rows0, plan.rows1,
            plan.xs_off, plan.ring_off, plan.base_off, plan.cluster, plan.smem_bytes,
            stream_of(log_likelihood)),
            f"monotonic_align kernel (B={B}, S={S}, T={T}, {plan})")
    return out


monotonic_align.launches = 0
