"""Monotonic Alignment Search (MAS): the training step's hot-path scan as one kernel.

Replaces no Pallas kernel: the JAX package runs MAS as two ``lax.scan``s in
XLA (the Viterbi forward at ``vits_tpu/ops/align.py:51``, the backtrace at
``:70``), over every frame of every training step. The CUDA kernel is
``vits_tpu_torch/csrc/align.cu`` (one block per batch row; up to
REGISTER_TOKENS tokens the values in registers, shifted by warp shuffles and
one barrier a frame, and the choices packed into bits in shared memory;
every other shape through ``mas_generic``, the values and, where they do not
fit, the choices in device scratch; one thread walks the bits back and the
block writes the one-hot rows). Its plain twin is
:func:`monotonic_align_reference`, the Python loop over frames. Both compute
JAX's arithmetic cell for cell (one fp32 add and one compare), so their
alignments are equal, not close.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from vits_tpu_torch.ops.cuda import check, count_launch, library, on_cuda, on_device, stream_of

_NEG_INF = -1e9

# sm_90's most dynamic shared memory a block may use (common.cuh kMaxSmemBytes)
SMEM_BYTES = 232448
# align.cu's constants: frames in the likelihood ring, frames of the path walked
# between writes, the most threads a block has
RING_FRAMES = 8
PATH_CHUNK = 1024
MAX_THREADS = 1024
# The most tokens that mas_kernel takes (one a thread, values in registers): up to
# its 1024 threads it beats mas_generic at every width measured (ns a frame at B=2,
# 372.6 against 586.5 at T=512, 498.7 against 675.6 at 768, 690.1 against 849.7 at
# 1024; scripts/torch_mas_probe.py on an H100 80GB HBM3 at 700 W)
REGISTER_TOKENS = 1024


class MasPlan(NamedTuple):
    """How ``vk_monotonic_align`` runs a (S, T) alignment."""

    threads: int  # the block's threads
    registers: bool  # values in registers (mas_kernel), else in device scratch (mas_generic)
    choice_bytes: int  # (S - 1) * ceil(T / 32) * 4: one bit a cell
    base_bytes: int  # shared memory besides the choices
    choices_shared: bool  # choices in shared memory (else device scratch)


def mas_plan(S: int, T: int) -> MasPlan:
    """The kernel, the block and where the choices live, for S frames and T
    tokens (align.cu's shared-memory layout, byte for byte).

    mas_kernel where T <= REGISTER_TOKENS and its choices fit in shared memory
    beside its likelihood ring; else mas_generic, its choices in shared memory
    where they fit, else in device scratch. A block of one thread a token, up
    to MAX_THREADS."""
    if S < 1 or T < 1:
        raise ValueError(f"monotonic_align needs a frame and a token, got S={S}, T={T}")
    tail = 4 * PATH_CHUNK + 4 * 64 + 4 * 2  # path chunk, reduction, lengths
    threads = 32 * -(-min(T, MAX_THREADS) // 32)
    choice_bytes = 4 * (S - 1) * -(-T // 32)
    if T <= REGISTER_TOKENS:
        base = 4 * (RING_FRAMES * threads + 2 * (threads // 32)) + tail
        if base + choice_bytes <= SMEM_BYTES:
            return MasPlan(threads, True, choice_bytes, base, True)
    return MasPlan(threads, False, choice_bytes, tail, tail + choice_bytes <= SMEM_BYTES)


# The shapes the kernel is held equal to its plain loop at (tests/test_torch_cuda.py,
# chip_smoke.py) and, up to "training", the loop to JAX's on the CPU
# (tests/test_torch_align.py): (B, S, T, frame lengths, token lengths).
MAS_CASES = {
    "tied": (2, 23, 7, (23, 15), (7, 4)),  # every likelihood 0: every path tied
    "empty_rows": (4, 19, 6, (19, 0, 0, 19), (0, 6, 0, 6)),  # no valid token / frame / both
    "one_token": (3, 17, 1, (17, 9, 1), (1, 1, 1)),
    "one_frame": (3, 1, 8, (1, 1, 0), (8, 3, 1)),
    "fewer_frames": (2, 5, 40, (5, 3), (40, 12)),  # S < T
    "padded": (3, 61, 37, (61, 44, 20), (37, 30, 9)),
    "random": (3, 300, 97, (300, 211, 150), (97, 64, 33)),
    "training": (2, 1280, 512, (1280, 800), (512, 300)),  # chip_smoke.py's phase 7 batch
    "training_b16": (16, 1280, 512, tuple(range(1280, 480, -50)), tuple(range(512, 192, -20))),
    "register_tokens": (2, 640, 1024, (640, 500), (1024, 700)),  # mas_kernel's widest
    "past_register_tokens": (1, 200, 1025, (200,), (1025,)),  # mas_generic's narrowest
    "choices_in_scratch": (2, 3000, 700, (3000, 2100), (700, 450)),
    "values_in_scratch": (2, 40, 5000, (40, 31), (5000, 4100)),
    "both_in_scratch": (1, 400, 9000, (400,), (8999,)),
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
    kernel: fp32 likelihoods and masks (the training step's), contiguous, on
    one device, any S and T (:func:`mas_plan`), or raise.
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
    out = torch.empty_like(log_likelihood)
    if B == 0:
        return out
    plan = mas_plan(S, T)
    choices = None if plan.choices_shared else torch.empty(
        (B, plan.choice_bytes // 4), dtype=torch.int32, device=out.device)
    values = None if plan.registers else torch.empty(
        (B, 2, T), dtype=torch.float32, device=out.device)
    with on_device(log_likelihood):
        check(library().vk_monotonic_align(
            log_likelihood.data_ptr(), frame_mask.data_ptr(), token_mask.data_ptr(),
            out.data_ptr(), None if choices is None else choices.data_ptr(),
            None if values is None else values.data_ptr(), B, S, T, plan.threads,
            stream_of(log_likelihood)),
            f"monotonic_align kernel (B={B}, S={S}, T={T}, {plan})")
    count_launch(monotonic_align)
    return out


monotonic_align.launches = 0
