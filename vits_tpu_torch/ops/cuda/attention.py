"""Kernel A: windowed relative-position self-attention (the text encoder's).

Replaces ``vits_tpu/ops/pallas/attention.py::flash_rel_attention``. The CUDA
kernel is ``vits_tpu_torch/csrc/rel_attention.cu`` (fp32; the warps of a
block split the keys, each with its own online softmax, merged at the end;
the key loop stops at a row's length; finite additive key mask); its plain
PyTorch twin is :func:`rel_attention_reference`, the encoder module's
einsum-and-shuffle math.
With ``return_lse`` both also return each query row's logsumexp, the residual
of the backward (``ops/cuda/attention_grad.py``). Both take a precision tier
(``ops/tiers.py``: the JAX kernel's ``precision``), which rounds the operands of
every product -- q.k, q.rel_k, the probabilities against v and rel_v -- as
the tier rounds them; the values and the softmax stay fp32. At a tier with
bf16 values (``ops/tiers.py::BF16_TRAIN_TIER``, bf16 training) q, k, v and
the tables are bf16 storage, read and computed in fp32 as the JAX kernel
upcasts them; the output comes back in their dtype, lse in fp32. bf16
serving (``Tier.bf16_compute``, no lse) takes bf16 q, k, v and tables at any
tier, as the JAX kernel does at ``compute_dtype="bfloat16"``: at the fast tier
the kernel reads them as bf16 storage (the route above); at "high" and
"highest" the wrapper widens them to fp32 (bf16 is exact in fp32) and the
kernel runs that tier's fp32 path; the output is rounded to bf16 either way,
where the JAX kernel writes q's dtype.
"""

from __future__ import annotations

import torch

from vits_tpu_torch.ops.attention import (
    absolute_position_to_relative_position,
    get_relative_embeddings,
    relative_position_to_absolute_position,
)
from vits_tpu_torch.ops.conv import softmax
from vits_tpu_torch.ops.tiers import EXACT, EXACT_TIER, FAST, Tier, tier_product
from vits_tpu_torch.ops.cuda import (
    check,
    count_launch,
    cuda_lengths,
    library,
    no_autograd,
    on_cuda,
    on_device,
    stream_of,
)


# The kernels' ceiling (rel_attention.cu and rel_attention_bwd.cu, kMaxD and kMaxW):
# head widths up to 256 in two column chunks of up to 128, windows up to 32 (65
# relative offsets in shared memory). A shape past it raises; it never takes the
# plain twin on the card.
MAX_HEAD_DIM = 256
MAX_WINDOW = 32


def check_ceiling(what: str, head_dim: int, window: int) -> None:
    """Raise where kernels A and 4 do not take ``head_dim`` or ``window``."""
    if not 1 <= head_dim <= MAX_HEAD_DIM or not 0 <= window <= MAX_WINDOW:
        raise ValueError(f"{what} kernel takes 1 <= head_dim <= {MAX_HEAD_DIM} and "
                         f"0 <= window <= {MAX_WINDOW}, got head_dim {head_dim}, window {window}")


def _rel_product(a: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqd,rd->bqr", a, rel)


def _rel_weighted(a: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqr,rd->bqd", a, rel)


def _scores_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b.transpose(1, 2))


def _product(op, a: torch.Tensor, b: torch.Tensor, tier: Tier) -> torch.Tensor:
    """``op(a, b)`` at ``tier``; operands of one dtype at the exact tier as they
    are (bf16 ones: XLA's bf16 einsum, fp32 sums and the result rounded)."""
    if tier.mode == EXACT and a.dtype == b.dtype:
        return op(a, b)
    return tier_product(op, a, b, tier)


def rel_attention_scores(q: torch.Tensor, k: torch.Tensor, rel_k: torch.Tensor | None,
                         window: int, tier: Tier = EXACT_TIER) -> torch.Tensor:
    """(B*H, L, L) scores q.k plus the windowed rel-key logits (none without a
    table), before any mask."""
    B, H, L, d = q.shape
    qf, kf = q.reshape(B * H, L, d), k.reshape(B * H, L, d)
    scores = _product(_scores_product, qf, kf, tier)
    if rel_k is None:
        return scores
    key_rel = get_relative_embeddings(rel_k[None], L, window)
    rel_logits = _product(_rel_product, qf, key_rel[0], tier)
    return scores + relative_position_to_absolute_position(rel_logits)


def rel_attention_reference(
    q: torch.Tensor,  # (B, H, L, d), pre-scaled by 1/sqrt(d)
    k: torch.Tensor,
    v: torch.Tensor,
    rel_k: torch.Tensor | None,  # (2w+1, d)
    rel_v: torch.Tensor | None,
    *,
    window: int,
    lengths: torch.Tensor | None = None,  # (B,) valid keys per row
    return_lse: bool = False,
    tier: Tier = EXACT_TIER,
):
    """Plain PyTorch: scores, rel-key logits, finfo.min key mask, softmax, rel
    values, every product at ``tier``, in the inputs' dtype (on bf16 tensors the
    JAX module's bf16 graph: the encoder's plain path in bf16 training). With
    no tables (``rel_k = rel_v = None``, a model with ``window_size`` 0) the
    same without the relative terms: the JAX module's path at window 0
    (``vits_tpu/models/encoder.py:82-110``), which no kernel replaces.

    With ``return_lse`` returns ``(out, lse)``, lse (B, H, L) the logsumexp of
    each query row's masked scores.
    """
    B, H, L, d = q.shape
    vf = v.reshape(B * H, L, d)
    weights = rel_attention_scores(q, k, rel_k, window, tier)
    if lengths is not None:
        keep = (torch.arange(L, device=q.device)[None, :] < lengths[:, None]).to(q.dtype)
        bias = (1.0 - keep[:, None, None, :]) * torch.finfo(q.dtype).min
        weights = (weights.reshape(B, H, L, L) + bias).reshape(B * H, L, L)
    lse = torch.logsumexp(weights, dim=-1) if return_lse else None
    weights = softmax(weights)  # on bf16: jax.nn.softmax's steps, as bf16 training runs it
    out = _product(torch.bmm, weights, vf, tier)
    if rel_v is not None:
        value_rel = get_relative_embeddings(rel_v[None], L, window)
        rel_weights = absolute_position_to_relative_position(weights)
        out = out + _product(_rel_weighted, rel_weights, value_rel[0], tier)
    out = out.reshape(B, H, L, d)
    return (out, lse.reshape(B, H, L)) if return_lse else out


def rel_attention_plain(q, k, v, rel_k, rel_v, *, window: int,
                        lengths: torch.Tensor | None = None, return_lse: bool = False,
                        tier: Tier = EXACT_TIER):
    """Kernel A's plain twin: :func:`rel_attention_reference` on the inputs read
    as fp32, the output in q's dtype (lse fp32)."""
    out = rel_attention_reference(q.float(), k.float(), v.float(), rel_k.float(), rel_v.float(),
                                  window=window, lengths=lengths, return_lse=return_lse,
                                  tier=tier)
    if return_lse:
        return out[0].to(q.dtype), out[1]
    return out.to(q.dtype)


def flash_rel_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    rel_k: torch.Tensor,
    rel_v: torch.Tensor,
    *,
    window: int,
    lengths: torch.Tensor | None = None,
    return_lse: bool = False,
    tier: Tier = EXACT_TIER,
):
    """(B, H, L, d) attention output before the out-projection, at ``tier``.

    With ``return_lse`` returns ``(out, lse)``, lse (B, H, L) fp32. q, k, v
    and the tables in the tier's value dtype (bf16 values only at the fast
    tier; bf16 compute at every tier, without lse). CPU tensors take
    :func:`rel_attention_plain`; CUDA tensors launch the kernel (contiguous,
    ``d <= MAX_HEAD_DIM``, ``window <= MAX_WINDOW``, no autograd) or raise.
    """
    if tier.bf16_compute:
        if return_lse:
            raise ValueError("rel_attention: bf16 serving returns no lse")
        if tier.mode == FAST:  # bf16 storage, as bf16 training reads it
            return flash_rel_attention(q, k, v, rel_k, rel_v, window=window, lengths=lengths,
                                       tier=Tier(FAST, True))
        if any(t.dtype != torch.bfloat16 for t in (q, k, v, rel_k, rel_v)):
            raise ValueError(f"rel_attention at the {tier.name} tier takes bf16 q, k, v and "
                             "tables")
        wide = [t.float() for t in (q, k, v, rel_k, rel_v)]
        return flash_rel_attention(*wide, window=window, lengths=lengths,
                                   tier=Tier(tier.mode)).to(torch.bfloat16)
    dtype = tier.value_dtype
    if any(t.dtype != dtype for t in (q, k, v, rel_k, rel_v)) or (
            tier.bf16_values and tier.mode != FAST):
        raise ValueError(f"rel_attention at the {tier.name} tier takes {dtype} q, k, v and "
                         "tables (bf16 at the fast tier only)")
    if not on_cuda("flash_rel_attention", q, k, v, rel_k, rel_v, dtype=dtype):
        return rel_attention_plain(q, k, v, rel_k, rel_v, window=window, lengths=lengths,
                                   return_lse=return_lse, tier=tier)
    no_autograd("flash_rel_attention", q, k, v, rel_k, rel_v)
    B, H, L, d = q.shape
    nr = 2 * window + 1
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    if rel_k.shape != (nr, d) or rel_v.shape != (nr, d):
        raise ValueError(f"rel tables must be ({nr}, {d}): {rel_k.shape}, {rel_v.shape}")
    check_ceiling("rel_attention", d, window)
    lens = cuda_lengths(lengths, B, L, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=q.device) if return_lse else None
    with on_device(q):
        check(library().vk_rel_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_k.data_ptr(), rel_v.data_ptr(),
            lens.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
            B, H, L, d, window, tier.mode, int(tier.bf16_values), stream_of(q)),
            "rel_attention kernel")
    count_launch(flash_rel_attention)
    if return_lse:
        count_launch(flash_rel_attention, "lse_launches")
        return out, lse
    return out


flash_rel_attention.launches = 0
flash_rel_attention.lse_launches = 0  # the launches that also wrote lse
