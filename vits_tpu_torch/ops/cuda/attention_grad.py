"""Kernel 4: the relative-position attention's backward, behind autograd.

Replaces ``vits_tpu/ops/pallas/attention_grad.py::make_trainable_attention``
(its backward ``_flash_bwd``). :func:`trainable_rel_attention` is a
``torch.autograd.Function``: the forward is kernel A with its logsumexp output
(``ops/cuda/attention.py``), the backward the one-launch CUDA kernel of
``vits_tpu_torch/csrc/rel_attention_bwd.cu`` (dq blocks and dk/dv blocks in
one grid) via :func:`rel_attention_bwd`,
whose plain PyTorch twin is :func:`rel_attention_bwd_reference`. Both rebuild
the probabilities from the saved lse as ``p = exp(s - lse)``, 0 for keys at or
past each row's length, and form ``ds = p (dp - D)`` with ``D = dout . out``.

Every function takes a precision tier (``ops/tiers.py``), as
``make_trainable_attention(precision=...)`` takes one: each product of the
backward's dots at the tier, ds, p and every sum fp32; the kernel is built
for the two training tiers (:data:`TRAIN_TIERS`), the twins take any. At
``BF16_TRAIN_TIER`` (bf16 training) q, k, v, the tables, dout and out are
bf16 storage, read as fp32 as the JAX kernel upcasts them; dq, dk, dv come
back in bf16, and the rel-table gradients are summed in fp32 and cast once to
the tables' dtype (``vits_tpu/ops/pallas/attention_grad.py:253-257``).
"""

from __future__ import annotations

import torch

from vits_tpu_torch.ops.attention import (
    absolute_position_to_relative_position,
    get_relative_embeddings,
    relative_position_to_absolute_position,
)
from vits_tpu_torch.ops.cuda import (
    booked_to,
    check,
    count_launch,
    current_book,
    cuda_lengths,
    library,
    on_cuda,
    on_device,
    stream_of,
)
from vits_tpu_torch.ops.cuda.attention import (
    check_ceiling,
    flash_rel_attention,
    rel_attention_scores,
)
from vits_tpu_torch.ops.tiers import EXACT_TIER, FAST, TRAIN_TIERS, Tier, tier_product

_TILE = 16  # queries per dq block, one rel-table partial each (rel_attention_bwd.cu)


def _rel_table_grad(rel: torch.Tensor, L: int, window: int) -> torch.Tensor:
    """(B*H, 2L-1, d) per-offset gradients -> the (2w+1, d) table rows, summed over B*H.

    Relative row m is the offset j - i = m - (L - 1); table row r is the
    offset r - w. Rows whose offset does not occur at this L get 0.
    """
    nr = 2 * window + 1
    summed = rel.sum(dim=0)
    out = summed.new_zeros((nr, summed.shape[-1]))
    for r in range(nr):
        m = r - window + L - 1
        if 0 <= m < 2 * L - 1:
            out[r] = summed[m]
    return out


def _bmm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b.transpose(1, 2))


def _rel_product(a: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bqd,rd->bqr", a, rel)


def _rel_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bim,bid->bmd", a, b)


def rel_attention_bwd_terms(q, k, v, rel_k, rel_v, lse, dout, out, *, window, lengths,
                            tier: Tier = EXACT_TIER):
    """Plain PyTorch on fp32 inputs: the (B*H, L, L) probabilities p and ds = p (dp - D)
    that the backward rebuilds from lse, products at ``tier``; p is exactly 0 for
    keys at or past a row's length."""
    B, H, L, d = q.shape
    dof, vf = dout.reshape(B * H, L, d), v.reshape(B * H, L, d)
    s = rel_attention_scores(q, k, rel_k, window, tier)
    keep = torch.ones((B, L), dtype=torch.bool, device=q.device) if lengths is None else \
        torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    keep = keep[:, None, None, :].expand(B, H, L, L).reshape(B * H, L, L)
    p = torch.where(keep, torch.exp(s - lse.reshape(B * H, L, 1)), torch.zeros_like(s))
    value_rel = get_relative_embeddings(rel_v[None], L, window)[0]  # (2L-1, d)
    dp = tier_product(_bmm_t, dof, vf, tier) + relative_position_to_absolute_position(
        tier_product(_rel_product, dof, value_rel, tier))
    drow = (dout * out).sum(dim=-1).reshape(B * H, L, 1)
    return p, p * (dp - drow)


def rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out, *, window, lengths,
                                tier: Tier = EXACT_TIER):
    """Plain PyTorch: (dq, dk, dv, drel_k, drel_v) with the kernel's math, full
    matrices, on the inputs read as fp32, every product at ``tier``; dq, dk, dv
    in q's dtype, the table gradients summed in fp32 and cast to rel_k's."""
    dtype, rel_dtype = q.dtype, rel_k.dtype
    q, k, v, rel_k, rel_v, dout, out = (t.float() for t in (q, k, v, rel_k, rel_v, dout, out))
    B, H, L, d = q.shape
    qf, kf, dof = (t.reshape(B * H, L, d) for t in (q, k, dout))
    p, ds = rel_attention_bwd_terms(q, k, v, rel_k, rel_v, lse, dout, out, window=window,
                                    lengths=lengths, tier=tier)
    key_rel = get_relative_embeddings(rel_k[None], L, window)[0]
    ds_rel = absolute_position_to_relative_position(ds)  # (B*H, L, 2L-1)
    p_rel = absolute_position_to_relative_position(p)
    dq = tier_product(torch.bmm, ds, kf, tier) + tier_product(torch.matmul, ds_rel, key_rel, tier)
    dk = tier_product(torch.bmm, ds.transpose(1, 2), qf, tier)
    dv = tier_product(torch.bmm, p.transpose(1, 2), dof, tier)
    drk = _rel_table_grad(tier_product(_rel_sums, ds_rel, qf, tier), L, window)
    drv = _rel_table_grad(tier_product(_rel_sums, p_rel, dof, tier), L, window)
    shape4 = (B, H, L, d)
    return (dq.reshape(shape4).to(dtype), dk.reshape(shape4).to(dtype),
            dv.reshape(shape4).to(dtype), drk.to(rel_dtype), drv.to(rel_dtype))


def rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout, out, *, window, lengths,
                      tier: Tier = EXACT_TIER):
    """(dq, dk, dv, drel_k, drel_v) of :func:`flash_rel_attention` given its lse,
    at ``tier``: q, k, v, the tables, dout and out in the tier's value dtype
    (bf16 at the fast tier only), lse fp32.

    CPU tensors take :func:`rel_attention_bwd_reference`; CUDA tensors launch
    the kernel (contiguous, at kernel A's ceiling) or raise.
    """
    dtype = tier.value_dtype
    if any(t.dtype != dtype for t in (q, k, v, rel_k, rel_v, dout, out)) or (
            tier.bf16_values and tier.mode != FAST):
        raise ValueError(f"rel_attention_bwd at the {tier.name} tier takes {dtype} tensors "
                         "(bf16 at the fast tier only)")
    if not on_cuda("rel_attention_bwd", q, k, v, rel_k, rel_v, dout, out, dtype=dtype):
        return rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out,
                                           window=window, lengths=lengths, tier=tier)
    if tier not in TRAIN_TIERS:
        raise ValueError(f"rel_attention_bwd kernel: the exact tier on fp32 or the fast tier "
                         f"on bf16, not {tier.name}")
    if lse.device != q.device or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("rel_attention_bwd: lse must be a contiguous fp32 tensor on q's device")
    B, H, L, d = q.shape
    nr = 2 * window + 1
    for t in (k, v, dout, out):
        if t.shape != q.shape:
            raise ValueError(f"rel_attention_bwd: shape {tuple(t.shape)} != {tuple(q.shape)}")
    if lse.shape != (B, H, L) or rel_k.shape != (nr, d) or rel_v.shape != (nr, d):
        raise ValueError(f"rel_attention_bwd: lse {tuple(lse.shape)} or rel tables "
                         f"{tuple(rel_k.shape)}, {tuple(rel_v.shape)} do not fit ({B}, {H}, {L}, {d})")
    check_ceiling("rel_attention_bwd", d, window)
    lens = cuda_lengths(lengths, B, L, q.device)
    drow = (dout.float() * out.float()).sum(dim=-1).contiguous()  # D in fp32, outside as in JAX
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    tiles = -(-L // _TILE)
    drk_part = torch.empty((B, H, tiles, nr, d), dtype=torch.float32, device=q.device)
    drv_part = torch.empty_like(drk_part)
    with on_device(q):
        check(library().vk_rel_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_k.data_ptr(), rel_v.data_ptr(),
            lens.data_ptr(), lse.data_ptr(), drow.data_ptr(), dout.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drk_part.data_ptr(), drv_part.data_ptr(),
            B, H, L, d, window, tier.mode, int(tier.bf16_values), stream_of(q)),
            "rel_attention backward kernel")
    count_launch(rel_attention_bwd)
    return (dq, dk, dv, drk_part.sum(dim=(0, 1, 2)).to(rel_k.dtype),
            drv_part.sum(dim=(0, 1, 2)).to(rel_v.dtype))


rel_attention_bwd.launches = 0


class _TrainableRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_k, rel_v, lengths, window, tier):
        out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=window, lengths=lengths,
                                       return_lse=True, tier=tier)
        ctx.window, ctx.tier, ctx.book = window, tier, current_book()
        ctx.save_for_backward(q, k, v, rel_k, rel_v, lse, out,
                              *(() if lengths is None else (lengths,)))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_k, rel_v, lse, out, *lengths = ctx.saved_tensors
        with booked_to(ctx.book):  # the forward's label (a pipeline stage's)
            grads = rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout.contiguous(), out,
                                      window=ctx.window,
                                      lengths=lengths[0] if lengths else None, tier=ctx.tier)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None, None)


def trainable_rel_attention(
    q: torch.Tensor,  # (B, H, L, d), pre-scaled by 1/sqrt(d)
    k: torch.Tensor,
    v: torch.Tensor,
    rel_k: torch.Tensor,  # (2w+1, d)
    rel_v: torch.Tensor,
    *,
    window: int,
    lengths: torch.Tensor | None = None,  # (B,) int
    tier: Tier = EXACT_TIER,
) -> torch.Tensor:
    """Differentiable relative-position attention: kernel A forward, kernel 4 backward,
    both at ``tier``."""
    return _TrainableRelAttention.apply(q, k, v, rel_k, rel_v, lengths, window, tier)
