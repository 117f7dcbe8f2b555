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
"""

from __future__ import annotations

import torch

from vits_tpu_torch.ops.attention import (
    absolute_position_to_relative_position,
    get_relative_embeddings,
    relative_position_to_absolute_position,
)
from vits_tpu_torch.ops.cuda import (
    check,
    count_launch,
    cuda_lengths,
    library,
    on_cuda,
    stream_of,
)
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_scores

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


def rel_attention_bwd_terms(q, k, v, rel_k, rel_v, lse, dout, out, *, window, lengths):
    """Plain PyTorch: the (B*H, L, L) probabilities p and ds = p (dp - D) that the
    backward rebuilds from lse; p is exactly 0 for keys at or past a row's length."""
    B, H, L, d = q.shape
    dof, vf = dout.reshape(B * H, L, d), v.reshape(B * H, L, d)
    s = rel_attention_scores(q, k, rel_k, window)
    keep = torch.ones((B, L), dtype=torch.bool, device=q.device) if lengths is None else \
        torch.arange(L, device=q.device)[None, :] < lengths[:, None]
    keep = keep[:, None, None, :].expand(B, H, L, L).reshape(B * H, L, L)
    p = torch.where(keep, torch.exp(s - lse.reshape(B * H, L, 1)), torch.zeros_like(s))
    value_rel = get_relative_embeddings(rel_v[None], L, window)[0]  # (2L-1, d)
    dp = torch.bmm(dof, vf.transpose(1, 2)) + relative_position_to_absolute_position(
        torch.einsum("bqd,rd->bqr", dof, value_rel))
    drow = (dout * out).sum(dim=-1).reshape(B * H, L, 1)
    return p, p * (dp - drow)


def rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out, *, window, lengths):
    """Plain PyTorch: (dq, dk, dv, drel_k, drel_v) with the kernel's math, full matrices."""
    B, H, L, d = q.shape
    qf, kf, dof = (t.reshape(B * H, L, d) for t in (q, k, dout))
    p, ds = rel_attention_bwd_terms(q, k, v, rel_k, rel_v, lse, dout, out, window=window,
                                    lengths=lengths)
    key_rel = get_relative_embeddings(rel_k[None], L, window)[0]
    ds_rel = absolute_position_to_relative_position(ds)  # (B*H, L, 2L-1)
    p_rel = absolute_position_to_relative_position(p)
    dq = torch.bmm(ds, kf) + ds_rel @ key_rel
    dk = torch.bmm(ds.transpose(1, 2), qf)
    dv = torch.bmm(p.transpose(1, 2), dof)
    drk = _rel_table_grad(torch.einsum("bim,bid->bmd", ds_rel, qf), L, window)
    drv = _rel_table_grad(torch.einsum("bim,bid->bmd", p_rel, dof), L, window)
    shape4 = (B, H, L, d)
    return dq.reshape(shape4), dk.reshape(shape4), dv.reshape(shape4), drk, drv


def rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout, out, *, window, lengths):
    """(dq, dk, dv, drel_k, drel_v) of :func:`flash_rel_attention` given its lse.

    CPU tensors take :func:`rel_attention_bwd_reference`; CUDA tensors launch
    the kernel (fp32, contiguous, as kernel A takes them) or raise.
    """
    if not on_cuda("rel_attention_bwd", q, k, v, rel_k, rel_v, lse, dout, out):
        return rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out,
                                           window=window, lengths=lengths)
    B, H, L, d = q.shape
    nr = 2 * window + 1
    for t in (k, v, dout, out):
        if t.shape != q.shape:
            raise ValueError(f"rel_attention_bwd: shape {tuple(t.shape)} != {tuple(q.shape)}")
    if lse.shape != (B, H, L) or rel_k.shape != (nr, d) or rel_v.shape != (nr, d):
        raise ValueError(f"rel_attention_bwd: lse {tuple(lse.shape)} or rel tables "
                         f"{tuple(rel_k.shape)}, {tuple(rel_v.shape)} do not fit ({B}, {H}, {L}, {d})")
    lens = cuda_lengths(lengths, B, L, q.device)
    drow = (dout * out).sum(dim=-1).contiguous()  # D, outside the kernel as in JAX
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    tiles = -(-L // _TILE)
    drk_part = torch.empty((B, H, tiles, nr, d), dtype=torch.float32, device=q.device)
    drv_part = torch.empty_like(drk_part)
    check(library().vk_rel_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_k.data_ptr(), rel_v.data_ptr(),
        lens.data_ptr(), lse.data_ptr(), drow.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drk_part.data_ptr(), drv_part.data_ptr(),
        B, H, L, d, window, stream_of(q)), "rel_attention backward kernel")
    count_launch(rel_attention_bwd)
    return dq, dk, dv, drk_part.sum(dim=(0, 1, 2)), drv_part.sum(dim=(0, 1, 2))


rel_attention_bwd.launches = 0


class _TrainableRelAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, rel_k, rel_v, lengths, window):
        out, lse = flash_rel_attention(q, k, v, rel_k, rel_v, window=window, lengths=lengths,
                                       return_lse=True)
        ctx.window = window
        ctx.save_for_backward(q, k, v, rel_k, rel_v, lse, out,
                              *(() if lengths is None else (lengths,)))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_k, rel_v, lse, out, *lengths = ctx.saved_tensors
        grads = rel_attention_bwd(q, k, v, rel_k, rel_v, lse, dout.contiguous(), out,
                                  window=ctx.window, lengths=lengths[0] if lengths else None)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def trainable_rel_attention(
    q: torch.Tensor,  # (B, H, L, d), pre-scaled by 1/sqrt(d)
    k: torch.Tensor,
    v: torch.Tensor,
    rel_k: torch.Tensor,  # (2w+1, d)
    rel_v: torch.Tensor,
    *,
    window: int,
    lengths: torch.Tensor | None = None,  # (B,) int
) -> torch.Tensor:
    """Differentiable relative-position attention: kernel A forward, kernel 4 backward."""
    return _TrainableRelAttention.apply(q, k, v, rel_k, rel_v, lengths, window)
