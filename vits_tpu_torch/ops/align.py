"""Monotonic Alignment Search (MAS) and the prior log-likelihood it searches.

Counterpart of ``vits_tpu/ops/align.py``: the Viterbi forward pass is a
Python loop over frames, vectorised over batch and tokens, and the backtrace
a second loop over the recorded choices. Plain PyTorch (the JAX package runs
it in XLA, not a TPU kernel). The contract points, kept exactly: the ``>=``
tie-break toward the diagonal move, the finite ``-1e9`` of invalid cells, and
a backtrace that holds each padded frame at its row's last token.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e9


@torch.no_grad()
def monotonic_align(
    log_likelihood: torch.Tensor,  # (B, S_frames, T_tokens)
    frame_mask: torch.Tensor,  # (B, S_frames) 1/0
    token_mask: torch.Tensor,  # (B, T_tokens) 1/0
) -> torch.Tensor:
    """Best monotonic path -> one-hot alignment (B, S_frames, T_tokens), no gradient."""
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
        take_diag = choices[s - 1][rows, t_here].to(torch.int64)
        t_cur = torch.where(s <= s_len - 1, t_here - take_diag, t_here)
    path[:, 0] = t_cur

    attn = torch.nn.functional.one_hot(path, T).to(log_likelihood.dtype)
    return attn * frame_mask[..., None] * token_mask[:, None, :]


def prior_log_likelihood(
    latents: torch.Tensor,  # (B, S, C) z_p
    prior_means: torch.Tensor,  # (B, T, C)
    prior_log_stddev: torch.Tensor,  # (B, T, C)
) -> torch.Tensor:
    """log N(z_p[s]; mu[t], sigma[t]) summed over channels -> (B, S, T), as four matmuls."""
    const = -0.5 * math.log(2 * math.pi)
    inv_var = torch.exp(-2.0 * prior_log_stddev)
    term1 = torch.sum(const - prior_log_stddev - 0.5 * inv_var * prior_means**2, dim=-1)
    # bf16 prior stats (bf16 training): the products in bf16, the matmuls in the
    # latents' fp32, as JAX promotes them
    term2 = torch.einsum("bsc,btc->bst", latents, (inv_var * prior_means).to(latents.dtype))
    term3 = torch.einsum("bsc,btc->bst", -0.5 * latents**2, inv_var.to(latents.dtype))
    return term1[:, None, :] + term2 + term3
