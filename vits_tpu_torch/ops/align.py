"""Monotonic Alignment Search (MAS) and the prior log-likelihood it searches.

Counterpart of ``vits_tpu/ops/align.py``. :func:`monotonic_align` is the
kernel's wrapper, ``ops/cuda/align.py``: the port of JAX's hot-path
``lax.scan`` to one CUDA launch on the card, the Python loop over frames
(``monotonic_align_reference``) on the CPU.
"""

from __future__ import annotations

import math

import torch

from vits_tpu_torch.ops.cuda.align import monotonic_align  # noqa: F401  (re-exported)


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
