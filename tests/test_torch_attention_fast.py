"""Kernel A's plain twin at the ``fast`` tier against the JAX kernel's own arithmetic.

The Pallas kernel (``vits_tpu/ops/pallas/attention.py:46-88``) rounds the
operands of each dot at the fast tier (one bf16 pass, fp32 sums): q and k,
q and the rel-key table, the UNNORMALISED weights ``p = exp(s - m)`` and v,
and the normalised rel weights and the rel-value table. The port's twin
(``vits_tpu_torch/ops/cuda/attention.py::rel_attention_reference``) rounds
the NORMALISED weights before the value product. JAX on the CPU computes the
kernel's DEFAULT-precision dots on fp32 values in full fp32, so the tier's
arithmetic is built here in jax.numpy with every dot's operands cast to bf16
explicitly, at one key chunk (``tile_k=512`` covers L <= 512, so ``m`` is the
row's maximum and ``p`` is computed once).

Measured on these inputs: the twin at fast sits at 0.15-0.19 of the twin at
exact's relative L2 distance from that arithmetic (max |diff| 0.0064-0.0073
against 0.068-0.127). So the twin's rounding point is the nearer one and stays:
held here at TWIN_SHARE of the exact distance and within TWIN_ATOL.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu_torch.ops.cuda.attention import rel_attention_plain
from vits_tpu_torch.ops.tiers import EXACT_TIER, FAST, Tier

torch.set_num_threads(2)

TWIN_SHARE = 0.25  # relative L2 to the kernel's arithmetic, as a share of exact's
TWIN_ATOL = 0.02  # max |twin at fast - the kernel's arithmetic at fast|


@functools.partial(jax.jit, static_argnames="window")
def jax_kernel_fast(q, k, v, rel_k, rel_v, window: int, lengths):
    """The Pallas kernel's output at the fast tier, one key chunk (L <= 512)."""
    bf16, f32 = jnp.bfloat16, jnp.float32

    def dot(spec, a, b):  # bf16 operands, exact products, fp32 sums
        return jnp.einsum(spec, a.astype(bf16), b.astype(bf16), preferred_element_type=f32)

    L = q.shape[2]
    assert L <= 512
    neg = float(jnp.finfo(f32).min)
    q, k, v = (jnp.asarray(a, f32) for a in (q, k, v))
    rl = dot("bhqd,rd->bhqr", q, jnp.asarray(rel_k))
    delta = jnp.arange(L)[None, :] - jnp.arange(L)[:, None]  # key j - query i
    s = dot("bhqd,bhkd->bhqk", q, k)
    for r in range(2 * window + 1):
        s = s + jnp.where(delta == r - window, rl[..., r:r + 1], 0.0)
    valid = jnp.arange(L)[None, :] < jnp.asarray(lengths)[:, None]
    s = s + jnp.where(valid, 0.0, neg)[:, None, None, :]
    m = jnp.max(s, axis=-1, keepdims=True)
    p = jnp.exp(s - m)
    inv_l = 1.0 / jnp.sum(p, axis=-1, keepdims=True)
    acc = dot("bhqk,bhkd->bhqd", p, v)
    racc = jnp.stack([jnp.sum(jnp.where(delta == r - window, p, 0.0), axis=-1)
                      for r in range(2 * window + 1)], axis=-1)
    return acc * inv_l + dot("bhqr,rd->bhqd", racc * inv_l, jnp.asarray(rel_v))


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("B,H,L,d,window,lengths", [
    (2, 2, 87, 96, 4, (87, 40)),  # MMS-TTS's heads, the 87-token request
    (1, 2, 300, 96, 4, (300,)),
    (2, 2, 64, 192, 16, (64, 30)),
])
def test_fast_twin_is_nearer_the_kernel_arithmetic_than_exact(B, H, L, d, window, lengths):
    rng = np.random.default_rng(L)
    q = (3 * rng.standard_normal((B, H, L, d)) / np.sqrt(d)).astype(np.float32)
    k = (3 * rng.standard_normal((B, H, L, d))).astype(np.float32)
    v = rng.standard_normal((B, H, L, d)).astype(np.float32)
    rel_k, rel_v = (rng.standard_normal((2 * window + 1, d)).astype(np.float32)
                    for _ in range(2))
    want = np.asarray(jax_kernel_fast(q, k, v, rel_k, rel_v, window, np.asarray(lengths)))
    args = [torch.tensor(a) for a in (q, k, v, rel_k, rel_v)]
    kw = dict(window=window, lengths=torch.tensor(lengths))
    fast = rel_attention_plain(*args, tier=Tier(FAST), **kw).numpy()
    exact = rel_attention_plain(*args, tier=EXACT_TIER, **kw).numpy()
    near, far = _rel_l2(fast, want), _rel_l2(exact, want)
    print(f"twin at fast {near:.3e} (max {np.abs(fast - want).max():.3e}), "
          f"at exact {far:.3e} (max {np.abs(exact - want).max():.3e})")
    assert near <= TWIN_SHARE * far
    assert np.abs(fast - want).max() <= TWIN_ATOL
