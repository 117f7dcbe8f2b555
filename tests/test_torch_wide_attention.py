"""Kernels A and 4 past head_dim 128 and window 15: their plain twins against JAX's kernels.

JAX's ``flash_rel_attention`` (``vits_tpu/ops/pallas/attention.py:97-147``) and
its backward (``attention_grad.py::_flash_bwd``) take any head width ``d`` and
window ``w``: they pad only the length and use ``d`` and ``2w + 1`` as whole
block dimensions. The port's CUDA kernels take ``d`` up to 256 (two column
chunks) and ``w`` up to 32 (``ops/cuda/attention.py::MAX_HEAD_DIM``,
``MAX_WINDOW``); ``tests/test_torch_cuda.py`` holds them against these twins
on the card. Here the twins (CPU tensors) are held against the JAX kernels in
interpret mode at ``precision="highest"`` under
``jax.default_matmul_precision("highest")``, as ``test_torch_train_kernels.py``
holds them at MMS's d = 96, w = 4: ragged rows (one whole, one of length 0,
one ending mid-tile), lse included. Tolerance: that file's fp32 summation-order
noise, atol 1e-5 relative to max(1, |ref|); the gradients over each row's valid
queries and keys, a length-0 row's whole gradients exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_kernels import _assert_close
from vits_tpu.ops.pallas.attention import flash_rel_attention as jax_flash_rel_attention
from vits_tpu.ops.pallas.attention_grad import make_trainable_attention
from vits_tpu_torch.ops.cuda.attention import (
    MAX_HEAD_DIM,
    MAX_WINDOW,
    check_ceiling,
    flash_rel_attention,
)
from vits_tpu_torch.ops.cuda.attention_grad import trainable_rel_attention

torch.set_num_threads(2)

SHAPES = [(d, w) for d in (160, 192, 256) for w in (16, 32)]
L, LENGTHS = 40, [40, 0, 23]


def _inputs(d, w, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * 0.5).astype(np.float32)
            for s in ((len(LENGTHS), 2, L, d),) * 3 + ((2 * w + 1, d),) * 2]


@pytest.mark.parametrize("d,w", SHAPES)
def test_wide_attention_and_lse_match_jax_kernel(d, w):
    arrays = _inputs(d, w, d + w)
    with jax.default_matmul_precision("highest"):
        want_out, want_lse = jax_flash_rel_attention(
            *map(jnp.asarray, arrays), window=w, lengths=jnp.asarray(LENGTHS, jnp.int32),
            interpret=True, precision="highest", return_lse=True)
    out, lse = flash_rel_attention(*map(torch.tensor, arrays), window=w,
                                   lengths=torch.tensor(LENGTHS, dtype=torch.int32),
                                   return_lse=True)
    _assert_close(out, want_out, what="out")
    for b in range(len(LENGTHS)):  # per row: the length-0 row's lse is near finfo.min
        _assert_close(lse[b], want_lse[b], what=f"lse row {b}")


@pytest.mark.parametrize("d,w", SHAPES)
def test_wide_attention_grads_match_jax_kernel(d, w):
    """dq, dk, dv, drel_k, drel_v of a seeded cotangent on the valid queries."""
    arrays = _inputs(d, w, d * w)
    g0 = np.random.default_rng(d - w).standard_normal(arrays[0].shape).astype(np.float32)
    g0 *= (np.arange(L)[None, :] < np.asarray(LENGTHS)[:, None])[:, None, :, None]
    attn = make_trainable_attention(window=w, interpret=True, precision="highest")
    lens = jnp.asarray(LENGTHS, jnp.int32)
    with jax.default_matmul_precision("highest"):
        want = jax.grad(lambda *a: jnp.sum(attn(*a, lens) * g0), argnums=range(5))(
            *map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = trainable_rel_attention(*leaves, window=w,
                                  lengths=torch.tensor(LENGTHS, dtype=torch.int32))
    (out * torch.tensor(g0)).sum().backward()
    for name, leaf, ref in zip(("dq", "dk", "dv", "drel_k", "drel_v"), leaves, want):
        got, ref = leaf.grad.numpy(), np.asarray(ref)
        if got.ndim == 2:
            _assert_close(got, ref, what=name)
            continue
        for b, n in enumerate(LENGTHS):
            if n == 0:  # every p of the row is 0: so is each gradient
                assert not np.any(got[b]), name
                _assert_close(got[b], ref[b], what=f"{name} row {b}")
            else:
                _assert_close(got[b, :, :n], ref[b, :, :n], what=f"{name} row {b}")


@pytest.mark.parametrize("d,w,ok", [(MAX_HEAD_DIM, MAX_WINDOW, True), (1, 0, True),
                                    (MAX_HEAD_DIM + 1, 4, False), (96, MAX_WINDOW + 1, False),
                                    (0, 4, False), (96, -1, False)])
def test_kernel_ceiling_is_stated(d, w, ok):
    """The kernels take head_dim 1-256 and window 0-32; past that the wrappers raise
    with the numbers (on a CUDA tensor, before any launch)."""
    if ok:
        check_ceiling("rel_attention", d, w)
        return
    with pytest.raises(ValueError, match=f"head_dim {d}, window {w}"):
        check_ceiling("rel_attention", d, w)
