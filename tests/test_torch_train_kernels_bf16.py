"""The bf16 training tier of kernels 4 and 5: their plain twins against the JAX package.

The twins are what CPU tensors take, and what ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the kernels to on the card.

Kernel 5 (``ops/cuda/trio_grad.py``) at ``BF16_TRAIN_TIER`` computes what
JAX's bf16 training runs on a wide stage: its plain resblocks and their mean
in XLA's bf16 graph (``vits_tpu/models/hifigan.py:29-57, 425-434``; the trio
kernel needs fp32 there). Against eager JAX the value agrees within TWIN_ULPS
bf16 ulps of its scale (the same rounding after every op, fp32 sums inside
each conv); the VJP within VJP_RTOL relative L2 per tensor: it sums the
cotangents that fan in to one activation (the residual and the conv path,
the blocks' shares of x) in bf16, in another order than XLA's transpose.
``make_trainable_trio`` refuses bf16 storage (its kernel compares a bf16
array with an fp32 one), so it gets the same bf16 values in fp32 storage and
computes in fp32: against it the twin is off by bf16 rounding, KERNEL_RTOL
relative L2 per tensor.

Kernel 4 (``ops/cuda/attention_grad.py``) on bf16 storage, against
``make_trainable_attention`` on bf16 inputs in interpret mode (the JAX kernels
upcast to fp32; on the CPU its default precision multiplies in fp32): at the
exact tier the twin is the same computation, every output within TWIN_ULPS
bf16 ulps of its scale; at the fast tier (bf16 products, the training tier
on the card) within FAST_RTOL relative L2. The
differentiable function runs both twins under autograd on bf16 leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.models.hifigan import _resblock as jax_resblock
from vits_tpu.ops.pallas.attention_grad import make_trainable_attention
from vits_tpu.ops.pallas.trio_grad import make_trainable_trio
from vits_tpu_torch.ops.cuda.attention import rel_attention_plain
from vits_tpu_torch.ops.cuda.attention_grad import (
    rel_attention_bwd_reference,
    trainable_rel_attention,
)
from vits_tpu_torch.ops.cuda.resblock import pair_weights
from vits_tpu_torch.ops.cuda.trio_grad import (
    flat_acts,
    trainable_trio,
    trio_backward_reference,
    trio_forward_with_acts_reference,
)
from vits_tpu_torch.ops.tiers import BF16_TRAIN_TIER, EXACT_TIER

torch.set_num_threads(2)

TWIN_ULPS = 1.0
VJP_RTOL = 2e-2  # measured: dx 0.003, dW <= 0.0006, db <= 0.0099 (bf16 bias sums)
KERNEL_RTOL = 5e-2  # measured 0.0017-0.027
FAST_RTOL = 2e-2  # measured 0.002-0.0035
ULP = 2.0**-8  # bf16's spacing relative to a value's binade
SLOPE = 0.1
METAS = ((3, (1, 3)), (5, (1, 3)))  # (kernel size, dilations) per block
C, T, B = 128, 24, 2


def _bf16(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(jnp.bfloat16)


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _f64(a) -> np.ndarray:
    return np.asarray(a.float().numpy() if torch.is_tensor(a) else np.asarray(a, np.float32),
                      np.float64)


def _within_ulps(got, want, what: str, ulps: float = TWIN_ULPS) -> None:
    g, w = _f64(got), _f64(want)
    assert g.shape == w.shape, what
    err = float(np.abs(g - w).max())
    assert err <= ulps * ULP * max(1.0, float(np.abs(w).max())), f"{what}: max|diff| {err:.3e}"


def _rel_l2(got, want, what: str, rtol: float) -> None:
    g, w = _f64(got), _f64(want)
    err = float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    assert err <= rtol, f"{what}: relative L2 {err:.3e} > {rtol}"


@pytest.fixture(scope="module")
def trio_case():
    rng = np.random.default_rng(11)
    weights = []  # per block (w1, b1, w2, b2), stacked over pairs, bf16
    for k, dil in METAS:
        n = len(dil)
        weights.append((_bf16(rng, (n, k, C, C), 0.05), _bf16(rng, (n, C), 0.1),
                        _bf16(rng, (n, k, C, C), 0.05), _bf16(rng, (n, C), 0.1)))
    x = _bf16(rng, (B, T, C))
    g = _bf16(rng, (B, T, C))
    blocks = [dict(kernel_size=k, dilations=dil,
                   **{name: [_t(w[i]) for i in range(len(dil))]
                      for name, w in zip(("w1", "b1", "w2", "b2"), ws)})
              for (k, dil), ws in zip(METAS, weights)]
    return x, g, weights, blocks


def _jax_plain_trio(x, weights):
    """JAX's bf16 training on a wide stage: the plain resblocks, summed, / count."""
    total = None
    for (k, dil), (w1, b1, w2, b2) in zip(METAS, weights):
        p = {}
        for i in range(len(dil)):
            p.update({f"convs1.{i}.weight": w1[i], f"convs1.{i}.bias": b1[i],
                      f"convs2.{i}.weight": w2[i], f"convs2.{i}.bias": b2[i]})
        out = jax_resblock(JaxParamView(p), x, None, k, dil, SLOPE)
        total = out if total is None else total + out
    return total / len(METAS)


def _twin(x, g, blocks):
    out, acts = trio_forward_with_acts_reference(_t(x), blocks, slope=SLOPE)
    dx, dweights = trio_backward_reference(_t(g), _t(x), blocks, flat_acts(acts), slope=SLOPE)
    return out, dx, dweights


def _jax_grads_by_pair(weight_grads):
    """JAX's per-block (dw1, db1, dw2, db2) stacks -> pair_weights order."""
    return [t[i] for (_, dil), ws in zip(METAS, weight_grads) for i in range(len(dil))
            for t in ws]


def test_trio_twin_bf16_matches_jax_plain_resblocks(trio_case):
    x, g, weights, blocks = trio_case
    jx, jg = jnp.asarray(x), jnp.asarray(g)
    want, vjp = jax.vjp(_jax_plain_trio, jx, weights)
    want_dx, want_dw = vjp(jg)
    out, dx, dweights = _twin(x, g, blocks)
    assert out.dtype == dx.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in dweights)
    _within_ulps(out, want, "value")
    _rel_l2(dx, want_dx, "dx", VJP_RTOL)
    for i, (got, exp) in enumerate(zip(dweights, _jax_grads_by_pair(want_dw))):
        _rel_l2(got, exp, f"weight grad {i}", VJP_RTOL)


def test_trio_twin_bf16_near_jax_trio_kernel(trio_case):
    """make_trainable_trio in interpret mode on the bf16 values in fp32 storage."""
    x, g, weights, blocks = trio_case
    metas = [{"kernel_size": k, "dilations": dil} for k, dil in METAS]
    fn = make_trainable_trio(metas, slope=SLOPE, tile_t=T, interpret=True)
    f32 = [tuple(jnp.asarray(w, jnp.float32) for w in ws) for ws in weights]
    want, vjp = jax.vjp(fn, jnp.asarray(x, jnp.float32), tuple(f32))
    want_dx, want_dw = vjp(jnp.asarray(g, jnp.float32))
    out, dx, dweights = _twin(x, g, blocks)
    _rel_l2(out, want, "value", KERNEL_RTOL)
    _rel_l2(dx, want_dx, "dx", KERNEL_RTOL)
    for i, (got, exp) in enumerate(zip(dweights, _jax_grads_by_pair(want_dw))):
        _rel_l2(got, exp, f"weight grad {i}", KERNEL_RTOL)


def test_trainable_trio_bf16_runs_the_twins_under_autograd(trio_case):
    x, g, _, blocks = trio_case
    xt = _t(x).requires_grad_()
    leaves = [xt] + [w.requires_grad_() for w in pair_weights(blocks)]
    out = trainable_trio(xt, blocks, slope=SLOPE, tier=BF16_TRAIN_TIER)
    grads = torch.autograd.grad(out, leaves, _t(g))
    want_out, want_dx, want_dw = _twin(x, g, blocks)
    assert torch.equal(out, want_out) and torch.equal(grads[0], want_dx)
    assert all(torch.equal(a, b) for a, b in zip(grads[1:], want_dw))
    with pytest.raises(ValueError, match="bfloat16"):
        trainable_trio(xt.float(), blocks, slope=SLOPE, tier=BF16_TRAIN_TIER)


H, L, D, W = 2, 40, 16, 4


@pytest.fixture(scope="module")
def attention_case():
    rng = np.random.default_rng(12)
    q, k, v, dout = (_bf16(rng, (2, H, L, D), 0.5) for _ in range(4))
    rel_k, rel_v = (_bf16(rng, (2 * W + 1, D), 0.5) for _ in range(2))
    lengths = np.array([L, 29], np.int32)
    fn = make_trainable_attention(window=W, interpret=True)
    args = tuple(jnp.asarray(a) for a in (q, k, v, rel_k, rel_v))
    want, vjp = jax.vjp(lambda *a: fn(*a, jnp.asarray(lengths)), *args)
    return (q, k, v, rel_k, rel_v, dout, lengths), want, vjp(jnp.asarray(dout))


def _attention_twins(case, tier):
    q, k, v, rel_k, rel_v, dout, lengths = (torch.tensor(np.asarray(a, np.float32))
                                            for a in case)
    q, k, v, rel_k, rel_v, dout = (t.to(torch.bfloat16) for t in (q, k, v, rel_k, rel_v, dout))
    lens = lengths.to(torch.int32)
    out, lse = rel_attention_plain(q, k, v, rel_k, rel_v, window=W, lengths=lens,
                                   return_lse=True, tier=tier)
    grads = rel_attention_bwd_reference(q, k, v, rel_k, rel_v, lse, dout, out, window=W,
                                        lengths=lens, tier=tier)
    return out, grads


def _valid(t, lengths):
    """Each row's queries up to its length: past it JAX's padding queries attend
    with the finfo.min weights of their own, which the backward's dq keeps."""
    return [np.asarray(t[b, :, :n], np.float32) for b, n in enumerate(lengths)]


def test_attention_twins_bf16_match_jax_kernels_exact_tier(attention_case):
    case, want, want_grads = attention_case
    out, grads = _attention_twins(case, EXACT_TIER)
    assert out.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    _within_ulps(out, want, "out")
    for name, got, exp in zip(("dq", "dk", "dv", "drel_k", "drel_v"), grads, want_grads):
        _within_ulps(got, exp, name)


def test_attention_twins_bf16_fast_tier_near_jax_kernels(attention_case):
    case, want, want_grads = attention_case
    out, grads = _attention_twins(case, BF16_TRAIN_TIER)
    _rel_l2(out, want, "out", FAST_RTOL)
    for name, got, exp in zip(("dq", "dk", "dv", "drel_k", "drel_v"), grads, want_grads):
        _rel_l2(got, exp, name, FAST_RTOL)


def test_trainable_attention_bf16_under_autograd(attention_case):
    case, _, _ = attention_case
    q, k, v, rel_k, rel_v, dout, lengths = (torch.tensor(np.asarray(a, np.float32))
                                            for a in case)
    leaves = [t.to(torch.bfloat16).requires_grad_() for t in (q, k, v, rel_k, rel_v)]
    out = trainable_rel_attention(*leaves, window=W, lengths=lengths.to(torch.int32),
                                  tier=BF16_TRAIN_TIER)
    grads = torch.autograd.grad(out, leaves, dout.to(torch.bfloat16))
    want_out, want_grads = _attention_twins(case, BF16_TRAIN_TIER)
    assert torch.equal(out, want_out)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
