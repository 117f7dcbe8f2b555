"""The port's training kernels against the JAX package's Pallas kernels.

Kernel A with its logsumexp output (``ops/cuda/attention.py``), the
attention backward behind its autograd Function (kernel 4,
``ops/cuda/attention_grad.py``) and the trainable resblock trio (kernel 5,
``ops/cuda/trio_grad.py``) take their plain PyTorch versions on CPU tensors;
here each is held against the JAX function it replaces, run in interpret mode
at ``precision="highest"`` under ``jax.default_matmul_precision("highest")``
(as ``tests/test_trainable_attention.py`` and ``tests/test_trio_grad.py`` run
them), on the same seeded numpy inputs. Tolerance: fp32 summation-order
noise, atol 1e-5 relative to max(1, |ref|).

``tests/test_torch_cuda.py`` holds each CUDA kernel against its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.ops.pallas.attention import flash_rel_attention as jax_flash_rel_attention
from vits_tpu.ops.pallas.attention_grad import make_trainable_attention, xla_rel_attention
from vits_tpu.ops.pallas.trio_grad import make_trainable_trio
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
from vits_tpu_torch.ops.cuda.attention_grad import trainable_rel_attention
from vits_tpu_torch.ops.cuda.resblock import pair_weights
from vits_tpu_torch.ops.conv import conv1d, leaky_relu
from vits_tpu_torch.ops.cuda.trio_grad import (
    WGRAD_FRAMES,
    flat_acts,
    flip_transpose,
    trainable_trio,
    trio_backward,
    trio_forward_with_acts,
)

torch.set_num_threads(2)

ATOL = 1e-5
SLOPE = 0.1


def _assert_close(got, want, atol=ATOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=what)


def _attention_inputs(B, H, L, d, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, L, d),) * 3 + ((2 * w + 1, d),) * 2]


def test_attention_lse_matches_jax_kernel():
    """Kernel A's out and lse vs flash_rel_attention(return_lse=True), a length-0 row."""
    w, lengths = 4, [40, 0, 1]
    arrays = _attention_inputs(3, 2, 40, 16, w, 0)
    with jax.default_matmul_precision("highest"):
        want_out, want_lse = jax_flash_rel_attention(
            *map(jnp.asarray, arrays), window=w, lengths=jnp.asarray(lengths, jnp.int32),
            interpret=True, precision="highest", return_lse=True)
    out, lse = flash_rel_attention(*map(torch.tensor, arrays), window=w,
                                   lengths=torch.tensor(lengths, dtype=torch.int32),
                                   return_lse=True)
    _assert_close(out, want_out, what="out")
    assert bool(torch.isfinite(lse).all())
    for b in range(len(lengths)):  # per row: the length-0 row's lse is near finfo.min
        _assert_close(lse[b], want_lse[b], what=f"lse row {b}")


@pytest.mark.parametrize("L,lengths", [(16, [16, 11]), (40, [40, 23]), (40, None),
                                       (40, [37, 0])])
def test_attention_grads_match_jax(L, lengths):
    """dq, dk, dv, drel_k, drel_v vs the Pallas backward and vs jax.grad of the XLA math;
    one (L=16) and several (L=40) 16-query tiles; valid region only, and a length-0
    row's whole gradients, exactly 0."""
    B, H, d, w = 2, 2, 8, 4
    arrays = _attention_inputs(B, H, L, d, w, L)
    g0 = np.random.default_rng(L + 1).standard_normal((B, H, L, d)).astype(np.float32)
    lens = None
    if lengths is not None:  # cotangents only from valid queries, as in the masked encoder
        g0 *= (np.arange(L)[None, :] < np.asarray(lengths)[:, None])[:, None, :, None]
        lens = jnp.asarray(lengths, jnp.int32)
    attn = make_trainable_attention(window=w, tile_q=16, tile_k=16, interpret=True,
                                    precision="highest")
    args = tuple(map(jnp.asarray, arrays))
    with jax.default_matmul_precision("highest"):
        want_pallas = jax.grad(lambda *a: jnp.sum(attn(*a, lens) * g0), argnums=range(5))(*args)
        want_xla = jax.grad(lambda *a: jnp.sum(xla_rel_attention(*a, w, lens) * g0),
                            argnums=range(5))(*args)
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = trainable_rel_attention(*leaves, window=w, lengths=None if lengths is None
                                  else torch.tensor(lengths, dtype=torch.int32))
    (out * torch.tensor(g0)).sum().backward()
    names = ("dq", "dk", "dv", "drel_k", "drel_v")
    for name, leaf, wp, wx in zip(names, leaves, want_pallas, want_xla):
        got, wp, wx = leaf.grad.numpy(), np.asarray(wp), np.asarray(wx)
        if got.ndim == 4 and lengths is not None:
            for b, n in enumerate(lengths):
                if n == 0:  # every p of the row is 0: so is each gradient
                    assert not np.any(got[b]), name
                    _assert_close(got[b], wp[b], what=name)
                    continue
                _assert_close(got[b, :, :n], wp[b, :, :n], what=name)
                _assert_close(got[b, :, :n], wx[b, :, :n], what=name)
        else:
            _assert_close(got, wp, what=name)
            _assert_close(got, wx, what=name)


METAS = [{"kernel_size": 3, "dilations": (1, 3)}, {"kernel_size": 5, "dilations": (1, 2)}]


def test_trainable_trio_matches_jax():
    """Forward, saved activations' use and grads for x and every weight vs
    make_trainable_trio; T = 40 is not a multiple of the tile (16)."""
    rng = np.random.default_rng(0)
    C, T = 8, 40
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    weights = [tuple((rng.standard_normal(s) * 0.1).astype(np.float32) for s in (
        (len(m["dilations"]), m["kernel_size"], C, C), (len(m["dilations"]), C)) * 2)
        for m in METAS]
    g = rng.standard_normal((2, T, C)).astype(np.float32)
    f = make_trainable_trio(METAS, slope=SLOPE, tile_t=16, interpret=True, precision="highest")
    with jax.default_matmul_precision("highest"):
        want_out = f(jnp.asarray(x), tuple(tuple(map(jnp.asarray, b)) for b in weights))
        want_grads = jax.grad(lambda x, w: jnp.sum(f(x, w) * g), argnums=(0, 1))(
            jnp.asarray(x), tuple(tuple(map(jnp.asarray, b)) for b in weights))

    tx = torch.tensor(x, requires_grad=True)
    tw = [[torch.tensor(a, requires_grad=True) for a in b] for b in weights]
    blocks = [dict(kernel_size=m["kernel_size"], dilations=m["dilations"],
                   w1=list(b[0]), b1=list(b[1]), w2=list(b[2]), b2=list(b[3]))
              for m, b in zip(METAS, tw)]
    out = trainable_trio(tx, blocks, slope=SLOPE)
    _assert_close(out.detach(), want_out, what="forward")
    (out * torch.tensor(g)).sum().backward()
    _assert_close(tx.grad, want_grads[0], what="dx")
    for m, block, jblock in zip(METAS, tw, want_grads[1]):
        for name, leaf, want in zip(("w1", "b1", "w2", "b2"), block, jblock):
            _assert_close(leaf.grad, want, what=f"k={m['kernel_size']} {name}")

    with torch.no_grad():
        _, acts = trio_forward_with_acts(tx, blocks, slope=SLOPE)
    for m, (y1s, xs) in zip(METAS, acts):  # pairs y1s and pairs - 1 saved inputs per block
        assert len(y1s) == len(m["dilations"]) and len(xs) == len(m["dilations"]) - 1


def test_trio_backward_honours_needs_input_grad():
    """With x constant the backward skips dx and gives the same weight grads."""
    rng = np.random.default_rng(1)
    C, T = 8, 24
    x = torch.tensor(rng.standard_normal((2, T, C)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((2, T, C)), dtype=torch.float32)
    blocks = [dict(kernel_size=m["kernel_size"], dilations=m["dilations"], **{
        n: [torch.tensor(rng.standard_normal(s) * 0.1, dtype=torch.float32, requires_grad=True)
            for _ in m["dilations"]]
        for n, s in (("w1", (m["kernel_size"], C, C)), ("b1", (C,)),
                     ("w2", (m["kernel_size"], C, C)), ("b2", (C,)))}) for m in METAS]
    with torch.no_grad():
        _, acts = trio_forward_with_acts(x, blocks, slope=SLOPE)
        dx, full = trio_backward(g, x, blocks, flat_acts(acts), slope=SLOPE)
        no_dx, weights_only = trio_backward(g, x, blocks, flat_acts(acts), slope=SLOPE,
                                            need_x=False)
    assert dx is not None and no_dx is None
    for a, b in zip(full, weights_only):
        assert torch.equal(a, b)
    leaves = pair_weights(blocks)
    got = torch.autograd.grad((trainable_trio(x, blocks, slope=SLOPE) * g).sum(), leaves)
    for a, b in zip(got, full):
        assert torch.equal(a, b)


def _shifted(a, shift):
    """a[b, t + shift] where 0 <= t + shift < T, else 0."""
    out, T = torch.zeros_like(a), a.shape[1]
    if shift >= 0:
        out[:, : max(0, T - shift)] = a[:, shift:]
    else:
        out[:, -shift:] = a[:, : T + shift]
    return out


def _split_sum(rows, split):
    """sum over frames of rows(frame slice), as the weight-gradient kernel adds it:
    32-frame steps, each rank of the cluster its ceil(steps / split) contiguous
    steps summed one step at a time, then the ranks in order 0, 1, ..."""
    F = rows.frames
    steps = -(-F // WGRAD_FRAMES)
    per = -(-steps // split)
    assert (split - 1) * per < steps  # every rank has frames
    total = None
    for r in range(split):
        part = None
        for s in range(r * per, min(steps, (r + 1) * per)):
            term = rows(slice(s * WGRAD_FRAMES, min(F, (s + 1) * WGRAD_FRAMES)))
            part = term if part is None else part + term
        total = part if total is None else total + part
    return total


def _wgrad_decomposed(a, dy, k, dil, split):
    """(dW (k, C_in, C_out), db): per tap leaky(a) shifted by tap * dil - pad, times dy,
    summed over the B*T frames in the kernel's chunks and order."""
    B, T, C = a.shape
    pad = dil * (k - 1) // 2
    dyf = dy.reshape(B * T, -1)

    class Rows:
        frames = B * T

        def __init__(self, fn):
            self.fn = fn

        def __call__(self, sl):
            return self.fn(sl)

    dw = []
    for tap in range(k):
        af = _shifted(leaky_relu(a, SLOPE), tap * dil - pad).reshape(B * T, C)
        dw.append(_split_sum(Rows(lambda sl, af=af: af[sl].T @ dyf[sl]), split))
    return torch.stack(dw), _split_sum(Rows(lambda sl: dyf[sl].sum(0)), split)


def _trio_backward_decomposed(g, x, blocks, saved, split, need_x):
    """Kernel 5's backward as the kernels compute it, in plain PyTorch: input
    gradients as forward convs with flip_transpose(w) and leaky's derivative, weight
    gradients by :func:`_wgrad_decomposed`."""
    def leaky_grad(v):
        return torch.where(v >= 0, 1.0, SLOPE)

    dx_total, dweights, pos = None, [], 0
    for blk in blocks:
        k, dils = blk["kernel_size"], blk["dilations"]
        n = len(dils)
        y1s, xs = saved[pos: pos + n], saved[pos + n: pos + 2 * n - 1]
        pos += 2 * n - 1
        grads = [None] * (4 * n)
        dx = g * (1.0 / len(blocks))
        for i in reversed(range(n)):
            d, x_in, y1 = dils[i], (x if i == 0 else xs[i - 1]), y1s[i]
            dw2, db2 = _wgrad_decomposed(y1, dx, k, 1, split)
            dy1 = conv1d(dx, flip_transpose(blk["w2"][i]), None, padding=(k - 1) // 2)
            dy1 = dy1 * leaky_grad(y1)
            dw1, db1 = _wgrad_decomposed(x_in, dy1, k, d, split)
            grads[4 * i: 4 * i + 4] = [dw1, db1, dw2, db2]
            if i > 0 or need_x:
                dh = conv1d(dy1, flip_transpose(blk["w1"][i]), None, padding=d * (k - 1) // 2,
                            dilation=d)
                dx = dx + dh * leaky_grad(x_in)
        dweights += grads
        if need_x:
            dx_total = dx if dx_total is None else dx_total + dx
    return dx_total, dweights


@pytest.mark.parametrize("k,dilation", [(3, 1), (7, 3), (11, 5)])
def test_flip_transpose_is_the_input_gradient(k, dilation):
    """conv1d(dy, flip_transpose(w)) is conv1d's input gradient from autograd."""
    rng = np.random.default_rng(k)
    h = torch.tensor(rng.standard_normal((2, 37, 8)), dtype=torch.float32, requires_grad=True)
    w = torch.tensor(rng.standard_normal((k, 8, 12)) * 0.2, dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((2, 37, 12)), dtype=torch.float32)
    pad = dilation * (k - 1) // 2
    (want,) = torch.autograd.grad((conv1d(h, w, None, padding=pad, dilation=dilation) * dy).sum(),
                                  h)
    got = conv1d(dy, flip_transpose(w), None, padding=pad, dilation=dilation)
    _assert_close(got, want, what=f"k={k} d={dilation}")


TRIO_METAS = [{"kernel_size": k, "dilations": (1, 3, 5)} for k in (3, 7, 11)]


@pytest.mark.parametrize("need_x", [True, False])
def test_trio_backward_decomposition_matches_jax(need_x):
    """The backward kernels' decomposition (flip_transpose convs for the input
    gradients; weight gradients summed over 32-frame steps in a 4-block split, T = 100
    a multiple of neither) vs jax.grad of make_trainable_trio (interpret, highest), k up
    to 11 at dilations 1, 3, 5; with need_x False, the weights' gradients alone."""
    rng = np.random.default_rng(7)
    C, T = 8, 100
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    weights = [tuple((rng.standard_normal(s) * 0.1).astype(np.float32) for s in (
        (3, m["kernel_size"], C, C), (3, C)) * 2) for m in TRIO_METAS]
    g = rng.standard_normal((2, T, C)).astype(np.float32)
    f = make_trainable_trio(TRIO_METAS, slope=SLOPE, tile_t=32, interpret=True,
                            precision="highest")
    jw = tuple(tuple(map(jnp.asarray, b)) for b in weights)
    with jax.default_matmul_precision("highest"):
        if need_x:
            want_dx, want_w = jax.grad(lambda x, w: jnp.sum(f(x, w) * g), argnums=(0, 1))(
                jnp.asarray(x), jw)
        else:
            want_w = jax.grad(lambda w: jnp.sum(f(jnp.asarray(x), w) * g))(jw)
    blocks = [dict(kernel_size=m["kernel_size"], dilations=m["dilations"],
                   **{n: list(torch.tensor(b[i])) for i, n in enumerate(("w1", "b1", "w2", "b2"))})
              for m, b in zip(TRIO_METAS, weights)]
    tx, tg = torch.tensor(x), torch.tensor(g)
    with torch.no_grad():
        _, acts = trio_forward_with_acts(tx, blocks, slope=SLOPE)
        dx, dweights = _trio_backward_decomposed(tg, tx, blocks, flat_acts(acts), 4, need_x)
    assert (dx is None) == (not need_x)
    if need_x:
        _assert_close(dx, want_dx, what="dx")
    for j, (m, jblock) in enumerate(zip(TRIO_METAS, want_w)):
        for p in range(3):
            for q, name in enumerate(("w1", "b1", "w2", "b2")):
                _assert_close(dweights[12 * j + 4 * p + q], np.asarray(jblock[q])[p],
                              what=f"k={m['kernel_size']} pair {p} {name}")
