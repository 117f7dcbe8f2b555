"""Kernels 6 and 7 and the narrow stage, plain versions against the JAX kernels.

Kernel 6 (``vits_tpu_torch/ops/cuda/flow.py::fused_flow``) and kernel 7
(``ops/cuda/resblock.py::fused_resblock``) take their plain PyTorch versions
on CPU tensors; here each is held against the Pallas kernel it replaces, run
in interpret mode at ``precision="highest"`` as ``tests/test_pallas_flow.py``
and ``tests/test_pallas_resblock.py`` run them, and the flow also against the
JAX module, on the same seeded numpy inputs. Tolerances are those of the JAX
tests: 1e-5 relative to max(1, |output|), 1e-4 at MMS dims (fp32 sums in
another order over 192-wide products).

``tests/test_torch_cuda.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.config import VitsConfig
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.io.random_init import random_params
from vits_tpu.models.flow import residual_coupling_block as jax_residual_coupling_block
from vits_tpu.models.hifigan import _resblock as jax_resblock
from vits_tpu.ops.conv import conv1d as jax_conv1d
from vits_tpu.ops.conv import conv_transpose1d as jax_conv_transpose1d
from vits_tpu.ops.conv import leaky_relu as jax_leaky_relu
from vits_tpu.ops.pallas.flow import fused_flow as jax_fused_flow
from vits_tpu.ops.pallas.flow import pack_flow_cond as jax_pack_flow_cond
from vits_tpu.ops.pallas.flow import pack_flow_weights
from vits_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from vits_tpu.ops.pallas.stage import fused_stage as jax_fused_stage
from vits_tpu_torch.io.params import ParamView, from_jax_params
from vits_tpu_torch.ops.cuda.flow import flow_reference, flow_steps, fused_flow, pack_flow_cond
from vits_tpu_torch.ops.cuda.resblock import fused_resblock
from vits_tpu_torch.ops.cuda.stage import fused_stage

torch.set_num_threads(2)

SLOPE = 0.1


def _assert_close(got, want, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _small_config(**kw):
    return dataclasses.replace(VitsConfig(), hidden_size=32, flow_size=16,
                               prior_encoder_num_flows=4, prior_encoder_num_wavenet_layers=2,
                               **kw)


@pytest.fixture(scope="module")
def small_params():
    return random_params(_small_config(num_speakers=4, speaker_embedding_size=8), seed=0,
                         keep_training=False)


@pytest.fixture(scope="module")
def mms_params():
    return random_params(VitsConfig(), seed=0, keep_training=False)


@pytest.mark.parametrize("case", ["masked", "speaker", "mms"])
def test_flow_plain_matches_jax_kernel_and_module(case, small_params, mms_params):
    """Kernel 6's plain version vs JAX fused_flow and residual_coupling_block(reverse)."""
    if case == "mms":
        config, params, B, T, lengths, atol = VitsConfig(), mms_params, 1, 24, [20], 1e-4
    else:
        config = _small_config(num_speakers=4, speaker_embedding_size=8)
        params, B, T, lengths, atol = small_params, 3, 48, [48, 17, 33], 1e-5
    rng = np.random.default_rng(1)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((B, T, config.flow_size)).astype(np.float32) * mask
    emb = None
    if case == "speaker":
        emb = rng.standard_normal((B, 1, config.speaker_embedding_size)).astype(np.float32)
    jp = JaxParamView(params)
    packed, type_a = pack_flow_weights(jp, config)
    cond = None if emb is None else jax_pack_flow_cond(jp, config, jnp.asarray(emb))
    want_kernel = np.asarray(jax_fused_flow(
        jnp.asarray(x), packed, type_a, config, lengths=jnp.asarray(lengths, jnp.int32),
        cond=cond, interpret=True, precision="highest"))
    want_module, _ = jax_residual_coupling_block(
        jp, config, jnp.asarray(x), jnp.asarray(mask),
        None if emb is None else jnp.asarray(emb), reverse=True)
    tp = ParamView(from_jax_params(params, "cpu"))
    args = (torch.tensor(x), tp, config)
    kw = dict(lengths=torch.tensor(lengths, dtype=torch.int32),
              speaker_embeddings=None if emb is None else torch.tensor(emb))
    got = fused_flow(*args, **kw)
    torch.testing.assert_close(got, flow_reference(*args, **kw), rtol=0, atol=0)
    _assert_close(got, want_kernel * mask, atol)
    _assert_close(got, np.asarray(want_module) * mask, atol)
    if emb is not None:  # the per-step cond vectors, in the JAX kernel's execution order
        np.testing.assert_allclose(
            pack_flow_cond(tp, config, torch.tensor(emb)).numpy(), np.asarray(cond),
            atol=1e-6, rtol=0)


def test_flow_steps_follow_the_jax_packing(small_params):
    """Step s runs coupling n-1-s, flipped exactly on the JAX kernel's type-A steps."""
    config = _small_config(num_speakers=4, speaker_embedding_size=8)
    _, type_a = pack_flow_weights(JaxParamView(small_params), config)
    n = config.prior_encoder_num_flows
    assert flow_steps(config) == [(n - 1 - s, a) for s, a in enumerate(type_a)]


def test_flow_plain_zeroes_a_length_zero_row(small_params):
    config = _small_config(num_speakers=4, speaker_embedding_size=8)
    x = torch.ones((2, 16, config.flow_size))
    out = fused_flow(x, ParamView(from_jax_params(small_params, "cpu")), config,
                     lengths=torch.tensor([16, 0], dtype=torch.int32))
    assert float(out[1].abs().max()) == 0.0 and float(out[0].abs().max()) > 0.0


def _block(rng, C, k=7, dilations=(1, 3, 5), scale=0.1):
    pairs = len(dilations)
    return dict(kernel_size=k, dilations=dilations,
                w1=(rng.standard_normal((pairs, k, C, C)) * scale).astype(np.float32),
                b1=(rng.standard_normal((pairs, C)) * scale).astype(np.float32),
                w2=(rng.standard_normal((pairs, k, C, C)) * scale).astype(np.float32),
                b2=(rng.standard_normal((pairs, C)) * scale).astype(np.float32))


@pytest.mark.parametrize("C", [8, 16, 32, 64])
def test_resblock_plain_matches_jax_kernel(C):
    """Kernel 7's plain version vs JAX fused_resblock at the narrow stage widths."""
    rng = np.random.default_rng(C)
    T, lengths = 40, [40, 23]
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    x *= (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[..., None]
    blk = _block(rng, C)
    want = jax_fused_resblock(
        jnp.asarray(x), *(jnp.asarray(blk[n]) for n in ("w1", "b1", "w2", "b2")),
        kernel_size=blk["kernel_size"], dilations=blk["dilations"], slope=SLOPE,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, precision="highest")
    got = fused_resblock(
        torch.tensor(x), {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
                          for k, v in blk.items()},
        slope=SLOPE, lengths=torch.tensor(lengths, dtype=torch.int32))
    _assert_close(got, want, 1e-5)
    assert float(got[1, 23:].abs().max()) == 0.0


def _jax_stage_module(x, up_w, up_b, blocks, w_post, lengths, stride, up_padding, slope):
    """The stage as the JAX module computes it without kernels (``hifigan.py``)."""
    h = jax_conv_transpose1d(jax_leaky_relu(x, slope), up_w, up_b, stride=stride,
                             padding=up_padding)
    mask = (jnp.arange(h.shape[1])[None, :] < stride * lengths[:, None])[..., None]
    h = h * mask
    total = 0.0
    for blk in blocks:
        view = JaxParamView({f"convs{n}.{i}.{kind}": blk[f"{kind[0]}{n}"][i]
                             for n in (1, 2) for i in range(len(blk["dilations"]))
                             for kind in ("weight", "bias")})
        total = total + jax_resblock(view, h, mask, blk["kernel_size"], blk["dilations"], slope)
    h = total / len(blocks)
    if w_post is None:
        return h
    wave = jnp.tanh(jax_conv1d(jax_leaky_relu(h, 0.01), w_post, None, padding=3)) * mask
    return wave[..., 0]


@pytest.mark.parametrize("C_in,C_out,final", [(32, 16, False), (32, 16, True), (16, 8, True)])
def test_narrow_stage_plain_matches_jax(C_in, C_out, final):
    """Kernel C's plain version at HiFi-GAN V2's tail widths (C_out 16, 8), against
    the JAX kernel and the JAX module math. At C_out = 8 the JAX kernel asserts
    (its packed halo rows do not align to the 16-step lane groups), so there the
    module math is the only reference."""
    rng = np.random.default_rng(C_out)
    T_in, lengths = 24, [24, 13]
    x = rng.standard_normal((2, T_in, C_in)).astype(np.float32)
    x *= (np.arange(T_in)[None, :] < np.asarray(lengths)[:, None])[..., None]
    up_w = (rng.standard_normal((4, C_in, C_out)) * 0.2).astype(np.float32)
    up_b = (rng.standard_normal((C_out,)) * 0.1).astype(np.float32)
    blocks = [_block(rng, C_out, k=k) for k in (3, 7, 11)]
    w_post = (rng.standard_normal((7, C_out, 1)) * 0.3).astype(np.float32) if final else None
    kw = dict(stride=2, up_padding=1, slope=SLOPE)
    jblocks = [{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
               for b in blocks]
    jlens = jnp.asarray(lengths, jnp.int32)
    got = fused_stage(
        torch.tensor(x), torch.tensor(up_w), torch.tensor(up_b),
        [{k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
         for b in blocks],
        lengths=torch.tensor(lengths, dtype=torch.int32),
        final_conv=(torch.tensor(w_post), 3) if final else None, **kw)
    module = _jax_stage_module(jnp.asarray(x), jnp.asarray(up_w), jnp.asarray(up_b), jblocks,
                               None if w_post is None else jnp.asarray(w_post), jlens, **kw)
    _assert_close(got, module, 1e-5)
    args = (jnp.asarray(x), jnp.asarray(up_w), jnp.asarray(up_b))
    jkw = dict(tile_t=64, resblocks=jblocks, lengths=jlens, interpret=True, precision="highest",
               final_conv=(jnp.asarray(w_post), 3) if final else None, **kw)
    if C_out == 8:
        with pytest.raises(AssertionError):
            jax_fused_stage(*args, **jkw)
    else:
        _assert_close(got, jax_fused_stage(*args, **jkw), 1e-5)
