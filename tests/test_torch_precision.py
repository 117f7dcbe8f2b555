"""The precision tiers of kernels B, C, 7, 6 and A against the JAX kernels.

Each kernel of ``vits_tpu_torch`` takes its plain PyTorch twin on CPU
tensors, and the twin emulates the tier (``vits_tpu_torch/ops/tiers.py``):
here each is held against the Pallas kernel it replaces, run in interpret
mode (``interpret=True``) at the same ``precision`` and ``value_dtype``, on
the same seeded numpy inputs, at "fast" (None; the vocoder kernels with bf16
values, the serving default), "high" (bf16x3) and "highest", and B and C with
int8 weights. Bounds, all relative to max(1, |output|), from the JAX
package's own tests:

- bf16 values, and the fast tier of A and 6: 0.03
  (``tests/test_pallas_resblock.py:219-221``, ``test_pallas_stage.py:210-227``);
- "high": 1e-4 (``test_pallas_stage.py:231-249``);
- "highest": 1e-5 (the fp32 parity tests, ``tests/test_torch_kernels.py``);
- int8 weights with fp32 values: 2e-4 for B and 2e-5 for C
  (``test_pallas_resblock.py:224-253``, ``test_pallas_stage.py:259-302``);
- the int8 + bf16 two-stage chain against the fp32 stages: 0.08 (``:312-341``).

On the CPU the JAX kernels compute fp32 operands at ``precision=None`` in
full fp32, so for kernels A and 6 (whose values are fp32) JAX-on-CPU is no
bit-level oracle at "fast": the port is held to it at the bf16 bound, and
its "fast" must differ from its own "highest" by more than 1e-5, which shows
that the operands are rounded. The vocoder kernels' "fast" casts its values
to bf16 explicitly, so there JAX-on-CPU is the tier's arithmetic.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.config import VitsConfig
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.io.random_init import random_params
from vits_tpu.models.hifigan import _quantize_conv_stack
from vits_tpu.ops.pallas.attention import flash_rel_attention as jax_flash_rel_attention
from vits_tpu.ops.pallas.flow import fused_flow as jax_fused_flow
from vits_tpu.ops.pallas.flow import pack_flow_weights as jax_pack_flow_weights
from vits_tpu.ops.pallas.resblock import fused_resblock as jax_fused_resblock
from vits_tpu.ops.pallas.resblock import fused_resblock_trio as jax_fused_resblock_trio
from vits_tpu.ops.pallas.stage import fused_stage as jax_fused_stage
from vits_tpu.ops.pallas.stage import pack_stage_arrays
from vits_tpu_torch.io.params import ParamView, from_jax_params
from vits_tpu_torch.models.hifigan import quantize_out_channels
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
from vits_tpu_torch.ops.cuda.flow import fused_flow
from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio
from vits_tpu_torch.ops.cuda.stage import fused_stage
from vits_tpu_torch.ops.tiers import EXACT, FAST, HIGH, Tier, Tiers, resolve_tier

torch.set_num_threads(2)

SLOPE = 0.1
BF16_BOUND = 0.03
HIGH_BOUND = 1e-4
EXACT_BOUND = 1e-5
TRIO_INT8_BOUND = 2e-4
STAGE_INT8_BOUND = 2e-5
CHAIN_INT8_BF16_BOUND = 0.08
ROUNDING_FLOOR = 1e-5  # "fast" differs from "highest" by more than this

# tier name -> (the JAX kernels' precision, the vocoder's value dtype, bound)
TIERS = {
    "fast": (None, jnp.bfloat16, BF16_BOUND),
    "high": ("high", None, HIGH_BOUND),
    "highest": ("highest", None, EXACT_BOUND),
}


def _port_tier(name):
    precision, value_dtype, _ = TIERS[name]
    return resolve_tier(precision, None if value_dtype is None else "bfloat16")


def _scale(want):
    return max(1.0, float(np.abs(np.asarray(want, np.float32)).max()))


def _assert_close(got, want, atol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = _scale(want)
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0)


def _masked(rng, B, T, C, lengths):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    return x * (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[..., None]


def _blocks(rng, C, ks=(3, 7), scale=0.05):
    return [dict(
        kernel_size=k, dilations=(1, 3, 5),
        w1=(rng.standard_normal((3, k, C, C)) * scale).astype(np.float32),
        b1=(rng.standard_normal((3, C)) * scale).astype(np.float32),
        w2=(rng.standard_normal((3, k, C, C)) * scale).astype(np.float32),
        b2=(rng.standard_normal((3, C)) * scale).astype(np.float32),
    ) for k in ks]


def _to(blocks, convert):
    return [{k: (convert(v) if isinstance(v, np.ndarray) else v) for k, v in b.items()}
            for b in blocks]


def _values(x, name):
    """The port's input at a tier: bf16 when the tier carries bf16 values."""
    t = torch.tensor(x)
    return t.to(torch.bfloat16) if _port_tier(name).bf16_values else t


def test_resolve_tier_follows_the_jax_names():
    assert resolve_tier(None) == resolve_tier("fast") == resolve_tier("default") == Tier(FAST)
    assert resolve_tier("high") == Tier(HIGH) and resolve_tier("HIGHEST") == Tier(EXACT)
    assert resolve_tier("float32") == Tier(EXACT)
    assert resolve_tier("highest", "bfloat16") == Tier(FAST, True)  # bf16 operands: exact products
    tiers = Tiers.of("high,high,highest,highest", "float32")
    assert [tiers.stage(i).mode for i in range(5)] == [HIGH, HIGH, EXACT, EXACT, EXACT]
    assert tiers.attention == tiers.flow == Tier(EXACT)  # the strongest tier named
    with pytest.raises(ValueError, match="unknown"):
        resolve_tier("medium")


@pytest.mark.parametrize("name", list(TIERS))
def test_trio_tiers_match_jax_kernel(name):
    """Kernel B at each tier, C=128, ragged rows."""
    precision, value_dtype, bound = TIERS[name]
    rng = np.random.default_rng(20)
    C, T, lengths = 128, 64, [64, 29]
    x = _masked(rng, 2, T, C, lengths)
    blocks = _blocks(rng, C)
    want = jax_fused_resblock_trio(
        jnp.asarray(x), _to(blocks, jnp.asarray), slope=SLOPE, tile_t=32,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, precision=precision,
        value_dtype=value_dtype)
    got = fused_resblock_trio(
        _values(x, name), _to(blocks, torch.tensor), slope=SLOPE,
        lengths=torch.tensor(lengths, dtype=torch.int32), tier=_port_tier(name))
    assert got.dtype == _port_tier(name).value_dtype
    _assert_close(got, want, bound)
    assert float(got[1, 29:].abs().max()) == 0.0
    if name == "fast":
        exact = fused_resblock_trio(torch.tensor(x), _to(blocks, torch.tensor), slope=SLOPE,
                                    lengths=torch.tensor(lengths, dtype=torch.int32))
        assert float((got.float() - exact).abs().max()) / _scale(want) > ROUNDING_FLOOR


def _int8_blocks(blocks):
    """The JAX pack's int8 trio weights and the port's, from the same fp32 weights."""
    jax_q, port_q = [], []
    for blk in blocks:
        j, t = dict(blk), dict(blk)
        for w, s in (("w1", "s1"), ("w2", "s2")):
            jq, js = _quantize_conv_stack(jnp.asarray(blk[w]))
            tq, ts = quantize_out_channels(torch.tensor(blk[w]), (1, 2))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
            j[w], j[s] = jq, js
            t[w], t[s] = tq, ts
        jax_q.append({k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
                      for k, v in j.items()})
        port_q.append({k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
                       for k, v in t.items()})
    return jax_q, port_q


@pytest.mark.parametrize("name", ["highest", "fast"])
def test_trio_int8_matches_jax_kernel(name):
    """Kernel B on int8 packs (per-(pair, out-channel) scales on the sum): with
    fp32 values against the JAX kernel's fp32 int8 run, with bf16 values (the
    fast tier of a quantized checkpoint) against its bf16 one."""
    precision, value_dtype, _ = TIERS[name]
    rng = np.random.default_rng(21)
    C, T, lengths = 128, 64, [64, 40]
    x = _masked(rng, 2, T, C, lengths)
    jax_q, port_q = _int8_blocks(_blocks(rng, C))
    want = jax_fused_resblock_trio(
        jnp.asarray(x), jax_q, slope=SLOPE, tile_t=32, lengths=jnp.asarray(lengths, jnp.int32),
        interpret=True, precision=None, value_dtype=value_dtype)
    tier = Tier(EXACT) if name == "highest" else _port_tier(name)
    got = fused_resblock_trio(_values(x, name), port_q, slope=SLOPE,
                              lengths=torch.tensor(lengths, dtype=torch.int32), tier=tier)
    _assert_close(got, want, TRIO_INT8_BOUND if name == "highest" else BF16_BOUND)


def _stage_inputs(rng, C_in, C_out, T_in, lengths, ks=(3, 7, 11)):
    x = _masked(rng, 2, T_in, C_in, lengths)
    up_w = (rng.standard_normal((4, C_in, C_out)) * 0.1).astype(np.float32)
    up_b = (rng.standard_normal((C_out,)) * 0.1).astype(np.float32)
    blocks = _blocks(rng, C_out, ks=ks, scale=0.1)
    w_post = (rng.standard_normal((7, C_out, 1)) * 0.3).astype(np.float32)
    return x, up_w, up_b, blocks, w_post


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("name", list(TIERS))
def test_stage_tiers_match_jax_kernel(name, final):
    """Kernel C at each tier, 64->32, without and with conv_post, ragged rows."""
    precision, value_dtype, bound = TIERS[name]
    rng = np.random.default_rng(11)
    T_in, lengths = 48, [48, 29]
    x, up_w, up_b, blocks, w_post = _stage_inputs(rng, 64, 32, T_in, lengths)
    want = jax_fused_stage(
        jnp.asarray(x), jnp.asarray(up_w), jnp.asarray(up_b), stride=2, up_padding=1,
        resblocks=_to(blocks, jnp.asarray), slope=SLOPE, tile_t=64,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, precision=precision,
        value_dtype=value_dtype, final_conv=(jnp.asarray(w_post), 3) if final else None)
    got = fused_stage(
        _values(x, name), torch.tensor(up_w), torch.tensor(up_b), _to(blocks, torch.tensor),
        stride=2, up_padding=1, slope=SLOPE, lengths=torch.tensor(lengths, dtype=torch.int32),
        final_conv=(torch.tensor(w_post), 3) if final else None, tier=_port_tier(name))
    assert got.dtype == torch.float32
    _assert_close(got, want, bound)


def _port_stage_pack(up_w, blocks, w_post):
    """The port's int8 stage weights (as models/hifigan.py::precompute_vocoder_packs)."""
    up_q, su = quantize_out_channels(torch.tensor(up_w), (0, 1))
    qblocks = []
    for blk in _to(blocks, torch.tensor):
        q = dict(blk)
        for w, s in (("w1", "s1"), ("w2", "s2")):
            q[w], q[s] = quantize_out_channels(blk[w], (1, 2))
        qblocks.append(q)
    post = None
    if w_post is not None:
        post_q, sq = quantize_out_channels(torch.tensor(w_post), (0, 1))
        post = (post_q, 3, sq)
    return up_q, su, qblocks, post


def test_stage_int8_pack_matches_jax_pack():
    """The port's int8 stage weights are the JAX pack's: the same scales (JAX
    tiles each per-out-channel scale over its packed slots) and the same int8
    values (its packed shift matrices hold them)."""
    from vits_tpu.ops.pallas.stage import _materialize_stage, _stage_plan

    rng = np.random.default_rng(12)
    _, up_w, up_b, blocks, w_post = _stage_inputs(rng, 64, 32, 8, [8, 8], ks=(3, 7))
    arrays = pack_stage_arrays(jnp.asarray(up_w), jnp.asarray(up_b), _to(blocks, jnp.asarray),
                               stride=2, up_padding=1, final_conv=(jnp.asarray(w_post), 3),
                               weight_format="int8")
    up_q, su, qblocks, (post_q, _, sq) = _port_stage_pack(up_w, blocks, w_post)
    g_out = 128 // 32
    np.testing.assert_array_equal(np.asarray(arrays["su"])[0], np.tile(su.numpy(), g_out))
    np.testing.assert_array_equal(np.asarray(arrays["sq"])[0], np.tile(sq.numpy(), g_out))
    s1 = np.concatenate([b["s1"].numpy() for b in qblocks])  # (pairs, C) over the blocks
    np.testing.assert_array_equal(np.asarray(arrays["s1"]), np.tile(s1, (1, g_out)))
    meta = _stage_plan(tuple((b["kernel_size"], b["dilations"]) for b in blocks), 4, 2, 1,
                       64, 32, final=(7, 3))
    as_f32 = [{**b, **{w: jnp.asarray(b[w].numpy().astype(np.float32)) for w in ("w1", "w2")},
               "b1": jnp.asarray(b["b1"].numpy()), "b2": jnp.asarray(b["b2"].numpy())}
              for b in qblocks]
    placed = _materialize_stage(meta, jnp.asarray(up_q.numpy().astype(np.float32)),
                                jnp.asarray(up_b), as_f32,
                                jnp.asarray(post_q.numpy().astype(np.float32)))
    for key in ("wu", "w1_all", "w2_all", "wq"):
        np.testing.assert_array_equal(np.asarray(placed[key]),
                                      np.asarray(arrays[key]).astype(np.float32), err_msg=key)


@pytest.mark.parametrize("final", [False, True])
def test_stage_int8_matches_jax_kernel(final):
    """Kernel C on int8 weights with fp32 values against the JAX kernel on its
    int8 packs (scales on the upsampler's, each pair conv's and conv_post's sums)."""
    rng = np.random.default_rng(12)
    T_in, lengths = 50, [50, 29]
    x, up_w, up_b, blocks, w_post = _stage_inputs(rng, 64, 32, T_in, lengths, ks=(3, 7))
    arrays = pack_stage_arrays(jnp.asarray(up_w), jnp.asarray(up_b), _to(blocks, jnp.asarray),
                               stride=2, up_padding=1,
                               final_conv=(jnp.asarray(w_post), 3) if final else None,
                               weight_format="int8")
    want = jax_fused_stage(
        jnp.asarray(x), jnp.asarray(up_w), jnp.asarray(up_b), stride=2, up_padding=1,
        resblocks=_to(blocks, jnp.asarray), slope=SLOPE, tile_t=64,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, arrays=arrays,
        final_conv=(jnp.asarray(w_post), 3) if final else None)
    up_q, su, qblocks, post = _port_stage_pack(up_w, blocks, w_post if final else None)
    got = fused_stage(torch.tensor(x), up_q, torch.tensor(up_b), qblocks, stride=2, up_padding=1,
                      slope=SLOPE, lengths=torch.tensor(lengths, dtype=torch.int32),
                      final_conv=post, tier=Tier(EXACT), up_scale=su)
    _assert_close(got, want, STAGE_INT8_BOUND)


def test_stage_int8_bf16_chain_matches_jax_kernels():
    """Two chained stages on int8 weights with bf16 values (a quantized
    checkpoint's fast tier): the first stage's bf16 output feeds the second,
    as JAX's packed carry does; held against the JAX chain at the bf16 bound
    and, as JAX holds its own, against the fp32 stages at 0.08."""
    rng = np.random.default_rng(13)
    T_in = 64
    x = rng.standard_normal((1, T_in, 128)).astype(np.float32)
    _, wA, bA, rbA, _ = _stage_inputs(rng, 128, 64, 1, [1, 1], ks=(3, 7))
    _, wB, bB, rbB, _ = _stage_inputs(rng, 64, 32, 1, [1, 1], ks=(3, 5))
    kw = dict(stride=2, up_padding=1, slope=SLOPE)
    jkw = dict(kw, interpret=True, tile_t=48)
    a_ref = jax_fused_stage(jnp.asarray(x), jnp.asarray(wA), jnp.asarray(bA),
                            resblocks=_to(rbA, jnp.asarray), **jkw)
    b_ref = np.asarray(jax_fused_stage(a_ref, jnp.asarray(wB), jnp.asarray(bB),
                                       resblocks=_to(rbB, jnp.asarray), **jkw))
    packA = pack_stage_arrays(jnp.asarray(wA), jnp.asarray(bA), _to(rbA, jnp.asarray),
                              stride=2, up_padding=1, weight_format="int8")
    packB = pack_stage_arrays(jnp.asarray(wB), jnp.asarray(bB), _to(rbB, jnp.asarray),
                              stride=2, up_padding=1, weight_format="int8")
    a_q = jax_fused_stage(jnp.asarray(x), jnp.asarray(wA), jnp.asarray(bA),
                          resblocks=_to(rbA, jnp.asarray), arrays=packA, packed_out=True,
                          value_dtype=jnp.bfloat16, **jkw)
    b_q = np.asarray(jax_fused_stage(a_q, jnp.asarray(wB), jnp.asarray(bB),
                                     resblocks=_to(rbB, jnp.asarray), arrays=packB,
                                     packed_in=T_in * 2, value_dtype=jnp.bfloat16, **jkw))
    tier = resolve_tier(None, "bfloat16")
    qA, sA, blocksA, _ = _port_stage_pack(wA, rbA, None)
    qB, sB, blocksB, _ = _port_stage_pack(wB, rbB, None)
    a = fused_stage(torch.tensor(x).to(torch.bfloat16), qA, torch.tensor(bA), blocksA,
                    up_scale=sA, tier=tier, chain=True, **kw)
    assert a.dtype == torch.bfloat16  # the chained carry rides the value dtype
    b = fused_stage(a, qB, torch.tensor(bB), blocksB, up_scale=sB, tier=tier, **kw)
    _assert_close(b, b_q, BF16_BOUND)
    _assert_close(b, b_ref, CHAIN_INT8_BF16_BOUND)


@pytest.mark.parametrize("name", list(TIERS))
def test_resblock_kernel7_tiers_match_jax_kernel(name):
    """Kernel 7 at each tier, C=32 (HiFi-GAN V2's narrow stage), fp32 in and out
    as the JAX engine runs it (its value dtype cast inside)."""
    precision, value_dtype, bound = TIERS[name]
    rng = np.random.default_rng(5)
    C, T, lengths = 32, 80, [80, 41]
    x = _masked(rng, 2, T, C, lengths)
    blk = _blocks(rng, C, ks=(7,), scale=0.1)[0]
    want = jax_fused_resblock(
        jnp.asarray(x), *(jnp.asarray(blk[n]) for n in ("w1", "b1", "w2", "b2")),
        kernel_size=7, dilations=(1, 3, 5), slope=SLOPE, tile_t=64,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, precision=precision,
        value_dtype=value_dtype)
    got = fused_resblock(torch.tensor(x), _to([blk], torch.tensor)[0], slope=SLOPE,
                         lengths=torch.tensor(lengths, dtype=torch.int32), tier=_port_tier(name))
    assert got.dtype == torch.float32
    _assert_close(got, want, bound)


def _flow_config():
    return dataclasses.replace(VitsConfig(), hidden_size=32, flow_size=16,
                               prior_encoder_num_flows=4, prior_encoder_num_wavenet_layers=2)


@pytest.fixture(scope="module")
def flow_params():
    return random_params(_flow_config(), seed=0, keep_training=False)


@pytest.mark.parametrize("name", list(TIERS))
def test_flow_tiers_match_jax_kernel(name, flow_params):
    """Kernel 6 at each tier (its values fp32, every product's operands rounded)."""
    precision, _, bound = TIERS[name]
    config = _flow_config()
    rng = np.random.default_rng(1)
    B, T, lengths = 3, 40, [40, 17, 33]
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]
    x = rng.standard_normal((B, T, config.flow_size)).astype(np.float32) * mask
    packed, type_a = jax_pack_flow_weights(JaxParamView(flow_params), config)
    want = np.asarray(jax_fused_flow(
        jnp.asarray(x), packed, type_a, config, lengths=jnp.asarray(lengths, jnp.int32),
        interpret=True, precision=precision)) * mask
    tp = ParamView(from_jax_params(flow_params, "cpu"))
    kw = dict(lengths=torch.tensor(lengths, dtype=torch.int32))
    got = fused_flow(torch.tensor(x), tp, config, tier=resolve_tier(precision), **kw)
    _assert_close(got, want, bound)
    if name == "fast":
        exact = fused_flow(torch.tensor(x), tp, config, **kw)
        assert float((got - exact).abs().max()) / _scale(want) > ROUNDING_FLOOR


@pytest.mark.parametrize("name", list(TIERS))
def test_attention_tiers_match_jax_kernel(name):
    """Kernel A at each tier (q, k, v, the relative tables and the weights
    rounded before every product), lengths 40/0/23."""
    precision, _, bound = TIERS[name]
    rng = np.random.default_rng(0)
    B, H, L, d, w = 3, 2, 40, 96, 4
    lengths = [40, 0, 23]
    q, k, v = ((rng.standard_normal((B, H, L, d)) * 0.5).astype(np.float32) for _ in range(3))
    rel_k, rel_v = ((rng.standard_normal((2 * w + 1, d)) * 0.5).astype(np.float32)
                    for _ in range(2))
    want = jax_flash_rel_attention(
        *map(jnp.asarray, (q, k, v, rel_k, rel_v)), window=w,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, precision=precision)
    args = tuple(map(torch.tensor, (q, k, v, rel_k, rel_v)))
    kw = dict(window=w, lengths=torch.tensor(lengths, dtype=torch.int32))
    got = flash_rel_attention(*args, tier=resolve_tier(precision), **kw)
    assert bool(torch.isfinite(got).all())
    _assert_close(got, want, bound)
    if name == "fast":
        exact = flash_rel_attention(*args, **kw)
        assert float((got - exact).abs().max()) / _scale(want) > ROUNDING_FLOOR


# --------------------------------------------------------------------------- #
# The whole slice: the port's engine against the JAX engine at each fidelity
# tier, ``use_pallas_vocoder=True, use_pallas_attention=True`` on both sides.
# The engines draw noise from different generators, so both run their model
# with the engine's resolved state (parameters, vocoder packs, tiers, value
# dtype, the JAX engine's matmul-precision context) on the same
# ``NoiseOverride`` draws. Frame counts must be equal (they are on these
# inputs at every tier). Bounds: "exact" as ``tests/test_torch_slice_kernels.py``
# (waveform 2e-4, latents 5e-4); "high" latents 5e-4 and waveform 1e-3, ten
# times the kernels' bf16x3 bound over the chain of an encoder, a flow and a
# vocoder; "fast" and "glue32" -- where the JAX engine's attention computes
# fp32 on the CPU (see above) and the durations, latents and audio therefore
# differ at the bf16 level -- latents within 0.03 of their scale and the
# waveform by mel-L1 below 0.15, as ``tests/test_precision_variants.py``
# holds a precision variant by mel-L1.
# --------------------------------------------------------------------------- #

ENGINE_TIERS = ("fast", "glue32", "high", "exact")
ENGINE_WAVE_ATOL = {"exact": 2e-4, "high": 1e-3}
ENGINE_LATENT_ATOL = 5e-4
ENGINE_MEL_L1 = 0.15
FIXTURE = "tests/fixtures/tiny-vits.ggml"


def engine_parity(config, params, tier, ids, mask, dur, prior, num_frames):
    """Port and JAX engines at ``tier`` on the same draws; asserts the bounds
    above and returns the port's engine."""
    from vits_tpu.config import EngineConfig as JaxEngineConfig
    from vits_tpu.config import VitsConfig as JaxVitsConfig
    from vits_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
    from vits_tpu.engine.synthesizer import _matmul_precision_ctx
    from vits_tpu.models import vits as jax_vits
    from vits_tpu.utils.mel import mel_l1
    from vits_tpu_torch.config import EngineConfig
    from vits_tpu_torch.config import VitsConfig as PortVitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io.loader import load_ggml
    from vits_tpu_torch.models import vits

    _, tokenizer, _ = load_ggml(FIXTURE)  # the engines' tokenizer (the inputs are ids)
    kw = dict(use_pallas_vocoder=True, use_pallas_attention=True,
              **EngineConfig.fidelity_kwargs(tier))
    port = Synthesizer(PortVitsConfig(**dataclasses.asdict(config)), tokenizer, params,
                       EngineConfig(**kw), device="cpu")
    ref = JaxSynthesizer(JaxVitsConfig(**dataclasses.asdict(config)), tokenizer, params,
                         JaxEngineConfig(**kw))
    with torch.inference_mode():
        got = vits.synthesize(
            port.params, port.config, torch.tensor(ids, dtype=torch.long), torch.tensor(mask),
            num_frames, noise=vits.NoiseOverride(torch.tensor(dur), torch.tensor(prior)),
            tiers=port.tiers, vocoder_packs=port._vocoder_packs())
    with _matmul_precision_ctx(ref.engine.matmul_precision):
        want = jax_vits.synthesize(
            ref.params, ref.config, jnp.asarray(ids), jnp.asarray(mask), num_frames,
            noise=jax_vits.NoiseOverride(jnp.asarray(dur), jnp.asarray(prior)),
            use_pallas=True, use_pallas_attention=True,
            pallas_precision=ref.engine.pallas_precision,
            pallas_value_dtype=ref._pallas_value_dtype)
    np.testing.assert_array_equal(got.frame_lengths.numpy(), np.asarray(want.frame_lengths))
    wave, want_wave = got.waveform.numpy(), np.asarray(want.waveform)
    if tier in ENGINE_WAVE_ATOL:
        np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                                   atol=ENGINE_LATENT_ATOL, rtol=0)
        np.testing.assert_allclose(wave, want_wave, atol=ENGINE_WAVE_ATOL[tier], rtol=0)
    else:
        _assert_close(got.latents, want.latents, BF16_BOUND)
        mel = float(mel_l1(wave, want_wave, sample_rate=config.sampling_rate))
        assert mel < ENGINE_MEL_L1, mel
    return port


def fixture_inputs(tokenizer, seed=3, num_frames=160):
    rng = np.random.default_rng(seed)
    ids, mask = tokenizer.pad([tokenizer.encode(t) for t in ("hello world", "the quick fox")],
                              pad_to=32)
    dur = rng.standard_normal((2, 32, 2)).astype(np.float32)
    prior = rng.standard_normal((2, num_frames, 16)).astype(np.float32)
    return ids, mask, dur, prior, num_frames


@pytest.mark.parametrize("tier", ENGINE_TIERS)
def test_engine_tiers_match_jax_engine(tier):
    """The fixture (its vocoder: kernel 7 at C = 16 and 8; attention: kernel A)."""
    from vits_tpu.io.loader import load_ggml

    config, tokenizer, params = load_ggml(FIXTURE)
    port = engine_parity(config, params, tier, *fixture_inputs(tokenizer))
    assert port.tiers.stage(0).bf16_values == (tier in ("fast", "glue32"))


def test_engine_fast_tier_on_every_vocoder_kernel():
    """The fast tier on a config whose vocoder takes kernels B and C (the
    kernel-shaped config of ``tests/test_torch_slice_kernels.py``): bf16
    vocoder packs, the bf16 carry and its bf16 wide-stage upsampler."""
    from tests.test_torch_slice_kernels import KERNEL_SHAPED, _inputs

    params = random_params(KERNEL_SHAPED, seed=0, keep_training=False)
    ids, mask, dur, prior = _inputs(KERNEL_SHAPED, 1, lengths=(12, 3), num_frames=16)
    port = engine_parity(KERNEL_SHAPED, params, "fast", ids, mask, dur, prior, 16)
    packs = port._vocoder_packs()
    assert sorted(packs) == [0, 1, 2] and packs[0]["up_w"].dtype == torch.bfloat16
    assert packs[2]["blocks"][0]["w1"].dtype == torch.bfloat16 and "post" in packs[2]
