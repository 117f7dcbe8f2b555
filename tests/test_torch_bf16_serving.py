"""Serving at ``compute_dtype="bfloat16"`` in the port against the JAX package's, on the CPU.

The JAX engine at bf16 casts every fp32 parameter to bf16 (int8 weights
dequantize into bf16 scales), feeds bf16 masks and noise, computes durations
in fp32 and runs no vocoder kernel: XLA's bf16 graph of every stage. The
port's engine does the same through its kernels' bf16 serving mode
(``ops/tiers.py::Tiers.bf16_compute``), whose plain twins on CPU tensors are
held here against the JAX functions at bf16 on the same seeded numpy inputs.

The oracle is the JAX model run eagerly (``jax.disable_jit()``), op by op:
the port rounds to bf16 after every op as eager JAX does, and is then equal
to it stage by stage (the text encoder and the durations to the bit on the
fixture). The JAX engine itself is jitted, and XLA keeps fp32 inside a
fusion, so jitted and eager JAX differ at bf16 by about as much as bf16
differs from fp32 (on the fixture: the encoder's prior means by 1.2x that
gap, log durations by 3.6x); jitted JAX is no tighter oracle than fp32.

Bounds: frame counts equal; every stage tensor within GAP_FRACTION of the JAX
package's own bf16-versus-fp32 gap on the same inputs (the L2 norm of fp32 -
bf16 of that stage, eager), so a port that silently computed in fp32 would sit
at 1.0. L2, not the largest element: two fp32 sums of one product in other
orders may round to bf16 one ulp apart, and that ulp travels downstream.
The kernels' twins against the JAX functions at bf16: the vocoder's (B, C,
7) within GAP_FRACTION of their fp32-versus-bf16 gap; kernels A and 6 (fp32
staging, a bf16 output) within their tier's bound of the JAX kernels run in
interpret mode on the same bf16 inputs, plus one bf16 ulp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vits_tpu_torch
from vits_tpu.config import EngineConfig as JaxEngineConfig
from vits_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.io.quantize import quantize_params as jax_quantize_params
from vits_tpu.io.random_init import random_params
from vits_tpu.models import hifigan as jax_hifigan
from vits_tpu.models import flow as jax_flow
from vits_tpu.models import vits as jax_vits
from vits_tpu.models.encoder import text_encoder as jax_text_encoder
from vits_tpu.ops import conv as jax_conv
from vits_tpu.ops.pallas.attention import flash_rel_attention as jax_flash_rel_attention
from vits_tpu.ops.pallas.flow import fused_flow as jax_fused_flow
from vits_tpu.ops.pallas.flow import pack_flow_cond as jax_pack_flow_cond
from vits_tpu.ops.pallas.flow import pack_flow_weights as jax_pack_flow_weights
from vits_tpu_torch.config import EngineConfig, VitsConfig
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.io.params import ParamView, from_jax_params
from vits_tpu_torch.models import vits
from vits_tpu_torch.models.flow import residual_coupling_forward
from vits_tpu_torch.models.hifigan import hifigan as port_hifigan
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
from vits_tpu_torch.ops.cuda.flow import fused_flow
from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio
from vits_tpu_torch.ops.cuda.stage import fused_stage
from vits_tpu_torch.ops.tiers import BF16_COMPUTE_TIER, Tier, Tiers, resolve_tier
from vits_tpu_torch.utils import debug

torch.set_num_threads(2)

GGML = "tests/fixtures/tiny-vits.ggml"
GAP_FRACTION = 0.5
BF16_ULP = 2.0**-7  # relative to max(1, |output|)
SLOPE = 0.1
TIER_BOUNDS = {"fast": 0.03, "high": 1e-4, "highest": 1e-5}  # tests/test_torch_precision.py
FRAMES = 160


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float() if t.dtype == torch.bfloat16 else t.detach()
        return t.numpy().astype(np.float64)
    return np.asarray(t).astype(np.float64)


def _gap_check(name, got, bf16, fp32, fraction=GAP_FRACTION):
    """||got - bf16|| <= fraction x ||fp32 - bf16|| (L2 over the tensor: a sum in
    another order may flip one bf16 rounding, whose ulp then travels); the ratio."""
    gap = float(np.linalg.norm(_np(fp32) - _np(bf16)))
    err = float(np.linalg.norm(_np(got) - _np(bf16)))
    ratio = err / max(gap, 1e-30)
    print(f"  {name}: |port - jax bf16| {err:.4g}  gap {gap:.4g}  ratio {ratio:.3f}")
    assert gap > 0 and ratio <= fraction, (name, err, gap)
    return ratio


# --------------------------------------------------------------------------- #
# The engine on the fixture
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def bundle():
    return jax_load_ggml(GGML)


def _inputs(tokenizer, seed=3):
    rng = np.random.default_rng(seed)
    ids, mask = tokenizer.pad([tokenizer.encode(t) for t in ("hello world", "the quick fox")],
                              pad_to=32)
    dur = rng.standard_normal((2, 32, 2)).astype(np.float32)
    prior = rng.standard_normal((2, FRAMES, 16)).astype(np.float32)
    return ids, mask, dur, prior


def _jax_stages(params, config, ids, mask, dur, prior, dtype):
    """The JAX package's stages at ``dtype`` on its engine's parameters, eager."""
    ref = JaxSynthesizer(config, None, params, JaxEngineConfig(compute_dtype=dtype,
                                                               use_pallas_vocoder=False))
    cd = ref.compute_dtype
    m = jnp.asarray(mask, cd)
    with jax.disable_jit():
        enc = jax_text_encoder(JaxParamView(ref.params), ref.config, jnp.asarray(ids),
                               m[..., None], m)
        out = jax_vits.synthesize(
            ref.params, ref.config, jnp.asarray(ids), m, FRAMES,
            noise=jax_vits.NoiseOverride(jnp.asarray(dur, cd), jnp.asarray(prior, cd)))
    f32 = lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == cd else a)  # noqa: E731
    return {"text_encoder_output": f32(enc.last_hidden_state),
            "prior_means": f32(enc.prior_means),
            "prior_log_variances": f32(enc.prior_log_variances),
            "log_duration": f32(out.log_duration), "latents": f32(out.latents),
            "waveform": f32(out.waveform), "lengths": np.asarray(out.lengths)}


def _port_stages(params, config, ids, mask, dur, prior, **engine):
    port = Synthesizer(VitsConfig(**dataclasses.asdict(config)), None, params,
                       EngineConfig(compute_dtype="bfloat16", **engine), device="cpu")
    stages = debug.stage_outputs(
        port.params, port.config, ids, mask, FRAMES, compute_dtype="bfloat16",
        noise=vits.NoiseOverride(torch.tensor(dur), torch.tensor(prior)), tiers=port.tiers)
    return port, stages


STAGES = ("text_encoder_output", "prior_means", "prior_log_variances", "log_duration",
          "latents", "waveform")


def _hold(got, bf16, fp32):
    np.testing.assert_array_equal(got["lengths"], bf16["lengths"])  # the frame counts
    return max(_gap_check(name, got[name], bf16[name], fp32[name]) for name in STAGES)


@pytest.mark.parametrize("int8", [False, True])
def test_engine_bf16_stages_match_jax_bf16(bundle, int8):
    """The port's bf16 engine (int8 weights: dequantized into bf16) against the
    JAX package's, stage by stage (``utils/debug.py::stage_outputs``) on one
    NoiseOverride: equal frame counts, each stage within GAP_FRACTION of JAX's gap."""
    config, tok, params = bundle
    if int8:
        params = jax_quantize_params(params)
    inputs = _inputs(tok)
    bf16 = _jax_stages(params, config, *inputs, "bfloat16")
    fp32 = _jax_stages(params, config, *inputs, "float32")
    port, got = _port_stages(params, config, *inputs)
    assert port.compute_dtype == torch.bfloat16 and port._vocoder_packs() == {}
    assert all(v.dtype == torch.bfloat16 for v in port.params.values())
    np.testing.assert_array_equal(got["log_duration"], bf16["log_duration"])
    _hold(got, bf16, fp32)


def test_engine_bf16_int8_dequantizes_into_bf16(bundle):
    """int8 weights times bf16 scales, rounded to bf16: the JAX ParamView's values."""
    config, tok, params = bundle
    q = jax_quantize_params(params)
    port = Synthesizer(VitsConfig(**dataclasses.asdict(config)), tok, q,
                       EngineConfig(compute_dtype="bfloat16"), device="cpu")
    ref = JaxSynthesizer(config, tok, q, JaxEngineConfig(compute_dtype="bfloat16",
                                                         use_pallas_vocoder=False))
    view = JaxParamView(ref.params)
    names = [k for k in q if np.asarray(q[k]).dtype == np.int8]
    assert names and not any(k.endswith(".scale") for k in port.params)
    for name in names:
        want = np.asarray(view[name]).astype(np.float32)
        np.testing.assert_array_equal(port.params[name].float().numpy(), want)


@pytest.mark.parametrize("dtype,int8", [("bfloat16", False), ("float32", True),
                                        ("bfloat16", True)])
def test_variant_synthesizes(dtype, int8, tmp_path):
    """``tests/test_precision_variants.py``'s three variants through ``load_model``."""
    from vits_tpu_torch.io.loader import export_to_ggml, load_ggml
    from vits_tpu_torch.io.quantize import quantize_params

    source = GGML
    if int8:
        config, tok, params = load_ggml(GGML)
        source = str(tmp_path / "int8.ggml")
        export_to_ggml(source, config, tok, quantize_params(params))
    m = vits_tpu_torch.load_model(source, EngineConfig(token_buckets=(64,), compute_dtype=dtype),
                                  device="cpu")
    w = m.synthesize("hello world", seed=3)
    assert w.dtype == np.float32 and w.ndim == 1 and len(w) > 0
    assert np.all(np.isfinite(w)) and np.abs(w).max() <= 1.0


def test_controls_stay_bf16(bundle):
    """Per-call controls on a bf16 engine: bf16 throughout (no promotion), finite
    audio, and the JAX engine's frame counts at the same controls and noise."""
    config, tok, params = bundle
    m = vits_tpu_torch.load_model(GGML, EngineConfig(compute_dtype="bfloat16"), device="cpu")
    w = m.synthesize("hello", seed=0, noise_scale=0.5, speaking_rate=1.5,
                     noise_scale_duration=0.2)
    assert np.all(np.isfinite(w))
    ids, mask, dur, prior = _inputs(tok)
    controls = dict(noise_scale=0.5, speaking_rate=1.5, noise_scale_duration=0.2)
    with torch.inference_mode():
        got = vits.synthesize(
            m.params, m.config, torch.tensor(ids, dtype=torch.long),
            torch.tensor(mask).to(torch.bfloat16), FRAMES,
            noise=vits.NoiseOverride(torch.tensor(dur).bfloat16(), torch.tensor(prior).bfloat16()),
            tiers=m.tiers, **controls)
    assert got.waveform.dtype == got.latents.dtype == torch.bfloat16
    ref = JaxSynthesizer(config, tok, params, JaxEngineConfig(compute_dtype="bfloat16",
                                                              use_pallas_vocoder=False))
    with jax.disable_jit():
        want = jax_vits.synthesize(
            ref.params, ref.config, jnp.asarray(ids), jnp.asarray(mask, jnp.bfloat16), FRAMES,
            noise=jax_vits.NoiseOverride(jnp.asarray(dur, jnp.bfloat16),
                                         jnp.asarray(prior, jnp.bfloat16)), **controls)
    np.testing.assert_array_equal(got.frame_lengths.numpy(), np.asarray(want.frame_lengths))


def test_convert_voice_bf16_matches_jax(bundle):
    """``convert_voice`` at bf16: fp32 PCM of the source's shape from the engine;
    the conversion (the posterior encoder on the bf16 spectrogram and mask, the
    forward and reverse flows, the vocoder; noise_scale 0) against the JAX
    package's on the same spectrogram, within GAP_FRACTION of its gap."""
    from vits_tpu_torch.train.data import linear_spectrogram

    config, tok, params = bundle
    port = vits_tpu_torch.load_model(GGML, EngineConfig(compute_dtype="bfloat16"), device="cpu")
    audio = vits_tpu_torch.load_model(GGML, device="cpu").synthesize("hello dame", seed=1)
    converted = port.convert_voice(audio)
    assert converted.dtype == np.float32 and converted.shape == audio.shape
    assert np.isfinite(converted).all()
    hop, n_fft = config.total_upsample, 2 * (config.spectrogram_bins - 1)
    frames = len(audio) // hop
    spec = linear_spectrogram(audio[: frames * hop], n_fft, hop)[None, :frames]
    mask = np.ones((1, frames), np.float32)
    p = ParamView(port.params)
    with torch.inference_mode():
        got = vits.voice_convert(port.params, port.config,
                                 torch.tensor(spec).to(torch.bfloat16),
                                 torch.tensor(mask).to(torch.bfloat16), tiers=port.tiers,
                                 noise_scale=0.0)

    def jax_convert(dtype, z=None):
        """JAX's posterior mean, and the conversion of ``z`` (else of that mean)."""
        ref = JaxSynthesizer(config, tok, params, JaxEngineConfig(compute_dtype=dtype,
                                                                  use_pallas_vocoder=False))
        cd = ref.compute_dtype
        m = jnp.asarray(mask, cd)
        with jax.disable_jit():
            out = jax_vits.voice_convert(ref.params, ref.config, jnp.asarray(spec, cd), m,
                                         noise_scale=0.0)
            z = out.posterior_mean if z is None else jnp.asarray(z, cd)
            z_p, _ = jax_flow.residual_coupling_block(JaxParamView(ref.params), ref.config, z,
                                                      m[..., None], None, reverse=False)
            lat = jax_vits.latents_from_prior(ref.params, ref.config, z_p, m[..., None])
            wave = jax_hifigan.hifigan(JaxParamView(ref.params), ref.config, lat, m[..., None])
        return (np.asarray(out.posterior_mean.astype(jnp.float32)),
                np.asarray(wave.astype(jnp.float32)))

    # the posterior encoder; then the flows and the vocoder from JAX's posterior
    mean16, _ = jax_convert("bfloat16")
    mean32, _ = jax_convert("float32")
    _gap_check("posterior mean", got.posterior_mean, mean16, mean32)
    with torch.inference_mode():
        z = torch.tensor(mean16).to(torch.bfloat16)
        m3 = torch.ones((1, frames, 1), dtype=torch.bfloat16)
        z_p, _ = residual_coupling_forward(p, port.config, z, m3)
        lat = vits.latents_from_prior(port.params, port.config, z_p, m3)
        wave = port_hifigan(p, port.config, lat, m3, tiers=port.tiers)
    _gap_check("converted waveform", wave, jax_convert("bfloat16", mean16)[1],
               jax_convert("float32", mean16)[1])


# --------------------------------------------------------------------------- #
# Streaming, the mux and the CLI at bf16
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def bf16_model():
    return vits_tpu_torch.load_model(
        GGML, EngineConfig(compute_dtype="bfloat16", adaptive_capacity=False), device="cpu")


def test_stream_bf16_equals_oneshot(bf16_model):
    """A bf16 stream equals the bf16 one-shot decode at one frame capacity."""
    from vits_tpu_torch.engine.streaming import StreamingDecoder

    text = "the quick brown fox jumps over the lazy dog"
    want = bf16_model.synthesize(text, seed=5)
    with torch.backends.mkldnn.flags(enabled=False):
        stream = StreamingDecoder(bf16_model, chunk_frames=16)
        got = np.concatenate(list(stream.stream(text, seed=5)))
        want = bf16_model.synthesize(text, seed=5)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BF16_ULP, rtol=0)


def test_mux_bf16_matches_solo_streams(bf16_model):
    """Two bf16 streams through the mux: each equals its solo stream."""
    from vits_tpu_torch.engine.mux import MultiplexedStreamingDecoder
    from vits_tpu_torch.engine.streaming import StreamingDecoder

    texts = ("hello world", "the quick fox")
    with torch.backends.mkldnn.flags(enabled=False):
        solo = [np.concatenate(list(StreamingDecoder(bf16_model, chunk_frames=16)
                                    .stream(t, seed=i))) for i, t in enumerate(texts)]
        mux = MultiplexedStreamingDecoder(bf16_model, chunk_frames=16, max_batch=2)
        try:
            mux.warmup(token_buckets=(32,))
            got = [np.concatenate(list(mux.stream(t, seed=i))) for i, t in enumerate(texts)]
        finally:
            mux.stop()
    for g, s in zip(got, solo):
        assert g.shape == s.shape
        np.testing.assert_allclose(g, s, atol=BF16_ULP, rtol=0)


def test_cli_dtype_bfloat16_writes_the_engines_wav(tmp_path):
    from vits_tpu_torch import cli
    from vits_tpu_torch.utils.wav import read_wav

    out = str(tmp_path / "out.wav")
    assert cli.main(["--model", GGML, "--device", "cpu", "--out", out, "--text", "hello world",
                     "--seed", "3", "--dtype", "bfloat16"]) == 0
    audio = read_wav(out)[0]
    want = vits_tpu_torch.load_model(GGML, EngineConfig(compute_dtype="bfloat16"),
                                      device="cpu").synthesize("hello world", seed=3)
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=1.5 / 32767, rtol=0)


# --------------------------------------------------------------------------- #
# The kernels' bf16 serving twins against the JAX functions at bf16
# --------------------------------------------------------------------------- #


def _masked(rng, B, T, C, lengths):
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    return x * (np.arange(T)[None, :] < np.asarray(lengths)[:, None])[..., None]


def _mask(T, lengths):
    return (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _block_params(rng, C, k, scale):
    p = {}
    for i in range(3):
        for conv in ("convs1", "convs2"):
            p[f"{conv}.{i}.weight"] = (rng.standard_normal((k, C, C)) * scale).astype(np.float32)
            p[f"{conv}.{i}.bias"] = (rng.standard_normal(C) * scale).astype(np.float32)
    return p


def _port_block(p, k):
    t = lambda n: torch.tensor(p[n]).to(torch.bfloat16)  # noqa: E731
    return dict(kernel_size=k, dilations=(1, 3, 5),
                w1=[t(f"convs1.{i}.weight") for i in range(3)],
                b1=[t(f"convs1.{i}.bias") for i in range(3)],
                w2=[t(f"convs2.{i}.weight") for i in range(3)],
                b2=[t(f"convs2.{i}.bias") for i in range(3)])


def _jax_mean(x, mask, blocks, ks, dtype, slope=SLOPE):
    """The JAX vocoder's plain resblocks and their mean at ``dtype``, eager."""
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    with jax.disable_jit():
        h, m, total = cast(x), cast(mask), None
        for p, k in zip(blocks, ks):
            out = jax_hifigan._resblock(JaxParamView({n: cast(v) for n, v in p.items()}), h, m,
                                        k, (1, 3, 5), slope)
            total = out if total is None else total + out
        return np.asarray((total / len(blocks)).astype(jnp.float32))


def test_trio_bf16_twin_matches_jax_bf16_graph():
    """Kernel B's bf16 serving twin (C=128, ragged rows) against the JAX vocoder's
    plain bf16 resblocks and mean."""
    rng = np.random.default_rng(0)
    lengths, ks = [96, 41], (3, 7, 11)
    x = _masked(rng, 2, 96, 128, lengths)
    blocks = [_block_params(rng, 128, k, 0.05) for k in ks]
    got = fused_resblock_trio(torch.tensor(x).bfloat16(), [_port_block(p, k) for p, k in
                                                           zip(blocks, ks)],
                              slope=SLOPE, lengths=torch.tensor(lengths), tier=BF16_COMPUTE_TIER)
    assert got.dtype == torch.bfloat16 and float(got[1, 41:].abs().max()) == 0.0
    mask = _mask(96, lengths)
    _gap_check("trio", got, _jax_mean(x, mask, blocks, ks, jnp.bfloat16),
               _jax_mean(x, mask, blocks, ks, jnp.float32))


def test_resblock7_bf16_twin_matches_jax_bf16_graph():
    """Kernel 7's bf16 serving twin (C=32): three blocks summed into ``into`` and
    divided by three, as the vocoder's narrow stages call it."""
    rng = np.random.default_rng(1)
    lengths, ks = [80, 33], (3, 7, 11)
    x = _masked(rng, 2, 80, 32, lengths)
    blocks = [_block_params(rng, 32, k, 0.1) for k in ks]
    xt, out = torch.tensor(x).bfloat16(), None
    for j, (p, k) in enumerate(zip(blocks, ks)):
        out = fused_resblock(xt, _port_block(p, k), slope=SLOPE, lengths=torch.tensor(lengths),
                             into=out, divisor=3 if j == 2 else 1, tier=BF16_COMPUTE_TIER)
    mask = _mask(80, lengths)
    _gap_check("resblock 7", out, _jax_mean(x, mask, blocks, ks, jnp.bfloat16),
               _jax_mean(x, mask, blocks, ks, jnp.float32))
    with pytest.raises(ValueError):
        fused_resblock(xt, _port_block(blocks[0], 3), slope=SLOPE, scale=0.5,
                       tier=BF16_COMPUTE_TIER)


def _jax_stage(x, mask_in, up_w, up_b, blocks, ks, w_post, stride, pad, final, dtype):
    """The JAX vocoder's plain stage at ``dtype`` (eager): leaky, the per-phase
    transposed conv, the mask, the resblocks' mean, and with ``final`` leaky(0.01),
    conv_post, tanh and the mask."""
    cast = lambda a: jnp.asarray(a, dtype)  # noqa: E731
    with jax.disable_jit():
        h = jax_conv.leaky_relu(cast(x), SLOPE)
        h = jax_conv.conv_transpose1d(h, cast(up_w), cast(up_b), stride=stride, padding=pad,
                                      method="phases")
        mask = jnp.repeat(cast(mask_in), stride, axis=1)
        h = h * mask
        total = None
        for p, k in zip(blocks, ks):
            out = jax_hifigan._resblock(JaxParamView({n: cast(v) for n, v in p.items()}), h,
                                        mask, k, (1, 3, 5), SLOPE)
            total = out if total is None else total + out
        h = total / len(blocks)
        if final:
            h = jnp.tanh(jax_conv.conv1d(jax_conv.leaky_relu(h, 0.01), cast(w_post), None,
                                         padding=3)) * mask
            h = h[..., 0]
        return np.asarray(h.astype(jnp.float32))


@pytest.mark.parametrize("C_in,C_out,final", [(64, 32, False), (32, 16, True)])
def test_stage_bf16_twin_matches_jax_bf16_graph(C_in, C_out, final):
    """Kernel C's bf16 serving twin against the JAX vocoder's plain bf16 stage."""
    rng = np.random.default_rng(C_out)
    lengths, ks = [40, 17], (3, 7, 11)
    x = _masked(rng, 2, 40, C_in, lengths)
    up_w = (rng.standard_normal((4, C_in, C_out)) * 0.1).astype(np.float32)
    up_b = (rng.standard_normal(C_out) * 0.1).astype(np.float32)
    w_post = (rng.standard_normal((7, C_out, 1)) * 0.3).astype(np.float32)
    blocks = [_block_params(rng, C_out, k, 0.1) for k in ks]
    b16 = lambda a: torch.tensor(a).bfloat16()  # noqa: E731
    got = fused_stage(b16(x), b16(up_w), b16(up_b), [_port_block(p, k) for p, k in
                                                     zip(blocks, ks)],
                      stride=2, up_padding=1, slope=SLOPE, lengths=torch.tensor(lengths),
                      final_conv=(b16(w_post), 3) if final else None, tier=BF16_COMPUTE_TIER)
    assert got.dtype == torch.bfloat16
    args = (x, _mask(40, lengths), up_w, up_b, blocks, ks, w_post, 2, 1, final)
    _gap_check("stage", got, _jax_stage(*args, jnp.bfloat16), _jax_stage(*args, jnp.float32))


def _flow_config():
    return dataclasses.replace(VitsConfig(), hidden_size=32, flow_size=16, num_speakers=4,
                               speaker_embedding_size=8, prior_encoder_num_flows=4,
                               prior_encoder_num_wavenet_layers=2)


@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_flow_bf16_twin_matches_jax_kernel(name):
    """Kernel 6 at bf16 serving (with speakers) against the JAX kernel in interpret
    mode on bf16 inputs and its bf16 weights packed as fp32 (its tier's bound
    plus one bf16 ulp)."""
    config = _flow_config()
    params = {k: v for k, v in random_params(config, seed=0, keep_training=False).items()
              if k.startswith("flow.")}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()}
    rng = np.random.default_rng(2)
    lengths = [40, 17, 33]
    x = (rng.standard_normal((3, 40, 16)) * _mask(40, lengths)).astype(np.float32)
    spk = rng.standard_normal((3, 1, 8)).astype(np.float32)
    precision = None if name == "fast" else name
    packed, type_a = jax_pack_flow_weights(JaxParamView(jp), config)
    cond = jax_pack_flow_cond(JaxParamView(jp), config, jnp.asarray(spk, jnp.bfloat16))
    want = jax_fused_flow(jnp.asarray(x, jnp.bfloat16), packed, type_a, config,
                          lengths=jnp.asarray(lengths, jnp.int32), cond=cond, interpret=True,
                          precision=precision)
    assert want.dtype == jnp.bfloat16
    tp = ParamView({k: v.to(torch.bfloat16) for k, v in from_jax_params(params, "cpu").items()})
    tier = resolve_tier(precision)._replace(bf16_compute=True)
    got = fused_flow(torch.tensor(x).bfloat16(), tp, config, lengths=torch.tensor(lengths),
                     speaker_embeddings=torch.tensor(spk).bfloat16(), tier=tier)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                               atol=TIER_BOUNDS[name] + BF16_ULP, rtol=0)


@pytest.mark.parametrize("name", list(TIER_BOUNDS))
def test_attention_bf16_twin_matches_jax_kernel(name):
    """Kernel A at bf16 serving at each tier against the JAX kernel in interpret
    mode on bf16 q, k, v and tables (its tier's bound plus one bf16 ulp)."""
    rng = np.random.default_rng(0)
    B, H, L, d, w = 3, 2, 40, 96, 4
    lengths = [40, 0, 23]
    q, k, v = ((rng.standard_normal((B, H, L, d)) * 0.5).astype(np.float32) for _ in range(3))
    rel_k, rel_v = ((rng.standard_normal((2 * w + 1, d)) * 0.5).astype(np.float32)
                    for _ in range(2))
    precision = None if name == "fast" else name
    want = jax_flash_rel_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v, rel_k, rel_v)), window=w,
        lengths=jnp.asarray(lengths, jnp.int32), interpret=True, precision=precision)
    assert want.dtype == jnp.bfloat16
    tier = Tier(resolve_tier(precision).mode, False, True)
    got = flash_rel_attention(*(torch.tensor(a).bfloat16() for a in (q, k, v, rel_k, rel_v)),
                              window=w, lengths=torch.tensor(lengths), tier=tier)
    assert got.dtype == torch.bfloat16
    scale = max(1.0, float(np.abs(_np(want)).max()))
    np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                               atol=TIER_BOUNDS[name] + BF16_ULP, rtol=0)


def test_bf16_compute_tiers_resolve_as_the_jax_engine():
    """Tiers.bf16_compute: every vocoder stage XLA's bf16 graph whatever the precision;
    A and 6 at the collapsed tier of a per-stage spec, with bf16 in and out."""
    tiers = Tiers.bf16_compute("high,high,highest,highest")
    assert all(tiers.stage(i) == BF16_COMPUTE_TIER for i in range(4))
    assert tiers.attention == Tier(resolve_tier("highest").mode, False, True) == tiers.flow
    assert tiers.compute_dtype == torch.bfloat16
    off = Tiers.bf16_compute(None, attention=False, flow=False)
    assert not off.attention.bf16_compute and off.flow.bf16_compute
    port = vits_tpu_torch.load_model(GGML, EngineConfig(compute_dtype="bfloat16"), device="cpu")
    assert not port.tiers.attention.bf16_compute  # the JAX engine's CPU default: kernel A off
    with pytest.raises(ValueError, match="compute_dtype"):
        vits_tpu_torch.load_model(GGML, EngineConfig(compute_dtype="float16"), device="cpu")


def test_longform_and_warmup_bf16(bf16_model):
    """Long-form synthesis and warmup on a bf16 engine: fp32 PCM, one chunk per
    sentence's length, and a warmed shape adds no dispatch shape."""
    from vits_tpu_torch.engine.longform import synthesize_long

    audio = synthesize_long(bf16_model, "One sentence here. And another one!", seed=2)
    assert audio.dtype == np.float32 and audio.size > 0 and np.isfinite(audio).all()
    bf16_model.warmup(batch_sizes=(1,), token_buckets=(32, 64), overflow_ladder=1)
    shapes = set(bf16_model._dispatch_shapes)
    bf16_model.synthesize("hello", seed=0)
    assert bf16_model._dispatch_shapes == shapes


def test_server_serves_a_bf16_engine():
    """``serve`` over a bf16 engine (the JAX server has no ``--dtype``; a program
    passes the engine): /synthesize returns the engine's audio as WAV."""
    import json
    import threading
    import urllib.request

    from vits_tpu_torch.engine.server import serve
    from vits_tpu_torch.utils.wav import read_wav

    model = vits_tpu_torch.load_model(
        GGML, EngineConfig(compute_dtype="bfloat16", token_buckets=(32,)), device="cpu")
    server, worker = serve(model, port=0, batch_window_ms=5.0, max_batch=4)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/synthesize",
            data=json.dumps({"text": "hello dame", "seed": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            audio = read_wav(resp.read())[0]
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    want = model.synthesize("hello dame", seed=4)
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=1.5 / 32767, rtol=0)
