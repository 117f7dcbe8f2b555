"""Multi-speaker synthesis and voice conversion in the port, against the JAX package.

On the multi-speaker test model of ``tests/test_multispeaker.py`` (4
speakers, 8-wide embeddings; its vocoder stages are 16 and 8 channels wide
and fail the stage kernel's check, so they take kernel 7): the speaker
weights cross ``from_jax_params`` unchanged; each conditioned module matches
its JAX counterpart on seeded numpy inputs (atol 1e-5, fp32 summation order);
``synthesize(speaker_id=, use_pallas_flow=True)`` matches JAX's with its
Pallas vocoder and flow (interpret mode, ``precision="highest"``) given the
same ``NoiseOverride`` (waveform atol 2e-4 and latents atol 5e-4, the bounds
of ``tests/test_torch_synthesis.py``); ``voice_convert`` matches with the same
noise. Then the engine (``use_pallas_flow=True``, which on the CPU runs the
plain flow): per-row speakers, batch rows equal to solo runs, and
deterministic conversion.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_multispeaker import spk_bundle, spk_hf_model  # noqa: F401 (fixtures)
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.models import duration as jax_duration
from vits_tpu.models import flow as jax_flow
from vits_tpu.models import hifigan as jax_hifigan
from vits_tpu.models import posterior as jax_posterior
from vits_tpu.models import vits as jax_vits
from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.io import VitsTokenizer
from vits_tpu_torch.io.params import ParamView, from_jax_params
from vits_tpu_torch.models import duration, flow, hifigan, posterior, vits

torch.set_num_threads(2)

ATOL = 1e-5
WAVE_ATOL, LATENT_ATOL = 2e-4, 5e-4
INT16_STEP = 1.5 / 32767
VOCAB = "kzyuvdheswm' ablcfgijnopqrtx0123456789"


def test_from_jax_params_carries_speaker_weights(spk_bundle):  # noqa: F811
    config, params = spk_bundle
    names = [n for n in params if n == "embed_speaker.weight" or ".cond_layer." in n
             or n.startswith(("duration_predictor.cond.", "decoder.cond."))]
    assert "embed_speaker.weight" in names and "decoder.cond.weight" in names
    assert "duration_predictor.cond.weight" in names
    assert sum(".cond_layer.weight" in n for n in names) == config.prior_encoder_num_flows + 1
    tensors = from_jax_params(params, "cpu")
    for n in names:
        np.testing.assert_array_equal(tensors[n].numpy(), params[n])


def _module_pair(name, config, params, rng):
    """(JAX output, port output) of one conditioned module on the same inputs."""
    B, T = 2, 13
    mask = np.ones((B, T, 1), np.float32)
    mask[1, 9:] = 0.0
    emb = rng.standard_normal((B, 1, config.speaker_embedding_size)).astype(np.float32)
    jp, tp = JaxParamView(params), ParamView(from_jax_params(params, "cpu"))
    j, t = jnp.asarray, torch.tensor

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32) * mask[..., :1]

    if name == "sdp_reverse":
        h, noise = draw(B, T, config.hidden_size), draw(B, T, 2)
        return (jax_duration.stochastic_duration_predictor_reverse(
                    jp, config, j(h), j(mask), j(noise), 0.8, j(emb)),
                duration.stochastic_duration_predictor_reverse(
                    tp, config, t(h), t(mask), t(noise), 0.8, t(emb)))
    if name == "sdp_nll":
        h, noise = draw(B, T, config.hidden_size), draw(B, T, 2)
        dur = np.abs(draw(B, T, 1)) * 3 + mask
        return (jax_duration.stochastic_duration_predictor_nll(
                    jp, config, j(h), j(mask), j(dur), j(noise), j(emb)),
                duration.stochastic_duration_predictor_nll(
                    tp, config, t(h), t(mask), t(dur), t(noise), t(emb)))
    if name == "posterior":
        spec, noise = draw(B, T, config.spectrogram_bins), draw(B, T, config.flow_size)
        return (jax_posterior.posterior_encoder(jp, config, j(spec), j(mask), j(noise), j(emb)),
                posterior.posterior_encoder(tp, config, t(spec), t(mask), t(noise), t(emb)))
    z = draw(B, T, config.flow_size)
    if name == "flow_forward":
        return (jax_flow.residual_coupling_block(jp, config, j(z), j(mask), j(emb),
                                                 reverse=False),
                flow.residual_coupling_forward(tp, config, t(z), t(mask), t(emb)))
    if name == "flow_reverse":
        return (jax_flow.residual_coupling_block(jp, config, j(z), j(mask), j(emb))[0],
                flow.residual_coupling_block(tp, config, t(z), t(mask), t(emb)))
    assert name == "hifigan"
    return (jax_hifigan.hifigan(jp, config, j(z), j(mask), j(emb)),
            hifigan.hifigan(tp, config, t(z), t(mask), t(emb)))


@pytest.mark.parametrize("name", ["sdp_reverse", "sdp_nll", "posterior", "flow_forward",
                                  "flow_reverse", "hifigan"])
def test_conditioned_module_matches_jax(name, spk_bundle):  # noqa: F811
    config, params = spk_bundle
    want, got = _module_pair(name, config, params, np.random.default_rng(4))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=1e-5)


def test_deterministic_duration_predictor_with_speaker_matches_jax():
    from transformers import VitsConfig as HFVitsConfig
    from transformers import VitsModel

    from vits_tpu.io.loader import load_hf_module

    torch.manual_seed(2)
    model = VitsModel(HFVitsConfig(
        vocab_size=38, hidden_size=32, num_hidden_layers=1, num_attention_heads=2, ffn_dim=64,
        flow_size=16, spectrogram_bins=65, upsample_initial_channel=32, upsample_rates=[4, 4],
        upsample_kernel_sizes=[8, 8], resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1]],
        prior_encoder_num_flows=2, prior_encoder_num_wavenet_layers=1,
        duration_predictor_filter_channels=32, use_stochastic_duration_prediction=False,
        num_speakers=3, speaker_embedding_size=8)).eval()
    config, _, params = load_hf_module(model)
    rng = np.random.default_rng(6)
    mask = np.ones((2, 11, 1), np.float32)
    mask[0, 7:] = 0.0
    h = rng.standard_normal((2, 11, config.hidden_size)).astype(np.float32) * mask
    emb = rng.standard_normal((2, 1, 8)).astype(np.float32)
    want = jax_duration.duration_predictor(JaxParamView(params), config, jnp.asarray(h),
                                           jnp.asarray(mask), jnp.asarray(emb))
    got = duration.duration_predictor(ParamView(from_jax_params(params, "cpu")), config,
                                      torch.tensor(h), torch.tensor(mask), torch.tensor(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


def test_synthesize_with_speakers_and_fused_flow_matches_jax(spk_bundle):  # noqa: F811
    """Speakers (2, 0, 3) over a ragged batch; JAX with its Pallas vocoder (fused_resblock
    at C = 16, 8) and fused flow, the port with kernel 6's and 7's plain versions."""
    config, params = spk_bundle
    rng = np.random.default_rng(8)
    B, T, F = 3, 10, 32
    lengths = np.array([10, 4, 7])
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    ids = rng.integers(1, config.vocab_size, size=(B, T)).astype(np.int32) * mask.astype(np.int32)
    dur = rng.standard_normal((B, T, 2)).astype(np.float32)
    prior = rng.standard_normal((B, F, config.flow_size)).astype(np.float32)
    spk = np.array([2, 0, 3], np.int32)
    want = jax_vits.synthesize(
        params, config, jnp.asarray(ids), jnp.asarray(mask), F,
        noise=jax_vits.NoiseOverride(jnp.asarray(dur), jnp.asarray(prior)),
        speaker_id=jnp.asarray(spk), use_pallas=True, use_pallas_flow=True,
        pallas_precision="highest")
    got = vits.synthesize(
        from_jax_params(params, "cpu"), config, torch.tensor(ids, dtype=torch.long),
        torch.tensor(mask), F, noise=vits.NoiseOverride(torch.tensor(dur), torch.tensor(prior)),
        speaker_id=torch.tensor(spk), use_pallas_flow=True)
    np.testing.assert_array_equal(got.frame_lengths.numpy(), np.asarray(want.frame_lengths))
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=LATENT_ATOL, rtol=0)
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(want.waveform),
                               atol=WAVE_ATOL, rtol=0)


def test_voice_convert_matches_jax(spk_bundle):  # noqa: F811
    config, params = spk_bundle
    rng = np.random.default_rng(9)
    B, F = 2, 14
    spec = np.abs(rng.standard_normal((B, F, config.spectrogram_bins))).astype(np.float32)
    mask = np.ones((B, F), np.float32)
    mask[1, 10:] = 0.0
    noise = rng.standard_normal((B, F, config.flow_size)).astype(np.float32)
    src, tgt = np.array([1, 3], np.int32), np.array([3, 0], np.int32)
    want = jax_vits.voice_convert(params, config, jnp.asarray(spec), jnp.asarray(mask),
                                  jnp.asarray(src), jnp.asarray(tgt), noise=jnp.asarray(noise),
                                  noise_scale=0.7)
    got = vits.voice_convert(from_jax_params(params, "cpu"), config, torch.tensor(spec),
                             torch.tensor(mask), torch.tensor(src), torch.tensor(tgt),
                             noise=torch.tensor(noise), noise_scale=0.7)
    for name in ("posterior_mean", "latents", "waveform"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   atol=WAVE_ATOL, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def spk_engine(spk_bundle):  # noqa: F811
    config, params = spk_bundle
    tokenizer = VitsTokenizer(vocab={c: i for i, c in enumerate(VOCAB[:config.vocab_size])},
                              pad_token="k", unk_token="z")
    return Synthesizer(config, tokenizer, params, EngineConfig(use_pallas_flow=True), device="cpu")


def test_engine_speaker_batch_rows_equal_solo_runs(spk_engine):
    texts, seeds, speakers = ["hello world", "good day to you", "hi"], [3, 4, 5], [1, 3, 0]
    batch = spk_engine.synthesize_raw(texts, seed=seeds, speaker_id=speakers)
    for i, (text, seed, spk) in enumerate(zip(texts, seeds, speakers)):
        solo = spk_engine.synthesize_raw([text], seed=[seed], speaker_id=spk)
        assert batch.frame_lengths[i] == solo.frame_lengths[0]
        n = solo.lengths[0]
        np.testing.assert_allclose(batch.waveform[i, :n], solo.waveform[0, :n],
                                   atol=INT16_STEP, rtol=0)
    a, b = (spk_engine.synthesize("hello world", seed=7, speaker_id=s) for s in (0, 3))
    assert a.shape != b.shape or not np.allclose(a, b)
    with pytest.raises(ValueError, match="speaker"):
        spk_engine.synthesize("hello", speaker_id=[1, 2])


def test_engine_convert_voice_posterior_mean_is_deterministic(spk_engine):
    hop = spk_engine.config.total_upsample
    audio = spk_engine.synthesize("hello world", seed=1, speaker_id=0)
    first = spk_engine.convert_voice(audio, source_speaker=0, target_speaker=3)
    again = spk_engine.convert_voice(audio, source_speaker=0, target_speaker=3)
    assert first.shape == ((len(audio) // hop) * hop,) and np.isfinite(first).all()
    np.testing.assert_array_equal(first, again)
    rows = spk_engine.convert_voice([audio, audio[: 5 * hop]], source_speaker=0,
                                    target_speaker=[3, 3], noise_scale=0.5, seed=2)
    assert [len(r) for r in rows] == [len(first), 5 * hop]
