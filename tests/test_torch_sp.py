"""The port's time-sharded decode (``vits_tpu_torch.engine.sp``) on the CPU.

Mirrors ``tests/test_sp.py``: 8, 3 and 2 shards over ``[cpu] * n`` meshes
equal the port's one-shot decode within 2e-6 (``tests/test_streaming.py``'s
bound: a window runs the plain convs over fewer frames than the whole
utterance), a one-token text, the overflow ladder and a speaker included; a
mesh engine's replicas are reused; no mesh raises. One window decode is held
against JAX's ``ShardedDecoder._decode_fn`` on the same padded prior, at the
whole-slice bound. The engines keep a static frame capacity
(``adaptive_capacity=False``): the prior's noise is drawn at the capacity, so
the sharded and the one-shot decode agree when both run at one. oneDNN is
off, as in the streaming tests: it picks its conv algorithm per length.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vits_tpu
import vits_tpu_torch
from tests.test_multispeaker import spk_bundle, spk_hf_model  # noqa: F401 (fixtures)
from vits_tpu.config import EngineConfig as JaxEngineConfig
from vits_tpu.engine.sp import ShardedDecoder as JaxShardedDecoder
from vits_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vits_tpu_torch import cli
from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine.sp import ShardedDecoder
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.parallel.mesh import make_mesh
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.utils.wav import read_wav

torch.set_num_threads(2)

GGML = "tests/fixtures/tiny-vits.ggml"
ENGINE_KW = dict(token_buckets=(64,), frames_per_token=4.0, transfer_int16=False,
                 adaptive_capacity=False)
EXACT = 2e-6  # tests/test_streaming.py's bound
WAVE_ATOL = 2e-4  # port vs JAX, tests/test_torch_synthesis.py's whole-slice bound
INT16_STEP = 1.5 / 32767  # at most one int16 level apart
TEXT = "hello sharded decoder well cheese and more words to say"
SPK_VOCAB = "kzyuvdheswm' ablcfgijnopqrtx0123456789"


def cpus(n):
    return make_mesh(devices=[torch.device("cpu")] * n)


@pytest.fixture(scope="module", autouse=True)
def plain_convs_fixed_order():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def model():
    return vits_tpu_torch.load_model(GGML, EngineConfig(**ENGINE_KW), device="cpu")


@pytest.fixture(scope="module")
def sp8(model):
    return ShardedDecoder(model, mesh=cpus(8))


@pytest.mark.parametrize("text,seed", [
    (TEXT, 6),
    ("a", 0),  # one token: most shards decode only the zero-masked tail
    ("my sweet valley hums a song of sad dames and wellness", 123),
])
def test_eight_shards_equal_oneshot(model, sp8, text, seed):
    ref = model.synthesize(text, seed=seed)
    got = sp8.synthesize(text, seed=seed)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=EXACT, rtol=0)


@pytest.mark.parametrize("n", [2, 3])
def test_few_shards_equal_oneshot(model, n):
    """2 shards, and 3 over a capacity that 3 does not divide (ceil + tail padding)."""
    text = "hello sad dame be well"
    sp = ShardedDecoder(model, mesh=cpus(n))
    assert len(sp.replicas) == n and sp.replicas is not model.replicas
    ref = model.synthesize(text, seed=2)
    got = sp.synthesize(text, seed=2)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=EXACT, rtol=0)


def test_controls_and_overflow_ladder(model, sp8):
    """speaking_rate=0.5 overflows the capacity: the prior rides the doubling
    ladder, as the one-shot request's re-dispatch does."""
    text = "hello sad dame be well and hum"
    kw = dict(seed=9, speaking_rate=0.5)
    before = model.stats["redispatches"]
    ref = model.synthesize(text, **kw)
    assert model.stats["redispatches"] > before
    got = sp8.synthesize(text, **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=EXACT, rtol=0)


@pytest.mark.parametrize("flow_kernel", [False, True])
def test_speaker_conditioning(spk_bundle, flow_kernel):  # noqa: F811
    """A multi-speaker model over 3 shards, with the plain flow and with kernel
    6's plain twin (``use_pallas_flow``), which masks by per-row length: every
    window's masked frames sit at its end."""
    config, params = spk_bundle
    tok = VitsTokenizer(vocab={c: i for i, c in enumerate(SPK_VOCAB[:config.vocab_size])},
                        pad_token="k", unk_token="z")
    eng = Synthesizer(config, tok, params,
                      EngineConfig(**ENGINE_KW, use_pallas_flow=flow_kernel), device="cpu")
    sp = ShardedDecoder(eng, mesh=cpus(3))
    for speaker in (1, 3):
        ref = eng.synthesize("hello well spoken", seed=4, speaker_id=speaker)
        got = sp.synthesize("hello well spoken", seed=4, speaker_id=speaker)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=EXACT, rtol=0)


def test_mesh_synthesizer_replicas_reused(model):
    mesh = cpus(4)
    m = vits_tpu_torch.load_model(GGML, EngineConfig(**ENGINE_KW), mesh=mesh)
    sp = ShardedDecoder(m, mesh=mesh)
    assert sp.replicas is m.replicas  # the replicas are shared, not copied
    assert ShardedDecoder(m).replicas is m.replicas
    np.testing.assert_allclose(sp.synthesize("hello mesh engine", seed=1),
                               model.synthesize("hello mesh engine", seed=1),
                               atol=EXACT, rtol=0)


def test_requires_mesh(model):
    with pytest.raises(ValueError, match="mesh"):
        ShardedDecoder(model)


def test_window_decode_matches_jax(model, sp8):
    """Each replica's window decode against JAX's ``_decode_fn`` (shard_map over
    8 virtual CPU devices) on the same prior: JAX pads the prior by the margin
    at both ends and decodes ``[i * shard, i * shard + window)`` of that; the
    port's window starts at frame 0 where JAX's would start in the front pad
    (its length-masked kernels would read a masked front as valid frames).
    Every replica's interior against JAX's."""
    config = model.config
    jax_model = vits_tpu.load_model(GGML, JaxEngineConfig(
        token_buckets=(64,), frames_per_token=4.0, use_pallas_vocoder=False,
        use_pallas_attention=False, transfer_int16=False))
    theirs = JaxShardedDecoder(jax_model, mesh=jax_make_mesh(data=8, model=1))
    n, m, num_frames = 8, theirs.total_margin, 200
    assert sp8.total_margin == m
    shard = -(-num_frames // n)
    window, padded, up = shard + 2 * m, max(shard * n, shard + 2 * m), config.total_upsample
    rng = np.random.default_rng(3)
    valid = 150
    mask = (np.arange(num_frames) < valid).astype(np.float32)[None]
    prior = rng.standard_normal((1, num_frames, config.flow_size)).astype(np.float32)
    prior *= mask[..., None]
    tail = shard * n - num_frames
    want = np.asarray(theirs._decode_fn(num_frames, False)(
        theirs._params, jnp.asarray(np.pad(prior, ((0, 0), (m, m + tail), (0, 0)))),
        jnp.asarray(np.pad(mask, ((0, 0), (m, m + tail)))), None))
    assert want.shape == (1, shard * n * up)
    latents = torch.tensor(np.pad(prior, ((0, 0), (0, padded - num_frames), (0, 0))))
    mask3 = torch.tensor(np.pad(mask, ((0, 0), (0, padded - num_frames)))[..., None])
    for i in range(n):
        lo = min(max(i * shard - m, 0), padded - window)
        with torch.inference_mode():
            got = sp8._decode_shard(sp8.replicas[i], latents, mask3, None, lo, window,
                                    i * shard - lo, shard)
        assert got.shape == (1, shard * up)
        np.testing.assert_allclose(got, want[:, i * shard * up: (i + 1) * shard * up],
                                   atol=WAVE_ATOL, rtol=0)
    assert len(jax.devices()) >= 8


def test_cli_sp_on_cpu(tmp_path, model, monkeypatch):
    """``python -m vits_tpu_torch.cli --sp 2 --device cpu``: the engine is the
    two-replica mesh engine and the decoder reuses its replicas (one copy of the
    weights a replica); the sharded decode of each text, written as WAV, equals
    the one-shot decode within an int16 step."""
    built = []
    init = ShardedDecoder.__init__

    def recording(self, synthesizer, *args, **kw):
        init(self, synthesizer, *args, **kw)
        built.append((self.replicas is synthesizer.replicas, len(self.replicas)))

    monkeypatch.setattr(ShardedDecoder, "__init__", recording)
    out = str(tmp_path / "out.wav")
    assert cli.main(["--model", GGML, "--device", "cpu", "--text", TEXT, "--seed", "6",
                     "--sp", "2", "--out", out]) == 0
    assert built == [(True, 2)]
    audio, _ = read_wav(out)
    want = vits_tpu_torch.load_model(GGML, EngineConfig(transfer_int16=False),
                                     device="cpu").synthesize(TEXT, seed=6)
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=INT16_STEP, rtol=0)


def test_cli_sp_without_cards_exits_nonzero(tmp_path, capsys):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are visible")
    out = str(tmp_path / "out.wav")
    assert cli.main(["--model", GGML, "--device", "cuda", "--text", "hi", "--sp", "2",
                     "--out", out]) != 0
    assert "CUDA device" in capsys.readouterr().err and not os.path.exists(out)
