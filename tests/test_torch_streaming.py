"""The port's streaming decode (``vits_tpu_torch.engine.streaming``) on the CPU.

Mirrors ``tests/test_streaming.py``: the concatenated stream equals the
one-shot decode within 2e-6 (that test's bound; the windows run the plain
twins over fewer frames than the whole utterance, so the convs may sum in
another order), each chunk but the last is a multiple of ``total_upsample``,
zero margins detectably diverge, and ``warmup`` records its shapes. The
engines are built as there (``token_buckets=(64,)``, ``frames_per_token=4.0``,
``transfer_int16=False``) and with ``adaptive_capacity=False``: the prior's
noise is drawn at the frame capacity, so a stream equals a one-shot request
only when both run at the same capacity, and the stream keeps the static
``frame_bucket``. The tests run with oneDNN off (``plain_convs_fixed_order``):
oneDNN picks its conv algorithm per sequence length, so the same output frame
sums in another order in a 144-frame window than in a 1024-frame utterance
(~1e-6 of the output's scale); PyTorch's own conv sums every output in one
order whatever the length. One test holds the port's window decode against the JAX
package's ``StreamingDecoder._decode_fn`` on the same prior latents, at the
whole-slice bounds of ``tests/test_torch_synthesis.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.config import EngineConfig as JaxEngineConfig
from vits_tpu.engine.streaming import StreamingDecoder as JaxStreamingDecoder
from vits_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from vits_tpu.text.tokenizer import VitsTokenizer as JaxVitsTokenizer
from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine.streaming import StreamingDecoder
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.text.tokenizer import VitsTokenizer

torch.set_num_threads(2)

VOCAB = {c: i for i, c in enumerate("kzyuvdheswm' ablc")}
TEXT = "hello sad dame well cheese"
EXACT = 2e-6  # tests/test_streaming.py's bound
WAVE_ATOL = 2e-4  # port vs JAX, tests/test_torch_synthesis.py's whole-slice bound


@pytest.fixture(scope="module", autouse=True)
def plain_convs_fixed_order():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _engine(**kw):
    return EngineConfig(**{**dict(token_buckets=(64,), frames_per_token=4.0,
                                  transfer_int16=False, adaptive_capacity=False), **kw})


@pytest.fixture(scope="module")
def model(tiny_bundle):
    config, params = tiny_bundle
    tok = VitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z")
    return Synthesizer(config, tok, params, _engine(), device="cpu")


def test_stream_concat_equals_oneshot(model):
    oneshot = model.synthesize(TEXT, seed=5)
    stream = StreamingDecoder(model, chunk_frames=32, margin_frames=16)
    streamed = stream.synthesize_streaming(TEXT, seed=5)
    assert streamed.shape == oneshot.shape
    np.testing.assert_allclose(streamed, oneshot, atol=EXACT, rtol=0)


def test_stream_yields_multiple_chunks(model):
    chunks = list(StreamingDecoder(model, chunk_frames=16, margin_frames=16).stream(TEXT, seed=5))
    assert len(chunks) >= 2
    up = model.config.total_upsample
    assert all(len(c) % up == 0 for c in chunks[:-1])


def test_stream_small_margin_detectably_diverges(model):
    """A 0 margin must NOT be exact (otherwise the overlap machinery is vacuous)."""
    oneshot = model.synthesize(TEXT, seed=5)
    streamed = StreamingDecoder(
        model, chunk_frames=16, margin_frames=0, flow_margin_frames=0
    ).synthesize_streaming(TEXT, seed=5)
    assert streamed.shape == oneshot.shape
    assert not np.allclose(streamed, oneshot, atol=EXACT, rtol=0)


def test_warmup_records_stream_shapes(model):
    """warmup runs the prior and the window decode of every shape a stream of
    its buckets runs (here the base capacity and two rungs); a stream after it
    adds no shape and still matches the one-shot decode."""
    stream = StreamingDecoder(model, chunk_frames=32, margin_frames=16)
    stream.warmup(overflow_ladder=2)
    window = stream.chunk_frames + 2 * stream.total_margin
    base = model.engine.frame_bucket(64)
    want = {("prior", 64, base * 2 ** r, False) for r in range(3)}
    want |= {("window", 1, min(window, base * 2 ** r), False) for r in range(3)}
    assert stream._dispatch_shapes == want
    streamed = stream.synthesize_streaming(TEXT, seed=5)
    assert stream._dispatch_shapes == want
    np.testing.assert_allclose(streamed, model.synthesize(TEXT, seed=5), atol=EXACT, rtol=0)


def test_overflow_ladder_stream_equals_oneshot(tiny_bundle):
    """frames_per_token=1: the base capacity (64 frames) holds more than one
    window but overflows, so the speculative first window is discarded, the
    prior runs again at a doubled capacity, and the stream still equals the
    one-shot request (which re-dispatches the same way)."""
    config, params = tiny_bundle
    tok = VitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z")
    small = Synthesizer(config, tok, params, _engine(frames_per_token=1.0), device="cpu")
    stream = StreamingDecoder(small, chunk_frames=8, margin_frames=8, flow_margin_frames=12)
    assert stream.chunk_frames + 2 * stream.total_margin < small.engine.frame_bucket(64)
    streamed = stream.synthesize_streaming(TEXT, seed=5)
    priors = sorted(s[2] for s in stream._dispatch_shapes if s[0] == "prior")
    base = small.engine.frame_bucket(64)
    assert len(priors) >= 2 and priors[0] == base
    assert all(p % base == 0 and (p // base) & (p // base - 1) == 0 for p in priors)
    oneshot = small.synthesize(TEXT, seed=5)
    assert small.stats["redispatches"] >= 1
    assert streamed.shape == oneshot.shape
    np.testing.assert_allclose(streamed, oneshot, atol=EXACT, rtol=0)


def test_window_decode_matches_jax(tiny_bundle, model):
    """The port's window decode vs JAX ``_decode_fn(window)`` on the same prior
    latents and mask: a first window, a middle one and the last, partial one
    (frames past the predicted length masked)."""
    config, params = tiny_bundle
    jax_model = JaxSynthesizer(
        config, JaxVitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z"), params,
        JaxEngineConfig(token_buckets=(64,), frames_per_token=4.0, transfer_int16=False))
    ours = StreamingDecoder(model, chunk_frames=32, margin_frames=16)
    theirs = JaxStreamingDecoder(jax_model, chunk_frames=32, margin_frames=16)
    window = ours.chunk_frames + 2 * ours.total_margin
    rng = np.random.default_rng(3)
    frames, valid = 3 * window, 3 * window - 50
    latents = rng.standard_normal((1, frames, config.flow_size)).astype(np.float32)
    mask3 = (np.arange(frames) < valid).astype(np.float32)[None, :, None]
    for lo in (0, window, frames - window):
        piece, m = latents[:, lo: lo + window], mask3[:, lo: lo + window]
        got = ours._resolve(ours._dispatch_window(torch.tensor(latents), torch.tensor(mask3),
                                                  None, lo, window))
        want = np.asarray(theirs._decode_fn(window)(theirs._params, jnp.asarray(piece),
                                                    jnp.asarray(m), None))
        assert got.shape == want.shape == (1, window * config.total_upsample)
        np.testing.assert_allclose(got, want, atol=WAVE_ATOL, rtol=0)
    assert not got[0, (valid - (frames - window)) * config.total_upsample:].any()
