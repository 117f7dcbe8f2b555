"""The port's multiplexed streaming (``vits_tpu_torch.engine.mux``) on the CPU.

Mirrors ``tests/test_mux.py``: MultiplexedStreamingDecoder output equals the
solo StreamingDecoder's and the one-shot synthesis, within 2e-6, for a solo
stream, concurrent mixed-seed streams (with fewer dispatches than windows)
and a short utterance on the mask-padded full-window path; ``warmup`` runs
the window decode at every batch bucket. As in
``tests/test_torch_streaming.py``, the engine keeps the static frame
capacity and the plain convs run with oneDNN off, which sums each output in
one order whatever the sequence length and batch size.
"""

import threading

import numpy as np
import pytest
import torch

from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine.mux import MultiplexedStreamingDecoder
from vits_tpu_torch.engine.streaming import StreamingDecoder
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.text.tokenizer import VitsTokenizer

torch.set_num_threads(2)

VOCAB = {c: i for i, c in enumerate("kzyuvdheswm' ablc")}
TEXT = "hello sad dame well cheese"
EXACT = 2e-6  # tests/test_mux.py's bound


@pytest.fixture(scope="module", autouse=True)
def plain_convs_fixed_order():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture(scope="module")
def model(tiny_bundle):
    config, params = tiny_bundle
    tok = VitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z")
    eng = EngineConfig(token_buckets=(64,), frames_per_token=4.0, transfer_int16=False,
                       adaptive_capacity=False)
    return Synthesizer(config, tok, params, eng, device="cpu")


def test_mux_single_stream_equals_oneshot(model):
    oneshot = model.synthesize(TEXT, seed=5)
    mux = MultiplexedStreamingDecoder(model, chunk_frames=32, margin_frames=16, max_batch=4)
    try:
        streamed = mux.synthesize_streaming(TEXT, seed=5)
    finally:
        mux.stop()
    assert streamed.shape == oneshot.shape
    np.testing.assert_allclose(streamed, oneshot, atol=EXACT, rtol=0)


def test_mux_concurrent_streams_exact_and_batched(model):
    """Three concurrent streams: each within 2e-6 of the SOLO streaming
    decoder, and the worker coalesced windows (fewer dispatches than windows)."""
    texts = [TEXT, "hello dame", "cheese well said hello sad dame"]
    seeds = [5, 11, 23]
    solo = StreamingDecoder(model, chunk_frames=16, margin_frames=16)
    expected = [solo.synthesize_streaming(t, seed=s) for t, s in zip(texts, seeds)]

    mux = MultiplexedStreamingDecoder(
        model, chunk_frames=16, margin_frames=16, max_batch=4,
        batch_window_ms=100.0,  # generous pickup so the threads coalesce
    )
    results = [None] * len(texts)
    errors = []

    def run(i):
        try:
            results[i] = mux.synthesize_streaming(texts[i], seed=seeds[i])
        except Exception as exc:  # surfaced below
            errors.append((i, exc))

    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(texts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
    finally:
        mux.stop()

    assert not errors, errors
    for got, want in zip(results, expected):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=EXACT, rtol=0)
    assert mux.stats["max_rows"] >= 2, mux.stats  # coalescing happened
    assert mux.stats["dispatches"] < mux.stats["windows"], mux.stats


def test_mux_short_utterance_padded_path(model):
    """An utterance that fits in one window rides the mask-padded full-window
    decode and still matches one-shot synthesis. (A 160-frame chunk: at
    tests/test_mux.py's 64 the 256-frame capacity is longer than the window.)"""
    oneshot = model.synthesize("hi", seed=3)
    mux = MultiplexedStreamingDecoder(model, chunk_frames=160, margin_frames=20, max_batch=4)
    try:
        streamed = mux.synthesize_streaming("hi", seed=3)
    finally:
        mux.stop()
    assert model.engine.frame_bucket(64) < mux._window
    assert streamed.shape == oneshot.shape
    np.testing.assert_allclose(streamed, oneshot, atol=EXACT, rtol=0)


def test_mux_warmup_runs_bucketed_windows(model):
    """warmup runs the window decode at batch 1, 2 and 4; a stream after it
    runs no new shape."""
    mux = MultiplexedStreamingDecoder(model, chunk_frames=32, margin_frames=16, max_batch=4)
    try:
        mux.warmup()
        window = mux._window
        assert {("window", b, window, False) for b in (1, 2, 4)} <= mux._dispatch_shapes
        before = set(mux._dispatch_shapes)
        mux.synthesize_streaming(TEXT, seed=5)
        assert mux._dispatch_shapes == before
    finally:
        mux.stop()
