"""The port's engine, loaded through ``vits_tpu_torch.load_model`` on the CPU.

Noise contract, batching parity (a padded row equals its solo run), seed
determinism, the overflow re-dispatch ladder, warmup, batch buckets,
long-form synthesis, and the EngineConfig fields the port refuses (its
kernels cannot be turned off). Waveforms cross to the host as int16 PCM, so two runs that agree in fp32
may differ by one int16 step (1/32767): rows of batches of different sizes
are held within INT16_STEP (the plain convs' summation order follows the
batch size), rows of the same dispatch bit for bit.
"""

import numpy as np
import pytest
import torch

import vits_tpu_torch
from vits_tpu.config import EngineConfig
from vits_tpu.engine.longform import split_sentences as jax_split_sentences
from vits_tpu_torch.engine.longform import split_sentences, synthesize_long
from vits_tpu_torch.models import vits
from vits_tpu_torch.ops.cuda import flow as flow_module

torch.set_num_threads(2)

GGML = "tests/fixtures/tiny-vits.ggml"
INT16_STEP = 1.5 / 32767  # at most one int16 level apart


def test_per_row_noise_does_not_depend_on_capacity():
    gens = lambda: [torch.Generator().manual_seed(s) for s in (4, 9)]  # noqa: E731
    short = vits.draw_noise(gens(), 2, 8, 40, 16, torch.device("cpu"))
    long = vits.draw_noise(gens(), 2, 8, 200, 16, torch.device("cpu"))
    torch.testing.assert_close(long.prior[:, :40], short.prior, rtol=0, atol=0)
    torch.testing.assert_close(long.duration, short.duration, rtol=0, atol=0)


@pytest.fixture(scope="module")
def model():
    return vits_tpu_torch.load_model(GGML, device="cpu")


def test_load_model_synthesizes_on_cpu(model):
    audio = model.synthesize("hello world")
    assert audio.ndim == 1 and audio.dtype == np.float32 and audio.size > 0
    assert np.isfinite(audio).all() and np.abs(audio).max() <= 1.0


def test_padded_batch_row_equals_solo_run(model):
    batch = model.synthesize_raw(["hello world, how are you", "hi there"], seed=[3, 5])
    solo = model.synthesize_raw(["hi there"], seed=[5])
    assert batch.frame_lengths[1] == solo.frame_lengths[0]
    n = solo.lengths[0]
    assert n > 0 and batch.lengths[1] == n
    np.testing.assert_allclose(batch.waveform[1, :n], solo.waveform[0, :n], atol=INT16_STEP, rtol=0)
    assert np.abs(batch.waveform[1, n:]).max() == 0.0


def test_same_seed_same_audio(model):
    a = model.synthesize("hello world", seed=7)
    np.testing.assert_array_equal(a, model.synthesize("hello world", seed=7))
    rows = model.synthesize(["hello", "world"], seed=[11, 12])
    again = model.synthesize(["hello", "world"], seed=[11, 12])
    for x, y in zip(rows, again):
        np.testing.assert_array_equal(x, y)
    swapped = model.synthesize(["hello", "world"], seed=[12, 12])
    assert not np.array_equal(rows[0], swapped[0])


def test_overflow_redispatches_at_double_capacity():
    small = vits_tpu_torch.load_model(
        GGML, EngineConfig(frames_per_token=0.25, adaptive_capacity=False), device="cpu")
    roomy = vits_tpu_torch.load_model(GGML, EngineConfig(frames_per_token=4.0), device="cpu")
    text = "hello world"
    out = small.synthesize_raw([text], seed=[2])
    ref = roomy.synthesize_raw([text], seed=[2])
    assert small.stats["redispatches"] >= 1 and roomy.stats["redispatches"] == 0
    assert out.frame_lengths[0] == ref.frame_lengths[0]
    n = ref.lengths[0]
    assert out.lengths[0] == n
    np.testing.assert_allclose(out.waveform[0, :n], ref.waveform[0, :n], atol=INT16_STEP, rtol=0)


def test_adaptive_capacity_raises_on_overflow_and_decays():
    """As in the JAX engine: an overflow at default controls raises the working
    frames/token ratio (at most 2x per observation), a speaking-rate override
    never moves it, and a full window of dispatches that needed less lowers it."""
    eng = EngineConfig(token_buckets=(32,), frames_per_token=2.0, adaptive_capacity_window=3)
    model = vits_tpu_torch.load_model(GGML, eng, device="cpu")
    model.synthesize("hello sad dame", seed=0, speaking_rate=0.25)
    assert model.stats["redispatches"] == 1 and model._frames_per_token == 2.0
    base = model._frame_capacity(32)
    model.synthesize("hello sad dame", seed=0)  # ~10 frames/token here
    assert model._frames_per_token == 4.0 and model._frame_capacity(32) > base
    model._frames_per_token = 16.0  # as if an outlier had raised it
    for i in range(3):
        model.synthesize("bbbb", seed=i)
    assert 4.0 < model._frames_per_token < 16.0


def test_adaptive_capacity_align_stays_on_rungs():
    """adaptive_capacity_align: every raised capacity is the base doubled."""
    eng = EngineConfig(token_buckets=(32,), frames_per_token=2.0, adaptive_capacity_align=True,
                       adaptive_capacity_step=0.3, adaptive_capacity_request_max=0.7)
    model = vits_tpu_torch.load_model(GGML, eng, device="cpu")
    base = model._frame_capacity(32)
    model.synthesize("hello sad dame", seed=0)
    assert model._frames_per_token == 4.0 and model._frame_capacity(32) == 2 * base


@pytest.mark.parametrize("field,value", [
    ("use_pallas_attention", False),
    ("use_pallas_vocoder", False),
])
def test_engine_rejects_unported_fields(field, value):
    """The port has no kernel-off switch (compilation_cache_dir and
    aot_bundle_dir: tests/test_torch_aot.py)."""
    with pytest.raises(NotImplementedError, match=field):
        vits_tpu_torch.load_model(GGML, EngineConfig(**{field: value}), device="cpu")


def test_warmup_records_each_batch_bucket_and_rung():
    """warmup dispatches every (batch, token bucket, capacity x 2^rung) once, with
    the seed layout asked for, and nothing else; a request of a warmed shape
    adds no shape."""
    eng = EngineConfig(token_buckets=(32, 64), frames_per_token=4.0, adaptive_capacity=False)
    model = vits_tpu_torch.load_model(GGML, eng, device="cpu")
    model.warmup(batch_sizes=(1, 3), overflow_ladder=1)
    model.warmup(batch_sizes=(2,), token_buckets=(32,), per_row_seeds=True)
    want = {(bs, tb, eng.frame_bucket(tb) * 2 ** rung, (), False)
            for bs in (1, 3) for tb in (32, 64) for rung in (0, 1)}
    want.add((2, 32, eng.frame_bucket(32), (2,), False))
    assert model._dispatch_shapes == want
    assert model.stats["compiled_shapes"] == len(want) == model.stats["dispatches"]
    model.synthesize("hello", seed=1)
    assert model._dispatch_shapes == want


# No adaptive capacity: a dispatch's shape then depends on its texts alone, not
# on what the module's earlier tests sent.
@pytest.fixture(scope="module")
def bucketed():
    eng = EngineConfig(token_buckets=(32, 64), frames_per_token=4.0, batch_buckets=(1, 2, 4),
                       adaptive_capacity=False)
    return vits_tpu_torch.load_model(GGML, eng, device="cpu")


@pytest.fixture(scope="module")
def unbucketed():
    eng = EngineConfig(token_buckets=(32, 64), frames_per_token=4.0, adaptive_capacity=False)
    return vits_tpu_torch.load_model(GGML, eng, device="cpu")


def test_batch_buckets_rows_match_unbucketed(bucketed, unbucketed):
    """Per-row seeds: rows of a batch padded 3 -> 4 equal the unpadded batch's."""
    texts = ["hello", "sad dame", "well cheese"]
    a = unbucketed.synthesize(texts, seed=[1, 2, 3])
    b = bucketed.synthesize(texts, seed=[1, 2, 3])
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=INT16_STEP, rtol=0)


def test_batch_buckets_dispatch_only_bucket_sizes(bucketed):
    texts = ["hello", "sad dame", "well cheese", "be well"]
    for n in (2, 3, 4):
        bucketed.synthesize(texts[:n], seed=list(range(n)))
    batch_dims = {shape[0] for shape in bucketed._dispatch_shapes}
    assert batch_dims <= {1, 2, 4} and 3 not in batch_dims


def test_batch_buckets_scalar_seed_pad_invariant(bucketed):
    """A scalar seed on a multi-row bucketed batch becomes per-row generators
    (row_seed): each row's audio does not depend on how many rows rode along."""
    c2 = bucketed.synthesize(["hello", "sad dame"], seed=7)
    c3 = bucketed.synthesize(["hello", "sad dame", "well"], seed=7)
    for a, b in zip(c2, c3):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=INT16_STEP, rtol=0)
    other = bucketed.synthesize(["hello", "sad dame"], seed=8)
    assert not np.array_equal(c2[0], other[0])


def test_batch_buckets_single_text_unchanged(bucketed, unbucketed):
    """Bucket 1 exists: a single text keeps the scalar-seed stream, bit for bit."""
    np.testing.assert_array_equal(unbucketed.synthesize("hello sad dame", seed=5),
                                  bucketed.synthesize("hello sad dame", seed=5))


def test_pad_to_batch_drops_its_pad_rows(bucketed, unbucketed):
    """pad_to_batch pads the dispatch with empty rows that carry no audio; the
    same 4-row dispatch through a batch bucket gives the same bits, and
    synthesize returns only the texts' rows."""
    texts = ["hello", "sad dame", "well cheese"]
    raw = unbucketed.synthesize_raw(texts, seed=[4, 5, 6], pad_to_batch=4)
    assert raw.waveform.shape[0] == 4 and not raw.waveform[3].any()
    assert (4, 32, 128, (4,), False) in unbucketed._dispatch_shapes
    np.testing.assert_array_equal(
        bucketed.synthesize_raw(texts, seed=[4, 5, 6]).waveform, raw.waveform)
    got = bucketed.synthesize(texts, seed=[4, 5, 6])
    assert len(got) == 3
    for i, audio in enumerate(got):
        np.testing.assert_array_equal(audio, raw.waveform[i, : raw.lengths[i]])


def test_split_sentences_matches_the_jax_package():
    texts = ["Hello there. How are you today? I am fine; thanks!   ",
             "a" * 100 + ", " + "b" * 100 + ", " + "c" * 100, "   ", "no stop at all"]
    for text in texts:
        for max_chars in (300, 120):
            assert split_sentences(text, max_chars) == jax_split_sentences(text, max_chars)
    assert split_sentences(texts[0]) == ["Hello there.", "How are you today?", "I am fine;",
                                         "thanks!"]


def test_synthesize_long_concatenates(unbucketed):
    """Sentences as one batch (one generator for the batch: a scalar seed), each
    trimmed, joined by gap_ms of silence."""
    audio = synthesize_long(unbucketed, "hello sad dame. my sweet valley shell.", seed=0,
                            gap_ms=50)
    parts = unbucketed.synthesize(["hello sad dame.", "my sweet valley shell."], seed=0)
    gap = int(unbucketed.config.sampling_rate * 0.05)
    assert audio.ndim == 1 and len(audio) == len(parts[0]) + gap + len(parts[1])
    np.testing.assert_array_equal(audio[: len(parts[0])], parts[0])
    assert not audio[len(parts[0]): len(parts[0]) + gap].any()
    assert len(synthesize_long(unbucketed, "   ")) == 0


def test_flow_pack_keeps_warmed_workspaces(monkeypatch):
    """FlowPack.keeping: the 16 shapes made under it stay, however many others
    come after; the others stay bounded by WORKSPACES, oldest out first."""
    made = []

    class Stub:
        def __init__(self, pack, config, B, T, speakers, mode):
            made.append((B, T, speakers))

    monkeypatch.setattr(flow_module, "FlowWorkspace", Stub)
    pack = flow_module.FlowPack(torch.zeros(4), {name: torch.zeros(1)
                                                 for name in flow_module.PACK_NAMES})
    warmed = [(b, t, False) for b in (1, 2) for t in range(8, 72, 8)]
    with pack.keeping():
        kept = {key: pack.workspace(None, *key) for key in warmed}
    others = [(3, t, True) for t in range(8, 8 * (flow_module.WORKSPACES + 5), 8)]
    for key in others:
        pack.workspace(None, *key)
    assert all(pack.workspace(None, *key) is ws for key, ws in kept.items())
    assert made == warmed + others
    assert len(pack._workspaces) == len(warmed) + flow_module.WORKSPACES
    keys = {key[:3] for key in pack._workspaces}  # (B, T, speakers) of each (..., tier) key
    assert keys - set(warmed) == set(others[-flow_module.WORKSPACES:])
