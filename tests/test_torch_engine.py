"""The port's engine, loaded through ``vits_tpu_torch.load_model`` on the CPU.

Noise contract, batching parity (a padded row equals its solo run), seed
determinism, the overflow re-dispatch ladder, and the EngineConfig fields the
port does not honour yet. Waveforms cross to the host as int16 PCM, so two
runs that agree in fp32 may differ by one int16 step (1/32767).
"""

import numpy as np
import pytest
import torch

import vits_tpu_torch
from vits_tpu.config import EngineConfig
from vits_tpu_torch.models import vits

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
    ("compute_dtype", "bfloat16"), ("use_pallas_attention", True), ("pallas_precision", "high"),
    ("batch_buckets", (1, 4)), ("aot_bundle_dir", "bundle"), ("use_pallas_vocoder", False),
])
def test_engine_rejects_unported_fields(field, value):
    with pytest.raises(NotImplementedError, match=field):
        vits_tpu_torch.load_model(GGML, EngineConfig(**{field: value}), device="cpu")
