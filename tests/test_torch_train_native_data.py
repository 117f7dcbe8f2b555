"""The port's data pipeline with the C++ corpus loader (``io/native.py``) against its numpy path.

Mirrors ``tests/test_native_data.py`` for ``vits_tpu_torch.train.data.VitsDataset``:
token ids and audio equal, spectrograms within 1e-5 (double-precision FFTs
on both sides), batches equal with and without worker threads. The parity
tests skip where that file skips: without the built library
(``cmake -S native -B native/build && cmake --build native/build``). The
choice of path runs everywhere: ``use_native=None`` takes the loader only when
it is built and n_fft is a power of two, and the numpy path reads the corpus.
"""

import numpy as np
import pytest

from vits_tpu.io import native as jax_native
from vits_tpu_torch.io import native
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.train.data import VitsDataset, linear_spectrogram
from vits_tpu_torch.utils.wav import write_wav

needs_loader = pytest.mark.skipif(not native.loader_available(),
                                  reason="native corpus loader not built")

VOCAB = {c: i for i, c in enumerate("kzyuvdheswm' ablc")}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory, tiny_bundle):
    config, _ = tiny_bundle
    root = tmp_path_factory.mktemp("native_corpus")
    (root / "wavs").mkdir()
    rng = np.random.default_rng(7)
    lines = []
    for i, text in enumerate(["hello sad dame", "my sweet valley", "be well and hum", "ask less"]):
        n = config.total_upsample * (20 + 8 * i) + i * 3  # ragged tails
        audio = np.clip(rng.standard_normal(n) * 0.2, -1, 1).astype(np.float32)
        write_wav(str(root / "wavs" / f"utt{i}.wav"), audio, config.sampling_rate)
        lines.append(f"utt{i}|RAW|{text}")
    (root / "metadata.csv").write_text("\n".join(lines))
    return str(root)


def _dataset(corpus, tiny_bundle, **kwargs):
    config, _ = tiny_bundle
    tok = VitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z")
    return VitsDataset(corpus, tok, config, max_frames=64, **kwargs)


def test_use_native_default_and_numpy_path(corpus, tiny_bundle):
    auto = _dataset(corpus, tiny_bundle)
    assert auto.use_native == (native.loader_available()
                               and auto.n_fft & (auto.n_fft - 1) == 0)
    assert native.loader_available() == jax_native.loader_available()
    ref = _dataset(corpus, tiny_bundle, use_native=False)
    assert not ref.use_native
    ids, spec, audio = ref.load(ref.utterances[0])
    assert spec.shape[0] * ref.hop == audio.shape[0] and len(ids) > 0
    np.testing.assert_allclose(spec, linear_spectrogram(audio, ref.n_fft, ref.hop)[:len(spec)])
    batches = list(ref.batches(batch_size=2, rng=np.random.default_rng(3), epochs=1))
    assert sum(b.input_ids.shape[0] for b in batches) == len(ref.utterances)


@needs_loader
def test_load_parity(corpus, tiny_bundle):
    nat = _dataset(corpus, tiny_bundle, use_native=True)
    ref = _dataset(corpus, tiny_bundle, use_native=False)
    for utt in nat.utterances:
        a, b = nat.load(utt), ref.load(utt)
        assert (a is None) == (b is None)
        if a is None:
            continue
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[2], b[2])
        assert a[1].shape == b[1].shape
        np.testing.assert_allclose(a[1], b[1], atol=1e-5)


@needs_loader
def test_batches_parity_and_workers(corpus, tiny_bundle):
    nat = _dataset(corpus, tiny_bundle, use_native=True, num_workers=4)
    ref = _dataset(corpus, tiny_bundle, use_native=False)
    b0 = list(nat.batches(batch_size=2, rng=np.random.default_rng(3), epochs=1))
    b1 = list(ref.batches(batch_size=2, rng=np.random.default_rng(3), epochs=1))
    assert len(b0) == len(b1)
    for x, y in zip(b0, b1):
        np.testing.assert_array_equal(x.input_ids, y.input_ids)
        np.testing.assert_array_equal(x.audio, y.audio)
        np.testing.assert_array_equal(x.frame_mask, y.frame_mask)
        np.testing.assert_allclose(x.spectrogram, y.spectrogram, atol=1e-5)
