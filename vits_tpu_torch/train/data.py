"""Training data: (text, wav) corpus -> padded batches, prefetched on a thread.

Counterpart of ``vits_tpu/train/data.py`` (which imports the JAX train step,
so it is ported, not imported). An LJSpeech-layout corpus::

    corpus/
      metadata.csv          # id|transcript  (LJSpeech uses id|raw|normalized)
      wavs/<id>.wav         # 16-bit PCM mono at config.sampling_rate

Linear spectrograms use the posterior encoder's STFT (n_fft =
2*(spectrogram_bins-1), hop = total_upsample, so frames align 1:1 with latent
frames); batches are shuffled, length-bucketed and padded, with masks, as
numpy (``train/step.py::batch_to`` moves them to the device). The numpy
loader only: the JAX package's optional C++ loader is not carried over.
:class:`Prefetcher` re-raises a producer error in the consumer, where the
JAX one ends the stream early; ``close()`` stops the thread. (The loop's
side of the teardown is in ``train/loop.py``.) The synthetic micro-corpus
(``generate_micro_corpus``, ``corpus_vocab``) is the port's copy of
``vits_tpu/train/synthetic.py``, re-exported here.
"""

from __future__ import annotations

import csv
import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.train.step import TrainBatch
from vits_tpu_torch.train.synthetic import corpus_vocab, generate_micro_corpus  # noqa: F401
from vits_tpu_torch.utils.mel import hann_window
from vits_tpu_torch.utils.wav import read_wav


def linear_spectrogram(audio: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| with VITS framing: reflect-pad (n_fft-hop)/2 per side, no centering,
    so exactly T/hop frames."""
    pad = (n_fft - hop) // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    frames = x[idx] * hann_window(n_fft)
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


@dataclass
class Utterance:
    utt_id: str
    text: str
    wav_path: str


def read_metadata(corpus_dir: str) -> list[Utterance]:
    utts = []
    with open(os.path.join(corpus_dir, "metadata.csv"), encoding="utf-8") as f:
        for row in csv.reader(f, delimiter="|"):
            if not row:
                continue
            utt_id = row[0].strip()
            wav = os.path.join(corpus_dir, "wavs", utt_id + ".wav")
            if os.path.exists(wav):
                utts.append(Utterance(utt_id, row[-1].strip(), wav))  # last column: normalized
    return utts


class VitsDataset:
    def __init__(self, corpus_dir: str, tokenizer: VitsTokenizer, config: VitsConfig,
                 max_frames: int = 400, min_frames: int = 8):
        self.tokenizer = tokenizer
        self.config = config
        self.n_fft = 2 * (config.spectrogram_bins - 1)
        self.hop = config.total_upsample
        self.max_frames = max_frames
        self.min_frames = min_frames
        self.utterances = read_metadata(corpus_dir)
        if not self.utterances:
            raise FileNotFoundError(f"no utterances found under {corpus_dir}")

    def __len__(self) -> int:
        return len(self.utterances)

    def load(self, utt: Utterance):
        """-> (token_ids, spectrogram (S, bins), audio (S*hop,)) or None if rejected."""
        audio, rate = read_wav(utt.wav_path)
        if rate != self.config.sampling_rate:
            raise ValueError(f"{utt.wav_path}: rate {rate} != config {self.config.sampling_rate}")
        ids = self.tokenizer.encode(utt.text)
        n_frames = min(len(audio) // self.hop, self.max_frames)
        if n_frames < self.min_frames or not ids:
            return None
        audio = audio[: n_frames * self.hop]
        spec = linear_spectrogram(audio, self.n_fft, self.hop)[:n_frames]
        return np.asarray(ids, np.int32), spec, audio

    def batches(self, batch_size: int, rng: np.random.Generator, epochs: Optional[int] = None,
                bucket_mult: int = 32) -> Iterator[TrainBatch]:
        """Shuffled, length-bucketed padded batches; loops ``epochs`` times (None = forever)."""
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.utterances))
            chunk = batch_size * 16  # sort within shuffled chunks by length: less padding
            for start in range(0, len(order), chunk):
                idxs = sorted(order[start: start + chunk],
                              key=lambda i: os.path.getsize(self.utterances[i].wav_path))
                for b0 in range(0, len(idxs), batch_size):
                    items = [r for r in (self.load(self.utterances[i])
                                         for i in idxs[b0: b0 + batch_size]) if r is not None]
                    if items:
                        yield self._collate(items, bucket_mult)
            epoch += 1

    def _collate(self, items: Sequence, bucket_mult: int) -> TrainBatch:
        B = len(items)
        t_pad = -(-max(len(ids) for ids, _, _ in items) // bucket_mult) * bucket_mult
        s_pad = -(-max(spec.shape[0] for _, spec, _ in items) // bucket_mult) * bucket_mult
        input_ids = np.zeros((B, t_pad), np.int32)
        token_mask = np.zeros((B, t_pad), np.float32)
        spec = np.zeros((B, s_pad, self.config.spectrogram_bins), np.float32)
        frame_mask = np.zeros((B, s_pad), np.float32)
        audio = np.zeros((B, s_pad * self.hop), np.float32)
        for b, (ids, sp, au) in enumerate(items):
            input_ids[b, : len(ids)] = ids
            token_mask[b, : len(ids)] = 1.0
            spec[b, : sp.shape[0]] = sp
            frame_mask[b, : sp.shape[0]] = 1.0
            audio[b, : len(au)] = au
        return TrainBatch(input_ids, token_mask, spec, frame_mask, audio)


class _Failed:
    """The producer's exception, carried to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class Prefetcher:
    """Background-thread batch prefetch (host prep overlaps device compute).

    A producer error is re-raised from ``__next__`` (not turned into an
    early stop). ``close()`` stops the producer even when the consumer
    stops early; it is idempotent.
    """

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._stopped = threading.Event()
        self._ended = False  # the consumer has seen the end or the error
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that gives up (returns False) once close() is called."""
        while not self._stopped.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self, iterator) -> None:
        items = iter(iterator)
        while True:
            try:
                item = next(items)
            except StopIteration:
                self._put(self._done)
                return
            except Exception as error:  # handed to the consumer, raised there
                self._put(_Failed(error))
                return
            if not self._put(item):
                return  # closed mid-stream; the consumer is gone

    def close(self, timeout: float = 5.0) -> None:
        self._stopped.set()
        if self._thread.is_alive():
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._ended:
            raise StopIteration
        item = self._queue.get()
        if item is self._done:
            self._ended = True
            raise StopIteration
        if isinstance(item, _Failed):
            self._ended = True
            raise RuntimeError("the batch producer failed") from item.error
        return item
