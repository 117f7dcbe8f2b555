"""Long-form synthesis: split text into sentences, batch them, stitch audio.

The reference synthesizes one utterance per call and its graph grows with
utterance length (256x upsampling of the full text, SURVEY.md §5 "the scaling
problem ... the time axis of the vocoder").  Long inputs here are split at
sentence boundaries, synthesized as ONE padded batch (a single dispatch in
the common case), and concatenated with a short silence gap — so paragraph
synthesis costs one dispatch instead of a giant graph.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;:])\s+")


def split_sentences(text: str, max_chars: int = 300) -> list[str]:
    """Sentence-ish chunks, further split at commas/spaces if over max_chars."""
    pieces: list[str] = []
    for sent in _SENTENCE_SPLIT.split(text.strip()):
        sent = sent.strip()
        if not sent:
            continue
        while len(sent) > max_chars:
            cut = sent.rfind(",", 0, max_chars)
            if cut < max_chars // 2:
                cut = sent.rfind(" ", 0, max_chars)
            if cut <= 0:
                cut = max_chars
            pieces.append(sent[:cut].strip())
            sent = sent[cut:].lstrip(", ")
        if sent:
            pieces.append(sent)
    return pieces


def synthesize_long(
    model,
    text: str,
    *,
    seed: int = 0,
    speaker_id: Optional[int] = None,
    gap_ms: float = 120.0,
    max_chars: int = 300,
    noise_scale: Optional[float] = None,
    noise_scale_duration: Optional[float] = None,
    speaking_rate: Optional[float] = None,
) -> np.ndarray:
    """Paragraph/document -> one concatenated waveform."""
    sentences = split_sentences(text, max_chars=max_chars)
    if not sentences:
        return np.zeros(0, np.float32)
    waves = model.synthesize(
        sentences, seed=seed, speaker_id=speaker_id, noise_scale=noise_scale,
        noise_scale_duration=noise_scale_duration, speaking_rate=speaking_rate,
    )
    if isinstance(waves, np.ndarray):
        waves = [waves]
    gap = np.zeros(int(model.config.sampling_rate * gap_ms / 1000.0), np.float32)
    out: list[np.ndarray] = []
    for i, wave in enumerate(waves):
        out.append(wave)
        if i != len(waves) - 1:
            out.append(gap)
    return np.concatenate(out)
