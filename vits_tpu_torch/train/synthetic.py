"""Deterministic synthetic micro-corpus: formant-ish tones + transcripts.

No speech corpus ships with (or can be downloaded into) this environment, so
training convergence is demonstrated on a synthetic corpus with the essential
structure of speech data: each "phoneme" character maps to a stable spectral
identity (an f0 + formant stack, or a noise burst for consonant-ish chars),
characters have consistent durations, and transcripts are word-like strings.
A model that learns text->spectral identity + duration + alignment on this
corpus exercises every term of the VITS objective (KL, SDP duration NLL, mel
reconstruction, adversarial).

Layout written is the LJSpeech layout VitsDataset consumes:
    out_dir/metadata.csv   (id|transcript)
    out_dir/wavs/<id>.wav
"""

from __future__ import annotations

import os

import numpy as np

# vowel-ish: (f0 Hz, formants Hz); consonant-ish: noise band (lo, hi) Hz
_VOWELS = {
    "a": (110, (800, 1200, 2500)),
    "e": (130, (500, 1900, 2600)),
    "i": (150, (320, 2300, 3000)),
    "o": (120, (450, 850, 2600)),
    "u": (100, (350, 700, 2400)),
    "y": (140, (420, 1800, 2500)),
}
_CONSONANTS = {
    "s": (3500, 6000),
    "f": (2500, 5000),
    "k": (1200, 2800),
    "t": (2000, 4500),
    "m": (150, 600),
    "n": (200, 900),
    "l": (250, 1200),
    "r": (300, 1500),
}
CHARS = sorted(_VOWELS) + sorted(_CONSONANTS)


def synth_char(ch: str, n: int, rate: int, rng: np.random.Generator) -> np.ndarray:
    t = np.arange(n) / rate
    if ch in _VOWELS:
        f0, formants = _VOWELS[ch]
        sig = np.zeros(n)
        # harmonic stack weighted by distance to the formants
        for h in range(1, 30):
            f = f0 * h
            if f > rate / 2 - 200:
                break
            w = sum(np.exp(-0.5 * ((f - fm) / 300.0) ** 2) for fm in formants)
            sig += (0.05 + w) * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    elif ch in _CONSONANTS:
        lo, hi = _CONSONANTS[ch]
        white = rng.standard_normal(n)
        spec = np.fft.rfft(white)
        freqs = np.fft.rfftfreq(n, 1.0 / rate)
        band = (freqs >= lo) & (freqs <= hi)
        spec[~band] = 0
        sig = np.fft.irfft(spec, n)
    else:  # space: silence
        return np.zeros(n, np.float32)
    sig = sig / (np.abs(sig).max() + 1e-6) * 0.5
    # attack/decay envelope so char boundaries are audible events
    env = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n)) / (0.015 * rate))
    return (sig * env).astype(np.float32)


def make_transcript(rng: np.random.Generator, n_words: int) -> str:
    words = []
    for _ in range(n_words):
        n_chars = int(rng.integers(2, 6))
        word = "".join(
            CHARS[int(i)] for i in rng.integers(0, len(CHARS), n_chars)
        )
        words.append(word)
    return " ".join(words)


def generate_micro_corpus(
    out_dir: str,
    n_utts: int = 64,
    seed: int = 0,
    sample_rate: int = 16000,
    char_ms: float = 80.0,
    words_range: tuple[int, int] = (2, 5),
) -> list[str]:
    """Write the corpus; returns the transcript list."""
    from vits_tpu_torch.utils.wav import write_wav

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    n_char = int(sample_rate * char_ms / 1000.0)
    transcripts = []
    rows = []
    for idx in range(n_utts):
        text = make_transcript(rng, int(rng.integers(*words_range)))
        audio = np.concatenate([synth_char(c, n_char, sample_rate, rng) for c in text])
        utt_id = f"syn{idx:04d}"
        write_wav(os.path.join(out_dir, "wavs", f"{utt_id}.wav"), audio, sample_rate)
        rows.append(f"{utt_id}|{text}")
        transcripts.append(text)
    with open(os.path.join(out_dir, "metadata.csv"), "w", encoding="utf-8") as fh:
        fh.write("\n".join(rows) + "\n")
    return transcripts


def corpus_vocab() -> dict[str, int]:
    """Tokenizer vocab covering the synthetic charset (pad='_', unk='?')."""
    vocab = {"_": 0, "?": 1, " ": 2}
    for i, c in enumerate(CHARS):
        vocab[c] = 3 + i
    return vocab
