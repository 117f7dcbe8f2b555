"""VITS / MMS-TTS tokenizer.

Feature-parity with the reference tokenizer (reference/src/vits_tokenizer.cpp):
vocab loaded from the checkpoint, lowercase normalization, greedy vocabulary matching,
and blank (<pad>, id 0) interspersal between tokens
(reference/src/vits_tokenizer.cpp:182-241).  Semantics follow the HF
``VitsTokenizer`` (the oracle the reference was validated against): normalize via greedy
longest-prefix vocab match with lowercase fallback, drop characters outside the vocab,
strip, then intersperse token id 0.

The optional espeak-ng phoneme path of the reference
(reference/src/vits_tokenizer.cpp:121-158, behind VITS_ESPEAK) is provided by
:mod:`vits_tpu.text.phonemizer` and enabled per-checkpoint via the ``phonetic`` config
flag (reference/src/vits_model_data.cpp:92-94).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np


@dataclass
class VitsTokenizer:
    vocab: dict[str, int]
    add_blank: bool = True
    normalize: bool = True
    pad_token: str = "<pad>"
    unk_token: str = "<unk>"
    phonetic: bool = False
    language: Optional[str] = None

    def __post_init__(self):
        # Sort keys longest-first so greedy matching prefers multi-char tokens,
        # independent of dict insertion order (the reference iterates an
        # unordered_map; HF iterates vocab order — longest-first is the only
        # deterministic choice that matches both for MMS single-char vocabs and
        # stays correct for multi-char special tokens).
        self._keys_by_len = sorted(self.vocab.keys(), key=len, reverse=True)
        self._phonemizer = None
        if self.phonetic:
            from vits_tpu_torch.text.phonemizer import Phonemizer

            self._phonemizer = Phonemizer(language=self.language or "en-us")

    # ------------------------------------------------------------------ #
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def blank_id(self) -> int:
        # HF intersperses the token with id 0 (tokenization_vits.py::_tokenize).
        return 0

    def normalize_text(self, text: str) -> str:
        """Greedy vocab match preserving cased vocab entries, lowercasing the rest.

        Mirrors HF ``VitsTokenizer.normalize_text``.
        """
        out = []
        i = 0
        n = len(text)
        while i < n:
            matched = False
            for word in self._keys_by_len:
                if text.startswith(word, i):
                    out.append(word)
                    i += len(word)
                    matched = True
                    break
            if not matched:
                out.append(text[i].lower())
                i += 1
        return "".join(out)

    def prepare_text(self, text: str) -> str:
        if self.normalize:
            text = self.normalize_text(text)
        if self.phonetic and self._phonemizer is not None:
            text = self._phonemizer.phonemize(text)
        if self.normalize:
            text = "".join(c for c in text if c in self.vocab).strip()
        return text

    def encode(self, text: str) -> list[int]:
        """Text -> token ids with blank interspersal.

        Matches the reference's tokenize+add_blank
        (reference/src/vits_tokenizer.cpp:199-207): ids[2i+1] = token_i,
        even slots hold the blank id.
        """
        prepared = self.prepare_text(text)
        ids = []
        i = 0
        n = len(prepared)
        while i < n:
            matched = False
            for word in self._keys_by_len:
                if prepared.startswith(word, i):
                    ids.append(self.vocab[word])
                    i += len(word)
                    matched = True
                    break
            if not matched:
                i += 1  # skip unknown chars, like tokenize_fast (:71-74)
        if self.add_blank and ids:
            out = [self.blank_id] * (2 * len(ids) + 1)
            out[1::2] = ids
            ids = out
        return ids

    def __call__(
        self,
        texts: str | Sequence[str],
        pad_to: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batch-encode to (input_ids, attention_mask) int32/float arrays."""
        if isinstance(texts, str):
            texts = [texts]
        return self.pad([self.encode(t) for t in texts], pad_to)

    def pad(
        self,
        encoded: Sequence[Sequence[int]],
        pad_to: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Pad pre-encoded id lists to (input_ids, attention_mask) arrays —
        lets callers that already tokenized (for bucket selection) avoid a
        second pass through the greedy matcher."""
        max_len = max((len(e) for e in encoded), default=1)
        length = pad_to if pad_to is not None else max_len
        if max_len > length:
            raise ValueError(f"pad_to={length} shorter than longest sequence {max_len}")
        ids = np.zeros((len(encoded), length), dtype=np.int32)
        mask = np.zeros((len(encoded), length), dtype=np.float32)
        for row, e in enumerate(encoded):
            ids[row, : len(e)] = e
            mask[row, : len(e)] = 1.0
        return ids, mask

    # ------------------------------------------------------------------ #
    @classmethod
    def from_hf(cls, hf_tokenizer) -> "VitsTokenizer":
        """Build from a ``transformers.VitsTokenizer``."""
        return cls(
            vocab=dict(hf_tokenizer.get_vocab()),
            add_blank=bool(hf_tokenizer.add_blank),
            normalize=bool(hf_tokenizer.normalize),
            pad_token=str(hf_tokenizer.pad_token),
            unk_token=str(hf_tokenizer.unk_token),
            phonetic=bool(getattr(hf_tokenizer, "phonemize", False)),
            language=getattr(hf_tokenizer, "language", None),
        )

    @classmethod
    def from_vocab_file(cls, path: str, **kwargs) -> "VitsTokenizer":
        with open(path, encoding="utf-8") as f:
            vocab = json.load(f)
        return cls(vocab=vocab, **kwargs)
