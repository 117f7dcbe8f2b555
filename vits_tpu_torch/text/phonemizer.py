"""Text -> IPA phoneme bridge (espeak-ng), with graceful degradation.

The reference links libespeak-ng directly and converts text chunk-by-chunk around
punctuation (reference/src/vits_tokenizer.cpp:121-158, CMakeLists.txt:28-33).
Here the bridge is a ctypes binding to the same library when present, with a
subprocess fallback to the ``espeak-ng`` binary; non-phonetic models (MMS-TTS) never
touch this module.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import re
import shutil
import subprocess

_PUNCT = "!\\,.:;?"


class PhonemizerUnavailable(RuntimeError):
    pass


class Phonemizer:
    """espeak-ng text->phoneme converter with punctuation-aware chunking.

    Chunking mirrors convert_to_phonetic
    (reference/src/vits_tokenizer.cpp:123-158): split on punctuation,
    phonemize each chunk, re-insert the punctuation mark and a space.
    """

    def __init__(self, language: str = "en-us"):
        self.language = language
        self._lib = None
        self._binary = None
        lib_name = ctypes.util.find_library("espeak-ng") or ctypes.util.find_library(
            "espeak"
        )
        if lib_name:
            try:
                self._lib = self._init_lib(lib_name)
            except OSError:
                self._lib = None
        if self._lib is None:
            self._binary = shutil.which("espeak-ng") or shutil.which("espeak")
        if self._lib is None and self._binary is None:
            raise PhonemizerUnavailable(
                "No espeak-ng library or binary found; phonetic checkpoints need "
                "espeak-ng installed (non-phonetic MMS models do not)."
            )

    def _init_lib(self, lib_name: str):
        lib = ctypes.CDLL(lib_name)
        # espeak_Initialize(AUDIO_OUTPUT_SYNCHRONOUS=2, buflength=0, path=NULL, options=0)
        lib.espeak_Initialize(2, 0, None, 0)
        lib.espeak_SetVoiceByName(self.language.encode())
        lib.espeak_TextToPhonemes.restype = ctypes.c_char_p
        return lib

    def _phonemize_chunk(self, chunk: str) -> str:
        if not chunk:
            return ""
        if self._lib is not None:
            text = ctypes.c_char_p(chunk.encode("utf-8"))
            ptr = ctypes.pointer(ctypes.cast(text, ctypes.c_void_p))
            # espeakCHARS_UTF8 = 1, phoneme_mode = 2 (IPA)
            out = self._lib.espeak_TextToPhonemes(ptr, 1, 2)
            return out.decode("utf-8") if out else ""
        result = subprocess.run(
            [self._binary, "-q", "--ipa", "-v", self.language, chunk],
            capture_output=True,
            text=True,
            check=False,
        )
        return re.sub(r"\s+", " ", result.stdout).strip()

    def phonemize(self, text: str) -> str:
        out: list[str] = []
        i = 0
        n = len(text)
        while i < n:
            nxt = min((text.find(c, i) for c in _PUNCT if text.find(c, i) != -1), default=-1)
            if nxt == -1:
                out.append(self._phonemize_chunk(text[i:]))
                break
            out.append(self._phonemize_chunk(text[i:nxt]))
            out.append(text[nxt])
            i = nxt + 1
            if text[nxt] == "." and text[i : i + 2] == "..":
                out.append("..")
                i += 2
            if i < n:
                out.append(" ")
        return "".join(out)
