"""ctypes bindings to the native runtime library (native/vitstpu.cpp).

Gives zero-copy mmap checkpoint loads, a trie tokenizer, and native WAV
encoding.  Every entry point has a pure-Python fallback (vits_tpu_torch.io.ggml,
vits_tpu_torch.text.tokenizer, vits_tpu_torch.utils.wav), so the native library is an
accelerator, not a dependency.  Build it with:

    cmake -S native -B native/build && cmake --build native/build
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False


class _VtTensor(ctypes.Structure):
    _fields_ = [
        ("name", ctypes.c_char_p),
        ("dtype", ctypes.c_uint32),
        ("rank", ctypes.c_uint32),
        ("dims", ctypes.c_uint32 * 8),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("nbytes", ctypes.c_uint64),
    ]


class _VtKV(ctypes.Structure):
    _fields_ = [("key", ctypes.c_char_p), ("value", ctypes.c_char_p)]


class _VtVocabEntry(ctypes.Structure):
    _fields_ = [("token", ctypes.c_char_p), ("id", ctypes.c_uint32)]


def _candidates():
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return [
        os.environ.get("VITS_TPU_NATIVE_LIB", ""),
        os.path.join(here, "native", "build", "libvitstpu.so"),
        os.path.join(here, "libvitstpu.so"),
    ]


def load_library() -> Optional[ctypes.CDLL]:
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    for path in _candidates():
        if path and os.path.exists(path):
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                continue
            lib.vt_ggml_open.restype = ctypes.c_void_p
            lib.vt_ggml_open.argtypes = [ctypes.c_char_p]
            lib.vt_ggml_from_bytes.restype = ctypes.c_void_p
            lib.vt_ggml_from_bytes.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.vt_ggml_error.restype = ctypes.c_char_p
            lib.vt_ggml_error.argtypes = [ctypes.c_void_p]
            lib.vt_ggml_num_tensors.restype = ctypes.c_uint32
            lib.vt_ggml_num_tensors.argtypes = [ctypes.c_void_p]
            lib.vt_ggml_tensor.restype = ctypes.POINTER(_VtTensor)
            lib.vt_ggml_tensor.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.vt_ggml_num_config.restype = ctypes.c_uint32
            lib.vt_ggml_num_config.argtypes = [ctypes.c_void_p]
            lib.vt_ggml_config.restype = ctypes.POINTER(_VtKV)
            lib.vt_ggml_config.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.vt_ggml_num_vocab.restype = ctypes.c_uint32
            lib.vt_ggml_num_vocab.argtypes = [ctypes.c_void_p]
            lib.vt_ggml_vocab.restype = ctypes.POINTER(_VtVocabEntry)
            lib.vt_ggml_vocab.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            for fname in ("vt_ggml_add_blank", "vt_ggml_normalize"):
                fn = getattr(lib, fname)
                fn.restype = ctypes.c_uint32
                fn.argtypes = [ctypes.c_void_p]
            for fname in ("vt_ggml_pad_token", "vt_ggml_unk_token"):
                fn = getattr(lib, fname)
                fn.restype = ctypes.c_char_p
                fn.argtypes = [ctypes.c_void_p]
            lib.vt_ggml_close.restype = None
            lib.vt_ggml_close.argtypes = [ctypes.c_void_p]
            lib.vt_tokenizer_new.restype = ctypes.c_void_p
            lib.vt_tokenizer_new.argtypes = [ctypes.c_uint32, ctypes.c_uint32]
            lib.vt_tokenizer_add.restype = None
            lib.vt_tokenizer_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
            lib.vt_tokenize.restype = ctypes.c_uint32
            lib.vt_tokenize.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
            ]
            lib.vt_tokenizer_free.restype = None
            lib.vt_tokenizer_free.argtypes = [ctypes.c_void_p]
            lib.vt_wav_size.restype = ctypes.c_uint64
            lib.vt_wav_size.argtypes = [ctypes.c_uint64]
            lib.vt_wav_encode.restype = None
            lib.vt_wav_encode.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.c_uint64,
                ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
            ]
            # Embeddable synthesis client (vt_engine_*, vt_synthesize) —
            # absent from libraries built before round 2.
            if hasattr(lib, "vt_engine_connect"):
                lib.vt_engine_connect.restype = ctypes.c_void_p
                lib.vt_engine_connect.argtypes = [ctypes.c_char_p, ctypes.c_uint16]
                lib.vt_engine_error.restype = ctypes.c_char_p
                lib.vt_engine_error.argtypes = [ctypes.c_void_p]
                lib.vt_synthesize.restype = ctypes.c_void_p
                lib.vt_synthesize.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
                    ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ]
                if hasattr(lib, "vt_convert"):  # round-3+ libraries
                    lib.vt_convert.restype = ctypes.c_void_p
                    lib.vt_convert.argtypes = [
                        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                        ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int32,
                        ctypes.c_int32, ctypes.c_int64, ctypes.c_float,
                    ]
                lib.vt_audio_samples.restype = ctypes.POINTER(ctypes.c_float)
                lib.vt_audio_samples.argtypes = [ctypes.c_void_p]
                lib.vt_audio_num_samples.restype = ctypes.c_uint64
                lib.vt_audio_num_samples.argtypes = [ctypes.c_void_p]
                lib.vt_audio_sample_rate.restype = ctypes.c_uint32
                lib.vt_audio_sample_rate.argtypes = [ctypes.c_void_p]
                lib.vt_audio_free.restype = None
                lib.vt_audio_free.argtypes = [ctypes.c_void_p]
                lib.vt_engine_close.restype = None
                lib.vt_engine_close.argtypes = [ctypes.c_void_p]
            # Corpus loader (vt_utt_*) — absent from pre-round-3 libraries.
            if hasattr(lib, "vt_utt_load"):
                lib.vt_utt_load.restype = ctypes.c_void_p
                lib.vt_utt_load.argtypes = [
                    ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
                    ctypes.c_uint32,
                ]
                lib.vt_utt_error.restype = ctypes.c_char_p
                lib.vt_utt_error.argtypes = [ctypes.c_void_p]
                for fname in ("vt_utt_audio", "vt_utt_spec"):
                    fn = getattr(lib, fname)
                    fn.restype = ctypes.POINTER(ctypes.c_float)
                    fn.argtypes = [ctypes.c_void_p]
                for fname in ("vt_utt_num_frames", "vt_utt_bins", "vt_utt_rate"):
                    fn = getattr(lib, fname)
                    fn.restype = ctypes.c_uint32
                    fn.argtypes = [ctypes.c_void_p]
                lib.vt_utt_free.restype = None
                lib.vt_utt_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
            break
    return _LIB


def available() -> bool:
    return load_library() is not None


# ---------------------------------------------------------------------- #
class NativeCheckpoint:
    """Zero-copy view of a .ggml checkpoint via the native parser.

    Tensor arrays alias the mmap until ``materialize()`` copies them; keep the
    object alive while the arrays are in use.
    """

    def __init__(self, source: str | bytes):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not built (see native/README)")
        self._lib = lib
        if isinstance(source, (bytes, bytearray)):
            self._handle = lib.vt_ggml_from_bytes(bytes(source), len(source))
        else:
            self._handle = lib.vt_ggml_open(source.encode())
        err = lib.vt_ggml_error(self._handle)
        if err:
            msg = err.decode()
            lib.vt_ggml_close(self._handle)
            self._handle = None
            raise ValueError(f"ggml parse error: {msg}")

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vt_ggml_close(self._handle)
            self._handle = None

    @property
    def vocab(self) -> dict[str, int]:
        lib = self._lib
        out = {}
        for i in range(lib.vt_ggml_num_vocab(self._handle)):
            e = lib.vt_ggml_vocab(self._handle, i).contents
            out[e.token.decode()] = int(e.id)
        return out

    @property
    def config_kv(self) -> dict[str, str]:
        lib = self._lib
        out = {}
        for i in range(lib.vt_ggml_num_config(self._handle)):
            e = lib.vt_ggml_config(self._handle, i).contents
            out[e.key.decode()] = e.value.decode()
        return out

    @property
    def tokenizer_meta(self) -> dict:
        lib = self._lib
        return {
            "add_blank": bool(lib.vt_ggml_add_blank(self._handle)),
            "normalize": bool(lib.vt_ggml_normalize(self._handle)),
            "pad_token": lib.vt_ggml_pad_token(self._handle).decode(),
            "unk_token": lib.vt_ggml_unk_token(self._handle).decode(),
        }

    def tensors(self, copy: bool = False) -> dict[str, np.ndarray]:
        lib = self._lib
        out = {}
        for i in range(lib.vt_ggml_num_tensors(self._handle)):
            t = lib.vt_ggml_tensor(self._handle, i).contents
            shape = tuple(t.dims[d] for d in range(t.rank))
            dtype = {0: np.float32, 1: np.float16, 2: np.int8}[t.dtype]
            buf = ctypes.cast(
                t.data, ctypes.POINTER(ctypes.c_uint8 * t.nbytes)
            ).contents
            arr = np.frombuffer(buf, dtype=dtype).reshape(shape)
            out[t.name.decode()] = arr.copy() if copy else arr
        return out


class NativeTokenizer:
    """Trie-based greedy tokenizer (byte-level longest match + blanks)."""

    def __init__(self, vocab: dict[str, int], add_blank: bool = True, blank_id: int = 0):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library not built")
        self._lib = lib
        self._handle = lib.vt_tokenizer_new(int(add_blank), blank_id)
        for token, tid in vocab.items():
            lib.vt_tokenizer_add(self._handle, token.encode(), tid)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vt_tokenizer_free(self._handle)
            self._handle = None

    def encode(self, text: str) -> list[int]:
        raw = text.encode()
        cap = len(raw) * 2 + 1
        buf = (ctypes.c_int32 * max(cap, 1))()
        n = self._lib.vt_tokenize(self._handle, raw, buf, cap)
        return list(buf[:n])


def loader_available() -> bool:
    """True when the built library has the corpus loader (vt_utt_*)."""
    lib = load_library()
    return lib is not None and hasattr(lib, "vt_utt_load")


def load_utterance(
    path: str, n_fft: int, hop: int, max_frames: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Native WAV decode + VITS-framed linear spectrogram.

    Drop-in equivalent of ``read_wav`` + ``train.data.linear_spectrogram``
    (audio bit-identical, spectrogram ~1e-6 relative — the C++ FFT runs in
    double like numpy's).  Returns ``(audio[T], spec[n_frames, bins], rate)``;
    ``n_frames`` may be 0 for too-short audio (empty arrays).  The underlying
    C call releases the GIL, so calls from a thread pool run in parallel.
    """
    lib = load_library()
    if lib is None or not hasattr(lib, "vt_utt_load"):
        raise RuntimeError("native corpus loader not available (rebuild native/)")
    handle = lib.vt_utt_load(path.encode(), n_fft, hop, max_frames)
    try:
        err = lib.vt_utt_error(handle)
        if err:
            raise ValueError(f"{path}: {err.decode()}")
        n_frames = lib.vt_utt_num_frames(handle)
        bins = lib.vt_utt_bins(handle)
        rate = lib.vt_utt_rate(handle)
        if n_frames == 0:
            return (np.empty((0,), np.float32),
                    np.empty((0, bins), np.float32), rate)
        audio = np.ctypeslib.as_array(
            lib.vt_utt_audio(handle), shape=(n_frames * hop,)).copy()
        spec = np.ctypeslib.as_array(
            lib.vt_utt_spec(handle), shape=(n_frames, bins)).copy()
        return audio, spec, rate
    finally:
        lib.vt_utt_free(handle)


def wav_encode(samples: np.ndarray, rate: int) -> bytes:
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library not built")
    arr = np.ascontiguousarray(samples, dtype=np.float32)
    n = arr.size
    out = (ctypes.c_uint8 * int(lib.vt_wav_size(n)))()
    lib.vt_wav_encode(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, rate, out
    )
    return bytes(out)


def load_ggml_native(source: str | bytes, dtype=np.float32):
    """Native-parser twin of vits_tpu_torch.io.loader.load_ggml (same return types)."""
    from vits_tpu_torch.config import VitsConfig
    from vits_tpu_torch.io.params import convert_state_dict
    from vits_tpu_torch.text.tokenizer import VitsTokenizer

    ck = NativeCheckpoint(source)
    config = VitsConfig.from_kv(ck.config_kv)
    meta = ck.tokenizer_meta
    tokenizer = VitsTokenizer(
        vocab=ck.vocab,
        add_blank=meta["add_blank"],
        normalize=meta["normalize"],
        pad_token=meta["pad_token"],
        unk_token=meta["unk_token"],
        phonetic=config.phonetic,
    )
    # copy=True: layout conversion is a no-op for 1-D params, and a no-copy
    # view into the mmap must not outlive the checkpoint handle.
    params = convert_state_dict(ck.tensors(copy=True), dtype=dtype)
    return config, tokenizer, params


class NativeEngineClient:
    """ctypes wrapper over the embeddable synthesis C ABI (vt_engine_*).

    Demonstrates what a C/C++/Swift embedder does: connect to a running
    engine server, call ``vt_synthesize``, get float PCM back.  The TPU
    program must live in the process that owns the chip, so the C ABI's
    synthesis entry point is a local-socket client — the TPU-native
    equivalent of the reference's in-process ``vits_model_process``
    (the reference's ``src/include/vits.h:102``).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 8080):
        self._lib = load_library()
        if self._lib is None or not hasattr(self._lib, "vt_engine_connect"):
            raise RuntimeError("native library with vt_synthesize not built")
        self._handle = self._lib.vt_engine_connect(host.encode(), port)
        err = self._lib.vt_engine_error(self._handle)
        if err:
            msg = err.decode()
            self.close()
            raise ConnectionError(msg)

    def synthesize(
        self,
        text: str,
        speaker_id: int | None = None,
        seed: int = 0,
        speaking_rate: float | None = None,
        noise_scale: float | None = None,
        noise_scale_duration: float | None = None,
    ) -> tuple[np.ndarray, int]:
        """Returns (float32 PCM, sample_rate).

        ``None`` controls mean "use the checkpoint's configured value" and
        travel as the C ABI's negative sentinel; explicit 0.0 (deterministic
        synthesis) is honored and sent through.
        """
        audio = self._lib.vt_synthesize(
            self._handle,
            text.encode("utf-8"),
            -1 if speaker_id is None else int(speaker_id),
            int(seed),
            -1.0 if speaking_rate is None else float(speaking_rate),
            -1.0 if noise_scale is None else float(noise_scale),
            -1.0 if noise_scale_duration is None else float(noise_scale_duration),
        )
        if not audio:
            err = self._lib.vt_engine_error(self._handle)
            raise RuntimeError(err.decode() if err else "vt_synthesize failed")
        try:
            n = int(self._lib.vt_audio_num_samples(audio))
            rate = int(self._lib.vt_audio_sample_rate(audio))
            ptr = self._lib.vt_audio_samples(audio)
            pcm = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        finally:
            self._lib.vt_audio_free(audio)
        return pcm, rate

    def convert(
        self,
        audio: np.ndarray,
        sample_rate: int,
        source_speaker: int | None = None,
        target_speaker: int | None = None,
        seed: int = 0,
        noise_scale: float | None = None,
    ) -> tuple[np.ndarray, int]:
        """Voice conversion through the C ABI (``vt_convert``).

        Returns (converted float32 PCM, sample_rate).  ``None`` speakers mean
        unconditioned; ``noise_scale=None`` is the deterministic default
        (posterior-mean conversion) — both ride the negative C sentinel.
        """
        if not hasattr(self._lib, "vt_convert"):
            raise RuntimeError("native library predates vt_convert — rebuild")
        pcm_in = np.ascontiguousarray(audio, dtype=np.float32)
        out = self._lib.vt_convert(
            self._handle,
            pcm_in.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(pcm_in),
            int(sample_rate),
            -1 if source_speaker is None else int(source_speaker),
            -1 if target_speaker is None else int(target_speaker),
            int(seed),
            -1.0 if noise_scale is None else float(noise_scale),
        )
        if not out:
            err = self._lib.vt_engine_error(self._handle)
            raise RuntimeError(err.decode() if err else "vt_convert failed")
        try:
            n = int(self._lib.vt_audio_num_samples(out))
            rate = int(self._lib.vt_audio_sample_rate(out))
            ptr = self._lib.vt_audio_samples(out)
            pcm = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
        finally:
            self._lib.vt_audio_free(out)
        return pcm, rate

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.vt_engine_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
