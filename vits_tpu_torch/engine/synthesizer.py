"""The synthesis engine: token buckets, frame capacity, overflow re-dispatch.

Counterpart of ``vits_tpu/engine/synthesizer.py``, reduced to the main path:
``load``/``__init__``, ``synthesize``, ``synthesize_raw``, ``submit`` /
``collect``, token buckets, the frame capacity of
``EngineConfig.frame_bucket`` with its adaptive raise and decay, the overflow
re-dispatch ladder, trimming, per-row seeds, per-row speakers of a
multi-speaker model (``speaker_id``) and voice conversion
(:meth:`Synthesizer.convert_voice`). ``EngineConfig.use_pallas_flow`` runs
the reverse flow of synthesis as kernel 6, as it runs the fused flow kernel in
the JAX engine; without it the plain flow runs.

Every dispatch pads a batch into its token bucket and runs at a static frame
capacity; ``collect`` reads the predicted frame counts and, when they exceed
the capacity, runs the batch again at double capacity. ``submit`` enqueues
the whole dispatch on the device and returns; ``collect`` copies to the host.

Noise: ``seed=int`` draws the whole batch from one ``torch.Generator``
(HF-style); ``seed=[...]`` gives each row its own
``torch.Generator(device).manual_seed(seed_i)``, so a row's audio does not
depend on the rest of its batch. The port shares no random stream with the
JAX package.

Precision: fp32 everywhere. TF32 is switched off for cuDNN convolutions and
cuBLAS matmuls when an engine is made on a CUDA device (``_fp32_backends``):
TF32 convs can flip ``ceil(exp(log_duration))`` frame counts.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vits_tpu_torch.config import EngineConfig, VitsConfig
from vits_tpu_torch.io import VitsTokenizer, load_ggml, load_hf_pretrained
from vits_tpu_torch.io.params import from_jax_params
from vits_tpu_torch.models.vits import synthesize as synthesize_fn
from vits_tpu_torch.models.vits import voice_convert

# EngineConfig fields the port does not honour yet: each must keep its default.
_UNSUPPORTED_FIELDS = (
    "compute_dtype", "batch_buckets", "use_pallas_vocoder", "pallas_precision",
    "pallas_value_dtype", "pallas_weight_format", "use_pallas_attention",
    "matmul_precision", "compilation_cache_dir", "aot_bundle_dir",
)


def _check_engine_config(engine: EngineConfig) -> None:
    default = EngineConfig()
    changed = [f for f in _UNSUPPORTED_FIELDS if getattr(engine, f) != getattr(default, f)]
    if changed:
        raise NotImplementedError(
            f"EngineConfig fields not ported to vits_tpu_torch yet: {', '.join(changed)}")


def _fp32_backends(device: torch.device) -> None:
    """Full fp32 for the plain convs and matmuls on a CUDA device (no TF32)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class EngineOutput(NamedTuple):
    """Host-side synthesis result (numpy)."""

    waveform: np.ndarray  # (B, capacity_samples) float32
    lengths: np.ndarray  # (B,) valid samples (clamped to capacity)
    frame_lengths: np.ndarray  # (B,) predicted frames, unclamped
    log_duration: np.ndarray  # (B, T_in, 1)


class PendingSynthesis(NamedTuple):
    """A dispatch enqueued on the device; :meth:`Synthesizer.collect` fetches it."""

    device_out: tuple
    ids: np.ndarray
    mask: np.ndarray
    num_frames: int
    seed: int | tuple[int, ...]
    speaker: np.ndarray | None
    controls: tuple


def _next_bucket(buckets: Sequence[int], value: int) -> int:
    for b in buckets:
        if value <= b:
            return b
    biggest = buckets[-1]
    return ((value + biggest - 1) // biggest) * biggest


def _speaker_rows(value, rows: int, given: int, name: str) -> np.ndarray | None:
    """One speaker id for every row, from one id or one per input; rows past
    the inputs (padding) ride speaker 0."""
    if value is None:
        return None
    arr = np.asarray(value, np.int64)
    out = np.zeros((rows,), np.int64)
    if arr.ndim == 0:
        out[:] = arr
    elif arr.shape == (given,):
        out[:given] = arr
    else:
        raise ValueError(f"{name} list length {arr.shape} != number of inputs ({given})")
    return out


class Synthesizer:
    def __init__(
        self,
        config: VitsConfig,
        tokenizer: VitsTokenizer,
        params: dict,
        engine_config: Optional[EngineConfig] = None,
        *,
        device: torch.device | str,
    ):
        """``params``: canonical-layout numpy parameters (``vits_tpu_torch.io``)."""
        self.config = config
        self.tokenizer = tokenizer
        self.engine = engine_config or EngineConfig()
        _check_engine_config(self.engine)
        self.device = torch.device(device)
        _fp32_backends(self.device)
        self.params = from_jax_params(params, self.device)
        # Working frames/token ratio, raised on overflow and decayed back
        # (EngineConfig.adaptive_capacity*), as in the JAX engine.
        self._frames_per_token = float(self.engine.frames_per_token)
        self._rate_window: deque = deque(maxlen=max(1, self.engine.adaptive_capacity_window))
        self.stats = {
            "dispatches": 0,
            "redispatches": 0,
            "audio_seconds": 0.0,
            "wall_seconds": 0.0,
        }

    @classmethod
    def load(cls, source, engine_config: Optional[EngineConfig] = None, *,
             device: torch.device | str) -> "Synthesizer":
        """Load from a .ggml path/bytes or an HF directory."""
        if isinstance(source, (bytes, bytearray)):
            config, tokenizer, params = load_ggml(bytes(source))
        elif isinstance(source, str) and source.endswith(".ggml"):
            config, tokenizer, params = load_ggml(source)
        else:
            config, tokenizer, params = load_hf_pretrained(source)
        return cls(config, tokenizer, params, engine_config, device=device)

    # ------------------------------------------------------------------ #
    def _controls(self, noise_scale, noise_scale_duration, speaking_rate) -> tuple:
        cfg = self.config
        return (
            float(cfg.noise_scale if noise_scale is None else noise_scale),
            float(cfg.noise_scale_duration if noise_scale_duration is None
                  else noise_scale_duration),
            float(cfg.speaking_rate if speaking_rate is None else speaking_rate),
        )

    def _generators(self, seed: int | tuple[int, ...]):
        if isinstance(seed, tuple):
            return [torch.Generator(self.device).manual_seed(s) for s in seed]
        return torch.Generator(self.device).manual_seed(seed)

    def _speaker_tensor(self, speaker: np.ndarray | None) -> torch.Tensor | None:
        if speaker is None:
            return None
        if speaker.min() < 0 or speaker.max() >= self.config.num_speakers:
            raise ValueError(f"speaker ids {speaker.tolist()} outside "
                             f"[0, {self.config.num_speakers})")
        return torch.as_tensor(speaker, dtype=torch.long).to(self.device)

    @torch.inference_mode()
    def _dispatch(self, ids: np.ndarray, mask: np.ndarray, num_frames: int, seed,
                  speaker: np.ndarray | None, controls: tuple) -> tuple:
        t0 = time.perf_counter()
        noise_scale, noise_scale_duration, speaking_rate = controls
        out = synthesize_fn(
            self.params, self.config,
            torch.as_tensor(ids, dtype=torch.long).to(self.device),
            torch.as_tensor(mask, dtype=torch.float32).to(self.device),
            num_frames,
            generator=self._generators(seed),
            speaker_id=self._speaker_tensor(speaker),
            noise_scale=noise_scale,
            noise_scale_duration=noise_scale_duration,
            speaking_rate=speaking_rate,
            use_pallas_flow=self.engine.use_pallas_flow,
        )
        wave = out.waveform
        if self.engine.transfer_int16:
            wave = torch.round(torch.clamp(wave, -1.0, 1.0) * 32767.0).to(torch.int16)
        self.stats["dispatches"] += 1
        self.stats["wall_seconds"] += time.perf_counter() - t0
        return (wave, out.lengths, out.frame_lengths, out.log_duration)

    @staticmethod
    def _fetch(device_out: tuple) -> EngineOutput:
        host = [t.cpu().numpy() for t in device_out]
        wave = host[0]
        if wave.dtype == np.int16:
            wave = wave.astype(np.float32) / 32767.0
        return EngineOutput(wave, *host[1:])

    # ------------------------------------------------------------------ #
    def synthesize(
        self,
        texts: str | Sequence[str],
        *,
        seed: int | Sequence[int] = 0,
        speaker_id: Optional[int | Sequence[int]] = None,
        trim: bool = True,
        max_redispatch: int = 3,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
    ):
        """Text(s) -> float32 PCM at ``config.sampling_rate``.

        A single string returns one 1-D array; a list returns a list, each
        trimmed to its predicted length unless ``trim=False``. ``speaker_id``
        (a multi-speaker model) is one id for all texts or one per text.
        """
        single = isinstance(texts, str)
        out = self.synthesize_raw(
            texts, seed=seed, speaker_id=speaker_id, max_redispatch=max_redispatch,
            noise_scale=noise_scale,
            noise_scale_duration=noise_scale_duration, speaking_rate=speaking_rate,
        )
        n_texts = 1 if single else len(texts)
        results = [out.waveform[i, : out.lengths[i]] if trim else out.waveform[i]
                   for i in range(n_texts)]
        return results[0] if single else results

    def submit(
        self,
        texts: str | Sequence[str],
        *,
        seed: int | Sequence[int] = 0,
        speaker_id: Optional[int | Sequence[int]] = None,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
    ) -> PendingSynthesis:
        """Enqueue one dispatch on the device; pair with :meth:`collect`."""
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.tokenizer.encode(t) for t in texts]
        max_len = max((len(e) for e in encoded), default=1) or 1
        t_bucket = _next_bucket(self.engine.token_buckets, max_len)
        ids, mask = self.tokenizer.pad(encoded, pad_to=t_bucket)
        if isinstance(seed, (int, np.integer)):
            seed_spec = int(seed)
        else:
            seed_spec = tuple(int(s) for s in seed)
            if len(seed_spec) != len(texts):
                raise ValueError(
                    f"seed list length {len(seed_spec)} != number of texts ({len(texts)})")
        speaker = _speaker_rows(speaker_id, ids.shape[0], len(texts), "speaker_id")
        controls = self._controls(noise_scale, noise_scale_duration, speaking_rate)
        num_frames = self._frame_capacity(t_bucket)
        device_out = self._dispatch(ids, mask, num_frames, seed_spec, speaker, controls)
        return PendingSynthesis(device_out, ids, mask, num_frames, seed_spec, speaker, controls)

    def collect(self, pending: PendingSynthesis, max_redispatch: int = 3) -> EngineOutput:
        """Fetch a dispatch to the host, re-dispatching at double capacity on overflow."""
        out = self._fetch(pending.device_out)
        predicted = int(out.frame_lengths.max())
        num_frames = pending.num_frames
        rate = self._observed_rate(pending, out.frame_lengths)
        if predicted <= num_frames:
            self._maybe_decay()
        else:
            self._observe_overflow(rate)
            for attempt in range(max_redispatch):
                while num_frames < predicted:
                    num_frames *= 2
                self.stats["redispatches"] += 1
                device_out = self._dispatch(pending.ids, pending.mask, num_frames,
                                            pending.seed, pending.speaker, pending.controls)
                predicted = int(device_out[2].max().item())
                if predicted <= num_frames or attempt == max_redispatch - 1:
                    out = self._fetch(device_out)
                    break
        self.stats["audio_seconds"] += float(np.sum(out.lengths)) / self.config.sampling_rate
        return out

    def synthesize_raw(
        self,
        texts: str | Sequence[str],
        *,
        seed: int | Sequence[int] = 0,
        speaker_id: Optional[int | Sequence[int]] = None,
        max_redispatch: int = 3,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
    ) -> EngineOutput:
        """Untrimmed batched output (host numpy) plus per-row lengths."""
        pending = self.submit(
            texts, seed=seed, speaker_id=speaker_id, noise_scale=noise_scale,
            noise_scale_duration=noise_scale_duration, speaking_rate=speaking_rate,
        )
        return self.collect(pending, max_redispatch=max_redispatch)

    @torch.inference_mode()
    def convert_voice(
        self,
        audio: np.ndarray | Sequence[np.ndarray],
        *,
        source_speaker: Optional[int | Sequence[int]] = None,
        target_speaker: Optional[int | Sequence[int]] = None,
        seed: int = 0,
        noise_scale: float = 0.0,
        trim: bool = True,
    ):
        """Voice conversion: source audio -> the same speech in the target voice.

        ``audio`` is one 1-D float32 waveform at ``config.sampling_rate`` (or a
        list; returns a list). The spectrogram is framed as in training (hop =
        total_upsample, n_fft = 2*(spectrogram_bins-1)), so posterior frames
        align 1:1 with latent frames, and padded to the smallest frame bucket
        that holds the longest input. ``noise_scale=0`` converts the posterior
        mean: deterministic. Otherwise row r draws its noise from its own
        ``torch.Generator`` seeded from (seed, r).
        """
        from vits_tpu_torch.train.data import linear_spectrogram

        single = isinstance(audio, np.ndarray) and np.ndim(audio) == 1
        waves_in = [audio] if single else list(audio)
        hop = self.config.total_upsample
        n_fft = 2 * (self.config.spectrogram_bins - 1)
        specs = []
        for a in waves_in:
            a = np.asarray(a, np.float32).reshape(-1)
            floor = max(hop, (n_fft - hop) // 2 + 1)  # reflect padding and one frame
            if len(a) < floor:
                a = np.pad(a, (0, floor - len(a)))
            n_frames = len(a) // hop
            specs.append(linear_spectrogram(a[: n_frames * hop], n_fft, hop)[:n_frames])
        batch = len(specs)
        capacity = _next_bucket([self._frame_capacity(tb) for tb in self.engine.token_buckets],
                                max(s.shape[0] for s in specs))
        spec = np.zeros((batch, capacity, self.config.spectrogram_bins), np.float32)
        mask = np.zeros((batch, capacity), np.float32)
        for i, s in enumerate(specs):
            spec[i, : s.shape[0]] = s
            mask[i, : s.shape[0]] = 1.0
        src = _speaker_rows(source_speaker, batch, batch, "source_speaker")
        tgt = _speaker_rows(target_speaker, batch, batch, "target_speaker")
        generators = [torch.Generator(self.device).manual_seed(
            int(np.random.SeedSequence([seed, r]).generate_state(1, np.uint64)[0]))
            for r in range(batch)]
        t0 = time.perf_counter()
        out = voice_convert(
            self.params, self.config, torch.as_tensor(spec).to(self.device),
            torch.as_tensor(mask).to(self.device), self._speaker_tensor(src),
            self._speaker_tensor(tgt), generator=generators, noise_scale=noise_scale)
        wave = out.waveform.cpu().numpy()
        self.stats["dispatches"] += 1
        self.stats["wall_seconds"] += time.perf_counter() - t0
        results = [wave[i, : specs[i].shape[0] * hop] if trim else wave[i]
                   for i in range(batch)]
        return results[0] if single else results

    # ------------------------------------------------------------------ #
    # Frame capacity: the JAX engine's adaptive ratio, on host numbers only.
    def _frame_capacity(self, token_bucket: int) -> int:
        eng = self.engine
        if eng.adaptive_capacity_align and self._frames_per_token > eng.frames_per_token:
            k = float(np.log2(self._frames_per_token / eng.frames_per_token))
            if abs(k - round(k)) < 1e-6:  # on-ladder ratio: base capacity doubled k times
                return eng.frame_bucket(token_bucket) * (2 ** max(0, int(round(k))))
        return eng.frame_bucket(token_bucket, ratio=self._frames_per_token)

    def _observed_rate(self, pending: PendingSynthesis, frame_lengths) -> float | None:
        """Per-dispatch frames/token, or None when the controls change durations."""
        defaults = (self.config.noise_scale_duration, self.config.speaking_rate)
        observed = (pending.controls[1], pending.controls[2])
        for obs, dflt in zip(observed, defaults):
            if abs(float(np.float32(obs)) - float(np.float32(dflt))) > 1e-6:
                return None
        tokens = np.maximum(np.asarray(pending.mask, np.float32).sum(axis=1), 1.0)
        rate = float(np.max(np.asarray(frame_lengths, np.float32) / tokens))
        self._rate_window.append(rate)
        return rate

    def _aligned_ratio(self, rate: float, round_up: bool = True) -> float:
        """Smallest (largest, if ``round_up=False``) base * 2^k covering ``rate``."""
        base = float(self.engine.frames_per_token)
        if rate <= base:
            return base
        k = float(np.log2(rate / base))
        k = int(np.ceil(k - 1e-9)) if round_up else int(np.floor(k + 1e-9))
        return base * (2 ** max(0, k))

    def _observe_overflow(self, rate: float | None) -> None:
        """Raise the working ratio to cover an overflow, within the config's clamps."""
        eng = self.engine
        if not eng.adaptive_capacity or rate is None:
            return
        if eng.adaptive_capacity_align:
            bumped = min(self._aligned_ratio(rate), self._frames_per_token * 2.0,
                         self._aligned_ratio(float(eng.adaptive_capacity_max), round_up=False))
        else:
            step = max(eng.adaptive_capacity_step, 1e-3)
            bumped = min(float(np.ceil(rate / step) * step),
                         self._frames_per_token * 2.0,
                         self._frames_per_token + float(eng.adaptive_capacity_request_max),
                         float(eng.adaptive_capacity_max))
        if bumped > self._frames_per_token:
            self._frames_per_token = bumped
            self._rate_window.clear()

    def _maybe_decay(self) -> None:
        """After a full window of dispatches, fall back to what the window needed."""
        eng = self.engine
        if not (eng.adaptive_capacity and eng.adaptive_capacity_decay):
            return
        floor = float(eng.frames_per_token)
        if self._frames_per_token <= floor or len(self._rate_window) < self._rate_window.maxlen:
            return
        if eng.adaptive_capacity_align:
            target = max(floor, self._aligned_ratio(max(self._rate_window)))
        else:
            step = max(eng.adaptive_capacity_step, 1e-3)
            target = max(floor, float(np.ceil(max(self._rate_window) / step) * step))
        if target < self._frames_per_token:
            self._frames_per_token = target
            self._rate_window.clear()
