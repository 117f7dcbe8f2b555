"""Chunked streaming decode: audio before the whole utterance is decoded.

Counterpart of ``vits_tpu/engine/streaming.py``. Only the globally coupled
stages (encoder -> durations -> alignment -> prior draw) run over the whole
utterance; the reverse flow and the HiFiGAN vocoder, both frame-local conv
stacks, then decode fixed-size windows of the prior latents, each with a
receptive-field margin on either side that is recomputed and discarded
(overlap-discard). ``margin_frames`` covers the vocoder's receptive field
(20 by default) and ``flow_margin_frames`` the flow's (40): a window decodes
``chunk_frames + 2 * (margin_frames + flow_margin_frames)`` frames.

The prior runs as ``Synthesizer.synthesize(text, seed)`` runs it for one
text: one ``torch.Generator(device).manual_seed(seed)``, at the static
capacity ``EngineConfig.frame_bucket(token_bucket)`` doubled while the
predicted length overflows it. The scalar generator draws ``(1, F, flow)``
prior normals, so a stream equals the one-shot decode only when both end at
the same capacity: compare against an engine built with
``EngineConfig(adaptive_capacity=False)``, whose one-shot capacity starts at
the same ``frame_bucket`` and doubles the same way. On CPU tensors (the
plain twins) the concatenated stream then equals ``synthesize`` with
``transfer_int16=False`` within fp32 rounding; on the card the kernels pick
tiles and K splits per (B, T), so a window and the whole utterance sum in
different orders and agree within a tolerance.

Each window's waveform goes to pinned host memory with a ``non_blocking``
copy and a CUDA event (``_prefetch``); ``pipeline_depth`` windows are in
flight while the host drains the oldest. Nothing between dispatches waits
for the card except the read of the predicted length, which rides behind the
first window.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from vits_tpu_torch.engine.synthesizer import _next_bucket


class _Prior(NamedTuple):
    latents: torch.Tensor  # (1, F, flow_size)
    mask3: torch.Tensor  # (1, F, 1)
    speaker_embeddings: Optional[torch.Tensor]  # (1, 1, speaker_emb)
    total_duration: torch.Tensor  # (1,) predicted frames, unclamped


class _HostCopy(NamedTuple):
    """A device tensor on its way to the host: pinned copy plus the event after it."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]

    def numpy(self) -> np.ndarray:
        """The waveform on the host, fp32 (a bf16 engine's upcast here, as in JAX)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host.float().numpy()


class StreamingDecoder:
    """Wraps a Synthesizer with chunked flow + vocoder dispatch.

    Usage::

        stream = StreamingDecoder(model)
        for pcm_chunk in stream.stream("hello world"):
            play(pcm_chunk)  # float32 PCM
    """

    def __init__(
        self,
        synthesizer,
        chunk_frames: int = 64,
        margin_frames: int = 20,
        flow_margin_frames: int = 40,
        pipeline_depth: int = 2,
    ):
        self.synth = synthesizer
        self.chunk_frames = chunk_frames
        self.margin_frames = margin_frames
        self.flow_margin_frames = flow_margin_frames
        # Window decodes in flight at once: depth 2+ overlaps each chunk's
        # device->host copy (and the host's drain) with the next chunk's compute.
        self.pipeline_depth = max(1, pipeline_depth)
        # Shapes run: ("prior", token bucket, frames, speakers) and
        # ("window", rows, frames, speakers), as Synthesizer._dispatch_shapes.
        self._dispatch_shapes: set = set()

    @property
    def total_margin(self) -> int:
        return self.margin_frames + self.flow_margin_frames

    # ------------------------------------------------------------------ #
    @torch.inference_mode()
    def _prior(self, ids: np.ndarray, mask: np.ndarray, num_frames: int, seed: int,
               speaker: np.ndarray | None, controls: tuple) -> _Prior:
        prior = self.synth._prior_on(self.synth.replicas[0], ids, mask, num_frames, seed,
                                     speaker, controls)
        self._dispatch_shapes.add(("prior", ids.shape[1], num_frames, speaker is not None))
        return _Prior(prior.prior_latents, prior.frame_mask[..., None],
                      prior.speaker_embeddings, prior.total_duration)

    @torch.inference_mode()
    def _decode(self, latents: torch.Tensor, mask3: torch.Tensor,
                speaker_embeddings: torch.Tensor | None) -> torch.Tensor:
        """Flow + vocoder over (B, W) frames -> (B, W * total_upsample) waveform."""
        wave = self.synth._decode_on(self.synth.replicas[0], latents, mask3,
                                     speaker_embeddings)
        self._dispatch_shapes.add(("window", *latents.shape[:2],
                                   speaker_embeddings is not None))
        return wave

    def warmup(self, token_buckets=None, overflow_ladder: int = 0) -> None:
        """Run the streaming shapes ahead of traffic.

        One prior per token bucket (and, with ``overflow_ladder=N``, per rung
        of its capacity-doubling ladder) and the window decode at each, with
        and without a speaker on a multi-speaker model, under
        ``FlowPack.keeping()``: the kernels are built, cuDNN has picked its
        algorithms and kernel 6's graph is captured for every shape a stream
        of those buckets runs, so the first client pays none of it.
        """
        synth = self.synth
        buckets = tuple(token_buckets or synth.engine.token_buckets)
        window = self.chunk_frames + 2 * self.total_margin
        controls = synth._controls(None, None, None)
        speakers = [None]
        if synth.config.num_speakers > 1:
            speakers.append(np.zeros((1,), np.int64))
        with synth._keeping_flow_graphs():
            for tb in buckets:
                ids = np.zeros((1, tb), np.int32)
                mask = np.ones((1, tb), np.float32)
                base_frames = synth.engine.frame_bucket(tb)
                for spk in speakers:
                    for rung in range(overflow_ladder + 1):
                        num_frames = base_frames * (2 ** rung)
                        prior = self._prior(ids, mask, num_frames, 0, spk, controls)
                        w = min(window, num_frames)
                        self._decode(prior.latents[:, :w], prior.mask3[:, :w],
                                     prior.speaker_embeddings)
        if synth.device.type == "cuda":
            torch.cuda.synchronize(synth.device)

    # --- window-dispatch seam (overridden by MultiplexedStreamingDecoder) -- #
    @staticmethod
    def _prefetch(t: torch.Tensor) -> _HostCopy:
        """Start ``t``'s copy to the host: pinned memory and an event on the card."""
        if t.device.type != "cuda":
            return _HostCopy(t, None)
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)  # on the current stream of t's device
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(t.device))
        return _HostCopy(host, event)

    @torch.inference_mode()
    def _dispatch_window(self, prior_latents, frame_mask3, speaker_embeddings,
                         lo: int, window: int):
        """Dispatch one fixed-size window decode; returns an opaque handle."""
        wave = self._decode(prior_latents[:, lo: lo + window],
                            frame_mask3[:, lo: lo + window], speaker_embeddings)
        return self._prefetch(wave)

    def _dispatch_full(self, prior_latents, frame_mask3, speaker_embeddings,
                       num_frames: int):
        """Whole-utterance decode for inputs that fit in one window."""
        return self._prefetch(self._decode(prior_latents, frame_mask3, speaker_embeddings))

    def _resolve(self, handle) -> np.ndarray:
        """Handle -> (1, T) float PCM; blocks until the decode lands."""
        return handle.numpy()

    # ------------------------------------------------------------------ #
    def stream(
        self, text: str, seed: int = 0, speaker_id: int | None = None,
        noise_scale: float | None = None,
        noise_scale_duration: float | None = None,
        speaking_rate: float | None = None,
    ) -> Iterator[np.ndarray]:
        """Yield float32 PCM chunks; concatenation == one-shot synthesis."""
        synth = self.synth
        tok = synth.tokenizer

        encoded = tok.encode(text)
        t_bucket = _next_bucket(synth.engine.token_buckets, max(len(encoded), 1))
        ids, mask = tok.pad([encoded], pad_to=t_bucket)
        num_frames = synth.engine.frame_bucket(t_bucket)
        spk = None if speaker_id is None else np.asarray([speaker_id], np.int64)

        controls = synth._controls(noise_scale, noise_scale_duration, speaking_rate)
        up = synth.config.total_upsample
        chunk, margin = self.chunk_frames, self.total_margin
        window = chunk + 2 * margin

        prior = self._prior(ids, mask, num_frames, seed, spk, controls)
        total = self._prefetch(prior.total_duration)

        # Speculative first-window decode: the common case is no capacity
        # overflow, so dispatch chunk 0 BEFORE waiting on total_duration --
        # the overflow check's host round-trip then rides behind the first
        # window's compute instead of preceding it.
        spec_wave = None
        if num_frames > window:
            spec_wave = self._dispatch_window(
                prior.latents, prior.mask3, prior.speaker_embeddings, 0, window,
            )

        # Escalate capacity (doubling ladder, like Synthesizer.collect)
        # if the predicted length overflowed the frame bucket.
        for _ in range(4):
            predicted = int(total.numpy()[0])
            if predicted <= num_frames:
                break
            spec_wave = None  # latents are being recomputed; discard
            while num_frames < predicted:
                num_frames *= 2
            prior = self._prior(ids, mask, num_frames, seed, spk, controls)
            total = self._prefetch(prior.total_duration)
        valid_frames = int(min(total.numpy()[0], num_frames))

        if num_frames <= window:
            # Utterance fits in one window: plain one-shot decode.
            handle = self._dispatch_full(
                prior.latents, prior.mask3, prior.speaker_embeddings, num_frames
            )
            yield self._resolve(handle)[0, : valid_frames * up]
            return

        def submit(start):
            lo = min(max(start - margin, 0), num_frames - window)
            if start == 0 and spec_wave is not None:
                handle = spec_wave  # lo == 0 for the first chunk
            else:
                handle = self._dispatch_window(
                    prior.latents, prior.mask3, prior.speaker_embeddings, lo, window,
                )
            offset = (start - lo) * up
            n_valid = min(chunk, valid_frames - start) * up
            return handle, offset, n_valid

        inflight: deque = deque()
        for start in range(0, valid_frames, chunk):
            inflight.append(submit(start))
            if len(inflight) >= self.pipeline_depth:
                handle, offset, n_valid = inflight.popleft()
                yield self._resolve(handle)[0, offset: offset + n_valid]
        while inflight:
            handle, offset, n_valid = inflight.popleft()
            yield self._resolve(handle)[0, offset: offset + n_valid]

    def synthesize_streaming(
        self, text: str, seed: int = 0, speaker_id: int | None = None, **controls
    ) -> np.ndarray:
        """Convenience: concatenate all streamed chunks."""
        return np.concatenate(
            list(self.stream(text, seed=seed, speaker_id=speaker_id, **controls))
        )
