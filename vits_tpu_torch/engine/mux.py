"""Multiplexed streaming: concurrent /stream clients share window dispatches.

Counterpart of ``vits_tpu/engine/mux.py``. ``StreamingDecoder``
(engine/streaming.py) decodes fixed-size latent windows, but each client's
windows dispatch alone, so N concurrent streams queue N batch-1 decodes on
the card. ``MultiplexedStreamingDecoder`` batches them: every stream's window
decode has the same shape by construction (the decoder's chunk/margin
geometry is fixed per instance; whole-utterance decodes of short inputs are
mask-padded up to the window), so a background worker collects pending
window requests from any number of streams -- each at its own position in
its own utterance -- pads them to a power-of-two batch bucket and runs ONE
decode. Rows of the batched conv stack are independent and pad rows are
masked as the batch engine's are, so each stream's audio is its solo
decoder's (on the card within the tolerance that the batch size's tile and
K-split plans allow).

Usage (drop-in for StreamingDecoder, including in engine/server.py)::

    mux = MultiplexedStreamingDecoder(model, max_batch=8)
    for pcm in mux.stream("hello"):   # same interface; windows now batch
        play(pcm)
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from vits_tpu_torch.engine.streaming import StreamingDecoder


@dataclass
class _WindowReq:
    """One pending window decode: device slices + a completion event."""

    latents: torch.Tensor  # (1, W, C) device slice
    mask3: torch.Tensor  # (1, W, 1)
    spk: Optional[torch.Tensor]  # (1, 1, emb) or None
    window: int
    done: threading.Event = field(default_factory=threading.Event)
    wave: Optional[object] = None  # the batch's host copy, row ``row``, when done
    row: int = 0
    error: Optional[str] = None


class MultiplexedStreamingDecoder(StreamingDecoder):
    """StreamingDecoder whose window decodes batch across concurrent streams.

    ``max_batch`` bounds rows per dispatch (ragged counts pad up to a
    power-of-two bucket, so at most log2(max_batch)+1 batch shapes run per
    window); ``batch_window_ms`` is how long the worker waits to fill a batch
    once one request is pending -- with pipelined streams (pipeline_depth >=
    2) follow-up windows are already queued and the wait never triggers in
    steady state.

    The streams' prior slices and the worker's decode are enqueued on
    PyTorch's one current stream of the device (no thread here sets another),
    so a slice handed to the worker is ordered after the prior that wrote it
    without a cross-stream event; each waiter reads its row of the batch's
    host copy after that copy's event.
    """

    def __init__(
        self,
        synthesizer,
        max_batch: int = 8,
        batch_window_ms: float = 5.0,
        resolve_timeout_s: float = 300.0,
        **kwargs,
    ):
        super().__init__(synthesizer, **kwargs)
        self.max_batch = max(1, max_batch)
        self.batch_window_s = batch_window_ms / 1000.0
        self.resolve_timeout_s = resolve_timeout_s
        self._queue: "queue.Queue[_WindowReq]" = queue.Queue(maxsize=1024)
        self.stats = {"windows": 0, "dispatches": 0, "max_rows": 0}
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # --- the dispatch seam: enqueue instead of running ------------------- #
    @property
    def _window(self) -> int:
        return self.chunk_frames + 2 * self.total_margin

    @torch.inference_mode()
    def _dispatch_window(self, prior_latents, frame_mask3, speaker_embeddings,
                         lo: int, window: int):
        req = _WindowReq(
            latents=prior_latents[:, lo: lo + window],
            mask3=frame_mask3[:, lo: lo + window],
            spk=speaker_embeddings,
            window=window,
        )
        self._queue.put(req)
        return req

    @torch.inference_mode()
    def _dispatch_full(self, prior_latents, frame_mask3, speaker_embeddings,
                       num_frames: int):
        # Mask-pad short utterances up to the shared window so every request
        # in the system has one shape (padded frames are zero-masked -- the
        # same contract the bucketed batch engine keeps).
        window = self._window
        pad = window - num_frames
        if pad > 0:
            prior_latents = torch.nn.functional.pad(prior_latents, (0, 0, 0, pad))
            frame_mask3 = torch.nn.functional.pad(frame_mask3, (0, 0, 0, pad))
        return self._dispatch_window(
            prior_latents, frame_mask3, speaker_embeddings, 0, window
        )

    def _resolve(self, handle) -> np.ndarray:
        if not handle.done.wait(timeout=self.resolve_timeout_s):
            raise TimeoutError("multiplexed window decode timed out")
        if handle.error is not None:
            raise RuntimeError(f"window decode failed: {handle.error}")
        return handle.wave.numpy()[handle.row: handle.row + 1]

    # --- worker ----------------------------------------------------------- #
    def stop(self, timeout: float = 30.0) -> None:
        """Stop the worker and wait for it: a thread that ran CUDA work must not
        outlive the interpreter's shutdown (it would unwind through torch's
        frames while the process tears CUDA down)."""
        self._stop.set()
        if self._worker is not threading.current_thread():
            self._worker.join(timeout)

    def _collect(self) -> list[_WindowReq]:
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.batch_window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    @torch.inference_mode()
    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            # Speaker conditioning is another computation when absent (no
            # cond adds), so rows can only share a dispatch with matching
            # presence; a mixed pickup splits into two.
            with_spk = [r for r in batch if r.spk is not None]
            without = [r for r in batch if r.spk is None]
            for group in (with_spk, without):
                if not group:
                    continue
                try:
                    self._run_batch(group)
                except Exception as exc:  # surface to every waiter
                    for req in group:
                        req.error = f"{type(exc).__name__}: {exc}"
                        req.done.set()

    @staticmethod
    def _bucket(n: int, max_batch: int) -> int:
        b = 1
        while b < n:
            b *= 2
        return min(b, max_batch)

    def _run_batch(self, reqs: list[_WindowReq]) -> None:
        window = reqs[0].window
        if any(r.window != window for r in reqs):
            raise ValueError("mixed window shapes")
        b = self._bucket(len(reqs), self.max_batch)
        # pad rows replicate row 0 (cheapest same-shape filler; outputs of a
        # batched row-independent conv stack don't cross rows, and the pad
        # rows are never read back)
        fill = [reqs[0]] * (b - len(reqs))
        latents = torch.cat([r.latents for r in reqs + fill], dim=0)
        mask3 = torch.cat([r.mask3 for r in reqs + fill], dim=0)
        spk = None
        if reqs[0].spk is not None:
            spk = torch.cat([r.spk for r in reqs + fill], dim=0)
        wave = self._prefetch(self._decode(latents, mask3, spk)[: len(reqs)])
        for i, req in enumerate(reqs):
            req.wave, req.row = wave, i
            req.done.set()
        with self._stats_lock:
            self.stats["windows"] += len(reqs)
            self.stats["dispatches"] += 1
            self.stats["max_rows"] = max(self.stats["max_rows"], len(reqs))

    # --- warmup ------------------------------------------------------------ #
    def warmup(self, token_buckets=None, overflow_ladder: int = 0) -> None:
        """The base warmup (priors, including its capacity-overflow ladder
        rungs) plus the batched window decode at every batch bucket, with and
        without a speaker, under ``FlowPack.keeping()``: first clients must
        not pay kernel builds or flow-graph captures while holding stream
        slots."""
        super().warmup(token_buckets=token_buckets, overflow_ladder=overflow_ladder)
        synth = self.synth
        window = self._window
        config = synth.config
        buckets = []
        b = 1
        while b <= self.max_batch:
            buckets.append(b)
            b *= 2
        spk_variants = [None]
        if config.num_speakers > 1:
            spk_variants.append(synth.params["embed_speaker.weight"][:1][:, None, :])
        with synth._keeping_flow_graphs():
            for nb in buckets:
                # live traffic's dtypes (a bf16 engine's latents and masks are bf16)
                lat = torch.zeros((nb, window, config.flow_size), device=synth.device,
                                  dtype=synth.compute_dtype)
                mask3 = torch.ones((nb, window, 1), device=synth.device,
                                   dtype=synth.compute_dtype)
                for spk1 in spk_variants:
                    spk = None if spk1 is None else spk1.expand(nb, -1, -1).contiguous()
                    self._decode(lat, mask3, spk)
        if synth.device.type == "cuda":
            torch.cuda.synchronize(synth.device)
