"""Time-axis (sequence-parallel) sharded decode: one utterance over a mesh's replicas.

Counterpart of ``vits_tpu/engine/sp.py``. The mesh engine scales throughput
(rows over replicas); this shortens one utterance's latency: the flow and the
HiFi-GAN vocoder, frame-local conv stacks and most of the device time, run on
every replica of the mesh's data axis at once, each decoding a contiguous
slice of the latent frames.

  * The prior (encoder, durations, alignment, the prior draw) runs once, on
    replica 0, at the token bucket's frame capacity, doubled while the
    predicted length overflows it (the engine's ladder). It is small
    ((F, flow_size) values), so each replica copies its window of it.
  * Replica i keeps frames ``[i * shard, (i + 1) * shard)``, ``shard =
    ceil(F / n)``, and decodes a window of ``shard + 2 * (margin_frames +
    flow_margin_frames)`` frames around them; the margins are recomputed and
    discarded, as the streaming decoder's are (``engine/streaming.py``).
  * Every window has the same length, so every replica runs one shape. A
    window starts ``margin`` frames before its shard, moved right to frame 0
    and left to the padded end where those lie closer: the frames before a
    window's start are always the utterance's own, and the frames past the
    predicted length sit at its end under a zero mask, where the kernels'
    per-row lengths (kernels 6, B, C and 7 mask by length, a suffix) put
    them. The JAX package pads the prior by the margin at both ends
    instead; a masked zero margin at a window's front would be read as
    valid frames by a length-masked kernel. Every conv re-zeroes the masked
    tail, so the result equals the one-shot decode (``tests/test_torch_sp.py``).

The noise is the scalar seed's whole-row stream, as ``Synthesizer.synthesize(
text, seed)`` draws it for one text on a single-device engine (JAX:
``PRNGKey(seed)``). A mesh engine's replicas are reused; for another mesh
the engine's weights are placed on it once. The windows run kernels B and C
at each stage's window length and kernel 6's graph at ``(1, window)``, shapes
no engine dispatch runs: the first call builds them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vits_tpu_torch.engine.synthesizer import Replica, ReplicaSet, _next_bucket
from vits_tpu_torch.parallel.mesh import DATA_AXIS


class ShardedDecoder:
    """Decode single utterances with the time axis sharded over a mesh.

    Usage::

        mesh = make_mesh(data=8)
        sp = ShardedDecoder(model, mesh=mesh)
        audio = sp.synthesize("a very long paragraph ...")

    ``margin_frames`` / ``flow_margin_frames`` follow the streaming decoder's
    receptive-field analysis (the vocoder ~16 latent frames for MMS, the flow
    exactly 32; the defaults carry the same safety margin).
    """

    def __init__(self, synthesizer, mesh=None, margin_frames: int = 20,
                 flow_margin_frames: int = 40):
        self.synth = synthesizer
        mesh = mesh if mesh is not None else synthesizer.mesh
        if mesh is None:
            raise ValueError("ShardedDecoder needs a mesh (pass mesh= or use "
                             "a mesh-constructed Synthesizer)")
        if DATA_AXIS not in mesh.axis_names:
            raise ValueError(f"mesh needs a '{DATA_AXIS}' axis: {mesh}")
        self.mesh = mesh
        self.n_shards = mesh.shape[DATA_AXIS]
        self.total_margin = margin_frames + flow_margin_frames
        if synthesizer.mesh is mesh:
            self.replicas = synthesizer.replicas
        else:  # the engine's weights, placed on this mesh once
            devices = [torch.device(d) for d in mesh.devices.reshape(-1)]
            if any(d.type != synthesizer.device.type for d in devices):
                raise ValueError(f"mesh {mesh} on another device type than the engine's "
                                 f"{synthesizer.device}")
            self.replicas = ReplicaSet(synthesizer.replicas[0].placed(d) for d in devices)

    # ------------------------------------------------------------------ #
    def _decode_shard(self, replica: Replica, latents: torch.Tensor, mask3: torch.Tensor,
                      speaker_embeddings: torch.Tensor | None, lo: int, window: int,
                      offset: int, shard: int) -> np.ndarray:
        """Replica's window from ``lo``; its shard's samples, from ``offset`` frames in."""
        piece = [t[:, lo: lo + window].to(replica.device) for t in (latents, mask3)]
        emb = None if speaker_embeddings is None else speaker_embeddings.to(replica.device)
        wave = self.synth._decode_on(replica, *piece, emb)
        up = self.synth.config.total_upsample
        return self.synth._host(wave[:, offset * up: (offset + shard) * up])

    # ------------------------------------------------------------------ #
    def synthesize(
        self,
        text: str,
        seed: int = 0,
        speaker_id: Optional[int] = None,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
        trim: bool = True,
    ) -> np.ndarray:
        """Synthesize one utterance with the flow and vocoder sharded over the mesh.

        Equal to ``Synthesizer.synthesize(text, seed)`` of a single-device
        engine with ``transfer_int16=False`` and the same controls, within the
        plain convs' summation order (``tests/test_torch_sp.py``)."""
        synth = self.synth
        encoded = synth.tokenizer.encode(text)
        t_bucket = _next_bucket(synth.engine.token_buckets, max(len(encoded), 1))
        ids, mask = synth.tokenizer.pad([encoded], pad_to=t_bucket)
        num_frames = synth._frame_capacity(t_bucket)
        spk = None if speaker_id is None else np.asarray([speaker_id], np.int64)
        controls = synth._controls(noise_scale, noise_scale_duration, speaking_rate)
        prior = self.replicas.call(0, synth._prior_on, ids, mask, num_frames, int(seed), spk,
                                   controls)
        # the overflow ladder, as the engine and the streamer run it
        for _ in range(4):
            predicted = int(prior.total_duration[0].item())
            if predicted <= num_frames:
                break
            while num_frames < predicted:
                num_frames *= 2
            prior = self.replicas.call(0, synth._prior_on, ids, mask, num_frames, int(seed),
                                       spk, controls)
        valid_frames = min(predicted, num_frames)

        n, m = self.n_shards, self.total_margin
        shard = -(-num_frames // n)  # ceil: every replica the same window
        window = shard + 2 * m
        padded = max(shard * n, window)
        latents = F.pad(prior.prior_latents, (0, 0, 0, padded - num_frames))
        mask3 = F.pad(prior.frame_mask, (0, padded - num_frames))[..., None]
        jobs = []
        for i in range(n):
            lo = min(max(i * shard - m, 0), padded - window)
            jobs.append((latents, mask3, prior.speaker_embeddings, lo, window, i * shard - lo,
                         shard))
        wave = np.concatenate(self.replicas.run(self._decode_shard, jobs), axis=1)[0]
        if trim:
            wave = wave[: valid_frames * synth.config.total_upsample]
        return wave
