"""Full VITS synthesis at a static frame capacity.

Counterpart of ``vits_tpu/models/vits.py``: text -> prior (encoder, SDP,
duration alignment as a one-hot matmul, prior draw) -> reverse flow ->
vocoder, all at ``num_frames`` frames; the predicted length comes out as a
tensor the engine uses to trim (and to re-dispatch on overflow). A
multi-speaker model (``num_speakers > 1``) takes one ``speaker_id`` per row:
its embedding conditions the duration predictor, the flow and the vocoder.
``use_pallas_flow`` runs the reverse flow as kernel 6 (``ops/cuda/flow.py``),
as the JAX option of that name runs its fused flow kernel; without it the
plain flow runs. :func:`voice_convert` re-synthesises a spectrogram in
another speaker's voice.

Noise enters explicitly: a ``torch.Generator`` (one for the batch, or one per
row) or recorded draws in a :class:`NoiseOverride`, the hook the parity tests
share with the JAX package. Draws follow the JAX shapes: duration
``(B, T_in, 2)`` then prior ``(B, F, flow)``; a per-row generator draws its
row's duration noise, then its prior noise in blocks of
:data:`PRIOR_NOISE_BLOCK` frames, so a row's noise does not depend on the
frame capacity its batch ran at.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.models.duration import (
    duration_predictor,
    stochastic_duration_predictor_reverse,
)
from vits_tpu_torch.models.encoder import text_encoder
from vits_tpu_torch.models.flow import residual_coupling_block, residual_coupling_forward
from vits_tpu_torch.models.hifigan import hifigan
from vits_tpu_torch.models.posterior import posterior_encoder
from vits_tpu_torch.ops.cuda.flow import fused_flow

PRIOR_NOISE_BLOCK = 64  # frames per per-row prior-noise draw


class NoiseOverride(NamedTuple):
    """Concrete standard-normal draws, in the order HF/torch draws them."""

    duration: torch.Tensor  # (B, T_in, 2)
    prior: torch.Tensor  # (B, T_frames, flow_size)


class SynthesisOutput(NamedTuple):
    waveform: torch.Tensor  # (B, T_frames * total_upsample) in [-1, 1]
    lengths: torch.Tensor  # (B,) int32 valid samples per row (clamped to capacity)
    frame_lengths: torch.Tensor  # (B,) int32 predicted frames, UNclamped
    latents: torch.Tensor  # (B, T_frames, flow_size) flow output
    log_duration: torch.Tensor  # (B, T_in, 1)


class PriorOutput(NamedTuple):
    prior_latents: torch.Tensor  # (B, T_frames, flow_size)
    frame_mask: torch.Tensor  # (B, T_frames)
    total_duration: torch.Tensor  # (B,) float, UNclamped predicted frames
    log_duration: torch.Tensor  # (B, T_in, 1)
    speaker_embeddings: torch.Tensor | None  # (B, 1, speaker_emb)


class LatentsOutput(NamedTuple):
    latents: torch.Tensor  # (B, T_frames, flow_size)
    frame_mask: torch.Tensor  # (B, T_frames)
    total_duration: torch.Tensor  # (B,)
    log_duration: torch.Tensor  # (B, T_in, 1)
    speaker_embeddings: torch.Tensor | None


class VoiceConversionOutput(NamedTuple):
    waveform: torch.Tensor  # (B, F * total_upsample) in [-1, 1]
    latents: torch.Tensor  # (B, F, flow_size) target-speaker vocoder latents
    posterior_mean: torch.Tensor  # (B, F, flow_size) source posterior mean


Generators = torch.Generator | Sequence[torch.Generator]


def _blocked_randn(gen: torch.Generator, num_frames: int, channels: int,
                   device: torch.device) -> torch.Tensor:
    """(num_frames, channels) normals drawn in PRIOR_NOISE_BLOCK-frame blocks."""
    n_blocks = -(-num_frames // PRIOR_NOISE_BLOCK)
    blocks = [torch.randn((PRIOR_NOISE_BLOCK, channels), generator=gen, device=device)
              for _ in range(n_blocks)]
    return torch.cat(blocks)[:num_frames]


def draw_noise(generator: Generators, batch: int, t_in: int, num_frames: int,
               flow_size: int, device: torch.device) -> NoiseOverride:
    """Standard-normal draws from one generator (whole batch) or one per row."""
    if isinstance(generator, torch.Generator):
        return NoiseOverride(
            duration=torch.randn((batch, t_in, 2), generator=generator, device=device),
            prior=torch.randn((batch, num_frames, flow_size), generator=generator,
                              device=device),
        )
    if len(generator) != batch:
        raise ValueError(f"{len(generator)} generators for {batch} rows")
    durations, priors = [], []
    for gen in generator:
        durations.append(torch.randn((t_in, 2), generator=gen, device=device))
        priors.append(_blocked_randn(gen, num_frames, flow_size, device))
    return NoiseOverride(duration=torch.stack(durations), prior=torch.stack(priors))


def align_durations(
    duration: torch.Tensor,  # (B, T_in) float, integral values, 0 at padded tokens
    input_mask: torch.Tensor,  # (B, T_in)
    num_frames: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Duration -> one-hot alignment (B, num_frames, T_in) plus frame mask.

    attn[b, f, t] = 1 iff cum_dur[t-1] <= f < cum_dur[t].
    """
    cum_duration = torch.cumsum(duration, dim=-1)
    frames = torch.arange(num_frames, dtype=duration.dtype, device=duration.device)
    valid = (frames[None, :, None] < cum_duration[:, None, :]).to(duration.dtype)
    prev = torch.nn.functional.pad(valid, (1, 0))[:, :, :-1]
    attn = (valid - prev) * input_mask[:, None, :]
    total = torch.clamp(cum_duration[:, -1], max=float(num_frames))
    frame_mask = (frames[None, :] < total[:, None]).to(duration.dtype)
    return attn * frame_mask[:, :, None], frame_mask


def text_to_prior(
    params: dict,
    config: VitsConfig,
    input_ids: torch.Tensor,  # (B, T_in) int
    input_mask: torch.Tensor,  # (B, T_in) float32, 1=token 0=pad (a prefix mask)
    num_frames: int,
    generator: Generators | None = None,
    noise: NoiseOverride | None = None,
    speaker_id: torch.Tensor | None = None,  # (B,) int
    noise_scale: float | None = None,
    noise_scale_duration: float | None = None,
    speaking_rate: float | None = None,
) -> PriorOutput:
    """Text -> sampled prior latents (encoder, SDP, alignment, prior draw)."""
    p = ParamView(params)
    noise_scale = config.noise_scale if noise_scale is None else noise_scale
    if noise_scale_duration is None:
        noise_scale_duration = config.noise_scale_duration
    speaking_rate = config.speaking_rate if speaking_rate is None else speaking_rate

    batch, t_in = input_ids.shape
    padding_mask = input_mask[..., None]
    if noise is None:
        if generator is None:
            raise ValueError("provide either a generator or a NoiseOverride")
        noise = draw_noise(generator, batch, t_in, num_frames, config.flow_size,
                           input_mask.device)

    speaker_embeddings = embed_speaker(p, config, speaker_id)
    enc = text_encoder(p, config, input_ids, padding_mask)
    if config.use_stochastic_duration_prediction:
        log_duration = stochastic_duration_predictor_reverse(
            p, config, enc.last_hidden_state, padding_mask, noise.duration,
            noise_scale_duration, speaker_embeddings)
    else:
        log_duration = duration_predictor(p, config, enc.last_hidden_state, padding_mask,
                                          speaker_embeddings)

    length_scale = 1.0 / speaking_rate
    duration = torch.ceil(torch.exp(log_duration) * padding_mask * length_scale)[..., 0]
    total_duration = torch.clamp(duration.sum(dim=-1), min=1.0)

    attn, frame_mask = align_durations(duration, input_mask, num_frames)
    prior_means = torch.bmm(attn, enc.prior_means)
    prior_log_variances = torch.bmm(attn, enc.prior_log_variances)
    prior_latents = prior_means + noise.prior * torch.exp(prior_log_variances) * noise_scale
    return PriorOutput(prior_latents, frame_mask, total_duration, log_duration,
                       speaker_embeddings)


def embed_speaker(p: ParamView, config: VitsConfig,
                  speaker_id: torch.Tensor | None) -> torch.Tensor | None:
    """(B,) speaker ids -> (B, 1, speaker_emb) embeddings; None for a one-speaker model."""
    if config.num_speakers <= 1 or speaker_id is None:
        return None
    return p["embed_speaker.weight"][speaker_id.long()][:, None, :]


def latents_from_prior(
    params: dict,
    config: VitsConfig,
    prior_latents: torch.Tensor,  # (B, F, flow_size)
    frame_mask3: torch.Tensor,  # (B, F, 1)
    speaker_embeddings: torch.Tensor | None = None,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Sampled prior -> flow latents (reverse residual-coupling stack).

    With ``use_pallas`` the stack runs as kernel 6 (:func:`fused_flow`).
    """
    p = ParamView(params)
    if use_pallas:
        lengths = frame_mask3[..., 0].sum(dim=1).to(torch.int32)
        latents = fused_flow(prior_latents.contiguous(), p, config, lengths=lengths,
                             speaker_embeddings=speaker_embeddings)
    else:
        latents = residual_coupling_block(p, config, prior_latents, frame_mask3,
                                          speaker_embeddings)
    return latents * frame_mask3


def text_to_latents(params: dict, config: VitsConfig, input_ids: torch.Tensor,
                    input_mask: torch.Tensor, num_frames: int, use_pallas: bool = False,
                    **prior_kwargs) -> LatentsOutput:
    """Text -> flow latents (prior stage + full-length flow)."""
    prior = text_to_prior(params, config, input_ids, input_mask, num_frames, **prior_kwargs)
    latents = latents_from_prior(params, config, prior.prior_latents,
                                 prior.frame_mask[..., None], prior.speaker_embeddings,
                                 use_pallas=use_pallas)
    return LatentsOutput(latents, prior.frame_mask, prior.total_duration, prior.log_duration,
                         prior.speaker_embeddings)


def synthesize(
    params: dict,
    config: VitsConfig,
    input_ids: torch.Tensor,
    input_mask: torch.Tensor,
    num_frames: int,
    generator: Generators | None = None,
    noise: NoiseOverride | None = None,
    speaker_id: torch.Tensor | None = None,  # (B,) int
    noise_scale: float | None = None,
    noise_scale_duration: float | None = None,
    speaking_rate: float | None = None,
    use_pallas_flow: bool = False,
) -> SynthesisOutput:
    """Full text -> waveform pipeline (latents stage + vocoder)."""
    lat = text_to_latents(
        params, config, input_ids, input_mask, num_frames, use_pallas=use_pallas_flow,
        generator=generator, noise=noise, speaker_id=speaker_id, noise_scale=noise_scale,
        noise_scale_duration=noise_scale_duration, speaking_rate=speaking_rate,
    )
    waveform = hifigan(ParamView(params), config, lat.latents, lat.frame_mask[..., None],
                       lat.speaker_embeddings)
    frame_lengths = torch.clamp(lat.total_duration, max=float(num_frames)).to(torch.int32)
    return SynthesisOutput(
        waveform=waveform,
        lengths=frame_lengths * config.total_upsample,
        frame_lengths=torch.clamp(lat.total_duration, max=2_147_483_000.0).to(torch.int32),
        latents=lat.latents,
        log_duration=lat.log_duration,
    )


def voice_convert(
    params: dict,
    config: VitsConfig,
    spectrogram: torch.Tensor,  # (B, F, spectrogram_bins) linear |STFT| of the source
    frame_mask: torch.Tensor,  # (B, F) 1 = real frame, 0 = pad
    source_speaker_id: torch.Tensor | None = None,  # (B,) int
    target_speaker_id: torch.Tensor | None = None,  # (B,) int
    generator: Generators | None = None,
    noise: torch.Tensor | None = None,  # (B, F, flow_size) standard normal
    noise_scale: float = 1.0,
) -> VoiceConversionOutput:
    """Source audio's spectrogram -> the same speech in the target speaker's voice.

    The posterior encoder reads the spectrogram under the source speaker, the
    flow runs forward (audio latents -> the speaker-independent prior space)
    and back under the target speaker, and the vocoder speaks with the target
    embedding. The reverse flow is the plain one, as in the JAX package. With
    no ``noise`` and no ``generator`` (or ``noise_scale=0``) the posterior
    mean is converted: deterministic. A per-row generator draws its row's
    noise in blocks of :data:`PRIOR_NOISE_BLOCK` frames.
    """
    p = ParamView(params)
    frame_mask3 = frame_mask[..., None]
    g_src = embed_speaker(p, config, source_speaker_id)
    g_tgt = embed_speaker(p, config, target_speaker_id)
    if noise is None:
        B, F = spectrogram.shape[:2]
        device = spectrogram.device
        if generator is None:
            noise = spectrogram.new_zeros((B, F, config.flow_size))
        elif isinstance(generator, torch.Generator):
            noise = torch.randn((B, F, config.flow_size), generator=generator, device=device)
        else:
            if len(generator) != B:
                raise ValueError(f"{len(generator)} generators for {B} rows")
            noise = torch.stack([_blocked_randn(g, F, config.flow_size, device)
                                 for g in generator])
    z, post_mean, _ = posterior_encoder(p, config, spectrogram, frame_mask3,
                                        noise * noise_scale, g_src)
    z_p, _ = residual_coupling_forward(p, config, z, frame_mask3, g_src)
    latents = latents_from_prior(params, config, z_p, frame_mask3, g_tgt)
    waveform = hifigan(p, config, latents, frame_mask3, g_tgt)
    return VoiceConversionOutput(waveform, latents, post_mean)
