"""VITS training steps: the generator objective and the adversarial step.

Counterpart of ``vits_tpu/train/step.py``::

    text --encoder--> prior stats        spec --posterior--> z, (m_q, logs_q)
    z --flow(fwd)--> z_p
    MAS(log N(z_p; prior)) --> alignment --> durations + aligned prior
    losses: KL + SDP duration NLL + 45 * mel-L1 on a random decoded segment
    (+ LSGAN adversarial and feature-matching terms in the GAN step)

Parameters are the flat dicts of leaf tensors (JAX names and layouts) the
rest of the port reads through ``ParamView``; training marks them
``requires_grad`` and a step writes each one's ``.grad`` before calling its
optimizer's ``step()`` (``train/schedule.py``, or any ``torch.optim``
optimizer over the same tensors).

Noise: ``jax.random`` and torch share no stream, so the three draws of a step
-- posterior noise, duration noise and the segment uniforms -- are a
:class:`TrainNoise`, drawn from an explicit ``torch.Generator`` or handed in
(the parity tests rebuild the JAX package's own draws).

On CUDA the encoder's attention runs kernels A (with lse) and 4 from 512
tokens up, and the vocoder's wide stages kernel 5; everything else is plain
PyTorch. The inference kernels B and C are never reached under autograd.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import numpy as np
import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.models.discriminator import discriminate
from vits_tpu_torch.models.duration import stochastic_duration_predictor_nll
from vits_tpu_torch.models.encoder import text_encoder
from vits_tpu_torch.models.flow import residual_coupling_forward
from vits_tpu_torch.models.hifigan import hifigan
from vits_tpu_torch.models.posterior import posterior_encoder
from vits_tpu_torch.ops.align import monotonic_align, prior_log_likelihood
from vits_tpu_torch.train.losses import (
    discriminator_loss,
    feature_matching_loss,
    generator_adversarial_loss,
    kl_divergence,
    random_segment_starts,
    slice_segments,
)
from vits_tpu_torch.utils.mel import log_mel_spectrogram


class TrainBatch(NamedTuple):
    """One padded batch. S = spectrogram frames, T = tokens."""

    input_ids: torch.Tensor  # (B, T) int
    token_mask: torch.Tensor  # (B, T) float
    spectrogram: torch.Tensor  # (B, S, spectrogram_bins) linear spec of the target audio
    frame_mask: torch.Tensor  # (B, S) float
    audio: torch.Tensor  # (B, S * total_upsample) float target waveform
    speaker_id: Optional[torch.Tensor] = None  # (B,) int


class TrainNoise(NamedTuple):
    """A step's random draws."""

    posterior: torch.Tensor  # (B, S, flow_size) standard normal
    duration: torch.Tensor  # (B, T, 2) standard normal
    segment_u: torch.Tensor  # (B,) uniform [0, 1): segment start = u * (max_start + 1)


class TrainMetrics(NamedTuple):
    loss: torch.Tensor
    kl: torch.Tensor
    duration: torch.Tensor
    mel: torch.Tensor


class GanTrainMetrics(NamedTuple):
    gen_loss: torch.Tensor
    disc_loss: torch.Tensor
    kl: torch.Tensor
    duration: torch.Tensor
    mel: torch.Tensor
    adversarial: torch.Tensor
    feature_matching: torch.Tensor


class GeneratorOutput(NamedTuple):
    loss: torch.Tensor  # reconstruction loss: KL + duration NLL + mel_weight * mel-L1
    metrics: TrainMetrics
    wave_fake: torch.Tensor  # (B, segment_frames * total_upsample) decoded segment
    wave_real: torch.Tensor  # (B, segment_frames * total_upsample) the target's segment
    durations: torch.Tensor  # (B, T) MAS durations (frames per token)


def batch_to(batch, device) -> TrainBatch:
    """A TrainBatch of numpy arrays or tensors -> tensors on ``device`` (ids int64)."""
    def conv(x, dtype):
        return None if x is None else torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                                                      else x, dtype=dtype, device=device)
    return TrainBatch(conv(batch.input_ids, torch.int64), conv(batch.token_mask, torch.float32),
                      conv(batch.spectrogram, torch.float32),
                      conv(batch.frame_mask, torch.float32), conv(batch.audio, torch.float32),
                      conv(batch.speaker_id, torch.int64))


def draw_noise(config: VitsConfig, batch: TrainBatch,
               generator: Optional[torch.Generator] = None) -> TrainNoise:
    """The step's draws from ``generator`` (on the batch's device), in JAX's order."""
    B, S, _ = batch.spectrogram.shape
    device = batch.spectrogram.device
    return TrainNoise(
        torch.randn((B, S, config.flow_size), generator=generator, device=device),
        torch.randn((B, batch.input_ids.shape[1], 2), generator=generator, device=device),
        torch.rand((B,), generator=generator, device=device),
    )


def fp32_backends(*param_dicts: Mapping[str, torch.Tensor]) -> None:
    """No TF32 for cuDNN convs and cuBLAS matmuls when training on a CUDA device:
    MAS and the duration NLL are fp32 semantics (as the serving engine's)."""
    if any(p.is_cuda for params in param_dicts for p in params.values()):
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


def _check_compute_dtype(compute_dtype) -> None:
    if compute_dtype not in (None, "float32", torch.float32):
        raise NotImplementedError(
            f"compute_dtype={compute_dtype!r}: the port trains in fp32 only (precision "
            "tiers are queued, ROADMAP.md)")


def generator_forward(
    params: Mapping[str, torch.Tensor],
    config: VitsConfig,
    batch: TrainBatch,
    noise: TrainNoise,
    segment_frames: int = 32,
    mel_weight: float = 45.0,
    mel_kwargs: Optional[dict] = None,
    compute_dtype=None,
) -> GeneratorOutput:
    """Forward pass with the reconstruction losses (``vits_tpu`` ``generator_forward``)."""
    _check_compute_dtype(compute_dtype)
    if config.num_speakers > 1 and batch.speaker_id is not None:
        raise NotImplementedError("speaker-conditioned training is not ported yet")
    mel_kwargs = dict(mel_kwargs or {})
    mel_kwargs.setdefault("sample_rate", config.sampling_rate)
    p = ParamView(params)
    token_mask3 = batch.token_mask[..., None]
    frame_mask3 = batch.frame_mask[..., None]
    B, S, _ = batch.spectrogram.shape

    # posterior + flow forward
    z, _, logs_q = posterior_encoder(p, config, batch.spectrogram, frame_mask3, noise.posterior)
    z_p, _ = residual_coupling_forward(p, config, z, frame_mask3)

    # text prior + MAS alignment (a constant target: no gradient)
    enc = text_encoder(p, config, batch.input_ids, token_mask3, trainable=True)
    log_lik = prior_log_likelihood(z_p, enc.prior_means, enc.prior_log_variances)
    attn = monotonic_align(log_lik.detach(), batch.frame_mask, batch.token_mask)
    durations = attn.sum(dim=1)
    m_p = torch.einsum("bst,btc->bsc", attn, enc.prior_means)
    logs_p = torch.einsum("bst,btc->bsc", attn, enc.prior_log_variances)
    loss_kl = kl_divergence(z_p, logs_q, m_p, logs_p, batch.frame_mask)

    # duration NLL on the stop-grad encoder output
    dur_nll = stochastic_duration_predictor_nll(
        p, config, enc.last_hidden_state.detach(), token_mask3, durations[..., None],
        noise.duration)
    loss_dur = dur_nll.sum() / torch.clamp(batch.token_mask.sum(), min=1.0)

    # mel reconstruction on a random decoded segment
    frame_lengths = batch.frame_mask.sum(dim=-1).to(torch.int32)
    starts = random_segment_starts(noise.segment_u, frame_lengths, segment_frames)
    wave_fake = hifigan(p, config, slice_segments(z, starts, segment_frames), trainable=True)
    up = config.total_upsample
    wave_real = slice_segments(batch.audio.reshape(B, S, up), starts,
                               segment_frames).reshape(B, segment_frames * up)
    loss_mel = torch.mean(torch.abs(log_mel_spectrogram(wave_fake, **mel_kwargs)
                                    - log_mel_spectrogram(wave_real, **mel_kwargs)))

    total = loss_kl + loss_dur + mel_weight * loss_mel
    metrics = TrainMetrics(loss=total, kl=loss_kl, duration=loss_dur, mel=loss_mel)
    return GeneratorOutput(total, metrics, wave_fake, wave_real, durations)


def generator_loss(params, config, batch, noise, segment_frames=32, mel_weight=45.0,
                   mel_kwargs=None, compute_dtype=None):
    """(total reconstruction loss, TrainMetrics)."""
    out = generator_forward(params, config, batch, noise, segment_frames, mel_weight,
                            mel_kwargs, compute_dtype)
    return out.loss, out.metrics


def gradients(loss: torch.Tensor, params: Mapping[str, torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d each parameter, zeros for one the loss does not reach (as ``jax.grad``)."""
    leaves = list(params.values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _apply(params: Mapping[str, torch.Tensor], optimizer, grads) -> None:
    for p, g in zip(params.values(), grads):
        p.grad = g
    optimizer.step()


def _microbatches(batch: TrainBatch, noise: TrainNoise, n: int):
    B = batch.input_ids.shape[0]
    if B % n:
        raise ValueError(f"batch size {B} not divisible by grad_accum={n}")
    m = B // n

    def rows(t, i):
        return None if t is None else t[i * m:(i + 1) * m]
    return [(TrainBatch(*(rows(t, i) for t in batch)), TrainNoise(*(rows(t, i) for t in noise)))
            for i in range(n)]


def _mean_metrics(cls, items):
    return cls(*(torch.stack([torch.as_tensor(x) for x in xs]).mean() for xs in zip(*items)))


def make_train_step(
    config: VitsConfig,
    params: Mapping[str, torch.Tensor],
    optimizer,
    segment_frames: int = 32,
    mel_weight: float = 45.0,
    mel_kwargs: Optional[dict] = None,
    grad_accum: int = 1,
    compute_dtype=None,
) -> Callable[..., TrainMetrics]:
    """Generator-only step ``step(batch, generator=None, noise=None) -> TrainMetrics``.

    Updates ``params`` in place through ``optimizer``. ``grad_accum=N`` splits
    the batch into N microbatches and averages their gradients before one
    update; the step's noise is drawn for the whole batch and split with it.
    Turns TF32 off when the parameters lie on a CUDA device.
    """
    _check_compute_dtype(compute_dtype)
    fp32_backends(params)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(batch: TrainBatch, generator=None, noise: Optional[TrainNoise] = None):
        noise = draw_noise(config, batch, generator) if noise is None else noise
        acc, all_metrics = None, []
        for mb, mn in _microbatches(batch, noise, grad_accum):
            loss, metrics = generator_loss(params, config, mb, mn, segment_frames, mel_weight,
                                           mel_kwargs)
            grads = gradients(loss, params)
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            all_metrics.append(tuple(m.detach() for m in metrics))
        _apply(params, optimizer, [a / grad_accum for a in acc] if grad_accum > 1 else acc)
        return _mean_metrics(TrainMetrics, all_metrics)

    return step


def make_gan_train_step(
    config: VitsConfig,
    gen_params: Mapping[str, torch.Tensor],
    disc_params: Mapping[str, torch.Tensor],
    gen_optimizer,
    disc_optimizer,
    segment_frames: int = 32,
    mel_weight: float = 45.0,
    fm_weight: float = 2.0,
    mel_kwargs: Optional[dict] = None,
    grad_accum: int = 1,
    compute_dtype=None,
) -> Callable[..., GanTrainMetrics]:
    """Adversarial step ``step(batch, generator=None, noise=None) -> GanTrainMetrics``.

    The JAX package's order: one generator forward; the discriminator updated
    on (real, detached fake); the adversarial and feature-matching terms
    through the UPDATED discriminator on the same fake; one backward into the
    generator only, and its update. With ``grad_accum=N`` each phase runs
    over N microbatches (discriminator gradients accumulated and applied,
    then generator gradients through the updated discriminator), the
    generator forward repeated per phase with the same noise. Turns TF32 off
    when the parameters lie on a CUDA device.
    """
    _check_compute_dtype(compute_dtype)
    fp32_backends(gen_params, disc_params)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def forward(batch, noise):
        return generator_forward(gen_params, config, batch, noise, segment_frames, mel_weight,
                                 mel_kwargs)

    def d_loss_of(wave_real, wave_fake):
        real_logits, _ = discriminate(disc_params, wave_real)
        fake_logits, _ = discriminate(disc_params, wave_fake.detach())
        return discriminator_loss(real_logits, fake_logits)

    def g_loss_of(out: GeneratorOutput):
        with torch.no_grad():
            _, real_feats = discriminate(disc_params, out.wave_real)
        fake_logits, fake_feats = discriminate(disc_params, out.wave_fake)
        adv = generator_adversarial_loss(fake_logits)
        fm = feature_matching_loss(real_feats, fake_feats)
        return out.loss + adv + fm_weight * fm, adv, fm

    def metrics_of(g_loss, d_loss, out, adv, fm):
        m = out.metrics
        return tuple(t.detach() for t in (g_loss, d_loss, m.kl, m.duration, m.mel, adv, fm))

    def step(batch: TrainBatch, generator=None, noise: Optional[TrainNoise] = None):
        noise = draw_noise(config, batch, generator) if noise is None else noise
        if grad_accum == 1:
            out = forward(batch, noise)
            d_loss = d_loss_of(out.wave_real, out.wave_fake)
            _apply(disc_params, disc_optimizer, gradients(d_loss, disc_params))
            g_loss, adv, fm = g_loss_of(out)
            _apply(gen_params, gen_optimizer, gradients(g_loss, gen_params))
            return GanTrainMetrics(*metrics_of(g_loss, d_loss, out, adv, fm))

        micro = _microbatches(batch, noise, grad_accum)
        d_acc, d_losses = None, []
        for mb, mn in micro:
            with torch.no_grad():
                out = forward(mb, mn)
            d_loss = d_loss_of(out.wave_real, out.wave_fake)
            grads = gradients(d_loss, disc_params)
            d_acc = grads if d_acc is None else [a + g for a, g in zip(d_acc, grads)]
            d_losses.append(d_loss.detach())
        _apply(disc_params, disc_optimizer, [a / grad_accum for a in d_acc])
        g_acc, items = None, []
        for (mb, mn), d_loss in zip(micro, d_losses):
            out = forward(mb, mn)
            g_loss, adv, fm = g_loss_of(out)
            grads = gradients(g_loss, gen_params)
            g_acc = grads if g_acc is None else [a + g for a, g in zip(g_acc, grads)]
            items.append(metrics_of(g_loss, d_loss, out, adv, fm))
        _apply(gen_params, gen_optimizer, [a / grad_accum for a in g_acc])
        return _mean_metrics(GanTrainMetrics, items)

    return step
