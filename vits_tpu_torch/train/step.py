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

Speakers: a batch with ``speaker_id`` on a multi-speaker model conditions the
posterior, the flow, the duration predictor and the vocoder on its rows of
``embed_speaker.weight``, which takes gradient through all four.

Mixed precision (``compute_dtype="bfloat16"``, the JAX package's semantics):
the text encoder and the decoder (:data:`BF16_SUBTREES`) and the
discriminator run in bf16 on casts of the fp32 master parameters made inside
the step, so every ``.grad`` stays fp32; the posterior, the flow and the
duration predictor stay fp32, and the loss anchors -- the prior likelihood
before MAS, the KL, the duration NLL, the frame lengths and the log-mel --
are fp32. The training kernels then run at ``ops/tiers.py::training_tiers``:
bf16 storage at the fast tier.

Data parallelism (``data_parallel=``, a ``parallel/mesh.py::DataParallel``):
every rank is handed the same global batch and draws (or is handed) the same
global noise, then keeps its rows of both (``rank_rows``). Its losses are its
part of the global batch's: the KL and the duration NLL divide its sums by the
global batch's mask sums (computed from the global batch on every rank, so
no collective), and the means (mel L1, discriminator, adversarial, feature
matching) are scaled by its share of the rows. The gradients are summed over
the ranks before each optimizer update, so the global-norm clip and the
update see the global batch's gradient, identical on every rank; the metrics
are summed too, so every rank returns the global values. With ``grad_accum``
each microbatch's normalizers are that microbatch's global sums, and a rank
holds its share of each microbatch (``microbatch_rows``): where the microbatch
does not divide over the ranks the shares differ by one row, and a rank that
holds none of it adds zero losses and gradients without running the model
(every rank still calls the same collectives, in the same order). JAX's
GSPMD step computes the whole batch's loss on a 'data' mesh; this is the same
function, summed in another order.

Tensor parallelism (``model_parallel=``, a ``parallel/tensor.py::
TensorParallel``; the generator's parameters are the rank's slices,
``parallel/mesh.py::shard_params``): the ranks of a model group compute one
batch's rows together, the split layers on their slices
(``parallel/tensor.py``), everything else whole on every rank; the tensors
split only at rest are gathered once a forward. The discriminator stays
replicated. With a model axis, ``data_parallel`` is the data axis of the
same world (``parallel/mesh.py::data_axis(model)``): the gradient and metric
sums run over its group, the ranks of one model index, never over the world
(that would add one rank's q-slice gradient to another's k-slice). With a
slice axis (``data_axis(model, slices=k)``) the rows split over slice x data,
slice-major, and each sum runs inside the slice, then in chunks across slices
(``parallel/mesh.py::data_all_reduce_``), JAX's psum over ('slice', 'data').
``generator_forward``'s ``encoder_fn`` replaces the text encoder (the
pipelined one, ``parallel/pipeline.py``).
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
from vits_tpu_torch.ops.tiers import training_tiers
from vits_tpu_torch.parallel.mesh import DataParallel, data_all_reduce_, microbatch_rows
from vits_tpu_torch.parallel.tensor import TensorParallel
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


class RowShare(NamedTuple):
    """A rank's part of one global (micro)batch under data parallelism."""

    frames: torch.Tensor  # () the global frame mask's sum: the KL's normalizer
    tokens: torch.Tensor  # () the global token mask's sum: the duration NLL's
    rows: float  # the rank's rows over the global rows: the weight of its mean losses


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


# The generator's parameters that run in the compute dtype: the encoder's and the
# decoder's, where its products are; the posterior encoder, the flow and the
# duration predictor stay fp32 (log-domain math, vits_tpu/train/step.py:85-97).
BF16_SUBTREES = ("text_encoder.", "decoder.")


def resolve_compute_dtype(compute_dtype) -> torch.dtype:
    """None, "float32" or torch.float32 -> fp32; "bfloat16" or torch.bfloat16 -> bf16."""
    if compute_dtype in (None, "float32", torch.float32):
        return torch.float32
    if compute_dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"compute_dtype={compute_dtype!r}: float32 or bfloat16")


def cast_generator_params(params: Mapping[str, torch.Tensor],
                          dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The :data:`BF16_SUBTREES` leaves cast to ``dtype`` (a differentiable cast of the
    master parameters), the others as they are."""
    return {k: v.to(dtype) if k.startswith(BF16_SUBTREES) and v.is_floating_point() else v
            for k, v in params.items()}


def generator_forward(
    params: Mapping[str, torch.Tensor],
    config: VitsConfig,
    batch: TrainBatch,
    noise: TrainNoise,
    segment_frames: int = 32,
    mel_weight: float = 45.0,
    mel_kwargs: Optional[dict] = None,
    compute_dtype=None,
    share: Optional[RowShare] = None,
    tp: Optional[TensorParallel] = None,
    encoder_fn: Optional[Callable] = None,
) -> GeneratorOutput:
    """Forward pass with the reconstruction losses (``vits_tpu`` ``generator_forward``).

    ``wave_fake`` comes back in the compute dtype, ``wave_real`` in fp32.
    ``share``: ``batch`` is a rank's rows of a global batch, and the losses are
    its part of the global batch's (module docstring). ``tp``: ``params`` are
    the rank's slices. ``encoder_fn(params, config, input_ids, padding_mask3)
    -> EncoderOutput`` replaces the text encoder."""
    cd = resolve_compute_dtype(compute_dtype)
    tiers = training_tiers(cd)
    if tp is not None:
        params = tp.gather(params)
    if cd != torch.float32:
        params = cast_generator_params(params, cd)
    mel_kwargs = dict(mel_kwargs or {})
    mel_kwargs.setdefault("sample_rate", config.sampling_rate)
    p = ParamView(params)
    token_mask3 = batch.token_mask[..., None]
    frame_mask3 = batch.frame_mask[..., None]
    B, S, _ = batch.spectrogram.shape

    speakers = None  # (B, 1, speaker_embedding_size), not detached: it trains in every module
    if config.num_speakers > 1 and batch.speaker_id is not None:
        speakers = p["embed_speaker.weight"][batch.speaker_id][:, None, :]

    # posterior + flow forward
    z, _, logs_q = posterior_encoder(p, config, batch.spectrogram, frame_mask3, noise.posterior,
                                     speakers, tp)
    z_p, _ = residual_coupling_forward(p, config, z, frame_mask3, speakers, tp)

    # text prior (bf16 masks with bf16 parameters) + MAS alignment (a constant
    # target: no gradient) on fp32 likelihoods
    if encoder_fn is None:
        enc = text_encoder(p, config, batch.input_ids, token_mask3.to(cd), trainable=True,
                           tier=tiers.attention, tp=tp)
    else:
        enc = encoder_fn(params, config, batch.input_ids, token_mask3.to(cd))
    log_lik = prior_log_likelihood(z_p, enc.prior_means, enc.prior_log_variances).float()
    attn = monotonic_align(log_lik.detach(), batch.frame_mask, batch.token_mask)
    durations = attn.sum(dim=1)
    m_p = torch.einsum("bst,btc->bsc", attn, enc.prior_means.float())
    logs_p = torch.einsum("bst,btc->bsc", attn, enc.prior_log_variances.float())
    loss_kl = kl_divergence(z_p, logs_q, m_p, logs_p, batch.frame_mask,
                            None if share is None else share.frames)

    # duration NLL (fp32) on the stop-grad encoder output
    dur_nll = stochastic_duration_predictor_nll(
        p, config, enc.last_hidden_state.detach().float(), token_mask3, durations[..., None],
        noise.duration, speakers)
    tokens = batch.token_mask.sum() if share is None else share.tokens
    loss_dur = dur_nll.sum() / torch.clamp(tokens, min=1.0)

    # mel reconstruction on a random decoded segment (frame lengths and log-mel in fp32)
    frame_lengths = batch.frame_mask.sum(dim=-1).to(torch.int32)
    starts = random_segment_starts(noise.segment_u, frame_lengths, segment_frames)
    wave_fake = hifigan(p, config, slice_segments(z, starts, segment_frames).to(cd), None,
                        None if speakers is None else speakers.to(cd), trainable=True,
                        tiers=tiers, tp=tp)
    up = config.total_upsample
    wave_real = slice_segments(batch.audio.reshape(B, S, up), starts,
                               segment_frames).reshape(B, segment_frames * up)
    loss_mel = torch.mean(torch.abs(log_mel_spectrogram(wave_fake.float(), **mel_kwargs)
                                    - log_mel_spectrogram(wave_real, **mel_kwargs)))
    if share is not None:
        loss_mel = loss_mel * share.rows

    total = loss_kl + loss_dur + mel_weight * loss_mel
    metrics = TrainMetrics(loss=total, kl=loss_kl, duration=loss_dur, mel=loss_mel)
    return GeneratorOutput(total, metrics, wave_fake, wave_real, durations)


def generator_loss(params, config, batch, noise, segment_frames=32, mel_weight=45.0,
                   mel_kwargs=None, compute_dtype=None, share=None, tp=None, encoder_fn=None):
    """(total reconstruction loss, TrainMetrics)."""
    out = generator_forward(params, config, batch, noise, segment_frames, mel_weight,
                            mel_kwargs, compute_dtype, share, tp, encoder_fn)
    return out.loss, out.metrics


def gradients(loss: torch.Tensor, params: Mapping[str, torch.Tensor]) -> list[torch.Tensor]:
    """d loss / d each parameter, zeros for one the loss does not reach (as ``jax.grad``)."""
    leaves = list(params.values())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def _apply(params: Mapping[str, torch.Tensor], optimizer, grads,
           data_parallel: Optional[DataParallel] = None) -> None:
    """Hand ``grads`` (summed over the data axis's ranks first) to ``optimizer``
    and step it."""
    if data_parallel is not None:
        data_all_reduce_(grads, data_parallel)
    for p, g in zip(params.values(), grads):
        p.grad = g
    optimizer.step()


def _microbatches(batch: TrainBatch, noise: TrainNoise, n: int,
                  data_parallel: Optional[DataParallel] = None):
    """[(batch rows, noise rows, RowShare or None)] of each of ``n`` microbatches:
    the whole microbatch's, or the rank's rows of it under ``data_parallel``."""
    B = batch.input_ids.shape[0]
    world, rank = (1, 0) if data_parallel is None else (data_parallel.world, data_parallel.rank)
    m = B // n
    out = []
    # raises where the rows do not divide by n or by the world
    for i, held in enumerate(microbatch_rows(B, world, rank, n)):
        # a view of microbatch i where this rank holds all of it
        mine = slice(i * m, (i + 1) * m) if world == 1 else torch.as_tensor(
            held, device=batch.input_ids.device)

        def rows(t):
            return None if t is None else t[mine]
        share = None if data_parallel is None else RowShare(
            batch.frame_mask[i * m:(i + 1) * m].sum(), batch.token_mask[i * m:(i + 1) * m].sum(),
            len(held) / m)
        out.append((TrainBatch(*map(rows, batch)), TrainNoise(*map(rows, noise)), share))
    return out


def _holds_none(batch: TrainBatch) -> bool:
    """A rank's part of a microbatch that it holds no row of."""
    return batch.input_ids.shape[0] == 0


def _zeros(params: Mapping[str, torch.Tensor]) -> list[torch.Tensor]:
    return [torch.zeros_like(p) for p in params.values()]


def _zero_metrics(n: int, batch: TrainBatch) -> tuple[torch.Tensor, ...]:
    return tuple(torch.zeros((), device=batch.input_ids.device) for _ in range(n))


def _mean_metrics(cls, items, data_parallel: Optional[DataParallel] = None):
    """The mean of each metric over the microbatches; under ``data_parallel`` summed
    over the ranks (each rank's is its part of the global value)."""
    values = torch.stack([torch.stack([torch.as_tensor(x) for x in xs]).mean()
                          for xs in zip(*items)])
    if data_parallel is not None:
        data_all_reduce_([values], data_parallel)
    return cls(*values.unbind())


def make_train_step(
    config: VitsConfig,
    params: Mapping[str, torch.Tensor],
    optimizer,
    segment_frames: int = 32,
    mel_weight: float = 45.0,
    mel_kwargs: Optional[dict] = None,
    grad_accum: int = 1,
    compute_dtype=None,
    data_parallel: Optional[DataParallel] = None,
    model_parallel: Optional[TensorParallel] = None,
    encoder_fn: Optional[Callable] = None,
) -> Callable[..., TrainMetrics]:
    """Generator-only step ``step(batch, generator=None, noise=None) -> TrainMetrics``.

    Updates ``params`` in place through ``optimizer``. ``grad_accum=N`` splits
    the batch into N microbatches and averages their gradients before one
    update; the step's noise is drawn for the whole batch and split with it.
    ``data_parallel``: ``batch`` is the global batch and this rank computes its
    rows; ``model_parallel``: ``params`` are the rank's slices (module
    docstring). ``encoder_fn``: :func:`generator_forward`'s. Turns TF32 off
    when the parameters lie on a CUDA device.
    """
    resolve_compute_dtype(compute_dtype)
    fp32_backends(params)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def step(batch: TrainBatch, generator=None, noise: Optional[TrainNoise] = None):
        noise = draw_noise(config, batch, generator) if noise is None else noise
        acc, all_metrics = None, []
        for mb, mn, share in _microbatches(batch, noise, grad_accum, data_parallel):
            if _holds_none(mb):
                grads, metrics = _zeros(params), _zero_metrics(len(TrainMetrics._fields), mb)
            else:
                loss, metrics = generator_loss(params, config, mb, mn, segment_frames,
                                               mel_weight, mel_kwargs, compute_dtype, share,
                                               model_parallel, encoder_fn)
                grads = gradients(loss, params)
            acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
            all_metrics.append(tuple(m.detach() for m in metrics))
        _apply(params, optimizer, [a / grad_accum for a in acc] if grad_accum > 1 else acc,
               data_parallel)
        return _mean_metrics(TrainMetrics, all_metrics, data_parallel)

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
    reuse_forward: bool = True,
    data_parallel: Optional[DataParallel] = None,
    model_parallel: Optional[TensorParallel] = None,
) -> Callable[..., GanTrainMetrics]:
    """Adversarial step ``step(batch, generator=None, noise=None) -> GanTrainMetrics``.

    The JAX package's order: one generator forward; the discriminator updated
    on (real, detached fake); the adversarial and feature-matching terms
    through the UPDATED discriminator on the same fake; one backward into the
    generator only, and its update. ``reuse_forward=False`` is the JAX
    package's two-forward step (``step_naive``): a forward without gradients
    for the discriminator's update, then a second one with the same noise for
    the generator's loss. With ``grad_accum=N`` each phase runs over N
    microbatches (discriminator gradients accumulated and applied, then
    generator gradients through the updated discriminator), the generator
    forward repeated per phase with the same noise. ``compute_dtype``: see
    the module docstring; the discriminator runs on bf16 casts of its fp32
    parameters, on bf16 waves. ``data_parallel``: ``batch`` is the global batch
    and this rank computes its rows (module docstring); the discriminator's
    gradients are summed over the ranks before its update, the generator's
    after the adversarial terms. ``model_parallel``: the generator's
    parameters are the rank's slices; the discriminator is replicated. Turns
    TF32 off when the parameters lie on a CUDA device.
    """
    cd = resolve_compute_dtype(compute_dtype)
    fp32_backends(gen_params, disc_params)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    dp = data_parallel

    def forward(batch, noise, share):
        return generator_forward(gen_params, config, batch, noise, segment_frames, mel_weight,
                                 mel_kwargs, cd, share, model_parallel)

    def weighted(loss, share):  # a mean loss: the rank's part of the global batch's
        return loss if share is None else loss * share.rows

    def disc():  # cast at each use: after the update the casts are of the updated weights
        return disc_params if cd == torch.float32 else {k: v.to(cd)
                                                        for k, v in disc_params.items()}

    def d_loss_of(wave_real, wave_fake, share):
        params = disc()
        real_logits, _ = discriminate(params, wave_real.to(cd))
        fake_logits, _ = discriminate(params, wave_fake.detach().to(cd))
        return weighted(discriminator_loss(real_logits, fake_logits), share)

    def g_loss_of(out: GeneratorOutput, share):
        params = disc()
        with torch.no_grad():
            _, real_feats = discriminate(params, out.wave_real.to(cd))
        fake_logits, fake_feats = discriminate(params, out.wave_fake.to(cd))
        adv = weighted(generator_adversarial_loss(fake_logits), share)
        fm = weighted(feature_matching_loss(real_feats, fake_feats), share)
        return out.loss + adv + fm_weight * fm, adv, fm

    def metrics_of(g_loss, d_loss, out, adv, fm):
        m = out.metrics
        return tuple(t.detach() for t in (g_loss, d_loss, m.kl, m.duration, m.mel, adv, fm))

    def step(batch: TrainBatch, generator=None, noise: Optional[TrainNoise] = None):
        noise = draw_noise(config, batch, generator) if noise is None else noise
        micro = _microbatches(batch, noise, grad_accum, dp)
        if grad_accum == 1 and reuse_forward:
            (mb, mn, share), = micro
            out = forward(mb, mn, share)
            d_loss = d_loss_of(out.wave_real, out.wave_fake, share)
            _apply(disc_params, disc_optimizer, gradients(d_loss, disc_params), dp)
            g_loss, adv, fm = g_loss_of(out, share)
            _apply(gen_params, gen_optimizer, gradients(g_loss, gen_params), dp)
            return _mean_metrics(GanTrainMetrics, [metrics_of(g_loss, d_loss, out, adv, fm)],
                                 dp)

        d_acc, d_losses = None, []
        for mb, mn, share in micro:
            if _holds_none(mb):  # no rows of this microbatch: a zero part, no forward
                grads, d_loss = _zeros(disc_params), _zero_metrics(1, mb)[0]
            else:
                with torch.no_grad():
                    out = forward(mb, mn, share)
                d_loss = d_loss_of(out.wave_real, out.wave_fake, share)
                grads = gradients(d_loss, disc_params)
            d_acc = grads if d_acc is None else [a + g for a, g in zip(d_acc, grads)]
            d_losses.append(d_loss.detach())
        _apply(disc_params, disc_optimizer, [a / grad_accum for a in d_acc], dp)
        g_acc, items = None, []
        for (mb, mn, share), d_loss in zip(micro, d_losses):
            if _holds_none(mb):
                grads, item = _zeros(gen_params), _zero_metrics(len(GanTrainMetrics._fields), mb)
            else:
                out = forward(mb, mn, share)
                g_loss, adv, fm = g_loss_of(out, share)
                grads = gradients(g_loss, gen_params)
                item = metrics_of(g_loss, d_loss, out, adv, fm)
            g_acc = grads if g_acc is None else [a + g for a, g in zip(g_acc, grads)]
            items.append(item)
        _apply(gen_params, gen_optimizer, [a / grad_accum for a in g_acc], dp)
        return _mean_metrics(GanTrainMetrics, items, dp)

    return step
