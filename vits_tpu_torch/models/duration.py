"""Duration predictors: stochastic (normalizing-flow, both directions) and
deterministic.

Counterpart of ``vits_tpu/models/duration.py``. Layout (batch, time,
channels); channel flips are along the last axis. The sampling direction
serves synthesis; the NLL (:func:`stochastic_duration_predictor_nll`) is the
training direction, with the flows' log-determinants. On bf16 inputs (bf16
serving) every step runs in bf16 as the JAX package's does; a Python constant
applied to a bf16 tensor is rounded to bf16 first, as JAX's weak types and
its explicit casts of the control scalars round it (``ops/conv.py::weak_scalar``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.ops.conv import conv1d, depthwise_conv1d, gelu, layer_norm, weak_scalar
from vits_tpu_torch.ops.spline import unconstrained_rational_quadratic_spline


def dilated_depth_separable_conv(
    p: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, C)
    padding_mask: torch.Tensor,  # (B, T, 1)
    global_conditioning: torch.Tensor | None = None,
) -> torch.Tensor:
    """Depthwise-dilated + pointwise conv stack with LayerNorm/GELU."""
    kernel_size = config.duration_predictor_kernel_size
    if global_conditioning is not None:
        inputs = inputs + global_conditioning
    for i in range(config.depth_separable_num_layers):
        dilation = kernel_size**i
        h = depthwise_conv1d(
            inputs * padding_mask,
            p[f"convs_dilated.{i}.weight"],
            p[f"convs_dilated.{i}.bias"],
            padding=(kernel_size * dilation - dilation) // 2,
            dilation=dilation,
        )
        h = gelu(layer_norm(h, p[f"norms_1.{i}.weight"], p[f"norms_1.{i}.bias"]))
        h = conv1d(h, p[f"convs_pointwise.{i}.weight"], p[f"convs_pointwise.{i}.bias"])
        h = gelu(layer_norm(h, p[f"norms_2.{i}.weight"], p[f"norms_2.{i}.bias"]))
        inputs = inputs + h
    return inputs * padding_mask


def conv_flow(
    p: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, depth_separable_channels)
    padding_mask: torch.Tensor,
    global_conditioning: torch.Tensor | None,
    reverse: bool = True,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Spline coupling flow: (outputs, log-determinant (B,) or None when reverse)."""
    half = config.depth_separable_channels // 2
    num_bins = config.duration_predictor_flow_bins
    first_half, second_half = inputs[..., :half], inputs[..., half:]

    h = conv1d(first_half, p["conv_pre.weight"], p["conv_pre.bias"])
    h = dilated_depth_separable_conv(p.sub("conv_dds"), config, h, padding_mask,
                                     global_conditioning)
    h = conv1d(h, p["conv_proj.weight"], p["conv_proj.bias"]) * padding_mask

    batch, length = first_half.shape[:2]
    # channel split order matches HF's reshape(B, half, 3nb-1, T) on channels-first data
    h = h.reshape(batch, length, half, num_bins * 3 - 1)
    scale = weak_scalar(1.0 / math.sqrt(config.hidden_size), h)
    second_half, log_abs_det = unconstrained_rational_quadratic_spline(
        second_half,
        h[..., :num_bins] * scale,
        h[..., num_bins : 2 * num_bins] * scale,
        h[..., 2 * num_bins :],
        reverse=reverse,
        tail_bound=config.duration_predictor_tail_bound,
    )
    outputs = torch.cat([first_half, second_half], dim=-1) * padding_mask
    if reverse:
        return outputs, None
    return outputs, torch.sum(log_abs_det * padding_mask, dim=(1, 2))


def elementwise_affine(p: ParamView, inputs: torch.Tensor, padding_mask: torch.Tensor,
                       reverse: bool = True) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Elementwise affine flow, params (C, 1): (outputs, log-det (B,) or None when reverse)."""
    translate, log_scale = p["translate"][:, 0], p["log_scale"][:, 0]
    if reverse:
        return (inputs - translate) * torch.exp(-log_scale) * padding_mask, None
    outputs = (translate + torch.exp(log_scale) * inputs) * padding_mask
    return outputs, torch.sum(log_scale * padding_mask, dim=(1, 2))


def _conditioned_pre(p: ParamView, config: VitsConfig, inputs: torch.Tensor,
                     padding_mask: torch.Tensor,
                     global_conditioning: torch.Tensor | None) -> torch.Tensor:
    """The SDP's shared trunk: conv_pre (+ speaker cond) -> DDS convs -> conv_proj."""
    h = conv1d(inputs, p["conv_pre.weight"], p["conv_pre.bias"])
    if global_conditioning is not None:
        h = h + conv1d(global_conditioning, p["cond.weight"], p["cond.bias"])
    h = dilated_depth_separable_conv(p.sub("conv_dds"), config, h, padding_mask)
    return conv1d(h, p["conv_proj.weight"], p["conv_proj.bias"]) * padding_mask


def stochastic_duration_predictor_reverse(
    params: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, hidden) encoder output
    padding_mask: torch.Tensor,  # (B, T, 1)
    noise: torch.Tensor,  # (B, T, 2) standard normal
    noise_scale: float,
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Sampling direction: noise -> log durations (B, T, 1).

    Runs the flows [EA (index 0), CF_1..CF_N] in reverse, skipping flow 1 as
    HF does ("remove a useless vflow").
    """
    p = params.sub("duration_predictor")
    h = _conditioned_pre(p, config, inputs, padding_mask, global_conditioning)

    latents = noise * weak_scalar(noise_scale, noise)
    for i in [i for i in range(config.duration_predictor_num_flows, -1, -1) if i != 1]:
        latents = torch.flip(latents, dims=(-1,))
        fp = p.sub(f"flows.{i}")
        if i == 0:
            latents, _ = elementwise_affine(fp, latents, padding_mask)
        else:
            latents, _ = conv_flow(fp, config, latents, padding_mask, h)
    return latents[..., :1]


def stochastic_duration_predictor_nll(
    params: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, hidden), the (stop-grad) encoder output
    padding_mask: torch.Tensor,  # (B, T, 1)
    durations: torch.Tensor,  # (B, T, 1) target durations
    posterior_noise: torch.Tensor,  # (B, T, 2) standard normal
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Training direction: negative log-likelihood of the target durations, (B,)."""
    p = params.sub("duration_predictor")
    h = _conditioned_pre(p, config, inputs, padding_mask, global_conditioning)

    hd = conv1d(durations, p["post_conv_pre.weight"], p["post_conv_pre.bias"])
    hd = dilated_depth_separable_conv(p.sub("post_conv_dds"), config, hd, padding_mask)
    hd = conv1d(hd, p["post_conv_proj.weight"], p["post_conv_proj.bias"]) * padding_mask

    def run_flows(prefix, latents, cond, log_det):
        for i in range(config.duration_predictor_num_flows + 1):
            fp = p.sub(f"{prefix}.{i}")
            if i == 0:
                latents, ld = elementwise_affine(fp, latents, padding_mask, reverse=False)
            else:
                latents, ld = conv_flow(fp, config, latents, padding_mask, cond, reverse=False)
            latents = torch.flip(latents, dims=(-1,))
            log_det = log_det + ld
        return latents, log_det

    random_posterior = posterior_noise * padding_mask
    latents_posterior, log_det_posterior = run_flows("post_flows", random_posterior, h + hd, 0.0)
    first_half, second_half = latents_posterior[..., :1], latents_posterior[..., 1:]
    log_det_posterior = log_det_posterior + torch.sum(
        (F.logsigmoid(first_half) + F.logsigmoid(-first_half)) * padding_mask, dim=(1, 2))
    logq = torch.sum(-0.5 * (math.log(2 * math.pi) + random_posterior**2) * padding_mask,
                     dim=(1, 2)) - log_det_posterior

    first_half = (durations - torch.sigmoid(first_half)) * padding_mask
    first_half = torch.log(torch.clamp(first_half, min=1e-5)) * padding_mask
    latents, log_det_sum = run_flows("flows", torch.cat([first_half, second_half], dim=-1), h,
                                     torch.sum(-first_half, dim=(1, 2)))
    nll = torch.sum(0.5 * (math.log(2 * math.pi) + latents**2) * padding_mask,
                    dim=(1, 2)) - log_det_sum
    return nll + logq


def duration_predictor(
    params: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, hidden)
    padding_mask: torch.Tensor,
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Deterministic VitsDurationPredictor (use_stochastic_duration_prediction=False)."""
    p = params.sub("duration_predictor")
    k = config.duration_predictor_kernel_size
    eps = config.layer_norm_eps
    if global_conditioning is not None:
        inputs = inputs + conv1d(global_conditioning, p["cond.weight"], p["cond.bias"])
    h = conv1d(inputs * padding_mask, p["conv_1.weight"], p["conv_1.bias"], padding=k // 2)
    h = layer_norm(torch.relu(h), p["norm_1.weight"], p["norm_1.bias"], eps)
    h = conv1d(h * padding_mask, p["conv_2.weight"], p["conv_2.bias"], padding=k // 2)
    h = layer_norm(torch.relu(h), p["norm_2.weight"], p["norm_2.bias"], eps)
    h = conv1d(h * padding_mask, p["proj.weight"], p["proj.bias"])
    return h * padding_mask
