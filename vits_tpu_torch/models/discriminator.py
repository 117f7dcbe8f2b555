"""HiFiGAN-style discriminators for adversarial VITS training.

Counterpart of ``vits_tpu/models/discriminator.py``: multi-period
discriminators (periods 2/3/5/7/11; the audio reflect-padded to a multiple of
the period and folded to 2-D) plus one multi-scale discriminator on the raw
waveform (grouped, strided conv1d). Parameters keep the JAX layouts -- conv2d
``(kh, kw, in, out)`` (HWIO), conv1d ``(k, in/groups, out)`` -- and
:func:`init_discriminator_params` makes the JAX package's numpy draws, so a
seed gives the same parameters in both packages. Feature maps come back in
the JAX layouts (NHWC for the period discriminators, NTC for the scale one).
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from vits_tpu_torch.ops.conv import conv1d, leaky_relu

PERIODS = (2, 3, 5, 7, 11)
_SLOPE = 0.1

# (out_channels, kernel, stride) for the period discriminators' conv ladder.
_MPD_LADDER = ((32, 5, 3), (128, 5, 3), (512, 5, 3), (1024, 5, 3), (1024, 5, 1))
# (out_channels, kernel, stride, groups) for the scale discriminator.
_MSD_LADDER = (
    (16, 15, 1, 1),
    (64, 41, 4, 4),
    (256, 41, 4, 16),
    (1024, 41, 4, 64),
    (1024, 41, 4, 256),
    (1024, 5, 1, 1),
)


def _kaiming(rng: np.random.Generator, shape, fan_in):
    std = math.sqrt(2.0 / fan_in)
    return (rng.standard_normal(shape) * std).astype(np.float32)


def init_discriminator_params(seed: int = 0) -> dict[str, np.ndarray]:
    """Flat numpy params, the JAX package's draws in its order and layouts."""
    rng = np.random.default_rng(seed)
    params: dict[str, np.ndarray] = {}
    for p_idx, _period in enumerate(PERIODS):
        in_ch = 1
        for i, (out_ch, k, _s) in enumerate(_MPD_LADDER):
            name = f"discriminator.mpd.{p_idx}.convs.{i}"
            params[f"{name}.weight"] = _kaiming(rng, (k, 1, in_ch, out_ch), k * in_ch)
            params[f"{name}.bias"] = np.zeros(out_ch, np.float32)
            in_ch = out_ch
        name = f"discriminator.mpd.{p_idx}.conv_post"
        params[f"{name}.weight"] = _kaiming(rng, (3, 1, in_ch, 1), 3 * in_ch)
        params[f"{name}.bias"] = np.zeros(1, np.float32)
    in_ch = 1
    for i, (out_ch, k, _s, g) in enumerate(_MSD_LADDER):
        name = f"discriminator.msd.convs.{i}"
        params[f"{name}.weight"] = _kaiming(rng, (k, in_ch // g, out_ch), k * in_ch // g)
        params[f"{name}.bias"] = np.zeros(out_ch, np.float32)
        in_ch = out_ch
    params["discriminator.msd.conv_post.weight"] = _kaiming(rng, (3, in_ch, 1), 3 * in_ch)
    params["discriminator.msd.conv_post.bias"] = np.zeros(1, np.float32)
    return params


def _conv2d(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, stride: int,
            padding: int) -> torch.Tensor:
    """NCHW conv over H with an HWIO (k, 1, in, out) kernel."""
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, stride=(stride, 1),
                    padding=(padding, 0))


def _period_discriminator(params: Mapping[str, torch.Tensor], prefix: str,
                          audio: torch.Tensor, period: int):
    """audio (B, T) -> (logits (B, n), NHWC feature maps). Folds T into (T/period, period)."""
    B, T = audio.shape
    pad = (-T) % period
    if pad:  # reflect-pad like HiFiGAN's DiscriminatorP
        audio = F.pad(audio[:, None], (0, pad), mode="reflect")[:, 0]
    x = audio.reshape(B, 1, -1, period)  # NCHW
    feats = []
    for i, (_out, k, s) in enumerate(_MPD_LADDER):
        name = f"{prefix}.convs.{i}"
        x = leaky_relu(_conv2d(x, params[f"{name}.weight"], params[f"{name}.bias"], s,
                               (k - 1) // 2), _SLOPE)
        feats.append(x.permute(0, 2, 3, 1))
    x = _conv2d(x, params[f"{prefix}.conv_post.weight"], params[f"{prefix}.conv_post.bias"],
                1, 1)
    feats.append(x.permute(0, 2, 3, 1))
    return x.reshape(B, -1), feats


def _scale_discriminator(params: Mapping[str, torch.Tensor], prefix: str, audio: torch.Tensor):
    x = audio[..., None]  # (B, T, 1)
    feats = []
    for i, (_out, k, s, g) in enumerate(_MSD_LADDER):
        name = f"{prefix}.convs.{i}"
        x = leaky_relu(conv1d(x, params[f"{name}.weight"], params[f"{name}.bias"],
                              stride=s, padding=(k - 1) // 2, groups=g), _SLOPE)
        feats.append(x)
    x = conv1d(x, params[f"{prefix}.conv_post.weight"], params[f"{prefix}.conv_post.bias"],
               padding=1)
    feats.append(x)
    return x.reshape(audio.shape[0], -1), feats


def discriminate(params: Mapping[str, torch.Tensor], audio: torch.Tensor):
    """audio (B, T) -> (list of logits, list of per-discriminator feature lists)."""
    logits, feats = [], []
    for p_idx, period in enumerate(PERIODS):
        lg, ft = _period_discriminator(params, f"discriminator.mpd.{p_idx}", audio, period)
        logits.append(lg)
        feats.append(ft)
    lg, ft = _scale_discriminator(params, "discriminator.msd", audio)
    logits.append(lg)
    feats.append(ft)
    return logits, feats
