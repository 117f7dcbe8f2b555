"""VITS training losses and segment slicing.

Counterpart of ``vits_tpu/train/losses.py``: KL(posterior || aligned prior),
LSGAN generator and discriminator losses, feature matching (real features
stop-grad), and the random decoded-segment slice.
"""

from __future__ import annotations

from typing import Sequence

import torch


def kl_divergence(
    z_p: torch.Tensor,  # (B, S, C) flow-forward posterior sample
    logs_q: torch.Tensor,  # (B, S, C) posterior log-stddev
    m_p: torch.Tensor,  # (B, S, C) aligned prior means
    logs_p: torch.Tensor,  # (B, S, C) aligned prior log-stddev
    frame_mask: torch.Tensor,  # (B, S)
    mask_sum: torch.Tensor | None = None,  # () the normalizer's mask sum (None: frame_mask's)
) -> torch.Tensor:
    """Masked mean KL (the VITS formulation on flow-mapped samples), in fp32 (the
    inputs are read as fp32: a no-op in fp32 training). ``mask_sum``: the global
    batch's frame count, when these rows are a rank's part of it."""
    z_p, logs_q, m_p, logs_p = z_p.float(), logs_q.float(), m_p.float(), logs_p.float()
    mask = frame_mask.float()[..., None]
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * (torch.exp(2.0 * logs_q) + (z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    channels = z_p.shape[-1]
    if mask_sum is None:
        mask_sum = torch.sum(mask)
    return torch.sum(kl * mask) / torch.clamp(mask_sum * channels, min=1.0) * channels


def feature_matching_loss(real_feats: Sequence, fake_feats: Sequence) -> torch.Tensor:
    """Mean L1 distance between discriminator feature maps, real side stop-grad;
    the maps read as fp32."""
    total, count = 0.0, 0
    for rf, ff in zip(real_feats, fake_feats):
        for r, f in zip(rf, ff):
            total = total + torch.mean(torch.abs(r.detach().float() - f.float()))
            count += 1
    return total / max(count, 1)


def generator_adversarial_loss(fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN generator loss: mean (1 - D(fake))^2 over all discriminators."""
    total = sum(torch.mean((1.0 - logits.float()) ** 2) for logits in fake_logits)
    return total / max(len(fake_logits), 1)


def discriminator_loss(real_logits: Sequence[torch.Tensor],
                       fake_logits: Sequence[torch.Tensor]) -> torch.Tensor:
    """LSGAN discriminator loss."""
    total = sum(torch.mean((1.0 - r.float()) ** 2) + torch.mean(f.float() ** 2)
                for r, f in zip(real_logits, fake_logits))
    return total / max(len(real_logits), 1)


def slice_segments(x: torch.Tensor, starts: torch.Tensor, segment_size: int) -> torch.Tensor:
    """Per-row slice of ``segment_size`` frames of a (B, S, ...) tensor (VITS rand_slice).

    Starts are clamped to ``[0, S - segment_size]`` as ``dynamic_slice`` clamps them.
    """
    S = x.shape[1]
    starts = torch.clamp(starts.to(torch.int64), 0, max(S - segment_size, 0))
    idx = starts[:, None] + torch.arange(segment_size, device=x.device)[None, :]
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def random_segment_starts(u: torch.Tensor, frame_lengths: torch.Tensor,
                          segment_size: int) -> torch.Tensor:
    """Start frames from uniforms ``u`` (B,) such that the segment stays inside each row."""
    max_start = torch.clamp(frame_lengths - segment_size, min=0)
    return (u * (max_start + 1)).to(torch.int32)
