"""Posterior encoder q(z | spectrogram), the training-only module.

Counterpart of ``vits_tpu/models/posterior.py``: 1x1 conv in, WaveNet,
1x1 conv to (mean, log_stddev), reparameterized sample. Plain PyTorch; under
``tp`` the WaveNet splits over the model group (``models/flow.py``).
"""

from __future__ import annotations

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.models.flow import wavenet
from vits_tpu_torch.ops.conv import conv1d


def posterior_encoder(
    params: ParamView,
    config: VitsConfig,
    spectrogram: torch.Tensor,  # (B, T, spectrogram_bins) linear spectrogram
    padding_mask: torch.Tensor,  # (B, T, 1)
    noise: torch.Tensor,  # (B, T, flow_size) standard normal
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
    tp=None,  # a parallel/tensor.py::TensorParallel (training)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (sampled_latents, mean, log_stddev), each (B, T, flow_size)."""
    p = params.sub("posterior_encoder")
    h = conv1d(spectrogram, p["conv_pre.weight"], p["conv_pre.bias"]) * padding_mask
    h = wavenet(p.sub("wavenet"), config, h, padding_mask,
                config.posterior_encoder_num_wavenet_layers, global_conditioning, tp)
    stats = conv1d(h, p["conv_proj.weight"], p["conv_proj.bias"]) * padding_mask
    mean, log_stddev = stats[..., : config.flow_size], stats[..., config.flow_size:]
    sampled = (mean + noise * torch.exp(log_stddev)) * padding_mask
    return sampled, mean, log_stddev
