"""WaveNet stack and residual-coupling flow, both directions.

Counterpart of ``vits_tpu/models/flow.py``. Plain PyTorch: the JAX package
leaves this to XLA by default; its fused flow kernel is opt-in
(``use_pallas_flow``) and ported as ``ops/cuda/flow.py`` (kernel 6). The
reverse direction samples; the forward direction
(:func:`residual_coupling_forward`) maps posterior latents to the prior space
in training and voice conversion. ``global_conditioning`` is the speaker
embedding (B, 1, speaker_emb): each WaveNet's ``cond_layer`` 1x1-convs it to
(B, 1, 2*hidden*num_layers) and layer l adds slice [l*2h, (l+1)*2h) before the
gate.
"""

from __future__ import annotations

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.ops.conv import conv1d, sigmoid


def wavenet(
    p: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, hidden)
    padding_mask: torch.Tensor,  # (B, T, 1)
    num_layers: int,
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    hidden = config.hidden_size
    outputs = torch.zeros_like(inputs)
    cond = None
    if global_conditioning is not None:
        cond = conv1d(global_conditioning, p["cond_layer.weight"], p["cond_layer.bias"])
    for i in range(num_layers):
        dilation = config.wavenet_dilation_rate**i
        in_act = conv1d(
            inputs,
            p[f"in_layers.{i}.weight"],
            p[f"in_layers.{i}.bias"],
            padding=(config.wavenet_kernel_size * dilation - dilation) // 2,
            dilation=dilation,
        )
        if cond is not None:
            in_act = in_act + cond[..., i * 2 * hidden:(i + 1) * 2 * hidden]
        acts = torch.tanh(in_act[..., :hidden]) * sigmoid(in_act[..., hidden:])
        res_skip = conv1d(acts, p[f"res_skip_layers.{i}.weight"],
                          p[f"res_skip_layers.{i}.bias"])
        if i < num_layers - 1:
            inputs = (inputs + res_skip[..., :hidden]) * padding_mask
            outputs = outputs + res_skip[..., hidden:]
        else:
            outputs = outputs + res_skip
    return outputs * padding_mask


def residual_coupling_layer(
    p: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, flow_size)
    padding_mask: torch.Tensor,
    global_conditioning: torch.Tensor | None = None,
    reverse: bool = True,
) -> torch.Tensor:
    """Mean-only coupling: second_half -/+= mean(first_half) (log-det 0)."""
    half = config.flow_size // 2
    first_half, second_half = inputs[..., :half], inputs[..., half:]
    h = conv1d(first_half, p["conv_pre.weight"], p["conv_pre.bias"]) * padding_mask
    h = wavenet(p.sub("wavenet"), config, h, padding_mask,
                config.prior_encoder_num_wavenet_layers, global_conditioning)
    mean = conv1d(h, p["conv_post.weight"], p["conv_post.bias"]) * padding_mask
    second_half = (second_half - mean if reverse else mean + second_half) * padding_mask
    return torch.cat([first_half, second_half], dim=-1)


def residual_coupling_block(
    params: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, flow_size)
    padding_mask: torch.Tensor,
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Prior latents -> vocoder latents: the couplings in reverse, flips between."""
    p = params.sub("flow")
    cur = inputs
    for i in range(config.prior_encoder_num_flows - 1, -1, -1):
        cur = torch.flip(cur, dims=(-1,))
        cur = residual_coupling_layer(p.sub(f"flows.{i}"), config, cur, padding_mask,
                                      global_conditioning)
    return cur


def residual_coupling_forward(
    params: ParamView,
    config: VitsConfig,
    inputs: torch.Tensor,  # (B, T, flow_size) posterior latents
    padding_mask: torch.Tensor,
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior latents -> prior space (the training direction): (z_p, log_det (B,)).

    Mean-only couplings have a zero log-determinant, returned for the JAX
    signature.
    """
    p = params.sub("flow")
    cur = inputs
    for i in range(config.prior_encoder_num_flows):
        cur = residual_coupling_layer(p.sub(f"flows.{i}"), config, cur, padding_mask,
                                      global_conditioning, reverse=False)
        cur = torch.flip(cur, dims=(-1,))
    return cur, inputs.new_zeros(inputs.shape[0])
