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

Tensor parallel (``tp``, a ``parallel/tensor.py::TensorParallel``; training):
where ``in_layers.*`` hold the rank's share of each gate half, a WaveNet
layer computes those hidden units (tanh's and sigmoid's channels of the same
units, never one half alone) and their rows of ``res_skip``, one sum over the
model group a layer.
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
    tp=None,  # a parallel/tensor.py::TensorParallel (training)
) -> torch.Tensor:
    hidden = config.hidden_size
    outputs = torch.zeros_like(inputs)
    cond = None
    if global_conditioning is not None:
        cond = conv1d(global_conditioning, p["cond_layer.weight"], p["cond_layer.bias"])
    res_skip_w = [p[f"res_skip_layers.{i}.weight"] for i in range(num_layers)]
    units = p["in_layers.0.weight"].shape[2] // 2  # this rank's hidden units
    split = tp is not None and units != hidden
    if split:  # replicated, used on the rank's units: gradients summed over the group
        gate = tp.gate_channels(2 * hidden, inputs.device)
        rows = tp.channels(hidden)
        copied = tp.copy_in(*res_skip_w, *(() if cond is None else (cond,)))
        res_skip_w = [w[:, rows] for w in copied[:num_layers]]
        cond = None if cond is None else copied[num_layers]
    for i in range(num_layers):
        dilation = config.wavenet_dilation_rate**i
        x = tp.copy_in(inputs)[0] if split else inputs
        in_act = conv1d(
            x,
            p[f"in_layers.{i}.weight"],
            p[f"in_layers.{i}.bias"],
            padding=(config.wavenet_kernel_size * dilation - dilation) // 2,
            dilation=dilation,
        )
        if cond is not None:
            c = cond[..., i * 2 * hidden:(i + 1) * 2 * hidden]
            in_act = in_act + (c.index_select(-1, gate) if split else c)
        acts = torch.tanh(in_act[..., :units]) * sigmoid(in_act[..., units:])
        if split:  # the rank's rows of res_skip; its bias once, after the sum
            res_skip = tp.reduce(conv1d(acts, res_skip_w[i])) + p[f"res_skip_layers.{i}.bias"]
        else:
            res_skip = conv1d(acts, res_skip_w[i], p[f"res_skip_layers.{i}.bias"])
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
    tp=None,
) -> torch.Tensor:
    """Mean-only coupling: second_half -/+= mean(first_half) (log-det 0)."""
    half = config.flow_size // 2
    first_half, second_half = inputs[..., :half], inputs[..., half:]
    h = conv1d(first_half, p["conv_pre.weight"], p["conv_pre.bias"]) * padding_mask
    h = wavenet(p.sub("wavenet"), config, h, padding_mask,
                config.prior_encoder_num_wavenet_layers, global_conditioning, tp)
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
    tp=None,  # a parallel/tensor.py::TensorParallel (training)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior latents -> prior space (the training direction): (z_p, log_det (B,)).

    Mean-only couplings have a zero log-determinant, returned for the JAX
    signature.
    """
    p = params.sub("flow")
    cur = inputs
    for i in range(config.prior_encoder_num_flows):
        cur = residual_coupling_layer(p.sub(f"flows.{i}"), config, cur, padding_mask,
                                      global_conditioning, reverse=False, tp=tp)
        cur = torch.flip(cur, dims=(-1,))
    return cur, inputs.new_zeros(inputs.shape[0])
