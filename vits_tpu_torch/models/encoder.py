"""VITS text encoder: transformer with windowed relative-position attention.

Counterpart of ``vits_tpu/models/encoder.py``. Self-attention goes through
kernel A (``ops/cuda/attention.py``), which takes its plain version on the
CPU; the projections and the conv-FFN are plain PyTorch. With
``trainable=True`` (the training step) attention is differentiable: from
:data:`FLASH_TRAIN_TOKENS` tokens up through kernel A with lse forward and
kernel 4 backward (``ops/cuda/attention_grad.py``), below it plain autograd
attention -- the JAX package's gate (``vits_tpu/train/step.py:182``).

Trainable at bf16 (bf16 training casts the encoder's parameters and masks to
bf16): kernels A and 4 then take bf16 q, k, v at ``tier`` (the training
step's ``ops/tiers.py::BF16_TRAIN_TIER``), and the plain path below
:data:`FLASH_TRAIN_TOKENS` runs the module's bf16 graph, as JAX's does.

Serving at bf16 (``EngineConfig.compute_dtype="bfloat16"``: bf16 parameters
and masks) runs kernel A on bf16 q, k, v at ``tier`` (``Tier.bf16_compute``,
``ops/tiers.py::Tiers.bf16_compute``); with kernel A off (the JAX engine's CPU
default) the module's bf16 graph, which only a CPU tensor takes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.ops.conv import conv1d, layer_norm, weak_scalar
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_reference
from vits_tpu_torch.ops.cuda.attention_grad import trainable_rel_attention
from vits_tpu_torch.ops.tiers import EXACT_TIER, Tier

FLASH_TRAIN_TOKENS = 512  # training token length from which attention takes kernels A + 4


class EncoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # (B, T, H)
    prior_means: torch.Tensor  # (B, T, flow)
    prior_log_variances: torch.Tensor  # (B, T, flow)


def _attention(p: ParamView, x: torch.Tensor, lengths: torch.Tensor,
               config: VitsConfig, trainable: bool = False,
               tier: Tier = EXACT_TIER) -> torch.Tensor:
    """Multi-head self-attention with relative position bias; x: (B, T, H).
    Kernels A (and 4) run at ``tier``; the plain training path ignores it."""
    if not config.window_size:
        raise NotImplementedError("attention without a relative window is not ported")
    bsz, tgt_len, embed_dim = x.shape
    num_heads, head_dim = config.num_attention_heads, config.head_dim

    def shape4(t):  # (B, T, H) -> (B, heads, T, head_dim)
        return t.reshape(bsz, tgt_len, num_heads, head_dim).transpose(1, 2).contiguous()

    query = (x @ p["q_proj.weight"] + p["q_proj.bias"]) * weak_scalar(head_dim**-0.5, x)
    key = x @ p["k_proj.weight"] + p["k_proj.bias"]
    value = x @ p["v_proj.weight"] + p["v_proj.bias"]
    kw = {}
    if not trainable and x.dtype == torch.bfloat16 and not tier.bf16_compute:
        if x.device.type != "cpu":
            raise ValueError("bf16 serving runs kernel A: its tier needs bf16_compute")
        attend = rel_attention_reference  # kernel A off: the module's bf16 graph
    elif not trainable:
        attend, kw = flash_rel_attention, {"tier": tier}
    elif tgt_len >= FLASH_TRAIN_TOKENS:
        attend, kw = trainable_rel_attention, {"tier": tier}
    else:
        attend = rel_attention_reference
    attn = attend(
        shape4(query), shape4(key), shape4(value),
        p["emb_rel_k"][0], p["emb_rel_v"][0],
        window=config.window_size, lengths=lengths, **kw,
    )
    attn = attn.transpose(1, 2).reshape(bsz, tgt_len, embed_dim)
    return attn @ p["out_proj.weight"] + p["out_proj.bias"]


def _feed_forward(p: ParamView, x: torch.Tensor, padding_mask: torch.Tensor,
                  config: VitsConfig) -> torch.Tensor:
    """Conv-FFN; x: (B, T, H)."""
    k = config.ffn_kernel_size
    pad = ((k - 1) // 2, k // 2)
    if config.hidden_act == "relu":
        act = torch.relu
    else:  # jax.nn.gelu's default is the tanh approximation
        act = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    h = conv1d(x * padding_mask, p["conv_1.weight"], p["conv_1.bias"], padding=pad)
    h = act(h) * padding_mask
    h = conv1d(h, p["conv_2.weight"], p["conv_2.bias"], padding=pad)
    return h * padding_mask


def encoder_layer(layer: ParamView, hidden: torch.Tensor, lengths: torch.Tensor,
                  padding_mask: torch.Tensor, config: VitsConfig,
                  trainable: bool = False, tier: Tier = EXACT_TIER) -> torch.Tensor:
    """One transformer layer: rel-pos attention + conv-FFN, post-layernorms."""
    attn_out = _attention(layer.sub("attention"), hidden, lengths, config, trainable, tier)
    hidden = layer_norm(hidden + attn_out, layer["layer_norm.weight"],
                        layer["layer_norm.bias"], config.layer_norm_eps)
    ffn_out = _feed_forward(layer.sub("feed_forward"), hidden, padding_mask, config)
    return layer_norm(hidden + ffn_out, layer["final_layer_norm.weight"],
                      layer["final_layer_norm.bias"], config.layer_norm_eps)


def text_encoder(
    params: ParamView,
    config: VitsConfig,
    input_ids: torch.Tensor,  # (B, T) int
    padding_mask: torch.Tensor,  # (B, T, 1) float, a prefix mask
    trainable: bool = False,
    tier: Tier = EXACT_TIER,  # kernel A's (the JAX reduce_precision(pallas_precision))
) -> EncoderOutput:
    p = params.sub("text_encoder")
    hidden = p["embed_tokens.weight"][input_ids]
    hidden = hidden * weak_scalar(math.sqrt(config.hidden_size), hidden)
    hidden = hidden * padding_mask
    # counted in fp32: a bf16 mask's sum rounds above 256 tokens
    lengths = padding_mask[..., 0].float().sum(dim=1).to(torch.int32)

    enc = p.sub("encoder")
    for i in range(config.num_hidden_layers):
        hidden = encoder_layer(enc.sub(f"layers.{i}"), hidden, lengths, padding_mask, config,
                               trainable, tier)

    hidden = hidden * padding_mask
    stats = conv1d(hidden, p["project.weight"], p["project.bias"]) * padding_mask
    return EncoderOutput(hidden, stats[..., : config.flow_size], stats[..., config.flow_size :])
