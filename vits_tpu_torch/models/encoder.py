"""VITS text encoder: transformer with windowed relative-position attention.

Counterpart of ``vits_tpu/models/encoder.py``. Self-attention goes through
kernel A (``ops/cuda/attention.py``), which takes its plain version on the
CPU; the projections and the conv-FFN are plain PyTorch. With
``trainable=True`` (the training step) attention is differentiable: from
:data:`FLASH_TRAIN_TOKENS` tokens up through kernel A with lse forward and
kernel 4 backward (``ops/cuda/attention_grad.py``), below it plain autograd
attention -- the JAX package's gate (``vits_tpu/train/step.py:182``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.ops.conv import conv1d, layer_norm
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention, rel_attention_reference
from vits_tpu_torch.ops.cuda.attention_grad import trainable_rel_attention

FLASH_TRAIN_TOKENS = 512  # training token length from which attention takes kernels A + 4


class EncoderOutput(NamedTuple):
    last_hidden_state: torch.Tensor  # (B, T, H)
    prior_means: torch.Tensor  # (B, T, flow)
    prior_log_variances: torch.Tensor  # (B, T, flow)


def _attention(p: ParamView, x: torch.Tensor, lengths: torch.Tensor,
               config: VitsConfig, trainable: bool = False) -> torch.Tensor:
    """Multi-head self-attention with relative position bias; x: (B, T, H)."""
    if not config.window_size:
        raise NotImplementedError("attention without a relative window is not ported")
    bsz, tgt_len, embed_dim = x.shape
    num_heads, head_dim = config.num_attention_heads, config.head_dim

    def shape4(t):  # (B, T, H) -> (B, heads, T, head_dim)
        return t.reshape(bsz, tgt_len, num_heads, head_dim).transpose(1, 2).contiguous()

    query = (x @ p["q_proj.weight"] + p["q_proj.bias"]) * head_dim**-0.5
    key = x @ p["k_proj.weight"] + p["k_proj.bias"]
    value = x @ p["v_proj.weight"] + p["v_proj.bias"]
    if not trainable:
        attend = flash_rel_attention
    elif tgt_len >= FLASH_TRAIN_TOKENS:
        attend = trainable_rel_attention
    else:
        attend = rel_attention_reference
    attn = attend(
        shape4(query), shape4(key), shape4(value),
        p["emb_rel_k"][0], p["emb_rel_v"][0],
        window=config.window_size, lengths=lengths,
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
                  trainable: bool = False) -> torch.Tensor:
    """One transformer layer: rel-pos attention + conv-FFN, post-layernorms."""
    attn_out = _attention(layer.sub("attention"), hidden, lengths, config, trainable)
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
) -> EncoderOutput:
    p = params.sub("text_encoder")
    hidden = p["embed_tokens.weight"][input_ids] * math.sqrt(config.hidden_size)
    hidden = hidden * padding_mask
    lengths = padding_mask[..., 0].sum(dim=1).to(torch.int32)

    enc = p.sub("encoder")
    for i in range(config.num_hidden_layers):
        hidden = encoder_layer(enc.sub(f"layers.{i}"), hidden, lengths, padding_mask, config,
                               trainable)

    hidden = hidden * padding_mask
    stats = conv1d(hidden, p["project.weight"], p["project.bias"]) * padding_mask
    return EncoderOutput(hidden, stats[..., : config.flow_size], stats[..., config.flow_size :])
