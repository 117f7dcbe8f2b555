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

No relative window (``config.window_size`` 0, no ``emb_rel_k``/``emb_rel_v``):
the JAX module's plain path -- scores, the additive key-padding bias, softmax
and the value product (``rel_attention_reference`` without tables) -- for
serving and training alike, on any device: the JAX package runs it outside any
kernel, so kernels A and 4 have nothing to replace there.

Tensor parallel (``tp``, a ``parallel/tensor.py::TensorParallel``; training):
where a layer's q/k/v hold the rank's heads, the attention runs on those heads
(kernels A and 4 included) and ``out_proj`` on their rows, one sum over the
model group; where ``conv_1`` holds the rank's channels, the FFN likewise.
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
               tier: Tier = EXACT_TIER, tp=None) -> torch.Tensor:
    """Multi-head self-attention with relative position bias; x: (B, T, H).
    Kernels A (and 4) run at ``tier``; the plain paths ignore it. Under ``tp``
    with the rank's heads in q/k/v: those heads, then a sum."""
    bsz, tgt_len, embed_dim = x.shape
    head_dim, window = config.head_dim, config.window_size
    tables = (p["emb_rel_k"], p["emb_rel_v"]) if window else ()
    split = tp is not None and p["q_proj.weight"].shape[1] != embed_dim
    if split:  # the tables are shared by every head: their gradients sum over the group
        x, *tables = tp.copy_in(x, *tables)
    num_heads = p["q_proj.weight"].shape[1] // head_dim

    def shape4(t):  # (B, T, H) -> (B, heads, T, head_dim)
        return t.reshape(bsz, tgt_len, num_heads, head_dim).transpose(1, 2).contiguous()

    query = (x @ p["q_proj.weight"] + p["q_proj.bias"]) * weak_scalar(head_dim**-0.5, x)
    key = x @ p["k_proj.weight"] + p["k_proj.bias"]
    value = x @ p["v_proj.weight"] + p["v_proj.bias"]
    kw = {}
    if not window:
        attend = rel_attention_reference  # no table: JAX's plain path, no kernel
    elif not trainable and x.dtype == torch.bfloat16 and not tier.bf16_compute:
        if x.device.type != "cpu":
            raise ValueError("bf16 serving runs kernel A: its tier needs bf16_compute")
        attend = rel_attention_reference  # kernel A off: the module's bf16 graph
    elif not trainable:
        attend, kw = flash_rel_attention, {"tier": tier}
    elif tgt_len >= FLASH_TRAIN_TOKENS:
        attend, kw = trainable_rel_attention, {"tier": tier}
    else:
        attend = rel_attention_reference
    rel_k, rel_v = (t[0] for t in tables) if window else (None, None)
    attn = attend(shape4(query), shape4(key), shape4(value), rel_k, rel_v, window=window,
                  lengths=lengths, **kw)
    attn = attn.transpose(1, 2).reshape(bsz, tgt_len, num_heads * head_dim)
    if split:  # out_proj's rows of the rank's heads; its bias once, after the sum
        return tp.reduce(attn @ p["out_proj.weight"]) + p["out_proj.bias"]
    return attn @ p["out_proj.weight"] + p["out_proj.bias"]


def _feed_forward(p: ParamView, x: torch.Tensor, padding_mask: torch.Tensor,
                  config: VitsConfig, tp=None) -> torch.Tensor:
    """Conv-FFN; x: (B, T, H). Under ``tp`` with the rank's channels in
    ``conv_1``: those channels, then ``conv_2``'s rows of them and a sum."""
    k = config.ffn_kernel_size
    pad = ((k - 1) // 2, k // 2)
    if config.hidden_act == "relu":
        act = torch.relu
    else:  # jax.nn.gelu's default is the tanh approximation
        act = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
    x = x * padding_mask
    split = tp is not None and p["conv_1.weight"].shape[2] != config.ffn_dim
    if split:
        x, = tp.copy_in(x)
    h = conv1d(x, p["conv_1.weight"], p["conv_1.bias"], padding=pad)
    h = act(h) * padding_mask
    if split:
        h = tp.reduce(conv1d(h, p["conv_2.weight"], padding=pad)) + p["conv_2.bias"]
    else:
        h = conv1d(h, p["conv_2.weight"], p["conv_2.bias"], padding=pad)
    return h * padding_mask


def encoder_layer(layer: ParamView, hidden: torch.Tensor, lengths: torch.Tensor,
                  padding_mask: torch.Tensor, config: VitsConfig,
                  trainable: bool = False, tier: Tier = EXACT_TIER, tp=None) -> torch.Tensor:
    """One transformer layer: rel-pos attention + conv-FFN, post-layernorms."""
    attn_out = _attention(layer.sub("attention"), hidden, lengths, config, trainable, tier, tp)
    hidden = layer_norm(hidden + attn_out, layer["layer_norm.weight"],
                        layer["layer_norm.bias"], config.layer_norm_eps)
    ffn_out = _feed_forward(layer.sub("feed_forward"), hidden, padding_mask, config, tp)
    return layer_norm(hidden + ffn_out, layer["final_layer_norm.weight"],
                      layer["final_layer_norm.bias"], config.layer_norm_eps)


def text_encoder(
    params: ParamView,
    config: VitsConfig,
    input_ids: torch.Tensor,  # (B, T) int
    padding_mask: torch.Tensor,  # (B, T, 1) float, a prefix mask
    trainable: bool = False,
    tier: Tier = EXACT_TIER,  # kernel A's (the JAX reduce_precision(pallas_precision))
    tp=None,  # a parallel/tensor.py::TensorParallel (training)
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
                               trainable, tier, tp)

    hidden = hidden * padding_mask
    stats = conv1d(hidden, p["project.weight"], p["project.bias"]) * padding_mask
    return EncoderOutput(hidden, stats[..., : config.flow_size], stats[..., config.flow_size :])
