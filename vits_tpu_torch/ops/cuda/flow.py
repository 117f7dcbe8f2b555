"""Kernel 6: the reverse residual-coupling flow, one call per coupling.

Replaces ``vits_tpu/ops/pallas/flow.py::fused_flow``: the prior latents go
back through the ``n_flows`` mean-only couplings (flow n-1 first, a channel
flip before each), each a 1x1 conv_pre, a WaveNet of ``nl`` gated k=5 layers
with per-layer speaker conditioning, and a 1x1 conv_post whose output is
subtracted from the other half; rows at and past each row's length are zero
after every step. The CUDA kernel is ``vits_tpu_torch/csrc/flow.cu``.

The TPU kernel runs grid ``(B, n_flows)`` with the whole sequence resident in
VMEM and the couplings in order. Here each coupling is one call (the next
one reads the half this one wrote) that launches one tiled product per step
of the coupling (conv_pre, each layer's gate and res/skip, conv_post) over
all frames of the batch, the step's elementwise work in its epilogue, with
the WaveNet state in three (B, T, hidden) scratch buffers. The flips are not
applied to the data: the JAX package folds
them into packed weights; the kernel reads the canonical weights and walks
the channels of the read and updated halves backwards on the flipped steps
(:func:`flow_steps`). The per-(row, coupling, layer) speaker vectors are the
``cond_layer`` 1x1 convs of the embedding, computed before the launches in
plain PyTorch (:func:`pack_flow_cond`), as JAX computes them outside its
``pallas_call``. The plain PyTorch twin is :func:`flow_reference`: the
module's own math.
"""

from __future__ import annotations

import ctypes

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.models.flow import residual_coupling_block
from vits_tpu_torch.ops.conv import conv1d
from vits_tpu_torch.ops.cuda import (
    check,
    cuda_lengths,
    library,
    no_autograd,
    on_cuda,
    stream_of,
)
from vits_tpu_torch.ops.cuda.resblock import length_mask


def flow_steps(config: VitsConfig) -> list[tuple[int, bool]]:
    """The reverse flow's execution order: ``(coupling index, flipped)`` per step.

    Step s runs coupling n-1-s after s+1 flips. In the input's channel order
    an odd number of flips makes the coupling read the second half reversed
    and subtract its reversed mean from the first half (the JAX kernel's type
    A steps, s even); an even number reads the first half and updates the
    second (type B). With n even the output is back in the input's order.
    """
    n = config.prior_encoder_num_flows
    return [(n - 1 - s, s % 2 == 0) for s in range(n)]


def pack_flow_cond(params: ParamView, config: VitsConfig,
                   speaker_embeddings: torch.Tensor) -> torch.Tensor:
    """(B, 1, speaker_emb) -> (B, n_flows, nl, 2*hidden) WaveNet cond, in execution order."""
    nl, hidden = config.prior_encoder_num_wavenet_layers, config.hidden_size
    p = params.sub("flow")
    per_step = []
    for i, _ in flow_steps(config):
        wn = p.sub(f"flows.{i}.wavenet")
        c = conv1d(speaker_embeddings, wn["cond_layer.weight"], wn["cond_layer.bias"])
        per_step.append(c.reshape(c.shape[0], nl, 2 * hidden))
    return torch.stack(per_step, dim=1).contiguous()


def flow_reference(
    x: torch.Tensor,  # (B, T, flow_size) prior latents
    params: ParamView,
    config: VitsConfig,
    *,
    lengths: torch.Tensor | None = None,  # (B,) valid frames
    speaker_embeddings: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Plain PyTorch: the reverse coupling stack, zero at and past each length."""
    mask = length_mask(lengths, x.shape[1], x.dtype)
    if mask is None:
        mask = x.new_ones((*x.shape[:2], 1))
    return residual_coupling_block(params, config, x, mask, speaker_embeddings) * mask


def _coupling_weights(params: ParamView, config: VitsConfig,
                      i: int) -> list[tuple[str, torch.Tensor, tuple]]:
    """Coupling i's (name, tensor, kernel's shape), in the kernel's order."""
    half, hidden = config.flow_size // 2, config.hidden_size
    nl, k = config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size
    f = params.sub(f"flow.flows.{i}")
    wn = f.sub("wavenet")
    named = [("conv_pre.weight", f, (1, half, hidden)), ("conv_pre.bias", f, (hidden,)),
             ("conv_post.weight", f, (1, hidden, half)), ("conv_post.bias", f, (half,))]
    for l in range(nl):
        rs = 2 * hidden if l < nl - 1 else hidden
        named += [(f"in_layers.{l}.weight", wn, (k, hidden, 2 * hidden)),
                  (f"in_layers.{l}.bias", wn, (2 * hidden,)),
                  (f"res_skip_layers.{l}.weight", wn, (1, hidden, rs)),
                  (f"res_skip_layers.{l}.bias", wn, (rs,))]
    return [(f"flows.{i}.{name}", view[name], shape) for name, view, shape in named]


def fused_flow(
    x: torch.Tensor,  # (B, T, flow_size)
    params: ParamView,
    config: VitsConfig,
    *,
    lengths: torch.Tensor | None = None,  # (B,) valid frames; None = all T
    speaker_embeddings: torch.Tensor | None = None,  # (B, 1, speaker_emb)
) -> torch.Tensor:
    """Prior latents -> flow latents (B, T, flow_size), zero at and past each length.

    CPU tensors take :func:`flow_reference`; CUDA tensors launch the kernels
    (fp32, contiguous, no autograd, flow_size // 2 a multiple of 16 and
    hidden_size of 32) or raise, including on what the TPU kernel silently
    gets wrong: a WaveNet dilation rate other than 1 (it reads its k taps
    contiguously) and an odd number of flows.
    """
    steps = flow_steps(config)
    weights = [_coupling_weights(params, config, i) for i, _ in steps]
    tensors = [x, *(t for ws in weights for _, t, _ in ws)]
    if speaker_embeddings is not None:
        tensors.append(speaker_embeddings)
    if not on_cuda("fused_flow", *tensors):
        return flow_reference(x, params, config, lengths=lengths,
                              speaker_embeddings=speaker_embeddings)
    no_autograd("fused_flow", *tensors)
    B, T, C = x.shape
    half, hidden = config.flow_size // 2, config.hidden_size
    nl, k = config.prior_encoder_num_wavenet_layers, config.wavenet_kernel_size
    if C != config.flow_size:
        raise ValueError(f"flow kernel: input has {C} channels, flow_size is {config.flow_size}")
    if config.wavenet_dilation_rate != 1 and nl > 1:
        raise ValueError("flow kernel needs wavenet_dilation_rate == 1, got "
                         f"{config.wavenet_dilation_rate}")
    if half % 16 or hidden % 32:
        raise ValueError(f"flow kernel needs flow_size // 2 % 16 == 0 and hidden_size % 32 == 0 "
                         f"(got {half}, {hidden})")
    if len(steps) % 2 or k % 2 == 0:
        raise ValueError(f"flow kernel needs an even number of flows and an odd kernel size "
                         f"(got {len(steps)} flows, k={k})")
    for name, t, shape in (w for ws in weights for w in ws):
        if tuple(t.shape) != shape or t.data_ptr() % 16:
            raise ValueError(f"flow kernel: {name} {tuple(t.shape)} != {shape} "
                             "or not 16-byte aligned")
    cond = None
    if speaker_embeddings is not None:
        cond = pack_flow_cond(params, config, speaker_embeddings)
    lib = library()
    stream = stream_of(x)
    lens = cuda_lengths(lengths, B, T, x.device)
    out = x.clone()  # the couplings update its halves in place
    h, acts, skip = (x.new_empty((B, T, hidden)) for _ in range(3))
    row_stride = len(steps) * nl * 2 * hidden
    for s, ((_, flipped), ws) in enumerate(zip(steps, weights)):
        ptrs = (ctypes.c_void_p * len(ws))(*(t.data_ptr() for _, t, _ in ws))
        cond_ptr = None if cond is None else cond.data_ptr() + 4 * s * nl * 2 * hidden
        read_off, upd_off = (half, 0) if flipped else (0, half)
        check(lib.vk_flow_coupling(
            out.data_ptr(), lens.data_ptr(), cond_ptr, row_stride, ctypes.addressof(ptrs),
            len(ws), h.data_ptr(), acts.data_ptr(), skip.data_ptr(), B, T, C, half, hidden, nl,
            k, read_off, upd_off, int(flipped), stream),
            f"flow coupling kernels (step {s})")
    fused_flow.launches += 1
    return out


fused_flow.launches = 0
