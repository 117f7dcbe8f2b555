"""HiFiGAN vocoder: transposed-conv upsampling + multi-receptive-field resblocks.

Counterpart of ``vits_tpu/models/hifigan.py`` with the JAX package's per-stage
routing (its ``use_pallas`` path):

* a stage whose channels fit the stage kernel's check (``_stage_fusable``,
  the MMS tail stages 128->64->32) runs as kernel C, and the last such stage
  also applies conv_post + tanh and returns the waveform;
* a wide stage (C_out % 128 == 0, MMS stages 0-1) runs leaky ->
  ConvTranspose1d -> mask in plain PyTorch and its resblocks as kernel B;
* a narrow stage that fails that check (C_out dividing 128: HiFi-GAN V2's
  stages 0-1 at C 64, 32; the multi-speaker test model's at C 16, 8) runs its
  upsampler in plain PyTorch and each resblock as kernel 7, summed and divided
  by the number of blocks;
* any other stage takes the plain per-block path.

``global_conditioning`` (B, 1, speaker_emb) is 1x1-convolved by
``decoder.cond`` and added after ``conv_pre``.

After every conv the padded tail of each row is re-zeroed with the stage's
upsampled mask, so a padded batch row equals its solo run. The final
activation uses torch's default slope (0.01), not ``leaky_relu_slope``.

With ``trainable=True`` (the training step decodes unmasked segments) the
routing is the JAX package's training one (``hifigan.py:356-367``): wide
stages run kernel 5 (``ops/cuda/trio_grad.py``), differentiable; every other
stage takes the plain path. Kernels B and C are not reached under autograd.
"""

from __future__ import annotations

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.ops.conv import conv1d, conv_transpose1d, leaky_relu
from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio
from vits_tpu_torch.ops.cuda.stage import FINAL_SLOPE, fused_stage
from vits_tpu_torch.ops.cuda.trio_grad import trainable_trio


def _resblock(p: ParamView, x: torch.Tensor, mask: torch.Tensor | None,
              kernel_size: int, dilations: tuple[int, ...], slope: float) -> torch.Tensor:
    """One multi-dilation residual block (HifiGanResidualBlock)."""
    for i, dilation in enumerate(dilations):
        h = conv1d(leaky_relu(x, slope), p[f"convs1.{i}.weight"], p[f"convs1.{i}.bias"],
                   padding=(kernel_size * dilation - dilation) // 2, dilation=dilation)
        if mask is not None:
            h = h * mask
        h = conv1d(leaky_relu(h, slope), p[f"convs2.{i}.weight"], p[f"convs2.{i}.bias"],
                   padding=(kernel_size - 1) // 2)
        if mask is not None:
            h = h * mask
        x = h + x
    return x


def _stage_resblocks(p: ParamView, config: VitsConfig, i: int) -> list[dict]:
    """Stage i's resblocks as kernel blocks (per-pair weight lists, no copies)."""
    num_kernels = len(config.resblock_kernel_sizes)
    blocks = []
    for j, (k, dilations) in enumerate(zip(config.resblock_kernel_sizes,
                                           config.resblock_dilation_sizes)):
        block = p.sub(f"resblocks.{i * num_kernels + j}")
        pairs = range(len(dilations))
        blocks.append(dict(
            kernel_size=k,
            dilations=tuple(dilations),
            w1=[block[f"convs1.{n}.weight"] for n in pairs],
            b1=[block[f"convs1.{n}.bias"] for n in pairs],
            w2=[block[f"convs2.{n}.weight"] for n in pairs],
            b2=[block[f"convs2.{n}.bias"] for n in pairs],
        ))
    return blocks


def _stage_fusable(c_in: int, c_out: int, rate: int) -> bool:
    """The JAX package's routing check for its stage kernel (hifigan.py:233-241)."""
    return 128 % c_in == 0 and 128 % c_out == 0 and (128 // c_out) == rate * (128 // c_in)


def _lengths(mask: torch.Tensor | None) -> torch.Tensor | None:
    return None if mask is None else mask[..., 0].sum(dim=1).to(torch.int32)


def hifigan(
    params: ParamView,
    config: VitsConfig,
    spectrogram: torch.Tensor,  # (B, T, flow_size) latents
    frame_mask: torch.Tensor | None = None,  # (B, T, 1)
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
    trainable: bool = False,
) -> torch.Tensor:
    """Latents -> waveform (B, T * prod(upsample_rates))."""
    if trainable and frame_mask is not None:
        raise ValueError("trainable decoding takes unmasked segments (frame_mask=None)")
    p = params.sub("decoder")
    num_kernels = len(config.resblock_kernel_sizes)
    slope = config.leaky_relu_slope

    h = conv1d(spectrogram, p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
    if global_conditioning is not None:
        h = h + conv1d(global_conditioning, p["cond.weight"], p["cond.bias"])
    mask = frame_mask
    if mask is not None:
        h = h * mask

    n_stages = len(config.upsample_rates)
    for i, rate in enumerate(config.upsample_rates):
        kernel_size = config.upsample_kernel_sizes[i]
        up_w, up_b = p[f"upsampler.{i}.weight"], p[f"upsampler.{i}.bias"]
        c_in, c_out = up_w.shape[1], up_w.shape[2]
        up_padding = (kernel_size - rate) // 2

        if not trainable and _stage_fusable(c_in, c_out, rate):
            final_conv = None
            if i == n_stages - 1:
                w_post = p["conv_post.weight"]
                final_conv = (w_post, (w_post.shape[0] - 1) // 2)
            h = fused_stage(
                h.contiguous(), up_w, up_b, _stage_resblocks(p, config, i),
                stride=rate, up_padding=up_padding, slope=slope,
                lengths=_lengths(mask), final_conv=final_conv,
            )
            if final_conv is not None:
                return h  # tanh'd, masked waveform (B, T)
            if mask is not None:
                mask = torch.repeat_interleave(mask, rate, dim=1)
            continue

        h = conv_transpose1d(leaky_relu(h, slope), up_w, up_b, stride=rate,
                             padding=up_padding)
        if mask is not None:
            mask = torch.repeat_interleave(mask, rate, dim=1)
            h = h * mask

        if c_out % 128 == 0:
            blocks = _stage_resblocks(p, config, i)
            if trainable:
                h = trainable_trio(h.contiguous(), blocks, slope=slope)
            else:
                h = fused_resblock_trio(h.contiguous(), blocks, slope=slope,
                                        lengths=_lengths(mask))
            continue

        narrow = not trainable and 128 % c_out == 0
        if narrow:
            h, blocks, lengths = h.contiguous(), _stage_resblocks(p, config, i), _lengths(mask)
        res_state = None
        for j in range(num_kernels):
            if narrow:
                block_out = fused_resblock(h, blocks[j], slope=slope, lengths=lengths)
            else:
                block_out = _resblock(
                    p.sub(f"resblocks.{i * num_kernels + j}"), h, mask,
                    config.resblock_kernel_sizes[j], config.resblock_dilation_sizes[j], slope)
            res_state = block_out if res_state is None else res_state + block_out
        h = res_state / num_kernels

    h = conv1d(leaky_relu(h, FINAL_SLOPE), p["conv_post.weight"], None, padding=3)
    waveform = torch.tanh(h)
    if mask is not None:
        waveform = waveform * mask
    return waveform[..., 0]
