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
  upsampler in plain PyTorch and each resblock as kernel 7, the sum over the
  blocks and the division by their number in the kernel's epilogue
  (``into``/``scale``);
* any other stage takes the plain per-block path.

``global_conditioning`` (B, 1, speaker_emb) is 1x1-convolved by
``decoder.cond`` and added after ``conv_pre``.

After every conv the padded tail of each row is re-zeroed with the stage's
upsampled mask, so a padded batch row equals its solo run. The final
activation uses torch's default slope (0.01), not ``leaky_relu_slope``.

With ``trainable=True`` (the training step decodes unmasked segments) the
routing is the JAX package's training one (``hifigan.py:356-367``): wide
stages run kernel 5 (``ops/cuda/trio_grad.py``) at the stage's tier,
differentiable; every other stage takes the plain path. Kernels B and C are
not reached under autograd. With bf16 parameters and latents (bf16 training,
``tiers`` its ``ops/tiers.py::training_tiers``) the whole decoder runs in bf16
as JAX's bf16 training runs it, kernel 5 on bf16 storage, and returns a bf16
waveform.

Precision tiers (``tiers``, ``ops/tiers.py``) as the JAX ``pallas_precision``
(one tier, or one per stage: ``stage_precision``) and ``pallas_value_dtype``.
With bf16 values the activation is carried in bf16 from ``conv_pre`` on, as
the JAX vocoder carries it (``hifigan.py:221-231``): the wide stages'
upsampler runs in bf16 on the packs' bf16 weights (a plain bf16
ConvTranspose1d), kernels B and C take and give bf16; kernel 7 and the other
plain steps compute in fp32, as the JAX ones do once an fp32 weight has
promoted the carry. ``packs`` (:func:`precompute_vocoder_packs`, made once
per engine) hold the bf16 or int8 weights of kernels B and C; without them
the kernels read the fp32 parameters.

bf16 serving (``tiers.compute_dtype`` bf16, ``ops/tiers.py::Tiers.bf16_compute``:
bf16 parameters, latents and mask) is the JAX vocoder at ``compute_dtype=
"bfloat16"``, which runs no vocoder kernel: XLA's masked bf16 graph of every
stage (the plain ``_resblock``, the mean's bf16 sum and division, the
per-phase transposed conv where the geometry allows it, leaky(0.01),
conv_post, tanh, the mask). Here the stages keep their routing and kernels B,
C and 7 compute that graph (``ops/tiers.py::BF16_COMPUTE_TIER``: bf16 in and
out, rounding where XLA's graph rounds); the glue between them (conv_pre,
cond, the wide stages' upsamplers) runs as bf16 PyTorch ops. The waveform
comes back bf16, as JAX's does; the engine upcasts it on the host.

Tensor parallel (``tp``, a ``parallel/tensor.py::TensorParallel``; training
only): ``conv_pre`` computes the rank's channels and ``upsampler.0`` their
rows; each later upsampler whose rows split takes the rank's channels of the
whole activation; each sum over the model group is followed by the
upsampler's bias. The resblocks (kernel 5 on the wide stages) run whole on
gathered weights.
"""

from __future__ import annotations

import torch

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.ops.conv import conv1d, conv_transpose1d, leaky_relu
from vits_tpu_torch.ops.cuda.resblock import fused_resblock, fused_resblock_trio, resblocks_mean
from vits_tpu_torch.ops.cuda.stage import FINAL_SLOPE, fused_stage, per_tap
from vits_tpu_torch.ops.cuda.trio_grad import trainable_trio
from vits_tpu_torch.ops.tiers import EXACT_TIERS, Tiers

PACK_WEIGHT_FORMATS = ("float32", "bfloat16", "int8")


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


def quantize_out_channels(w: torch.Tensor, dims: tuple[int, ...]) -> tuple[torch.Tensor,
                                                                           torch.Tensor]:
    """fp32 weights -> int8 + fp32 scales, one per index of the dims not in
    ``dims`` (a conv's out-channel, and a stack's pair): the JAX packs' scheme
    (``hifigan.py::_quantize_conv_stack``, ``stage.py::_quantize_group``) and
    arithmetic."""
    absmax = w.abs().amax(dim=dims, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.reshape([n for d, n in enumerate(w.shape) if d not in dims])


def _pack_blocks(blocks: list[dict], weight_format: str) -> list[dict]:
    """A stage's resblocks with stacked (pairs, k, C, C) weights in the format:
    int8 with (pairs, C) scales per (pair, out-channel), the JAX trio's and
    stage's sum-groups."""
    packed = []
    for blk in blocks:
        out = {"kernel_size": blk["kernel_size"], "dilations": blk["dilations"],
               "b1": torch.stack(blk["b1"]), "b2": torch.stack(blk["b2"])}
        for w, s in (("w1", "s1"), ("w2", "s2")):
            stack = torch.stack(blk[w])
            if weight_format == "int8":
                out[w], out[s] = quantize_out_channels(stack, (1, 2))
            else:
                out[w] = stack.to(torch.bfloat16)
        packed.append(out)
    return packed


def precompute_vocoder_packs(params: ParamView, config: VitsConfig,
                             weight_format: str) -> dict[int, dict]:
    """Load-time weights of kernels B and C in a weight format, per stage.

    The port's ``precompute_vocoder_packs`` (``vits_tpu/models/hifigan.py:121-192``):
    for "bfloat16" and "int8" each stage-kernel stage gets its upsampler
    (``up_w``, with int8 its ``su`` scales), its resblocks (stacked, ``s1``/
    ``s2`` scales) and on the last stage conv_post (``post``: weight, padding,
    scale or None); each wide stage its resblocks and a bf16 copy of its
    upsampler (``up_w``, ``up_b``) for the bf16 carry. The raw (k, in, out)
    layout, quantized per out-channel as JAX quantizes its packed layout:
    the same int8 values and scales. Int8 checkpoints are read dequantized
    (:class:`ParamView`), as in JAX. "float32" needs no pack: the kernels read
    the parameters. Returns ``{stage: {...}}``.
    """
    if weight_format not in PACK_WEIGHT_FORMATS:
        raise ValueError(f"unknown weight_format {weight_format!r}")
    if weight_format == "float32":
        return {}
    p = params.sub("decoder")
    packs: dict[int, dict] = {}
    n_stages = len(config.upsample_rates)
    for i, rate in enumerate(config.upsample_rates):
        up_w, up_b = p[f"upsampler.{i}.weight"], p[f"upsampler.{i}.bias"]
        c_in, c_out = up_w.shape[1], up_w.shape[2]
        blocks = _pack_blocks(_stage_resblocks(p, config, i), weight_format)
        if _stage_fusable(c_in, c_out, rate):
            pack = {"blocks": blocks, "up_b": up_b}
            if weight_format == "int8":
                pack["up_w"], pack["su"] = quantize_out_channels(up_w, (0, 1))
            else:
                pack["up_w"] = up_w.to(torch.bfloat16)
            if i == n_stages - 1:
                w_post = p["conv_post.weight"]
                pad = (w_post.shape[0] - 1) // 2
                if weight_format == "int8":  # one out-channel: one scale
                    q, scale = quantize_out_channels(w_post, (0, 1))
                    pack["post"] = (q, pad, scale)
                else:
                    pack["post"] = (w_post.to(torch.bfloat16), pad, None)
            packs[i] = pack
        elif c_out % 128 == 0:
            packs[i] = {"blocks": blocks, "up_w": up_w.to(torch.bfloat16),
                        "up_b": up_b.to(torch.bfloat16)}
    return packs


def _lengths(mask: torch.Tensor | None) -> torch.Tensor | None:
    """Valid steps per row, counted in fp32 (a bf16 sum rounds above 256)."""
    return None if mask is None else mask[..., 0].float().sum(dim=1).to(torch.int32)


def hifigan(
    params: ParamView,
    config: VitsConfig,
    spectrogram: torch.Tensor,  # (B, T, flow_size) latents
    frame_mask: torch.Tensor | None = None,  # (B, T, 1)
    global_conditioning: torch.Tensor | None = None,  # (B, 1, speaker_emb)
    trainable: bool = False,
    tiers: Tiers = EXACT_TIERS,
    packs: dict | None = None,
    tp=None,  # a parallel/tensor.py::TensorParallel (trainable only)
) -> torch.Tensor:
    """Latents -> waveform (B, T * prod(upsample_rates)), fp32 (trainable: in the
    parameters' dtype; bf16 serving: bf16)."""
    if trainable and frame_mask is not None:
        raise ValueError("trainable decoding takes unmasked segments (frame_mask=None)")
    if tp is not None and not trainable:
        raise ValueError("tensor-parallel decoding is a training path (trainable=True)")
    p = params.sub("decoder")
    packs = packs or {}
    num_kernels = len(config.resblock_kernel_sizes)
    slope = config.leaky_relu_slope
    compute16 = not trainable and tiers.compute_dtype == torch.bfloat16  # bf16 serving

    width = config.upsample_initial_channel
    split = tp is not None and p["conv_pre.weight"].shape[2] != width  # h: the rank's channels
    if split:
        spectrogram, = tp.copy_in(spectrogram)
    h = conv1d(spectrogram, p["conv_pre.weight"], p["conv_pre.bias"], padding=3)
    if global_conditioning is not None:
        cond = conv1d(global_conditioning, p["cond.weight"], p["cond.bias"])
        h = h + (tp.copy_in(cond)[0][..., tp.channels(width)] if split else cond)
    mask = frame_mask
    if mask is not None:
        h = h * mask
    if not trainable and not compute16 and tiers.value_dtype == torch.bfloat16:
        h = h.to(torch.bfloat16)  # the bf16 carry

    n_stages = len(config.upsample_rates)
    for i, rate in enumerate(config.upsample_rates):
        kernel_size = config.upsample_kernel_sizes[i]
        up_w, up_b = p[f"upsampler.{i}.weight"], p[f"upsampler.{i}.bias"]
        c_in, c_out = up_w.shape[1], up_w.shape[2]
        up_padding = (kernel_size - rate) // 2
        tier = tiers.stage(i)
        pack = packs.get(i, {})

        if not trainable and _stage_fusable(c_in, c_out, rate):
            final_conv = None
            if i == n_stages - 1:
                w_post = p["conv_post.weight"]
                final_conv = pack.get("post", (w_post, (w_post.shape[0] - 1) // 2))
            chain = i < n_stages - 1 and _stage_fusable(
                c_out, p[f"upsampler.{i + 1}.weight"].shape[2], config.upsample_rates[i + 1])
            h = fused_stage(
                h.to(tier.value_dtype).contiguous(), pack.get("up_w", up_w), up_b,
                pack.get("blocks") or _stage_resblocks(p, config, i),
                stride=rate, up_padding=up_padding, slope=slope,
                lengths=_lengths(mask), final_conv=final_conv, tier=tier,
                up_scale=pack.get("su"), chain=chain,
            )
            if final_conv is not None:
                return h  # tanh'd, masked waveform (B, T)
            if mask is not None:
                mask = torch.repeat_interleave(mask, rate, dim=1)
            continue

        if "up_w" in pack and h.dtype == torch.bfloat16:  # the bf16 carry's upsampler
            up_w, up_b = pack["up_w"], pack["up_b"]
        h = leaky_relu(h, slope)
        if h.dtype != up_w.dtype:  # an fp32 weight promotes the carry, as in JAX
            h = h.float()
        # the upsampler's rows are the rank's (conv_pre's out channels split with
        # upsampler.0's rows: one width, one divisibility)
        rows = tp is not None and c_in != width >> i
        if rows and not split:  # the rank's channels of the whole activation
            h = tp.copy_in(h)[0][..., tp.channels(width >> i)]
        # bf16 training and serving: the JAX decoder's per-phase form where it
        # applies, as it rounds
        phases = ((trainable or compute16) and h.dtype == torch.bfloat16
                  and per_tap(kernel_size, rate, up_padding))
        h = conv_transpose1d(h, up_w, None if rows else up_b, stride=rate, padding=up_padding,
                             method="phases" if phases else None)
        if rows:  # the bias once, after the sum
            h = tp.reduce(h) + up_b
        split = False
        if mask is not None:
            mask = torch.repeat_interleave(mask, rate, dim=1)
            h = h * mask.to(h.dtype)

        if c_out % 128 == 0:
            if trainable:
                h = trainable_trio(h.contiguous(), _stage_resblocks(p, config, i), slope=slope,
                                   tier=tier)
            else:
                h = fused_resblock_trio(h.to(tier.value_dtype).contiguous(),
                                        pack.get("blocks") or _stage_resblocks(p, config, i),
                                        slope=slope, lengths=_lengths(mask), tier=tier)
            continue

        if not trainable and not compute16:
            h = h.float()
        if not trainable and 128 % c_out == 0:  # narrow: kernel 7 per block, summed in place
            h, lengths, res_state = h.contiguous(), _lengths(mask), None
            for j, block in enumerate(_stage_resblocks(p, config, i)):
                last = j == num_kernels - 1
                res_state = fused_resblock(  # the mean: x (1 / n) in fp32, / n in bf16
                    h, block, slope=slope, lengths=lengths, into=res_state,
                    scale=1.0 / num_kernels if last and not compute16 else 1.0,
                    divisor=num_kernels if last and compute16 else 1, tier=tier)
            h = res_state
            continue

        h = resblocks_mean(h, _stage_resblocks(p, config, i), slope, mask)

    h = conv1d(leaky_relu(h if trainable or compute16 else h.float(), FINAL_SLOPE),
               p["conv_post.weight"], None, padding=3)
    waveform = torch.tanh(h)
    if mask is not None:
        waveform = waveform * mask
    return waveform[..., 0]
