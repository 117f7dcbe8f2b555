"""High-level checkpoint loading: .ggml files, HF modules, HF directories.

Covers the reference's loader capabilities (file and in-memory bytes,
reference/src/vits_model_data.cpp:99-117) plus direct HF loading — the
reference's prefix-name scheme is just the HF state_dict namespace, so both
sources produce identical parameter pytrees.  Weight-norm parametrizations are
merged at load exactly like the reference's export step
(reference/scripts/export_vits.py:72-93).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.ggml import GgmlCheckpoint, read_ggml, write_ggml
from vits_tpu_torch.io.params import convert_state_dict, to_torch_layout
from vits_tpu_torch.text.tokenizer import VitsTokenizer

# Modules that are only used when training (the reference never exports runs
# them; we keep them loadable for the training path but tolerate their absence).
_TRAIN_ONLY_PREFIXES = ("posterior_encoder.",)
_TRAIN_ONLY_SDP = re.compile(r"duration_predictor\.post_")


def merge_weight_norm(state_dict: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Fold weight-norm parametrizations into plain ``.weight`` tensors.

    Handles both new-style ``...parametrizations.weight.original{0,1}`` and
    old-style ``...weight_{g,v}`` key pairs.  w = g * v / ||v|| with the norm
    taken over all axes except 0 (torch ``weight_norm`` default ``dim=0``).
    """
    out: dict[str, np.ndarray] = {}
    handled: set[str] = set()
    for key in state_dict:
        m = re.match(r"(.*)\.parametrizations\.weight\.original0$", key)
        style = "new"
        if m is None:
            m = re.match(r"(.*)\.weight_g$", key)
            style = "old"
        if m is None:
            continue
        base = m.group(1)
        g = np.asarray(state_dict[key], dtype=np.float32)
        v_key = (
            f"{base}.parametrizations.weight.original1" if style == "new" else f"{base}.weight_v"
        )
        v = np.asarray(state_dict[v_key], dtype=np.float32)
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt(np.sum(v * v, axis=axes, keepdims=True))
        out[f"{base}.weight"] = g * v / norm
        handled.update({key, v_key})
    for key, value in state_dict.items():
        if key in handled or key in out:
            continue
        if ".parametrizations." in key or key.endswith((".weight_g", ".weight_v")):
            continue
        out[key] = np.asarray(value)
    return out


def _strip_train_only(state_dict: Mapping[str, np.ndarray], keep_training: bool):
    if keep_training:
        return dict(state_dict)
    return {
        k: v
        for k, v in state_dict.items()
        if not k.startswith(_TRAIN_ONLY_PREFIXES) and not _TRAIN_ONLY_SDP.match(k)
    }


def load_ggml(source: str | bytes, dtype=np.float32):
    """Load a reference-format .ggml checkpoint.

    Returns ``(config, tokenizer, params)`` where params is the flat canonical-
    layout dict ready for the JAX model.
    """
    ckpt: GgmlCheckpoint = read_ggml(source)
    config = VitsConfig.from_kv(ckpt.config_kv)
    tokenizer = VitsTokenizer(
        vocab=ckpt.vocab,
        add_blank=ckpt.add_blank,
        normalize=ckpt.normalize,
        pad_token=ckpt.pad_token,
        unk_token=ckpt.unk_token,
        phonetic=config.phonetic,
    )
    params = convert_state_dict(ckpt.tensors, dtype=dtype)
    return config, tokenizer, params


def load_hf_module(model: Any, tokenizer: Any = None, dtype=np.float32, keep_training=False):
    """Load from live ``transformers.VitsModel`` (+ optional ``VitsTokenizer``)."""
    state = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
    state = merge_weight_norm(state)
    state = _strip_train_only(state, keep_training)
    config = VitsConfig.from_hf(model.config)
    tok = VitsTokenizer.from_hf(tokenizer) if tokenizer is not None else None
    return config, tok, convert_state_dict(state, dtype=dtype)


def load_hf_pretrained(name_or_dir: str, dtype=np.float32, keep_training=False):
    """Load from a HF hub name or local directory (requires torch+transformers)."""
    from transformers import VitsModel
    from transformers import VitsTokenizer as HFVitsTokenizer

    model = VitsModel.from_pretrained(name_or_dir)
    tokenizer = HFVitsTokenizer.from_pretrained(name_or_dir)
    return load_hf_module(model, tokenizer, dtype=dtype, keep_training=keep_training)


def export_to_ggml(
    dest: str,
    config: VitsConfig,
    tokenizer: VitsTokenizer,
    params: Mapping[str, np.ndarray],
    fp16_convs: bool = True,
) -> None:
    """Write params back to the reference's .ggml format.

    Mirrors the reference export pipeline: conv/conv-transpose weights stored
    fp16, everything else fp32 (reference/scripts/export_vits.py:87).
    """
    tensors: dict[str, np.ndarray] = {}
    for name, value in params.items():
        arr = np.asarray(value)
        if arr.dtype == np.int8:
            # quantized weights (io/quantize.py) round-trip verbatim; their
            # f32 .scale rows ride the plain path below (dtype code 2 is
            # this repo's format extension — io/ggml.py docstring)
            tensors[name] = to_torch_layout(name, arr)
            continue
        torch_arr = to_torch_layout(name, arr.astype(np.float32, copy=False))
        if fp16_convs and torch_arr.ndim == 3 and name.endswith(".weight"):
            torch_arr = torch_arr.astype(np.float16)
        tensors[name] = torch_arr
    config_kv = {
        "hidden_act": config.hidden_act,
        "hidden_size": str(config.hidden_size),
        "window_size": str(config.window_size),
        "flow_size": str(config.flow_size),
        "num_hidden_layers": str(config.num_hidden_layers),
        "ffn_kernel_size": str(config.ffn_kernel_size),
        "ffn_dim": str(config.ffn_dim),
        "num_attention_heads": str(config.num_attention_heads),
        "layer_norm_eps": repr(config.layer_norm_eps),
        "vocab_size": str(config.vocab_size),
        "spectrogram_bins": str(config.spectrogram_bins),
        "prior_encoder_num_wavenet_layers": str(config.prior_encoder_num_wavenet_layers),
        "posterior_encoder_num_wavenet_layers": str(config.posterior_encoder_num_wavenet_layers),
        "wavenet_dilation_rate": str(config.wavenet_dilation_rate),
        "wavenet_kernel_size": str(config.wavenet_kernel_size),
        "speaker_embedding_size": str(config.speaker_embedding_size),
        "num_speakers": str(config.num_speakers),
        "prior_encoder_num_flows": str(config.prior_encoder_num_flows),
        "upsample_rates": str(list(config.upsample_rates)),
        "upsample_kernel_sizes": str(list(config.upsample_kernel_sizes)),
        "upsample_initial_channel": str(config.upsample_initial_channel),
        "resblock_kernel_sizes": str(list(config.resblock_kernel_sizes)),
        "resblock_dilation_sizes": str([list(d) for d in config.resblock_dilation_sizes]),
        "leaky_relu_slope": repr(config.leaky_relu_slope),
        "duration_predictor_kernel_size": str(config.duration_predictor_kernel_size),
        "depth_separable_num_layers": str(config.depth_separable_num_layers),
        "depth_separable_channels": str(config.depth_separable_channels),
        "duration_predictor_flow_bins": str(config.duration_predictor_flow_bins),
        "duration_predictor_tail_bound": str(int(config.duration_predictor_tail_bound)),
        "duration_predictor_num_flows": str(config.duration_predictor_num_flows),
        "duration_predictor_filter_channels": str(config.duration_predictor_filter_channels),
        "noise_scale": repr(config.noise_scale),
        "noise_scale_duration": repr(config.noise_scale_duration),
        "speaking_rate": repr(config.speaking_rate),
        "sampling_rate": str(config.sampling_rate),
        "use_stochastic_duration_prediction": str(config.use_stochastic_duration_prediction),
        "phonetic": "1" if config.phonetic else "0",
    }
    write_ggml(
        dest,
        vocab=tokenizer.vocab,
        add_blank=tokenizer.add_blank,
        normalize=tokenizer.normalize,
        pad_token=tokenizer.pad_token,
        unk_token=tokenizer.unk_token,
        config_kv=config_kv,
        tensors=tensors,
    )
