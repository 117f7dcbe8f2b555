"""Random parameter initialization matching a VitsConfig's shape-set.

Used by the bench (full-size MMS-shaped weights when real checkpoints aren't
on disk — the repo's .ggml artifacts are git-LFS pointers) and by
``__graft_entry__``.  Delegates shape construction to HF ``VitsModel`` when
torch is importable (guaranteed-consistent, and exercises the same load path
as a real checkpoint); otherwise falls back to a pure-numpy shape generator.
"""

from __future__ import annotations

import numpy as np

from vits_tpu_torch.config import VitsConfig


def random_params(config: VitsConfig, seed: int = 0, keep_training: bool = True) -> dict:
    try:
        return _random_params_hf(config, seed, keep_training)
    except ImportError:  # torch not available — numpy fallback
        return _random_params_numpy(config, seed, keep_training)


def _random_params_hf(config: VitsConfig, seed: int, keep_training: bool) -> dict:
    import torch
    from transformers import VitsConfig as HFVitsConfig
    from transformers import VitsModel

    from vits_tpu_torch.io.loader import load_hf_module

    torch.manual_seed(seed)
    hf_config = HFVitsConfig(
        vocab_size=config.vocab_size,
        hidden_size=config.hidden_size,
        num_hidden_layers=config.num_hidden_layers,
        num_attention_heads=config.num_attention_heads,
        window_size=config.window_size,
        ffn_dim=config.ffn_dim,
        ffn_kernel_size=config.ffn_kernel_size,
        flow_size=config.flow_size,
        spectrogram_bins=config.spectrogram_bins,
        upsample_initial_channel=config.upsample_initial_channel,
        upsample_rates=list(config.upsample_rates),
        upsample_kernel_sizes=list(config.upsample_kernel_sizes),
        resblock_kernel_sizes=list(config.resblock_kernel_sizes),
        resblock_dilation_sizes=[list(d) for d in config.resblock_dilation_sizes],
        prior_encoder_num_flows=config.prior_encoder_num_flows,
        prior_encoder_num_wavenet_layers=config.prior_encoder_num_wavenet_layers,
        posterior_encoder_num_wavenet_layers=config.posterior_encoder_num_wavenet_layers,
        duration_predictor_num_flows=config.duration_predictor_num_flows,
        duration_predictor_flow_bins=config.duration_predictor_flow_bins,
        duration_predictor_kernel_size=config.duration_predictor_kernel_size,
        duration_predictor_filter_channels=config.duration_predictor_filter_channels,
        depth_separable_channels=config.depth_separable_channels,
        depth_separable_num_layers=config.depth_separable_num_layers,
        wavenet_kernel_size=config.wavenet_kernel_size,
        wavenet_dilation_rate=config.wavenet_dilation_rate,
        num_speakers=config.num_speakers,
        speaker_embedding_size=config.speaker_embedding_size,
        use_stochastic_duration_prediction=config.use_stochastic_duration_prediction,
        sampling_rate=config.sampling_rate,
    )
    model = VitsModel(hf_config).eval()
    _, _, params = load_hf_module(model, keep_training=keep_training)
    return params


def _random_params_numpy(config: VitsConfig, seed: int, keep_training: bool) -> dict:
    """Pure-numpy shape generator (canonical layouts, see io/params.py).

    Weight values are small gaussians (benchmarking/shape-checking quality,
    not torch-matching); the shape-set mirrors the HF VitsModel state dict and
    is pinned against it by tests/test_random_init.py.
    """
    rng = np.random.default_rng(seed)
    p: dict[str, np.ndarray] = {}

    def w(name, *shape, scale=0.05):
        p[name] = (rng.standard_normal(shape) * scale).astype(np.float32)

    def b(name, dim):
        p[name] = np.zeros(dim, np.float32)

    def ln(name, dim):
        p[name + ".weight"] = np.ones(dim, np.float32)
        p[name + ".bias"] = np.zeros(dim, np.float32)

    def conv(name, k, cin, cout, bias=True):
        w(name + ".weight", k, cin, cout)
        if bias:
            b(name + ".bias", cout)

    H = config.hidden_size
    flow = config.flow_size
    emb = config.speaker_embedding_size

    def conv_dds(prefix):
        dk = config.duration_predictor_kernel_size
        for i in range(config.depth_separable_num_layers):
            conv(f"{prefix}.convs_dilated.{i}", dk, 1, H)
            conv(f"{prefix}.convs_pointwise.{i}", 1, H, H)
            ln(f"{prefix}.norms_1.{i}", H)
            ln(f"{prefix}.norms_2.{i}", H)

    def wavenet(prefix, num_layers):
        k = config.wavenet_kernel_size
        for j in range(num_layers):
            conv(f"{prefix}.in_layers.{j}", k, H, 2 * H)
            out = 2 * H if j < num_layers - 1 else H
            conv(f"{prefix}.res_skip_layers.{j}", 1, H, out)
        if emb:
            conv(f"{prefix}.cond_layer", 1, emb, 2 * H * num_layers)

    # ---- text encoder ---------------------------------------------------- #
    w("text_encoder.embed_tokens.weight", config.vocab_size, H, scale=0.02)
    for i in range(config.num_hidden_layers):
        base = f"text_encoder.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            w(f"{base}.attention.{proj}.weight", H, H)
            b(f"{base}.attention.{proj}.bias", H)
        if config.window_size:
            w(f"{base}.attention.emb_rel_k", 1, 2 * config.window_size + 1, config.head_dim)
            w(f"{base}.attention.emb_rel_v", 1, 2 * config.window_size + 1, config.head_dim)
        ln(f"{base}.layer_norm", H)
        ln(f"{base}.final_layer_norm", H)
        conv(f"{base}.feed_forward.conv_1", config.ffn_kernel_size, H, config.ffn_dim)
        conv(f"{base}.feed_forward.conv_2", config.ffn_kernel_size, config.ffn_dim, H)
    conv("text_encoder.project", 1, H, 2 * flow)

    # ---- duration predictor ---------------------------------------------- #
    if config.use_stochastic_duration_prediction:
        dsc = config.depth_separable_channels
        half = dsc // 2
        nb = config.duration_predictor_flow_bins

        def sdp_flows(prefix):
            p[f"{prefix}.0.translate"] = np.zeros((dsc, 1), np.float32)
            p[f"{prefix}.0.log_scale"] = np.zeros((dsc, 1), np.float32)
            for i in range(1, config.duration_predictor_num_flows + 1):
                conv(f"{prefix}.{i}.conv_pre", 1, half, H)
                conv(f"{prefix}.{i}.conv_proj", 1, H, half * (nb * 3 - 1))
                conv_dds(f"{prefix}.{i}.conv_dds")

        conv("duration_predictor.conv_pre", 1, H, H)
        conv("duration_predictor.conv_proj", 1, H, H)
        conv_dds("duration_predictor.conv_dds")
        sdp_flows("duration_predictor.flows")
        if emb:
            conv("duration_predictor.cond", 1, emb, H)
        if keep_training:
            conv("duration_predictor.post_conv_pre", 1, 1, H)
            conv("duration_predictor.post_conv_proj", 1, H, H)
            conv_dds("duration_predictor.post_conv_dds")
            sdp_flows("duration_predictor.post_flows")
    else:
        filt = config.duration_predictor_filter_channels
        dk = config.duration_predictor_kernel_size
        conv("duration_predictor.conv_1", dk, H, filt)
        ln("duration_predictor.norm_1", filt)
        conv("duration_predictor.conv_2", dk, filt, filt)
        ln("duration_predictor.norm_2", filt)
        conv("duration_predictor.proj", 1, filt, 1)
        if emb:
            conv("duration_predictor.cond", 1, emb, H)

    # ---- residual coupling flow ------------------------------------------ #
    for i in range(config.prior_encoder_num_flows):
        base = f"flow.flows.{i}"
        conv(f"{base}.conv_pre", 1, flow // 2, H)
        conv(f"{base}.conv_post", 1, H, flow // 2)
        wavenet(f"{base}.wavenet", config.prior_encoder_num_wavenet_layers)

    # ---- HiFiGAN decoder -------------------------------------------------- #
    up0 = config.upsample_initial_channel
    conv("decoder.conv_pre", 7, flow, up0)
    channels = up0
    num_kernels = len(config.resblock_kernel_sizes)
    for i, (rate, ksize) in enumerate(
        zip(config.upsample_rates, config.upsample_kernel_sizes)
    ):
        conv(f"decoder.upsampler.{i}", ksize, channels, channels // 2)
        channels //= 2
        for j, rk in enumerate(config.resblock_kernel_sizes):
            base = f"decoder.resblocks.{i * num_kernels + j}"
            for d in range(len(config.resblock_dilation_sizes[j])):
                conv(f"{base}.convs1.{d}", rk, channels, channels)
                conv(f"{base}.convs2.{d}", rk, channels, channels)
    conv("decoder.conv_post", 7, channels, 1, bias=False)
    if emb:
        conv("decoder.cond", 1, emb, up0)

    # ---- posterior encoder (training) ------------------------------------- #
    if keep_training:
        conv("posterior_encoder.conv_pre", 1, config.spectrogram_bins, H)
        wavenet("posterior_encoder.wavenet", config.posterior_encoder_num_wavenet_layers)
        conv("posterior_encoder.conv_proj", 1, H, 2 * flow)

    if config.num_speakers > 1:
        w("embed_speaker.weight", config.num_speakers, emb, scale=0.02)
    return p
