"""Model configuration for TPU-native VITS.

The reference stores hyperparameters as an untyped string->string KV map inside the
checkpoint (HF ``config.to_diff_dict()``, see reference/scripts/export_vits.py:30-38)
and parses values lazily (reference/src/vits.cpp:33-110).  Here the config is a
typed frozen dataclass: every key the reference consumes (survey of
reference/src/vits.cpp:246-254,453-457,523,585-595,648-649,858-861,930,977-993 and
reference/src/vits_model_data.cpp:92-94) is a field with the MMS-TTS default, and
``VitsConfig.from_kv`` reconstructs a config from the reference's serialized KV block.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Sequence


def _parse_value(raw: str, target_type: Any):
    """Parse one string value from the reference's KV config block."""
    if target_type is bool:
        return raw in ("True", "true", "1")
    if target_type is int:
        return int(raw)
    if target_type is float:
        return float(raw)
    if target_type is str:
        return raw
    # list / nested list fields, serialized with Python repr by export_vits.py
    return ast.literal_eval(raw)


@dataclass(frozen=True)
class VitsConfig:
    """Architecture + inference hyperparameters for a VITS / MMS-TTS model.

    Field names and defaults follow the HF ``VitsConfig`` for facebook/mms-tts-*
    so that checkpoints round-trip without translation.
    """

    vocab_size: int = 38
    hidden_size: int = 192
    num_hidden_layers: int = 6
    num_attention_heads: int = 2
    window_size: int = 4
    use_bias: bool = True
    ffn_dim: int = 768
    ffn_kernel_size: int = 3
    flow_size: int = 192
    spectrogram_bins: int = 513
    hidden_act: str = "relu"
    layer_norm_eps: float = 1e-5

    use_stochastic_duration_prediction: bool = True
    num_speakers: int = 1
    speaker_embedding_size: int = 0

    # HiFiGAN vocoder
    upsample_initial_channel: int = 512
    upsample_rates: tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: tuple[int, ...] = (16, 16, 4, 4)
    resblock_kernel_sizes: tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: tuple[tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    leaky_relu_slope: float = 0.1

    # Stochastic duration predictor
    depth_separable_channels: int = 2
    depth_separable_num_layers: int = 3
    duration_predictor_flow_bins: int = 10
    duration_predictor_tail_bound: float = 5.0
    duration_predictor_kernel_size: int = 3
    duration_predictor_num_flows: int = 4
    duration_predictor_filter_channels: int = 256

    # Flows / WaveNet
    prior_encoder_num_flows: int = 4
    prior_encoder_num_wavenet_layers: int = 4
    posterior_encoder_num_wavenet_layers: int = 16
    wavenet_kernel_size: int = 5
    wavenet_dilation_rate: int = 1

    # Synthesis controls
    speaking_rate: float = 1.0
    noise_scale: float = 0.667
    noise_scale_duration: float = 0.8
    sampling_rate: int = 16000

    # Tokenizer-adjacent flag carried in reference checkpoints
    # (reference/src/vits_model_data.cpp:92-94)
    phonetic: bool = False

    pad_token_id: int = 0

    @property
    def total_upsample(self) -> int:
        """Samples of audio per latent frame (256 for MMS-TTS)."""
        out = 1
        for r in self.upsample_rates:
            out *= r
        return out

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def from_kv(cls, kv: Mapping[str, str]) -> "VitsConfig":
        """Build a config from the reference checkpoint's string KV map.

        Mirrors load_param/load_number/load_float/load_vector in
        reference/src/vits.cpp:33-110 but eagerly and with types.
        Unknown keys are ignored (the HF diff-dict includes extra keys such as
        dropout rates that inference does not use).
        """
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs: dict[str, Any] = {}
        hints = {f.name: f.type for f in dataclasses.fields(cls)}
        for key, raw in kv.items():
            if key not in fields:
                continue
            default = fields[key].default
            target: Any = type(default) if default is not dataclasses.MISSING else str
            hint = str(hints[key])
            if "tuple" in hint and "tuple[tuple" not in hint and "Tuple[Tuple" not in hint:
                val = tuple(_parse_value(raw, list))
            elif "tuple[tuple" in hint or "Tuple[Tuple" in hint:
                val = tuple(tuple(v) for v in _parse_value(raw, list))
            else:
                val = _parse_value(raw, target)
            kwargs[key] = val
        return cls(**kwargs)

    @classmethod
    def from_hf(cls, hf_config: Any) -> "VitsConfig":
        """Build from a HF ``transformers.VitsConfig`` instance (duck-typed)."""
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for name in fields:
            if hasattr(hf_config, name):
                val = getattr(hf_config, name)
                if isinstance(val, list):
                    val = tuple(tuple(v) if isinstance(v, list) else v for v in val)
                kwargs[name] = val
        if kwargs.get("pad_token_id") is None:
            kwargs["pad_token_id"] = 0
        return cls(**kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "VitsConfig":
        data = json.loads(text)
        for key in ("upsample_rates", "upsample_kernel_sizes", "resblock_kernel_sizes"):
            if key in data:
                data[key] = tuple(data[key])
        if "resblock_dilation_sizes" in data:
            data["resblock_dilation_sizes"] = tuple(
                tuple(v) for v in data["resblock_dilation_sizes"]
            )
        return cls(**data)


@dataclass(frozen=True)
class EngineConfig:
    """Runtime/engine knobs: static-shape bucketing, dtype policy, batching.

    These have no counterpart in the reference (which rebuilds a dynamically
    shaped graph per utterance, reference/src/vits.cpp:1101-1164); they
    exist because XLA compiles one program per static shape.
    """

    # Token-length buckets; an utterance is padded to the smallest bucket >= its length.
    token_buckets: tuple[int, ...] = (64, 128, 256, 512)
    # Latent-frame capacity per token bucket, as a multiple of the token
    # bucket.  2.5 is the measured operating point: MMS-shaped weights predict
    # ~2.2 frames/token (round-2 TTFA investigation), so 2.0 capacity forced
    # the overflow re-dispatch ladder on ordinary utterances — the default and
    # the benches now agree (tests/test_engine.py pins redispatches == 0).
    frames_per_token: float = 2.5
    # Learn the frame capacity from overflows: when a dispatch's predicted
    # frames exceed capacity, raise the engine's working frames_per_token to
    # the observed per-token rate (rounded up to adaptive_capacity_step so the
    # set of compiled shapes stays tiny).  A checkpoint whose duration
    # distribution differs from MMS then pays the ladder at most once per
    # rate regime instead of on every utterance.
    adaptive_capacity: bool = True
    adaptive_capacity_step: float = 0.5
    # Hard ceiling on the learned frames/token ratio: real VITS checkpoints
    # sit at ~1.5-5, so anything beyond this is pathological input (e.g. a
    # noise_scale_duration bomb), not a rate regime worth compiling for.
    adaptive_capacity_max: float = 10.0
    # Per-request ceiling: ONE overflow observation may raise the working
    # ratio by at most this many frames/token (on top of the 2x-per-overflow
    # multiplicative clamp).  Repeated observations — a real traffic pattern,
    # not one slow-speech utterance — still converge on the true rate.
    adaptive_capacity_request_max: float = 2.0
    # Decay the raised ratio back when traffic stops needing it: once a full
    # window of default-control dispatches has been observed since the last
    # raise, the ratio falls to what the window's WORST request actually
    # needed (never below frames_per_token) — a one-off overflow stops being
    # a permanent FLOP/transfer tax on a long-lived serving process.
    adaptive_capacity_decay: bool = True
    adaptive_capacity_window: int = 32
    # Snap adaptive raises/decays to the overflow-ladder geometry: the
    # working capacity only ever takes values base_capacity * 2^k — exactly
    # the shapes ``warmup(overflow_ladder=N)`` pre-compiles.  With this set
    # (and the ladder warmed) NO adaptive event can trigger an XLA compile
    # mid-request; without it, step/request_max interplay can land a raise on
    # a never-warmed intermediate capacity (the 11 s serving p95 of
    # BENCH_DETAIL serving_load_r4).  The trade: capacity quantizes coarser
    # (up to 2x the observed need), costing padding FLOPs on traffic that
    # sits between rungs.  adaptive_capacity_step/request_max are ignored in
    # this mode; the 2x-per-overflow and adaptive_capacity_max clamps hold.
    adaptive_capacity_align: bool = False
    # Computation dtype for the heavy conv stacks ("float32" or "bfloat16").
    compute_dtype: str = "float32"
    # Max batch size compiled into the batched path.
    max_batch: int = 32
    # Batch-size buckets: a batch of B rows pads up to the smallest bucket
    # >= B (pad rows are masked and dropped — bit-identical outputs, the
    # batching parity invariant).  Bounds the compiled-program count under
    # serving traffic of ragged batch sizes and lets AOT bundles cover every
    # dispatch with a handful of exported batches.  None = dispatch exact B.
    batch_buckets: tuple[int, ...] | None = None
    # Route HiFiGAN resblocks through the fused Pallas kernel.
    # None = auto (enabled on TPU backends), True/False = force.
    use_pallas_vocoder: bool | None = None
    # Matmul precision inside the Pallas vocoder kernels (jax.lax.Precision
    # names): None = fast single-pass bf16 multiplies (fp32 accumulation —
    # same class as XLA's DEFAULT conv precision); "high" = 3-pass bf16x3;
    # "highest" = 6-pass fp32-exact.  NOTE "float32" is accepted by jax but
    # aliases HIGHEST (6-pass), not the 3-pass tier.
    pallas_precision: str | None = None
    # VMEM *value* dtype inside the fused vocoder kernels ("float32" or
    # "bfloat16").  None = auto: bfloat16 unless pallas_precision is
    # "highest" (exact-parity mode needs fp32 values).  bf16 values halve
    # the window/weight VMEM traffic and the sublane-relayout bytes between
    # shift-matmuls; accumulation stays fp32 on the MXU either way.
    pallas_value_dtype: str | None = None
    # Packed-weight storage format for the fused vocoder kernels
    # ("float32" | "bfloat16" | "int8").  None = auto: "int8" when the
    # loaded params are int8-quantized (io/quantize.py), else follows the
    # resolved value dtype.  int8 packed weights ride HBM->VMEM at 1
    # byte/entry and are dequantized on the fp32 accumulator in-kernel.
    pallas_weight_format: str | None = None
    # Route encoder self-attention through the flash-style fused kernel
    # (ops/pallas/attention.py — no quadratic HBM traffic; the XLA path
    # profiles at ~27 ms for a 2048-token encoder vs ~2 ms at 512).
    # None = auto (enabled on TPU backends), True/False = force.
    use_pallas_attention: bool | None = None
    # Route the residual-coupling flow through the fused whole-flow Pallas
    # kernel (ops/pallas/flow.py).  Default False: XLA already fuses the flow
    # to ~0.3 ms at the bench shape and the kernel measured 0.48 ms
    # (BENCH_DETAIL.json "flow_kernel") — kept as an opt-in for shapes where
    # per-op launch overhead dominates.
    use_pallas_flow: bool = False
    # Transfer waveforms device->host as int16 PCM (the final WAV format;
    # halves transfer bytes, quantization error 1/32767 ~ 3e-5).
    transfer_int16: bool = True
    # XLA matmul/conv precision for the NON-kernel ("glue") parts of the
    # dispatch — encoder, duration predictor, flow — via
    # jax.default_matmul_precision at trace time.  None = backend default
    # (bf16 multiplies on TPU).  "highest" runs those modules fp32-exact;
    # they are a small fraction of dispatch FLOPs (the vocoder dominates),
    # so this buys glue exactness cheaply while the fused vocoder kernels
    # keep their own pallas_precision/value-dtype policy.  Fidelity table:
    # BENCH_DETAIL value_dtype_fidelity* (glue32 rows).
    matmul_precision: str | None = None
    # Kernel library directory (ops/cuda::use_build_dir): the CUDA kernels are
    # built into it once and later processes load them from it, skipping the
    # nvcc build.  None = the package's _build/.
    # NOTE the directory is process-global — the last engine constructed
    # with a non-None dir wins for the whole process.
    compilation_cache_dir: str | None = None
    # AOT bundle (io/aot.py): serve with a bundle's verified kernel library
    # and manifest — a versioned, auditable serving artifact.  Exported
    # signatures count stats["aot_hits"], others stats["aot_misses"]; both
    # run the same kernels.  None = disabled.
    aot_bundle_dir: str | None = None

    @staticmethod
    def fidelity_kwargs(tier: str) -> dict:
        """EngineConfig kwargs for a user-level fidelity tier.

        Measured on 16,000-step trained weights (BENCH_DETAIL.json
        ``value_dtype_fidelity_trained`` + ``fidelity_tiers_r4``; mel-L1
        alignment-pinned vs the fp32-multiply XLA oracle at the bench shape):

        * ``"fast"`` — the defaults: single-pass bf16 multiplies with fp32
          accumulation everywhere (the same multiply class as XLA's own TPU
          default), bf16 kernel values.  mel-L1 0.064 alignment-pinned;
          6.2 ms/dispatch.
        * ``"glue32"`` — encoder/duration/flow matmuls fp32-exact, vocoder
          kernels stay on the fast path.  Pins duration rounding (and hence
          frame alignment) to fp32 semantics: use when outputs must line up
          frame-for-frame with a CPU/fp32 deployment.  Same 0.064 vocoder
          error; 7.2 ms/dispatch (+15%).
        * ``"high"`` — glue32 plus 3-pass bf16x3 vocoder multiplies with
          fp32 values/weights: mel-L1 **2.9e-4 — under the 1e-3 BASELINE
          target** at 18.5 ms/dispatch, the recommended verification tier
          (42% cheaper than exact).
        * ``"exact"`` — glue32 plus 6-pass fp32-exact vocoder kernels:
          mel-L1 3.6e-5 at 32.1 ms/dispatch — for bit-level debugging
          against fp32 deployments; ``high`` already meets the target.

        ``pallas_precision`` also accepts per-vocoder-stage comma specs
        ("high,high,highest,highest", ops/precision.py) — the measured
        per-stage frontier is BENCH_DETAIL ``stage_precision_r5``: uniform
        ``high`` is the cheapest <1e-3 configuration (every stage at
        single-pass costs >=1.7e-3 alone), and the one useful mixed point
        is ``"high,high,highest,highest"`` (8.2e-5 at ~half the
        high-to-exact cost gap).
        """
        tiers = {
            "fast": {},
            "glue32": {"matmul_precision": "highest"},
            "high": {"matmul_precision": "highest",
                     "pallas_precision": "high",
                     "pallas_value_dtype": "float32",
                     "pallas_weight_format": "float32"},
            "exact": {"matmul_precision": "highest",
                      "pallas_precision": "highest",
                      "pallas_value_dtype": "float32",
                      "pallas_weight_format": "float32"},
        }
        if tier not in tiers:
            raise ValueError(
                f"unknown fidelity tier {tier!r}; pick from {sorted(tiers)}")
        return dict(tiers[tier])

    def frame_bucket(self, token_bucket: int, ratio: float | None = None) -> int:
        """Frame capacity for a token bucket; ``ratio`` overrides the static
        frames_per_token (the engine passes its adaptively-raised ratio)."""
        frames = int(token_bucket * (self.frames_per_token if ratio is None else ratio))
        # Round to a multiple of 8 so the time axis tiles the VPU sublanes.
        return ((frames + 7) // 8) * 8
