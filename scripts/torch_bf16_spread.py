#!/usr/bin/env python3
"""How far bf16 serving's results spread between implementations of one graph.

    python3 scripts/torch_bf16_spread.py           # the CPU: the port against JAX
    python3 scripts/torch_bf16_spread.py --card    # one NVIDIA GPU: the card against the CPU

CPU (needs the JAX package): the tiny fixture (``tests/fixtures/tiny-vits.ggml``),
two texts at a 32-token bucket and 160 frames, one seeded ``NoiseOverride``;
the port's bf16 engine (``EngineConfig(compute_dtype="bfloat16")``) against the
JAX package's bf16 engine run eagerly (``jax.disable_jit()``) and jitted, and
against its fp32 engine: the frame counts of each, and per stage (text
encoder, prior means, log durations, latents, waveform) the max |diff| of
port - eager, port - jit, eager - jit, and the bf16-versus-fp32 gap (jit fp32
- jit bf16).

Card: (1) each bf16 op the text side runs (matmul, a k=3 conv, a depthwise
conv, layer norm, the activations, the spline) on seeded inputs, on the card
and on the CPU: the share of outputs that differ and the max |diff|; (2) MMS
at full width (random weights, seed 0), the 87-token text of ``chip_smoke.py``
at bf16: the text encoder's output card against CPU (share differing, max
|diff|), the duration predictor's log durations card against CPU, and the
card's duration predictor on the CPU's encoder output against the CPU's, and
the frame counts.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

FIXTURE = "tests/fixtures/tiny-vits.ggml"
FRAMES = 160


def cpu_spread() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from vits_tpu.config import EngineConfig as JaxEngineConfig
    from vits_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
    from vits_tpu.io.loader import load_ggml
    from vits_tpu.io.params import ParamView as JaxParamView
    from vits_tpu.models import vits as jax_vits
    from vits_tpu.models.encoder import text_encoder as jax_text_encoder
    from vits_tpu_torch.config import EngineConfig, VitsConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.models.vits import NoiseOverride
    from vits_tpu_torch.utils import debug

    config, tok, params = load_ggml(FIXTURE)
    rng = np.random.default_rng(3)
    ids, mask = tok.pad([tok.encode(t) for t in ("hello world", "the quick fox")], pad_to=32)
    dur = rng.standard_normal((2, 32, 2)).astype(np.float32)
    prior = rng.standard_normal((2, FRAMES, config.flow_size)).astype(np.float32)

    def jax_run(dtype: str, jit: bool) -> dict:
        ref = JaxSynthesizer(config, tok, params, JaxEngineConfig(compute_dtype=dtype,
                                                                  use_pallas_vocoder=False))
        cd = ref.compute_dtype

        def run(p, i, m, d, pr):
            enc = jax_text_encoder(JaxParamView(p), ref.config, i, m[..., None], m)
            out = jax_vits.synthesize(p, ref.config, i, m, FRAMES,
                                      noise=jax_vits.NoiseOverride(d, pr))
            return enc, out
        args = (ref.params, jnp.asarray(ids), jnp.asarray(mask, cd), jnp.asarray(dur, cd),
                jnp.asarray(prior, cd))
        if jit:
            enc, out = jax.jit(run)(*args)
        else:
            with jax.disable_jit():
                enc, out = run(*args)
        f = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
        return {"text_encoder_output": f(enc.last_hidden_state), "prior_means": f(enc.prior_means),
                "log_duration": f(out.log_duration), "latents": f(out.latents),
                "waveform": f(out.waveform), "frames": np.asarray(out.frame_lengths)}

    port = Synthesizer(VitsConfig(**dataclasses.asdict(config)), tok, params,
                       EngineConfig(compute_dtype="bfloat16"), device="cpu")
    got = debug.stage_outputs(port.params, port.config, ids, mask, FRAMES,
                              compute_dtype="bfloat16", tiers=port.tiers,
                              noise=NoiseOverride(torch.tensor(dur), torch.tensor(prior)))
    got["frames"] = got["lengths"] // config.total_upsample
    eager, jitted, fp32 = jax_run("bfloat16", False), jax_run("bfloat16", True), jax_run(
        "float32", True)
    clamp = lambda a: np.minimum(a, FRAMES).tolist()  # noqa: E731
    print(f"frames (at most the {FRAMES}-frame capacity): port", got["frames"].tolist(), "eager",
          clamp(eager["frames"]), "jit", clamp(jitted["frames"]), "fp32", clamp(fp32["frames"]))
    for name in ("text_encoder_output", "prior_means", "log_duration", "latents", "waveform"):
        d = lambda a, b: float(np.abs(a[name] - b[name]).max())  # noqa: E731
        print(f"{name:20s} port-eager {d(got, eager):.4g}  port-jit {d(got, jitted):.4g}  "
              f"eager-jit {d(eager, jitted):.4g}  gap (fp32 - bf16, jit) {d(fp32, jitted):.4g}")


def card_spread() -> None:
    import chip_smoke as cs
    from vits_tpu_torch import EngineConfig
    from vits_tpu_torch.io.params import ParamView
    from vits_tpu_torch.models.duration import stochastic_duration_predictor_reverse
    from vits_tpu_torch.models.encoder import text_encoder
    from vits_tpu_torch.ops import conv as C
    from vits_tpu_torch.ops.spline import unconstrained_rational_quadratic_spline

    dev, bf = torch.device("cuda"), torch.bfloat16
    torch.manual_seed(0)

    def compare(name, fn, *args):
        a = fn(*[x.to(dev) for x in args])
        b = fn(*[x.cpu() for x in args])
        a, b = (a[0] if isinstance(a, tuple) else a), (b[0] if isinstance(b, tuple) else b)
        a, b = a.float().cpu(), b.float()
        print(f"  {name:22s} share differing {float((a != b).float().mean()):.5f}  max|diff| "
              f"{float((a - b).abs().max()):.3e}")

    print("bf16 ops, card against the CPU:")
    x = torch.randn(2, 64, 192).to(bf)
    w = (torch.randn(192, 192) * 0.1).to(bf)
    compare("matmul 192x192", lambda a, b: a @ b, x, w)
    compare("conv1d k=3 192->768", lambda a, b: C.conv1d(a, b, None, padding=1), x,
            (torch.randn(3, 192, 768) * 0.1).to(bf))
    compare("depthwise k=3 d=3", lambda a, b: C.depthwise_conv1d(a, b, None, padding=3,
                                                                 dilation=3),
            x, (torch.randn(3, 1, 192) * 0.3).to(bf))
    lw = torch.randn(192).to(bf)
    compare("layer_norm", lambda a, b: C.layer_norm(a, b, b), x, lw)
    for name, fn in (("gelu", C.gelu), ("softplus", C.softplus), ("sigmoid", C.sigmoid),
                     ("softmax", C.softmax), ("exp", torch.exp), ("tanh", torch.tanh)):
        compare(name, fn, x)
    u = torch.randn(2, 64, 1).to(bf)
    compare("spline (reverse)", lambda a, b, c, d: unconstrained_rational_quadratic_spline(
        a, b, c, d, reverse=True, tail_bound=5.0), u, torch.randn(2, 64, 1, 10).to(bf),
        torch.randn(2, 64, 1, 10).to(bf), torch.randn(2, 64, 1, 9).to(bf))

    model = cs.make_model(dev, engine_config=EngineConfig(compute_dtype="bfloat16"))
    tok, config = model.tokenizer, model.config
    ids, mask = tok.pad([tok.encode(cs.SINGLE_TEXTS[1])], pad_to=128)
    dur = torch.tensor(np.random.default_rng(2).standard_normal((1, 128, 2)),
                       dtype=torch.float32).to(bf)
    cpu_params = {k: v.cpu() for k, v in model.params.items()}
    res = {}
    with torch.inference_mode():
        for d, params in ((dev, model.params), (torch.device("cpu"), cpu_params)):
            m = torch.tensor(mask, device=d).to(bf)[..., None]
            enc = text_encoder(ParamView(params), config,
                               torch.tensor(ids, dtype=torch.long, device=d), m,
                               tier=model.tiers.attention)
            ld = stochastic_duration_predictor_reverse(ParamView(params), config,
                                                       enc.last_hidden_state, m, dur.to(d),
                                                       config.noise_scale_duration)
            res[d.type] = (enc.last_hidden_state.float().cpu(), ld.float().cpu())
        hc = res["cpu"][0]
        m = torch.tensor(mask, device=dev).to(bf)[..., None]
        cross = stochastic_duration_predictor_reverse(
            ParamView(model.params), config, hc.to(dev).to(bf), m, dur.to(dev),
            config.noise_scale_duration).float().cpu()
    (he, le), (_, lc) = res["cuda"], res["cpu"]
    frames = [float(torch.ceil(torch.exp(t[0, :, 0]) * torch.tensor(mask[0])).sum())
              for t in (le, lc)]
    print(f"MMS, the {int(mask.sum())}-token text at bf16, card against the CPU: text encoder "
          f"share differing {float((he != hc).float().mean()):.4f}, max|diff| "
          f"{float((he - hc).abs().max()):.3e}; log durations max|diff| "
          f"{float((le - lc).abs().max()):.3e}; the card's duration predictor on the CPU's "
          f"encoder output {float((cross - lc).abs().max()):.3e}; frames {frames}")


if __name__ == "__main__":
    card_spread() if sys.argv[1:] == ["--card"] else cpu_spread()
