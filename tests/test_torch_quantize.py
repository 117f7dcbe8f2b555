"""Int8 weights in the port: the quantize copy, the loader, the packs, the engine.

``vits_tpu_torch/io/quantize.py`` is a copy of the JAX module (without its
unused jax import): its round trips must match the original array for array.
``from_jax_params`` keeps int8 weights beside their ``.scale`` rows,
``ParamView`` dequantizes them on access as the JAX ``ParamView`` does, and
the engine dequantizes them once. The vocoder packs of kernels B and C
(``models/hifigan.py::precompute_vocoder_packs``) hold the same int8 values
and scales as the JAX packs. The engine on ``quantize_params(fixture)``
matches the JAX engine at each fidelity tier, with the bounds of
``tests/test_torch_precision.py``.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from tests.test_torch_precision import ENGINE_TIERS, engine_parity, fixture_inputs
from vits_tpu.io import quantize as jax_quantize
from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.io.random_init import random_params
from vits_tpu.models.hifigan import PACK_PREFIX
from vits_tpu.models.hifigan import precompute_vocoder_packs as jax_precompute_vocoder_packs
from vits_tpu_torch.config import EngineConfig, VitsConfig
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.io import quantize
from vits_tpu_torch.io.loader import export_to_ggml, load_ggml
from vits_tpu_torch.io.params import ParamView, dequantize_tensors, from_jax_params
from vits_tpu_torch.models.hifigan import precompute_vocoder_packs

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny-vits.ggml")


@pytest.fixture(scope="module")
def fixture_bundle():
    return load_ggml(FIXTURE)


def test_quantize_round_trips_match_jax(fixture_bundle):
    """quantize_params / dequantize_params / quantization_error: the port's copy
    gives the JAX module's arrays, bit for bit."""
    _, _, params = fixture_bundle
    ours, theirs = quantize.quantize_params(params), jax_quantize.quantize_params(params)
    assert ours.keys() == theirs.keys() and any(v.dtype == np.int8 for v in ours.values())
    for name, value in theirs.items():
        assert ours[name].dtype == value.dtype
        np.testing.assert_array_equal(ours[name], value)
    back, jax_back = quantize.dequantize_params(ours), jax_quantize.dequantize_params(theirs)
    assert back.keys() == params.keys()
    for name, value in jax_back.items():
        np.testing.assert_array_equal(back[name], value)
    assert quantize.quantization_error(params) == jax_quantize.quantization_error(params)


def test_from_jax_params_keeps_int8(fixture_bundle):
    """int8 weights stay int8 on the device with their fp32 scales; ParamView
    reads them dequantized, dequantize_tensors dequantizes them once, both the
    values of dequantize_params."""
    _, _, params = fixture_bundle
    qparams = quantize.quantize_params(params)
    tensors = from_jax_params(qparams, "cpu")
    assert tensors.keys() == qparams.keys()
    quantized = [n for n, v in qparams.items() if v.dtype == np.int8]
    assert quantized and all(tensors[n].dtype == torch.int8 for n in quantized)
    want = quantize.dequantize_params(qparams)
    view, once = ParamView(tensors), dequantize_tensors(tensors)
    assert once.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_array_equal(view[name].numpy(), value)
        np.testing.assert_array_equal(once[name].numpy(), value)
    with pytest.raises(ValueError, match="scale"):
        from_jax_params({"w.weight": np.ones((2, 2), np.int8)}, "cpu")


def test_int8_ggml_through_the_loader_and_the_engine(fixture_bundle):
    """An int8 .ggml (dtype code 2) goes through the port's loader,
    from_jax_params and the engine, which synthesizes what it synthesizes
    from the dequantized parameters."""
    config, tokenizer, params = fixture_bundle
    qparams = quantize.quantize_params(params)
    buf = io.BytesIO()
    export_to_ggml(buf, config, tokenizer, qparams, fp16_convs=False)
    config2, tokenizer2, loaded = load_ggml(buf.getvalue())
    assert {n for n, v in loaded.items() if v.dtype == np.int8} == {
        n for n, v in qparams.items() if v.dtype == np.int8}
    jax_loaded = jax_load_ggml(buf.getvalue())[2]
    for name, value in jax_loaded.items():
        np.testing.assert_array_equal(loaded[name], value)
    engine = Synthesizer(config2, tokenizer2, loaded, EngineConfig(), device="cpu")
    plain = Synthesizer(config, tokenizer, quantize.dequantize_params(qparams), EngineConfig(),
                        device="cpu")
    np.testing.assert_array_equal(engine.synthesize("hello world", seed=2),
                                  plain.synthesize("hello world", seed=2))


@pytest.mark.parametrize("weight_format", ["int8", "bfloat16"])
def test_vocoder_packs_match_jax_packs(weight_format):
    """The wide stage's trio packs (int8 values and per-(pair, out-channel)
    scales, or bf16) and its bf16 upsampler equal the JAX packs; the stage
    kernel stages' scales are the JAX packs' (tiled over their packed slots;
    their int8 values are held in tests/test_torch_precision.py)."""
    from tests.test_torch_slice_kernels import KERNEL_SHAPED

    params = jax_quantize.quantize_params(random_params(KERNEL_SHAPED, seed=0,
                                                        keep_training=False))
    jax_packs = jax_precompute_vocoder_packs(JaxParamView(params), KERNEL_SHAPED,
                                             weight_format=weight_format)
    port = precompute_vocoder_packs(ParamView(from_jax_params(params, "cpu")),
                                    VitsConfig(**dataclasses.asdict(KERNEL_SHAPED)),
                                    weight_format)
    assert sorted(port) == [0, 1, 2]

    def jax(i, name):
        return np.asarray(jax_packs[f"{PACK_PREFIX}.{i}.{name}"]).astype(np.float32)

    for j, blk in enumerate(port[0]["blocks"]):
        for name in ("w1", "w2", "b1", "b2") + (("s1", "s2") if weight_format == "int8" else ()):
            np.testing.assert_array_equal(blk[name].float().numpy(), jax(0, f"rb{j}.{name}"),
                                          err_msg=f"rb{j}.{name}")
    np.testing.assert_array_equal(port[0]["up_w"].float().numpy(), jax(0, "up_w"))
    if weight_format == "int8":
        for i, c_out in ((1, 64), (2, 32)):
            g_out = 128 // c_out
            np.testing.assert_array_equal(jax(i, "su")[0], np.tile(port[i]["su"].numpy(), g_out))
            s1 = np.concatenate([b["s1"].numpy() for b in port[i]["blocks"]])
            np.testing.assert_array_equal(jax(i, "s1"), np.tile(s1, (1, g_out)))
        np.testing.assert_array_equal(jax(2, "sq")[0], np.tile(port[2]["post"][2].numpy(), 4))


@pytest.mark.parametrize("tier", ENGINE_TIERS)
def test_int8_engine_tiers_match_jax_engine(tier, fixture_bundle):
    """quantize_params(fixture) at each tier, port engine against JAX engine."""
    _, tokenizer, params = fixture_bundle
    config = jax_load_ggml(FIXTURE)[0]
    port = engine_parity(config, quantize.quantize_params(params), tier,
                         *fixture_inputs(tokenizer))
    assert port._weight_format == ("int8" if tier in ("fast", "glue32") else "float32")


def test_int8_engine_fast_tier_on_every_vocoder_kernel():
    """A quantized checkpoint's fast tier where the vocoder takes kernels B and
    C: int8 packs (scales on every conv's sum), the bf16 carry."""
    from tests.test_torch_slice_kernels import KERNEL_SHAPED, _inputs

    params = jax_quantize.quantize_params(random_params(KERNEL_SHAPED, seed=0,
                                                        keep_training=False))
    ids, mask, dur, prior = _inputs(KERNEL_SHAPED, 1, lengths=(12, 3), num_frames=16)
    port = engine_parity(KERNEL_SHAPED, params, "fast", ids, mask, dur, prior, 16)
    packs = port._vocoder_packs()
    assert packs[0]["blocks"][0]["w1"].dtype == torch.int8 and packs[1]["up_w"].dtype == torch.int8
    assert packs[2]["post"][0].dtype == torch.int8
