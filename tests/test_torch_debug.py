"""The port's debug toolkit (``vits_tpu_torch/utils/debug.py``), as
``tests/test_checkpoint_debug.py`` holds the JAX package's.

The port's stage tensors equal the JAX package's ``debug.stage_outputs`` on one
``NoiseOverride`` of the tiny fixture at fp32 (1e-4); the save / load /
compare round trip, the shape and prefix assertions, the timer and the
profiler trace.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.models.vits import NoiseOverride as JaxNoiseOverride
from vits_tpu.utils import debug as jax_debug
from vits_tpu_torch.io.params import from_jax_params
from vits_tpu_torch.models.vits import NoiseOverride
from vits_tpu_torch.utils import debug

torch.set_num_threads(2)

GGML = "tests/fixtures/tiny-vits.ggml"
ATOL = 1e-4


@pytest.fixture(scope="module")
def stages_of_both():
    config, tok, params = jax_load_ggml(GGML)
    ids, mask = tok.pad([tok.encode(t) for t in ("hello world", "hi")], pad_to=32)
    rng = np.random.default_rng(4)
    dur = rng.standard_normal((2, 32, 2)).astype(np.float32)
    prior = rng.standard_normal((2, 64, config.flow_size)).astype(np.float32)
    want = jax_debug.stage_outputs(params, config, ids, mask, 64,
                                   noise=JaxNoiseOverride(jnp.asarray(dur), jnp.asarray(prior)))
    from vits_tpu_torch.config import VitsConfig
    import dataclasses

    got = debug.stage_outputs(from_jax_params(params, "cpu"),
                              VitsConfig(**dataclasses.asdict(config)), ids, mask, 64,
                              noise=NoiseOverride(torch.tensor(dur), torch.tensor(prior)))
    return got, want


def test_stage_outputs_match_jax_stage_outputs(stages_of_both):
    got, want = stages_of_both
    assert set(got) == set(want)
    report = debug.compare_stages(got, {k: np.asarray(v) for k, v in want.items()}, atol=ATOL)
    assert set(report) == set(want)
    np.testing.assert_array_equal(got["lengths"], np.asarray(want["lengths"]))


def test_stage_dump_compare_roundtrip(tmp_path, stages_of_both):
    stages, _ = stages_of_both
    d = str(tmp_path / "stages")
    debug.save_stages(d, stages)
    with open(os.path.join(d, "shapes.json")) as f:
        assert json.load(f) == {k: list(v.shape) for k, v in stages.items()}
    loaded = debug.load_stages(d)
    report = debug.compare_stages(stages, loaded, atol=0)
    assert set(report) == set(stages) and all(v == 0.0 for v in report.values())
    loaded["latents"] = loaded["latents"] + 1.0  # a perturbed stage must fail
    with pytest.raises(AssertionError, match="latents"):
        debug.compare_stages(stages, loaded, atol=1e-3)
    loaded["waveform"] = loaded["waveform"][:, :-1]
    with pytest.raises(AssertionError, match="waveform: shape"):
        debug.compare_stages(stages, loaded, names=["waveform"])


def test_stage_outputs_at_bf16_are_host_fp32():
    """compute_dtype="bfloat16" casts the parameters, the mask and the noise as the
    engine does; the stages come back as fp32 numpy."""
    config, tok, params = jax_load_ggml(GGML)
    from vits_tpu_torch.config import VitsConfig
    import dataclasses

    ids, mask = tok.pad([tok.encode("hello")], pad_to=32)
    rng = np.random.default_rng(1)
    noise = NoiseOverride(torch.tensor(rng.standard_normal((1, 32, 2)), dtype=torch.float32),
                          torch.tensor(rng.standard_normal((1, 64, config.flow_size)),
                                       dtype=torch.float32))
    stages = debug.stage_outputs(from_jax_params(params, "cpu"),
                                 VitsConfig(**dataclasses.asdict(config)), ids, mask, 64,
                                 noise=noise, compute_dtype="bfloat16")
    assert all(v.dtype == np.float32 for k, v in stages.items() if k != "lengths")
    debug.assert_shape(stages["waveform"], 1, 64 * config.total_upsample)
    assert np.isfinite(stages["waveform"]).all()


def test_assert_shape_and_prefix():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    debug.assert_shape(x, 3, 4)
    debug.assert_shape(x, None, 4)
    with pytest.raises(AssertionError):
        debug.assert_shape(x, 4, 3)
    debug.assert_starts_with(x, 0.0, 1.0, 2.0)
    debug.assert_starts_with(torch.tensor(x).to(torch.bfloat16), 0.0, 1.0, 2.0)
    with pytest.raises(AssertionError):
        debug.assert_starts_with(x, 5.0, 1.0)


def test_stage_timer_and_torch_trace(tmp_path):
    lines = []
    with debug.stage_timer("matmul", log=lines.append):
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert len(lines) == 1 and "matmul" in lines[0] and lines[0].endswith(" ms")
    with debug.torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
