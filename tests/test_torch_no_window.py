"""The port at ``window_size`` 0 (attention with no relative window) against the JAX package.

A model without a relative window has no ``emb_rel_k`` / ``emb_rel_v``; JAX's
encoder then runs its plain path -- scores, the additive key-padding bias,
softmax and the value product (``vits_tpu/models/encoder.py:82-110``) -- for
serving and for training, outside any Pallas kernel, and so does the port's
(``rel_attention_reference`` without tables, no kernel on any device). The
model here is ``tiny_bundle`` with ``window_size`` 0 and its tables dropped;
every input is a seeded numpy draw, CPU on both sides.

Tolerances, and why:

* the encoder in fp32 (inference and ``trainable=True``):
  ``test_torch_modules.py``'s atol 1e-5 relative to max(1, |ref|); its
  gradients by ``test_torch_train_step.py``'s relative L2 2e-4 per tensor
  (fp32 summation-order noise);
* the encoder in bf16 (bf16 parameters and masks, as both engines and bf16
  training feed it) against JAX run eagerly (``jax.disable_jit()``, which
  rounds after every op as the port does): each output within GAP_FRACTION
  of JAX's own bf16-versus-fp32 gap, relative L2 (``test_torch_bf16_serving.py``'s
  rule: a port that computed in fp32 would sit at 1.0);
* a dispatch through ``Synthesizer`` against JAX's engine, both on one
  ``NoiseOverride``: ``test_torch_synthesis.py``'s bounds (latents atol 5e-4,
  waveform 2e-4, equal frame counts);
* one GAN step against ``make_gan_train_step``: ``test_torch_train_step.py``'s
  bounds (losses 1e-5 relative to max(1, |ref|), gradients relative L2 2e-4);
* the tensor-parallel split of the heads (two gloo ranks, ``data=1 x
  model=2``, ``tests/test_torch_dp_worker.py`` scenario ``no_window``) against
  the one-process step on the same noise: the same two bounds
  (``test_torch_tensor_parallel.py``'s: the ranks sum partial products in
  another order).
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16_serving import GAP_FRACTION
from tests.test_torch_dp_worker import (
    free_port,
    no_window_params,
    spawn,
    step_inputs,
    wait_all,
)
from tests.test_torch_tensor_parallel import _reassembled
from tests.test_torch_train_step import (
    MEL_KWARGS,
    SEGMENT,
    _assert_close,
    _assert_grad_close,
    _batch,
    _jax_noise,
    _leaves,
    _recording,
)
from vits_tpu.config import EngineConfig as JaxEngineConfig
from vits_tpu.engine import synthesizer as jax_synthesizer
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.models import encoder as jax_encoder
from vits_tpu.models import vits as jax_vits
from vits_tpu.models.discriminator import init_discriminator_params as jax_init_disc
from vits_tpu.train import step as jax_step
from vits_tpu_torch.config import EngineConfig, VitsConfig
from vits_tpu_torch.engine import synthesizer
from vits_tpu_torch.io.params import ParamView, from_jax_params
from vits_tpu_torch.models import encoder, vits
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
from vits_tpu_torch.parallel.mesh import split_plan
from vits_tpu_torch.train import step

torch.set_num_threads(2)

WAVE_ATOL, LATENT_ATOL = 2e-4, 5e-4  # test_torch_synthesis.py's
FRAMES = 40


@pytest.fixture(scope="module")
def no_window(tiny_bundle):
    """(config, params): the tiny model with window_size 0 and no relative tables."""
    config, params = tiny_bundle
    params = {k: v for k, v in params.items() if ".emb_rel_" not in k}
    assert len(params) < len(tiny_bundle[1])
    return dataclasses.replace(config, window_size=0), params


def _tokens(config, seed, lengths=(13, 6), T=13):
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)
    ids = (rng.integers(1, config.vocab_size, (len(lengths), T)) * mask).astype(np.int32)
    return ids, mask


def _encoder_params(params, dtype=None):
    sub = {k: v for k, v in params.items() if k.startswith("text_encoder.")}
    return sub if dtype is None else {k: np.asarray(v).astype(dtype) for k, v in sub.items()}


def test_encoder_without_window_matches_jax(no_window):
    config, params = no_window
    ids, mask = _tokens(config, 0)
    want = jax_encoder.text_encoder(JaxParamView(params), config, jnp.asarray(ids),
                                    jnp.asarray(mask[..., None]), jnp.asarray(mask))
    launches = flash_rel_attention.launches
    got = encoder.text_encoder(ParamView(from_jax_params(params, "cpu")), config,
                               torch.tensor(ids, dtype=torch.long), torch.tensor(mask[..., None]))
    assert flash_rel_attention.launches == launches  # no kernel A call, not even its twin
    for name, g, w in zip(encoder.EncoderOutput._fields, got, want):
        _assert_close(g, w, what=name)


@pytest.mark.parametrize("T", [13, 512])  # below and at FLASH_TRAIN_TOKENS
def test_trainable_encoder_without_window_matches_jax(no_window, T):
    """``trainable=True`` (the training step's encoder): outputs, and the gradients of
    every encoder parameter of a seeded cotangent, against ``jax.vjp``; at 512 tokens
    too, where a model with a window would take kernels A and 4."""
    config, params = no_window
    ids, mask = _tokens(config, 1, lengths=(T, T // 2 + 1), T=T)
    rng = np.random.default_rng(2)
    cot = [rng.standard_normal((2, T, n)).astype(np.float32)
           for n in (config.hidden_size, config.flow_size, config.flow_size)]
    sub = _encoder_params(params)

    def jax_fn(p):
        out = jax_encoder.text_encoder(JaxParamView(p), config, jnp.asarray(ids),
                                       jnp.asarray(mask[..., None]), jnp.asarray(mask),
                                       trainable=True)
        return sum(jnp.sum(o * c) for o, c in zip(out, cot)), out

    with jax.default_matmul_precision("highest"):
        (_, want), want_grads = jax.value_and_grad(jax_fn, has_aux=True)(
            {k: jnp.asarray(v) for k, v in sub.items()})
    leaves = _leaves(sub)
    got = encoder.text_encoder(ParamView(leaves), config, torch.tensor(ids, dtype=torch.long),
                               torch.tensor(mask[..., None]), trainable=True)
    for name, g, w in zip(encoder.EncoderOutput._fields, got, want):
        _assert_close(g.detach(), w, what=name)
    loss = sum((o * torch.tensor(c)).sum() for o, c in zip(got, cot))
    for name, g in zip(leaves, step.gradients(loss, leaves)):
        _assert_grad_close(g, want_grads[name], what=name)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("trainable", [False, True])
def test_bf16_encoder_without_window_matches_eager_jax(no_window, trainable):
    """bf16 parameters and masks (bf16 serving; bf16 training's encoder), against
    eager JAX at bf16: each output within GAP_FRACTION of JAX's bf16-versus-fp32 gap."""
    config, params = no_window
    ids, mask = _tokens(config, 3)

    def run_jax(dtype):
        m = jnp.asarray(mask, dtype)
        with jax.disable_jit():
            out = jax_encoder.text_encoder(
                JaxParamView({k: jnp.asarray(v, dtype) for k, v in _encoder_params(params).items()}),
                config, jnp.asarray(ids), m[..., None], m, trainable=trainable)
        return [np.asarray(o.astype(jnp.float32)) for o in out]

    bf16, fp32 = run_jax(jnp.bfloat16), run_jax(jnp.float32)
    tparams = {k: torch.tensor(v).to(torch.bfloat16)
               for k, v in _encoder_params(params).items()}
    got = encoder.text_encoder(ParamView(tparams), config, torch.tensor(ids, dtype=torch.long),
                               torch.tensor(mask[..., None]).to(torch.bfloat16),
                               trainable=trainable)
    for name, g, want, wide in zip(encoder.EncoderOutput._fields, got, bf16, fp32):
        assert g.dtype == torch.bfloat16, name
        gap = _rel_l2(want, wide)
        assert gap > 0, name  # bf16 and fp32 differ: the bound is not vacuous
        assert _rel_l2(g.float().numpy(), want) <= GAP_FRACTION * gap, name


def test_engine_dispatch_without_window_matches_jax_engine(no_window, monkeypatch):
    """One dispatch through the port's ``Synthesizer`` and one through JAX's engine,
    each on the same ``NoiseOverride`` (injected into the engine's model call)."""
    config, params = no_window
    ids, mask = _tokens(config, 4, lengths=(12, 5), T=12)
    rng = np.random.default_rng(5)
    dur = rng.standard_normal((2, 12, 2)).astype(np.float32)
    prior = rng.standard_normal((2, FRAMES, config.flow_size)).astype(np.float32)

    def with_noise(fn, noise):
        def call(*args, **kwargs):
            return fn(*args, noise=noise, **kwargs)
        return call

    monkeypatch.setattr(jax_synthesizer, "synthesize_fn", with_noise(
        jax_synthesizer.synthesize_fn,
        jax_vits.NoiseOverride(jnp.asarray(dur), jnp.asarray(prior))))
    monkeypatch.setattr(synthesizer, "synthesize_fn", with_noise(
        synthesizer.synthesize_fn, vits.NoiseOverride(torch.tensor(dur), torch.tensor(prior))))
    engine = {"transfer_int16": False}  # on the CPU: no kernel on either side
    ref = jax_synthesizer.Synthesizer(config, None, params, JaxEngineConfig(**engine))
    port = synthesizer.Synthesizer(VitsConfig(**dataclasses.asdict(config)), None, params,
                                   EngineConfig(**engine), device="cpu")
    controls = ref._controls(None, None, None)
    want = ref._compiled(FRAMES)(ref.params, jnp.asarray(ids), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), None, controls)
    got = port._fetch(port._dispatch(ids, mask, FRAMES, 0, None,
                                     port._controls(None, None, None)))
    np.testing.assert_array_equal(got.frame_lengths, np.asarray(want[2]))
    np.testing.assert_array_equal(got.lengths, np.asarray(want[1]))
    np.testing.assert_allclose(got.waveform, np.asarray(want[0]), atol=WAVE_ATOL, rtol=0)
    np.testing.assert_allclose(got.log_duration, np.asarray(want[3]), atol=LATENT_ATOL, rtol=0)


def test_synthesize_without_window_matches_jax(no_window):
    """The model function: latents and waveform at test_torch_synthesis.py's bounds."""
    config, params = no_window
    ids, mask = _tokens(config, 6, lengths=(12, 5), T=12)
    rng = np.random.default_rng(7)
    dur = rng.standard_normal((2, 12, 2)).astype(np.float32)
    prior = rng.standard_normal((2, FRAMES, config.flow_size)).astype(np.float32)
    want = jax_vits.synthesize(params, config, jnp.asarray(ids), jnp.asarray(mask), FRAMES,
                               noise=jax_vits.NoiseOverride(jnp.asarray(dur), jnp.asarray(prior)))
    got = vits.synthesize(from_jax_params(params, "cpu"), config,
                          torch.tensor(ids, dtype=torch.long), torch.tensor(mask), FRAMES,
                          noise=vits.NoiseOverride(torch.tensor(dur), torch.tensor(prior)))
    np.testing.assert_array_equal(got.frame_lengths.numpy(), np.asarray(want.frame_lengths))
    np.testing.assert_allclose(got.latents.numpy(), np.asarray(want.latents),
                               atol=LATENT_ATOL, rtol=0)
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(want.waveform),
                               atol=WAVE_ATOL, rtol=0)


def test_gan_step_without_window_matches_jax(no_window):
    """Losses and both networks' gradients of one GAN step (G at lr 0, D by -g), as
    ``test_torch_train_step.py::test_gan_step_matches_jax``."""
    config, params = no_window
    batch = _batch(config, 1)
    key = jax.random.PRNGKey(5)
    disc_np = jax_init_disc(0)
    jstep = jax_step.make_gan_train_step(config, _recording(0.0), _recording(1.0),
                                         segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS,
                                         donate=False)
    gp = {k: jnp.asarray(v) for k, v in params.items()}
    dp = {k: jnp.asarray(v) for k, v in disc_np.items()}
    with jax.default_matmul_precision("highest"):
        _, _, want_g, want_d, want = jstep(gp, dp, _recording(0.0).init(gp),
                                           _recording(1.0).init(dp), batch, key)
    gen_params, disc_params = _leaves(params), _leaves(disc_np)
    tstep = step.make_gan_train_step(
        config, gen_params, disc_params, torch.optim.SGD(list(gen_params.values()), lr=0.0),
        torch.optim.SGD(list(disc_params.values()), lr=1.0), segment_frames=SEGMENT,
        mel_kwargs=MEL_KWARGS)
    got = tstep(step.batch_to(batch, "cpu"), noise=_jax_noise(config, batch, key))
    for name in step.GanTrainMetrics._fields:
        _assert_close(getattr(got, name), getattr(want, name), what=name)
    for name, p in gen_params.items():
        _assert_grad_close(p.grad, want_g[name], what=name)
    for name, p in disc_params.items():
        _assert_grad_close(p.grad, want_d[name], what=name)


@pytest.fixture(scope="module")
def model_axis_run(tmp_path_factory):
    """Two model ranks' GAN step on the window-0 model, and the one-process step."""
    config, gen_np, disc_np = no_window_params()
    out = str(tmp_path_factory.mktemp("no_window_tp"))
    batch, noise = step_inputs(config, 7)
    np.savez(os.path.join(out, "inputs.npz"),
             **{f"batch.{k}": v.numpy() for k, v in batch._asdict().items() if v is not None},
             **{f"noise.{k}": v.numpy() for k, v in noise._asdict().items()})
    port = free_port()
    procs = [spawn("no_window", r, 2, port, out) for r in range(2)]
    try:
        with torch.backends.mkldnn.flags(enabled=False):  # the workers' setting
            gen, disc = _leaves(gen_np), _leaves(disc_np)
            metrics = step.make_gan_train_step(
                config, gen, disc, torch.optim.SGD(list(gen.values()), lr=0.0),
                torch.optim.SGD(list(disc.values()), lr=1.0), segment_frames=SEGMENT,
                mel_kwargs=MEL_KWARGS)(batch, noise=noise)
    finally:
        wait_all(procs)
    reports, arrays = [], []
    for r in range(2):
        with open(os.path.join(out, f"nw-report-{r}.json")) as f:
            reports.append(json.load(f))
        with np.load(os.path.join(out, f"nw-arrays-{r}.npz")) as f:
            arrays.append({k: f[k] for k in f.files})
    yield {"config": config, "gen": gen_np, "reports": reports, "arrays": arrays,
           "want": ({k: float(v) for k, v in metrics._asdict().items()},
                    {k: p.grad.numpy() for k, p in gen.items()},
                    {k: p.grad.numpy() for k, p in disc.items()})}
    shutil.rmtree(out, ignore_errors=True)


def test_model_axis_splits_heads_without_window(model_axis_run):
    """With ``head_dim`` the plan splits q/k/v by heads (not gathered whole at use),
    each rank holding half; without it a model with no table gathers them whole."""
    config, gen_np = model_axis_run["config"], model_axis_run["gen"]
    for report in model_axis_run["reports"]:
        assert any(k.endswith("q_proj.weight") for k in report["split_heads"])
        for name, (held, whole) in report["held"].items():
            assert int(np.prod(held)) * 2 == int(np.prod(whole)), name
    without = split_plan(gen_np, 2)
    assert all(without[k].whole for k in without if ".attention." in k)
    assert not any(split_plan(gen_np, 2, config.head_dim)[k].whole
                   for k in without if ".attention." in k)


def test_model_axis_without_window_matches_one_process(model_axis_run):
    want_metrics, want_g, want_d = model_axis_run["want"]
    for report in model_axis_run["reports"]:
        for name, got in zip(step.GanTrainMetrics._fields, report["metrics"]):
            _assert_close(got, want_metrics[name], what=name)
    got = _reassembled(model_axis_run["gen"], model_axis_run["arrays"])
    for name, g in got.items():
        _assert_grad_close(g, want_g[name], what=name)
    for name, g in want_d.items():
        _assert_grad_close(model_axis_run["arrays"][0][f"d.{name}"], g, what=name)
