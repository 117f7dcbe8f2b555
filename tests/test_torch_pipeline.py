"""The port's GPipe encoder (``vits_tpu_torch/parallel/pipeline.py``) against JAX's.

Mirrors ``tests/test_pipeline.py``: a mesh of ``[cpu] * n`` stands for n
devices, as JAX's virtual CPU devices stand for chips. Tolerances:

* the pipelined encoder against JAX's plain ``text_encoder`` at JAX's four
  cases (stages == layers, stages < layers, remat, pp x dp), and one case
  against JAX's ``pipeline_text_encoder`` itself: atol and rtol 1e-5 (JAX's
  own bound; the port computes one microbatch's rows at a time, another
  summation order in oneDNN, ~3e-6);
* ``stack_pipeline_params`` / ``unstack_pipeline_params`` against JAX's:
  bit-equal;
* the stage blocks' gradients (a whole-batch abs-sum loss) against JAX's plain
  encoder's, restacked: atol and rtol 1e-3 (JAX's own bound: fp32 noise on
  O(100) gradients; a schedule bug is an O(gradient) error);
* the pp generator step's loss against JAX's ``make_train_step`` on the same
  batch and key (its draws rebuilt as a ``TrainNoise``): rtol 1e-4 (JAX's own
  test), each stage's block, gradient and Adam moments on its stage's device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_train_step import _jax_noise
from vits_tpu.io.params import ParamView as JaxParamView
from vits_tpu.io.random_init import random_params
from vits_tpu.models.encoder import text_encoder as jax_text_encoder
from vits_tpu.parallel import pipeline as jax_pipeline
from vits_tpu.train import step as jax_step
from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import from_jax_params
from vits_tpu_torch.parallel.pipeline import (
    layer_suffixes,
    layer_suffixes_stacked,
    make_pipe_mesh,
    make_pp_train_step,
    pipeline_text_encoder,
    stack_pipeline_params,
    unstack_pipeline_params,
)
from vits_tpu_torch.train import step
from vits_tpu_torch.train.schedule import vits_optimizer

torch.set_num_threads(2)

ATOL = RTOL = 1e-5
GRAD_TOL = 1e-3
LOSS_RTOL = 1e-4
MEL_KWARGS = {"n_fft": 256, "hop_length": 64, "n_mels": 20}
CPU = torch.device("cpu")
STACK = "text_encoder.encoder.pipeline."


def _four_layer_config():
    return VitsConfig(
        hidden_size=32, num_hidden_layers=4, num_attention_heads=2, ffn_dim=64,
        flow_size=16, spectrogram_bins=65, upsample_initial_channel=32,
        upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)),
        prior_encoder_num_flows=2, prior_encoder_num_wavenet_layers=2,
        posterior_encoder_num_wavenet_layers=2, duration_predictor_num_flows=2,
        duration_predictor_flow_bins=6, depth_separable_num_layers=2,
        duration_predictor_filter_channels=32,
    )


def _jax_config(config):
    from vits_tpu.config import VitsConfig as JaxVitsConfig

    return JaxVitsConfig(**{f: getattr(config, f) for f in config.__dataclass_fields__})


def _encoder_inputs(config, rng, B=8, T=12):
    ids = rng.integers(0, config.vocab_size, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.float32)
    mask[1, 8:] = 0.0  # ragged rows: the mask path must survive pipelining
    mask[5, 5:] = 0.0
    return ids, mask, mask[..., None]


@pytest.fixture(scope="module")
def four_layer():
    config = _four_layer_config()
    return config, _jax_config(config), random_params(_jax_config(config), seed=0,
                                                      keep_training=True)


@pytest.mark.parametrize("stages,data,microbatches,remat", [
    (4, 1, 4, False),  # one layer per stage
    (2, 1, 4, False),  # two layers per stage, M > P
    (4, 1, 8, True),   # remat'd stage interiors
    (2, 4, 2, False),  # pp x dp: microbatch rows split over 4 devices a stage
])
def test_pp_encoder_matches_jax_text_encoder(four_layer, stages, data, microbatches, remat):
    config, jconfig, params = four_layer
    ids, mask, mask3 = _encoder_inputs(config, np.random.default_rng(0))
    want = jax_text_encoder(JaxParamView({k: jnp.asarray(v) for k, v in params.items()}),
                            jconfig, ids, mask3, mask)
    mesh = make_pipe_mesh(stages, data=data, devices=[CPU] * (stages * data))
    assert mesh.shape == ({"pipe": stages, "data": data} if data > 1 else {"pipe": stages})
    pp = stack_pipeline_params(from_jax_params(params, CPU), config, stages, mesh=mesh)
    got = pipeline_text_encoder(pp, config, torch.tensor(ids), torch.tensor(mask3), mesh,
                                microbatches=microbatches, remat=remat)
    for a, b, name in zip(got, want, ("hidden", "means", "logvar")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


def test_pp_encoder_matches_jax_pipeline_text_encoder(four_layer):
    config, jconfig, params = four_layer
    ids, mask, mask3 = _encoder_inputs(config, np.random.default_rng(1))
    jmesh = jax_pipeline.make_pipe_mesh(2)
    jpp = jax_pipeline.stack_pipeline_params({k: jnp.asarray(v) for k, v in params.items()},
                                             jconfig, num_stages=2, mesh=jmesh)
    want = jax.jit(lambda prm, i, m3, m: jax_pipeline.pipeline_text_encoder(
        prm, jconfig, i, m3, m, jmesh, microbatches=4))(jpp, ids, mask3, mask)
    mesh = make_pipe_mesh(2, devices=[CPU] * 2)
    pp = stack_pipeline_params(from_jax_params(params, CPU), config, 2, mesh=mesh)
    got = pipeline_text_encoder(pp, config, torch.tensor(ids), torch.tensor(mask3), mesh,
                                microbatches=4)
    for a, b, name in zip(got, want, ("hidden", "means", "logvar")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("stages", [1, 2, 4])
def test_stack_and_unstack_equal_jax(four_layer, stages):
    """The port's stage blocks, stacked, are JAX's (stages, per, *leaf) arrays bit
    for bit; numpy and tensor inputs give the same blocks; unstack inverts."""
    config, jconfig, params = four_layer
    want = jax_pipeline.stack_pipeline_params(params, jconfig, num_stages=stages)
    got = stack_pipeline_params(params, config, stages)
    tensors = stack_pipeline_params(from_jax_params(params, CPU), config, stages)
    assert layer_suffixes_stacked(got) == layer_suffixes(params)
    assert set(got) == set(tensors)
    for suffix in layer_suffixes(params):
        blocks = [got[f"{STACK}{s}.{suffix}"] for s in range(stages)]
        np.testing.assert_array_equal(np.stack(blocks), np.asarray(want[STACK + suffix]))
        for s in range(stages):
            np.testing.assert_array_equal(tensors[f"{STACK}{s}.{suffix}"].numpy(), blocks[s])
    for k, v in params.items():
        if not k.startswith("text_encoder.encoder.layers."):
            np.testing.assert_array_equal(got[k], v)
    back = unstack_pipeline_params(got, config)
    assert set(back) == set(params)
    for k in params:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(params[k]))
    with pytest.raises(ValueError, match="not divisible"):
        stack_pipeline_params(params, config, 3)


def test_mesh_and_batch_refusals(four_layer):
    config, _, params = four_layer
    with pytest.raises(ValueError, match="need 4 devices"):
        make_pipe_mesh(2, data=2, devices=[CPU] * 3)
    mesh = make_pipe_mesh(2, devices=[CPU] * 2)
    pp = stack_pipeline_params(from_jax_params(params, CPU), config, 2, mesh=mesh)
    ids, _, mask3 = _encoder_inputs(config, np.random.default_rng(0), B=6)
    with pytest.raises(ValueError, match="microbatches=4"):
        pipeline_text_encoder(pp, config, torch.tensor(ids), torch.tensor(mask3), mesh, 4)
    dmesh = make_pipe_mesh(2, data=4, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="not divisible over"):
        pipeline_text_encoder(pp, config, torch.tensor(ids), torch.tensor(mask3), dmesh, 3)
    with pytest.raises(ValueError, match="pipeline layout"):
        pipeline_text_encoder(from_jax_params(params, CPU), config, torch.tensor(ids),
                              torch.tensor(mask3), mesh, 2)


@pytest.mark.parametrize("stages,data,microbatches", [(4, 1, 4), (2, 4, 2)])
def test_pp_grads_match_jax_plain(four_layer, stages, data, microbatches):
    """The stage blocks' gradients through the schedule (and, pp x dp, summed over
    the data replicas onto each block) equal JAX's plain encoder's, restacked."""
    config, jconfig, params = four_layer
    ids, mask, mask3 = _encoder_inputs(config, np.random.default_rng(2 + data))

    def loss_plain(prm):
        out = jax_text_encoder(JaxParamView(prm), jconfig, ids, mask3, mask)
        return jnp.sum(jnp.abs(out.last_hidden_state))

    want = jax_pipeline.stack_pipeline_params(
        jax.jit(jax.grad(loss_plain))({k: jnp.asarray(v) for k, v in params.items()}),
        jconfig, num_stages=stages)
    mesh = make_pipe_mesh(stages, data=data, devices=[CPU] * (stages * data))
    pp = {k: v.requires_grad_() for k, v in stack_pipeline_params(
        from_jax_params(params, CPU), config, stages, mesh=mesh).items()}
    out = pipeline_text_encoder(pp, config, torch.tensor(ids), torch.tensor(mask3), mesh,
                                microbatches=microbatches)
    out.last_hidden_state.abs().sum().backward()
    for suffix in layer_suffixes(params):
        got = np.stack([pp[f"{STACK}{s}.{suffix}"].grad.numpy() for s in range(stages)])
        np.testing.assert_allclose(got, np.asarray(want[STACK + suffix]), atol=GRAD_TOL,
                                   rtol=GRAD_TOL, err_msg=suffix)


def test_pp_train_step_matches_jax_train_step(tiny_bundle):
    """``make_pp_train_step`` (2 stages, 2 microbatches, remat) against JAX's
    ``make_train_step`` on one batch and key: the losses agree; each stage's
    block, its gradient and its moments lie on its stage's device, and the
    update moved it."""
    config, raw = tiny_bundle
    rng = np.random.default_rng(3)
    B, T, S = 4, 12, 24
    up = config.total_upsample
    batch = jax_step.TrainBatch(
        input_ids=rng.integers(0, config.vocab_size, (B, T)).astype(np.int32),
        token_mask=np.ones((B, T), np.float32),
        spectrogram=rng.standard_normal((B, S, config.spectrogram_bins)).astype(np.float32),
        frame_mask=np.ones((B, S), np.float32),
        audio=(rng.standard_normal((B, S * up)) * 0.1).astype(np.float32),
    )
    key = jax.random.PRNGKey(0)
    opt = optax.adamw(2e-4)
    params = {k: jnp.asarray(v) for k, v in raw.items()}
    ref_step = jax_step.make_train_step(config, opt, segment_frames=8, mel_kwargs=MEL_KWARGS,
                                        donate=False)
    with jax.default_matmul_precision("highest"):
        _, _, want = ref_step(params, opt.init(params), batch, key)

    from vits_tpu_torch.config import VitsConfig as PortConfig

    pconfig = PortConfig(**{f: getattr(config, f) for f in config.__dataclass_fields__})
    mesh = make_pipe_mesh(2, devices=[CPU] * 2)
    pp = {k: v.requires_grad_() for k, v in stack_pipeline_params(
        from_jax_params(raw, CPU), pconfig, 2, mesh=mesh).items()}
    before = {k: v.detach().clone() for k, v in pp.items()}
    optimizer = vits_optimizer(pp)
    fn = make_pp_train_step(pconfig, pp, optimizer, mesh, microbatches=2, segment_frames=8,
                            mel_kwargs=MEL_KWARGS, remat=True)
    got = fn(step.batch_to(batch, CPU), noise=_jax_noise(config, batch, key))
    np.testing.assert_allclose(float(got.loss), float(want.loss), rtol=LOSS_RTOL)
    k = STACK + "{}.attention.q_proj.weight"
    for s in range(2):
        block = pp[k.format(s)]
        state = optimizer.adamw.state[block]
        assert block.device == block.grad.device == state["exp_avg"].device == mesh.devices[s]
        assert block.shape[0] == config.num_hidden_layers // 2
        assert not torch.allclose(block, before[k.format(s)])
