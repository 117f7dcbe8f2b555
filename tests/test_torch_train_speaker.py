"""Speaker-conditioned training and the two-forward GAN step, against the JAX package.

* A speaker-conditioned ``generator_loss`` on ``tests/test_multispeaker.py``'s
  4-speaker model with ``TrainBatch.speaker_id`` given: the same parameters,
  seeded numpy batch and the JAX package's own noise on both sides, on the CPU.
  Losses within ATOL relative to max(1, |ref|) and every gradient leaf,
  ``embed_speaker.weight`` included, within GRAD_RTOL relative L2 error
  (``test_torch_train_step.py``'s bounds). The speaker vector trains through
  the posterior, the flow, the duration predictor (not detached, while the
  encoder output it sees is) and the vocoder; the rows of speakers absent
  from the batch get exactly 0.
* ``reuse_forward=False`` (JAX's ``step_naive``: a forward without gradients
  for the discriminator's update, a second one for the generator's loss)
  against the default single forward, as
  ``tests/test_gan.py::test_reused_forward_matches_two_forward_step`` holds
  the JAX step: losses at rtol 1e-5 and every updated parameter at rtol 1e-4,
  atol 1e-6, under AdamW.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_multispeaker import spk_bundle, spk_hf_model  # noqa: F401 (fixtures)
from tests.test_torch_train_step import (
    MEL_KWARGS,
    SEGMENT,
    _assert_close,
    _assert_grad_close,
    _batch,
    _jax_noise,
    _leaves,
)
from vits_tpu.models.discriminator import init_discriminator_params as jax_init_disc
from vits_tpu.train import step as jax_step
from vits_tpu_torch.train import step

torch.set_num_threads(2)

SPEAKERS = np.array([3, 1], np.int32)  # speakers 0 and 2 are absent from the batch


def test_speaker_generator_loss_matches_jax(spk_bundle):  # noqa: F811
    config, params = spk_bundle
    assert config.num_speakers == 4
    batch = _batch(config, 4)._replace(speaker_id=SPEAKERS)
    key = jax.random.PRNGKey(7)

    def loss_fn(p):
        return jax_step.generator_loss(p, config, batch, key, SEGMENT, mel_kwargs=MEL_KWARGS)

    with jax.default_matmul_precision("highest"):
        (_, want_metrics), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()})
    tparams = _leaves(params)
    loss, metrics = step.generator_loss(tparams, config, step.batch_to(batch, "cpu"),
                                        _jax_noise(config, batch, key), SEGMENT,
                                        mel_kwargs=MEL_KWARGS)
    for name, g, w in zip(step.TrainMetrics._fields, metrics, want_metrics):
        _assert_close(g.detach(), w, what=name)
    grads = dict(zip(tparams, step.gradients(loss, tparams)))
    for name, g in grads.items():
        _assert_grad_close(g, want_grads[name], what=name)
    emb = grads["embed_speaker.weight"]
    assert bool((emb[[0, 2]] == 0).all()) and bool((emb[SPEAKERS].abs().sum(dim=1) > 0).all())


def test_speaker_vector_trains_every_conditioned_module(spk_bundle):  # noqa: F811
    """Each conditioned module alone gives embed_speaker.weight a gradient: the
    duration predictor's path is not cut by the encoder output's detach."""
    config, params = spk_bundle
    batch = step.batch_to(_batch(config, 5)._replace(speaker_id=SPEAKERS), "cpu")
    noise = step.draw_noise(config, batch, torch.Generator().manual_seed(3))
    tparams = _leaves(params)
    out = step.generator_forward(tparams, config, batch, noise, SEGMENT, mel_kwargs=MEL_KWARGS)
    emb = tparams["embed_speaker.weight"]
    for name in ("kl", "duration", "mel"):
        (g,) = torch.autograd.grad(getattr(out.metrics, name), [emb], retain_graph=True)
        assert float(g[SPEAKERS].abs().sum()) > 0, name


def test_two_forward_step_matches_reused_forward(tiny_bundle):
    config, params = tiny_bundle
    batch = step.batch_to(_batch(config, 6), "cpu")
    noise = step.draw_noise(config, batch, torch.Generator().manual_seed(4))
    disc_np = jax_init_disc(0)
    results = []
    for reuse in (True, False):
        gen_params, disc_params = _leaves(params), _leaves(disc_np)
        tstep = step.make_gan_train_step(
            config, gen_params, disc_params, torch.optim.AdamW(list(gen_params.values()), 2e-4),
            torch.optim.AdamW(list(disc_params.values()), 2e-4), segment_frames=SEGMENT,
            mel_kwargs=MEL_KWARGS, reuse_forward=reuse)
        results.append((tstep(batch, noise=noise), gen_params, disc_params))
    (m_a, gp_a, dp_a), (m_b, gp_b, dp_b) = results
    for name in step.GanTrainMetrics._fields:
        np.testing.assert_allclose(float(getattr(m_b, name)), float(getattr(m_a, name)),
                                   rtol=1e-5, err_msg=name)
    for a, b in ((gp_a, gp_b), (dp_a, dp_b)):
        for name in a:
            np.testing.assert_allclose(b[name].detach().numpy(), a[name].detach().numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
