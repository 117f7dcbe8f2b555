"""The port's training step against the JAX package's, on ``tiny_bundle``.

Same parameters, same seeded numpy batch, and the same noise: the JAX
package's own draws, rebuilt from its key exactly as ``generator_forward``
splits it (``vits_tpu/train/step.py:158,169,216,228``) and handed to the port
as a ``TrainNoise``. CPU on both sides, so the port's kernels take their
plain versions. Losses are compared at atol 1e-5 relative to max(1, |ref|).
Each gradient leaf is held by its relative L2 error ||got - ref|| / ||ref||
against GRAD_RTOL, set from the JAX reference's own noise: perturbing every
weight by 1e-7 relative moves a leaf's gradient by up to 4.3e-5 of its norm
(the duration predictor's spline flows amplify fp32 noise; the port differs
by up to 6.2e-5 there, by at most 9.3e-7 on the discriminator). The
attention key biases have an exact gradient of 0 (softmax is shift-
invariant per query row), so their reference is fp32 noise of norm ~1e-8;
a leaf whose reference norm is below ZERO_GRAD must stay below it too.
Updated generator parameters are not compared: Adam's first step turns fp32
noise in a gradient into a +-lr move (test_torch_train_modules.py holds the
optimizer on identical gradients). Also the loop end to end on the tiny ggml
fixture, with a checkpoint and a resume.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from vits_tpu.models.discriminator import init_discriminator_params as jax_init_disc
from vits_tpu.train import step as jax_step
from vits_tpu_torch.train import step

torch.set_num_threads(2)

ATOL = 1e-5
GRAD_RTOL = 2e-4  # see the module docstring
ZERO_GRAD = 1e-6
MEL_KWARGS = {"n_fft": 256, "hop_length": 64, "n_mels": 20}
SEGMENT = 8


def _assert_close(got, want, atol=ATOL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, atol=atol, rtol=0, err_msg=what)


def _assert_grad_close(got, want, what):
    """One gradient leaf: relative L2 error <= GRAD_RTOL, or both norms below ZERO_GRAD."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    norm = np.linalg.norm(want)
    if norm < ZERO_GRAD:
        assert np.linalg.norm(got) < ZERO_GRAD, f"{what}: |got| {np.linalg.norm(got):.3e}"
        return
    err = np.linalg.norm(got - want) / norm
    assert err <= GRAD_RTOL, f"{what}: relative L2 error {err:.3e} > {GRAD_RTOL}"


def _batch(config, seed, B=2, T=12, S=24, lengths=((12, 24), (9, 19))):
    rng = np.random.default_rng(seed)
    up = config.total_upsample
    token_mask = np.zeros((B, T), np.float32)
    frame_mask = np.zeros((B, S), np.float32)
    for b, (t, s) in enumerate(lengths):
        token_mask[b, :t] = 1.0
        frame_mask[b, :s] = 1.0
    return jax_step.TrainBatch(
        input_ids=(rng.integers(1, config.vocab_size, (B, T)) * token_mask).astype(np.int32),
        token_mask=token_mask,
        spectrogram=(rng.standard_normal((B, S, config.spectrogram_bins))
                     * frame_mask[..., None]).astype(np.float32),
        frame_mask=frame_mask,
        audio=(rng.standard_normal((B, S * up)) * 0.1 * np.repeat(frame_mask, up, axis=1))
        .astype(np.float32),
    )


def _jax_noise(config, batch, key):
    """The draws of vits_tpu generator_forward for ``key``, as a port TrainNoise."""
    k_post, k_dur, k_seg = jax.random.split(key, 3)
    B, S, _ = batch.spectrogram.shape
    return step.TrainNoise(
        torch.tensor(np.asarray(jax.random.normal(k_post, (B, S, config.flow_size)))),
        torch.tensor(np.asarray(jax.random.normal(k_dur, (B, batch.input_ids.shape[1], 2)))),
        torch.tensor(np.asarray(jax.random.uniform(k_seg, (B,)))),
    )


def _leaves(params):
    return {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in params.items()}


def test_generator_loss_and_grads_match_jax(tiny_bundle):
    config, params = tiny_bundle
    batch = _batch(config, 0)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        return jax_step.generator_loss(p, config, batch, key, SEGMENT, mel_kwargs=MEL_KWARGS)

    with jax.default_matmul_precision("highest"):
        (want, want_metrics), want_grads = jax.value_and_grad(loss_fn, has_aux=True)(
            {k: jnp.asarray(v) for k, v in params.items()})
    tparams = _leaves(params)
    got, got_metrics = step.generator_loss(tparams, config, step.batch_to(batch, "cpu"),
                                           _jax_noise(config, batch, key), SEGMENT,
                                           mel_kwargs=MEL_KWARGS)
    for name, g, w in zip(step.TrainMetrics._fields, got_metrics, want_metrics):
        _assert_close(g.detach(), w, what=name)
    grads = step.gradients(got, tparams)
    for name, g in zip(tparams, grads):
        _assert_grad_close(g, want_grads[name], what=name)


def _recording(lr):
    """An optax transformation that keeps the gradient in its state and moves by -lr*g."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree.map(lambda g: -lr * g, grads), grads
    return optax.GradientTransformation(init, update)


def test_gan_step_matches_jax(tiny_bundle):
    """Losses and both networks' gradients of one GAN step; the discriminator
    moves by -g (SGD, lr 1) so the generator's adversarial terms run through
    the updated discriminator on both sides."""
    config, params = tiny_bundle
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
        config, gen_params, disc_params,
        torch.optim.SGD(list(gen_params.values()), lr=0.0),
        torch.optim.SGD(list(disc_params.values()), lr=1.0),
        segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS)
    got = tstep(step.batch_to(batch, "cpu"), noise=_jax_noise(config, batch, key))
    for name in step.GanTrainMetrics._fields:
        _assert_close(getattr(got, name), getattr(want, name), what=name)
    for name, p in gen_params.items():
        _assert_grad_close(p.grad, want_g[name], what=name)
    for name, p in disc_params.items():
        _assert_grad_close(p.grad, want_d[name], what=name)
    for name, p in disc_params.items():  # the discriminator did move: p - g
        assert torch.equal(p.detach(), torch.tensor(disc_np[name]) - p.grad), name


def test_grad_accum_averages_microbatch_gradients(tiny_bundle):
    """Two microbatches of one row each give the mean of the two rows' gradients."""
    config, params = tiny_bundle
    batch = step.batch_to(_batch(config, 2), "cpu")
    noise = step.draw_noise(config, batch, torch.Generator().manual_seed(0))
    accum = _leaves(params)
    step.make_train_step(config, accum, torch.optim.SGD(list(accum.values()), lr=0.0),
                         SEGMENT, mel_kwargs=MEL_KWARGS, grad_accum=2)(batch, noise=noise)
    rows = []
    for b in range(2):
        tparams = _leaves(params)
        loss, _ = step.generator_loss(
            tparams, config, step.TrainBatch(*(None if t is None else t[b:b + 1] for t in batch)),
            step.TrainNoise(*(t[b:b + 1] for t in noise)), SEGMENT, mel_kwargs=MEL_KWARGS)
        rows.append(step.gradients(loss, tparams))
    for i, (name, p) in enumerate(accum.items()):
        _assert_close(p.grad, (rows[0][i] + rows[1][i]) / 2, what=name)


def test_train_loop_checkpoints_and_resumes(tmp_path):
    from vits_tpu.train.synthetic import corpus_vocab, generate_micro_corpus
    from vits_tpu.train.checkpoint import _load_flat
    from vits_tpu.io.loader import export_to_ggml, load_ggml
    from vits_tpu.text.tokenizer import VitsTokenizer
    from vits_tpu_torch.train.loop import train

    fixture = os.path.join(os.path.dirname(__file__), "fixtures", "tiny-vits.ggml")
    config, _, params = load_ggml(fixture)
    corpus = str(tmp_path / "corpus")
    generate_micro_corpus(corpus, n_utts=4, words_range=(1, 2))
    model = str(tmp_path / "model.ggml")
    export_to_ggml(model, config, VitsTokenizer(vocab=corpus_vocab(), pad_token="_",
                                                unk_token="?"), params, fp16_convs=False)
    out_dir = str(tmp_path / "run")
    logs = []
    train(corpus, model, out_dir, steps=2, batch_size=2, checkpoint_every=1, log_every=1,
          adversarial=False, segment_frames=8, log=logs.append, device="cpu")
    assert any(line.startswith("step 2:") for line in logs)
    for n in (1, 2):
        assert os.path.isdir(os.path.join(out_dir, f"step_{n:08d}"))
    saved = _load_flat(os.path.join(out_dir, "step_00000002", "gen_params.npz"))
    assert {k: v.shape for k, v in saved.items()} == {k: v.shape for k, v in params.items()}

    logs2 = []
    gen = train(corpus, model, out_dir, steps=3, batch_size=2, checkpoint_every=10,
                log_every=1, adversarial=False, segment_frames=8, log=logs2.append,
                device="cpu")
    assert "resumed from step 2" in logs2 and "restored EMA weights" in logs2
    assert any(line.startswith("step 3:") for line in logs2)
    assert all(bool(torch.isfinite(p).all()) for p in gen.values())
