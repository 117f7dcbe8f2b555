"""bf16 mixed-precision training in the port against the JAX package's, on ``tiny_bundle``.

``compute_dtype="bfloat16"`` in both packages: the text encoder, the decoder
and the discriminator on bf16 casts of fp32 master parameters, the loss
anchors in fp32. Same parameters, seeded numpy batch and the JAX package's own
noise (``test_torch_train_step.py``'s helpers), on the CPU: at this size the
encoder's attention is the plain module path (below 512 tokens) and the
vocoder's stages are narrow, so both sides run bf16 PyTorch / XLA ops.

The port rounds to bf16 after every op, as JAX does op by op: eager
``jax.value_and_grad`` of ``generator_loss`` then agrees with the port's to
fp32 noise in the losses and to a few hundredths of the bf16 error in the
gradients. JAX's jitted GAN step fuses elementwise chains and keeps fp32
inside a fusion (XLA's excess precision), so there the two differ by more.
Every bound is a fraction of the JAX package's own bf16-versus-fp32 gap on
the same batch (the error of its fp32 result against its bf16 one): a port
that silently computed in fp32 would sit at 1.0 of it.

* losses: |port - jax_bf16| <= LOSS_GAP_FRACTION x |jax_fp32 - jax_bf16| for
  every term (eager: also within ATOL relative, the fp32 test's bound);
* gradients, one concatenated vector per module: relative L2 error against
  JAX's bf16 gradients <= GRAD_GAP_FRACTION x that of JAX's fp32 gradients
  (eager: EAGER_GRAD_GAP_FRACTION). Measured: eager losses ~1e-6 relative and
  gradients <= 0.094 of the gap; the jitted GAN step <= 0.36 (losses) and
  <= 0.39 (gradients);
* master parameters and their gradients stay fp32; the bf16 gradients point
  the way of the fp32 ones (cosine >= 0.97, the JAX package's own bound in
  ``tests/test_train_scale.py``), and a few bf16 steps lower the loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_train_step import (
    MEL_KWARGS,
    SEGMENT,
    _batch,
    _jax_noise,
    _leaves,
    _recording,
)
from vits_tpu.models.discriminator import init_discriminator_params as jax_init_disc
from vits_tpu.train import step as jax_step
from vits_tpu_torch.train import step

torch.set_num_threads(2)

LOSS_GAP_FRACTION = 0.5
GRAD_GAP_FRACTION = 0.5
EAGER_GRAD_GAP_FRACTION = 0.2
ATOL = 1e-5
COSINE = 0.97


def _module(name: str) -> str:
    return name.split(".")[0]


def _by_module(grads) -> dict[str, np.ndarray]:
    out: dict[str, list] = {}
    for name in sorted(grads):
        out.setdefault(_module(name), []).append(np.asarray(grads[name], np.float64).ravel())
    return {k: np.concatenate(v) for k, v in out.items()}


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check_losses(got: dict, bf16: dict, fp32: dict, atol: float | None = None) -> None:
    fails = []
    for name, want in bf16.items():
        gap, err = abs(fp32[name] - want), abs(got[name] - want)
        print(f"  {name}: port {got[name]:.7g}  jax bf16 {want:.7g}  jax fp32 {fp32[name]:.7g}"
              f"  |port - bf16| / gap {err / max(gap, 1e-30):.3f}")
        if not err <= LOSS_GAP_FRACTION * gap:
            fails.append(name)
        if atol is not None and not err <= atol * max(1.0, abs(want)):
            fails.append(name)
    assert not fails, fails


def _check_grads(got: dict, bf16: dict, fp32: dict, fraction: float = GRAD_GAP_FRACTION) -> None:
    g, b, f = _by_module(got), _by_module(bf16), _by_module(fp32)
    fails = []
    for module in b:
        err, gap = _rel(g[module], b[module]), _rel(f[module], b[module])
        print(f"  grads {module}: port vs jax bf16 {err:.3e}, jax fp32 vs bf16 {gap:.3e} "
              f"ratio {err / max(gap, 1e-30):.3f}")
        if not err <= fraction * gap:
            fails.append(module)
    assert not fails, fails


def _jax_loss_grads(params, config, batch, key, dtype):
    def loss_fn(p):
        return jax_step.generator_loss(p, config, batch, key, SEGMENT, mel_kwargs=MEL_KWARGS,
                                       compute_dtype=dtype)

    (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()})
    return ({n: float(v) for n, v in zip(jax_step.TrainMetrics._fields, metrics)},
            {k: np.asarray(v) for k, v in grads.items()})


def test_bf16_generator_loss_matches_jax(tiny_bundle):
    config, params = tiny_bundle
    batch = _batch(config, 0)
    key = jax.random.PRNGKey(3)
    want, want_grads = _jax_loss_grads(params, config, batch, key, "bfloat16")
    ref32, ref32_grads = _jax_loss_grads(params, config, batch, key, None)

    tparams = _leaves(params)
    loss, metrics = step.generator_loss(tparams, config, step.batch_to(batch, "cpu"),
                                        _jax_noise(config, batch, key), SEGMENT,
                                        mel_kwargs=MEL_KWARGS, compute_dtype="bfloat16")
    grads = step.gradients(loss, tparams)
    assert all(g.dtype == torch.float32 for g in grads)  # fp32 master gradients
    _check_losses({n: float(m.detach()) for n, m in zip(step.TrainMetrics._fields, metrics)},
                  want, ref32, atol=ATOL)
    _check_grads({k: g.numpy() for k, g in zip(tparams, grads)}, want_grads, ref32_grads,
                 EAGER_GRAD_GAP_FRACTION)


def test_bf16_gan_step_matches_jax(tiny_bundle):
    """One bf16 GAN step: losses and both networks' gradients, the discriminator
    moved by -g (SGD, lr 1) so the adversarial terms run through the updated
    discriminator on both sides."""
    config, params = tiny_bundle
    batch = _batch(config, 1)
    key = jax.random.PRNGKey(5)
    disc_np = jax_init_disc(0)

    def jax_run(dtype):
        jstep = jax_step.make_gan_train_step(config, _recording(0.0), _recording(1.0),
                                             segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS,
                                             donate=False, compute_dtype=dtype)
        gp = {k: jnp.asarray(v) for k, v in params.items()}
        dp = {k: jnp.asarray(v) for k, v in disc_np.items()}
        _, _, g, d, m = jstep(gp, dp, _recording(0.0).init(gp), _recording(1.0).init(dp),
                              batch, key)
        return ({n: float(getattr(m, n)) for n in step.GanTrainMetrics._fields},
                {k: np.asarray(v) for k, v in g.items()}, {k: np.asarray(v) for k, v in d.items()})

    want, want_g, want_d = jax_run("bfloat16")
    ref32, ref32_g, ref32_d = jax_run(None)

    gen_params, disc_params = _leaves(params), _leaves(disc_np)
    tstep = step.make_gan_train_step(
        config, gen_params, disc_params,
        torch.optim.SGD(list(gen_params.values()), lr=0.0),
        torch.optim.SGD(list(disc_params.values()), lr=1.0),
        segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS, compute_dtype="bfloat16")
    got = tstep(step.batch_to(batch, "cpu"), noise=_jax_noise(config, batch, key))
    _check_losses({n: float(getattr(got, n)) for n in step.GanTrainMetrics._fields}, want, ref32)
    _check_grads({k: p.grad.numpy() for k, p in gen_params.items()}, want_g, ref32_g)
    _check_grads({k: p.grad.numpy() for k, p in disc_params.items()}, want_d, ref32_d)
    for p in (*gen_params.values(), *disc_params.values()):
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


def test_bf16_master_params_stay_fp32(tiny_bundle):
    """A bf16 GAN step under Adam: finite losses, fp32 master params that moved."""
    config, params = tiny_bundle
    gen_params, disc_params = _leaves(params), _leaves(jax_init_disc(0))
    tstep = step.make_gan_train_step(
        config, gen_params, disc_params, torch.optim.AdamW(list(gen_params.values()), 2e-4),
        torch.optim.AdamW(list(disc_params.values()), 2e-4), segment_frames=SEGMENT,
        mel_kwargs=MEL_KWARGS, compute_dtype="bfloat16")
    batch = step.batch_to(_batch(config, 17), "cpu")
    metrics = tstep(batch, torch.Generator().manual_seed(1))
    assert all(np.isfinite(float(v)) for v in metrics), metrics
    for name in ("decoder.conv_pre.weight", "text_encoder.embed_tokens.weight"):
        p = gen_params[name]
        assert p.dtype == torch.float32
        assert not torch.equal(p.detach(), torch.tensor(params[name])), name
    assert all(p.dtype == torch.float32 for p in disc_params.values())


def test_bf16_grads_agree_with_fp32(tiny_bundle):
    """The bf16 generator gradients point the way of the fp32 ones (cosine on the
    concatenated vector, the JAX package's bound)."""
    config, params = tiny_bundle
    batch = step.batch_to(_batch(config, 19), "cpu")
    noise = step.draw_noise(config, batch, torch.Generator().manual_seed(5))

    def grads_at(dtype):
        tparams = _leaves(params)
        loss, _ = step.generator_loss(tparams, config, batch, noise, SEGMENT,
                                      mel_kwargs=MEL_KWARGS, compute_dtype=dtype)
        return torch.cat([g.flatten() for g in step.gradients(loss, tparams)]).double()

    g32, g16 = grads_at(None), grads_at("bfloat16")
    cos = float(g32 @ g16 / (g32.norm() * g16.norm()))
    assert cos >= COSINE, cos
    assert not torch.equal(g32, g16)  # the bf16 step did compute in bf16


def test_bf16_loss_decreases(tiny_bundle):
    """A few bf16 generator steps on one batch lower the loss."""
    config, params = tiny_bundle
    tparams = _leaves(params)
    train_step = step.make_train_step(config, tparams, torch.optim.Adam(tparams.values(), 1e-3),
                                      SEGMENT, mel_kwargs=MEL_KWARGS,
                                      compute_dtype="bfloat16")
    batch = step.batch_to(_batch(config, 23), "cpu")
    noise = step.draw_noise(config, batch, torch.Generator().manual_seed(42))
    losses = [float(train_step(batch, noise=noise).loss) for _ in range(5)]
    assert losses[-1] < losses[0], losses
