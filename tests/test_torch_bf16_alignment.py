"""bf16 against fp32 generator gradients on one fixed alignment, in the port and in JAX.

``chip_smoke.py``'s phase 10b holds the bf16 generator gradients against the
fp32 ones per module on the card, with the fp32 run's alignment substituted for
MAS in the bf16 run, so that MAS cannot hand the two runs different durations.
Every module holds a cosine of 0.97 there but the duration predictor. Here the
same comparison runs on the CPU through the port and, for the duration
predictor, through the JAX package (eager, the port's oracle at bf16:
``tests/test_torch_train_bf16.py``; differentiated with respect to that
module's parameters alone, which only the duration NLL reaches), on
``tiny_bundle`` and one seeded batch:

* every other module of the port at or above 0.97;
* the duration predictor below 0.97 in JAX too: it runs fp32 in both dtypes
  (``BF16_SUBTREES`` are the text encoder and the decoder), and its gradient
  turns the bf16 encoder's states, its one input that bf16 moves, into a
  cosine of 0.53 on this batch (-0.75 on the batch of seed 19). The figure is
  the reference's; the port is held at JAX's own figure, within DP_FIGURE_ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import MEL_KWARGS, SEGMENT, _batch, _jax_noise, _leaves
from vits_tpu.train import step as jax_step
from vits_tpu_torch.train import step

torch.set_num_threads(2)

COSINE = 0.97  # chip_smoke.py's BF16_COSINE, the JAX package's own bound
DP_FIGURE_ATOL = 0.01  # the port's duration-predictor cosine against JAX's
DP = "duration_predictor."


def _cosines(got: dict, want: dict) -> dict:
    by = {}
    for name in sorted(want):
        by.setdefault(name.split(".")[0], []).append(name)
    out = {}
    for module, names in by.items():
        a = np.concatenate([np.asarray(got[n], np.float64).ravel() for n in names])
        b = np.concatenate([np.asarray(want[n], np.float64).ravel() for n in names])
        out[module] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
    return out


def _jax_fixed(params, config, batch, key, monkeypatch) -> dict:
    """JAX's cosine of bf16 against fp32 on the fp32 run's alignment, for the duration
    predictor: the generator loss's gradient with respect to its parameters alone
    (only the duration NLL reaches them), so that the backward is that module's."""
    seen = []
    align = jax_step.monotonic_align
    fixed = {k: jnp.asarray(v) for k, v in params.items() if not k.startswith(DP)}

    def grads(dtype):
        def loss_fn(dp):
            return jax_step.generator_loss({**fixed, **dp}, config, batch, key, SEGMENT,
                                           mel_kwargs=MEL_KWARGS, compute_dtype=dtype)[0]

        g = jax.grad(loss_fn)({k: jnp.asarray(v) for k, v in params.items()
                               if k.startswith(DP)})
        return {k: np.asarray(v) for k, v in g.items()}

    monkeypatch.setattr(jax_step, "monotonic_align",
                        lambda *a: seen.append(align(*a)) or seen[-1])
    fp32 = grads(None)
    monkeypatch.setattr(jax_step, "monotonic_align", lambda *a: seen[0])
    return _cosines(grads("bfloat16"), fp32)


def _port_fixed(params, config, batch, key, monkeypatch) -> dict:
    """The port's, on the same batch and JAX's noise."""
    seen = []
    align = step.monotonic_align
    tbatch, noise = step.batch_to(batch, "cpu"), _jax_noise(config, batch, key)

    def grads(dtype):
        leaves = _leaves(params)
        loss, _ = step.generator_loss(leaves, config, tbatch, noise, SEGMENT,
                                      mel_kwargs=MEL_KWARGS, compute_dtype=dtype)
        return dict(zip(leaves, (g.numpy() for g in step.gradients(loss, leaves))))

    monkeypatch.setattr(step, "monotonic_align", lambda *a: seen.append(align(*a)) or seen[-1])
    fp32 = grads(None)
    monkeypatch.setattr(step, "monotonic_align", lambda *a: seen[0])
    return _cosines(grads("bfloat16"), fp32)


@pytest.mark.parametrize("seed", [3])
def test_fixed_alignment_cosines_match_jax(tiny_bundle, monkeypatch, seed):
    config, params = tiny_bundle
    batch = _batch(config, seed, B=2, T=12, S=48, lengths=((12, 48), (9, 40)))
    key = jax.random.PRNGKey(5)
    want = _jax_fixed(params, config, batch, key, monkeypatch)
    got = _port_fixed(params, config, batch, key, monkeypatch)
    print(f"  seed {seed}: jax {want}\n  port {got}")
    dp = "duration_predictor"
    assert set(want) == {dp} and want[dp] < COSINE, want  # the reference's own figure
    assert abs(got[dp] - want[dp]) <= DP_FIGURE_ATOL, (got, want)
    assert set(got) == {"text_encoder", "posterior_encoder", "flow", dp, "decoder"}, got
    assert all(c >= COSINE for m, c in got.items() if m != dp), got
