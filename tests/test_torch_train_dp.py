"""The port's data-parallel training step on two gloo ranks, against JAX's.

Two OS processes (``tests/test_torch_dp_worker.py``, scenario ``steps``) join
over ``torch.distributed`` on the CPU and run the port's GAN step with
``data_parallel=``: each is handed the same global batch (B=4, unequal token
and frame lengths) and the JAX package's own noise for it, and computes its
two rows. The reference is JAX's ``make_gan_train_step`` on a ``data=2`` mesh
of two CPU devices, the batch sharded over 'data' (GSPMD computes the global
batch's losses). While the workers run, this process computes JAX's step and
the one-process port steps the ranks are also held against.

Tolerances, and why:

* losses and gradients against JAX: ``test_torch_train_step.py``'s
  ``_assert_close`` (1e-5 relative to max(1, |ref|)) and
  ``_assert_grad_close`` (relative L2 2e-4 per tensor, set from the JAX
  reference's own fp32 noise): the ranks sum partial losses and gradients in
  another order than one process, which is fp32 noise of the same size;
* MAS durations: equal;
* ranks against each other: bit-identical metrics and gradients (the SUM
  all-reduce hands every rank the same bits), and bit-identical parameters
  after two AdamW steps;
* ``grad_accum=2`` on two ranks against the one-process port step at
  ``grad_accum=2``: the same two tolerances;
* bf16 on two ranks against the one-process bf16 port step: the bounds of
  ``test_torch_train_bf16.py``, as fractions of the one-process step's own
  bf16-versus-fp32 gap (losses 0.5 of it, each module's gradients 0.5 of its
  relative L2 gap): a rank's bf16 weight gradient is rounded before the ranks
  sum it, so the two-rank step differs from the one-process one by bf16
  noise, well inside the gap;
* ZeRO-1 against the replicated optimizer on two ranks, three generator
  steps: bit-identical parameters (the owner runs the same AdamW arithmetic
  and broadcasts fp32 values exactly); its checkpoint resumed in one process
  without ZeRO-1: step 3's loss within ``_assert_close`` of the uninterrupted
  two-rank run's (one process sums the batch in another order).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dp_worker import (
    FIXTURE,
    MEL_KWARGS,
    SEGMENT,
    fixture_params,
    free_port,
    leaves,
    make_batch,
    spawn,
    step_inputs,
    wait_all,
)
from tests.test_torch_train_bf16 import GRAD_GAP_FRACTION, LOSS_GAP_FRACTION
from tests.test_torch_train_step import (
    _assert_close,
    _assert_grad_close,
    _jax_noise,
    _recording,
)
from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.parallel.mesh import data_sharding, make_mesh, shard_params
from vits_tpu.train import step as jax_step
from vits_tpu_torch.parallel.mesh import zero1_owners
from vits_tpu_torch.train import step
from vits_tpu_torch.train.checkpoint import restore_checkpoint
from vits_tpu_torch.train.schedule import vits_optimizer

torch.set_num_threads(2)

KEY = 5
FIELDS = step.GanTrainMetrics._fields


def _jax_durations(params, config, batch, key):
    """MAS durations of ``vits_tpu`` ``generator_forward`` for ``key`` (its first half)."""
    from vits_tpu.io.params import ParamView
    from vits_tpu.models.encoder import text_encoder
    from vits_tpu.models.flow import residual_coupling_block
    from vits_tpu.models.posterior import posterior_encoder
    from vits_tpu.ops.align import monotonic_align, prior_log_likelihood

    p = ParamView({k: jnp.asarray(v) for k, v in params.items()})
    k_post, _, _ = jax.random.split(key, 3)
    B, S, _ = batch.spectrogram.shape
    fm3, tm3 = batch.frame_mask[..., None], batch.token_mask[..., None]
    noise = jax.random.normal(k_post, (B, S, config.flow_size))
    z, _, _ = posterior_encoder(p, config, batch.spectrogram, fm3, noise, None)
    z_p, _ = residual_coupling_block(p, config, z, fm3, None, reverse=False)
    enc = text_encoder(p, config, batch.input_ids, tm3, batch.token_mask, trainable=True)
    log_lik = prior_log_likelihood(z_p, enc.prior_means, enc.prior_log_variances)
    return np.asarray(monotonic_align(log_lik, batch.frame_mask, batch.token_mask).sum(axis=1))


def _jax_data_parallel_step(config, gen_np, disc_np, batch, key):
    """JAX's GAN step on a data=2 mesh: G at lr 0 and D by -g, each recording its gradient."""
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    jstep = jax_step.make_gan_train_step(config, _recording(0.0), _recording(1.0),
                                         segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS,
                                         donate=False)
    with mesh, jax.default_matmul_precision("highest"):
        gp = shard_params(gen_np, mesh, model_parallel=False)
        dp = shard_params(disc_np, mesh, model_parallel=False)
        sharded = jax_step.TrainBatch(*(None if x is None else jax.device_put(
            x, data_sharding(mesh)) for x in batch))
        _, _, grads_g, grads_d, metrics = jstep(gp, dp, _recording(0.0).init(gp),
                                                _recording(1.0).init(dp), sharded, key)
    return ({k: float(v) for k, v in metrics._asdict().items()},
            {k: np.asarray(v) for k, v in grads_g.items()},
            {k: np.asarray(v) for k, v in grads_d.items()})


def _port_step(config, gen_np, disc_np, batch, noise, **kw):
    """The one-process port GAN step (G at lr 0, D by -g): metrics and gradients."""
    gen, disc = leaves(gen_np), leaves(disc_np)
    fn = step.make_gan_train_step(config, gen, disc, torch.optim.SGD(list(gen.values()), lr=0.0),
                                  torch.optim.SGD(list(disc.values()), lr=1.0),
                                  segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS, **kw)
    metrics = fn(batch, noise=noise)
    return ({k: float(v) for k, v in metrics._asdict().items()},
            {k: p.grad.numpy() for k, p in gen.items()},
            {k: p.grad.numpy() for k, p in disc.items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_steps"))
    config, gen_np, disc_np = fixture_params()
    jconfig, _, jparams = jax_load_ggml(FIXTURE)
    batch_np = make_batch(config, 0)
    key = jax.random.PRNGKey(KEY)
    noise = _jax_noise(jconfig, batch_np, key)
    arrays = {f"batch.{k}": v for k, v in batch_np._asdict().items() if v is not None}
    arrays.update({f"noise.{k}": v.numpy() for k, v in noise._asdict().items()})
    np.savez(os.path.join(out, "inputs.npz"), **arrays)
    port = free_port()
    procs = [spawn("steps", r, 2, port, out) for r in range(2)]
    try:
        jax_metrics, jax_g, jax_d = _jax_data_parallel_step(jconfig, jparams, disc_np, batch_np,
                                                            key)
        with jax.default_matmul_precision("highest"):
            jax_durations = _jax_durations(jparams, jconfig, batch_np, key)
        batch = step.batch_to(batch_np, "cpu")
        with torch.backends.mkldnn.flags(enabled=False):
            one = {label: _port_step(config, gen_np, disc_np, batch, noise, **kw) for label, kw in
                   (("fp32", {}), ("accum", {"grad_accum": 2}),
                    ("bf16", {"compute_dtype": "bfloat16"}))}
    finally:
        wait_all(procs)
    reports = []
    for r in range(2):
        with open(os.path.join(out, f"report-{r}.json")) as f:
            reports.append(json.load(f))
    with np.load(os.path.join(out, "arrays-0.npz")) as f:
        rank0 = {k: f[k] for k in f.files}
    with np.load(os.path.join(out, "arrays-1.npz")) as f:
        rank1 = {k: f[k] for k in f.files}
    os.remove(os.path.join(out, "arrays-0.npz"))  # ~0.5 GB of gradients
    yield {"out": out, "config": config, "gen": gen_np, "disc": disc_np, "reports": reports,
           "arrays": (rank0, rank1), "jax": (jax_metrics, jax_g, jax_d),
           "jax_durations": jax_durations, "one": one}
    shutil.rmtree(out, ignore_errors=True)


def _grads(arrays, label, net):
    prefix = f"{label}.{net}."
    return {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix)}


def test_two_rank_losses_match_jax_data_parallel_step(run):
    want = run["jax"][0]
    for report in run["reports"]:
        for name, got in zip(FIELDS, report["fp32_metrics"]):
            _assert_close(got, want[name], what=name)


@pytest.mark.parametrize("net", ["g", "d"])
def test_two_rank_gradients_match_jax_data_parallel_step(run, net):
    want = run["jax"][1 if net == "g" else 2]
    got = _grads(run["arrays"][0], "fp32", net)
    assert got.keys() == want.keys()
    for name, g in got.items():
        _assert_grad_close(g, want[name], what=name)


def test_two_rank_mas_durations_equal_jax(run):
    for arrays in run["arrays"]:
        np.testing.assert_array_equal(arrays["durations"], run["jax_durations"][arrays["rows"]])


def test_ranks_agree_bit_for_bit(run):
    """Every rank returns the same (global) metrics and holds the same summed
    gradients; after two AdamW steps the parameters are bit-identical."""
    a, b = run["reports"]
    for key in ("fp32_metrics", "accum_metrics", "bf16_metrics", "adamw_metrics",
                "fp32_grad_digest", "accum_grad_digest", "bf16_grad_digest",
                "adamw_param_digest"):
        assert a[key] == b[key], key
    assert a["adamw_metrics"][0] != a["adamw_metrics"][1]  # the parameters moved


def test_global_normalizers_matter(run):
    """On this batch the mean of the ranks' own KL ratios is not the global KL,
    which the two-rank step does reproduce."""
    per_rank = np.mean([r["kl_own_rows"] for r in run["reports"]])
    global_kl = run["jax"][0]["kl"]
    assert abs(per_rank - global_kl) > 100 * 1e-5 * max(1.0, abs(global_kl))
    _assert_close(run["reports"][0]["fp32_metrics"][FIELDS.index("kl")], global_kl, what="kl")


def test_grad_accum_two_ranks_matches_one_process(run):
    want_metrics, want_g, want_d = run["one"]["accum"]
    for name, got in zip(FIELDS, run["reports"][0]["accum_metrics"]):
        _assert_close(got, want_metrics[name], what=name)
    for net, want in (("g", want_g), ("d", want_d)):
        for name, g in _grads(run["arrays"][0], "accum", net).items():
            _assert_grad_close(g, want[name], what=name)


def _by_module(grads) -> dict[str, np.ndarray]:
    out: dict[str, list] = {}
    for name in sorted(grads):
        out.setdefault(name.split(".")[0], []).append(np.asarray(grads[name], np.float64).ravel())
    return {k: np.concatenate(v) for k, v in out.items()}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_bf16_two_ranks_matches_one_process(run):
    """Within test_torch_train_bf16.py's fractions of the one-process step's
    own bf16-versus-fp32 gap."""
    (bf16_metrics, bf16_g, bf16_d), (fp32_metrics, fp32_g, fp32_d) = (
        run["one"]["bf16"], run["one"]["fp32"])
    for name, got in zip(FIELDS, run["reports"][0]["bf16_metrics"]):
        gap = abs(fp32_metrics[name] - bf16_metrics[name])
        assert abs(got - bf16_metrics[name]) <= LOSS_GAP_FRACTION * gap, name
    for net, want, fp32 in (("g", bf16_g, fp32_g), ("d", bf16_d, fp32_d)):
        got = _by_module(_grads(run["arrays"][0], "bf16", net))
        want, fp32 = _by_module(want), _by_module(fp32)
        for module in want:
            assert _rel(got[module], want[module]) <= GRAD_GAP_FRACTION * _rel(
                fp32[module], want[module]), module
        for name, g in _grads(run["arrays"][0], "bf16", net).items():
            assert g.dtype == np.float32, name  # master gradients stay fp32


def test_zero1_matches_the_replicated_optimizer(run):
    """Three generator steps at world 2: ZeRO-1 gives the replicated run's
    parameters bit for bit, on both ranks."""
    a, b = run["reports"]
    for report in (a, b):
        assert report["zero1_max_abs_diff"] == 0.0
        assert report["zero1_True_losses"] == report["zero1_False_losses"]
    assert a["zero1_param_digest"] == b["zero1_param_digest"]


def test_zero1_moments_are_disjoint_and_balanced(run):
    owned = [set(r["owned"]) for r in run["reports"]]
    assert not owned[0] & owned[1]
    assert owned[0] | owned[1] == set(run["gen"])
    assert all(r["moment_share"] <= 0.6 for r in run["reports"])


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_zero1_owners_balance(run, net):
    """The split of the full parameter sets at world 2 and 4: each rank at most
    0.6 (world 2) or 0.3 (world 4) of the elements, every tensor owned once."""
    params = run["gen"] if net == "generator" else run["disc"]
    numels = [v.size for v in params.values()]
    for world, bound in ((2, 0.6), (4, 0.3)):
        owners = zero1_owners(numels, world)
        assert sorted(set(owners)) == list(range(world))
        for rank in range(world):
            share = sum(n for n, o in zip(numels, owners) if o == rank) / sum(numels)
            assert share <= bound, (world, rank, share)


def test_zero1_checkpoint_resumes_in_one_process(run):
    """The ZeRO-1 run's step-2 checkpoint (written by rank 0 from the gathered
    moments) resumed at world 1 without ZeRO-1: step 3's loss is the
    uninterrupted two-rank run's."""
    config = run["config"]
    restored = restore_checkpoint(os.path.join(run["out"], "zero1_run"))
    assert restored["step"] == 2 and int(restored["gen_opt"]["count"]) == 2
    assert {k[:-len(".exp_avg")] for k in restored["gen_opt"] if k.endswith(".exp_avg")} == set(
        run["gen"])
    gen = leaves(restored["gen_params"])
    opt = vits_optimizer(gen)
    opt.load_state_arrays(restored["gen_opt"])
    fn = step.make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS)
    batch, noise = step_inputs(config, 3)
    with torch.backends.mkldnn.flags(enabled=False):
        loss = float(fn(batch, noise=noise).loss)
    _assert_close(loss, run["reports"][0]["zero1_True_losses"][2], what="step 3 loss")
