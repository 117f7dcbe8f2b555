"""grad_accum microbatches that do not divide over the data ranks, against JAX's step.

Six rows at ``grad_accum=2`` make microbatches of three rows; over a data axis
of two, one rank holds two rows of each and the other one
(``parallel/mesh.py::microbatch_rows``). The port's GAN step runs so on two
gloo ranks (``data=2``) and on four (``data=2 x model=2``, the generator split
over the model axis), workers of ``tests/test_torch_dp_worker.py`` (scenario
``uneven``), each handed the same global batch and the JAX package's own noise
for it (microbatch i's rows drawn from ``fold_in(key, i)``, as JAX draws them). The
reference is JAX's ``make_gan_train_step(grad_accum=2)`` on a
``data=2`` mesh of two CPU devices (GSPMD runs the uneven microbatches),
computed here while the workers run. Then, at a data axis of two, three AdamW
generator steps at ``grad_accum=2`` on two-row batches: every microbatch is one
row, so data rank 0 holds none of it and adds zeros without running the model;
held against the one-process port step at ``grad_accum=2``.

Tolerances, and why (``test_torch_train_dp.py``'s bounds, set there):

* losses against JAX and against the one-process step: 1e-5 relative to
  max(1, |ref|); gradients: relative L2 2e-4 per tensor (the ranks sum partial
  losses and gradients in another order, fp32 noise of that size);
* the ranks against each other: bit-identical metrics (the SUM all-reduce
  hands every rank the same bits), gradients within a data group's model
  index bit-identical, ZeRO-1 against the replicated optimizer bit-identical
  parameters after three steps.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_dp_worker import (
    FIXTURE,
    MEL_KWARGS,
    SEGMENT,
    UNEVEN_LENGTHS,
    fixture_params,
    free_port,
    leaves,
    make_batch,
    spawn,
    step_inputs,
    wait_all,
)
from tests.test_torch_tensor_parallel import _reassembled
from tests.test_torch_train_step import (
    _assert_close,
    _assert_grad_close,
    _jax_noise,
    _recording,
)
from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.parallel.mesh import data_sharding, make_mesh, shard_params
from vits_tpu.train import step as jax_step
from vits_tpu_torch.train import step
from vits_tpu_torch.train.schedule import vits_optimizer

torch.set_num_threads(2)

KEY = 5  # test_torch_train_dp.py's
FIELDS = step.GanTrainMetrics._fields
WORLDS = {"d2": (2, 1), "d2m2": (4, 2)}  # label: (ranks, model)


def _jax_accum_step(config, gen_np, disc_np, batch, key):
    """JAX's GAN step at grad_accum=2 on a data=2 mesh: G at lr 0 and D by -g,
    each recording its gradient."""
    mesh = make_mesh(data=2, devices=jax.devices()[:2])
    jstep = jax_step.make_gan_train_step(config, _recording(0.0), _recording(1.0),
                                         segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS,
                                         grad_accum=2, donate=False)
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


def _jax_accum_noise(config, batch, key, n: int = 2) -> step.TrainNoise:
    """The draws of JAX's step at grad_accum=n for ``key``: microbatch i's rows from
    ``fold_in(key, i)`` (``vits_tpu/train/step.py::_microbatch_keys``), as one TrainNoise."""
    m = batch.input_ids.shape[0] // n
    parts = [_jax_noise(config, jax_step.TrainBatch(*(None if x is None else x[i * m:(i + 1) * m]
                                                      for x in batch)),
                        jax.random.fold_in(key, i)) for i in range(n)]
    return step.TrainNoise(*(torch.cat(ts) for ts in zip(*parts)))


def _one_process_small_steps(config, gen_np):
    """Three AdamW generator steps at grad_accum=2 on the workers' two-row batches."""
    gen = leaves(gen_np)
    fn = step.make_train_step(config, gen, vits_optimizer(gen), SEGMENT, mel_kwargs=MEL_KWARGS,
                              grad_accum=2)
    metrics = []
    for s in (1, 2, 3):
        batch, noise = step_inputs(config, s, rows=2)
        metrics.append([float(v) for v in fn(batch, noise=noise)])
    return metrics


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    config, gen_np, disc_np = fixture_params()
    jconfig, _, jparams = jax_load_ggml(FIXTURE)
    batch_np = make_batch(config, 0, UNEVEN_LENGTHS)
    key = jax.random.PRNGKey(KEY)
    noise = _jax_accum_noise(jconfig, batch_np, key)
    arrays = {f"batch.{k}": v for k, v in batch_np._asdict().items() if v is not None}
    arrays.update({f"noise.{k}": v.numpy() for k, v in noise._asdict().items()})
    outs, procs = {}, []
    for label, (world, model) in WORLDS.items():
        outs[label] = str(tmp_path_factory.mktemp(f"uneven_{label}"))
        np.savez(os.path.join(outs[label], "inputs.npz"), **arrays)
        port = free_port()
        procs += [spawn("uneven", r, world, port, outs[label], model) for r in range(world)]
    try:
        jax_run = _jax_accum_step(jconfig, jparams, disc_np, batch_np, key)
        with torch.backends.mkldnn.flags(enabled=False):  # the workers' setting
            small = _one_process_small_steps(config, gen_np)
    finally:
        wait_all(procs)
    results = {}
    for label, (world, model) in WORLDS.items():
        reports = []
        for r in range(world):
            with open(os.path.join(outs[label], f"uneven-report-{r}.json")) as f:
                reports.append(json.load(f))
        ranks = []
        for r in range(model):  # data index 0's model ranks
            with np.load(os.path.join(outs[label], f"uneven-arrays-{r}.npz")) as f:
                ranks.append({k: f[k] for k in f.files})
        results[label] = {"reports": reports, "arrays": ranks}
    yield {"gen": gen_np, "jax": jax_run, "small": small, **results}
    for out in outs.values():
        shutil.rmtree(out, ignore_errors=True)


@pytest.mark.parametrize("label", list(WORLDS))
def test_uneven_microbatch_losses_match_jax(run, label):
    want = run["jax"][0]
    for report in run[label]["reports"]:
        for name, got in zip(FIELDS, report["metrics"]):
            _assert_close(got, want[name], what=f"rank {report['rank']} {name}")


@pytest.mark.parametrize("label", list(WORLDS))
def test_uneven_microbatch_gradients_match_jax(run, label):
    _, want_g, want_d = run["jax"]
    arrays = run[label]["arrays"]
    got = _reassembled(run["gen"], arrays) if label == "d2m2" else {
        k[2:]: v for k, v in arrays[0].items() if k.startswith("g.")}
    assert got.keys() == want_g.keys()
    for name, g in got.items():
        _assert_grad_close(g, want_g[name], what=name)
    for name, g in want_d.items():
        _assert_grad_close(arrays[0][f"d.{name}"], g, what=name)


@pytest.mark.parametrize("label", list(WORLDS))
def test_uneven_ranks_agree_bit_for_bit(run, label):
    """Every rank returns the same global metrics; the ranks of one model index
    hold the same gradients."""
    reports = run[label]["reports"]
    assert len({json.dumps(r["metrics"]) for r in reports}) == 1
    for m in {r["model"] for r in reports}:
        assert len({r["grad_digest"] for r in reports if r["model"] == m}) == 1


@pytest.mark.parametrize("label", list(WORLDS))
def test_rank_without_rows_steps_with_the_others(run, label):
    """Two-row batches at grad_accum=2 (data rank 0 holds no row of any microbatch):
    three AdamW steps' metrics against the one-process step's, ZeRO-1 bit-identical
    to the replicated optimizer."""
    for report in run[label]["reports"]:
        for got_step, want_step in zip(report["small_zero1_False_metrics"], run["small"]):
            for name, got, want in zip(step.TrainMetrics._fields, got_step, want_step):
                _assert_close(got, want, what=f"rank {report['rank']} {name}")
        assert report["small_zero1_True_metrics"] == report["small_zero1_False_metrics"]
        assert report["small_zero1_True_param_digest"] == report["small_zero1_False_param_digest"]
