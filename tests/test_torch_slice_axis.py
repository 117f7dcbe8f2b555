"""The port's 'slice' mesh axis against JAX's slice mesh.

Unit part (no processes): ``make_mesh(slices=)`` against JAX's ``make_mesh``
(axis names, shape, slice-major device order, the count mismatch's message);
the ranks of every in-slice, cross-slice and model group
(``parallel/mesh.py::axis_rank_sets``) against the device ids along that axis
of JAX's mesh; the rows a ``(slice, data)`` rank holds (``microbatch_rows``)
against the rows ``jax.device_put(x, data_sharding(mesh))`` places on that
device, microbatch by microbatch (where a microbatch divides over the data
entries: JAX cannot place two rows on four); ZeRO-1's owners over the data
ranks of one slice alone.

Process part: two worlds of four OS processes (``tests/test_torch_dp_worker.py``,
scenario ``slice_axis``), started together, join over ``torch.distributed`` on
the CPU as ``slice=2 x data=2 x model=1`` (``s2d2``) and ``slice=2 x data=1 x
model=2`` (``s2m2``) and run the port's GAN step on the same global batch
(B=4, unequal lengths) and the JAX package's own noise for it (the batch and
key of ``test_torch_train_dp.py``). The references are computed here while the
workers run: JAX's ``make_gan_train_step`` on ``make_mesh(slices=2, data=2)``
and ``make_mesh(slices=2, data=1, model=2)`` of the virtual CPU devices, JAX's
flat ``data=2`` step (the same function), and the port's one-process step.

JAX's slice mesh with a model axis doubles every grouped conv's weight gradient
against its flat step, as its ``data=2 x model=2`` mesh does
(``test_torch_tensor_parallel.py``);
:func:`test_jax_slice_by_model_mesh_doubles_grouped_conv_gradients` pins it,
and where JAX's two steps disagree the port's ``s2m2`` world is held against
the flat step.

Tolerances (none new):

* losses: ``test_torch_train_step.py``'s 1e-5 relative to max(1, |ref|);
  gradients: relative L2 2e-4 per tensor (``test_torch_tensor_parallel.py``'s
  bounds: the ranks sum in another order, fp32 noise of the same size);
* every rank's metrics and gradients bit-identical (two ranks a level: a + b
  is b + a), in ``s2m2`` the split gradients across one model index;
* each reduction of gradients and metrics: an all-reduce over the two ranks
  of the slice, one of the rank's half over the two ranks across slices, then
  each half broadcast over the slice; never a call over all four (in ``s2m2`` a
  slice holds one data rank: its stages are skipped);
* ZeRO-1 at ``s2d2`` against the replicated optimizer, three AdamW steps:
  bit-identical parameters; each rank owns about half of the optimizer state,
  the same half as its counterpart in the other slice.
"""

import concurrent.futures
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
    fixture_params,
    free_port,
    leaves,
    make_batch,
    spawn,
    wait_all,
)
from tests.test_torch_tensor_parallel import _grad_agrees, _loss_agrees, _reassembled
from tests.test_torch_train_dp import _jax_data_parallel_step, _port_step
from tests.test_torch_train_step import _assert_close, _assert_grad_close, _jax_noise, _recording
from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.parallel import mesh as jax_mesh
from vits_tpu.train import step as jax_step
from vits_tpu_torch.parallel import mesh
from vits_tpu_torch.parallel.mesh import (
    DataParallel,
    axis_rank_sets,
    make_mesh,
    microbatch_rows,
    zero1_owners,
)
from vits_tpu_torch.train import step
from vits_tpu_torch.train.schedule import vits_optimizer

KEY = 5  # test_torch_train_dp.py's
FIELDS = step.GanTrainMetrics._fields
WORLDS = {"s2d2": (2, 1), "s2m2": (2, 2)}  # label: (slices, model), four ranks each
LAYOUTS = [(2, 2, 1), (2, 1, 2), (2, 2, 2)]  # (slices, data, model)


def _jax_slice_step(config, gen_np, disc_np, batch, key, slices, data, model):
    """JAX's GAN step on a slices x data x model mesh, the generator sharded by the
    rules where the mesh has a model axis: G at lr 0 and D by -g, each recording
    its gradient."""
    jmesh = jax_mesh.make_mesh(data=data, model=model, slices=slices,
                               devices=jax.devices()[:slices * data * model])
    jstep = jax_step.make_gan_train_step(config, _recording(0.0), _recording(1.0),
                                         segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS,
                                         donate=False)
    with jmesh, jax.default_matmul_precision("highest"):
        gp = jax_mesh.shard_params(gen_np, jmesh, model_parallel=model > 1)
        dp = jax_mesh.shard_params(disc_np, jmesh, model_parallel=False)
        sharded = jax_step.TrainBatch(*(None if x is None else jax.device_put(
            x, jax_mesh.data_sharding(jmesh)) for x in batch))
        _, _, grads_g, grads_d, metrics = jstep(gp, dp, _recording(0.0).init(gp),
                                                _recording(1.0).init(dp), sharded, key)
    return ({k: float(v) for k, v in metrics._asdict().items()},
            {k: np.asarray(v) for k, v in grads_g.items()},
            {k: np.asarray(v) for k, v in grads_d.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    config, gen_np, disc_np = fixture_params()
    jconfig, _, jparams = jax_load_ggml(FIXTURE)
    batch_np = make_batch(config, 0)
    key = jax.random.PRNGKey(KEY)
    noise = _jax_noise(jconfig, batch_np, key)
    arrays = {f"batch.{k}": v for k, v in batch_np._asdict().items() if v is not None}
    arrays.update({f"noise.{k}": v.numpy() for k, v in noise._asdict().items()})
    outs, procs = {}, []
    for label, (slices, model) in WORLDS.items():
        outs[label] = str(tmp_path_factory.mktemp(f"slice_{label}"))
        np.savez(os.path.join(outs[label], "inputs.npz"), **arrays)
        port = free_port()
        procs += [spawn("slice_axis", r, 4, port, outs[label], slices, model)
                  for r in range(4)]
    try:
        # the three JAX steps compile and run on threads of their own
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {label: pool.submit(_jax_slice_step, jconfig, jparams, disc_np, batch_np,
                                          key, 2, 4 // (2 * model), model)
                       for label, (_, model) in WORLDS.items()}
            futures["d2"] = pool.submit(_jax_data_parallel_step, jconfig, jparams, disc_np,
                                        batch_np, key)
            with torch.backends.mkldnn.flags(enabled=False):  # the workers' setting
                one = _port_step(config, gen_np, disc_np, step.batch_to(batch_np, "cpu"), noise)
            jax_runs = {label: f.result() for label, f in futures.items()}
    finally:
        wait_all(procs)
    results = {}
    for label in WORLDS:
        reports = []
        for r in range(4):
            with open(os.path.join(outs[label], f"slice-report-{r}.json")) as f:
                reports.append(json.load(f))
        ranks = []
        for r in range(WORLDS[label][1]):  # data index 0's model ranks
            with np.load(os.path.join(outs[label], f"slice-arrays-{r}.npz")) as f:
                ranks.append({k: f[k] for k in f.files})
        results[label] = {"reports": reports, "arrays": ranks, "jax": jax_runs[label]}
    yield {"gen": gen_np, "jax_d2": jax_runs["d2"], "one": one, **results}
    for out in outs.values():
        shutil.rmtree(out, ignore_errors=True)


# ---------------------------------------------------------------- unit part


@pytest.mark.parametrize("kw", [dict(slices=2, data=2, model=2), dict(slices=2, model=1),
                                dict(slices=2, model=2), dict(data=4, model=2)])
def test_make_mesh_matches_jax(monkeypatch, kw):
    """Axis names, shape and device order (slice-major) of JAX's mesh over eight
    devices: the port's mesh over eight distinct entries (their indices)."""
    want = jax_mesh.make_mesh(devices=jax.devices()[:8], **kw)
    got = make_mesh(devices=["cpu"] * 8, **kw)
    assert got.axis_names == want.axis_names
    assert got.devices.shape == want.devices.shape
    assert got.shape == dict(zip(want.axis_names, want.devices.shape))
    assert all(d == torch.device("cpu") for d in got.devices.flat)
    monkeypatch.setattr(mesh, "_mesh_device", lambda d: d)
    order = make_mesh(devices=list(range(8)), **kw)
    np.testing.assert_array_equal(order.devices.astype(int),
                                  np.vectorize(lambda d: d.id)(want.devices))


@pytest.mark.parametrize("kw", [dict(slices=2, data=3), dict(slices=3), dict(slices=2, model=3),
                                dict(slices=4, data=2, model=1)])
def test_make_mesh_count_mismatch_raises_jax_message(kw):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(devices=jax.devices()[:4], **kw)
    with pytest.raises(ValueError) as got:
        make_mesh(devices=["cpu"] * 4, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rank_layout_matches_jax_mesh(layout):
    """The world ranks of every in-slice data group, cross-slice group and model
    group: the device ids along that axis of JAX's mesh (rank r on device r)."""
    slices, data, model = layout
    world = slices * data * model
    ids = np.vectorize(lambda d: d.id)(jax_mesh.make_mesh(
        data=data, model=model, slices=slices, devices=jax.devices()[:world]).devices)
    sets = axis_rank_sets(world, model, slices)
    assert sets["slice"] == [list(ids[s, :, m]) for s in range(slices) for m in range(model)]
    assert sets["cross"] == [list(ids[:, d, m]) for d in range(data) for m in range(model)]
    assert sets["model"] == [list(ids[s, d, :]) for s in range(slices) for d in range(data)]
    assert sets["data"] == [list(ids[:, :, m].ravel()) for m in range(model)]


# B=4 at grad_accum=2 on four data entries is left out: JAX cannot place a
# microbatch of two rows on four devices
ROW_CASES = [(layout, B, accum) for layout in LAYOUTS
             for B, accum in ((4, 1), (8, 1), (8, 2), (4, 2))
             if (B // accum) % (layout[0] * layout[1]) == 0]


@pytest.mark.parametrize("layout,B,grad_accum", ROW_CASES)
def test_rank_rows_match_jax_data_sharding(layout, B, grad_accum):
    """Each microbatch's rows on a (slice, data) rank: the rows JAX's
    ``data_sharding`` places on that rank's device (every device of a model
    group holds the same)."""
    slices, data, model = layout
    world, entries = slices * data * model, slices * data
    m = B // grad_accum
    jmesh = jax_mesh.make_mesh(data=data, model=model, slices=slices,
                               devices=jax.devices()[:world])
    rows = np.arange(B)
    for i in range(grad_accum):
        placed = jax.device_put(rows[i * m:(i + 1) * m], jax_mesh.data_sharding(jmesh))
        held = {shard.device.id: np.asarray(shard.data) for shard in placed.addressable_shards}
        assert sorted(held) == list(range(world))
        for rank in range(world):
            np.testing.assert_array_equal(
                microbatch_rows(B, entries, rank // model, grad_accum)[i], held[rank])


def test_zero1_owners_split_over_the_slice_data_ranks():
    """ZeRO-1 at slice=2 x data=2: the owners split over the two data ranks of a
    slice (zero1_owners at 2, JAX's split over 'data' alone), the same in
    either slice; without a slice axis over all four."""
    _, gen_np, _ = fixture_params()
    gen = leaves(gen_np)
    numels = [v.size for v in gen_np.values()]
    owned = []
    for rank in range(4):
        opt = vits_optimizer(gen, zero1=DataParallel(4, rank, None, 2))
        assert opt.shard[:2] == (2, rank % 2)
        owned.append({n for i, n in enumerate(opt.names) if opt.owns(i)})
    assert owned[0] == owned[2] and owned[1] == owned[3]
    assert not owned[0] & owned[1] and owned[0] | owned[1] == set(gen_np)
    assert owned[0] == {n for n, o in zip(gen_np, zero1_owners(numels, 2)) if o == 0}
    flat = vits_optimizer(gen, zero1=DataParallel(4, 1))
    assert flat.shard[:2] == (4, 1) and flat.owners == zero1_owners(numels, 4)


# ---------------------------------------------------------------- process part


def _reference(runs, label):
    """JAX's step on the world's slice mesh; where it disagrees with JAX's flat
    data=2 step (the same function), the flat step's value (module docstring)."""
    metrics, grads_g, grads_d = runs[label]["jax"]
    d2_metrics, d2_g, d2_d = runs["jax_d2"]
    return ({k: v if _loss_agrees(v, d2_metrics[k]) else d2_metrics[k]
             for k, v in metrics.items()},
            {k: v if _grad_agrees(v, d2_g[k]) else d2_g[k] for k, v in grads_g.items()},
            {k: v if _grad_agrees(v, d2_d[k]) else d2_d[k] for k, v in grads_d.items()})


def _port_grads(runs, label):
    arrays = runs[label]["arrays"]
    gen = (_reassembled(runs["gen"], arrays) if len(arrays) > 1
           else {k[2:]: v for k, v in arrays[0].items() if k.startswith("g.")})
    return gen, {k[2:]: v for k, v in arrays[0].items() if k.startswith("d.")}


@pytest.mark.parametrize("label", list(WORLDS))
def test_groups_hold_the_layout_ranks(runs, label):
    """Each rank's in-slice, cross-slice and model groups hold the ranks of
    ``axis_rank_sets``; its place on the data axis is slice-major."""
    slices, model = WORLDS[label]
    sets = axis_rank_sets(4, model, slices)
    for report in runs[label]["reports"]:
        r = report["rank"]
        for name, ranks in report["groups"].items():
            assert ranks == next(s for s in sets[name] if r in s), (r, name)
        assert report["data_rank"] == r // model
        assert (report["slice"], report["in_slice"], report["model"]) == (
            r // (4 // slices), (r // model) % (4 // (slices * model)), r % model)
    assert ("model" in runs[label]["reports"][0]["groups"]) == (model > 1)


@pytest.mark.parametrize("label", list(WORLDS))
def test_losses_match_jax_slice_mesh_step(runs, label):
    want = _reference(runs, label)[0]
    for report in runs[label]["reports"]:
        for name, got in zip(FIELDS, report["metrics"]):
            _assert_close(got, want[name], what=f"rank {report['rank']} {name}")


@pytest.mark.parametrize("label", list(WORLDS))
def test_gradients_match_jax_slice_mesh_step(runs, label):
    _, want_g, want_d = _reference(runs, label)
    got_g, got_d = _port_grads(runs, label)
    assert got_g.keys() == want_g.keys() and got_d.keys() == want_d.keys()
    for got, want in ((got_g, want_g), (got_d, want_d)):
        for name, g in got.items():
            _assert_grad_close(g, want[name], what=name)


def test_slice_by_data_world_matches_one_process_step(runs):
    """s2d2 against the port's one-process step on the same inputs."""
    want_metrics, want_g, want_d = runs["one"]
    for name, got in zip(FIELDS, runs["s2d2"]["reports"][0]["metrics"]):
        _assert_close(got, want_metrics[name], what=name)
    got_g, got_d = _port_grads(runs, "s2d2")
    for got, want in ((got_g, want_g), (got_d, want_d)):
        for name, g in got.items():
            _assert_grad_close(g, want[name], what=name)


def test_jax_slice_by_data_mesh_agrees_with_its_flat_step(runs):
    """JAX's slice=2 x data=2 step and its flat data=2 step (the same function)
    agree on every loss and gradient: the s2d2 world's reference is JAX's own."""
    metrics, grads_g, grads_d = runs["s2d2"]["jax"]
    d2_metrics, d2_g, d2_d = runs["jax_d2"]
    assert all(_loss_agrees(metrics[k], d2_metrics[k]) for k in metrics)
    for got, want in ((grads_g, d2_g), (grads_d, d2_d)):
        assert [k for k in want if not _grad_agrees(got[k], want[k])] == []


def test_jax_slice_by_model_mesh_doubles_grouped_conv_gradients(runs):
    """The reference's fault: JAX's slice=2 x data=1 x model=2 step and its flat
    data=2 step disagree only on the grouped convs' weight gradients, by a factor
    of 2, and on the feature-matching loss through the discriminator they update;
    on those the port's s2m2 world agrees with the flat step."""
    metrics, grads_g, grads_d = runs["s2m2"]["jax"]
    d2_metrics, d2_g, d2_d = runs["jax_d2"]
    grouped = [k for k in grads_g if ".convs_dilated." in k and k.endswith(".weight")]
    grouped_d = [f"discriminator.msd.convs.{i}.weight" for i in range(1, 5)]
    for want, got, names in ((d2_g, grads_g, grouped), (d2_d, grads_d, grouped_d)):
        assert [k for k in want if not _grad_agrees(got[k], want[k])] == names
        for k in names:
            np.testing.assert_allclose(got[k], 2 * want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert [k for k in metrics if not _loss_agrees(metrics[k], d2_metrics[k])] == [
        "feature_matching"]
    port_g, _ = _port_grads(runs, "s2m2")
    for k in grouped:
        _assert_grad_close(port_g[k], d2_g[k], what=k)
    report = runs["s2m2"]["reports"][0]
    _assert_close(report["metrics"][FIELDS.index("feature_matching")],
                  d2_metrics["feature_matching"], what="feature_matching")


@pytest.mark.parametrize("label", list(WORLDS))
def test_ranks_bit_identical(runs, label):
    """Every rank returns the same metrics and holds the same replicated
    gradients; the split ones are the same across the ranks of a model index."""
    reports = runs[label]["reports"]
    for key in ("metrics", "replicated_grad_digest"):
        assert len({json.dumps(r[key]) for r in reports}) == 1, key
    model = WORLDS[label][1]
    for m in range(model):
        assert len({r["split_grad_digest"] for r in reports if r["model"] == m}) == 1


@pytest.mark.parametrize("label", list(WORLDS))
def test_two_level_reduction(runs, label):
    """The gradient and metric sums of one GAN step (the discriminator's, the
    generator's, the metrics'): each an all-reduce over the two ranks of the
    slice, an all-reduce of this rank's half over the two ranks across slices,
    then each half broadcast over the slice (s2m2: a slice holds one data rank,
    so the cross-slice all-reduce of the whole buffer alone); never a call over
    all four."""
    slices, model = WORLDS[label]
    per_sum = ([["all_reduce", "slice", 2], ["all_reduce", "cross", 2],
                ["broadcast", "slice", 2], ["broadcast", "slice", 2]] if model == 1
               else [["all_reduce", "cross", 2]])
    for report in runs[label]["reports"]:
        calls = report["collectives"]
        assert all(size < 4 for _, _, size in calls)
        assert [c for c in calls if c[1] != "model"] == per_sum * 3
        assert all(size == model for _, name, size in calls if name == "model")
        assert any(name == "model" for _, name, _ in calls) == (model > 1)


def test_zero1_under_slices_matches_the_replicated_optimizer(runs):
    """s2d2, three AdamW generator steps: ZeRO-1 over each slice's two data ranks
    gives the replicated optimizer's losses and parameters bit for bit on every
    rank; a rank owns about half of the optimizer state, as its counterpart in
    the other slice does."""
    reports = runs["s2d2"]["reports"]
    for report in reports:
        assert report["zero1_True_losses"] == report["zero1_False_losses"]
        assert report["zero1_True_param_digest"] == report["zero1_False_param_digest"]
        assert 0.4 <= report["moment_share"] <= 0.6
    assert len({r["zero1_True_param_digest"] for r in reports}) == 1
    owned = {(r["slice"], r["in_slice"]): set(r["owned"]) for r in reports}
    assert owned[0, 0] == owned[1, 0] and owned[0, 1] == owned[1, 1]
    assert not owned[0, 0] & owned[0, 1] and owned[0, 0] | owned[0, 1] == set(runs["gen"])
