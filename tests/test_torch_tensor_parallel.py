"""The port's model axis (tensor parallelism over processes) against JAX's GSPMD step.

Two and four OS processes (``tests/test_torch_dp_worker.py``, scenario
``tensor_parallel``) join over ``torch.distributed`` on the CPU as ``data=1 x
model=2`` and ``data=2 x model=2`` worlds, each rank with its slices of the
tiny fixture's generator (``parallel/mesh.py::shard_params``), and run the
port's GAN step with ``model_parallel=`` on the same global batch (B=4,
unequal lengths) and the JAX package's own noise for it (the batch and key of
``test_torch_train_dp.py``, where these bounds were set). The reference is
JAX's ``make_gan_train_step`` on ``make_mesh(data=1 | 2, model=2)`` of the
virtual CPU devices with ``shard_params(model_parallel=True)`` (GSPMD
partitions the step), computed here while the workers run.

JAX's step on the ``data=2 x model=2`` mesh returns twice the gradient of every
grouped conv's weight (the duration predictor's depthwise convs, the
discriminator's grouped ``msd`` convs) against its own step on ``data=2`` or
on ``model=2`` (the same function), and so its adversarial and
feature-matching losses, which run through the updated discriminator, move
too. :func:`test_jax_two_by_two_mesh_doubles_grouped_conv_gradients` pins that
fault of the reference; where JAX's two steps disagree, the port's
``data=2 x model=2`` world is held against JAX's ``data=2`` step.

Tolerances, and why:

* the rules: ``param_spec`` equal to JAX's on every name, and the split (with
  the fallback to replication where a dimension does not divide) equal to
  where JAX's ``shard_params`` puts 'model', at model 2 and 3, on the tiny
  fixture and on MMS-width random parameters (depth cut);
* losses against JAX: ``test_torch_train_step.py``'s 1e-5 relative to
  max(1, |ref|); gradients, the ranks' slices reassembled (a gate's in the
  tanh-then-sigmoid order of its halves): relative L2 2e-4 per tensor
  (``test_torch_train_dp.py``'s bounds: the ranks sum partial products in
  another order, fp32 noise of the same size);
* replicated tensors (gradients after the step, parameters after three AdamW
  steps) bit-identical on every rank; the split tensors' gradients
  bit-identical across a data group;
* each rank holds 1/2 of every split tensor and of its moments;
* the clip's norm on every rank within 1e-5 relative of the one-process
  step's norm of the same gradients (a norm of the rank's own slices would be
  ~0.7 of it);
* ZeRO-1 under a model axis (``data=2 x model=2``) against the replicated
  optimizer: bit-identical parameters after three AdamW steps;
* each world's checkpoint of step 2 (gathered whole by the writer)
  resumed in one process at ``model=1``: step 3's loss within the losses'
  bound of the uninterrupted multi-rank run's.
"""

import functools
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
    step_inputs,
    wait_all,
)
from tests.test_torch_train_dp import _jax_data_parallel_step
from tests.test_torch_train_step import (
    ATOL,
    GRAD_RTOL,
    ZERO_GRAD,
    _assert_close,
    _assert_grad_close,
    _jax_noise,
    _recording,
)
from vits_tpu.io.loader import load_ggml as jax_load_ggml
from vits_tpu.parallel import mesh as jax_mesh
from vits_tpu.train import step as jax_step
from vits_tpu_torch.parallel.mesh import param_spec, shard_index, split_plan
from vits_tpu_torch.train import step
from vits_tpu_torch.train.checkpoint import restore_checkpoint
from vits_tpu_torch.train.schedule import vits_optimizer

torch.set_num_threads(2)

KEY = 5  # test_torch_train_dp.py's
FIELDS = step.GanTrainMetrics._fields
WORLDS = {"m2": (2, 1), "d2m2": (4, 2)}  # label: (ranks, data)
NORM_RTOL = 1e-5
# The port's two-rank bf16 spread, at most this multiple of JAX's (its largest over
# the losses and the modules' gradients): test_bf16_model_axis_within_jax_spread.
BF16_SPREAD_FACTOR = 2.0


def _jax_model_parallel_step(config, gen_np, disc_np, batch, key, data, model=2,
                             compute_dtype=None):
    """JAX's GAN step on a data x model mesh (data=1, model=1: one device), the
    generator sharded by the rules: G at lr 0 and D by -g, each recording its gradient."""
    mesh = jax_mesh.make_mesh(data=data, model=model, devices=jax.devices()[:model * data])
    jstep = jax_step.make_gan_train_step(config, _recording(0.0), _recording(1.0),
                                         segment_frames=SEGMENT, mel_kwargs=MEL_KWARGS,
                                         donate=False, compute_dtype=compute_dtype)
    with mesh, jax.default_matmul_precision("highest"):
        gp = jax_mesh.shard_params(gen_np, mesh, model_parallel=model > 1)
        dp = jax_mesh.shard_params(disc_np, mesh, model_parallel=False)
        sharded = jax_step.TrainBatch(*(None if x is None else jax.device_put(
            x, jax_mesh.data_sharding(mesh)) for x in batch))
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
    for label, (world, _) in WORLDS.items():
        outs[label] = str(tmp_path_factory.mktemp(f"tp_{label}"))
        np.savez(os.path.join(outs[label], "inputs.npz"), **arrays)
        port = free_port()
        procs += [spawn("tensor_parallel", r, world, port, outs[label], 2)
                  for r in range(world)]
    try:
        jax_runs = {label: _jax_model_parallel_step(jconfig, jparams, disc_np, batch_np, key,
                                                    data)
                    for label, (_, data) in WORLDS.items()}
        jax_runs["d2"] = _jax_data_parallel_step(jconfig, jparams, disc_np, batch_np, key)
        # JAX's own spread at bf16: its model=2 step against its one-device step, and
        # that step's bf16-versus-fp32 gap
        jax_bf16 = {label: _jax_model_parallel_step(jconfig, jparams, disc_np, batch_np, key,
                                                    1, model, dtype)
                    for label, model, dtype in (("m2", 2, "bfloat16"), ("one", 1, "bfloat16"),
                                                ("one_fp32", 1, None))}
        one = {}
        with torch.backends.mkldnn.flags(enabled=False):  # the workers' setting
            for label, dtype in (("fp32", None), ("bf16", "bfloat16")):
                gen, disc = leaves(gen_np), leaves(disc_np)
                fn = step.make_gan_train_step(
                    config, gen, disc, torch.optim.SGD(list(gen.values()), lr=0.0),
                    torch.optim.SGD(list(disc.values()), lr=1.0), segment_frames=SEGMENT,
                    mel_kwargs=MEL_KWARGS, compute_dtype=dtype)
                metrics = fn(step.batch_to(batch_np, "cpu"), noise=noise)
                one[label] = ({k: float(v) for k, v in metrics._asdict().items()},
                              {k: p.grad.numpy() for k, p in gen.items()},
                              {k: p.grad.numpy() for k, p in disc.items()})
                if dtype is None:
                    norm = float(vits_optimizer(gen).grad_norm())
    finally:
        wait_all(procs)
    results = {}
    for label, (world, data) in WORLDS.items():
        reports = []
        for r in range(world):
            with open(os.path.join(outs[label], f"tp-report-{r}.json")) as f:
                reports.append(json.load(f))
        ranks = []
        for r in range(2):  # data index 0's model ranks
            with np.load(os.path.join(outs[label], f"tp-arrays-{r}.npz")) as f:
                ranks.append({k: f[k] for k in f.files})
        results[label] = {"reports": reports, "arrays": ranks, "jax": jax_runs[label],
                          "out": outs[label]}
    yield {"config": config, "gen": gen_np, "disc": disc_np, "norm": norm,
           "jax_d2": jax_runs["d2"], "jax_bf16": jax_bf16, "one": one, **results}
    for out in outs.values():
        shutil.rmtree(out, ignore_errors=True)


def _reassembled(gen_np, arrays) -> dict[str, np.ndarray]:
    """The whole generator gradients from the model ranks' slices (gate order)."""
    plan = split_plan(gen_np, 2)
    out = {}
    for name, value in gen_np.items():
        if name not in plan:
            out[name] = arrays[0][f"g.{name}"]
            continue
        split = plan[name]
        whole = np.zeros(value.shape, np.float32)
        for r, a in enumerate(arrays):
            index = [slice(None)] * value.ndim
            index[split.dim] = shard_index(split, value.shape[split.dim], 2, r)
            whole[tuple(index)] = a[f"g.{name}"]
        out[name] = whole
    return out


@functools.lru_cache(maxsize=None)
def _mms_width_params():
    from vits_tpu.config import VitsConfig as JaxVitsConfig
    from vits_tpu.io.random_init import random_params

    # MMS-TTS's widths (VitsConfig()), its depth cut
    return random_params(JaxVitsConfig(num_hidden_layers=1, prior_encoder_num_flows=1,
                                       prior_encoder_num_wavenet_layers=1,
                                       posterior_encoder_num_wavenet_layers=1,
                                       duration_predictor_num_flows=1,
                                       depth_separable_num_layers=1),
                         seed=0, keep_training=True)


@pytest.mark.parametrize("which", ["tiny", "mms_width"])
@pytest.mark.parametrize("model", [2, 3])
def test_param_spec_and_fallback_match_jax(which, model):
    params = fixture_params()[1] if which == "tiny" else _mms_width_params()
    mesh = jax_mesh.make_mesh(data=1, model=model, devices=jax.devices()[:model])
    sharded = jax_mesh.shard_params(params, mesh, model_parallel=True)
    plan = split_plan(params, model)
    split = 0
    for name, value in params.items():
        assert param_spec(name, value.shape) == tuple(jax_mesh.param_spec(name, value.shape))
        assert param_spec(name, value.shape, model_parallel=False) == ()
        want = tuple(sharded[name].sharding.spec)
        got = plan.get(name)
        assert (got is not None) == ("model" in want), name
        if got is not None:
            assert want[got.dim] == "model", name
            split += 1
    # the tiny fixture's widths (8-64) do not divide by 3: every tensor falls back
    assert (split == 0) == (which == "tiny" and model == 3)


def _loss_agrees(a: float, b: float) -> bool:
    return abs(a - b) <= ATOL * max(1.0, abs(b))


def _grad_agrees(a: np.ndarray, b: np.ndarray) -> bool:
    norm = np.linalg.norm(b)
    return norm < ZERO_GRAD or np.linalg.norm(a - b) <= GRAD_RTOL * norm


def _reference(runs, label):
    """JAX's step on the world's mesh; on the 2 x 2 mesh, where it disagrees with
    JAX's data=2 step (the same function), the data=2 step's value (module
    docstring)."""
    metrics, grads_g, grads_d = runs[label]["jax"]
    if label == "m2":
        return metrics, grads_g, grads_d
    d2_metrics, d2_g, d2_d = runs["jax_d2"]
    return ({k: v if _loss_agrees(v, d2_metrics[k]) else d2_metrics[k]
             for k, v in metrics.items()},
            {k: v if _grad_agrees(v, d2_g[k]) else d2_g[k] for k, v in grads_g.items()},
            {k: v if _grad_agrees(v, d2_d[k]) else d2_d[k] for k, v in grads_d.items()})


@pytest.mark.parametrize("label", list(WORLDS))
def test_losses_match_jax_model_parallel_step(runs, label):
    want = _reference(runs, label)[0]
    for report in runs[label]["reports"]:
        for name, got in zip(FIELDS, report["metrics"]):
            _assert_close(got, want[name], what=f"rank {report['rank']} {name}")


@pytest.mark.parametrize("label", list(WORLDS))
def test_gradients_match_jax_model_parallel_step(runs, label):
    _, want_g, want_d = _reference(runs, label)
    got = _reassembled(runs["gen"], runs[label]["arrays"])
    assert got.keys() == want_g.keys()
    for name, g in got.items():
        _assert_grad_close(g, want_g[name], what=name)
    for name, g in want_d.items():
        _assert_grad_close(runs[label]["arrays"][0][f"d.{name}"], g, what=name)


def test_jax_two_by_two_mesh_doubles_grouped_conv_gradients(runs):
    """The reference's fault: JAX's 2 x 2 mesh step and its data=2 step disagree
    only on the grouped convs' weight gradients, by a factor of 2, and on the
    feature-matching loss through the discriminator they update; on those the
    port's 2 x 2 world agrees with the data=2 step."""
    metrics, grads_g, grads_d = runs["d2m2"]["jax"]
    d2_metrics, d2_g, d2_d = runs["jax_d2"]
    grouped = [k for k in grads_g if ".convs_dilated." in k and k.endswith(".weight")]
    grouped_d = [f"discriminator.msd.convs.{i}.weight" for i in range(1, 5)]
    for want, got, names in ((d2_g, grads_g, grouped), (d2_d, grads_d, grouped_d)):
        assert [k for k in want if not _grad_agrees(got[k], want[k])] == names
        for k in names:
            np.testing.assert_allclose(got[k], 2 * want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert [k for k in metrics if not _loss_agrees(metrics[k], d2_metrics[k])] == [
        "feature_matching"]
    port = _reassembled(runs["gen"], runs["d2m2"]["arrays"])
    for k in grouped:
        _assert_grad_close(port[k], d2_g[k], what=k)
    report = runs["d2m2"]["reports"][0]
    for name in ("adversarial", "feature_matching"):
        _assert_close(report["metrics"][FIELDS.index(name)], d2_metrics[name], what=name)


@pytest.mark.parametrize("label", list(WORLDS))
def test_replicated_tensors_bit_identical(runs, label):
    """Every rank holds the same replicated gradients and, after three AdamW
    steps, the same replicated parameters; the ranks of a data group (one model
    index) hold the same split gradients."""
    reports = runs[label]["reports"]
    for key in ("replicated_grad_digest", "replicated_param_digest"):
        assert len({r[key] for r in reports}) == 1, key
    for m in range(2):
        assert len({r["split_grad_digest"] for r in reports if r["model"] == m}) == 1
    assert reports[0]["split_grad_digest"] != reports[1]["split_grad_digest"]
    assert [(r["data"], r["model"]) for r in reports] == [(r // 2, r % 2)
                                                          for r in range(len(reports))]


def test_each_rank_holds_half_of_each_split_tensor_and_moments(runs):
    gen = runs["gen"]
    plan = split_plan(gen, 2)
    assert {"decoder.conv_pre.weight", "decoder.resblocks.0.convs1.0.weight",
            "flow.flows.0.wavenet.in_layers.0.weight",
            "text_encoder.encoder.layers.0.attention.q_proj.weight"} <= set(plan)
    for report in runs["m2"]["reports"]:
        assert set(report["held"]) == set(plan)
        for name, (held, whole) in report["held"].items():
            assert int(np.prod(held)) * 2 == int(np.prod(whole)), name
            assert held[plan[name].dim] * 2 == whole[plan[name].dim], name
            assert report["moments"][name] == 2 * int(np.prod(held)), name


@pytest.mark.parametrize("label", list(WORLDS))
def test_clip_norm_covers_the_global_gradient(runs, label):
    for report in runs[label]["reports"]:
        assert abs(report["grad_norm"] - runs["norm"]) <= NORM_RTOL * runs["norm"]


def test_zero1_under_a_model_axis_matches_the_replicated_optimizer(runs):
    """data=2 x model=2, three AdamW steps: the moments split over each data
    group give the replicated optimizer's parameters bit for bit, on every rank."""
    reports = runs["d2m2"]["reports"]
    for report in reports:
        assert report["zero1_True_losses"] == report["zero1_False_losses"]
        assert report["zero1_True_param_digest"] == report["zero1_False_param_digest"]


@pytest.mark.parametrize("label", list(WORLDS))
def test_model_parallel_checkpoint_resumes_in_one_process(runs, label):
    """The step-2 checkpoint (gathered whole by the writer; ZeRO-1's at
    data=2 x model=2) resumed in one process at model=1."""
    config, gen_np = runs["config"], runs["gen"]
    restored = restore_checkpoint(os.path.join(runs[label]["out"], "tp_run"))
    assert restored["step"] == 2 and int(restored["gen_opt"]["count"]) == 2
    for name, value in gen_np.items():
        assert restored["gen_params"][name].shape == value.shape, name
        assert restored["gen_opt"][f"{name}.exp_avg"].shape == value.shape, name
    gen = leaves(restored["gen_params"])
    opt = vits_optimizer(gen)
    opt.load_state_arrays(restored["gen_opt"])
    fn = step.make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS)
    batch, noise = step_inputs(config, 3)
    with torch.backends.mkldnn.flags(enabled=False):
        loss = float(fn(batch, noise=noise).loss)
    _assert_close(loss, runs[label]["reports"][0]["losses"][2], what="step 3 loss")


def _gaps(m2, one, one_fp32) -> dict[str, float]:
    """Each loss's model=2-versus-one-device difference at bf16, as a multiple of
    the one-device step's own bf16-versus-fp32 gap."""
    return {k: abs(m2[k] - one[k]) / abs(one[k] - one_fp32[k]) for k in one}


def _module_gaps(m2, one, one_fp32) -> dict[str, float]:
    """The same per module of gradients (relative L2 over the module's tensors)."""
    def by_module(grads):
        out: dict[str, list] = {}
        for name in sorted(grads):
            out.setdefault(name.split(".")[0], []).append(np.ravel(grads[name]).astype(np.float64))
        return {k: np.concatenate(v) for k, v in out.items()}
    m2, one, one_fp32 = by_module(m2), by_module(one), by_module(one_fp32)
    return {k: float(np.linalg.norm(m2[k] - one[k]) / np.linalg.norm(one[k] - one_fp32[k]))
            for k in one}


def test_bf16_model_axis_within_jax_spread(runs):
    """The port's bf16 step on two ranks (data=1 x model=2) against its one-process
    bf16 step, in multiples of that step's bf16-versus-fp32 gap, within
    BF16_SPREAD_FACTOR x the largest such multiple that JAX's own model=2 bf16 step
    shows against its one-device bf16 step (on JAX's noise, the same inputs), over
    the losses and, per module, the gradients. bf16 rounds the partial sums of a
    split layer before the model group adds them, so the two-rank step differs from
    the one-process one by bf16 noise, which the duration predictor and the KL
    amplify (JAX's spread reaches several gaps on some losses); a missing or doubled
    collective moves a loss by far more than its bf16 gap."""
    jax_bf16, one = runs["jax_bf16"], runs["one"]
    jax_losses = _gaps(*(jax_bf16[k][0] for k in ("m2", "one", "one_fp32")))
    jax_grads = _module_gaps(*({**jax_bf16[k][1], **jax_bf16[k][2]}
                               for k in ("m2", "one", "one_fp32")))
    bound = BF16_SPREAD_FACTOR * max(max(jax_losses.values()), max(jax_grads.values()))
    report = runs["m2"]["reports"][0]
    port_losses = _gaps(dict(zip(FIELDS, report["bf16_metrics"])), one["bf16"][0],
                        one["fp32"][0])
    arrays = [{k[len("bf16."):]: v for k, v in a.items() if k.startswith("bf16.")}
              for a in runs["m2"]["arrays"]]
    port_g = {**_reassembled(runs["gen"], arrays),
              **{k[2:]: v for k, v in arrays[0].items() if k.startswith("d.")}}
    port_grads = _module_gaps(port_g, {**one["bf16"][1], **one["bf16"][2]},
                              {**one["fp32"][1], **one["fp32"][2]})
    print(f"JAX model=2 bf16 spread, in bf16 gaps: losses {jax_losses}, grads {jax_grads}")
    print(f"port two-rank bf16 spread: losses {port_losses}, grads {port_grads}")
    for r in runs["m2"]["reports"]:  # every rank returns the same global losses
        assert r["bf16_metrics"] == report["bf16_metrics"]
    for name, ratio in {**port_losses, **port_grads}.items():
        assert ratio <= bound, f"{name}: {ratio:.3g} gaps > {bound:.3g}"
