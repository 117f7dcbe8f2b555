"""Worker processes of the port's data-parallel tests (no tests here; no JAX).

Each test of ``tests/test_torch_train_dp*.py`` starts ranks of this module as
OS processes joined over ``torch.distributed`` (gloo, the CPU)::

    python -m tests.test_torch_dp_worker <scenario> <rank> <world> <port> <dir> [args]

Every worker runs on two threads with oneDNN off: oneDNN picks its conv
algorithm per shape, and a rank's half batch is another shape than the whole
batch, so the sums would run in other orders than the one-process step's.
Results go to ``<dir>`` as npz/JSON files; logs go where the test sends the
process's output (a file: a pipe nobody drains would block the worker).

The shared inputs are built here (numpy only) and imported by the tests:
:func:`make_batch` (B=4, unequal token and frame lengths, so the global
normalizers matter) and the tiny ggml fixture's parameters.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "tiny-vits.ggml")
SEGMENT = 8
MEL_KWARGS = {"n_fft": 256, "hop_length": 64, "n_mels": 20}
# (tokens, frames) of each row: unequal, so per-rank normalizers differ from the global ones
LENGTHS = ((12, 24), (9, 19), (5, 12), (11, 22))
T_PAD, S_PAD = 12, 24
# A collective that waits this long on a peer raises: far above any stall_seconds used here,
# so the training watchdog decides first.
GROUP_TIMEOUT_S = 600
WORKER_TIMEOUT_S = 600


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(scenario: str, rank: int, world: int, port: int, out: str, *args, log_tag=""):
    """One worker rank, its output to ``out/log-<scenario><tag>-<rank>.txt``."""
    log_path = os.path.join(out, f"log-{scenario}{log_tag}-{rank}.txt")
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_dp_worker", scenario, str(rank), str(world),
             str(port), out, *map(str, args)],
            cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
    proc.log_path = log_path
    return proc


def log_tail(proc) -> str:
    with open(proc.log_path, "rb") as f:
        return f.read()[-3000:].decode(errors="replace")


def wait_all(procs, timeout=WORKER_TIMEOUT_S) -> None:
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p in procs:
        assert p.returncode == 0, f"worker exited {p.returncode}:\n{log_tail(p)}"


def make_batch(config, seed: int, lengths=LENGTHS):
    """A seeded numpy ``TrainBatch`` of ``len(lengths)`` rows padded to T_PAD, S_PAD."""
    from vits_tpu_torch.train.step import TrainBatch

    rng = np.random.default_rng(seed)
    B, up = len(lengths), config.total_upsample
    token_mask = np.zeros((B, T_PAD), np.float32)
    frame_mask = np.zeros((B, S_PAD), np.float32)
    for b, (t, s) in enumerate(lengths):
        token_mask[b, :t] = 1.0
        frame_mask[b, :s] = 1.0
    return TrainBatch(
        input_ids=(rng.integers(1, config.vocab_size, (B, T_PAD)) * token_mask).astype(np.int32),
        token_mask=token_mask,
        spectrogram=(rng.standard_normal((B, S_PAD, config.spectrogram_bins))
                     * frame_mask[..., None]).astype(np.float32),
        frame_mask=frame_mask,
        audio=(rng.standard_normal((B, S_PAD * up)) * 0.1 * np.repeat(frame_mask, up, axis=1))
        .astype(np.float32),
    )


def step_inputs(config, step: int, rows: int = len(LENGTHS)):
    """The global batch (its first ``rows`` rows) and noise of training step
    ``step`` (both keyed by it)."""
    from vits_tpu_torch.train.step import batch_to, draw_noise

    batch = batch_to(make_batch(config, 1000 + step, LENGTHS[:rows]), "cpu")
    return batch, draw_noise(config, batch, torch.Generator().manual_seed(step))


def fixture_params():
    """(config, generator params, discriminator params) as numpy: the tiny ggml
    fixture and the discriminator at seed 0."""
    from vits_tpu_torch.io.loader import load_ggml
    from vits_tpu_torch.models.discriminator import init_discriminator_params

    config, _, params = load_ggml(FIXTURE)
    return config, params, init_discriminator_params(0)


def leaves(params) -> dict[str, torch.Tensor]:
    return {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in params.items()}


def digest(tensors) -> str:
    """sha256 over the bytes of ``tensors`` in order: equal digests, bit-identical values."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _gan(config, gen, disc, gen_opt, disc_opt, dp, **kw):
    from vits_tpu_torch.train.step import make_gan_train_step

    return make_gan_train_step(config, gen, disc, gen_opt, disc_opt, segment_frames=SEGMENT,
                               mel_kwargs=MEL_KWARGS, data_parallel=dp, **kw)


def _sgd(params, lr):
    return torch.optim.SGD(list(params.values()), lr=lr)


def steps_scenario(rank: int, world: int, out: str) -> None:
    """One GAN step (G at lr 0, D by -g: the adversarial terms run through the
    updated D) on the inputs of ``out/inputs.npz`` at fp32, at grad_accum=2 and
    at bf16; two AdamW GAN steps; three generator steps with and without ZeRO-1
    and a checkpoint of the ZeRO-1 run at step 2."""
    from vits_tpu_torch.parallel.mesh import data_axis, rank_rows
    from vits_tpu_torch.train.checkpoint import save_checkpoint
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import (
        RowShare, TrainBatch, TrainNoise, generator_forward, make_train_step)

    dp = data_axis()
    config, gen_np, disc_np = fixture_params()
    with np.load(os.path.join(out, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    batch = TrainBatch(*(torch.tensor(inputs[f"batch.{k}"]) if f"batch.{k}" in inputs else None
                         for k in TrainBatch._fields))
    noise = TrainNoise(*(torch.tensor(inputs[f"noise.{k}"]) for k in TrainNoise._fields))
    arrays: dict[str, np.ndarray] = {}
    report: dict = {"rank": rank}

    # this rank's MAS durations, and its KL over its own rows' frames (a per-rank normalizer)
    rows = torch.as_tensor(rank_rows(4, world, rank))
    mine = TrainBatch(*(None if t is None else t[rows] for t in batch))
    mine_noise = TrainNoise(*(t[rows] for t in noise))
    with torch.no_grad():
        out_global = generator_forward(leaves(gen_np), config, mine, mine_noise, SEGMENT,
                                       mel_kwargs=MEL_KWARGS, share=RowShare(
                                           batch.frame_mask.sum(), batch.token_mask.sum(),
                                           len(rows) / 4))
        out_local = generator_forward(leaves(gen_np), config, mine, mine_noise, SEGMENT,
                                      mel_kwargs=MEL_KWARGS)
    arrays["rows"] = rows.numpy()
    arrays["durations"] = out_global.durations.numpy()
    report["kl_own_rows"] = float(out_local.metrics.kl)

    for label, kw in (("fp32", {}), ("accum", {"grad_accum": 2}),
                      ("bf16", {"compute_dtype": "bfloat16"})):
        gen, disc = leaves(gen_np), leaves(disc_np)
        t0 = time.perf_counter()
        metrics = _gan(config, gen, disc, _sgd(gen, 0.0), _sgd(disc, 1.0), dp, **kw)(
            batch, noise=noise)
        report[f"{label}_s"] = time.perf_counter() - t0
        report[f"{label}_metrics"] = [float(v) for v in metrics]
        report[f"{label}_grad_digest"] = digest([p.grad for p in {**gen, **disc}.values()])
        if rank == 0:
            arrays.update({f"{label}.g.{k}": p.grad.numpy() for k, p in gen.items()})
            arrays.update({f"{label}.d.{k}": p.grad.numpy() for k, p in disc.items()})

    # two AdamW steps on the same inputs: every parameter bit-identical across the ranks
    gen, disc = leaves(gen_np), leaves(disc_np)
    step = _gan(config, gen, disc, vits_optimizer(gen), vits_optimizer(disc), dp)
    report["adamw_metrics"] = [[float(v) for v in step(batch, noise=noise)] for _ in range(2)]
    report["adamw_param_digest"] = digest({**gen, **disc}.values())

    # three generator steps with and without ZeRO-1 on step-keyed inputs; the
    # ZeRO-1 run checkpoints step 2 (every rank gathers the moments, rank 0 writes)
    finals = {}
    for zero1 in (False, True):
        gen = leaves(gen_np)
        opt = vits_optimizer(gen, zero1=dp if zero1 else None)
        step = make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS,
                               data_parallel=dp)
        losses = []
        for s in (1, 2, 3):
            step_batch, step_noise = step_inputs(config, s)
            losses.append(float(step(step_batch, noise=step_noise).loss))
            if zero1 and s == 2:
                state = opt.state_arrays()
                if rank == 0:
                    save_checkpoint(os.path.join(out, "zero1_run"), 2, gen, state)
                dist.barrier()
        finals[zero1] = {k: p.detach().clone() for k, p in gen.items()}
        report[f"zero1_{zero1}_losses"] = losses
        if zero1:
            report["owned"] = [n for i, n in enumerate(opt.names) if opt.owns(i)]
            held = sum(2 * s["exp_avg"].numel() for s in opt.adamw.state.values())
            report["moment_share"] = held / (2 * sum(p.numel() for p in opt.params))
    report["zero1_max_abs_diff"] = max(float((finals[True][k] - finals[False][k]).abs().max())
                                       for k in finals[False])
    report["zero1_param_digest"] = digest(finals[True].values())

    np.savez(os.path.join(out, f"arrays-{rank}.npz"), **arrays)
    with open(os.path.join(out, f"report-{rank}.json"), "w") as f:
        json.dump(report, f)


def writer_scenario(rank: int, world: int, out: str, corpus: str, model: str) -> None:
    """``train()`` with ZeRO-1 for two generator steps, a checkpoint at each: every
    call of ``save_checkpoint`` leaves a ``writer-<rank>`` marker, and the log
    goes to ``train-log-<rank>.txt``."""
    from vits_tpu_torch.parallel import distributed
    from vits_tpu_torch.train import loop

    save = loop.save_checkpoint

    def recorded(*args, **kwargs):
        with open(os.path.join(out, f"writer-{rank}"), "a") as f:
            f.write(f"step {args[1]}\n")
        return save(*args, **kwargs)

    loop.save_checkpoint = recorded
    with open(os.path.join(out, f"train-log-{rank}.txt"), "w") as log:
        loop.train(corpus, model, os.path.join(out, "run"), steps=2, batch_size=3,
                   checkpoint_every=1, log_every=1, adversarial=False, segment_frames=8,
                   zero1=True, log=lambda line: print(line, file=log, flush=True),
                   device="cpu")
    with open(os.path.join(out, f"primary-{rank}.json"), "w") as f:
        json.dump({"primary": distributed.is_primary(), "index": distributed.process_index(),
                   "count": distributed.process_count()}, f)


def elastic_scenario(rank: int, world: int, out: str, total_steps: str, checkpoint_every: str,
                     stall_seconds: str, step_delay: str, tag: str) -> None:
    """Data-parallel generator training with the recovery pieces wired together:
    a ``Watchdog(abort=True)`` beat after every step (a rank blocked in a
    collective against a frozen peer stops beating, and its watchdog exits 42),
    a checkpoint every ``checkpoint_every`` steps from rank 0 (after every rank
    gathered the optimizer state), and on start a resume from the latest one.
    Batches and noise are keyed by the global step, so a resumed run recomputes
    the steps the killed one took. Losses go to ``losses-<rank>-<tag>.json``, each
    step's seconds to ``step-seconds-<rank>-<tag>.json``."""
    from vits_tpu_torch.parallel import distributed
    from vits_tpu_torch.parallel.mesh import data_axis
    from vits_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import make_train_step
    from vits_tpu_torch.train.watchdog import Watchdog

    total_steps, checkpoint_every = int(total_steps), int(checkpoint_every)
    config, gen_np, _ = fixture_params()
    start = resumed_from = 0
    if latest_step(out) is not None:
        ck = restore_checkpoint(out)
        gen_np, start = ck["gen_params"], ck["step"]
        resumed_from = start
    gen = leaves(gen_np)
    opt = vits_optimizer(gen)
    if start:
        opt.load_state_arrays(ck["gen_opt"])
    step = make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS,
                           data_parallel=data_axis())
    losses, times = {}, []
    loss_path = os.path.join(out, f"losses-{rank}-{tag}.json")
    times_path = os.path.join(out, f"step-seconds-{rank}-{tag}.json")
    watchdog = None  # started after the first step: the ranks' start-up skew is no stall
    for s in range(start + 1, total_steps + 1):
        t0 = time.perf_counter()
        batch, noise = step_inputs(config, s)
        losses[str(s)] = float(step(batch, noise=noise).loss)
        times.append(time.perf_counter() - t0)
        for path, value in ((loss_path, losses), (times_path, times)):
            with open(path + ".tmp", "w") as f:
                json.dump(value, f)
            os.replace(path + ".tmp", path)
        if watchdog is None:
            watchdog = Watchdog(out, stall_seconds=float(stall_seconds),
                                process_index=distributed.process_index(), abort=True)
        watchdog.beat(s)
        if s % checkpoint_every == 0:
            state = opt.state_arrays()
            if distributed.is_primary():
                save_checkpoint(out, s, gen, state)
            dist.barrier()
        time.sleep(float(step_delay))
    if watchdog is not None:
        watchdog.stop()
    with open(os.path.join(out, f"final-{rank}-{tag}.json"), "w") as f:
        json.dump({"resumed_from": resumed_from, "final_step": total_steps, "losses": losses},
                  f)


def tensor_parallel_scenario(rank: int, world: int, out: str, model: str) -> None:
    """``world / model`` data ranks x ``model`` model ranks on the inputs of
    ``out/inputs.npz``: one GAN step (G at lr 0, D by -g) on the rank's slices
    (their gradients to ``tp-arrays-<rank>.npz``), at a data axis of one also at
    bf16 (``bf16.``-prefixed gradients), the clip's global norm of
    that step's gradients, what the rank holds of the split tensors and their
    moments, three AdamW generator steps on step-keyed inputs (with a data
    axis, with and without ZeRO-1) with a checkpoint of step 2 (gathered whole,
    written by rank 0), and digests of the replicated tensors."""
    from vits_tpu_torch.parallel.mesh import data_axis, gather_params, model_axis, shard_params
    from vits_tpu_torch.parallel.tensor import tensor_parallel
    from vits_tpu_torch.train.checkpoint import save_checkpoint
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import TrainBatch, TrainNoise, make_train_step

    model = int(model)
    dp, mp = data_axis(model), model_axis(model)
    config, gen_np, disc_np = fixture_params()
    tp = tensor_parallel(gen_np, mp)
    with np.load(os.path.join(out, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    batch = TrainBatch(*(torch.tensor(inputs[f"batch.{k}"]) if f"batch.{k}" in inputs else None
                         for k in TrainBatch._fields))
    noise = TrainNoise(*(torch.tensor(inputs[f"noise.{k}"]) for k in TrainNoise._fields))
    report: dict = {"rank": rank, "data": dp.rank, "model": mp.rank}
    split = sorted(tp.plan)
    replicated = [k for k in gen_np if k not in tp.plan]

    gen, disc = leaves(shard_params(gen_np, mp)), leaves(disc_np)
    metrics = _gan(config, gen, disc, _sgd(gen, 0.0), _sgd(disc, 1.0), dp,
                   model_parallel=tp)(batch, noise=noise)
    report["metrics"] = [float(v) for v in metrics]
    report["grad_norm"] = float(vits_optimizer(gen, model_parallel=tp).grad_norm())
    report["replicated_grad_digest"] = digest([gen[k].grad for k in replicated]
                                              + [p.grad for p in disc.values()])
    report["split_grad_digest"] = digest([gen[k].grad for k in split])
    report["held"] = {k: [list(gen[k].shape), list(gen_np[k].shape)] for k in split}
    arrays = {f"g.{k}": gen[k].grad.numpy() for k in split}
    if rank == 0:
        arrays.update({f"g.{k}": gen[k].grad.numpy() for k in replicated})
        arrays.update({f"d.{k}": p.grad.numpy() for k, p in disc.items()})
    if dp.world == 1:  # the same step at bf16 (held against JAX's model=2 bf16 spread)
        gen, disc = leaves(shard_params(gen_np, mp)), leaves(disc_np)
        metrics = _gan(config, gen, disc, _sgd(gen, 0.0), _sgd(disc, 1.0), dp,
                       model_parallel=tp, compute_dtype="bfloat16")(batch, noise=noise)
        report["bf16_metrics"] = [float(v) for v in metrics]
        arrays.update({f"bf16.g.{k}": gen[k].grad.numpy() for k in split})
        if rank == 0:
            arrays.update({f"bf16.g.{k}": gen[k].grad.numpy() for k in replicated})
            arrays.update({f"bf16.d.{k}": p.grad.numpy() for k, p in disc.items()})
    if dp.rank == 0:
        np.savez(os.path.join(out, f"tp-arrays-{rank}.npz"), **arrays)

    # with a data axis, ZeRO-1 too (the moments split over the data group); the last
    # run checkpoints step 2
    for zero1 in (False, True) if dp.world > 1 else (False,):
        gen = leaves(shard_params(gen_np, mp))
        opt = vits_optimizer(gen, zero1=dp if zero1 else None, model_parallel=tp)
        step = make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS,
                               data_parallel=dp, model_parallel=tp)
        losses = []
        for s in (1, 2, 3):
            step_batch, step_noise = step_inputs(config, s)
            losses.append(float(step(step_batch, noise=step_noise).loss))
            if s == 2 and (zero1 or dp.world == 1):
                state, whole = opt.state_arrays(), gather_params(gen, tp.plan, mp)
                if rank == 0:
                    save_checkpoint(os.path.join(out, "tp_run"), 2, whole, state)
                dist.barrier()
        report[f"zero1_{zero1}_losses"] = losses
        report[f"zero1_{zero1}_param_digest"] = digest(gen.values())
        if not zero1:
            moments = {n: sum(t.numel() for t in opt.adamw.state[p].values() if t.ndim)
                       for n, p in zip(opt.names, opt.params)}
            report["losses"] = losses
            report["moments"] = {k: moments[k] for k in split}
            report["replicated_param_digest"] = digest([gen[k] for k in replicated])
    with open(os.path.join(out, f"tp-report-{rank}.json"), "w") as f:
        json.dump(report, f)


# Six rows: a grad_accum=2 microbatch of three does not divide over two data ranks
UNEVEN_LENGTHS = LENGTHS + ((7, 15), (12, 20))


def uneven_scenario(rank: int, world: int, out: str, model: str) -> None:
    """``world / model`` data ranks x ``model`` model ranks on the six rows of
    ``out/inputs.npz``: one GAN step at grad_accum=2 (G at lr 0, D by -g; the
    gradients of data index 0 to ``uneven-arrays-<rank>.npz``), then, at a data
    axis of two, three generator steps at grad_accum=2 on two-row batches (each
    microbatch of one row: data rank 0 holds none of it), with and without
    ZeRO-1; every rank's metrics and digests to ``uneven-report-<rank>.json``."""
    from vits_tpu_torch.parallel.mesh import data_axis, model_axis, shard_params
    from vits_tpu_torch.parallel.tensor import tensor_parallel
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import TrainBatch, TrainNoise, make_train_step

    model = int(model)
    dp, mp = data_axis(model), model_axis(model)
    config, gen_np, disc_np = fixture_params()
    tp = tensor_parallel(gen_np, mp) if model > 1 else None
    own = (lambda a: shard_params(a, mp)) if model > 1 else (lambda a: a)  # noqa: E731
    with np.load(os.path.join(out, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    batch = TrainBatch(*(torch.tensor(inputs[f"batch.{k}"]) if f"batch.{k}" in inputs else None
                         for k in TrainBatch._fields))
    noise = TrainNoise(*(torch.tensor(inputs[f"noise.{k}"]) for k in TrainNoise._fields))
    report: dict = {"rank": rank, "data": dp.rank, "model": mp.rank}

    gen, disc = leaves(own(gen_np)), leaves(disc_np)
    metrics = _gan(config, gen, disc, _sgd(gen, 0.0), _sgd(disc, 1.0), dp, grad_accum=2,
                   model_parallel=tp)(batch, noise=noise)
    report["metrics"] = [float(v) for v in metrics]
    report["grad_digest"] = digest([p.grad for p in {**gen, **disc}.values()])
    if dp.rank == 0:
        arrays = {f"g.{k}": p.grad.numpy() for k, p in gen.items()}
        arrays.update({f"d.{k}": p.grad.numpy() for k, p in disc.items()})
        np.savez(os.path.join(out, f"uneven-arrays-{rank}.npz"), **arrays)

    for zero1 in (False, True):
        gen = leaves(own(gen_np))
        opt = vits_optimizer(gen, zero1=dp if zero1 else None, model_parallel=tp)
        step = make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS, grad_accum=2,
                               data_parallel=dp, model_parallel=tp)
        losses = []
        for s in (1, 2, 3):
            step_batch, step_noise = step_inputs(config, s, rows=2)
            losses.append([float(v) for v in step(step_batch, noise=step_noise)])
        report[f"small_zero1_{zero1}_metrics"] = losses
        report[f"small_zero1_{zero1}_param_digest"] = digest(gen.values())
    with open(os.path.join(out, f"uneven-report-{rank}.json"), "w") as f:
        json.dump(report, f)


def no_window_params():
    """(config, generator params, discriminator params): the tiny fixture with
    ``window_size`` 0 and its relative tables dropped."""
    import dataclasses

    config, gen_np, disc_np = fixture_params()
    return (dataclasses.replace(config, window_size=0),
            {k: v for k, v in gen_np.items() if ".emb_rel_" not in k}, disc_np)


def no_window_scenario(rank: int, world: int, out: str) -> None:
    """``data=1 x model=world`` on a model without a relative window: the attention's
    heads split by ``head_dim`` (no table to read it from), one GAN step (G at lr
    0, D by -g) on the inputs of ``out/inputs.npz``; the rank's slices' gradients
    (rank 0 also the replicated ones) to ``nw-arrays-<rank>.npz``."""
    from vits_tpu_torch.parallel.mesh import data_axis, model_axis, shard_params
    from vits_tpu_torch.parallel.tensor import tensor_parallel
    from vits_tpu_torch.train.step import TrainBatch, TrainNoise

    dp, mp = data_axis(world), model_axis(world)
    config, gen_np, disc_np = no_window_params()
    tp = tensor_parallel(gen_np, mp, config.head_dim)
    with np.load(os.path.join(out, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    batch = TrainBatch(*(torch.tensor(inputs[f"batch.{k}"]) if f"batch.{k}" in inputs else None
                         for k in TrainBatch._fields))
    noise = TrainNoise(*(torch.tensor(inputs[f"noise.{k}"]) for k in TrainNoise._fields))
    gen = leaves(shard_params(gen_np, mp, config.head_dim))
    disc = leaves(disc_np)
    metrics = _gan(config, gen, disc, _sgd(gen, 0.0), _sgd(disc, 1.0), dp,
                   model_parallel=tp)(batch, noise=noise)
    arrays = {f"g.{k}": p.grad.numpy() for k, p in gen.items() if k in tp.plan or rank == 0}
    if rank == 0:
        arrays.update({f"d.{k}": p.grad.numpy() for k, p in disc.items()})
    np.savez(os.path.join(out, f"nw-arrays-{rank}.npz"), **arrays)
    report = {"metrics": [float(v) for v in metrics],
              "split_heads": sorted(k for k, s in tp.plan.items()
                                    if ".attention." in k and not s.whole),
              "held": {k: [list(gen[k].shape), list(gen_np[k].shape)] for k in tp.plan}}
    with open(os.path.join(out, f"nw-report-{rank}.json"), "w") as f:
        json.dump(report, f)


def slice_axis_scenario(rank: int, world: int, out: str, slices: str, model: str) -> None:
    """``slices x data x model`` ranks on the inputs of ``out/inputs.npz``, one
    thread a rank: each group's ranks, one GAN step (G at lr 0, D by -g) with
    every ``all_reduce`` and ``broadcast`` recorded by its group
    (``chip_smoke.py::recorded_collectives``), the gradients of data index 0
    to ``slice-arrays-<rank>.npz``, and with a data axis of two in each slice,
    three AdamW generator steps on step-keyed inputs with and without ZeRO-1;
    every rank's report to ``slice-report-<rank>.json``."""
    from chip_smoke import recorded_collectives
    from vits_tpu_torch.parallel.mesh import data_axis, model_axis, shard_params
    from vits_tpu_torch.parallel.tensor import tensor_parallel
    from vits_tpu_torch.train.schedule import vits_optimizer
    from vits_tpu_torch.train.step import TrainBatch, TrainNoise, make_train_step

    torch.set_num_threads(1)  # replicated layers bit-identical across a model group
    slices, model = int(slices), int(model)
    dp = data_axis(model, slices)
    mp = model_axis(model) if model > 1 else None
    config, gen_np, disc_np = fixture_params()
    tp = None if mp is None else tensor_parallel(gen_np, mp)
    own = (lambda a: a) if mp is None else (lambda a: shard_params(a, mp))  # noqa: E731
    with np.load(os.path.join(out, "inputs.npz")) as f:
        inputs = {k: f[k] for k in f.files}
    batch = TrainBatch(*(torch.tensor(inputs[f"batch.{k}"]) if f"batch.{k}" in inputs else None
                         for k in TrainBatch._fields))
    noise = TrainNoise(*(torch.tensor(inputs[f"noise.{k}"]) for k in TrainNoise._fields))
    size, index, _ = dp.in_slice
    groups = {"slice": dp.group, "cross": dp.cross_group,
              "model": None if mp is None else mp.group}
    report: dict = {"rank": rank, "data_rank": dp.rank, "slice": dp.rank // size,
                    "in_slice": index, "model": 0 if mp is None else mp.rank,
                    "groups": {name: dist.get_process_group_ranks(g)
                               for name, g in groups.items() if g is not None}}

    gen, disc = leaves(own(gen_np)), leaves(disc_np)
    calls, stop = recorded_collectives(groups)
    try:
        metrics = _gan(config, gen, disc, _sgd(gen, 0.0), _sgd(disc, 1.0), dp,
                       model_parallel=tp)(batch, noise=noise)
    finally:
        stop()
    report["collectives"] = calls
    report["metrics"] = [float(v) for v in metrics]
    split = [] if tp is None else sorted(tp.plan)
    replicated = [k for k in gen_np if k not in split]
    report["replicated_grad_digest"] = digest([gen[k].grad for k in replicated]
                                              + [p.grad for p in disc.values()])
    report["split_grad_digest"] = digest([gen[k].grad for k in split])
    if dp.rank == 0:
        arrays = {f"g.{k}": p.grad.numpy() for k, p in gen.items()}
        arrays.update({f"d.{k}": p.grad.numpy() for k, p in disc.items()})
        np.savez(os.path.join(out, f"slice-arrays-{rank}.npz"), **arrays)

    for zero1 in (False, True) if size > 1 else ():
        gen = leaves(own(gen_np))
        opt = vits_optimizer(gen, zero1=dp if zero1 else None, model_parallel=tp)
        step = make_train_step(config, gen, opt, SEGMENT, mel_kwargs=MEL_KWARGS,
                               data_parallel=dp, model_parallel=tp)
        losses = []
        for s in (1, 2, 3):
            step_batch, step_noise = step_inputs(config, s)
            losses.append(float(step(step_batch, noise=step_noise).loss))
        report[f"zero1_{zero1}_losses"] = losses
        report[f"zero1_{zero1}_param_digest"] = digest(gen.values())
        if zero1:
            report["owned"] = [n for i, n in enumerate(opt.names) if opt.owns(i)]
            held = sum(2 * s["exp_avg"].numel() for s in opt.adamw.state.values())
            report["moment_share"] = held / (2 * sum(p.numel() for p in opt.params))
    with open(os.path.join(out, f"slice-report-{rank}.json"), "w") as f:
        json.dump(report, f)


SCENARIOS = {"steps": steps_scenario, "writer": writer_scenario, "elastic": elastic_scenario,
             "tensor_parallel": tensor_parallel_scenario, "uneven": uneven_scenario,
             "no_window": no_window_scenario, "slice_axis": slice_axis_scenario}


def main(argv) -> int:
    scenario, rank, world, port, out = argv[:5]
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    from vits_tpu_torch.parallel.distributed import initialize

    initialize(f"localhost:{port}", world, rank, GROUP_TIMEOUT_S, device="cpu")
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            SCENARIOS[scenario](rank, world, out, *argv[5:])
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
