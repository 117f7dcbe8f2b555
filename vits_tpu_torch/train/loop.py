"""Training loop: data -> GAN steps on one device -> checkpoints, resumable.

Counterpart of ``vits_tpu/train/loop.py``::

    python -m vits_tpu_torch.train.loop --corpus ./LJSpeech-1.1 \\
        --model mms-eng.ggml --out ./run1 --steps 100000 [--dtype bfloat16]

Picks up the latest checkpoint in ``out_dir``; writes one every
``checkpoint_every`` steps and at the end, with the EMA weights beside the
raw ones (``train/checkpoint.py``). ``compute_dtype="bfloat16"`` trains in
mixed precision (``train/step.py``; master weights and optimizer stay fp32).
The command line runs on the card (``--device cuda``, the default) unless
asked for the CPU.

Data parallel over processes, one per card (NCCL) or per CPU process (gloo),
after ``parallel/distributed.py::initialize``; the command line initializes
when torchrun's ``WORLD_SIZE`` is set::

    torchrun --nproc-per-node 8 -m vits_tpu_torch.train.loop --corpus ... [--zero1]

Every rank reads the same batch stream, pads each batch to a multiple of the
world (``parallel/mesh.py::pad_rows``) and computes its rows of it
(``train/step.py``); ``zero1`` splits the Adam moments over the ranks
(``train/schedule.py``). Only the primary process logs and writes
checkpoints.

Tensor parallel (``model_parallel=k``, ``--model-parallel k``): the world is
``world / k`` data ranks x ``k`` model ranks, model innermost
(``parallel/mesh.py::data_axis``, ``model_axis``); each rank holds its slices
of the generator's split tensors and their moments (``shard_params``), the
discriminator whole, as JAX's ``train(model_parallel=k)`` shards them. The
writer gathers whole tensors under their JAX names, so a checkpoint written
at ``model=2`` resumes at ``model=1`` and the other way round::

    torchrun --nproc-per-node 8 -m vits_tpu_torch.train.loop --model-parallel 2 ...
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch

from vits_tpu_torch.io import loader
from vits_tpu_torch.io.params import from_jax_params
from vits_tpu_torch.models.discriminator import init_discriminator_params
from vits_tpu_torch.parallel import distributed
from vits_tpu_torch.parallel.mesh import (
    data_axis,
    gather_params,
    model_axis,
    pad_rows,
    shard_params,
)
from vits_tpu_torch.parallel.tensor import tensor_parallel
from vits_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from vits_tpu_torch.train.data import Prefetcher, VitsDataset
from vits_tpu_torch.train.schedule import ParamEMA, vits_optimizer
from vits_tpu_torch.train.step import (
    batch_to,
    make_gan_train_step,
    make_train_step,
    resolve_compute_dtype,
)
from vits_tpu_torch.train.watchdog import Watchdog


def _load_into(params: dict[str, torch.Tensor], arrays) -> None:
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.as_tensor(arrays[name]))


def train(
    corpus_dir: str,
    model_source: str,
    out_dir: str,
    steps: int = 100_000,
    batch_size: int = 16,
    learning_rate: float = 2e-4,
    disc_learning_rate: float | None = None,  # None = same as the generator's
    segment_frames: int = 32,
    checkpoint_every: int = 2000,
    log_every: int = 50,
    seed: int = 0,
    adversarial: bool = True,
    model_parallel: int = 1,
    grad_accum: int = 1,
    compute_dtype: str = "float32",
    zero1: bool = False,
    log=print,
    metrics_hook=None,
    stall_seconds: float = 600.0,
    stall_abort: bool = False,
    *,
    device,
) -> dict[str, torch.Tensor]:
    """Train from ``model_source`` (.ggml with the training modules, or an HF dir)
    on ``corpus_dir``; returns the generator parameters.

    Data parallel over the initialized process group, if any, and tensor
    parallel over ``model_parallel`` of its ranks (module docstring): each rank
    then trains on ``distributed.local_device(device)``. Raises ``ValueError``
    where the world does not divide by ``model_parallel``. Returns the whole
    parameters on every rank (gathered under a model axis)."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel}: at least 1")
    resolve_compute_dtype(compute_dtype)
    dp = data_axis(model_parallel)
    mp = model_axis(model_parallel) if model_parallel > 1 else None
    world = 1 if dp is None else dp.world
    device = (torch.device(device) if distributed.process_count() == 1
              else distributed.local_device(device))
    primary = distributed.is_primary()
    say = log if primary else (lambda *_: None)  # the training log: the primary's only

    if model_source.endswith(".ggml"):
        config, tokenizer, params_np = loader.load_ggml(model_source)
    else:
        config, tokenizer, params_np = loader.load_hf_pretrained(model_source,
                                                                  keep_training=True)
    if "posterior_encoder.conv_pre.weight" not in params_np:
        raise ValueError("checkpoint lacks the training-only modules (posterior encoder, SDP "
                         "posterior flows); export with keep_training=True")

    dataset = VitsDataset(corpus_dir, tokenizer, config)
    say(f"dataset: {len(dataset)} utterances")
    tp = None if mp is None else tensor_parallel(params_np, mp, config.head_dim)

    def own(arrays):  # the rank's slices of whole arrays
        return arrays if mp is None else shard_params(arrays, mp, config.head_dim)

    def whole(params):  # whole tensors from the rank's slices (a collective)
        return params if mp is None else gather_params(params, tp.plan, mp)

    gen_params = {k: v.requires_grad_() for k, v in
                  from_jax_params(own(params_np), device).items()}
    disc_params = {k: v.requires_grad_() for k, v in
                   from_jax_params(init_discriminator_params(seed), device).items()}
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    shard = dp if zero1 else None
    gen_opt = vits_optimizer(gen_params, learning_rate, steps_per_epoch=steps_per_epoch,
                             zero1=shard, model_parallel=tp)
    disc_opt = vits_optimizer(
        disc_params, disc_learning_rate if disc_learning_rate is not None else learning_rate,
        steps_per_epoch=steps_per_epoch, zero1=shard)
    ema = ParamEMA()
    ema_params = ema.init(gen_params)

    start_step = 0
    if latest_step(out_dir) is not None:
        restored = restore_checkpoint(out_dir)
        _load_into(gen_params, own(restored["gen_params"]))
        if restored["disc_params"] is not None:
            _load_into(disc_params, restored["disc_params"])
        if restored["gen_opt"] is not None:
            gen_opt.load_state_arrays(restored["gen_opt"])
        if restored["disc_opt"] is not None:
            disc_opt.load_state_arrays(restored["disc_opt"])
        if restored["gen_params_ema"] is not None:
            _load_into(ema_params, own(restored["gen_params_ema"]))
            say("restored EMA weights")
        start_step = restored["step"]
        say(f"resumed from step {start_step}")

    if adversarial:
        step_fn = make_gan_train_step(config, gen_params, disc_params, gen_opt, disc_opt,
                                      segment_frames=segment_frames, grad_accum=grad_accum,
                                      compute_dtype=compute_dtype, data_parallel=dp,
                                      model_parallel=tp)
    else:
        step_fn = make_train_step(config, gen_params, gen_opt, segment_frames=segment_frames,
                                  grad_accum=grad_accum, compute_dtype=compute_dtype,
                                  data_parallel=dp, model_parallel=tp)
    noise_gen = torch.Generator(device=device).manual_seed(seed + start_step)

    with contextlib.ExitStack() as teardown:
        batches = Prefetcher(dataset.batches(batch_size, np.random.default_rng(seed)))
        teardown.callback(batches.close)
        # registered last, so it stops first: it force-exits the process on a
        # heartbeat gap, and checkpoint writes during an unwind must not race it
        watchdog = Watchdog(out_dir, stall_seconds=stall_seconds,
                            process_index=distributed.process_index(), abort=stall_abort,
                            log=log)
        teardown.callback(watchdog.stop)
        t0 = time.perf_counter()
        for step_idx, batch in zip(range(start_step + 1, steps + 1), batches):
            watchdog.beat(step_idx)
            metrics = step_fn(batch_to(pad_rows(batch, world, segment_frames), device),
                              noise_gen)
            ema.update(ema_params, gen_params, step_idx - 1)

            if step_idx % log_every == 0 and primary:
                values = {k: float(v) for k, v in metrics._asdict().items()}
                rate = log_every / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                fields = " ".join(f"{k}={v:.3f}" for k, v in values.items())
                log(f"step {step_idx}: {fields} ({rate:.2f} it/s)")
                if metrics_hook is not None:
                    metrics_hook(step_idx, values, rate)

            if step_idx % checkpoint_every == 0 or step_idx == steps:
                # every rank gathers the optimizer states and the split tensors (a
                # collective under ZeRO-1 or a model axis); one writer: concurrent
                # writers would corrupt the directory
                if primary or zero1 or mp is not None:
                    gen_state = gen_opt.state_arrays()
                    disc_state = disc_opt.state_arrays() if adversarial else None
                    gen_whole, ema_whole = whole(gen_params), whole(ema_params)
                if primary:
                    save_checkpoint(
                        out_dir, step_idx, gen_whole, gen_state,
                        disc_params if adversarial else None, disc_state, ema_whole,
                        metadata={"batch_size": batch_size, "lr": learning_rate,
                                  "model_parallel": model_parallel})
                    log(f"checkpointed step {step_idx}")
                if dp is not None:
                    torch.distributed.barrier()
    return whole(gen_params)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--model", required=True, help=".ggml (keep_training) or HF name")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; cpu)")
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--no-gan", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer update")
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"),
                    help="model compute dtype (master params stay fp32)")
    ap.add_argument("--zero1", action="store_true",
                    help="split the optimizer moments over the data-parallel ranks (ZeRO-1)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel degree: ranks that hold the slices of one model "
                         "(the world must divide by it)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}, but no CUDA device is visible "
              "(--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    launched = "WORLD_SIZE" in os.environ  # torchrun's, or set by hand per process
    if launched:
        distributed.initialize(device=args.device)
    try:
        train(args.corpus, args.model, args.out, steps=args.steps, batch_size=args.batch_size,
              learning_rate=args.lr, adversarial=not args.no_gan, grad_accum=args.grad_accum,
              compute_dtype=args.dtype, zero1=args.zero1, model_parallel=args.model_parallel,
              device=args.device)
    finally:
        if launched:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
