"""Training loop: data -> GAN steps on one device -> checkpoints, resumable.

Counterpart of ``vits_tpu/train/loop.py``::

    python -m vits_tpu_torch.train.loop --corpus ./LJSpeech-1.1 \\
        --model mms-eng.ggml --out ./run1 --steps 100000 --device cuda

Picks up the latest checkpoint in ``out_dir``; writes one every
``checkpoint_every`` steps and at the end, with the EMA weights beside the
raw ones (``train/checkpoint.py``). One device: ``model_parallel > 1``,
``zero1`` and ``compute_dtype="bfloat16"`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from vits_tpu_torch.io import loader
from vits_tpu_torch.io.params import from_jax_params
from vits_tpu_torch.models.discriminator import init_discriminator_params
from vits_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from vits_tpu_torch.train.data import Prefetcher, VitsDataset
from vits_tpu_torch.train.schedule import ParamEMA, vits_optimizer
from vits_tpu_torch.train.step import batch_to, make_gan_train_step, make_train_step
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
    on ``corpus_dir``; returns the generator parameters."""
    if model_parallel > 1 or zero1:
        raise NotImplementedError("multi-GPU training (model_parallel, zero1) is not ported yet")
    if compute_dtype != "float32":
        raise NotImplementedError(f"compute_dtype={compute_dtype!r}: the port trains in fp32")
    device = torch.device(device)

    if model_source.endswith(".ggml"):
        config, tokenizer, params_np = loader.load_ggml(model_source)
    else:
        config, tokenizer, params_np = loader.load_hf_pretrained(model_source,
                                                                  keep_training=True)
    if "posterior_encoder.conv_pre.weight" not in params_np:
        raise ValueError("checkpoint lacks the training-only modules (posterior encoder, SDP "
                         "posterior flows); export with keep_training=True")

    dataset = VitsDataset(corpus_dir, tokenizer, config)
    log(f"dataset: {len(dataset)} utterances")
    gen_params = {k: v.requires_grad_() for k, v in from_jax_params(params_np, device).items()}
    disc_params = {k: v.requires_grad_() for k, v in
                   from_jax_params(init_discriminator_params(seed), device).items()}
    steps_per_epoch = max(len(dataset) // batch_size, 1)
    gen_opt = vits_optimizer(gen_params, learning_rate, steps_per_epoch=steps_per_epoch)
    disc_opt = vits_optimizer(
        disc_params, disc_learning_rate if disc_learning_rate is not None else learning_rate,
        steps_per_epoch=steps_per_epoch)
    ema = ParamEMA()
    ema_params = ema.init(gen_params)

    start_step = 0
    if latest_step(out_dir) is not None:
        restored = restore_checkpoint(out_dir)
        _load_into(gen_params, restored["gen_params"])
        if restored["disc_params"] is not None:
            _load_into(disc_params, restored["disc_params"])
        if restored["gen_opt"] is not None:
            gen_opt.load_state_arrays(restored["gen_opt"])
        if restored["disc_opt"] is not None:
            disc_opt.load_state_arrays(restored["disc_opt"])
        if restored["gen_params_ema"] is not None:
            _load_into(ema_params, restored["gen_params_ema"])
            log("restored EMA weights")
        start_step = restored["step"]
        log(f"resumed from step {start_step}")

    if adversarial:
        step_fn = make_gan_train_step(config, gen_params, disc_params, gen_opt, disc_opt,
                                      segment_frames=segment_frames, grad_accum=grad_accum)
    else:
        step_fn = make_train_step(config, gen_params, gen_opt, segment_frames=segment_frames,
                                  grad_accum=grad_accum)
    noise_gen = torch.Generator(device=device).manual_seed(seed + start_step)

    with contextlib.ExitStack() as teardown:
        batches = Prefetcher(dataset.batches(batch_size, np.random.default_rng(seed)))
        teardown.callback(batches.close)
        # registered last, so it stops first: it force-exits the process on a
        # heartbeat gap, and checkpoint writes during an unwind must not race it
        watchdog = Watchdog(out_dir, stall_seconds=stall_seconds, process_index=0,
                            abort=stall_abort, log=log)
        teardown.callback(watchdog.stop)
        t0 = time.perf_counter()
        for step_idx, batch in zip(range(start_step + 1, steps + 1), batches):
            watchdog.beat(step_idx)
            metrics = step_fn(batch_to(batch, device), noise_gen)
            ema.update(ema_params, gen_params, step_idx - 1)

            if step_idx % log_every == 0:
                values = {k: float(v) for k, v in metrics._asdict().items()}
                rate = log_every / (time.perf_counter() - t0)
                t0 = time.perf_counter()
                fields = " ".join(f"{k}={v:.3f}" for k, v in values.items())
                log(f"step {step_idx}: {fields} ({rate:.2f} it/s)")
                if metrics_hook is not None:
                    metrics_hook(step_idx, values, rate)

            if step_idx % checkpoint_every == 0 or step_idx == steps:
                save_checkpoint(
                    out_dir, step_idx, gen_params, gen_opt,
                    disc_params if adversarial else None, disc_opt if adversarial else None,
                    ema_params, metadata={"batch_size": batch_size, "lr": learning_rate})
                log(f"checkpointed step {step_idx}")
    return gen_params


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--corpus", required=True)
    ap.add_argument("--model", required=True, help=".ggml (keep_training) or HF name")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", required=True, help="torch device, e.g. cuda")
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--no-gan", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatches per optimizer update")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    train(args.corpus, args.model, args.out, steps=args.steps, batch_size=args.batch_size,
          learning_rate=args.lr, adversarial=not args.no_gan, grad_accum=args.grad_accum,
          device=args.device)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
