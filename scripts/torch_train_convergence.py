"""Training convergence of the PyTorch port on the card: GAN training on the synthetic corpus.

The port's twin of ``scripts/train_convergence.py``: the same reduced-width
VITS (``small_config``, every module at narrow widths), the same deterministic
synthetic micro-corpus (``vits_tpu_torch/train/synthetic.py``, 64 utterances,
seed 0) and the same eval -- the reconstruction mel-L1 (target audio ->
posterior -> flow forward and reverse -> vocoder, frames aligned 1:1 with the
target) and the free-running one (text -> synthesis), of the raw and the EMA
weights -- through the port's own training loop (``train.loop.train``) on the
card. The JAX package's run is ``docs/convergence/eval.json`` (16,000 steps).

    python scripts/torch_train_convergence.py --steps 16000 --disc-lr 2.5e-5 \\
        --out docs/convergence_torch [--dtype bfloat16] [--device cuda]

Trains in chunks of ``--chunk`` steps (each a ``train()`` call that resumes
from the last one's checkpoint, data order reshuffled per call); with
``--max-seconds`` it stops before a chunk that would end past that wall time
since the script started, and evaluates what it reached. Writes
``loss_curve.json`` (every ``--log-every`` steps: losses and it/s),
``eval.json`` (with the card's name and power limit from nvidia-smi, the
steps, the wall seconds), and the run directory ``run/`` (checkpoints, git-
ignored) under ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def small_config():
    """``scripts/train_convergence.py::small_config``, as the port's VitsConfig."""
    from vits_tpu_torch.config import VitsConfig

    return VitsConfig(
        vocab_size=20,
        hidden_size=96,
        num_hidden_layers=3,
        num_attention_heads=2,
        ffn_dim=192,
        flow_size=96,
        spectrogram_bins=513,
        upsample_initial_channel=256,
        upsample_rates=(8, 8, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4),
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 3, 5)),
        prior_encoder_num_flows=2,
        prior_encoder_num_wavenet_layers=3,
        posterior_encoder_num_wavenet_layers=8,
        duration_predictor_num_flows=2,
        duration_predictor_filter_channels=96,
    )


def card() -> str:
    """nvidia-smi's name and power limit of the card, or what stands in for them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as err:
        return f"no nvidia-smi ({err.__class__.__name__})"


def run_eval(out_dir, run_dir, corpus, config, tokenizer, device) -> dict:
    """The JAX script's eval on the latest checkpoint, raw and EMA weights: mel-L1
    of free-running synthesis and of reconstruction against the corpus targets."""
    import torch

    from vits_tpu_torch.config import EngineConfig
    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.train.checkpoint import latest_step
    from vits_tpu_torch.train.data import VitsDataset
    from vits_tpu_torch.utils.mel import log_mel_spectrogram
    from vits_tpu_torch.utils.wav import write_wav

    def mel_l1(a, b):
        n = min(len(a), len(b))
        if n < 2048:
            return None
        m1, m2 = (log_mel_spectrogram(torch.as_tensor(np.asarray(w[None, :n], np.float32)),
                                      sample_rate=config.sampling_rate) for w in (a, b))
        return float((m1 - m2).abs().mean())

    step = latest_step(run_dir)
    ckpt_dir = os.path.join(run_dir, f"step_{step:08d}")
    free_running, reconstruction = {}, {}
    dataset = VitsDataset(corpus, tokenizer, config)
    for name, fname in (("raw", "gen_params.npz"), ("ema", "gen_params_ema.npz")):
        path = os.path.join(ckpt_dir, fname)
        if not os.path.exists(path):
            continue
        with np.load(path) as data:
            gp = {k: data[k] for k in data.files}
        model = Synthesizer(config, tokenizer, gp,
                            EngineConfig(token_buckets=(64,),
                                         **EngineConfig.fidelity_kwargs("exact")),
                            device=device)
        frees, recons = [], []
        for i, utt in enumerate(dataset.utterances[:8]):
            item = dataset.load(utt)
            if item is None:
                continue
            _, _, target = item
            wave = model.synthesize(utt.text, seed=0, noise_scale=0.0, noise_scale_duration=0.0)
            v = mel_l1(wave, target)
            if v is not None:
                frees.append(v)
            recon = model.convert_voice(np.asarray(target, np.float32))
            v = mel_l1(recon, target)
            if v is not None:
                recons.append(v)
            if i == 0:
                write_wav(os.path.join(out_dir, f"sample_{name}.wav"), np.asarray(wave),
                          config.sampling_rate)
        free_running[name] = float(np.mean(frees)) if frees else None
        reconstruction[name] = float(np.mean(recons)) if recons else None
        del model
    return {
        "mel_l1_vs_target": free_running,
        "mel_l1_reconstruction": reconstruction,
        "note": ("free-running = text->synthesis vs target (duration mismatch + acoustic "
                 "error); reconstruction = audio->posterior->flow->vocoder vs target (frames "
                 "aligned 1:1: acoustic error only, the duration-teacher-forced figure)"),
        "final_step": step,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--disc-lr", type=float, default=None,
                    help="discriminator learning rate (default: --lr)")
    ap.add_argument("--utts", type=int, default=64)
    ap.add_argument("--out", default="docs/convergence_torch")
    ap.add_argument("--segment-frames", type=int, default=32)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--chunk", type=int, default=1000, help="steps per train() call")
    ap.add_argument("--max-seconds", type=float, default=None,
                    help="stop before a chunk that would end past this wall time")
    ap.add_argument("--eval-only", action="store_true",
                    help="skip training; evaluate the run directory in --out")
    args = ap.parse_args()

    import torch

    from vits_tpu_torch.io import VitsTokenizer, export_to_ggml, random_params
    from vits_tpu_torch.train.data import corpus_vocab, generate_micro_corpus
    from vits_tpu_torch.train.loop import train

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}, but no CUDA device is visible", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="vits_torch_convergence_")
    corpus = os.path.join(tmp, "corpus")
    generate_micro_corpus(corpus, n_utts=args.utts, seed=0)
    config = small_config()
    tokenizer = VitsTokenizer(vocab=corpus_vocab(), pad_token="_", unk_token="?")
    run_dir = os.path.join(args.out, "run")
    info = {"card": card(), "torch": torch.__version__, "dtype": args.dtype,
            "batch_size": args.batch_size, "lr": args.lr, "disc_lr": args.disc_lr,
            "segment_frames": args.segment_frames}
    print(f"card: {info['card']}", flush=True)

    t0 = time.perf_counter()
    if not args.eval_only:
        ckpt = os.path.join(tmp, "init.ggml")
        export_to_ggml(ckpt, config, tokenizer, random_params(config, seed=0, keep_training=True),
                       fp16_convs=False)
        history = []

        def hook(step, metrics, rate):
            history.append({"step": step, **metrics, "it_per_s": rate})
            if len(history) % 20 == 0 or step == args.steps:
                with open(os.path.join(args.out, "loss_curve.json"), "w") as fh:
                    json.dump(history, fh, indent=1)

        done = 0
        while done < args.steps:
            elapsed = time.perf_counter() - t0
            per_step = elapsed / done if done else 0.0
            if (args.max_seconds is not None and done
                    and elapsed + per_step * min(args.chunk, args.steps - done) > args.max_seconds):
                print(f"stopping at step {done}: the next chunk would end past "
                      f"{args.max_seconds:.0f} s", flush=True)
                break
            target = min(done + args.chunk, args.steps)
            train(corpus, ckpt, run_dir, steps=target, batch_size=args.batch_size,
                  learning_rate=args.lr, disc_learning_rate=args.disc_lr,
                  segment_frames=args.segment_frames, checkpoint_every=args.chunk,
                  log_every=min(args.log_every, args.steps), adversarial=True,
                  metrics_hook=hook, compute_dtype=args.dtype, device=args.device)
            done = target
        info["steps_requested"] = args.steps
        with open(os.path.join(args.out, "loss_curve.json"), "w") as fh:
            json.dump(history, fh, indent=1)
    train_s = time.perf_counter() - t0
    results = run_eval(args.out, run_dir, corpus, config, tokenizer, args.device)
    results.update(info, train_seconds=train_s, eval_seconds=time.perf_counter() - t0 - train_s,
                   reference="docs/convergence/eval.json (JAX package, 16000 steps): "
                             "reconstruction raw 1.3671, EMA 1.2725")
    with open(os.path.join(args.out, "eval.json"), "w") as fh:
        json.dump(results, fh, indent=2)
    print("eval:", json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
