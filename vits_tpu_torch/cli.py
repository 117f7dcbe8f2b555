"""Command-line synthesis with the PyTorch port: load a model, synthesize,
write a WAV. Counterpart of ``vits_tpu/cli.py``; runs on ``--device cuda``
unless told otherwise.

    python -m vits_tpu_torch.cli --model voice.ggml \\
        --text "Cada amanecer trae consigo nuevas oportunidades" --out output.wav
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vits_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--model", required=True, help=".ggml path or HF model dir/name")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the plain PyTorch path)")
    parser.add_argument("--text", action="append",
                        help="text to synthesize (repeatable for batch)")
    parser.add_argument("--convert", metavar="WAV",
                        help="voice conversion: re-synthesize this WAV in the "
                             "--speaker-id voice (use --source-speaker for "
                             "multi-speaker checkpoints)")
    parser.add_argument("--source-speaker", type=int, default=None,
                        help="speaker the --convert audio was spoken by")
    parser.add_argument("--out", default="output.wav", help="output WAV path (or prefix for batches)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--speaker-id", type=int, default=None)
    parser.add_argument("--noise-scale", type=float, default=None,
                        help="prior noise scale (default: checkpoint config)")
    parser.add_argument("--noise-scale-duration", type=float, default=None,
                        help="duration-predictor noise scale")
    parser.add_argument("--speaking-rate", type=float, default=None,
                        help=">1 = faster speech, <1 = slower")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32",
                        help="compute dtype (EngineConfig.compute_dtype): bfloat16 serves "
                             "with bf16 parameters and activations, as the JAX CLI does")
    parser.add_argument("--fidelity", choices=["fast", "glue32", "high", "exact"],
                        default="fast",
                        help="precision tier (EngineConfig.fidelity_kwargs): fast = bf16 "
                             "kernel multiplies (the default, as in the JAX CLI), glue32 = "
                             "the same on the card (the port's glue is fp32 at every tier), "
                             "high = bf16x3 kernels, exact = fp32 (3xTF32) kernels")
    parser.add_argument("--bench", type=int, default=0, metavar="N",
                        help="after synthesis, time N repeat runs")
    parser.add_argument("--stream", action="store_true",
                        help="chunked streaming decode (prints the TTFA)")
    parser.add_argument("--sp", type=int, default=0, metavar="N",
                        help="time-sharded decode of each --text over N replicas "
                             "(engine/sp.py): --device cuda takes cards 0..N-1 (exits "
                             "where fewer are visible), --device cpu N CPU replicas")
    parser.add_argument("--long", action="store_true", dest="longform",
                        help="split long text at sentences, batch, and stitch")
    parser.add_argument("--compilation-cache", default=None, metavar="DIR",
                        help="kernel library cache (EngineConfig.compilation_cache_dir): "
                             "the first run builds the CUDA kernels into DIR, repeat runs "
                             "load them from there without nvcc")
    args = parser.parse_args(argv)
    if not args.text and not args.convert:
        parser.error("provide --text (synthesis) or --convert (voice conversion)")

    import numpy as np
    import torch

    import vits_tpu_torch
    from vits_tpu_torch.config import EngineConfig
    from vits_tpu_torch.utils.wav import write_wav

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}, but no CUDA device is visible "
              "(--device cpu runs on the CPU)", file=sys.stderr)
        return 1
    placement = {"device": args.device}
    if args.sp > 1:
        from vits_tpu_torch.parallel.mesh import make_mesh, replica_devices

        try:
            mesh = make_mesh(devices=replica_devices(args.device, args.sp))
        except ValueError as exc:
            print(f"error: --sp {args.sp}: {exc}", file=sys.stderr)
            return 1
        if not (args.convert or args.stream or args.longform):
            # the sharded decode's replicas are the mesh engine's (--convert,
            # --stream and --long take the single engine, as without --sp)
            placement = {"mesh": mesh}
    model = vits_tpu_torch.load_model(
        args.model, EngineConfig(compute_dtype=args.dtype,
                                 compilation_cache_dir=args.compilation_cache,
                                 **EngineConfig.fidelity_kwargs(args.fidelity)),
        **placement)
    controls = dict(
        noise_scale=args.noise_scale,
        noise_scale_duration=args.noise_scale_duration,
        speaking_rate=args.speaking_rate,
    )
    t0 = time.perf_counter()
    if args.convert:
        from vits_tpu_torch.utils.wav import read_wav

        audio, in_rate = read_wav(args.convert)
        if in_rate != model.config.sampling_rate:
            print(f"error: {args.convert} is {in_rate} Hz; the checkpoint "
                  f"expects {model.config.sampling_rate} Hz", file=sys.stderr)
            return 1
        waves = [model.convert_voice(
            audio, source_speaker=args.source_speaker,
            target_speaker=args.speaker_id, seed=args.seed,
            noise_scale=args.noise_scale or 0.0,
        )]
    elif args.stream:
        from vits_tpu_torch.engine.streaming import StreamingDecoder

        stream = StreamingDecoder(model)
        waves = []
        for text in args.text:
            chunks = []
            for i, chunk in enumerate(
                stream.stream(text, seed=args.seed, speaker_id=args.speaker_id,
                              **controls)
            ):
                if i == 0 and not waves:
                    print(f"TTFA: {(time.perf_counter() - t0) * 1000:.1f} ms")
                chunks.append(chunk)
            waves.append(np.concatenate(chunks))
    elif args.longform:
        from vits_tpu_torch.engine.longform import synthesize_long

        waves = [synthesize_long(model, " ".join(args.text), seed=args.seed,
                                 speaker_id=args.speaker_id, **controls)]
    elif model.mesh is not None:
        from vits_tpu_torch.engine.sp import ShardedDecoder

        sp = ShardedDecoder(model)
        waves = [sp.synthesize(t, seed=args.seed, speaker_id=args.speaker_id,
                               **controls) for t in args.text]
    else:
        waves = model.synthesize(list(args.text), seed=args.seed,
                                 speaker_id=args.speaker_id, **controls)
    t1 = time.perf_counter()

    rate = model.config.sampling_rate
    outs = []
    if len(waves) == 1:
        write_wav(args.out, waves[0], rate)
        outs.append(args.out)
    else:
        stem = args.out[:-4] if args.out.endswith(".wav") else args.out
        for i, w in enumerate(waves):
            path = f"{stem}_{i}.wav"
            write_wav(path, w, rate)
            outs.append(path)
    audio_sec = sum(len(w) for w in waves) / rate
    print(
        f"Synthesized {audio_sec:.2f}s of audio in {t1 - t0:.3f}s "
        f"(first call; {model.device}) -> {', '.join(outs)}"
    )

    if args.bench and args.text:
        times = []
        for _ in range(args.bench):
            t0 = time.perf_counter()
            model.synthesize(list(args.text), seed=args.seed,
                             speaker_id=args.speaker_id, **controls)
            times.append(time.perf_counter() - t0)
        avg = sum(times) / len(times)
        print(f"Average time: {avg * 1000:.2f} ms over {args.bench} runs "
              f"({audio_sec / avg:.1f}x real-time; {model.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
