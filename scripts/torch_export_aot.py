"""Export an AOT serving bundle of vits_tpu_torch (the kernel library and its manifest).

    python scripts/torch_export_aot.py --model vits-eng.ggml --out bundle/ \
        [--batch-sizes 1,2,4,8,16] [--token-buckets 64,128] [--device cuda] \
        [--platforms cuda] [--pallas {auto,on}] [--dtype float32]

Then serve without a build (no nvcc needed):

    python -m vits_tpu_torch.engine.server --model vits-eng.ggml --aot-bundle bundle/

On the card each exported signature runs once through the engine. ``--device
cpu --platforms cuda`` is the cross-platform export: nvcc builds the library on
a machine without a card and the signatures are recorded unrun. The port has
no kernel-off switch, so ``--pallas off`` is refused. Prints one JSON line:
bundle, programs, bytes, platforms, fingerprint.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True, help=".ggml path or HF dir")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--batch-sizes", default="1",
                    help="comma-separated batch sizes to export")
    ap.add_argument("--token-buckets", default=None,
                    help="comma-separated token buckets (default: engine's)")
    ap.add_argument("--frames-per-token", type=float, default=None)
    ap.add_argument("--platforms", default=None,
                    help="'cuda' or 'cpu' (default: the --device's)")
    ap.add_argument("--pallas", choices=("auto", "on", "off"), default="auto",
                    help="kernel selection: auto and on run the kernels on the card; "
                         "off is refused (the port has no kernel-off switch)")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the exporting engine (default cuda)")
    args = ap.parse_args(argv)

    import vits_tpu_torch
    from vits_tpu_torch.config import EngineConfig
    from vits_tpu_torch.engine.synthesizer import _check_engine_config
    from vits_tpu_torch.io.aot import export_bundle

    kw = {"compute_dtype": args.dtype}
    if args.token_buckets:
        kw["token_buckets"] = tuple(int(b) for b in args.token_buckets.split(","))
    if args.frames_per_token is not None:
        kw["frames_per_token"] = args.frames_per_token
    if args.pallas != "auto":
        on = args.pallas == "on"
        kw["use_pallas_vocoder"] = on
        kw["use_pallas_attention"] = on
    engine = EngineConfig(**kw)
    try:
        _check_engine_config(engine)
    except NotImplementedError as exc:
        ap.error(f"--pallas off: {exc}")

    import torch

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print(f"error: --device {args.device}, but no CUDA device is visible (--device cpu "
              "--platforms cuda exports for the card from here)", file=sys.stderr)
        return 1
    model = vits_tpu_torch.load_model(args.model, engine, device=args.device)
    manifest = export_bundle(
        model, args.out,
        batch_sizes=tuple(int(b) for b in args.batch_sizes.split(",")),
        platforms=args.platforms.split(",") if args.platforms else None,
    )
    files = {"manifest.json"} | {e["file"] for e in manifest["programs"] if e["file"]}
    print(json.dumps({
        "bundle": args.out,
        "programs": len(manifest["programs"]),
        "bytes": sum(os.path.getsize(os.path.join(args.out, f)) for f in sorted(files)),
        "platforms": sorted({p for e in manifest["programs"] for p in e["platforms"]}),
        "fingerprint": manifest["fingerprint"],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
