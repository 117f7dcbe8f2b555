"""AOT serving bundles: the built kernel library and a verified manifest.

Counterpart of ``vits_tpu/io/aot.py``. The JAX engine compiles one XLA program
per dispatch signature (batch x token bucket x frames x rng layout x speaker
presence) and a JAX bundle serialises those programs. The port runs PyTorch
eagerly: its only compiled code is the CUDA kernel library
(``ops/cuda/__init__.py``), and kernel 6's CUDA graphs cannot be written to
disk. So a port bundle is that library, copied byte for byte, and JAX's
manifest beside it::

    model = vits_tpu_torch.load_model("vits-eng.ggml")             # on the card
    from vits_tpu_torch.io.aot import export_bundle
    export_bundle(model, "bundle/", batch_sizes=(1, 4))             # once
    ...
    model = vits_tpu_torch.load_model(
        "vits-eng.ggml", EngineConfig(aot_bundle_dir="bundle/"))    # no nvcc
    model.synthesize("hello")

The manifest records the model's fingerprint (its config and the names,
shapes and dtypes of its parameters, never their values), the resolved
program options, ``frames_per_token`` and the exported signatures, each of
which ran once through the exporting engine with this library; for a CUDA
bundle also the library's file name, source digest and sha256. Loading
verifies all of it before any dispatch and before the library is opened: a
bundle of another version, model, options, library bytes or sources, or a
card that is not compute capability 9.0, raises ``ValueError``.

A signature the bundle lists counts a hit (``stats["aot_hits"]``), any other
a miss (``stats["aot_misses"]``), as in the JAX engine; both run the same
kernels from the same library, nothing falls back. Weights are not in the
bundle. v1 limit, as in JAX: single-device engines only (a mesh engine's
export raises).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Optional, Sequence

import torch

from vits_tpu_torch.ops import cuda as kernels
from vits_tpu_torch.ops.tiers import MODE_NAMES, Tier

MANIFEST = "manifest.json"
_VERSION = 1
PLATFORMS = ("cuda", "cpu")
COMPUTE_CAPABILITY = (9, 0)  # the library's kernels are built for sm_90a only


def _tier(tier: Tier) -> dict:
    return {"mode": MODE_NAMES[tier.mode], "bf16_values": tier.bf16_values,
            "bf16_compute": tier.bf16_compute}


def resolved_program_options(synth, platform: Optional[str] = None) -> dict:
    """The engine options that select what a dispatch runs, resolved as
    ``engine/synthesizer.py::resolve_tiers`` resolves them on ``platform``
    (default: the engine's device): whether the kernels run (on a CUDA
    engine; the plain twins on a CPU engine), the flow kernel, each kernel's
    tier, the vocoder packs' weight format and value dtype, the compute dtype
    and the int16 transfer."""
    from vits_tpu_torch.engine.synthesizer import resolve_tiers

    platform = platform or synth.device.type
    eng = synth.engine
    tiers, weight_format = resolve_tiers(eng, torch.device(platform), synth._quantized)
    return {
        "kernels": platform == "cuda",
        "use_pallas_flow": bool(eng.use_pallas_flow),
        "tiers": {"vocoder": tiers.vocoder, "attention": _tier(tiers.attention),
                  "flow": _tier(tiers.flow)},
        "weight_format": weight_format,
        "value_dtype": str(tiers.value_dtype).removeprefix("torch."),
        "compute_dtype": eng.compute_dtype,
        "transfer_int16": bool(eng.transfer_int16),
    }


def model_fingerprint(synth) -> str:
    """Hash of the model's config and its parameters' names, shapes and dtypes
    (as the engine holds them) -- NOT the values: a bundle pairs with any
    checkpoint of the same architecture."""
    h = hashlib.sha256()
    h.update(repr(synth.config).encode())
    for name in sorted(synth.params):
        p = synth.params[name]
        h.update(f"{name}:{tuple(p.shape)}:{p.dtype}".encode())
    return h.hexdigest()[:32]


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def export_bundle(
    synth,
    out_dir: str,
    *,
    batch_sizes: Sequence[int] = (1,),
    token_buckets: Optional[Sequence[int]] = None,
    per_row_seeds: Sequence[bool] = (False, True),
    with_speaker: Optional[bool] = None,
    platforms: Optional[Sequence[str]] = None,
) -> dict:
    """Write a bundle of the engine's signatures to ``out_dir``.

    One signature per (batch, token bucket, rng layout, speaker presence), at
    the engine's frame capacity of each bucket. ``platforms`` is ``["cuda"]``
    or ``["cpu"]`` (default: the engine's device). On an engine of that
    platform each signature runs once through the engine's ``warmup`` (on the
    card: with the library copied into the bundle). ``["cuda"]`` from a CPU engine is the
    cross-platform export: ``nvcc`` builds the library, which needs no card
    (without ``nvcc`` it raises), the options are resolved as a CUDA engine of
    the same ``EngineConfig`` resolves them, and nothing runs. Returns the
    manifest dict.
    """
    if synth.mesh is not None:
        raise NotImplementedError(
            "AOT bundles cover single-device engines; the mesh engine's replicas are not "
            "exportable yet")
    platforms = list(platforms or [synth.device.type])
    if len(platforms) != 1 or platforms[0] not in PLATFORMS:
        raise ValueError(f"platforms {platforms}: one of {PLATFORMS}")
    platform = platforms[0]
    if platform == "cpu" and synth.device.type != "cpu":
        raise ValueError("a CPU bundle is exported from a CPU engine")
    run = platform == synth.device.type
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    library = None
    if platform == "cuda":
        if run:
            kernels.library()
            built = kernels.loaded_library()
        else:
            built = kernels.build()
        library = {"file": built.name, "digest": kernels.source_digest()}
        if (out / built.name).resolve() != built.resolve():
            shutil.copyfile(built, out / built.name)
        library["sha256"] = _sha256(out / built.name)

    token_buckets = tuple(token_buckets or synth.engine.token_buckets)
    speaker_variants = ((False, True) if with_speaker is None
                        else ((True,) if with_speaker else (False,)))
    if run:
        for rng_rows in per_row_seeds:
            for speaker in speaker_variants:
                synth.warmup(batch_sizes, token_buckets, per_row_seeds=rng_rows, speaker=speaker)
    entries = [{"file": library and library["file"], "batch": batch, "tokens": tokens,
                "frames": synth._frame_capacity(tokens), "rng_rows": rng_rows,
                "speaker": speaker, "platforms": [platform]}
               for tokens in token_buckets for batch in batch_sizes
               for rng_rows in per_row_seeds for speaker in speaker_variants]

    manifest = {
        "version": _VERSION,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "fingerprint": model_fingerprint(synth),
        "options": resolved_program_options(synth, platform),
        "frames_per_token": synth._frames_per_token,
        "programs": entries,
    }
    if library is not None:
        manifest["library"] = library
    with open(out / MANIFEST, "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


class AotBundle:
    """A loaded bundle: its manifest, verified against an engine, and the
    signatures it lists."""

    def __init__(self, bundle_dir: str):
        self.dir = bundle_dir
        with open(os.path.join(bundle_dir, MANIFEST)) as f:
            self.manifest = json.load(f)
        if self.manifest.get("version") != _VERSION:
            raise ValueError(
                f"AOT bundle version {self.manifest.get('version')} != supported {_VERSION}")
        self._index = {
            (e["batch"], e["tokens"], e["frames"], bool(e["rng_rows"]), bool(e["speaker"])): e
            for e in self.manifest["programs"]
        }

    @property
    def frames_per_token(self) -> float:
        return float(self.manifest["frames_per_token"])

    @property
    def library_file(self) -> Path | None:
        lib = self.manifest.get("library")
        return None if lib is None else Path(self.dir) / lib["file"]

    def verify(self, synth) -> None:
        """Refuse a bundle exported for another model or other program-selecting
        options, a library whose bytes or sources differ from the manifest's and
        this checkout's, or a card the library was not built for. Opens nothing."""
        fp = model_fingerprint(synth)
        if fp != self.manifest["fingerprint"]:
            raise ValueError(
                f"AOT bundle {self.dir} was exported for a different model "
                f"(fingerprint {self.manifest['fingerprint']} != {fp})")
        opts = resolved_program_options(synth)
        if opts != self.manifest["options"]:
            diff = {k: (self.manifest["options"].get(k), opts.get(k))
                    for k in set(opts) | set(self.manifest["options"])
                    if self.manifest["options"].get(k) != opts.get(k)}
            raise ValueError(
                f"AOT bundle {self.dir} engine options differ (bundle vs engine): {diff}")
        lib = self.manifest.get("library")
        if lib is None:
            return
        sha = _sha256(self.library_file)
        if sha != lib["sha256"]:
            raise ValueError(f"AOT bundle {self.dir}: library {lib['file']} has sha256 {sha}, "
                             f"the manifest says {lib['sha256']}")
        digest = kernels.source_digest()
        if lib["digest"] != digest or lib["file"] != kernels.library_name(lib["digest"]):
            raise ValueError(f"AOT bundle {self.dir}: library {lib['file']} of source digest "
                             f"{lib['digest']}, these sources' digest is {digest}")
        capability = torch.cuda.get_device_capability(synth.device)
        if capability != COMPUTE_CAPABILITY:
            raise ValueError(f"AOT bundle {self.dir}: the library is built for compute "
                             f"capability {COMPUTE_CAPABILITY}, {synth.device} is {capability}")

    def load_library(self) -> None:
        """Load a CUDA bundle's library (``ops.cuda.load_library``: no build);
        call :meth:`verify` first."""
        lib = self.manifest.get("library")
        if lib is not None:
            kernels.load_library(self.library_file, lib["digest"])

    def lookup(self, batch: int, tokens: int, frames: int, rng_rows: bool,
               speaker: bool) -> dict | None:
        """The manifest's entry of the signature, or None when not exported."""
        return self._index.get((batch, tokens, frames, bool(rng_rows), bool(speaker)))
