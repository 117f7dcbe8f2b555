"""The port's AOT bundles and kernel library cache (``vits_tpu_torch/io/aot.py``,
``ops/cuda::use_build_dir`` / ``load_library``) on the CPU.

The nine cases of ``tests/test_aot.py`` as the port's own (a CPU bundle has
no library: the engine's plain twins are its program), the parity of a
one-program bundle with the JAX package's (signatures, ``frames_per_token``,
the bundle-served audio within ``tests/test_torch_synthesis.py``'s bounds),
the refusals of a CUDA bundle's library, ``compilation_cache_dir`` and the
export script (the CLI's and the server's flags: tests/test_torch_cli.py).
"""

import copy
import ctypes
import hashlib
import json
import os
import runpy
import shutil

import numpy as np
import pytest
import torch

import vits_tpu
import vits_tpu_torch
from vits_tpu.config import EngineConfig as JaxEngineConfig
from vits_tpu.io.aot import export_bundle as jax_export_bundle
from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.io.aot import MANIFEST, AotBundle, export_bundle
from vits_tpu_torch.ops import cuda as kernels

torch.set_num_threads(2)

FIXTURE = "tests/fixtures/tiny-vits.ggml"
ENGINE_KW = dict(token_buckets=(64,), frames_per_token=4.0, transfer_int16=False)
WAVE_ATOL = 2e-4  # tests/test_torch_synthesis.py: the whole path against JAX
TEXT = "hello aot bundle"


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """(bundle_dir, reference model, manifest): signatures for batch 1 and 2."""
    ref = vits_tpu_torch.load_model(FIXTURE, EngineConfig(**ENGINE_KW), device="cpu")
    out = str(tmp_path_factory.mktemp("aot_bundle"))
    manifest = export_bundle(ref, out, batch_sizes=(1, 2))
    return out, ref, manifest


@pytest.fixture(scope="module")
def aot_model(bundle):
    out, _, _ = bundle
    return vits_tpu_torch.load_model(FIXTURE, EngineConfig(**ENGINE_KW, aot_bundle_dir=out),
                                     device="cpu")


@pytest.fixture
def fresh_library(monkeypatch, tmp_path):
    """No library loaded and the build directory under ``tmp_path``, both
    restored afterwards; ``ctypes.CDLL`` opens nothing (a CPU test has no CUDA
    library to open)."""
    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_lib_path", None)
    monkeypatch.setattr(kernels, "_lib_digest", None)
    monkeypatch.setattr(kernels, "_build_dir", tmp_path / "default_build")
    monkeypatch.setattr(kernels, "build_seconds", None)
    opened = []

    class FakeLibrary:
        def __init__(self, path):
            opened.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(ctypes, "CDLL", FakeLibrary)
    return opened


def _stub_library(directory) -> str:
    """A file named as this checkout's library, in ``directory``."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, kernels.library_name(kernels.source_digest()))
    with open(path, "wb") as f:
        f.write(b"\x7fELF stub of the kernel library" * 8)
    return path


def test_manifest_contents(bundle):
    out, ref, manifest = bundle
    assert os.path.exists(os.path.join(out, MANIFEST))
    # 1 bucket x 2 batches x 2 rng layouts x 2 speaker variants, each run once
    assert len(manifest["programs"]) == 8
    signatures = set()
    for e in manifest["programs"]:
        assert e["tokens"] == 64 and e["frames"] == ref._frame_capacity(64)
        assert e["platforms"] == ["cpu"] and e["file"] is None
        signatures.add((e["batch"], e["tokens"], e["frames"],
                        (e["batch"],) if e["rng_rows"] else (), e["speaker"]))
    assert len(signatures) == 8 and signatures <= ref._dispatch_shapes
    assert manifest["version"] == 1 and manifest["torch_version"] == torch.__version__
    assert "library" not in manifest and manifest["options"]["kernels"] is False
    assert manifest["frames_per_token"] == 4.0 and len(manifest["fingerprint"]) == 32


def test_aot_serve_bit_identical(bundle, aot_model):
    _, ref, _ = bundle
    wa = ref.synthesize(TEXT, seed=4)
    wb = aot_model.synthesize(TEXT, seed=4)
    np.testing.assert_array_equal(wa, wb)
    assert aot_model.stats["aot_hits"] >= 1
    assert aot_model.stats["redispatches"] == 0


def test_aot_batch_and_controls(bundle, aot_model):
    _, ref, _ = bundle
    hits0 = aot_model.stats["aot_hits"]
    got = aot_model.synthesize(["hello", "sad dame"], seed=[1, 2])
    want = ref.synthesize(["hello", "sad dame"], seed=[1, 2])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    g2 = aot_model.synthesize("hello", seed=1, speaking_rate=1.4)
    w2 = ref.synthesize("hello", seed=1, speaking_rate=1.4)
    np.testing.assert_array_equal(g2, w2)
    assert aot_model.stats["aot_hits"] == hits0 + 2
    assert aot_model.stats["aot_misses"] == 0


def test_unexported_signature_counts_a_miss(bundle, aot_model):
    """batch=3 was not exported: the dispatch counts a miss and runs the same path."""
    _, ref, _ = bundle
    misses0 = aot_model.stats["aot_misses"]
    got = aot_model.synthesize(["a b", "c", "hello well"], seed=[1, 2, 3])
    want = ref.synthesize(["a b", "c", "hello well"], seed=[1, 2, 3])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert aot_model.stats["aot_misses"] == misses0 + 1


def test_engine_option_mismatch_rejected(bundle):
    out, _, _ = bundle
    with pytest.raises(ValueError, match="engine options differ"):
        vits_tpu_torch.load_model(FIXTURE, EngineConfig(
            **{**ENGINE_KW, "transfer_int16": True}, aot_bundle_dir=out), device="cpu")


def test_model_mismatch_rejected(bundle):
    """A bundle refuses a different model architecture."""
    out, ref, _ = bundle
    import dataclasses

    from vits_tpu_torch.engine.synthesizer import Synthesizer
    from vits_tpu_torch.io.random_init import _random_params_numpy

    config = dataclasses.replace(ref.config,
                                 upsample_initial_channel=2 * ref.config.upsample_initial_channel)
    with pytest.raises(ValueError, match="different model"):
        Synthesizer(config, ref.tokenizer, _random_params_numpy(config, 0, False),
                    EngineConfig(**ENGINE_KW, aot_bundle_dir=out), device="cpu")


def test_mesh_engine_export_raises(tmp_path):
    from vits_tpu_torch.parallel.mesh import make_mesh

    model = vits_tpu_torch.load_model(FIXTURE, EngineConfig(**ENGINE_KW),
                                      mesh=make_mesh(devices=[torch.device("cpu")] * 2))
    with pytest.raises(NotImplementedError, match="mesh"):
        export_bundle(model, str(tmp_path / "nope"))
    assert not (tmp_path / "nope").exists()


def test_bundle_version_gate(bundle, tmp_path):
    out, _, _ = bundle
    with open(os.path.join(out, MANIFEST)) as f:
        manifest = json.load(f)
    manifest["version"] = 99
    bad = tmp_path / "bad_bundle"
    bad.mkdir()
    with open(bad / MANIFEST, "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="version"):
        AotBundle(str(bad))


def test_cross_platform_cuda_export(bundle, tmp_path, monkeypatch, fresh_library):
    """``platforms=["cuda"]`` from a CPU engine builds the library with nvcc
    (here: none, so it raises nvcc's error and writes no CPU bundle instead);
    with the build stubbed it records the library's digest and sha256, the
    options a CUDA engine resolves, and a CPU engine refuses the bundle."""
    _, ref, _ = bundle
    with monkeypatch.context() as m:  # no nvcc anywhere
        m.delenv("CUDA_HOME", raising=False)
        m.delenv("CUDA_PATH", raising=False)
        m.setattr(kernels.shutil, "which", lambda name: str(tmp_path / "no-nvcc"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            export_bundle(ref, str(tmp_path / "none"), platforms=["cuda"])
    assert not (tmp_path / "none" / MANIFEST).exists()
    dispatches = ref.stats["dispatches"]

    stub = _stub_library(tmp_path / "built")
    monkeypatch.setattr(kernels, "build", lambda: kernels.Path(stub))
    out = str(tmp_path / "cuda_bundle")
    manifest = export_bundle(ref, out, batch_sizes=(1,), per_row_seeds=(False,),
                             with_speaker=False, platforms=("cuda",))
    lib = manifest["library"]
    assert lib["digest"] == kernels.source_digest()
    assert lib["file"] == os.path.basename(stub)
    assert lib["sha256"] == hashlib.sha256(kernels.Path(stub).read_bytes()).hexdigest()
    assert all(e["platforms"] == ["cuda"] and e["file"] == lib["file"]
               for e in manifest["programs"])
    assert manifest["options"]["kernels"] is True
    assert manifest["options"]["tiers"]["attention"]["mode"] == "fast"  # a card's auto tier
    assert ref.stats["dispatches"] == dispatches  # nothing ran
    with pytest.raises(ValueError, match="engine options differ"):
        vits_tpu_torch.load_model(FIXTURE, EngineConfig(**ENGINE_KW, aot_bundle_dir=out),
                                  device="cpu")
    assert fresh_library == []


def _cuda_view(model):
    """The engine as a CUDA engine of the same EngineConfig looks to ``verify``."""
    view = copy.copy(model)
    view.device = torch.device("cuda")
    return view


@pytest.mark.parametrize("fault", ["sha256", "digest", "capability"])
def test_cuda_bundle_refusals_before_the_library_loads(bundle, tmp_path, monkeypatch,
                                                       fresh_library, fault):
    """A CUDA bundle whose library has one byte flipped, whose manifest names
    another source digest, or that meets a card other than compute capability
    9.0 raises in ``verify``, and nothing is opened."""
    _, ref, _ = bundle
    stub = _stub_library(tmp_path / "built")
    monkeypatch.setattr(kernels, "build", lambda: kernels.Path(stub))
    out = tmp_path / "cuda_bundle"
    export_bundle(ref, str(out), batch_sizes=(1,), per_row_seeds=(False,),
                  with_speaker=False, platforms=("cuda",))
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (9, 0))
    bundle_ = AotBundle(str(out))
    bundle_.verify(_cuda_view(ref))  # the bundle as exported passes
    if fault == "sha256":
        data = bytearray(bundle_.library_file.read_bytes())
        data[5] ^= 0x01
        bundle_.library_file.write_bytes(bytes(data))
        match = "sha256"
    elif fault == "digest":
        manifest = json.loads((out / MANIFEST).read_text())
        manifest["library"]["digest"] = "0" * 16
        (out / MANIFEST).write_text(json.dumps(manifest))
        match = "source digest"
    else:
        monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: (8, 0))
        match = "compute capability"
    with pytest.raises(ValueError, match=match):
        AotBundle(str(out)).verify(_cuda_view(ref))
    assert fresh_library == []


def test_library_loads_from_a_file_once_per_digest(tmp_path, fresh_library):
    """``load_library`` opens a file of this checkout's digest without building
    (build_seconds 0.0); another digest, before or after, raises naming both; a
    file of the same digest elsewhere is the loaded library where its bytes
    are the same, and raises where they are not."""
    stub = _stub_library(tmp_path / "bundle")
    other = tmp_path / "other" / kernels.library_name("0123456789abcdef")
    other.parent.mkdir()
    shutil.copyfile(stub, other)
    with pytest.raises(ValueError, match="0123456789abcdef.*" + kernels.source_digest()):
        kernels.load_library(other, "0123456789abcdef")
    assert fresh_library == []
    kernels.load_library(stub, kernels.source_digest())
    assert fresh_library == [stub] and kernels.loaded_library() == kernels.Path(stub)
    assert kernels.build_seconds == 0.0
    with pytest.raises(ValueError, match=f"0123456789abcdef.*{kernels.source_digest()}"):
        kernels.load_library(other, "0123456789abcdef")
    assert kernels.load_library(stub, kernels.source_digest()) is kernels.library()
    copy = tmp_path / "copy" / os.path.basename(stub)
    copy.parent.mkdir()
    shutil.copyfile(stub, copy)
    assert kernels.load_library(copy, kernels.source_digest()) is kernels.library()
    copy.write_bytes(copy.read_bytes() + b"\0")
    with pytest.raises(ValueError, match="same digest and other bytes"):
        kernels.load_library(copy, kernels.source_digest())
    assert len(fresh_library) == 1 and kernels.loaded_library() == kernels.Path(stub)


def test_compilation_cache_dir_names_the_library_path(tmp_path, fresh_library):
    """A CPU engine with ``compilation_cache_dir`` moves the library path into
    the directory (process-wide) and builds nothing."""
    cache = tmp_path / "cache"
    model = vits_tpu_torch.load_model(
        FIXTURE, EngineConfig(**ENGINE_KW, compilation_cache_dir=str(cache)), device="cpu")
    model.synthesize("hello", seed=0)
    assert kernels.library_path().parent == cache.absolute()
    assert not cache.exists() or not os.listdir(cache)
    assert kernels.build_seconds is None and fresh_library == []


def test_compilation_cache_dir_receives_the_loaded_library(tmp_path, fresh_library):
    """The last engine to name a directory wins: a library already loaded from
    elsewhere (a bundle's) is copied there for the next process."""
    stub = _stub_library(tmp_path / "bundle")
    kernels.load_library(stub, kernels.source_digest())
    cache = tmp_path / "cache"
    vits_tpu_torch.load_model(FIXTURE, EngineConfig(**ENGINE_KW, compilation_cache_dir=str(cache)),
                              device="cpu")
    copied = cache / os.path.basename(stub)
    assert copied.read_bytes() == kernels.Path(stub).read_bytes()
    assert kernels.library_path() == copied.absolute()


@pytest.fixture(scope="module")
def jax_and_port_bundles(tmp_path_factory):
    """One program each from the JAX package and the port: batch 1, one key,
    no speaker, on the fixture; and an engine of each serving from it."""
    jax_kw = dict(ENGINE_KW, use_pallas_vocoder=False, use_pallas_attention=False)
    one = dict(batch_sizes=(1,), per_row_seeds=(False,), with_speaker=False)
    jax_dir = str(tmp_path_factory.mktemp("jax_bundle"))
    jax_manifest = jax_export_bundle(
        vits_tpu.load_model(FIXTURE, JaxEngineConfig(**jax_kw)), jax_dir, **one)
    port_dir = str(tmp_path_factory.mktemp("port_bundle"))
    port_manifest = export_bundle(
        vits_tpu_torch.load_model(FIXTURE, EngineConfig(**ENGINE_KW), device="cpu"),
        port_dir, **one)
    jax_model = vits_tpu.load_model(FIXTURE, JaxEngineConfig(**jax_kw, aot_bundle_dir=jax_dir))
    port_model = vits_tpu_torch.load_model(
        FIXTURE, EngineConfig(**ENGINE_KW, aot_bundle_dir=port_dir), device="cpu")
    return jax_manifest, port_manifest, jax_model, port_model


def test_bundle_matches_the_jax_bundle(jax_and_port_bundles):
    """The same signatures and frame ratio as JAX's bundle, and the audio each
    serves from its bundle (noise scales 0: the packages share no random
    stream) within the whole path's bound."""
    jax_manifest, port_manifest, jax_model, port_model = jax_and_port_bundles
    key = lambda e: (e["batch"], e["tokens"], e["frames"], e["rng_rows"], e["speaker"])  # noqa: E731
    assert [key(e) for e in port_manifest["programs"]] == [key(e) for e in
                                                            jax_manifest["programs"]]
    assert port_manifest["frames_per_token"] == jax_manifest["frames_per_token"]
    controls = dict(seed=0, noise_scale=0.0, noise_scale_duration=0.0)
    want = jax_model.synthesize(TEXT, **controls)
    got = port_model.synthesize(TEXT, **controls)
    assert jax_model.stats["aot_hits"] == port_model.stats["aot_hits"] == 1
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=WAVE_ATOL, rtol=0)


def test_export_script_and_serving_from_its_bundle(tmp_path, capsys):
    """``scripts/torch_export_aot.py --device cpu`` prints JAX's JSON line, the
    bundle serves, and ``--pallas off`` is refused in the engine's words."""
    script = runpy.run_path("scripts/torch_export_aot.py")
    out = str(tmp_path / "bundle")
    assert script["main"](["--model", FIXTURE, "--out", out, "--device", "cpu",
                           "--token-buckets", "64", "--frames-per-token", "4"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["programs"] == 4 and line["platforms"] == ["cpu"]
    assert line["bytes"] == os.path.getsize(os.path.join(out, MANIFEST))
    model = vits_tpu_torch.load_model(
        FIXTURE, EngineConfig(token_buckets=(64,), frames_per_token=4.0, aot_bundle_dir=out),
        device="cpu")
    assert model.synthesize("hello", seed=[3]) is not None
    assert model.stats["aot_hits"] == 1 and model.stats["aot_misses"] == 0
    assert line["fingerprint"] == model._aot.manifest["fingerprint"]
    with pytest.raises(SystemExit) as exc:
        script["main"](["--model", FIXTURE, "--out", out, "--device", "cpu",
                        "--pallas", "off"])
    assert exc.value.code == 2 and "no kernel-off switch" in capsys.readouterr().err
