"""The port's package boundary: parameter loading, and no jax anywhere.

``vits_tpu_torch`` imports torch and nothing of jax or of ``vits_tpu``: the
host modules it shares with the JAX package (config, checkpoint io, random
weights, tokenizer, wav, the training watchdog and synthetic corpus,
long-form synthesis, the HTTP server above its ``main``) are its own copies,
held here against their originals.
"""

import ast
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import vits_tpu_torch
from vits_tpu import config as jax_config
from vits_tpu.io import random_init as jax_random_init
from vits_tpu.io.loader import export_to_ggml as jax_export_to_ggml
from vits_tpu.io.loader import load_ggml
from vits_tpu.text.tokenizer import VitsTokenizer as JaxVitsTokenizer
from vits_tpu_torch import config as port_config
from vits_tpu_torch.io import export_to_ggml, random_params
from vits_tpu_torch.io import load_ggml as port_load_ggml
from vits_tpu_torch.io import random_init as port_random_init
from vits_tpu_torch.io.params import from_jax_params
from vits_tpu_torch.text.tokenizer import VitsTokenizer

GGML = "tests/fixtures/tiny-vits.ggml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_from_jax_params_round_trip():
    _, _, params = load_ggml(os.path.join(REPO, GGML))
    tensors = from_jax_params(params, "cpu")
    assert tensors.keys() == params.keys()
    for name, value in params.items():
        t = tensors[name]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), value)


def test_port_never_imports_jax():
    """Import the port and synthesize on the CPU with jax and vits_tpu made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None  # any 'import jax' now raises ImportError\n"
        "sys.modules['vits_tpu'] = None  # and so does any import of the JAX package\n"
        "import vits_tpu_torch\n"
        "from vits_tpu_torch.ops.cuda import attention, flow, resblock, stage\n"
        "from vits_tpu_torch.train import loop\n"
        "from vits_tpu_torch.parallel import distributed, mesh\n"
        "from vits_tpu_torch import cli\n"
        "from vits_tpu_torch.engine import mux, server, sp, streaming\n"
        "from vits_tpu_torch.io import quantize\n"
        "from vits_tpu_torch.ops import precision, tiers\n"
        f"m = vits_tpu_torch.load_model({GGML!r}, device='cpu')\n"
        "audio = m.synthesize('hello world')\n"
        "assert audio.size > 0\n"
        "streamed = streaming.StreamingDecoder(m, chunk_frames=16).synthesize_streaming('hello')\n"
        "assert streamed.size > 0\n"
        "print('ok')\n"
    )
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = sorted(Path(REPO, "vits_tpu_torch").rglob("*.py")) + [
        Path(REPO, "chip_smoke.py"), Path(REPO, "tests", "test_torch_dp_worker.py")]
    found = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
             if m.split(".")[0] in ("jax", "jaxlib", "vits_tpu")]
    assert len(files) > 30 and not found, found


def _fields(cls):
    return [(f.name, str(f.type), f.default, f.default_factory) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["VitsConfig", "EngineConfig"])
def test_config_copies_match_field_for_field(name):
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    assert vits_tpu_torch.VitsConfig is port_config.VitsConfig
    assert _fields(ours) == _fields(theirs)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_load_ggml_copy_matches_original():
    ours, theirs = port_load_ggml(os.path.join(REPO, GGML)), load_ggml(os.path.join(REPO, GGML))
    assert dataclasses.asdict(ours[0]) == dataclasses.asdict(theirs[0])
    assert ours[1].vocab == theirs[1].vocab and ours[2].keys() == theirs[2].keys()
    for name, value in theirs[2].items():
        np.testing.assert_array_equal(ours[2][name], value)


def test_tokenizer_copy_matches_original():
    config, tokenizer, _ = load_ggml(os.path.join(REPO, GGML))
    kw = dict(vocab=tokenizer.vocab, add_blank=tokenizer.add_blank,
              normalize=tokenizer.normalize, pad_token=tokenizer.pad_token,
              unk_token=tokenizer.unk_token, phonetic=config.phonetic)
    ours, theirs = VitsTokenizer(**kw), JaxVitsTokenizer(**kw)
    texts = ["hello world", "Hello, World! 123", "", "zzz qq -- '"]
    for text in texts:
        assert ours.encode(text) == theirs.encode(text)
    for a, b in zip(ours.pad([ours.encode(t) for t in texts], pad_to=64),
                    theirs.pad([theirs.encode(t) for t in texts], pad_to=64)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("init", ["_random_params_hf", "_random_params_numpy"])
def test_random_params_copy_matches_original(init):
    config = dataclasses.replace(
        port_config.VitsConfig(), hidden_size=32, num_hidden_layers=1, ffn_dim=64, flow_size=16,
        upsample_initial_channel=32, upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8),
        resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1,),),
        prior_encoder_num_wavenet_layers=1, posterior_encoder_num_wavenet_layers=1,
        duration_predictor_filter_channels=32, num_speakers=3, speaker_embedding_size=8)
    ours = getattr(port_random_init, init)(config, 3, True)
    theirs = getattr(jax_random_init, init)(
        jax_config.VitsConfig(**dataclasses.asdict(config)), 3, True)
    assert ours.keys() == theirs.keys()
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name], value)
    if init == "_random_params_hf":
        assert random_params(config, seed=3).keys() == ours.keys()


def test_export_round_trip_through_both_packages():
    """The port's export_to_ggml -> the JAX load_ggml, and the JAX export -> the port's load."""
    config, tokenizer, params = load_ggml(os.path.join(REPO, GGML))
    for export, load in ((export_to_ggml, load_ggml), (jax_export_to_ggml, port_load_ggml)):
        buf = io.BytesIO()
        export(buf, config, tokenizer, params, fp16_convs=False)
        config2, tokenizer2, params2 = load(buf.getvalue())
        assert dataclasses.asdict(config2) == dataclasses.asdict(config)
        assert tokenizer2.vocab == tokenizer.vocab and params2.keys() == params.keys()
        for name, value in params.items():
            np.testing.assert_array_equal(params2[name], value)


def _code_without_docstrings(path: Path, tree: ast.Module | None = None) -> str:
    tree = tree or ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_precision_copy_matches_original():
    """ops/precision.py imports nothing of JAX: the port's copy is verbatim."""
    ours = Path(REPO, "vits_tpu_torch", "ops", "precision.py")
    theirs = Path(REPO, "vits_tpu", "ops", "precision.py")
    assert ours.read_text() == theirs.read_text()
    assert set(_imported_modules(ours)) == {"__future__", "typing"}


def test_quantize_copy_matches_original():
    """io/quantize.py: the port's copy is the original's code, docstrings aside,
    without its unused ``import jax.numpy as jnp``."""
    ours = Path(REPO, "vits_tpu_torch", "io", "quantize.py")
    theirs = Path(REPO, "vits_tpu", "io", "quantize.py")
    tree = ast.parse(theirs.read_text(), filename=str(theirs))
    tree.body = [node for node in tree.body if not (
        isinstance(node, ast.Import) and all(a.name.startswith("jax") for a in node.names))]
    assert _code_without_docstrings(ours) == _code_without_docstrings(theirs, tree)
    assert set(_imported_modules(ours)) == {"__future__", "os", "typing", "numpy"}


def test_longform_copy_matches_original():
    """engine/longform.py imports only re and numpy: the port's copy is the
    original's code, docstrings aside."""
    ours = Path(REPO, "vits_tpu_torch", "engine", "longform.py")
    theirs = Path(REPO, "vits_tpu", "engine", "longform.py")
    assert _code_without_docstrings(ours) == _code_without_docstrings(theirs)
    assert set(_imported_modules(ours)) == {"__future__", "re", "typing", "numpy"}


def _definitions_without_docstrings(path: Path, rename: tuple[str, str] | None = None) -> list:
    """The module's top-level statements but ``main``, its docstring and the
    ``__main__`` block, each as an AST dump without docstrings; ``rename``
    rewrites the package prefix of every ``from ... import``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
        if rename and isinstance(node, ast.ImportFrom) and node.module.startswith(rename[0]):
            node.module = rename[1] + node.module[len(rename[0]):]
    return [ast.dump(node) for node in tree.body
            if not (isinstance(node, ast.FunctionDef) and node.name == "main")
            and not isinstance(node, ast.If)]


def test_server_copy_matches_original_above_main():
    """engine/server.py above ``main`` imports the standard library, numpy and
    the wav helpers: the port's copy is the original's code, docstrings aside,
    with the package's name in its imports."""
    ours = Path(REPO, "vits_tpu_torch", "engine", "server.py")
    theirs = Path(REPO, "vits_tpu", "engine", "server.py")
    want = _definitions_without_docstrings(theirs, ("vits_tpu.", "vits_tpu_torch."))
    assert _definitions_without_docstrings(ours) == want and len(want) > 8
    ported = {m for m in _imported_modules(ours) if m.startswith("vits_tpu_torch")}
    assert ported == {"vits_tpu_torch", "vits_tpu_torch.config", "vits_tpu_torch.utils.wav",
                      "vits_tpu_torch.engine.streaming", "vits_tpu_torch.engine.mux",
                      "vits_tpu_torch.parallel.mesh"}


def test_native_copy_matches_original():
    """io/native.py (the C++ runtime's ctypes bindings) imports the standard library
    and numpy at the top: the port's copy is the original's code, docstrings aside,
    with the package's name in its imports."""
    ours = Path(REPO, "vits_tpu_torch", "io", "native.py")
    theirs = Path(REPO, "vits_tpu", "io", "native.py")
    want = _definitions_without_docstrings(theirs, ("vits_tpu.", "vits_tpu_torch."))
    assert _definitions_without_docstrings(ours) == want and len(want) > 8
    assert set(_imported_modules(ours)) == {
        "__future__", "ctypes", "os", "typing", "numpy", "vits_tpu_torch.config",
        "vits_tpu_torch.io.params", "vits_tpu_torch.text.tokenizer"}
