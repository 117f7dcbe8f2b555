"""The port's command line (``python -m vits_tpu_torch.cli``) and the server's
``main`` on the CPU, with ``tests/fixtures/tiny-vits.ggml``.

Synthesis to a WAV, ``--stream`` (the TTFA printed; the audio within one
int16 step of the one-shot decode), ``--long``, ``--convert``; every flag the
port does not honour exits non-zero, and so does the default ``--device
cuda`` where no CUDA device is visible. The server is started as a user
starts it (``--device cpu --port 0``) and answers ``/synthesize`` and
``/stream``.
"""

import json
import os
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

import vits_tpu_torch
from vits_tpu_torch import cli
from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine import server
from vits_tpu_torch.engine.longform import synthesize_long
from vits_tpu_torch.utils.wav import read_wav, write_wav

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GGML = os.path.join(REPO, "tests", "fixtures", "tiny-vits.ggml")
TEXT = "hello sad dame well cheese"
INT16_STEP = 1.5 / 32767


@pytest.fixture(scope="module", autouse=True)
def plain_convs_fixed_order():
    # oneDNN picks its conv algorithm per sequence length; with it off a stream
    # window and the whole utterance sum each output in one order.
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _run(tmp_path, *args) -> tuple[int, np.ndarray | None]:
    out = str(tmp_path / "out.wav")
    code = cli.main(["--model", GGML, "--device", "cpu", "--out", out, *args])
    return code, (read_wav(out)[0] if os.path.exists(out) else None)


def test_cli_synthesizes_a_wav(tmp_path, capsys):
    code, audio = _run(tmp_path, "--text", TEXT, "--seed", "3", "--bench", "1")
    assert code == 0
    want = vits_tpu_torch.load_model(GGML, device="cpu").synthesize(TEXT, seed=3)
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=INT16_STEP, rtol=0)
    printed = capsys.readouterr().out
    assert "Synthesized" in printed and "Average time" in printed


def test_cli_stream_prints_ttfa_and_matches_oneshot(tmp_path, capsys):
    code, audio = _run(tmp_path, "--text", TEXT, "--seed", "3", "--stream")
    assert code == 0
    assert "TTFA:" in capsys.readouterr().out
    model = vits_tpu_torch.load_model(GGML, EngineConfig(transfer_int16=False), device="cpu")
    want = model.synthesize(TEXT, seed=3)
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=INT16_STEP, rtol=0)


def test_cli_long(tmp_path):
    text = "One sentence here. And another one!"
    code, audio = _run(tmp_path, "--long", "--text", text, "--seed", "2")
    assert code == 0
    want = synthesize_long(vits_tpu_torch.load_model(GGML, device="cpu"), text, seed=2)
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=INT16_STEP, rtol=0)


def test_cli_convert(tmp_path):
    model = vits_tpu_torch.load_model(GGML, device="cpu")
    source = str(tmp_path / "source.wav")
    write_wav(source, model.synthesize("hello dame", seed=1), model.config.sampling_rate)
    code, audio = _run(tmp_path, "--convert", source)
    assert code == 0
    want = model.convert_voice(read_wav(source)[0])
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=INT16_STEP, rtol=0)


@pytest.mark.parametrize("flags", [
    ("--compilation-cache", "cache"),
])
def test_cli_refuses_unported_flags(tmp_path, flags, capsys):
    with pytest.raises(SystemExit) as exc:
        _run(tmp_path, "--text", "hi", *flags)
    assert exc.value.code != 0
    assert "ROADMAP.md" in capsys.readouterr().err
    assert not (tmp_path / "out.wav").exists()


class _Loaded(Exception):
    """Raised by a stand-in load_model: carries the EngineConfig main built."""


@pytest.fixture()
def engine_of_main(monkeypatch):
    """Run a main up to its load_model call and return the EngineConfig it passed."""
    def fake(source, engine_config=None, device=None):
        raise _Loaded(engine_config)

    monkeypatch.setattr(vits_tpu_torch, "load_model", fake)

    def run(main, *argv):
        with pytest.raises(_Loaded) as caught:
            main(["--model", GGML, "--device", "cpu", *argv])
        return caught.value.args[0]

    return run


@pytest.mark.parametrize("tier", ["fast", "glue32", "high", "exact"])
def test_cli_and_server_take_every_fidelity_tier(tier, engine_of_main):
    """``--fidelity`` takes the JAX CLI's and server's four tiers, through
    ``EngineConfig.fidelity_kwargs``; without it both run ``fast``."""
    want = EngineConfig.fidelity_kwargs(tier)
    for main, extra in ((cli.main, ("--text", "hi")), (server.main, ("--port", "0"))):
        eng = engine_of_main(main, *extra, "--fidelity", tier)
        assert {f: getattr(eng, f) for f in want} == want
        default = engine_of_main(main, *extra)
        assert (default.pallas_precision, default.pallas_value_dtype,
                default.pallas_weight_format, default.matmul_precision) == (None,) * 4


def test_cli_fidelity_tiers_synthesize_on_cpu(tmp_path):
    """Every tier synthesizes through the CLI on the CPU (there the engine's
    defaults compute fp32, so each tier's audio is the default's)."""
    want = _run(tmp_path, "--text", TEXT)[1]
    for tier in ("glue32", "high", "exact"):
        code, audio = _run(tmp_path, "--text", TEXT, "--fidelity", tier)
        assert code == 0
        np.testing.assert_array_equal(audio, want)


def test_cli_and_server_default_to_cuda(tmp_path, capsys):
    """Without --device both ask for cuda; with no CUDA device they exit non-zero."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    out = str(tmp_path / "out.wav")
    assert cli.main(["--model", GGML, "--text", "hi", "--out", out]) != 0
    assert "no CUDA device" in capsys.readouterr().err and not os.path.exists(out)
    with pytest.raises(SystemExit) as exc:
        server.main(["--model", GGML, "--port", "0"])
    assert exc.value.code not in (0, None) and "no CUDA device" in str(exc.value.code)


@pytest.mark.parametrize("flags", [
    ("--aot-bundle", "bundle"), ("--compilation-cache", "cache"),
])
def test_server_refuses_unported_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        server.main(["--model", GGML, "--device", "cpu", "--port", "0", *flags])
    assert exc.value.code != 0
    assert "ROADMAP.md" in capsys.readouterr().err


def test_server_main_serves_on_cpu():
    """``python -m vits_tpu_torch.engine.server --device cpu --port 0 --stream-mux 2``
    warms up, prints its address, and answers /synthesize and /stream."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vits_tpu_torch.engine.server", "--model", GGML,
         "--device", "cpu", "--port", "0", "--stream-mux", "2", "--max-batch", "4"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(300, proc.kill)  # a hung start fails instead of blocking
    watchdog.start()
    try:
        line = proc.stdout.readline()
        assert "serving on http://" in line, (line, proc.stderr.read() if proc.poll() else "")
        url = line.split()[-2]
        bodies = []
        for path in ("/synthesize", "/stream"):
            req = urllib.request.Request(url + path, data=json.dumps({"text": "hello"}).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as resp:
                bodies.append(resp.read())
        assert all(b[:4] == b"RIFF" and len(b) > 44 for b in bodies)
    finally:
        watchdog.cancel()
        proc.terminate()
        proc.wait(timeout=30)
