"""The port's training entry point: ``python -m vits_tpu_torch.train.loop``.

``main`` with ``--dtype bfloat16`` on the tiny ggml fixture trains GAN steps
on the synthetic micro-corpus, checkpoints, and resumes from the checkpoint
(on the CPU, ``--device cpu``: its plain twins); its defaults are the card
(``--device cuda``) and fp32, and without a visible card it exits non-zero
with a message, as the port's other entry points do. ``model_parallel=k``
raises ``ValueError`` where the world does not divide by k (one process,
k = 2), from ``train`` and from the command line's ``--model-parallel``; two
processes with torchrun's variables train at ``--model-parallel 2``, their
checkpoint resumes in one process at ``model=1``, and that one's at
``model=2`` again (the step itself: tests/test_torch_tensor_parallel.py).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vits_tpu_torch.io.loader import export_to_ggml, load_ggml
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.train import loop
from vits_tpu_torch.train.checkpoint import latest_step
from vits_tpu_torch.train.data import corpus_vocab, generate_micro_corpus

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "tiny-vits.ggml")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def corpus_and_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("loop")
    config, _, params = load_ggml(FIXTURE)
    corpus = str(root / "corpus")
    generate_micro_corpus(corpus, n_utts=4, words_range=(1, 2))
    model = str(root / "model.ggml")
    export_to_ggml(model, config, VitsTokenizer(vocab=corpus_vocab(), pad_token="_",
                                                unk_token="?"), params, fp16_convs=False)
    return corpus, model


def test_main_bf16_checkpoints_and_resumes(corpus_and_model, tmp_path, capsys):
    corpus, model = corpus_and_model
    out = str(tmp_path / "run")
    args = ["--corpus", corpus, "--model", model, "--out", out, "--device", "cpu",
            "--dtype", "bfloat16", "--batch-size", "2"]
    assert loop.main(args + ["--steps", "2"]) == 0
    assert "checkpointed step 2" in capsys.readouterr().out and latest_step(out) == 2
    assert loop.main(args + ["--steps", "3"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 2" in second and "restored EMA weights" in second
    assert "checkpointed step 3" in second and latest_step(out) == 3
    with np.load(os.path.join(out, "step_00000003", "gen_params.npz")) as saved:
        assert all(saved[k].dtype == np.float32 and np.isfinite(saved[k]).all()
                   for k in saved.files)


def test_main_defaults_to_the_card(corpus_and_model, tmp_path, capsys, monkeypatch):
    corpus, model = corpus_and_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = loop.main(["--corpus", corpus, "--model", model, "--out", str(tmp_path / "x"),
                    "--steps", "1"])
    assert rc != 0
    assert "no CUDA device is visible" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "x")


@pytest.mark.parametrize("kwargs", [{"model_parallel": 2}])
def test_multi_gpu_options_raise(corpus_and_model, tmp_path, kwargs):
    """A world of one process does not divide by model_parallel=2."""
    corpus, model = corpus_and_model
    with pytest.raises(ValueError, match="model_parallel=2"):
        loop.train(corpus, model, str(tmp_path / "y"), steps=1, device="cpu", **kwargs)


def test_main_model_parallel_raises(corpus_and_model, tmp_path):
    corpus, model = corpus_and_model
    with pytest.raises(ValueError, match="model_parallel=2"):
        loop.main(["--corpus", corpus, "--model", model, "--out", str(tmp_path / "y"),
                   "--device", "cpu", "--steps", "1", "--model-parallel", "2"])


def _model_parallel_cli(corpus, model, out, steps, logs):
    """``python -m vits_tpu_torch.train.loop --model-parallel 2`` as two processes
    with torchrun's variables; returns their logs."""
    from tests.test_torch_dp_worker import free_port

    port, procs = free_port(), []
    for rank, log in enumerate(logs):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
        with open(log, "wb") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "vits_tpu_torch.train.loop", "--corpus", corpus,
                 "--model", model, "--out", out, "--device", "cpu", "--steps", str(steps),
                 "--batch-size", "2", "--model-parallel", "2"],
                cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    texts = []
    for log in logs:
        with open(log) as f:
            texts.append(f.read())
    assert [p.returncode for p in procs] == [0, 0], texts[0][-3000:] + texts[1][-3000:]
    return texts


def test_main_model_parallel_two_ranks_resumes_across_widths(corpus_and_model, tmp_path,
                                                            capsys):
    """``--model-parallel 2`` on two ranks checkpoints whole tensors under their
    JAX names; one process resumes it at model=1, and two ranks resume that one
    at model=2 again."""
    corpus, model = corpus_and_model
    out = str(tmp_path / "run")
    first = _model_parallel_cli(corpus, model, out, 2,
                                [str(tmp_path / f"a{r}.txt") for r in range(2)])
    assert "checkpointed step 2" in first[0] and "checkpointed" not in first[1]
    _, _, params = load_ggml(model)
    with np.load(os.path.join(out, "step_00000002", "gen_params.npz")) as saved:
        assert {k: saved[k].shape for k in saved.files} == {k: v.shape for k, v in
                                                            params.items()}
    with np.load(os.path.join(out, "step_00000002", "gen_opt.npz")) as saved:
        for k, v in params.items():
            assert saved[f"{k}.exp_avg"].shape == v.shape, k
    assert loop.main(["--corpus", corpus, "--model", model, "--out", out, "--device", "cpu",
                      "--steps", "3", "--batch-size", "2"]) == 0
    said = capsys.readouterr().out
    assert "resumed from step 2" in said and "checkpointed step 3" in said
    again = _model_parallel_cli(corpus, model, out, 4,
                                [str(tmp_path / f"b{r}.txt") for r in range(2)])
    assert "resumed from step 3" in again[0] and "checkpointed step 4" in again[0]
    assert latest_step(out) == 4
