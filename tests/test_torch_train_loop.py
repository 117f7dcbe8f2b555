"""The port's training entry point: ``python -m vits_tpu_torch.train.loop``.

``main`` with ``--dtype bfloat16`` on the tiny ggml fixture trains GAN steps
on the synthetic micro-corpus, checkpoints, and resumes from the checkpoint
(on the CPU, ``--device cpu``: its plain twins); its defaults are the card
(``--device cuda``) and fp32, and without a visible card it exits non-zero
with a message, as the port's other entry points do. ``model_parallel > 1``
still raises, naming the roadmap item, from ``train`` and from the command
line's ``--model-parallel`` (``zero1`` trains: tests/test_torch_train_dp*.py).
"""

import os

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
    corpus, model = corpus_and_model
    with pytest.raises(NotImplementedError, match="queue 1, item 1.3"):
        loop.train(corpus, model, str(tmp_path / "y"), steps=1, device="cpu", **kwargs)


def test_main_model_parallel_raises(corpus_and_model, tmp_path):
    corpus, model = corpus_and_model
    with pytest.raises(NotImplementedError, match="queue 1, item 1.3"):
        loop.main(["--corpus", corpus, "--model", model, "--out", str(tmp_path / "y"),
                   "--device", "cpu", "--steps", "1", "--model-parallel", "2"])
