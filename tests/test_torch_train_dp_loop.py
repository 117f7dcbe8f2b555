"""The port's training loop across two gloo ranks: one writer, and the command line.

``train()`` in two OS processes joined over ``torch.distributed`` on the CPU
(``tests/test_torch_dp_worker.py``, scenario ``writer``): exactly one
primary, checkpoints written by rank 0 only, log lines from rank 0 only --
the counterpart of ``tests/test_distributed.py``. Then ``python -m
vits_tpu_torch.train.loop --device cpu --zero1`` as two processes with
torchrun's variables set by hand: rank 0 writes the checkpoint, and a second
invocation resumes from it. Batch size 3 on two ranks: every batch is padded
to an even number of rows (``parallel/mesh.py::pad_rows``).
"""

import os
import subprocess
import sys

import pytest

from tests.test_torch_dp_worker import free_port, spawn, wait_all
from vits_tpu_torch.io.loader import export_to_ggml, load_ggml
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.train.checkpoint import latest_step
from vits_tpu_torch.train.data import corpus_vocab, generate_micro_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "tiny-vits.ggml")
CLI_TIMEOUT_S = 600


@pytest.fixture(scope="module")
def corpus_and_model(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    config, _, params = load_ggml(FIXTURE)
    corpus = str(root / "corpus")
    generate_micro_corpus(corpus, n_utts=4, words_range=(1, 2))
    model = str(root / "model.ggml")
    export_to_ggml(model, config, VitsTokenizer(vocab=corpus_vocab(), pad_token="_",
                                                unk_token="?"), params, fp16_convs=False)
    return corpus, model


@pytest.fixture(scope="module")
def writer_run(corpus_and_model, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dp_writer"))
    port = free_port()
    wait_all([spawn("writer", r, 2, port, out, *corpus_and_model) for r in range(2)])
    return out


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def test_exactly_one_primary(writer_run):
    import json

    ranks = [json.loads(_read(os.path.join(writer_run, f"primary-{r}.json"))) for r in range(2)]
    assert [r["primary"] for r in ranks] == [True, False]
    assert [r["index"] for r in ranks] == [0, 1] and {r["count"] for r in ranks} == {2}


def test_only_rank_zero_writes_checkpoints(writer_run):
    assert _read(os.path.join(writer_run, "writer-0")).split("\n")[:2] == ["step 1", "step 2"]
    assert not os.path.exists(os.path.join(writer_run, "writer-1"))
    run = os.path.join(writer_run, "run")
    assert latest_step(run) == 2
    # each rank beat its own heartbeat file (the watchdog's process index is its rank)
    assert {f for f in os.listdir(run) if f.startswith("heartbeat-")} == {
        "heartbeat-0.json", "heartbeat-1.json"}


def test_only_rank_zero_logs(writer_run):
    lines = _read(os.path.join(writer_run, "train-log-0.txt")).splitlines()
    assert "dataset: 4 utterances" in lines and "checkpointed step 2" in lines
    assert any(line.startswith("step 2:") for line in lines)
    assert _read(os.path.join(writer_run, "train-log-1.txt")) == ""


def _cli(rank: int, port: int, corpus: str, model: str, out: str, steps: int, log: str):
    env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
               MASTER_ADDR="localhost", MASTER_PORT=str(port), OMP_NUM_THREADS="2")
    with open(log, "wb") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "vits_tpu_torch.train.loop", "--corpus", corpus, "--model",
             model, "--out", out, "--device", "cpu", "--zero1", "--steps", str(steps),
             "--batch-size", "3"],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)


def test_cli_two_ranks_zero1_checkpoints_and_resumes(corpus_and_model, tmp_path):
    corpus, model = corpus_and_model
    out = str(tmp_path / "run")
    outputs = []
    for steps in (2, 3):
        port = free_port()
        logs = [str(tmp_path / f"cli-{steps}-{r}.txt") for r in range(2)]
        procs = [_cli(r, port, corpus, model, out, steps, logs[r]) for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=CLI_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        texts = [_read(log) for log in logs]
        assert [p.returncode for p in procs] == [0, 0], texts[0][-3000:] + texts[1][-3000:]
        outputs.append(texts)
    (first0, first1), (second0, second1) = outputs
    assert "checkpointed step 2" in first0 and "checkpointed step 3" in second0
    assert "resumed from step 2" in second0 and "restored EMA weights" in second0
    for text in (first1, second1):  # rank 1 trains, and logs nothing of it
        said = [line for line in text.splitlines() if line.startswith(
            ("step ", "checkpointed", "dataset:", "resumed", "restored"))]
        assert not said, said
    assert latest_step(out) == 3
