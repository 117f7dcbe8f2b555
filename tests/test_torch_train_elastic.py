"""Elastic recovery of the port's data-parallel training: freeze a rank, detect, resume.

The counterpart of ``tests/test_elastic_recovery.py`` for ``vits_tpu_torch``:
two gloo ranks (``tests/test_torch_dp_worker.py``, scenario ``elastic``) train
data-parallel generator steps with a ``Watchdog(abort=True)`` each and a
checkpoint every 6 steps from rank 0.

  phase 1: once a checkpoint exists and rank 1 has finished step 7, the test
           SIGSTOPs rank 1 (a frozen host: alive at the TCP level, making no
           progress). Rank 0 blocks in its next gloo ``all_reduce``; its
           watchdog thread still gets the interpreter lock (the collective
           waits without it), sees no beat for STALL_S, writes ``STALLED`` and
           exits 42. The process group's timeout (600 s) is far above STALL_S,
           so the watchdog decides first;
  phase 2: the "supervisor" (this test) kills the frozen rank and restarts
           both; they resume from step 6 and finish at step 9.

Batches and noise are keyed by the global step, so the resumed step 7
recomputes the pre-kill step 7 from the same checkpoint state: its loss
matches within 1e-5.

STALL_S: a step of this tiny model takes ~0.1 s on two threads; under the
test suite's six-worker load the worst step measured was 0.73 s (a rank's
first, which waits in its first collective for the slower rank's start-up;
0.16 s after it). STALL_S is twenty times that and still detects the freeze
quickly. Each rank starts its watchdog after its first step, so the ranks'
start-up skew is no stall.
"""

import json
import os
import signal
import time

import numpy as np
import pytest

from tests.test_torch_dp_worker import free_port, log_tail, spawn, wait_all
from vits_tpu_torch.train.checkpoint import latest_step
from vits_tpu_torch.train.watchdog import read_heartbeats

STALL_S = 15.0
CHECKPOINT_EVERY = 6


def _phase(out: str, total: int, delay: float, tag: str):
    port = free_port()
    return [spawn("elastic", r, 2, port, out, total, CHECKPOINT_EVERY, STALL_S, delay, tag,
                  log_tag=tag) for r in range(2)]


def test_freeze_a_rank_detect_and_resume(tmp_path):
    out = str(tmp_path)
    procs = _phase(out, 1000, 0.3, "p1")
    try:
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            if latest_step(out) is not None and read_heartbeats(out).get(1, {}).get("step", 0) >= 7:
                break
            for p in procs:
                assert p.poll() is None, f"a rank died before the freeze:\n{log_tail(p)}"
            time.sleep(0.05)
        else:
            pytest.fail("phase 1 never reached a checkpoint and step 7")
        procs[1].send_signal(signal.SIGSTOP)
        procs[0].wait(timeout=10 * STALL_S)
        assert procs[0].returncode == 42, (
            f"expected the watchdog's exit 42, got {procs[0].returncode}:\n{log_tail(procs[0])}")
        with open(os.path.join(out, "STALLED")) as f:
            assert f.read().startswith("process 0 ")
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGCONT)
                p.kill()
                p.wait(timeout=30)
    with open(os.path.join(out, "losses-0-p1.json")) as f:
        before = json.load(f)
    assert latest_step(out) == CHECKPOINT_EVERY  # lockstep: rank 0 cannot pass step 8 alone

    total = CHECKPOINT_EVERY + 3
    procs = _phase(out, total, 0.0, "p2")
    wait_all(procs)
    finals = []
    for r in range(2):
        with open(os.path.join(out, f"final-{r}-p2.json")) as f:
            finals.append(json.load(f))
    assert [f["resumed_from"] for f in finals] == [CHECKPOINT_EVERY] * 2
    assert [f["final_step"] for f in finals] == [total] * 2
    after = finals[0]["losses"]
    assert sorted(int(s) for s in after) == list(range(CHECKPOINT_EVERY + 1, total + 1))
    assert np.isfinite(list(after.values())).all()
    assert finals[0]["losses"] == finals[1]["losses"]  # every rank has the global loss
    common = str(CHECKPOINT_EVERY + 1)
    assert abs(before[common] - after[common]) < 1e-5, (before[common], after[common])
