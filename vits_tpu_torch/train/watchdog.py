"""Training liveness: heartbeat files + stall detection.

The failure-detection half of SURVEY §5's "failure detection / elastic
recovery" row (the reference has nothing here; recovery itself is the
resumable checkpoint story in train/checkpoint.py — restart the process and
it picks up the latest step).  This module makes failures DETECTABLE:

  * every process writes ``heartbeat-{proc}.json`` (step, timestamp, host)
    into the run directory on each beat — an external supervisor (or another
    host) can spot dead/stalled workers and restart them;
  * an in-process monitor thread fires ``on_stall`` if no beat arrives for
    ``stall_seconds`` — by default it logs loudly and writes a ``STALLED``
    marker; with ``abort=True`` it kills the process so a supervisor
    restarts it cleanly from the last checkpoint (a hung collective
    otherwise blocks forever with no signal).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Callable, Optional


def read_heartbeats(run_dir: str) -> dict[int, dict]:
    """Latest heartbeat per process index, for supervisors/tests."""
    out: dict[int, dict] = {}
    try:
        names = os.listdir(run_dir)
    except FileNotFoundError:
        return out
    for name in names:
        if name.startswith("heartbeat-") and name.endswith(".json"):
            try:
                with open(os.path.join(run_dir, name)) as f:
                    hb = json.load(f)
                out[int(hb["process"])] = hb
            except (OSError, ValueError, KeyError):
                continue
    return out


class Watchdog:
    """Per-process heartbeat writer + stall monitor for the training loop."""

    def __init__(
        self,
        run_dir: str,
        stall_seconds: float = 600.0,
        process_index: int = 0,
        abort: bool = False,
        on_stall: Optional[Callable[[float], None]] = None,
        log=print,
    ):
        self.run_dir = run_dir
        self.stall_seconds = stall_seconds
        self.process_index = process_index
        self.abort = abort
        self.on_stall = on_stall
        self.log = log
        self._last_beat = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        os.makedirs(run_dir, exist_ok=True)
        self._path = os.path.join(run_dir, f"heartbeat-{process_index}.json")
        self._thread = threading.Thread(target=self._monitor, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ #
    def beat(self, step: int) -> None:
        """Record progress; called once per training step."""
        self._last_beat = time.monotonic()
        self._stalled = False
        tmp = self._path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({
                    "process": self.process_index,
                    "step": step,
                    "time": time.time(),
                    "host": socket.gethostname(),
                }, f)
            os.replace(tmp, self._path)  # atomic: readers never see partials
        except OSError as exc:  # liveness must never kill training itself
            self.log(f"watchdog: heartbeat write failed: {exc}")

    @property
    def stalled(self) -> bool:
        return self._stalled

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------ #
    def _monitor(self) -> None:
        poll = min(1.0, self.stall_seconds / 4)
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last_beat
            if idle < self.stall_seconds or self._stalled:
                continue
            self._stalled = True
            self.log(
                f"watchdog: NO training progress for {idle:.0f}s "
                f"(threshold {self.stall_seconds:.0f}s)")
            try:
                with open(os.path.join(self.run_dir, "STALLED"), "w") as f:
                    f.write(f"process {self.process_index} idle {idle:.0f}s\n")
            except OSError:
                pass
            if self.on_stall is not None:
                self.on_stall(idle)
            if self.abort:
                self.log("watchdog: aborting so the supervisor restarts from "
                         "the latest checkpoint")
                os._exit(42)
