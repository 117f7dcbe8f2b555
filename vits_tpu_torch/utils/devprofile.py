"""Device time from a ``torch.profiler`` trace of the card.

Counterpart of ``vits_tpu/utils/devprofile.py``, which reads the XLA
profiler's device lane. Here the profiler's CUDA activity (CUPTI) is the
record of what the card itself ran: every kernel, memcpy and memset with its
start and duration on the device's clock. The union of those intervals is
the "device busy" time of ``PERF.md``: what a call costs the card, whatever
the host's clock says (a short call's wall time is mostly the host's
enqueue). This module is the one reader of that time: ``chip_smoke.py``'s
profiles take it from :func:`read`.

CUPTI now and then loses device records of a profiler session, the first
ones most often (at times all of them). :func:`lost_records` holds a trace
against two accounts of the work the session put on the card:

- every runtime call on the host that puts work on the card (a kernel
  launch, a memcpy, a memset: :data:`DEVICE_WORK_CALLS`) has a device record
  of its correlation id. This holds every record the host side saw, the
  library kernels' (cuDNN, cuBLAS, elementwise) and the port's alike;
- each wrapper of :data:`OWN_KERNELS` counted (``ops/cuda/__init__.py::
  count_launch``) no more launches than the trace holds records of its own
  kernel. Those are the wrappers whose every counted launch runs a kernel
  that no other wrapper runs. The others share B's convolutions (B runs up
  to 18 conv records for one count, C's resblocks and 5's forward run the
  same conv kernels, 7 runs them at 1, 2 and 4 channels), so a count of
  theirs says nothing of how many records to expect; the first account holds
  their records. Kernel 6 (``fused_flow``) counts one launch per call, which
  replays its captured CUDA graph (after capturing it on first use): CUPTI
  records each kernel node of a replay as a kernel of its own, so one replay
  gives at least one record of its ``FlowEpi`` convolutions, and those are
  its own.
"""

from __future__ import annotations

import dataclasses
import functools
import gzip
import json
import re
import tempfile
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# Runtime calls on the host that each put work on the card: each has a device
# record of its correlation id.
DEVICE_WORK_CALLS = ("LaunchKernel", "Memcpy", "Memset")
# Idle card at each end of a session: CUPTI loses a session's first records
# most often when the session opens on a busy card.
PAD_S = 0.005
# The wrappers whose every counted launch records at least one kernel that no
# other wrapper launches, and that kernel's name in a trace.
OWN_KERNELS = {
    "flash_rel_attention": r"\brel_attention_kernel\b",
    "rel_attention_bwd": r"\brel_attention_bwd_kernel\b",
    "fused_stage": r"\bupsample(16)?_kernel\b",
    "fused_flow": r"\bFlowEpi\b",
    "trio_backward": r"\bwgrad_kernel\b",
}


class LostRecords(RuntimeError):
    """The trace holds fewer device records than the session put on the card."""


@dataclasses.dataclass
class Reading:
    """One profiler session of a call (:func:`read`)."""

    wall_ms: float  # host clock, from the call to a synchronise after it
    busy_ms: float  # the union of the device records' intervals
    events: list  # the device records (kernel, memcpy, memset) as the trace has them
    categories_ms: dict  # summed device ms per name stem (:func:`_stem`)
    invocations: list  # (name, ms) of each record of the port's own kernels
    host_calls: int  # runtime calls on the host that put work on the card
    port_held: int  # records of the port's kernels that one of those calls launched
    lost: list  # what the trace is short of (:func:`lost_records`); empty: nothing
    sessions: int = 1  # sessions taken for this reading


def _stem(name: str) -> str:
    """A device event's name without ``void``, template arguments, parameters
    and namespaces (``void at::native::f<4>(...)`` and ``void (anonymous
    namespace)::f<1>(...)`` -> ``f``; ``Memcpy HtoD (Pageable -> Device)`` ->
    ``Memcpy HtoD``)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    name = re.split(r"[<(]", name, maxsplit=1)[0].strip()
    return name.rsplit("::", 1)[-1]


@functools.lru_cache(maxsize=None)
def port_kernels() -> frozenset:
    """The names of the ``__global__`` functions in ``vits_tpu_torch/csrc/``."""
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    pattern = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
    return frozenset(name for src in sorted(csrc.glob("*.cu*"))
                     for name in pattern.findall(src.read_text()))


def _events(path) -> list:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _device(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def _summary(device):
    busy_us, end = 0.0, float("-inf")
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    categories = defaultdict(float)
    invocations = []
    ours = port_kernels()
    for e in device:
        stem = _stem(e["name"])
        categories[stem] += e["dur"] / 1e3
        if e["cat"] == "kernel" and stem in ours:
            invocations.append((e["name"], e["dur"] / 1e3))
    return busy_us / 1e3, dict(categories), invocations


def parse_trace(path):
    """Parse one ``torch.profiler`` chrome trace (``export_chrome_trace``;
    ``.json`` or ``.json.gz``).

    Returns ``(device_ms, categories_ms, kernel_invocations)``: ``device_ms``
    the union of the device-activity intervals (kernels, memcpy, memset: the
    card busy, overlaps counted once), ``categories_ms`` the summed device ms
    per name stem (:func:`_stem`), and ``kernel_invocations`` ``(name, ms)``
    for each record of the port's own kernels (``csrc/``), in trace order.
    """
    return _summary(_device(_events(path)))


def _host_calls(events) -> list:
    return [e for e in events if e.get("cat") == "cuda_runtime"
            and any(word in e.get("name", "") for word in DEVICE_WORK_CALLS)]


def lost_records(events, launched: dict) -> list:
    """What a session's trace (``events``, all of them) is short of, as
    sentences; empty when nothing is lost. ``launched`` is the growth of each
    wrapper's launch counter over the session, by wrapper name. Short: a
    trace with no device record, a runtime call that put work on the card
    with no device record of its correlation id, and a wrapper of
    :data:`OWN_KERNELS` that counted more launches than the trace holds
    records of its kernel."""
    device = _device(events)
    if not device:
        return ["the trace holds no device record"]
    recorded = {e.get("args", {}).get("correlation") for e in device}
    calls = _host_calls(events)
    missing = [e for e in calls if e.get("args", {}).get("correlation") not in recorded]
    lost = []
    if missing:
        lost.append(f"{len(missing)} of {len(calls)} runtime calls that put work on the card "
                    f"have no device record ({', '.join(sorted({e['name'] for e in missing}))})")
    kernels = [e["name"] for e in device if e["cat"] == "kernel"]
    for name, n in launched.items():
        if name in OWN_KERNELS and n:
            found = sum(1 for kernel in kernels if re.search(OWN_KERNELS[name], kernel))
            if n > found:
                lost.append(f"{name} counted {n} launches, the trace holds {found} records "
                            "of its kernel")
    return lost


def _wrappers() -> dict:
    from vits_tpu_torch.ops.cuda import attention, attention_grad, flow, resblock, stage, trio_grad

    return {fn.__name__: fn for fn in (
        attention.flash_rel_attention, attention_grad.rel_attention_bwd,
        resblock.fused_resblock_trio, resblock.fused_resblock, stage.fused_stage,
        flow.fused_flow, trio_grad.trio_forward_with_acts, trio_grad.trio_backward)}


def read(run, *, attempts: int = 1, trace_dir: str | None = None) -> Reading:
    """One call of ``run()`` on the card under ``torch.profiler``.

    ``run()`` runs with CUDA activity on, between :data:`PAD_S` of idle card
    at each end, and the card is synchronised before the session closes. A
    session whose trace lost a record (:func:`lost_records`) is taken again,
    up to ``attempts`` sessions; the first with nothing lost is returned, or
    else the one with the most device records, with its ``lost`` sentences.
    Call ``run()`` once untraced first to leave out the kernel build and
    first-use work. The trace is written to ``trace_dir/trace.json`` (a
    temporary directory when None). Raises without a card (it never reads 0
    on the CPU), and when no session recorded any device activity.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("devprofile reads the card's device time: no CUDA device is "
                           "visible")
    wrappers = _wrappers()
    best = None
    for session in range(1, attempts + 1):
        before = {name: fn.launches for name, fn in wrappers.items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PAD_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
            time.sleep(PAD_S)
        launched = {name: fn.launches - before[name] for name, fn in wrappers.items()}
        with tempfile.TemporaryDirectory(prefix="devtrace_") as tmp:
            path = Path(trace_dir or tmp) / "trace.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            events = _events(path)
        device = _device(events)
        busy, categories, invocations = _summary(device)
        calls = _host_calls(events)
        ids = {e.get("args", {}).get("correlation") for e in calls}
        held = sum(1 for e in device if e["cat"] == "kernel" and _stem(e["name"]) in
                   port_kernels() and e.get("args", {}).get("correlation") in ids)
        reading = Reading(wall_ms, busy, device, categories, invocations, len(calls), held,
                          lost=lost_records(events, launched))
        if best is None or not reading.lost or len(device) > len(best.events):
            best = reading
        if not reading.lost:
            break
    if not best.events:
        raise RuntimeError(f"the profiler saw no device activity in {attempts} sessions")
    best.sessions = session
    return best


def device_ms(run, *, attempts: int = 1, trace_dir: str | None = None) -> float:
    """Device busy ms of one call of ``run()`` on the card (:func:`read`).
    Raises :class:`LostRecords` when every one of the ``attempts`` sessions
    lost a record, naming what was lost."""
    reading = read(run, attempts=attempts, trace_dir=trace_dir)
    if reading.lost:
        raise LostRecords("the profiler lost device records: " + "; ".join(reading.lost))
    return reading.busy_ms
