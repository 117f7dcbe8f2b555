"""``vits_tpu_torch/utils/devprofile.py`` on the CPU: the trace reader on a
chrome trace written here, the card-only reader refusing the CPU, and the
lost-record check, by correlation id and against the wrappers' launch
counters (``read`` and ``device_ms`` driven end to end with a stand-in
profiler that writes a trace)."""

import gzip
import json
import re

import pytest
import torch

from vits_tpu_torch.ops.cuda import count_launch
from vits_tpu_torch.ops.cuda.attention import flash_rel_attention
from vits_tpu_torch.ops.cuda.flow import fused_flow
from vits_tpu_torch.utils import devprofile

ATTN = "void (anonymous namespace)::rel_attention_kernel<1, 1, 0, float>(float const*, int)"
CONV = "void conv_kernel<2, 4, 2, false, float, ResEpi>(Gemm, ResEpi)"
FLOW = "void conv_kernel<2, 4, 2, false, float, FlowEpi<0> >(Gemm, FlowEpi<0>)"
ELEMENTWISE = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float> >(int)"


def _event(name, ts, dur, cat="kernel", ph="X", correlation=None):
    event = {"ph": ph, "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}
    if correlation is not None:
        event["args"] = {"correlation": correlation}
    return event


def _launched(name, ts, dur, correlation):
    """A kernel's device record and the host's runtime call that launched it."""
    return [_event("cudaLaunchKernel", ts - 5.0, 2.0, cat="cuda_runtime",
                   correlation=correlation),
            _event(name, ts, dur, correlation=correlation)]


def _trace(path, events, gz=False):
    opener = gzip.open if gz else open
    with opener(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


TRACE = [
    _event("aten::add", 0.0, 500.0, cat="cpu_op"),  # host: not device time
    _event(ATTN, 100.0, 40.0),
    _event(CONV, 120.0, 50.0),  # overlaps the attention kernel by 20 us
    _event(ELEMENTWISE, 300.0, 10.0),
    _event("Memcpy HtoD (Pageable -> Device)", 400.0, 5.0, cat="gpu_memcpy"),
    _event("Memset (Device)", 402.0, 1.0, cat="gpu_memset"),  # inside the memcpy
    _event(CONV, 500.0, 30.0),
    _event("thread_name", 0.0, 0.0, cat="__metadata", ph="M"),
]


@pytest.mark.parametrize("gz", [False, True])
def test_parse_trace_unions_device_intervals(tmp_path, gz):
    path = _trace(tmp_path / ("trace.json.gz" if gz else "trace.json"), TRACE, gz)
    busy, categories, invocations = devprofile.parse_trace(path)
    # 100-170 (attention and conv overlapping), 300-310, 400-405, 500-530
    assert busy == pytest.approx((70 + 10 + 5 + 30) / 1e3)
    assert categories == pytest.approx({
        "rel_attention_kernel": 0.04, "conv_kernel": 0.08,
        "vectorized_elementwise_kernel": 0.01, "Memcpy HtoD": 0.005, "Memset": 0.001})
    assert invocations == [(ATTN, 0.04), (CONV, 0.05), (CONV, 0.03)]


def test_port_kernels_are_the_csrc_globals():
    names = devprofile.port_kernels()
    assert {"rel_attention_kernel", "rel_attention_bwd_kernel", "conv_kernel",
            "block_kernel", "upsample_kernel", "wave_kernel", "wgrad_kernel",
            "mas_wavefront", "wgmma_upsample_kernel", "pair_conv_kernel"} <= names
    assert not {"mas_kernel", "mas_generic"} & names  # the first MAS design is gone
    assert set(devprofile.OWN_KERNELS) <= set(devprofile._wrappers())
    # each own kernel's pattern matches its kernel's records and no other kernel of the port
    records = {name: f"void {name}<2, 4>(Gemm, ResEpi)" for name in names}
    records["FlowEpi"] = FLOW
    own = {"flash_rel_attention": {"rel_attention_kernel"},
           "rel_attention_bwd": {"rel_attention_bwd_kernel"},
           "fused_stage": {"upsample_kernel", "upsample16_kernel", "wgmma_upsample_kernel"},
           "fused_flow": {"FlowEpi"}, "trio_backward": {"wgrad_kernel"},
           "monotonic_align": {"mas_wavefront"}}
    assert {wrapper: {name for name, record in records.items() if re.search(pattern, record)}
            for wrapper, pattern in devprofile.OWN_KERNELS.items()} == own


def test_device_ms_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devprofile.device_ms(lambda: None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        devprofile.read(lambda: None)


def test_lost_records_names_the_short_wrapper():
    """Counters are held only where a launch runs a kernel of the wrapper's own:
    two counts of B with one conv record are not short by the counters (B runs
    up to 18 conv records a count, C and 5 the same convs)."""
    events = [_event(ATTN, 0.0, 40.0), _event(ATTN, 50.0, 40.0), _event(FLOW, 100.0, 100.0),
              _event(CONV, 210.0, 50.0)]
    assert devprofile.lost_records(events, {"flash_rel_attention": 2, "fused_flow": 1,
                                            "fused_resblock_trio": 2, "fused_stage": 0}) == []
    lost = devprofile.lost_records(events, {"flash_rel_attention": 3, "fused_flow": 2})
    assert lost == ["flash_rel_attention counted 3 launches, the trace holds 2 records of its "
                    "kernel", "fused_flow counted 2 launches, the trace holds 1 records of its "
                    "kernel"]
    # kernel 6's FlowEpi conv is not a record of C's upsampler nor of kernel A
    assert devprofile.lost_records(events, {"fused_stage": 1}) == [
        "fused_stage counted 1 launches, the trace holds 0 records of its kernel"]
    assert devprofile.lost_records([], {}) == ["the trace holds no device record"]


def test_lost_records_holds_every_runtime_call_by_correlation():
    """A host launch (of the port's conv, a library kernel, a memcpy) whose device
    record is not in the trace is lost, whoever launched it and whatever the
    counters say."""
    events = (_launched(CONV, 100.0, 50.0, 11) + _launched(ELEMENTWISE, 200.0, 10.0, 12)
              + [_event("cudaMemcpyAsync", 290.0, 3.0, cat="cuda_runtime", correlation=13),
                 _event("Memcpy DtoH (Device -> Pinned)", 300.0, 5.0, cat="gpu_memcpy",
                        correlation=13),
                 _event("cudaStreamSynchronize", 310.0, 3.0, cat="cuda_runtime",
                        correlation=14)])  # puts no work on the card
    assert devprofile.lost_records(events, {"fused_resblock_trio": 1}) == []
    short = [e for e in events if e.get("args", {}).get("correlation") not in (11, 12)
             or e["cat"] == "cuda_runtime"]
    assert devprofile.lost_records(short, {"fused_resblock_trio": 1}) == [
        "2 of 3 runtime calls that put work on the card have no device record "
        "(cudaLaunchKernel)"]


class _FakeProfile:
    """torch.profiler.profile's interface, writing the next of ``traces`` as its trace."""

    traces: list = []

    def __init__(self, activities):
        assert torch.profiler.ProfilerActivity.CUDA in activities

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def export_chrome_trace(self, path):
        _trace(path, self.traces.pop(0))


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(torch.profiler, "profile", _FakeProfile)
    monkeypatch.setattr(devprofile, "PAD_S", 0.0)
    monkeypatch.setattr(flash_rel_attention, "launches", flash_rel_attention.launches)
    monkeypatch.setattr(fused_flow, "launches", fused_flow.launches)
    monkeypatch.setattr(_FakeProfile, "traces", [])


def _three_attention_launches():
    for _ in range(3):
        count_launch(flash_rel_attention)


@pytest.mark.parametrize("records", [2, 3])
def test_device_ms_holds_counters_against_the_trace(fake_card, tmp_path, records):
    """``run`` counts three launches of kernel A; the trace holds ``records`` of
    its kernel: all three read the busy ms, two raise naming the wrapper."""
    _FakeProfile.traces = [[_event(ATTN, 10.0 * i, 5.0) for i in range(records)]]
    if records == 3:
        busy = devprofile.device_ms(_three_attention_launches, trace_dir=str(tmp_path))
        assert busy == pytest.approx(0.015)
        assert (tmp_path / "trace.json").exists()
    else:
        with pytest.raises(RuntimeError, match="flash_rel_attention counted 3"):
            devprofile.device_ms(_three_attention_launches)


def test_read_takes_a_session_again_when_one_lost_records(fake_card):
    """The first session lost a record by correlation, the second none: read
    keeps the second; with every session short, device_ms raises and read
    returns the fullest session with what it lost."""
    full = [rec for i in range(3) for rec in _launched(ATTN, 100.0 * i, 5.0, i)]
    first = full[:1] + full[2:]  # the first launch's device record is lost
    _FakeProfile.traces = [first, full]
    reading = devprofile.read(_three_attention_launches, attempts=3)
    assert (reading.sessions, reading.lost, reading.host_calls, reading.port_held) == (2, [], 3, 3)
    assert reading.busy_ms == pytest.approx(0.015)
    assert reading.wall_ms >= 0.0 and len(reading.events) == 3
    assert reading.categories_ms == pytest.approx({"rel_attention_kernel": 0.015})
    _FakeProfile.traces = [first, first[2:]]
    reading = devprofile.read(_three_attention_launches, attempts=2)
    assert reading.sessions == 2 and len(reading.events) == 2 and reading.lost
    _FakeProfile.traces = [first, first]
    with pytest.raises(devprofile.LostRecords, match="1 of 3 runtime calls .* "
                                                     "flash_rel_attention counted 3"):
        devprofile.device_ms(_three_attention_launches, attempts=2)
    _FakeProfile.traces = [[_event("cudaLaunchKernel", 0.0, 1.0, cat="cuda_runtime")]]
    with pytest.raises(RuntimeError, match="no device activity in 1 sessions"):
        devprofile.read(_three_attention_launches)
