"""The port's HTTP serving layer (``vits_tpu_torch.engine.server``) on the CPU.

Mirrors ``tests/test_server.py`` against the port's ``serve``: end-to-end
requests, micro-batching, error paths, admission control, the non-blocking
requeue, ``/stream`` (chunked WAV within one int16 step of the one-shot
decode), ``/convert`` and ``/metrics``. Adds the C client
(``vits_tpu.io.native.NativeEngineClient``, as ``tests/test_native.py``
drives it) against the port's server, and a ~3 s closed-loop mixed load (4
``/synthesize`` and 2 ``/stream`` clients) with no errors and no 429s.
"""

import http.client
import io
import json
import struct
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine.server import BatchingWorker, _Request, serve
from vits_tpu_torch.engine.streaming import StreamingDecoder
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.utils.wav import read_wav, write_wav

torch.set_num_threads(2)

VOCAB = {c: i for i, c in enumerate("kzyuvdheswm' ablc")}
INT16_STEP = 1.5 / 32767


def _engine(tiny_bundle, **kw):
    config, params = tiny_bundle
    tok = VitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z")
    return Synthesizer(config, tok, params, EngineConfig(**kw), device="cpu")


@pytest.fixture(scope="module")
def running_server(tiny_bundle):
    model = _engine(tiny_bundle, token_buckets=(32,))
    server, worker = serve(model, port=0, batch_window_ms=20.0, max_batch=8)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", worker, model
    worker.stop()
    server.shutdown()
    server.server_close()


def _post(url, payload, path="/synthesize"):
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


def _threads(target, n):
    threads = [threading.Thread(target=target, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not any(t.is_alive() for t in threads)


def test_healthz(running_server):
    url, _, _ = running_server
    with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
        assert json.loads(resp.read())["status"] == "ok"


def test_synthesize_returns_wav(running_server):
    url, _, _ = running_server
    with _post(url, {"text": "hello dame"}) as resp:
        assert resp.headers["Content-Type"] == "audio/wav"
        body = resp.read()
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE" and len(body) > 44


def test_concurrent_requests_batched(running_server):
    url, worker, _ = running_server
    batches_before = worker.stats["batches"]
    results = {}

    def hit(i):
        with _post(url, {"text": f"hello dame {i % 3}"}) as resp:
            results[i] = resp.read()

    _threads(hit, 6)
    assert len(results) == 6 and all(r[:4] == b"RIFF" for r in results.values())
    # 6 concurrent requests must share dispatches (fewer batches than requests)
    assert 1 <= worker.stats["batches"] - batches_before < 6


def test_missing_text_400(running_server):
    url, _, _ = running_server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, {"nope": 1})
    assert err.value.code == 400


def test_unknown_route_404(running_server):
    url, _, _ = running_server
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(url + "/bogus", timeout=30)
    assert err.value.code == 404


def test_mixed_seed_requests_share_batch(running_server):
    """Per-request seeds are per-row generators: different seeds must not split
    the micro-batch."""
    url, worker, _ = running_server
    before = worker.stats["batches"]
    results = {}

    def hit(i):
        with _post(url, {"text": "hello dame", "seed": i * 13 + 1}) as resp:
            results[i] = resp.read()

    _threads(hit, 5)
    assert len(results) == 5
    assert len(set(results.values())) > 1  # different seeds -> different audio
    assert worker.stats["batches"] - before <= 2  # not 5 seed-solo batches


def test_speaking_rate_field_shortens_audio(running_server):
    url, _, _ = running_server
    with _post(url, {"text": "hello dame sad welsh", "seed": 0}) as resp:
        normal = resp.read()
    with _post(url, {"text": "hello dame sad welsh", "seed": 0, "speaking_rate": 2.0}) as resp:
        fast = resp.read()
    assert len(fast) < len(normal)


def test_bad_control_type_400(running_server):
    url, _, _ = running_server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, {"text": "hello", "speaking_rate": "not-a-number"})
    assert err.value.code == 400


def test_queue_full_returns_429_and_worker_rejects():
    """Bounded queue: submissions beyond max_queue are rejected (429 path)."""

    class SlowModel:
        def __init__(self):
            self.release = threading.Event()
            self.config = types.SimpleNamespace(sampling_rate=16000)

        def synthesize(self, texts, **kw):
            self.release.wait(20)
            return [np.zeros(16, np.float32) for _ in texts]

    model = SlowModel()
    worker = BatchingWorker(model, batch_window_ms=1.0, max_batch=1, max_queue=2)
    reqs = [_Request(text="a", speaker_id=None, seed=0) for _ in range(4)]
    assert worker.submit(reqs[0])
    time.sleep(0.5)  # the worker picks req0 and blocks inside synthesize
    assert worker.submit(reqs[1])
    assert worker.submit(reqs[2])
    assert not worker.submit(reqs[3])  # queue (capacity 2) is full
    assert worker.stats["rejected"] == 1
    model.release.set()
    for r in reqs[:3]:
        assert r.done.wait(30)
    worker.stop()


def test_requeue_never_blocks_when_queue_full():
    """A control-mismatched requeue must not block: the worker is the queue's
    only consumer, so a blocking put() under overload would wedge the server."""
    model = types.SimpleNamespace(config=types.SimpleNamespace(sampling_rate=16000))
    worker = BatchingWorker(model, batch_window_ms=300.0, max_batch=4, max_queue=2)
    worker.stop()
    worker._thread.join(timeout=5)
    assert not worker._thread.is_alive()

    a = _Request(text="a", speaker_id=None, seed=0)
    b = _Request(text="b", speaker_id=None, seed=0, noise_scale=0.3)
    c = _Request(text="c", speaker_id=None, seed=0, noise_scale=0.5)
    d = _Request(text="d", speaker_id=None, seed=0, noise_scale=0.7)
    worker.queue.put_nowait(a)
    worker.queue.put_nowait(b)
    result = {}
    t = threading.Thread(target=lambda: result.update(batch=worker._collect()))
    t.start()
    time.sleep(0.1)  # _collect has consumed a and b by now, window still open
    for req in (c, d):
        for _ in range(100):
            try:
                worker.queue.put_nowait(req)
                break
            except Exception:
                time.sleep(0.01)
    t.join(timeout=10)
    assert not t.is_alive(), "collect deadlocked on requeue"
    assert [r.text for r in result["batch"]] == ["a"]
    # b, c fit back in the capacity-2 queue; d was dropped with an error
    assert d.done.is_set() and d.error is not None
    assert worker.stats["rejected"] == 1


def test_seed_list_length_validated(tiny_bundle):
    model = _engine(tiny_bundle, token_buckets=(32,))
    with pytest.raises(ValueError, match="seed list length"):
        model.synthesize_raw(["one", "two"], seed=[1], max_redispatch=0)


def test_seeds_differing_above_bit31_differ(tiny_bundle):
    """64-bit per-row seeds must not alias: 5 and 2**33+5 give different audio."""
    model = _engine(tiny_bundle, token_buckets=(32,))
    lo = model.synthesize_raw("hello", seed=[5], max_redispatch=0)
    hi = model.synthesize_raw("hello", seed=[2**33 + 5], max_redispatch=0)
    n = min(len(lo.waveform[0]), len(hi.waveform[0]))
    assert not np.allclose(lo.waveform[0][:n], hi.waveform[0][:n])


# --------------------------------------------------------------------------- #
# /stream (chunked-transfer WAV)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def streaming_server(tiny_bundle):
    # adaptive_capacity=False: the stream keeps the static frame capacity, so
    # the one-shot request it is compared with must not have raised its own.
    model = _engine(tiny_bundle, token_buckets=(64,), frames_per_token=4.0,
                    transfer_int16=False, adaptive_capacity=False)
    streamer = StreamingDecoder(model, chunk_frames=16, margin_frames=16)
    server, worker = serve(model, port=0, streamer=streamer)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"127.0.0.1:{server.server_address[1]}", model, worker
    worker.stop()
    server.shutdown()
    server.server_close()


def _read_stream(hostport, payload, chunk_size=4096):
    """POST /stream and read the chunked body progressively: (body, arrival times)."""
    conn = http.client.HTTPConnection(hostport, timeout=300)
    conn.request("POST", "/stream", body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.headers["Content-Type"] == "audio/wav"
    body, stamps = b"", []
    while True:
        piece = resp.read(chunk_size)
        if not piece:
            break
        stamps.append(time.perf_counter())
        body += piece
    conn.close()
    return body, stamps


def test_stream_endpoint_wav_matches_oneshot(streaming_server):
    hostport, model, worker = streaming_server
    text = "hello sad dame well cheese"
    body, _ = _read_stream(hostport, {"text": text, "seed": 5})
    # streaming WAV header: RIFF/WAVE with 0xFFFFFFFF live-stream sizes
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert body[4:8] == b"\xff\xff\xff\xff"
    _, channels, rate, _, _, bits = struct.unpack("<HHIIHH", body[20:36])
    assert (channels, rate, bits) == (1, model.config.sampling_rate, 16)
    pcm = np.frombuffer(body[44:], dtype="<i2").astype(np.float32) / 32767.0
    oneshot = model.synthesize(text, seed=5)
    assert pcm.shape == oneshot.shape
    np.testing.assert_allclose(pcm, oneshot, atol=INT16_STEP, rtol=0)
    assert worker.stats["streams"] >= 1


def test_stream_endpoint_delivers_before_completion(streaming_server):
    """The first chunk lands strictly before the stream finishes."""
    hostport, _, _ = streaming_server
    body, stamps = _read_stream(
        hostport, {"text": "hello sad dame well cheese as my cheese", "seed": 1},
        chunk_size=1024)
    assert len(stamps) >= 3  # header + several PCM chunks
    assert stamps[0] < stamps[-1] and len(body) > 44


def test_stream_endpoint_validates(streaming_server):
    hostport, _, _ = streaming_server
    conn = http.client.HTTPConnection(hostport, timeout=60)
    conn.request("POST", "/stream", body=b"{}", headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    conn.close()


def test_keepalive_survives_404_with_body(running_server):
    """An early-return response (404) drains the POST body, so the next request
    on the same keep-alive socket parses cleanly."""
    url, _, _ = running_server
    conn = http.client.HTTPConnection(url.split("//")[1], timeout=120)
    body = json.dumps({"text": "hello dame"})
    hdrs = {"Content-Type": "application/json"}
    try:
        conn.request("POST", "/nope", body=body, headers=hdrs)
        r1 = conn.getresponse()
        r1.read()
        assert r1.status == 404
        conn.request("POST", "/synthesize", body=body, headers=hdrs)
        r2 = conn.getresponse()
        assert r2.status == 200 and r2.read()[:4] == b"RIFF"
    finally:
        conn.close()


def test_convert_endpoint_roundtrip(running_server, tiny_bundle):
    """POST /convert: WAV in -> converted WAV out, deterministic by default,
    equal to ``convert_voice`` on the same (int16) audio within one int16 step."""
    url, worker, model = running_server
    config, _ = tiny_bundle
    hop = config.total_upsample
    audio = np.sin(np.linspace(0, 40 * np.pi, 11 * hop)).astype(np.float32) * 0.3
    buf = io.BytesIO()
    write_wav(buf, audio, config.sampling_rate)
    body = buf.getvalue()

    def post(path):
        req = urllib.request.Request(url + path, data=body,
                                     headers={"Content-Type": "audio/wav"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "audio/wav"
            return resp.read()

    out1 = post("/convert?seed=0")
    out2 = post("/convert")
    assert out1[:4] == b"RIFF" and out1 == out2  # noise_scale=0 default
    got, rate = read_wav(out1)
    assert rate == config.sampling_rate and len(got) == 11 * hop
    sent, _ = read_wav(body)
    np.testing.assert_allclose(got, model.convert_voice(sent), atol=INT16_STEP, rtol=0)
    assert worker.stats["conversions"] >= 2


def test_convert_endpoint_rejects_bad_input(running_server, tiny_bundle):
    url, _, _ = running_server
    config, _ = tiny_bundle
    req = urllib.request.Request(url + "/convert", data=b"not a wav",
                                 headers={"Content-Type": "audio/wav"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 400
    buf = io.BytesIO()
    write_wav(buf, np.zeros(1024, np.float32), config.sampling_rate * 2)  # wrong rate
    req = urllib.request.Request(url + "/convert", data=buf.getvalue(),
                                 headers={"Content-Type": "audio/wav"})
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(req, timeout=30)
    assert exc.value.code == 400


def _metrics(url) -> tuple[str, dict]:
    with urllib.request.urlopen(url + "/metrics", timeout=30) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    return text, dict(line.split(" ", 1) for line in text.splitlines()
                      if line and not line.startswith("#") and "{" not in line)


def test_metrics_endpoint(running_server):
    """/metrics: counters consistent with traffic, engine stats as gauges, the
    synthesize-latency histogram cumulative and totaled."""
    url, worker, _ = running_server
    with _post(url, {"text": "hello dame"}) as resp:
        resp.read()
    text, lines = _metrics(url)
    assert float(lines["vits_requests_total"]) == worker.stats["requests"]
    assert float(lines["vits_batches_total"]) == worker.stats["batches"]
    assert float(lines["vits_audio_seconds_total"]) > 0
    assert "vits_queue_depth" in lines
    assert float(lines["vits_engine_dispatches"]) >= 1
    buckets = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("vits_synthesize_latency_seconds_bucket")]
    assert buckets == sorted(buckets)
    count = float(lines["vits_synthesize_latency_seconds_count"])
    assert buckets[-1] == count >= 1
    assert float(lines["vits_synthesize_latency_seconds_sum"]) > 0


def test_native_client_against_port_server(tiny_bundle):
    """The embeddable C ABI client gets the port's audio (within the WAV's int16
    quantization) from the port's server."""
    from vits_tpu.io import native

    if not native.available() or not hasattr(native.load_library(), "vt_engine_connect"):
        pytest.skip("native library with vt_synthesize not built")
    model = _engine(tiny_bundle, token_buckets=(32,))
    server, worker = serve(model, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        with native.NativeEngineClient(port=server.server_address[1]) as client:
            pcm, rate = client.synthesize("hello dame", seed=3)
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
    assert rate == model.config.sampling_rate
    # the server passes per-request seeds as seed lists (per-row generators)
    expected = model.synthesize(["hello dame"], seed=[3])[0]
    assert pcm.shape == expected.shape
    np.testing.assert_allclose(pcm, expected, atol=2.0 / 32767, rtol=0)


def test_mixed_load_without_errors_or_rejects(tiny_bundle):
    """~3 s of closed-loop traffic, 4 /synthesize and 2 /stream clients with
    their own seeds: no client error, no 429, the queue drained, and /metrics
    counting what the clients saw."""
    model = _engine(tiny_bundle, token_buckets=(32, 64))
    server, worker = serve(model, port=0, max_batch=8)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    hostport = f"127.0.0.1:{server.server_address[1]}"
    texts = ["hello dame", "sad welsh cheese", "hello sad dame well cheese"]
    counts = {"synth": 0, "stream": 0}
    errors = []
    lock = threading.Lock()
    stop_at = time.perf_counter() + 3.0

    def client(i):
        path = "/stream" if i >= 4 else "/synthesize"
        n = 0
        while time.perf_counter() < stop_at:
            payload = {"text": texts[(i + n) % len(texts)], "seed": 100 * i + n}
            try:
                conn = http.client.HTTPConnection(hostport, timeout=60)
                conn.request("POST", path, body=json.dumps(payload).encode(),
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                conn.close()
                if resp.status != 200 or body[:4] != b"RIFF" or len(body) <= 44:
                    raise RuntimeError(f"{path}: HTTP {resp.status}, {len(body)} bytes")
            except Exception as exc:
                with lock:
                    errors.append(repr(exc))
                return
            n += 1
            with lock:
                counts["stream" if i >= 4 else "synth"] += 1

    try:
        _threads(client, 6)
        for _ in range(50):  # a handler counts its stream just after the last chunk
            _, m = _metrics(f"http://{hostport}")
            if float(m["vits_streams_total"]) >= counts["stream"]:
                break
            time.sleep(0.02)
    finally:
        worker.stop()
        server.shutdown()
        server.server_close()
    assert not errors, errors
    assert counts["synth"] >= 4 and counts["stream"] >= 2, counts
    assert float(m["vits_rejected_total"]) == 0 and float(m["vits_queue_depth"]) == 0
    assert float(m["vits_requests_total"]) == counts["synth"]
    assert float(m["vits_streams_total"]) == counts["stream"]
