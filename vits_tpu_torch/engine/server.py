"""HTTP synthesis server with micro-batching, for the PyTorch port.

Counterpart of ``vits_tpu/engine/server.py``: everything above :func:`main`
is a copy of the original (it imports only the standard library, numpy and
the wav helpers), held against it by ``tests/test_torch_package.py``;
:func:`main` is the port's own. Requests arriving within ``batch_window_ms``
of each other (up to ``max_batch``) ride a single padded dispatch; each
caller gets back its own trimmed WAV.

Endpoints:
    POST /synthesize   {"text": "...", "speaker_id": 0?, "seed": 0?,
                        "noise_scale": f?, "noise_scale_duration": f?,
                        "speaking_rate": f?} -> audio/wav
    POST /stream       same body -> chunked audio/wav: a streaming WAV header
                       followed by 16-bit PCM chunks as the StreamingDecoder
                       emits them (network TTFA ~= the in-process TTFA, vs
                       full synthesis latency on /synthesize)
    POST /convert      body = a 16-bit mono WAV at the model rate; query
                       params ?target_speaker=N&source_speaker=M&seed=S&
                       noise_scale=F -> audio/wav voice conversion
    GET  /healthz      -> {"status": "ok", ...}
    GET  /metrics      -> Prometheus text exposition: request/batch/reject
                       counters, queue depth, engine dispatch stats, and
                       latency histograms (synthesize end-to-end, stream
                       time-to-first-audio)

Per-request seeds become per-row generators, so mixed-seed traffic shares
one dispatch; the queue is bounded (429 on overflow).

stdlib-only (http.server + threads); start with ``serve(model, port)`` or
``python -m vits_tpu_torch.engine.server --model m.ggml --port 8080``
(``--device cuda`` by default; ``--device cpu`` runs the plain PyTorch path).
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from vits_tpu_torch.utils.wav import pcm16, streaming_wav_header, write_wav


@dataclass
class _Request:
    text: str
    speaker_id: Optional[int]
    seed: int
    noise_scale: Optional[float] = None
    noise_scale_duration: Optional[float] = None
    speaking_rate: Optional[float] = None
    done: threading.Event = field(default_factory=threading.Event)
    audio: Optional[np.ndarray] = None
    error: Optional[str] = None

    def batch_key(self):
        """Requests may share one dispatch iff the batch-wide controls
        match; seeds are per-ROW (one generator a row) so they never split a
        batch."""
        return (self.noise_scale, self.noise_scale_duration, self.speaking_rate)


_LATENCY_BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class _Histogram:
    """Fixed-bucket latency histogram, rendered cumulatively on /metrics.

    stdlib-only stand-in for a Prometheus client histogram: observe() is a
    lock + one list write, render() emits the standard ``_bucket{le=...}`` /
    ``_sum`` / ``_count`` series.
    """

    def __init__(self, buckets=_LATENCY_BUCKETS):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self.lock:
            self.sum += value
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1

    def render(self, name: str) -> list[str]:
        with self.lock:
            counts = list(self.counts)
            total_sum = self.sum
        lines = [f"# TYPE {name} histogram"]
        cum = 0
        for b, c in zip(self.buckets, counts):
            cum += c
            lines.append(f'{name}_bucket{{le="{b}"}} {cum}')
        cum += counts[-1]
        lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
        lines.append(f"{name}_sum {total_sum:.6f}")
        lines.append(f"{name}_count {cum}")
        return lines


class BatchingWorker:
    """Collects requests into padded batches and runs one dispatch per batch."""

    def __init__(
        self,
        model,
        batch_window_ms: float = 5.0,
        max_batch: int = 16,
        max_queue: int = 256,
    ):
        self.model = model
        self.window = batch_window_ms / 1000.0
        self.max_batch = max_batch
        self.queue: "queue.Queue[_Request]" = queue.Queue(maxsize=max_queue)
        self.stats = {"requests": 0, "batches": 0, "rejected": 0,
                      "streams": 0, "conversions": 0, "audio_seconds": 0.0}
        # /metrics latency histograms: /synthesize end-to-end wall time and
        # /stream time-to-first-audio (the metric the endpoint exists for).
        self.synth_latency = _Histogram()
        self.stream_ttfa = _Histogram()
        # Guards stats read-modify-writes: the worker thread AND every
        # /stream handler thread update these counters.
        self.stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, req: _Request) -> bool:
        """Enqueue; False = queue full (caller should return 429)."""
        try:
            self.queue.put_nowait(req)
            return True
        except queue.Full:
            with self.stats_lock:
                self.stats["rejected"] += 1
            return False

    def stop(self) -> None:
        self._stop.set()

    def _collect(self) -> list[_Request]:
        """Collect a batch of requests sharing one set of control knobs.

        Per-request seeds ride as per-row generators inside one dispatch;
        only differing *control* values (batch-wide scalars) force a request
        into the next batch.
        """
        try:
            first = self.queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        requeue: list[_Request] = []
        deadline = time.perf_counter() + self.window
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                req = self.queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req.batch_key() == first.batch_key():
                batch.append(req)
            else:
                requeue.append(req)
        for req in requeue:
            try:
                # Never block here: the worker is the queue's only consumer,
                # so a blocking put() on a full queue would deadlock the whole
                # server (handler threads keep it full under overload).
                self.queue.put_nowait(req)
            except queue.Full:
                with self.stats_lock:
                    self.stats["rejected"] += 1
                req.error = "queue full (control-group requeue)"
                req.done.set()
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                # Group by speaker presence; pass per-row speakers when needed.
                texts = [r.text for r in batch]
                speaker = None
                if any(r.speaker_id is not None for r in batch):
                    speaker = [r.speaker_id or 0 for r in batch]
                first = batch[0]
                waves = self.model.synthesize(
                    texts,
                    seed=[r.seed for r in batch],
                    speaker_id=speaker,
                    noise_scale=first.noise_scale,
                    noise_scale_duration=first.noise_scale_duration,
                    speaking_rate=first.speaking_rate,
                )
                if isinstance(waves, np.ndarray):
                    waves = [waves]
                rate = self.model.config.sampling_rate
                for req, wave in zip(batch, waves):
                    req.audio = wave
                    with self.stats_lock:
                        self.stats["audio_seconds"] += len(wave) / rate
                    req.done.set()
                with self.stats_lock:
                    self.stats["requests"] += len(batch)
                    self.stats["batches"] += 1
            except Exception as exc:  # surface errors to every waiter
                for req in batch:
                    req.error = f"{type(exc).__name__}: {exc}"
                    req.done.set()


def render_metrics(worker: BatchingWorker, model) -> str:
    """Prometheus text exposition (version 0.0.4) of server + engine stats.

    A served engine needs a scrape surface.  Counters come from the batching worker, gauges
    from the live queue and the engine's structured stats
    (Synthesizer.stats), histograms from the per-request observations.
    """
    with worker.stats_lock:
        s = dict(worker.stats)
    lines = []

    def counter(name, value, help_text):
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} counter")
        lines.append(f"{name} {value}")

    counter("vits_requests_total", s["requests"],
            "Synthesis requests completed via the batching worker")
    counter("vits_batches_total", s["batches"],
            "Device dispatches issued by the batching worker")
    counter("vits_rejected_total", s["rejected"],
            "Requests rejected with 429 (queue or stream slots full)")
    counter("vits_streams_total", s["streams"],
            "Completed /stream responses")
    counter("vits_conversions_total", s["conversions"],
            "Completed /convert responses")
    counter("vits_audio_seconds_total", round(s["audio_seconds"], 6),
            "Seconds of audio produced across all endpoints")

    lines.append("# HELP vits_queue_depth Requests waiting in the batch queue")
    lines.append("# TYPE vits_queue_depth gauge")
    lines.append(f"vits_queue_depth {worker.queue.qsize()}")

    for key, value in sorted(getattr(model, "stats", {}).items()):
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            continue
        lines.append(f"# TYPE vits_engine_{key} gauge")
        lines.append(f"vits_engine_{key} {round(float(value), 6)}")

    lines.extend(worker.synth_latency.render("vits_synthesize_latency_seconds"))
    lines.extend(worker.stream_ttfa.render("vits_stream_ttfa_seconds"))
    return "\n".join(lines) + "\n"


def make_handler(worker: BatchingWorker, model, request_timeout_s: float = 120.0,
                 streamer=None, max_streams: int = 4):
    # /stream admission control: each stream occupies a handler thread and
    # dispatches device programs outside the batching worker, so concurrency
    # must be bounded like the queue is (429 when all slots are busy).
    stream_slots = threading.BoundedSemaphore(max(1, max_streams))

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 for Transfer-Encoding: chunked on /stream (every other
        # response carries an explicit Content-Length).
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                engine_stats = {
                    k: v for k, v in getattr(model, "stats", {}).items()
                    if k.startswith("aot_")  # AOT bundle hit/miss (io/aot.py)
                }
                self._json(200, {"status": "ok", **worker.stats, **engine_stats})
            elif self.path == "/metrics":
                body = render_metrics(worker, model).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            # Read the body BEFORE any early return: under HTTP/1.1
            # keep-alive an unread POST body stays in the socket and gets
            # parsed as the NEXT request line, desyncing the connection.
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "bad Content-Length"})
                return
            raw = self.rfile.read(length) if length > 0 else b""
            path_only = self.path.split("?", 1)[0]
            if path_only == "/convert":
                self._do_convert(raw)
                return
            if self.path not in ("/synthesize", "/stream"):
                self._json(404, {"error": "not found"})
                return
            if self.path == "/stream" and streamer is None:
                self._json(503, {"error": "streaming not enabled"})
                return
            try:
                payload = json.loads(raw or b"{}")
                text = payload.get("text")
                if not text or not isinstance(text, str):
                    self._json(400, {"error": "missing 'text'"})
                    return
                def _opt_float(key):
                    val = payload.get(key)
                    return None if val is None else float(val)

                rate_val = _opt_float("speaking_rate")
                if rate_val is not None and rate_val <= 0:
                    # length_scale = 1/speaking_rate (models/vits.py): a
                    # non-positive rate means infinite durations — reject
                    # instead of producing degenerate full-capacity audio.
                    self._json(400, {"error": "speaking_rate must be > 0"})
                    return
                req = _Request(
                    text=text,
                    speaker_id=payload.get("speaker_id"),
                    seed=int(payload.get("seed", 0)),
                    noise_scale=_opt_float("noise_scale"),
                    noise_scale_duration=_opt_float("noise_scale_duration"),
                    speaking_rate=rate_val,
                )
            except (ValueError, TypeError, json.JSONDecodeError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            if self.path == "/stream":
                if not stream_slots.acquire(blocking=False):
                    with worker.stats_lock:
                        worker.stats["rejected"] += 1
                    self._json(429, {"error": "stream slots busy, retry later"})
                    return
                try:
                    self._do_stream(req)
                finally:
                    stream_slots.release()
                return
            t_submit = time.perf_counter()
            if not worker.submit(req):
                self._json(429, {"error": "queue full, retry later"})
                return
            req.done.wait(timeout=request_timeout_s)
            if req.error is not None:
                self._json(500, {"error": req.error})
                return
            if req.audio is None:
                self._json(504, {"error": "synthesis timed out"})
                return
            worker.synth_latency.observe(time.perf_counter() - t_submit)
            buf = io.BytesIO()
            write_wav(buf, req.audio, model.config.sampling_rate)
            data = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _do_convert(self, raw: bytes) -> None:
            """Voice conversion: WAV in -> WAV out, params in the query string.

            Conversion dispatches device programs outside the batching worker
            (like /stream), so it shares the bounded direct-dispatch slots —
            429 when all are busy."""
            from urllib.parse import parse_qs, urlparse

            from vits_tpu_torch.utils.wav import read_wav

            try:
                q = parse_qs(urlparse(self.path).query)

                def _opt_int(key):
                    return int(q[key][0]) if key in q else None

                src = _opt_int("source_speaker")
                tgt = _opt_int("target_speaker")
                seed = _opt_int("seed") or 0
                noise_scale = float(q["noise_scale"][0]) if "noise_scale" in q else 0.0
                audio, rate = read_wav(raw)
            except (ValueError, KeyError) as exc:
                self._json(400, {"error": f"bad request: {exc}"})
                return
            if rate != model.config.sampling_rate:
                self._json(400, {"error": f"audio is {rate} Hz; model expects "
                                          f"{model.config.sampling_rate} Hz"})
                return
            if not stream_slots.acquire(blocking=False):
                with worker.stats_lock:
                    worker.stats["rejected"] += 1
                self._json(429, {"error": "dispatch slots busy, retry later"})
                return
            try:
                converted = model.convert_voice(
                    audio, source_speaker=src, target_speaker=tgt,
                    seed=seed, noise_scale=noise_scale,
                )
            except Exception as exc:
                self._json(500, {"error": f"{type(exc).__name__}: {exc}"})
                return
            finally:
                stream_slots.release()
            with worker.stats_lock:
                worker.stats["conversions"] = worker.stats.get("conversions", 0) + 1
                worker.stats["audio_seconds"] += (
                    len(converted) / model.config.sampling_rate)
            buf = io.BytesIO()
            write_wav(buf, converted, model.config.sampling_rate)
            data = buf.getvalue()
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _do_stream(self, req: _Request) -> None:
            """Chunked-transfer WAV: header first, then PCM as decoded.

            The client hears audio at ~the in-process TTFA instead of the
            full synthesis latency.  Errors after the 200 status line can only be signaled by
            closing the connection mid-stream (chunked encoding has no
            trailer semantics a WAV player would read)."""
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: bytes) -> None:
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            try:
                t_start = time.perf_counter()
                first_chunk_at = None
                chunk(streaming_wav_header(model.config.sampling_rate))
                for pcm in streamer.stream(
                    req.text, seed=req.seed, speaker_id=req.speaker_id,
                    noise_scale=req.noise_scale,
                    noise_scale_duration=req.noise_scale_duration,
                    speaking_rate=req.speaking_rate,
                ):
                    data = pcm16(pcm).tobytes()
                    if data:
                        chunk(data)
                        if first_chunk_at is None:
                            first_chunk_at = time.perf_counter()
                            worker.stream_ttfa.observe(first_chunk_at - t_start)
                        with worker.stats_lock:
                            worker.stats["audio_seconds"] += (
                                len(pcm) / model.config.sampling_rate)
                self.wfile.write(b"0\r\n\r\n")
                with worker.stats_lock:
                    worker.stats["streams"] = worker.stats.get("streams", 0) + 1
            except BrokenPipeError:
                pass  # client went away mid-stream
            except Exception:
                # already committed the 200: drop the connection so the
                # client sees a truncated stream instead of silence
                self.close_connection = True

    return Handler


def serve(model, port: int = 8080, host: str = "127.0.0.1",
          batch_window_ms: float = 5.0, max_batch: int = 16,
          max_queue: int = 256, request_timeout_s: float = 120.0,
          streaming: bool = True, streamer=None, max_streams: int = 4):
    """Blocking serve loop. Returns (server, worker) if you thread it yourself.

    ``streamer``: pass a configured StreamingDecoder to control chunk sizes;
    default builds one with library defaults (``streaming=False`` disables
    the /stream endpoint entirely).  ``max_streams`` bounds concurrent
    /stream connections (429 beyond it), mirroring the batched queue bound.
    """
    worker = BatchingWorker(model, batch_window_ms, max_batch, max_queue)
    if streaming and streamer is None:
        from vits_tpu_torch.engine.streaming import StreamingDecoder

        streamer = StreamingDecoder(model)
    elif not streaming:
        streamer = None
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(worker, model, request_timeout_s, streamer, max_streams),
    )
    return server, worker


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs the "
                         "plain PyTorch path)")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--request-timeout-s", type=float, default=120.0)
    ap.add_argument("--max-streams", type=int, default=4,
                    help="concurrent /stream connections (429 beyond)")
    ap.add_argument("--stream-mux", type=int, default=0, metavar="B",
                    help="multiplex concurrent /stream clients into batched "
                         "window dispatches of up to B rows "
                         "(engine/mux.py; 0 = solo dispatch per stream)")
    ap.add_argument("--dp", type=int, default=0, metavar="N",
                    help="serve data-parallel over N replicas (0 = one device): "
                         "--device cuda takes cards 0..N-1 (exits where fewer "
                         "are visible), --device cpu N CPU replicas; each batch "
                         "dispatch shards its rows over them")
    ap.add_argument("--compilation-cache", default=None, metavar="DIR",
                    help="kernel library cache (EngineConfig.compilation_cache_dir): "
                         "the first start builds the CUDA kernels into DIR, restarts "
                         "load them from there without nvcc")
    ap.add_argument("--warm-overflow", type=int, default=0, metavar="N",
                    help="run N rungs of the overflow-redispatch ladder at "
                         "startup so no request meets a new shape there "
                         "(each rung doubles frame capacity); also snaps "
                         "adaptive-capacity raises to those rungs "
                         "(EngineConfig.adaptive_capacity_align) unless "
                         "--no-capacity-align")
    ap.add_argument("--no-capacity-align", action="store_true",
                    help="with --warm-overflow: let adaptive capacity use "
                         "fine-grained steps (off the warmed rungs)")
    ap.add_argument("--aot-bundle", default=None, metavar="DIR",
                    help="AOT bundle (scripts/torch_export_aot.py): serve with its "
                         "verified kernel library, without nvcc, counting the "
                         "exported signatures' hits (/healthz)")
    ap.add_argument("--fidelity", choices=["fast", "glue32", "high", "exact"],
                    default="fast",
                    help="precision tier (EngineConfig.fidelity_kwargs): fast = "
                         "bf16 kernel multiplies (the default, as in the JAX "
                         "server), glue32 = the same on the card (the port's "
                         "glue is fp32 at every tier), high = bf16x3 kernels, "
                         "exact = fp32 (3xTF32) kernels")
    args = ap.parse_args(argv)

    import torch

    import vits_tpu_torch
    from vits_tpu_torch.config import EngineConfig

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"vits_tpu_torch.engine.server: --device {args.device}, but no "
                         "CUDA device is visible (--device cpu serves on the CPU)")
    place = {"device": args.device}
    if args.dp > 1:
        from vits_tpu_torch.parallel.mesh import make_mesh, replica_devices

        try:
            place = {"mesh": make_mesh(devices=replica_devices(args.device, args.dp))}
        except ValueError as exc:
            raise SystemExit(f"vits_tpu_torch.engine.server: --dp {args.dp}: {exc}") from exc
    # Batch buckets (powers of two up to max_batch): the worker's collected
    # batch size varies with traffic; buckets bound the shapes that warmup
    # covers and that capture flow graphs.  Server requests always ride
    # per-row seeds, so bucketing never changes audio (rows are pad-invariant).
    buckets = []
    b = 1
    while b < args.max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(args.max_batch)
    eng = EngineConfig(compilation_cache_dir=args.compilation_cache,
                       aot_bundle_dir=args.aot_bundle,
                       batch_buckets=tuple(dict.fromkeys(buckets)),
                       adaptive_capacity_align=(
                           args.warm_overflow > 0 and not args.no_capacity_align),
                       **EngineConfig.fidelity_kwargs(args.fidelity))
    model = vits_tpu_torch.load_model(args.model, eng, **place)
    # per_row_seeds: the worker always passes seed LISTS (per-row
    # generators), the layout its requests dispatch with.
    model.warmup(batch_sizes=(1,), token_buckets=model.engine.token_buckets[:2],
                 per_row_seeds=True, overflow_ladder=args.warm_overflow)
    # Warm the streaming shapes too, so the first /stream client does not
    # pay them while holding one of the max_streams slots.
    from vits_tpu_torch.engine.mux import MultiplexedStreamingDecoder
    from vits_tpu_torch.engine.streaming import StreamingDecoder

    if args.stream_mux > 1:
        streamer = MultiplexedStreamingDecoder(model, max_batch=args.stream_mux)
    else:
        streamer = StreamingDecoder(model)
    streamer.warmup(token_buckets=model.engine.token_buckets[:2],
                    overflow_ladder=args.warm_overflow)
    server, worker = serve(
        model, args.port, args.host, args.batch_window_ms, args.max_batch,
        args.max_queue, args.request_timeout_s, max_streams=args.max_streams,
        streamer=streamer,
    )
    print(f"vits_tpu_torch serving on http://{args.host}:{server.server_address[1]} "
          f"({model.device if model.mesh is None else model.mesh})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        # join the threads that ran CUDA work before the interpreter shuts down
        worker.stop()
        worker._thread.join(timeout=30)
        if isinstance(streamer, MultiplexedStreamingDecoder):
            streamer.stop()
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
