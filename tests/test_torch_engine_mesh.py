"""The port's mesh engine: ``Synthesizer(mesh=)`` over a data axis of replicas, on the CPU.

Mirrors ``tests/test_engine_mesh.py``. A mesh of ``[cpu] * n`` is n replicas,
as JAX's 8 virtual CPU devices are 8 chips: a padded batch with per-row seeds
must equal the single engine's row by row (rows are independent; each shard
runs the whole per-row program on its replica, on a thread of its own), and
the port's mesh engine must equal JAX's at zero noise within the whole-slice
bound. The tests run with oneDNN off: a shard is another batch shape, and
oneDNN picks its conv algorithm per shape, so it would sum in other orders.
The engines are built with ``adaptive_capacity=False``, so that a stream and a
one-shot request run at one frame capacity (``engine/streaming.py``).
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

import vits_tpu_torch
from vits_tpu.config import EngineConfig as JaxEngineConfig
from vits_tpu.engine.synthesizer import Synthesizer as JaxSynthesizer
from vits_tpu.parallel.mesh import make_mesh as jax_make_mesh
from vits_tpu.text.tokenizer import VitsTokenizer as JaxVitsTokenizer
from vits_tpu_torch.config import EngineConfig
from vits_tpu_torch.engine import server
from vits_tpu_torch.engine.streaming import StreamingDecoder
from vits_tpu_torch.engine.synthesizer import Synthesizer
from vits_tpu_torch.parallel.mesh import Mesh, make_mesh, replica_devices
from vits_tpu_torch.text.tokenizer import VitsTokenizer
from vits_tpu_torch.utils.wav import read_wav

torch.set_num_threads(2)

VOCAB = {c: i for i, c in enumerate("kzyuvdheswm' ablc")}
TEXTS = ["hello sad dame", "ab", "see my dames", "less well", "hello hello"]
SEEDS = [11, 12, 13, 14, 15]
INT16_STEP = 1.5 / 32767  # at most one int16 level apart
ROW_ATOL = 5e-5  # tests/test_engine_mesh.py's bound, fp32 waveforms
EXACT = 2e-6  # tests/test_streaming.py's bound
WAVE_ATOL = 2e-4  # port vs JAX, tests/test_torch_synthesis.py's whole-slice bound
GGML = "tests/fixtures/tiny-vits.ggml"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def plain_convs_fixed_order():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _engine(**kw):
    return EngineConfig(**{**dict(token_buckets=(32,), frames_per_token=4.0,
                                  transfer_int16=False, adaptive_capacity=False), **kw})


def _tokenizer():
    return VitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z")


@pytest.fixture(scope="module")
def single(tiny_bundle):
    config, params = tiny_bundle
    return Synthesizer(config, _tokenizer(), params, _engine(), device="cpu")


@pytest.fixture(scope="module")
def meshes(tiny_bundle):
    """Mesh engines of 2, 4 and 8 CPU replicas, made on first use."""
    config, params = tiny_bundle
    built = {}

    def get(n):
        if n not in built:
            built[n] = Synthesizer(config, _tokenizer(), params, _engine(),
                                   mesh=make_mesh(devices=[CPU] * n))
        return built[n]

    return get


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dp_batch_matches_single_device_per_row(single, meshes, n):
    """The same padded batch with per-row seeds, n replicas against one device:
    equal lengths and frame lengths, waveforms within the fp32 bound."""
    ref = single.synthesize_raw(TEXTS, seed=SEEDS, pad_to_batch=8)
    got = meshes(n).synthesize_raw(TEXTS, seed=SEEDS, pad_to_batch=8)
    assert got.waveform.shape == ref.waveform.shape
    np.testing.assert_array_equal(ref.lengths, got.lengths)
    np.testing.assert_array_equal(ref.frame_lengths, got.frame_lengths)
    np.testing.assert_allclose(ref.waveform, got.waveform, atol=ROW_ATOL, rtol=0)


def test_model_axis_mesh_replicates_over_model(tiny_bundle, meshes):
    """``make_mesh(model=2)`` of four entries serves as the data=2 mesh does: one
    replica per data entry, on the first device of its row (JAX's engine
    replicates over 'model'), the same rows bit for bit."""
    config, params = tiny_bundle
    tp = Synthesizer(config, _tokenizer(), params, _engine(),
                     mesh=make_mesh(model=2, devices=[CPU] * 4))
    assert len(tp.replicas) == 2 and all(r.device == CPU for r in tp.replicas)
    want = meshes(2).synthesize_raw(TEXTS, seed=SEEDS, pad_to_batch=8)
    got = tp.synthesize_raw(TEXTS, seed=SEEDS, pad_to_batch=8)
    np.testing.assert_array_equal(got.frame_lengths, want.frame_lengths)
    np.testing.assert_array_equal(got.waveform, want.waveform)


def test_slice_axis_mesh_replicates_over_slice(tiny_bundle, meshes):
    """``make_mesh(slices=2, data=2)`` of four entries serves as the data=2 mesh
    does (one replica per data entry, slice 0's device; JAX's engine replicates
    over 'slice'), the same rows bit for bit, and as JAX's engine on its
    ``slices=2, data=2`` mesh at zero noise within the whole-slice bound."""
    config, params = tiny_bundle
    sliced = Synthesizer(config, _tokenizer(), params, _engine(),
                         mesh=make_mesh(slices=2, data=2, devices=[CPU] * 4))
    assert sliced.mesh.axis_names == ("slice", "data", "model")
    assert len(sliced.replicas) == 2 and all(r.device == CPU for r in sliced.replicas)
    want = meshes(2).synthesize_raw(TEXTS, seed=SEEDS, pad_to_batch=8)
    got = sliced.synthesize_raw(TEXTS, seed=SEEDS, pad_to_batch=8)
    np.testing.assert_array_equal(got.frame_lengths, want.frame_lengths)
    np.testing.assert_array_equal(got.waveform, want.waveform)
    jax_sliced = JaxSynthesizer(
        config, JaxVitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z"), params,
        JaxEngineConfig(token_buckets=(32,), frames_per_token=4.0, transfer_int16=False),
        mesh=jax_make_mesh(slices=2, data=2, model=1, devices=jax.devices()[:4]))
    zero = dict(noise_scale=0.0, noise_scale_duration=0.0)
    want = jax_sliced.synthesize_raw(TEXTS, seed=SEEDS, **zero)
    got = sliced.synthesize_raw(TEXTS, seed=SEEDS, **zero)
    np.testing.assert_array_equal(got.frame_lengths, want.frame_lengths)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.waveform.shape == np.asarray(want.waveform).shape
    np.testing.assert_allclose(got.waveform, np.asarray(want.waveform, np.float32),
                               atol=WAVE_ATOL, rtol=0)


def test_dp_int16_transfer_matches_single_device(tiny_bundle):
    """With ``transfer_int16`` every shard rounds on its replica: one int16 level."""
    config, params = tiny_bundle
    eng = _engine(transfer_int16=True)
    one = Synthesizer(config, _tokenizer(), params, eng, device="cpu")
    dp = Synthesizer(config, _tokenizer(), params, eng, mesh=make_mesh(devices=[CPU] * 4))
    ref, got = one.synthesize(TEXTS, seed=SEEDS), dp.synthesize(TEXTS, seed=SEEDS)
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_allclose(r, g, atol=INT16_STEP, rtol=0)


def test_mesh_engine_matches_jax_mesh_engine(tiny_bundle, meshes):
    """The port's data=4 mesh against JAX's data=4 mesh (shard_map over 4 virtual
    CPU devices) at zero noise: equal frame lengths, waveforms within the
    whole-slice bound."""
    config, params = tiny_bundle
    jax_mesh = JaxSynthesizer(
        config, JaxVitsTokenizer(vocab=dict(VOCAB), pad_token="k", unk_token="z"), params,
        JaxEngineConfig(token_buckets=(32,), frames_per_token=4.0, transfer_int16=False),
        mesh=jax_make_mesh(data=4, model=1, devices=jax.devices()[:4]))
    zero = dict(noise_scale=0.0, noise_scale_duration=0.0)
    want = jax_mesh.synthesize_raw(TEXTS, seed=SEEDS, **zero)
    got = meshes(4).synthesize_raw(TEXTS, seed=SEEDS, **zero)
    np.testing.assert_array_equal(got.frame_lengths, want.frame_lengths)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.waveform.shape == np.asarray(want.waveform).shape
    np.testing.assert_allclose(got.waveform, np.asarray(want.waveform, np.float32),
                               atol=WAVE_ATOL, rtol=0)


def test_dp_batch_is_actually_sharded(meshes):
    """A batch of 5 pads to 8 rows on a data=8 mesh: one row on each replica."""
    sharded = meshes(8)
    pending = sharded.submit(TEXTS, seed=[1, 2, 3, 4, 5])
    assert pending.ids.shape[0] == 8
    assert len(pending.device_out) == 8
    assert all(shard[0].shape[0] == 1 for shard in pending.device_out)
    assert [shard[0].device for shard in pending.device_out] == [r.device for r in
                                                                  sharded.replicas]
    # each replica its own copy of the weights
    assert len({id(next(iter(r.params.values()))) for r in sharded.replicas}) == 8
    assert sharded.collect(pending).waveform.shape[0] == 8


def test_replica_launches_booked_where_counted(meshes):
    """A launch counted on a replica's thread is booked to that replica (and only
    there): each shard's calls land under its own label, and a call outside the
    replicas adds to ``launches`` alone."""
    from vits_tpu_torch.ops.cuda import count_launch

    def wrapper():
        pass

    wrapper.launches = 0
    sharded = meshes(4)

    def shard(replica, calls):
        for _ in range(calls):
            count_launch(wrapper)
        return threading.current_thread().name

    threads = sharded.replicas.run(shard, [(1,), (2,), (3,), (4,)])
    count_launch(wrapper)
    assert wrapper.launches == 11
    assert wrapper.replica_launches == {f"replica {i} | cpu": i + 1 for i in range(4)}
    assert threads[0] == threading.current_thread().name
    assert all(name.startswith("vits-replica") for name in threads[1:])


def test_dp_scalar_seed_deterministic_rows_independent(meshes):
    """A scalar seed becomes per-row seeds on a mesh: deterministic over calls,
    and identical texts in one batch draw independent noise."""
    sharded = meshes(2)
    a = sharded.synthesize(["hello hello", "hello hello"], seed=4)
    b = sharded.synthesize(["hello hello", "hello hello"], seed=4)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])


def test_dp_mixed_seeds_match_single_device(single, meshes):
    seeds = [3, 9, 3, 123456789012, 7]
    ref = single.synthesize(TEXTS, seed=seeds)
    got = meshes(4).synthesize(TEXTS, seed=seeds)
    for r, g in zip(ref, got):
        assert r.shape == g.shape
        np.testing.assert_allclose(r, g, atol=ROW_ATOL, rtol=0)


def test_dp_large_batch_rounds_to_mesh(meshes):
    sharded = meshes(8)
    texts = [TEXTS[i % len(TEXTS)] for i in range(10)]
    pending = sharded.submit(texts, seed=1)
    assert pending.ids.shape[0] == 16 and len(pending.seed) == 16
    sharded.collect(pending)
    waves = sharded.synthesize(texts, seed=1)
    assert len(waves) == 10  # the pad rows (10 -> 16) are dropped on trim
    for w in waves:
        assert np.isfinite(w).all() and len(w) > 0


def test_mesh_speaker_list_pads_with_batch(single, meshes):
    """A per-text speaker list shorter than the mesh-padded rows tail-fills, as
    the seeds do: the server's worker passes such lists."""
    texts = TEXTS[:3]  # pads 3 -> 8 rows on the data axis
    pending = meshes(8).submit(texts, seed=[1, 2, 3], speaker_id=[0, 0, 0])
    assert pending.speaker.tolist() == [0] * 8
    waves = meshes(8).synthesize(texts, seed=[1, 2, 3], speaker_id=[0, 0, 0])
    ref = single.synthesize(texts, seed=[1, 2, 3], speaker_id=[0, 0, 0])
    assert len(waves) == 3
    for w, r in zip(waves, ref):
        assert w.shape == r.shape
        np.testing.assert_allclose(w, r, atol=ROW_ATOL, rtol=0)


def test_mesh_streamer_pins_replica_zero(single, meshes):
    """Under a mesh the streamer runs on replica 0 (the engine's own device and
    parameters) and equals the single engine's one-shot decode."""
    sharded = meshes(4)
    assert sharded.device == sharded.replicas[0].device
    assert sharded.params is sharded.replicas[0].params
    stream = StreamingDecoder(sharded, chunk_frames=32, margin_frames=16)
    text = TEXTS[0]
    streamed = stream.synthesize_streaming(text, seed=4)
    np.testing.assert_allclose(streamed, single.synthesize(text, seed=4), atol=EXACT, rtol=0)


def test_mesh_convert_voice_matches_single_device(single, meshes):
    """Voice conversion shards over the data axis and stays row-identical to the
    single engine (per-row seeds; deterministic at noise_scale=0)."""
    hop = single.config.total_upsample
    rng = np.random.default_rng(21)
    auds = [rng.standard_normal(n * hop).astype(np.float32) * 0.1 for n in (19, 7, 12)]
    solo, dp = single.convert_voice(auds), meshes(4).convert_voice(auds)
    assert len(solo) == len(dp) == 3
    for a, b in zip(solo, dp):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ROW_ATOL, rtol=0)
    s1 = single.convert_voice(auds[0], seed=5, noise_scale=1.0)
    s2 = meshes(4).convert_voice(auds[0], seed=5, noise_scale=1.0)
    np.testing.assert_allclose(s1, s2, atol=ROW_ATOL, rtol=0)


def test_mesh_warmup_runs_every_shard_shape(meshes):
    """warmup rounds each batch size up to the data axis, with per-row seeds."""
    sharded = meshes(4)
    sharded._dispatch_shapes.clear()
    sharded.warmup(batch_sizes=(1, 6), overflow_ladder=1)
    base = sharded.engine.frame_bucket(32)
    assert sharded._dispatch_shapes == {(rows, 32, base * 2 ** r, (rows,), False)
                                        for rows in (4, 8) for r in range(2)}


def test_device_and_mesh_exclude_each_other(tiny_bundle):
    config, params = tiny_bundle
    with pytest.raises(ValueError, match="not both"):
        Synthesizer(config, _tokenizer(), params, _engine(), device="cpu",
                    mesh=make_mesh(devices=[CPU] * 2))
    with pytest.raises(ValueError, match="not both"):
        vits_tpu_torch.load_model(GGML)
    bad = Mesh(np.array([CPU, CPU], dtype=object).reshape(2, 1), ("x", "y"))
    with pytest.raises(ValueError, match="data"):
        Synthesizer(config, _tokenizer(), params, _engine(), mesh=bad)


def test_make_mesh_shapes_and_refusals():
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.axis_names == ("data", "model") and mesh.shape == {"data": 4, "model": 1}
    assert mesh.devices.shape == (4, 1) and all(d == CPU for d in mesh.devices.flat)
    with pytest.raises(ValueError):
        make_mesh(data=3, devices=["cpu"] * 4)
    tp = make_mesh(model=2, devices=["cpu"] * 4)
    assert tp.axis_names == ("data", "model") and tp.shape == {"data": 2, "model": 2}
    assert tp.devices.shape == (2, 2)
    with pytest.raises(ValueError):
        make_mesh(model=3, devices=["cpu"] * 4)
    assert replica_devices("cpu", 3) == [CPU] * 3
    if torch.cuda.device_count() < 2:
        # more CUDA devices than are visible: raise, never fewer replicas or the CPU
        with pytest.raises(ValueError, match="CUDA device"):
            make_mesh(devices=["cuda:0", "cuda:1"])
        with pytest.raises(ValueError, match="CUDA device"):
            replica_devices("cuda", 2)


def test_server_dp_without_cards_exits_nonzero():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are visible")
    with pytest.raises(SystemExit) as exc:
        server.main(["--model", GGML, "--device", "cuda", "--port", "0", "--dp", "2"])
    assert exc.value.code not in (0, None) and "CUDA device" in str(exc.value.code)


def test_server_main_dp2_serves_on_cpu(tmp_path):
    """``python -m vits_tpu_torch.engine.server --device cpu --dp 2`` warms up,
    prints its mesh, and answers /synthesize as the single engine would."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "vits_tpu_torch.engine.server", "--model", GGML,
         "--device", "cpu", "--port", "0", "--dp", "2", "--max-batch", "2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    watchdog = threading.Timer(300, proc.kill)  # a hung start fails instead of blocking
    watchdog.start()
    try:
        line = proc.stdout.readline()
        assert "serving on http://" in line and "'data': 2" in line, (
            line, proc.stderr.read() if proc.poll() else "")
        url = re.search(r"http://\S+", line).group(0)
        req = urllib.request.Request(url + "/synthesize",
                                     data=json.dumps({"text": "hello", "seed": 3}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            body = resp.read()
    finally:
        watchdog.cancel()
        proc.terminate()
        proc.wait(timeout=30)
    (tmp_path / "dp2.wav").write_bytes(body)
    audio, _ = read_wav(str(tmp_path / "dp2.wav"))
    model = vits_tpu_torch.load_model(GGML, EngineConfig(batch_buckets=(1, 2)), device="cpu")
    want = model.synthesize(["hello"], seed=[3])[0]
    assert audio.shape == want.shape
    np.testing.assert_allclose(audio, want, atol=INT16_STEP, rtol=0)
