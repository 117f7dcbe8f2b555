"""The synthesis engine: token buckets, frame capacity, overflow re-dispatch.

Counterpart of ``vits_tpu/engine/synthesizer.py``, reduced to the main path:
``load``/``__init__``, ``synthesize``, ``synthesize_raw``, ``submit`` /
``collect``, token buckets, batch buckets (``EngineConfig.batch_buckets``,
``pad_to_batch``), the frame capacity of ``EngineConfig.frame_bucket`` with
its adaptive raise and decay, the overflow re-dispatch ladder, trimming,
per-row seeds, per-row speakers of a multi-speaker model (``speaker_id``),
voice conversion (:meth:`Synthesizer.convert_voice`) and
:meth:`Synthesizer.warmup`. ``EngineConfig.use_pallas_flow`` runs
the reverse flow of synthesis as kernel 6, as it runs the fused flow kernel in
the JAX engine (on weights packed once per parameter set and kept here);
without it the plain flow runs. With ``EngineConfig.transfer_int16`` both
``synthesize`` and ``convert_voice`` round the waveform to int16 on the device
and scale it back on the host, as the JAX engine does.

Every dispatch pads a batch into its token bucket (and, with batch buckets,
its rows into the next batch bucket: pad rows are masked and dropped) and
runs at a static frame capacity; ``collect`` reads the predicted frame counts
and, when they exceed the capacity, runs the batch again at double capacity.
``submit`` enqueues the whole dispatch on the device and returns; ``collect``
copies to the host. ``stats["compiled_shapes"]`` counts the distinct
dispatch shapes (rows, token bucket, frames, seed layout, speakers), as the
JAX engine counts its compiled programs; :meth:`Synthesizer.warmup` runs each
shape a server expects once, so that the kernel library is built, cuDNN has
picked its algorithms and kernel 6's graphs are captured before the first
request.

Noise: ``seed=int`` draws the whole batch from one ``torch.Generator``
(HF-style); ``seed=[...]`` gives each row its own
``torch.Generator(device).manual_seed(seed_i)``, so a row's audio does not
depend on the rest of its batch (a seed past 32 bits is mixed down first,
:func:`generator_seed`). With batch buckets a scalar seed on a
dispatch of more than one row becomes per-row generators seeded
:func:`row_seed` ``(seed, r)``, so a row's audio does not depend on its
bucket (the JAX engine folds the row into the key). The port shares no
random stream with the JAX package.

Precision tiers, resolved as the JAX engine resolves them
(``vits_tpu/engine/synthesizer.py:134-165``; :func:`resolve_tiers`): on a
CUDA device the kernels are the JAX engine's Pallas path, so
``EngineConfig()`` runs the ``fast`` tier (bf16 vocoder values; bf16 vocoder
weights, int8 for a quantized checkpoint); ``EngineConfig.fidelity_kwargs``'s
``glue32``, ``high`` and ``exact`` and per-stage ``pallas_precision`` specs
run as in JAX. On the CPU the defaults compute fp32, as the JAX engine does
there; ``use_pallas_vocoder=True`` / ``use_pallas_attention=True`` make the
plain twins apply the tier. The vocoder packs (bf16 or int8 weights of
kernels B and C) are made once per engine. The glue (``matmul_precision``)
stays fp32 at every tier: TF32 is switched off for cuDNN convolutions and
cuBLAS matmuls when an engine is made on a CUDA device (``_fp32_backends``;
PyTorch's switches are process-wide, and TF32 convs can flip
``ceil(exp(log_duration))`` frame counts), so ``glue32`` is ``fast`` on the
card. Int8 checkpoints are dequantized once at load outside the packs (the
values the JAX ``ParamView`` reads).

``EngineConfig.compute_dtype="bfloat16"`` serves at bf16 as the JAX engine
does: every fp32 parameter is cast to bf16 at load (int8 weights stay int8
and their scales become bf16, so they dequantize to bf16), the masks and the
conversion spectrogram go in as bf16, and the host upcasts the bf16 waveform
and log durations. No vocoder packs are made; the kernels run in their bf16
serving mode (``ops/tiers.py::Tiers.bf16_compute``): B, C and 7 compute XLA's
bf16 graph of the plain stages, A and 6 take and give bf16 at the engine's
tier.

A mesh engine (``Synthesizer(mesh=make_mesh(...))``, ``parallel/mesh.py``)
serves over the mesh's data axis, as the JAX engine's ``shard_map`` does
(``vits_tpu/engine/synthesizer.py:267-297``): one :class:`Replica` per entry
of the data axis, each with its own parameters, vocoder packs, kernel 6 pack
and generators on its device, placed from the same numpy parameters. On a
mesh with ``model > 1`` JAX's engine shards rows over 'data' and replicates
over 'model' (``vits_tpu/engine/synthesizer.py:105-121``); here a data entry's
replica lies on the first device of its row, and the other model entries do
not repeat its rows. A dispatch
pads its rows to a multiple of the data axis, splits them into that many
contiguous shards (``PartitionSpec("data")``'s order) and runs each shard's
whole per-row program on its replica, on a host thread of its own
(:class:`ReplicaSet`); no shard waits on another. A scalar seed always
becomes per-row generators on a mesh. Replica 0 is the engine's own
``device`` and ``params``: the streamer and the mux run there, as JAX pins
its streamer to the mesh's first device.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import time
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vits_tpu_torch.config import EngineConfig, VitsConfig
from vits_tpu_torch.io import VitsTokenizer, load_ggml, load_hf_pretrained
from vits_tpu_torch.io.params import ParamView, dequantize_tensors, from_jax_params
from vits_tpu_torch.models.hifigan import hifigan, precompute_vocoder_packs
from vits_tpu_torch.models.vits import PriorOutput, latents_from_prior, text_to_prior
from vits_tpu_torch.models.vits import synthesize as synthesize_fn
from vits_tpu_torch.models.vits import voice_convert
from vits_tpu_torch.ops.cuda import booked_to
from vits_tpu_torch.ops.cuda.flow import FlowPack, pack_flow_weights
from vits_tpu_torch.ops.tiers import Tiers
from vits_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

# EngineConfig fields the port does not honour yet: each must keep its default
# (the kernels cannot be turned off on the card).
_UNSUPPORTED_FIELDS = ("compilation_cache_dir", "aot_bundle_dir")
_NO_KERNEL_OFF = ("use_pallas_vocoder", "use_pallas_attention")


def _check_engine_config(engine: EngineConfig) -> None:
    default = EngineConfig()
    changed = [f for f in _UNSUPPORTED_FIELDS if getattr(engine, f) != getattr(default, f)]
    changed += [f for f in _NO_KERNEL_OFF if getattr(engine, f) is False]
    if changed:
        raise NotImplementedError(
            f"EngineConfig fields not ported to vits_tpu_torch yet: {', '.join(changed)} "
            "(ROADMAP.md)")


def resolve_tiers(engine: EngineConfig, device: torch.device,
                  quantized: bool) -> tuple[Tiers, str | None]:
    """The kernels' tiers and the vocoder packs' weight format (None: no
    vocoder kernels' tier), as the JAX engine resolves ``use_pallas_*``,
    ``pallas_precision``, ``pallas_value_dtype`` and ``pallas_weight_format``:
    the kernels are on on a CUDA device (auto) or when asked for; the value
    dtype is bf16 unless the tier is "high" or "highest"; the weight format
    int8 for a quantized checkpoint, else the value dtype. On the CPU the flow
    (``use_pallas_flow``) takes the tier only beside an explicit
    ``use_pallas_vocoder`` or ``use_pallas_attention``: the JAX engine's CPU
    flow kernel computes fp32 operands in full fp32. At ``compute_dtype=
    "bfloat16"`` the kernels' bf16 serving mode (:meth:`Tiers.bf16_compute`)
    and no packs, as the JAX engine makes none at bf16."""
    on_card = device.type == "cuda"
    vocoder = on_card if engine.use_pallas_vocoder is None else engine.use_pallas_vocoder
    attention = on_card if engine.use_pallas_attention is None else engine.use_pallas_attention
    flow = engine.use_pallas_flow and (on_card or bool(engine.use_pallas_vocoder)
                                       or bool(engine.use_pallas_attention))
    if engine.compute_dtype == "bfloat16":
        return Tiers.bf16_compute(engine.pallas_precision, attention=attention, flow=flow), None
    if engine.compute_dtype != "float32":
        raise ValueError(f"compute_dtype {engine.compute_dtype!r}: float32 or bfloat16")
    value_dtype = weight_format = None
    if vocoder:
        value_dtype = engine.pallas_value_dtype or (
            "float32" if engine.pallas_precision in ("high", "highest") else "bfloat16")
        weight_format = engine.pallas_weight_format or ("int8" if quantized else value_dtype)
    tiers = Tiers.of(engine.pallas_precision, value_dtype, vocoder=vocoder,
                     attention=attention, flow=flow)
    return tiers, weight_format


def _fp32_backends(device: torch.device) -> None:
    """Full fp32 for the plain convs and matmuls on a CUDA device (no TF32)."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


class EngineOutput(NamedTuple):
    """Host-side synthesis result (numpy)."""

    waveform: np.ndarray  # (B, capacity_samples) float32
    lengths: np.ndarray  # (B,) valid samples (clamped to capacity)
    frame_lengths: np.ndarray  # (B,) predicted frames, unclamped
    log_duration: np.ndarray  # (B, T_in, 1)


class PendingSynthesis(NamedTuple):
    """A dispatch enqueued on the device; :meth:`Synthesizer.collect` fetches it."""

    device_out: tuple  # per shard: (wave, lengths, frame_lengths, log_duration) on its replica
    ids: np.ndarray
    mask: np.ndarray
    num_frames: int
    seed: int | tuple[int, ...]
    speaker: np.ndarray | None
    controls: tuple


def row_seed(seed: int, row: int) -> int:
    """Seed of row ``row``'s generator when one seed serves several rows: a
    64-bit word of numpy's ``SeedSequence([seed, row])``, distinct per row."""
    return int(np.random.SeedSequence([seed, row]).generate_state(1, np.uint64)[0])


def generator_seed(seed: int) -> int:
    """The seed a ``torch.Generator`` gets for ``seed``: itself in [0, 2**32),
    else a 32-bit word of numpy's ``SeedSequence(seed mod 2**64)``. The CPU
    generator keeps only the low 32 bits of its seed, so without the mix seeds
    differing only above bit 31 (5 and 2**33 + 5) would draw the same noise."""
    if 0 <= seed < 2**32:
        return seed
    return int(np.random.SeedSequence(seed % 2**64).generate_state(1, np.uint32)[0])


def _next_bucket(buckets: Sequence[int], value: int) -> int:
    for b in buckets:
        if value <= b:
            return b
    biggest = buckets[-1]
    return ((value + biggest - 1) // biggest) * biggest


def _speaker_rows(value, rows: int, given: int, name: str) -> np.ndarray | None:
    """One speaker id for every row, from one id or one per input; rows past
    the inputs (padding) ride speaker 0."""
    if value is None:
        return None
    arr = np.asarray(value, np.int64)
    out = np.zeros((rows,), np.int64)
    if arr.ndim == 0:
        out[:] = arr
    elif arr.shape == (given,):
        out[:given] = arr
    else:
        raise ValueError(f"{name} list length {arr.shape} != number of inputs ({given})")
    return out


class Replica:
    """One copy of the engine's weights on one device (a mesh entry): the
    parameters, the bf16 / int8 weights of kernels B and C and kernel 6's
    packed weights with its workspaces and graphs, each pack made on first
    use."""

    def __init__(self, device: torch.device, params: dict, config: VitsConfig,
                 weight_format: str | None, flow_kernel: bool):
        self.device = device
        self.params = params
        self._config, self._weight_format = config, weight_format
        self._flow_kernel = flow_kernel and device.type == "cuda"
        self._packed_vocoder: dict | None = None
        self._packed_flow: FlowPack | None = None

    def placed(self, device: torch.device) -> "Replica":
        """A replica of the same weights on ``device``, with packs of its own."""
        return Replica(device, {name: value.to(device, copy=True)
                                for name, value in self.params.items()},
                       self._config, self._weight_format, self._flow_kernel)

    def vocoder_packs(self) -> dict:
        """The bf16 or int8 weights of kernels B and C, made on first use."""
        if self._packed_vocoder is None:
            self._packed_vocoder = (
                precompute_vocoder_packs(ParamView(self.params), self._config,
                                         self._weight_format)
                if self._weight_format else {})
        return self._packed_vocoder

    def flow_pack(self) -> FlowPack | None:
        """Kernel 6's packed weights, made on the first dispatch that runs it."""
        if not self._flow_kernel:
            return None
        if self._packed_flow is None:
            self._packed_flow = pack_flow_weights(ParamView(self.params), self._config)
        return self._packed_flow

    def generators(self, seed: int | tuple[int, ...]):
        """One generator for the whole batch (an int), or one per row (a tuple)."""
        if isinstance(seed, tuple):
            return [self.generators(s) for s in seed]
        return torch.Generator(self.device).manual_seed(generator_seed(seed))


def _on_replica(fn, replica: Replica, index: int, job: tuple):
    # inference mode, the current CUDA device and the launch book are per host thread
    device = (torch.cuda.device(replica.device) if replica.device.type == "cuda"
              else contextlib.nullcontext())
    with torch.inference_mode(), device, booked_to(f"replica {index} | {replica.device}"):
        return fn(replica, *job)


class ReplicaSet:
    """The replicas of a mesh's data axis, and a host thread for each but the
    first: :meth:`run` runs one job on every replica at once."""

    def __init__(self, replicas: Sequence[Replica]):
        self.replicas = tuple(replicas)
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            len(self.replicas) - 1, thread_name_prefix="vits-replica")
            if len(self.replicas) > 1 else None)

    def __len__(self) -> int:
        return len(self.replicas)

    def __getitem__(self, i: int) -> Replica:
        return self.replicas[i]

    def __iter__(self):
        return iter(self.replicas)

    def call(self, index: int, fn, *job):
        """``fn(replica, *job)`` on replica ``index``, on the calling thread, under
        inference mode with the replica's device current and its kernel launches
        booked to it (``ops/cuda::booked_to``)."""
        return _on_replica(fn, self.replicas[index], index, job)

    def run(self, fn, jobs: Sequence[tuple]) -> list:
        """:meth:`call` of ``fn`` for each replica and its job, the first on the
        calling thread and each other on its own thread; the results in replica
        order. Each replica enqueues its whole job without waiting for another."""
        if len(jobs) != len(self.replicas):
            raise ValueError(f"{len(jobs)} jobs for {len(self.replicas)} replicas")
        futures = [self._pool.submit(self.call, i, fn, *job)
                   for i, job in enumerate(jobs[1:], start=1)]
        try:
            first = self.call(0, fn, *jobs[0])
        finally:
            concurrent.futures.wait(futures)
        return [first, *(f.result() for f in futures)]


class Synthesizer:
    def __init__(
        self,
        config: VitsConfig,
        tokenizer: VitsTokenizer,
        params: dict,
        engine_config: Optional[EngineConfig] = None,
        *,
        device: torch.device | str | None = None,
        mesh: Mesh | None = None,
    ):
        """``params``: canonical-layout numpy parameters (``vits_tpu_torch.io``),
        fp32 or int8-quantized (``io/quantize.py``). ``device`` or ``mesh``
        (one replica per entry of its 'data' axis), not both."""
        self.config = config
        self.tokenizer = tokenizer
        self.engine = engine_config or EngineConfig()
        _check_engine_config(self.engine)
        if (device is None) == (mesh is None):
            raise ValueError("pass either device= or mesh=, not both")
        self.mesh = mesh
        if mesh is not None:
            if DATA_AXIS not in mesh.axis_names:
                raise ValueError(f"mesh needs a '{DATA_AXIS}' axis: {mesh}")
            # one replica per data entry, on its first device: the engine replicates
            # over the other axes ('model'), as JAX's does, without repeating its rows
            rows = np.moveaxis(mesh.devices, mesh.axis_names.index(DATA_AXIS), 0)
            devices = [torch.device(d) for d in rows.reshape(rows.shape[0], -1)[:, 0]]
        else:
            devices = [torch.device(device)]
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"mesh of CUDA and CPU devices: {mesh}")
        self.device = devices[0]
        _fp32_backends(self.device)
        quantized = any(k.startswith("decoder.") and k.endswith(".scale") for k in params)
        self.tiers, self._weight_format = resolve_tiers(self.engine, self.device, quantized)
        self.compute_dtype = self.tiers.compute_dtype

        def place(device: torch.device) -> dict:
            # fp32 tensors (int8 scales too) to the compute dtype, then int8 weights
            # dequantized into their scales' dtype, as the JAX ParamView reads them
            return dequantize_tensors({
                name: value.to(self.compute_dtype) if value.dtype == torch.float32 else value
                for name, value in from_jax_params(params, device).items()})

        self.replicas = ReplicaSet(
            Replica(d, place(d), config, self._weight_format, self.engine.use_pallas_flow)
            for d in devices)
        # Working frames/token ratio, raised on overflow and decayed back
        # (EngineConfig.adaptive_capacity*), as in the JAX engine.
        self._frames_per_token = float(self.engine.frames_per_token)
        self._rate_window: deque = deque(maxlen=max(1, self.engine.adaptive_capacity_window))
        # Distinct dispatch shapes (rows, token bucket, frames, seed layout,
        # speakers): the JAX engine's compiled programs.
        self._dispatch_shapes: set = set()
        self.stats = {
            "dispatches": 0,
            "redispatches": 0,
            "compiled_shapes": 0,
            "audio_seconds": 0.0,
            "wall_seconds": 0.0,
        }

    @property
    def params(self) -> dict:
        """Replica 0's parameters (the engine's ``device``)."""
        return self.replicas[0].params

    def _vocoder_packs(self) -> dict:
        """Replica 0's bf16 or int8 weights of kernels B and C."""
        return self.replicas[0].vocoder_packs()

    def _flow_pack(self) -> FlowPack | None:
        """Replica 0's kernel 6 pack (None where the flow kernel does not run)."""
        return self.replicas[0].flow_pack()

    def _keeping_flow_graphs(self) -> contextlib.ExitStack:
        """``FlowPack.keeping()`` of every replica's kernel 6 pack (warmups)."""
        stack = contextlib.ExitStack()
        for replica in self.replicas:
            pack = replica.flow_pack()
            if pack is not None:
                stack.enter_context(pack.keeping())
        return stack

    def _synchronize(self) -> None:
        for device in {r.device for r in self.replicas if r.device.type == "cuda"}:
            torch.cuda.synchronize(device)

    @classmethod
    def load(cls, source, engine_config: Optional[EngineConfig] = None, *,
             device: torch.device | str | None = None,
             mesh: Mesh | None = None) -> "Synthesizer":
        """Load from a .ggml path/bytes or an HF directory."""
        if isinstance(source, (bytes, bytearray)):
            config, tokenizer, params = load_ggml(bytes(source))
        elif isinstance(source, str) and source.endswith(".ggml"):
            config, tokenizer, params = load_ggml(source)
        else:
            config, tokenizer, params = load_hf_pretrained(source)
        return cls(config, tokenizer, params, engine_config, device=device, mesh=mesh)

    # ------------------------------------------------------------------ #
    def _controls(self, noise_scale, noise_scale_duration, speaking_rate) -> tuple:
        cfg = self.config
        return (
            float(cfg.noise_scale if noise_scale is None else noise_scale),
            float(cfg.noise_scale_duration if noise_scale_duration is None
                  else noise_scale_duration),
            float(cfg.speaking_rate if speaking_rate is None else speaking_rate),
        )

    def _generators(self, seed: int | tuple[int, ...]):
        """Replica 0's generators for ``seed`` (the streamer's)."""
        return self.replicas[0].generators(seed)

    def _check_speakers(self, speaker: np.ndarray | None) -> None:
        if speaker is not None and (speaker.min() < 0
                                    or speaker.max() >= self.config.num_speakers):
            raise ValueError(f"speaker ids {speaker.tolist()} outside "
                             f"[0, {self.config.num_speakers})")

    def _speaker_tensor(self, speaker: np.ndarray | None,
                        device: torch.device | None = None) -> torch.Tensor | None:
        if speaker is None:
            return None
        self._check_speakers(speaker)
        return torch.as_tensor(speaker, dtype=torch.long).to(device or self.device)

    def _shards(self, rows: int) -> list[slice]:
        """The rows of each replica: ``rows / data`` contiguous rows apiece."""
        n = len(self.replicas)
        if rows % n:
            raise ValueError(f"{rows} rows do not tile the mesh's data axis ({n})")
        per = rows // n
        return [slice(i * per, (i + 1) * per) for i in range(n)]

    def _dispatch(self, ids: np.ndarray, mask: np.ndarray, num_frames: int, seed,
                  speaker: np.ndarray | None, controls: tuple) -> tuple:
        t0 = time.perf_counter()
        if len(self.replicas) > 1 and not isinstance(seed, tuple):
            raise ValueError("a mesh dispatch needs per-row seeds")
        self._check_speakers(speaker)  # on this thread, before any shard runs
        jobs = [(ids[s], mask[s], seed[s] if isinstance(seed, tuple) else seed,
                 None if speaker is None else speaker[s]) for s in self._shards(ids.shape[0])]
        device_out = tuple(self.replicas.run(
            functools.partial(self._run_shard, num_frames=num_frames, controls=controls), jobs))
        self._dispatch_shapes.add(
            (ids.shape[0], ids.shape[1], num_frames, np.shape(seed), speaker is not None))
        self.stats["compiled_shapes"] = len(self._dispatch_shapes)
        self.stats["dispatches"] += 1
        self.stats["wall_seconds"] += time.perf_counter() - t0
        return device_out

    def _run_shard(self, replica: Replica, ids: np.ndarray, mask: np.ndarray, seed,
                   speaker: np.ndarray | None, *, num_frames: int, controls: tuple) -> tuple:
        """One shard's whole per-row program on its replica."""
        noise_scale, noise_scale_duration, speaking_rate = controls
        out = synthesize_fn(
            replica.params, self.config,
            torch.as_tensor(ids, dtype=torch.long).to(replica.device),
            torch.as_tensor(mask, dtype=self.compute_dtype).to(replica.device),
            num_frames,
            generator=replica.generators(seed),
            speaker_id=self._speaker_tensor(speaker, replica.device),
            noise_scale=noise_scale,
            noise_scale_duration=noise_scale_duration,
            speaking_rate=speaking_rate,
            use_pallas_flow=self.engine.use_pallas_flow,
            flow_pack=replica.flow_pack(),
            tiers=self.tiers,
            vocoder_packs=replica.vocoder_packs(),
        )
        return (self._transfer(out.waveform), out.lengths, out.frame_lengths, out.log_duration)

    def _prior_on(self, replica: Replica, ids: np.ndarray, mask: np.ndarray,
                  num_frames: int, seed, speaker: np.ndarray | None,
                  controls: tuple) -> PriorOutput:
        """The prior of padded token rows on ``replica`` (the streamer's and the
        time-sharded decode's first half)."""
        noise_scale, noise_scale_duration, speaking_rate = controls
        return text_to_prior(
            replica.params, self.config,
            torch.as_tensor(ids, dtype=torch.long).to(replica.device),
            torch.as_tensor(mask, dtype=self.compute_dtype).to(replica.device),
            num_frames,
            generator=replica.generators(seed),
            speaker_id=self._speaker_tensor(speaker, replica.device),
            noise_scale=noise_scale,
            noise_scale_duration=noise_scale_duration,
            speaking_rate=speaking_rate,
            attention_tier=self.tiers.attention,
        )

    def _decode_on(self, replica: Replica, latents: torch.Tensor, mask3: torch.Tensor,
                   speaker_embeddings: torch.Tensor | None) -> torch.Tensor:
        """Flow + vocoder over (B, W) prior frames on ``replica`` -> (B, W *
        total_upsample) waveform (the second half)."""
        flow_latents = latents_from_prior(
            replica.params, self.config, latents, mask3, speaker_embeddings,
            use_pallas=self.engine.use_pallas_flow, flow_pack=replica.flow_pack(),
            tier=self.tiers.flow)
        return hifigan(ParamView(replica.params), self.config, flow_latents, mask3,
                       speaker_embeddings, tiers=self.tiers, packs=replica.vocoder_packs())

    def _transfer(self, wave: torch.Tensor) -> torch.Tensor:
        """The waveform as it crosses to the host: with ``transfer_int16`` int16
        PCM (from the fp32 upcast of a bf16 waveform, as in JAX), else as it is."""
        if self.engine.transfer_int16:
            return torch.round(torch.clamp(wave.float(), -1.0, 1.0) * 32767.0).to(torch.int16)
        return wave

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A device tensor on the host: bf16 upcast to fp32 there (numpy has no bf16)."""
        t = t.cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    @classmethod
    def _fetch(cls, device_out: tuple) -> EngineOutput:
        """The shards' outputs on the host, in row order."""
        host = [np.concatenate([cls._host(shard[i]) for shard in device_out])
                for i in range(4)]
        wave = host[0]
        if wave.dtype == np.int16:
            wave = wave.astype(np.float32) / 32767.0
        return EngineOutput(wave, *host[1:])

    # ------------------------------------------------------------------ #
    def synthesize(
        self,
        texts: str | Sequence[str],
        *,
        seed: int | Sequence[int] = 0,
        speaker_id: Optional[int | Sequence[int]] = None,
        trim: bool = True,
        max_redispatch: int = 3,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
    ):
        """Text(s) -> float32 PCM at ``config.sampling_rate``.

        A single string returns one 1-D array; a list returns a list, each
        trimmed to its predicted length unless ``trim=False``. ``speaker_id``
        (a multi-speaker model) is one id for all texts or one per text.
        """
        single = isinstance(texts, str)
        out = self.synthesize_raw(
            texts, seed=seed, speaker_id=speaker_id, max_redispatch=max_redispatch,
            noise_scale=noise_scale,
            noise_scale_duration=noise_scale_duration, speaking_rate=speaking_rate,
        )
        n_texts = 1 if single else len(texts)
        results = [out.waveform[i, : out.lengths[i]] if trim else out.waveform[i]
                   for i in range(n_texts)]
        return results[0] if single else results

    def submit(
        self,
        texts: str | Sequence[str],
        *,
        seed: int | Sequence[int] = 0,
        speaker_id: Optional[int | Sequence[int]] = None,
        pad_to_batch: Optional[int] = None,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
    ) -> PendingSynthesis:
        """Enqueue one dispatch on the device; pair with :meth:`collect`.

        ``pad_to_batch`` (else, with ``EngineConfig.batch_buckets``, the next
        batch bucket) pads the dispatch to that many rows: the pad rows are
        empty (masked) and :meth:`synthesize` drops them.
        """
        if isinstance(texts, str):
            texts = [texts]
        encoded = [self.tokenizer.encode(t) for t in texts]
        max_len = max((len(e) for e in encoded), default=1) or 1
        t_bucket = _next_bucket(self.engine.token_buckets, max_len)
        ids, mask = self.tokenizer.pad(encoded, pad_to=t_bucket)
        if pad_to_batch is None and self.engine.batch_buckets:
            pad_to_batch = _next_bucket(self.engine.batch_buckets, ids.shape[0])
        if pad_to_batch is not None and ids.shape[0] < pad_to_batch:
            pad_rows = pad_to_batch - ids.shape[0]
            ids = np.pad(ids, ((0, pad_rows), (0, 0)))
            mask = np.pad(mask, ((0, pad_rows), (0, 0)))
        if self.mesh is not None:  # the rows tile the data axis; pad rows are masked
            short = -ids.shape[0] % len(self.replicas)
            ids = np.pad(ids, ((0, short), (0, 0)))
            mask = np.pad(mask, ((0, short), (0, 0)))
        rows = ids.shape[0]
        if isinstance(seed, (int, np.integer)):
            seed_spec = int(seed)
            if self.mesh is not None or (self.engine.batch_buckets and rows > 1):
                # independent of the bucket and of the shards: per-row generators
                # (the JAX engine's fold_in)
                seed_spec = tuple(row_seed(seed_spec, r) for r in range(rows))
        else:
            seed_spec = tuple(int(s) for s in seed)
            if len(seed_spec) != len(texts):
                raise ValueError(
                    f"seed list length {len(seed_spec)} != number of texts ({len(texts)})")
            seed_spec += (0,) * (rows - len(texts))  # pad rows ride seed 0
        speaker = _speaker_rows(speaker_id, ids.shape[0], len(texts), "speaker_id")
        controls = self._controls(noise_scale, noise_scale_duration, speaking_rate)
        num_frames = self._frame_capacity(t_bucket)
        device_out = self._dispatch(ids, mask, num_frames, seed_spec, speaker, controls)
        return PendingSynthesis(device_out, ids, mask, num_frames, seed_spec, speaker, controls)

    def collect(self, pending: PendingSynthesis, max_redispatch: int = 3) -> EngineOutput:
        """Fetch a dispatch to the host, re-dispatching at double capacity on overflow."""
        out = self._fetch(pending.device_out)
        predicted = int(out.frame_lengths.max())
        num_frames = pending.num_frames
        rate = self._observed_rate(pending, out.frame_lengths)
        if predicted <= num_frames:
            self._maybe_decay()
        else:
            self._observe_overflow(rate)
            for attempt in range(max_redispatch):
                while num_frames < predicted:
                    num_frames *= 2
                self.stats["redispatches"] += 1
                device_out = self._dispatch(pending.ids, pending.mask, num_frames,
                                            pending.seed, pending.speaker, pending.controls)
                predicted = max(int(shard[2].max().item()) for shard in device_out)
                if predicted <= num_frames or attempt == max_redispatch - 1:
                    out = self._fetch(device_out)
                    break
        self.stats["audio_seconds"] += float(np.sum(out.lengths)) / self.config.sampling_rate
        return out

    def synthesize_raw(
        self,
        texts: str | Sequence[str],
        *,
        seed: int | Sequence[int] = 0,
        speaker_id: Optional[int | Sequence[int]] = None,
        max_redispatch: int = 3,
        pad_to_batch: Optional[int] = None,
        noise_scale: Optional[float] = None,
        noise_scale_duration: Optional[float] = None,
        speaking_rate: Optional[float] = None,
    ) -> EngineOutput:
        """Untrimmed batched output (host numpy) plus per-row lengths; rows past
        the texts are padding (``pad_to_batch``, batch buckets)."""
        pending = self.submit(
            texts, seed=seed, speaker_id=speaker_id, pad_to_batch=pad_to_batch,
            noise_scale=noise_scale, noise_scale_duration=noise_scale_duration,
            speaking_rate=speaking_rate,
        )
        return self.collect(pending, max_redispatch=max_redispatch)

    def convert_voice(
        self,
        audio: np.ndarray | Sequence[np.ndarray],
        *,
        source_speaker: Optional[int | Sequence[int]] = None,
        target_speaker: Optional[int | Sequence[int]] = None,
        seed: int = 0,
        noise_scale: float = 0.0,
        trim: bool = True,
    ):
        """Voice conversion: source audio -> the same speech in the target voice.

        ``audio`` is one 1-D float32 waveform at ``config.sampling_rate`` (or a
        list; returns a list). The spectrogram is framed as in training (hop =
        total_upsample, n_fft = 2*(spectrogram_bins-1)), so posterior frames
        align 1:1 with latent frames, and padded to the smallest frame bucket
        that holds the longest input. ``noise_scale=0`` converts the posterior
        mean: deterministic. Otherwise row r draws its noise from its own
        ``torch.Generator`` seeded from (seed, r). On a mesh engine the rows
        (padded to the data axis) shard over the replicas as a dispatch's do.
        """
        from vits_tpu_torch.train.data import linear_spectrogram

        single = isinstance(audio, np.ndarray) and np.ndim(audio) == 1
        waves_in = [audio] if single else list(audio)
        hop = self.config.total_upsample
        n_fft = 2 * (self.config.spectrogram_bins - 1)
        specs = []
        for a in waves_in:
            a = np.asarray(a, np.float32).reshape(-1)
            floor = max(hop, (n_fft - hop) // 2 + 1)  # reflect padding and one frame
            if len(a) < floor:
                a = np.pad(a, (0, floor - len(a)))
            n_frames = len(a) // hop
            specs.append(linear_spectrogram(a[: n_frames * hop], n_fft, hop)[:n_frames])
        batch = len(specs)
        rows = batch + (-batch % len(self.replicas) if self.mesh is not None else 0)
        capacity = _next_bucket([self._frame_capacity(tb) for tb in self.engine.token_buckets],
                                max(s.shape[0] for s in specs))
        spec = np.zeros((rows, capacity, self.config.spectrogram_bins), np.float32)
        mask = np.zeros((rows, capacity), np.float32)
        for i, s in enumerate(specs):
            spec[i, : s.shape[0]] = s
            mask[i, : s.shape[0]] = 1.0
        src = _speaker_rows(source_speaker, rows, batch, "source_speaker")
        tgt = _speaker_rows(target_speaker, rows, batch, "target_speaker")
        for speaker in (src, tgt):
            self._check_speakers(speaker)
        seeds = tuple(row_seed(seed, r) for r in range(rows))
        t0 = time.perf_counter()
        jobs = [(spec[s], mask[s], seeds[s], None if src is None else src[s],
                 None if tgt is None else tgt[s]) for s in self._shards(rows)]
        shards = self.replicas.run(
            functools.partial(self._convert_shard, noise_scale=noise_scale), jobs)
        wave = np.concatenate([self._host(w) for w in shards])
        if wave.dtype == np.int16:
            wave = wave.astype(np.float32) / 32767.0
        self.stats["dispatches"] += 1
        self.stats["wall_seconds"] += time.perf_counter() - t0
        results = [wave[i, : specs[i].shape[0] * hop] if trim else wave[i]
                   for i in range(batch)]
        return results[0] if single else results

    def _convert_shard(self, replica: Replica, spec: np.ndarray, mask: np.ndarray,
                       seeds: tuple, src: np.ndarray | None, tgt: np.ndarray | None, *,
                       noise_scale: float) -> torch.Tensor:
        """One shard of a conversion on its replica: the waveform as it crosses."""
        cd = self.compute_dtype
        out = voice_convert(
            replica.params, self.config, torch.as_tensor(spec).to(replica.device, cd),
            torch.as_tensor(mask).to(replica.device, cd), self._speaker_tensor(src, replica.device),
            self._speaker_tensor(tgt, replica.device), generator=replica.generators(seeds),
            noise_scale=noise_scale, tiers=self.tiers, vocoder_packs=replica.vocoder_packs())
        return self._transfer(out.waveform)

    def warmup(self, batch_sizes=(1,), token_buckets=None, per_row_seeds=False,
               overflow_ladder: int = 0) -> None:
        """Run each dispatch shape a server expects once, before its first request.

        As the JAX engine's ``warmup``: every (batch size, token bucket) at the
        current frame capacity and, with ``overflow_ladder=N``, at the first N
        rungs of the re-dispatch ladder (capacity doubled N times), with one
        per-row generator a row when ``per_row_seeds`` (the layout of
        ``seed=[...]``, which a server passes) and one generator otherwise.
        The first dispatch builds the kernel library; each shape lets cuDNN
        pick its algorithms and, with ``use_pallas_flow``, captures kernel 6's
        graph, which the flow pack keeps for good (``FlowPack.keeping``). A
        multi-speaker model dispatches speaker 0 on every row, the shapes of
        requests that name a speaker. On a mesh engine each batch size rounds
        up to the data axis and seeds are per row, as a mesh dispatch's are:
        every replica runs its shard's shapes.
        """
        n = len(self.replicas) if self.mesh is not None else 1
        with self._keeping_flow_graphs():
            for bs in batch_sizes:
                bs = -(-bs // n) * n
                speaker = np.zeros((bs,), np.int64) if self.config.num_speakers > 1 else None
                seed = (0,) * bs if per_row_seeds or self.mesh is not None else 0
                for tb in token_buckets or self.engine.token_buckets:
                    ids = np.zeros((bs, tb), np.int32)
                    mask = np.zeros((bs, tb), np.float32)
                    mask[:, 0] = 1.0
                    capacity = self._frame_capacity(tb)
                    for rung in range(overflow_ladder + 1):
                        self._dispatch(ids, mask, capacity * 2 ** rung, seed, speaker,
                                       self._controls(None, None, None))
        self._synchronize()

    # ------------------------------------------------------------------ #
    # Frame capacity: the JAX engine's adaptive ratio, on host numbers only.
    def _frame_capacity(self, token_bucket: int) -> int:
        eng = self.engine
        if eng.adaptive_capacity_align and self._frames_per_token > eng.frames_per_token:
            k = float(np.log2(self._frames_per_token / eng.frames_per_token))
            if abs(k - round(k)) < 1e-6:  # on-ladder ratio: base capacity doubled k times
                return eng.frame_bucket(token_bucket) * (2 ** max(0, int(round(k))))
        return eng.frame_bucket(token_bucket, ratio=self._frames_per_token)

    def _observed_rate(self, pending: PendingSynthesis, frame_lengths) -> float | None:
        """Per-dispatch frames/token, or None when the controls change durations."""
        defaults = (self.config.noise_scale_duration, self.config.speaking_rate)
        observed = (pending.controls[1], pending.controls[2])
        for obs, dflt in zip(observed, defaults):
            if abs(float(np.float32(obs)) - float(np.float32(dflt))) > 1e-6:
                return None
        tokens = np.maximum(np.asarray(pending.mask, np.float32).sum(axis=1), 1.0)
        rate = float(np.max(np.asarray(frame_lengths, np.float32) / tokens))
        self._rate_window.append(rate)
        return rate

    def _aligned_ratio(self, rate: float, round_up: bool = True) -> float:
        """Smallest (largest, if ``round_up=False``) base * 2^k covering ``rate``."""
        base = float(self.engine.frames_per_token)
        if rate <= base:
            return base
        k = float(np.log2(rate / base))
        k = int(np.ceil(k - 1e-9)) if round_up else int(np.floor(k + 1e-9))
        return base * (2 ** max(0, k))

    def _observe_overflow(self, rate: float | None) -> None:
        """Raise the working ratio to cover an overflow, within the config's clamps."""
        eng = self.engine
        if not eng.adaptive_capacity or rate is None:
            return
        if eng.adaptive_capacity_align:
            bumped = min(self._aligned_ratio(rate), self._frames_per_token * 2.0,
                         self._aligned_ratio(float(eng.adaptive_capacity_max), round_up=False))
        else:
            step = max(eng.adaptive_capacity_step, 1e-3)
            bumped = min(float(np.ceil(rate / step) * step),
                         self._frames_per_token * 2.0,
                         self._frames_per_token + float(eng.adaptive_capacity_request_max),
                         float(eng.adaptive_capacity_max))
        if bumped > self._frames_per_token:
            self._frames_per_token = bumped
            self._rate_window.clear()

    def _maybe_decay(self) -> None:
        """After a full window of dispatches, fall back to what the window needed."""
        eng = self.engine
        if not (eng.adaptive_capacity and eng.adaptive_capacity_decay):
            return
        floor = float(eng.frames_per_token)
        if self._frames_per_token <= floor or len(self._rate_window) < self._rate_window.maxlen:
            return
        if eng.adaptive_capacity_align:
            target = max(floor, self._aligned_ratio(max(self._rate_window)))
        else:
            step = max(eng.adaptive_capacity_step, 1e-3)
            target = max(floor, float(np.ceil(max(self._rate_window) / step) * step))
        if target < self._frames_per_token:
            self._frames_per_token = target
            self._rate_window.clear()
