"""The slice, data and model axes: a mesh of replicas for serving, and the
rows, collectives, ZeRO-1 owners and tensor-parallel parameter rules of
multi-process training.

Counterpart of ``vits_tpu/parallel/mesh.py``.

Serving (:func:`make_mesh`): a :class:`Mesh` lays devices out on the
('data', 'model') axes, or ('slice', 'data', 'model') with ``slices > 1``, as
JAX's ``make_mesh`` does. A mesh engine (``Synthesizer(mesh=)``) keeps one
replica of the weights on each entry of the data axis and runs each replica's
share of a batch there; the time-sharded decode (``engine/sp.py``) runs one
window on each. A device may repeat: each entry is a replica, as each of JAX's
virtual CPU devices is one. The engine replicates over 'slice' and 'model'
(``Synthesizer`` keeps one replica per data entry).

Training: JAX shards a global batch over a 'data' mesh axis and GSPMD inserts
the collectives; here every process (rank) holds the whole global batch, keeps
its rows (:func:`rank_rows`) and sums its gradients with the others'
(:func:`data_all_reduce_`) before one identical optimizer update on every
rank. The collectives are ``all_reduce`` and ``broadcast`` only, so the same
code runs over NCCL and over gloo, which has neither ``all_gather`` nor
``reduce_scatter`` for CUDA tensors.

The model axis (tensor parallelism over processes): a world of ``data x
model`` ranks, model innermost (rank = d * model + m, JAX's
``reshape(data, model)``), with one data group (the ranks of one model index)
and one model group (the ranks of one data index) per rank
(:func:`data_axis`, :func:`model_axis`). JAX's parameter rules
(:data:`_PARAM_RULES`, :func:`param_spec`) say which dimension of a tensor
splits over 'model'; a dimension that does not divide falls back to
replication, as in JAX's ``shard_params``. :func:`shard_params` gives a rank
its slices of the split tensors (:func:`split_plan`) and the whole of every
other; :func:`gather_params` is its inverse, a collective. How the split
tensors compute is ``parallel/tensor.py``'s.

The slice axis (``data_axis(model, slices=k)``): a world of ``slices x data x
model`` ranks, slice outermost (rank = (s * data + d) * model + m, JAX's
``reshape(slices, data, model)``). The batch splits over slice and data
together, slice-major (JAX's ``P(('slice', 'data'))``), so a rank's place on
the data axis stays ``rank // model``. A rank's data group is then its slice's
(the ranks d = 0..data-1 of its slice and model index), and it also joins its
cross-slice group (the ranks s = 0..slices-1 of its data and model index).
:func:`data_all_reduce_` sums in three stages, JAX's psum over ('slice',
'data'): inside the slice; then each in-slice rank d sums chunk d (1/data of
the buffer) across slices; then each chunk is broadcast inside the slice from
the rank that summed it. Each rank sends 2 (slices-1) / slices of 1/data of the
buffer across slices, so a slice sends about as much across as one flat ring
would; the rest stays inside the slice (on GPUs, a node's NVLink). No run over
several nodes has timed it. ZeRO-1 splits the moments over the slice's data
ranks alone (JAX's ``opt_state_shardings`` splits over 'data'; each slice
keeps a whole copy).
"""

from __future__ import annotations

import re
from typing import Any, Mapping, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"


class Mesh:
    """Devices laid out on named axes: ``devices`` is an array of
    ``torch.device`` of shape ``tuple(shape.values())``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS)):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"devices of shape {self.devices.shape} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _mesh_device(device) -> torch.device:
    """``device`` as a ``torch.device`` that exists: a CUDA device by its index."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = 0 if device.index is None else device.index
        if index >= count:
            raise ValueError(f"mesh device {device}: {count} CUDA device(s) visible")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"mesh device {device}: cuda or cpu")
    return device


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None, slices: int = 1) -> Mesh:
    """A ('data', 'model') mesh over ``devices`` (default: every visible CUDA
    device), or ('slice', 'data', 'model') with ``slices > 1``, as JAX's
    ``make_mesh``; ``data`` defaults to ``len(devices) // (model * slices)``.
    The devices are taken slice-major, so the inner axes hold consecutive
    devices. A device may repeat (``[cuda:0] * 2``, ``[cpu] * 4``): each entry
    is a replica. Raises where ``slices * data * model`` is not the number of
    devices or a device does not exist."""
    if model < 1 or slices < 1:
        raise ValueError(f"model={model}, slices={slices}: at least 1 each")
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("make_mesh: no CUDA device is visible (pass devices=)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_mesh_device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // (model * slices)
    if data < 1 or slices * data * model != n:
        raise ValueError(f"mesh {slices}x{data}x{model} != {n} devices")
    arr = np.empty((n,), dtype=object)
    arr[:] = devices
    if slices > 1:
        return Mesh(arr.reshape(slices, data, model), (SLICE_AXIS, DATA_AXIS, MODEL_AXIS))
    return Mesh(arr.reshape(data, model))


def replica_devices(device, n: int) -> list[torch.device]:
    """The devices of an ``n``-replica data axis from a ``--device`` flag: ``cuda``
    (``cuda:k``) takes ``n`` cards from 0 (from k), ``cpu`` ``n`` CPU replicas.
    Raises ``ValueError`` where fewer cards are visible: never fewer replicas,
    never another device."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * n
    first = device.index or 0
    return [_mesh_device(torch.device(device.type, first + i)) for i in range(n)]


class DataParallel(NamedTuple):
    """A process's place on the data axis: ``world`` ranks, this one ``rank``.
    ``group`` is the process group of its data ranks (None: the whole world).
    With a slice axis (``slices`` > 1) the data axis is slice x data,
    slice-major: ``group`` holds the ``world // slices`` data ranks of this
    rank's slice, ``cross_group`` the ``slices`` ranks of its in-slice index,
    one in each slice."""

    world: int
    rank: int
    group: Any = None
    slices: int = 1
    cross_group: Any = None

    @property
    def in_slice(self) -> tuple[int, int, Any]:
        """(ranks, this rank's index, group) of its slice's data axis: the whole data
        axis without a slice axis. ZeRO-1 splits the moments over it."""
        size = self.world // self.slices
        return size, self.rank % size, self.group


class ModelParallel(NamedTuple):
    """A process's place on the model axis: ``size`` ranks hold the slices of
    one model, this one ``rank``; ``group`` their process group."""

    size: int
    rank: int
    group: Any = None


# This process's group of each (axis, slices, model): every rank creates every
# group of an axis (dist.new_group's rule), in the same order, once per process group.
_GROUPS: dict[tuple[str, int, int], tuple] = {}


def axis_rank_sets(world: int, model: int = 1, slices: int = 1) -> dict[str, list[list[int]]]:
    """The ranks of every group of each axis in a world of ``slices x data x
    model`` ranks, model innermost (rank = (s * data + d) * model + m, JAX's
    ``reshape(slices, data, model)``): 'data' one per model index (the whole
    data axis, every slice), 'model' one per (slice, data) index, 'slice' one
    per (slice, model) index (the data ranks of one slice), 'cross' one per
    (data, model) index (one rank a slice). Raises ``ValueError`` where the
    world does not divide."""
    if model < 1 or world % model:
        raise ValueError(f"a world of {world} ranks does not divide by model_parallel={model}")
    if slices < 1 or world % (slices * model):
        raise ValueError(f"a world of {world} ranks does not divide by slices={slices} x "
                         f"model_parallel={model}")
    data = world // (slices * model)

    def rank(s, d, m):
        return (s * data + d) * model + m
    S, D, M = range(slices), range(data), range(model)
    return {"data": [[rank(s, d, m) for s in S for d in D] for m in M],
            "model": [[rank(s, d, m) for m in M] for s in S for d in D],
            "slice": [[rank(s, d, m) for d in D] for s in S for m in M],
            "cross": [[rank(s, d, m) for s in S] for d in D for m in M]}


def _group(axis: str, model: int, slices: int = 1) -> Any:
    """This rank's group of ``axis`` (a key of :func:`axis_rank_sets`), made once
    per process group: every rank creates every group of the axis, in order."""
    cached = _GROUPS.get((axis, slices, model))
    if cached is not None and cached[0] is dist.group.WORLD:
        return cached[1]
    rank, mine = dist.get_rank(), None
    for ranks in axis_rank_sets(dist.get_world_size(), model, slices)[axis]:
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    _GROUPS[(axis, slices, model)] = (dist.group.WORLD, mine)
    return mine


def data_axis(model: int = 1, slices: int = 1) -> Optional[DataParallel]:
    """The data axis of the initialized process group under a model axis of
    ``model`` ranks (the ranks of this rank's model index) and a slice axis of
    ``slices`` (its in-slice and cross-slice groups), or None without a process
    group. Raises ``ValueError`` where the world does not divide by ``slices *
    model``."""
    if not dist.is_initialized():
        if model != 1 or slices != 1:
            raise ValueError(f"slices={slices} x model_parallel={model} needs a process group "
                             f"of a multiple of {slices * model} ranks")
        return None
    world, rank = dist.get_world_size(), dist.get_rank()
    axis_rank_sets(world, model, slices)  # raises where the world does not divide
    if slices == 1:
        return DataParallel(world // model, rank // model,
                            None if model == 1 else _group("data", model))
    return DataParallel(world // model, rank // model, _group("slice", model, slices), slices,
                        _group("cross", model, slices))


def model_axis(model: int) -> ModelParallel:
    """This rank's place on a model axis of ``model`` ranks (the ranks of its data
    index, innermost). Raises ``ValueError`` without a process group or where
    the world does not divide by ``model``."""
    if not dist.is_initialized():
        raise ValueError(f"model_parallel={model} needs a process group of a multiple of "
                         f"{model} ranks")
    axis_rank_sets(dist.get_world_size(), model)  # raises where the world does not divide
    return ModelParallel(model, dist.get_rank() % model,
                         None if model == 1 else _group("model", model))


# ---------------------------------------------------------------------- #
# Parameter rules, JAX's (vits_tpu/parallel/mesh.py): the first regex that
# matches a canonical-layout name wins; a spec names the dimension that splits
# over 'model'. Layouts (io/params.py): linear (in, out), conv (k, in, out),
# conv_transpose (k, in, out), embeddings (vocab, dim). Column-split producers
# pair with row-split consumers (parallel/tensor.py).
_PARAM_RULES: list[tuple[re.Pattern, tuple]] = [
    # --- text encoder ---------------------------------------------------
    (re.compile(r".*\.attention\.(q|k|v)_proj\.weight$"), (None, MODEL_AXIS)),
    (re.compile(r".*\.attention\.(q|k|v)_proj\.bias$"), (MODEL_AXIS,)),
    (re.compile(r".*\.attention\.out_proj\.weight$"), (MODEL_AXIS, None)),
    (re.compile(r".*\.feed_forward\.conv_1\.weight$"), (None, None, MODEL_AXIS)),
    (re.compile(r".*\.feed_forward\.conv_1\.bias$"), (MODEL_AXIS,)),
    (re.compile(r".*\.feed_forward\.conv_2\.weight$"), (None, MODEL_AXIS, None)),
    # --- wavenet gates (2*hidden wide) ----------------------------------
    (re.compile(r".*wavenet\.in_layers\.\d+\.weight$"), (None, None, MODEL_AXIS)),
    (re.compile(r".*wavenet\.in_layers\.\d+\.bias$"), (MODEL_AXIS,)),
    # --- hifigan: shard the wide channel dims ---------------------------
    (re.compile(r"decoder\.conv_pre\.weight$"), (None, None, MODEL_AXIS)),
    (re.compile(r"decoder\.conv_pre\.bias$"), (MODEL_AXIS,)),
    (re.compile(r"decoder\.upsampler\.\d+\.weight$"), (None, MODEL_AXIS, None)),
    (re.compile(r"decoder\.resblocks\.\d+\.convs\d\.\d+\.weight$"), (None, None, MODEL_AXIS)),
    (re.compile(r"decoder\.resblocks\.\d+\.convs\d\.\d+\.bias$"), (MODEL_AXIS,)),
    # --- posterior encoder ----------------------------------------------
    (re.compile(r"posterior_encoder\.conv_pre\.weight$"), (None, None, MODEL_AXIS)),
    (re.compile(r"posterior_encoder\.conv_pre\.bias$"), (MODEL_AXIS,)),
]


def param_spec(name: str, shape: tuple[int, ...], model_parallel: bool = True) -> tuple:
    """The partition spec of one parameter, as JAX's ``PartitionSpec`` entries:
    ``MODEL_AXIS`` on the dimension that splits, () where nothing matches (the
    divisibility fallback is :func:`split_plan`'s)."""
    if model_parallel:
        for pattern, spec in _PARAM_RULES:
            if pattern.match(name):
                return spec
    return ()


class Split(NamedTuple):
    """How one parameter splits over the model axis."""

    dim: int  # the dimension of the canonical layout
    gate: bool = False  # a WaveNet gate's 2*hidden outputs: the rank's share of each half
    whole: bool = False  # split at rest only: gathered whole where it computes


# Split tensors whose consumer is not row-split: kept as slices, computed whole
# (parallel/tensor.py::TensorParallel.gather). The resblocks' consumer is kernel 5,
# which fuses every conv of the trio.
_WHOLE = re.compile(r"decoder\.resblocks\.|posterior_encoder\.conv_pre\.")
_ATTENTION = re.compile(r"(.*\.attention\.)(q_proj|k_proj|v_proj|out_proj)\.")
_GATE = re.compile(r".*wavenet\.in_layers\.\d+\.")


def split_plan(params: Mapping[str, Any], size: int,
               head_dim: int | None = None) -> dict[str, Split]:
    """Name -> :class:`Split` of every parameter that splits over a model axis of
    ``size`` ranks: a rule matches and its dimension divides (JAX's fallback
    replicates the others). The attention splits its compute by heads where the
    heads divide, the gates where each half divides; otherwise, and for the
    resblocks and the posterior's ``conv_pre``, the slices are gathered whole
    where they compute. The attention's head width is ``head_dim`` or, by
    default, its relative table's; a model with no table (``window_size`` 0)
    and no ``head_dim`` gathers its attention whole."""
    plan = {}
    for name, value in params.items():
        shape = tuple(value.shape)
        dims = [d for d, axis in enumerate(param_spec(name, shape)) if axis == MODEL_AXIS]
        if size == 1 or not dims or shape[dims[0]] % size:
            continue
        dim, gate, whole = dims[0], False, bool(_WHOLE.match(name))
        attention = _ATTENTION.match(name)
        if attention:  # heads = width / head_dim, head_dim by default from the shared rel table
            rel = params.get(attention.group(1) + "emb_rel_k")
            width = head_dim or (None if rel is None else rel.shape[-1])
            whole = width is None or (shape[dim] // width) % size != 0
        elif _GATE.match(name):
            gate = (shape[dim] // 2) % size == 0
            whole = not gate
        plan[name] = Split(dim, gate, whole)
    return plan


def shard_index(split: Split, n: int, size: int, rank: int) -> np.ndarray:
    """The indices along ``split.dim`` (of length ``n``) that ``rank`` holds: a
    contiguous ``n / size``, or for a gate the matching ``n / (2 size)`` of each
    half (tanh's, then sigmoid's)."""
    if split.gate:
        half, w = n // 2, n // (2 * size)
        return np.concatenate([np.arange(rank * w, (rank + 1) * w),
                               half + np.arange(rank * w, (rank + 1) * w)])
    w = n // size
    return np.arange(rank * w, (rank + 1) * w)


def _take(value, split: Split, size: int, rank: int):
    index = shard_index(split, value.shape[split.dim], size, rank)
    if torch.is_tensor(value):
        return value.index_select(split.dim, torch.as_tensor(index, device=value.device))
    return np.ascontiguousarray(np.take(np.asarray(value), index, axis=split.dim))


def take_shards(params: Mapping[str, Any], plan: Mapping[str, Split],
                model_parallel: ModelParallel) -> dict:
    """Rank ``model_parallel.rank``'s slices of the tensors in ``plan`` and the
    whole of every other, numpy or tensors as given (slices are copies)."""
    size, rank = model_parallel.size, model_parallel.rank
    return {name: _take(value, plan[name], size, rank) if name in plan else value
            for name, value in params.items()}


def shard_params(params: Mapping[str, Any], model_parallel: ModelParallel,
                 head_dim: int | None = None) -> dict:
    """Rank ``model_parallel.rank``'s slices of the tensors that split
    (:func:`split_plan`) and the whole of every other (:func:`take_shards`)."""
    return take_shards(params, split_plan(params, model_parallel.size, head_dim),
                       model_parallel)


def gather_params(params: Mapping[str, torch.Tensor], plan: Mapping[str, Split],
                  model_parallel: ModelParallel) -> dict[str, torch.Tensor]:
    """The whole tensors of a rank's ``params`` (:func:`shard_params`' layout):
    every rank of the model group calls it. One SUM ``all_reduce`` of the slices
    placed in zero-filled whole tensors (fp32), the others as they are."""
    names = [name for name in params if name in plan]
    whole = {}
    for name in names:
        value, split = params[name].detach(), plan[name]
        shape = list(value.shape)
        shape[split.dim] *= model_parallel.size
        full = torch.zeros(shape, dtype=torch.float32, device=value.device)
        index = torch.as_tensor(shard_index(split, shape[split.dim], model_parallel.size,
                                            model_parallel.rank), device=value.device)
        whole[name] = full.index_copy_(split.dim, index, value.float())
    all_reduce_(list(whole.values()), model_parallel.group)
    return {name: whole.get(name, value) for name, value in params.items()}


def pad_rows(batch, world: int, segment_frames: int):
    """Round a numpy ``TrainBatch`` up to a multiple of ``world`` rows.

    Padded rows are minimal dummy utterances (1 valid token, a few silent
    frames) -- a fully-masked row would NaN the attention softmax; these
    contribute ~0 to the masked losses.
    """
    B = batch.input_ids.shape[0]
    target = -(-B // world) * world
    if target == B:
        return batch
    extra = target - B

    def pad(x, rows):
        return np.concatenate([x, rows], axis=0)

    tm = np.zeros((extra, batch.token_mask.shape[1]), np.float32)
    tm[:, 0] = 1.0
    fm = np.zeros((extra, batch.frame_mask.shape[1]), np.float32)
    fm[:, : max(segment_frames, 8)] = 1.0
    return batch._replace(
        input_ids=pad(batch.input_ids, np.zeros((extra, batch.input_ids.shape[1]), np.int32)),
        token_mask=pad(batch.token_mask, tm),
        spectrogram=pad(batch.spectrogram,
                        np.zeros((extra,) + batch.spectrogram.shape[1:], np.float32)),
        frame_mask=pad(batch.frame_mask, fm),
        audio=pad(batch.audio, np.zeros((extra, batch.audio.shape[1]), np.float32)),
        speaker_id=None if batch.speaker_id is None else pad(
            batch.speaker_id, np.zeros((extra,), np.int32)),
    )


def microbatch_rows(batch_size: int, world: int, rank: int,
                    grad_accum: int = 1) -> list[np.ndarray]:
    """The global rows ``rank`` holds of each microbatch, in order.

    Microbatch ``i`` of ``grad_accum`` is global rows ``[i*m, (i+1)*m)``,
    ``m = batch_size / grad_accum`` (the one-process step's split); the rank
    holds rows ``[rank*m // world, (rank+1)*m // world)`` of it. Where ``m`` does
    not divide by ``world`` the shares differ by one row and a rank may hold
    none (as JAX's GSPMD step runs such a microbatch). Raises ``ValueError``
    where ``batch_size`` does not divide by ``grad_accum`` or by ``world``, as
    JAX does (:func:`pad_rows` pads a batch to the world).
    """
    if batch_size % grad_accum:
        raise ValueError(f"batch size {batch_size} not divisible by grad_accum={grad_accum}")
    if batch_size % world:
        raise ValueError(f"batch size {batch_size} does not divide over {world} ranks "
                         "(pad_rows pads it)")
    m = batch_size // grad_accum
    lo, hi = rank * m // world, (rank + 1) * m // world
    return [np.arange(i * m + lo, i * m + hi) for i in range(grad_accum)]


def rank_rows(batch_size: int, world: int, rank: int, grad_accum: int = 1) -> np.ndarray:
    """The global rows ``rank`` holds, microbatch by microbatch
    (:func:`microbatch_rows`, concatenated)."""
    return np.concatenate(microbatch_rows(batch_size, world, rank, grad_accum))


# The flat buffer is built and split in C++ (torch._utils' helpers DDP uses) and
# copied back with one multi-tensor copy: a generator has ~700 tensors, and a
# Python loop over them cost more than NCCL's all-reduce of them on an H100.
def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the collectives take fp32 tensors (gradients, master weights, moments)")
    return torch._utils._flatten_dense_tensors([t.detach() for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    with torch.no_grad():
        torch._foreach_copy_(list(tensors), torch._utils._unflatten_dense_tensors(flat, tensors))


def all_reduce_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """SUM every tensor over the ranks of ``group`` (None: the world), in place:
    one collective over one flat fp32 buffer, not one call per tensor."""
    if not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    _unflat(flat, tensors)


def data_all_reduce_(tensors: Sequence[torch.Tensor], data_parallel: DataParallel) -> None:
    """SUM every tensor over the data axis, in place, over one flat fp32 buffer:
    one ``all_reduce`` over the data group, then with a slice axis the rest of
    the module docstring's three stages: chunk d of the slice's data ranks summed
    across slices by in-slice rank d, then broadcast from it inside the slice. A
    stage over one rank is skipped; every rank ends with the same bits."""
    if not tensors:
        return
    size, index, group = data_parallel.in_slice
    flat = _flat(tensors)
    if size > 1 or data_parallel.slices == 1:
        dist.all_reduce(flat, group=group)
    if data_parallel.slices > 1:
        chunks = flat.tensor_split(size)
        dist.all_reduce(chunks[index], group=data_parallel.cross_group)
        for i, chunk in enumerate(chunks if size > 1 else ()):
            dist.broadcast(chunk, dist.get_global_rank(group, i), group=group)
    _unflat(flat, tensors)


def broadcast_(tensors: Sequence[torch.Tensor], src: int, group=None) -> None:
    """Rank ``src``'s values of ``tensors`` into those of every rank of ``group``
    (None: the world), in place: one collective over one flat fp32 buffer.
    ``src`` is a rank of the world."""
    if not tensors:
        return
    if dist.get_rank() == src:
        flat = _flat(tensors)
    else:
        flat = torch.empty(sum(t.numel() for t in tensors), dtype=torch.float32,
                           device=tensors[0].device)
    dist.broadcast(flat, src, group=group)
    if dist.get_rank() != src:
        _unflat(flat, tensors)


def zero1_owners(numels: Sequence[int], world: int) -> list[int]:
    """ZeRO-1's owner rank of each tensor: the largest first, each to the rank
    that owns the fewest elements so far (ties: the lower index, the lower
    rank). Deterministic, so every rank computes the same split."""
    load = [0] * world
    owners = [0] * len(numels)
    for i in sorted(range(len(numels)), key=lambda i: (-numels[i], i)):
        r = min(range(world), key=lambda r: (load[r], r))
        owners[i] = r
        load[r] += numels[i]
    return owners
