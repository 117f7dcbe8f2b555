"""The data axis: a mesh of replicas for serving, and the rows, collectives and
ZeRO-1 owners of multi-process training.

Counterpart of the data axis of ``vits_tpu/parallel/mesh.py``.

Serving (:func:`make_mesh`): a :class:`Mesh` lays devices out on the
('data', 'model') axes, as JAX's ``make_mesh`` does. A mesh engine
(``Synthesizer(mesh=)``) keeps one replica of the weights on each entry of the
data axis and runs each replica's share of a batch there; the time-sharded
decode (``engine/sp.py``) runs one window on each. A device may repeat: each
entry is a replica, as each of JAX's virtual CPU devices is one.

Training: JAX shards a global batch over a 'data' mesh axis and GSPMD inserts
the collectives; here every process (rank) holds the whole global batch, keeps
its rows (:func:`rank_rows`) and sums its gradients with the others'
(:func:`all_reduce_`) before one identical optimizer update on every rank.
The collectives are ``all_reduce`` and ``broadcast`` only, so the same code
runs over NCCL and over gloo, which has neither ``all_gather`` nor
``reduce_scatter`` for CUDA tensors.

Not ported: the 'model' axis (``make_mesh(model=2)`` raises
``NotImplementedError``; tensor-parallel parameter rules,
``shard_params(model_parallel=True)``) and the 'slice' axis.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


DATA_AXIS = "data"
MODEL_AXIS = "model"


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
              devices: Optional[Sequence] = None) -> Mesh:
    """A ('data', 'model') mesh over ``devices`` (default: every visible CUDA
    device), as JAX's ``make_mesh``; ``data`` defaults to ``len(devices) //
    model``. A device may repeat (``[cuda:0] * 2``, ``[cpu] * 4``): each entry
    is a replica. Raises where ``data * model`` is not the number of devices
    or a device does not exist; ``model > 1`` (tensor parallelism) is not
    ported."""
    if model != 1:
        raise NotImplementedError("the 'model' (tensor-parallel) mesh axis is not ported "
                                  "(ROADMAP.md queue 1)")
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("make_mesh: no CUDA device is visible (pass devices=)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_mesh_device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // model
    if data < 1 or data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.empty((n,), dtype=object)
    arr[:] = devices
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
    """A process's place on the data axis: ``world`` ranks, this one ``rank``."""

    world: int
    rank: int


def data_axis() -> Optional[DataParallel]:
    """The data axis of the initialized process group, or None without one."""
    if not dist.is_initialized():
        return None
    return DataParallel(dist.get_world_size(), dist.get_rank())


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


def rank_rows(batch_size: int, world: int, rank: int, grad_accum: int = 1) -> np.ndarray:
    """The global rows ``rank`` holds, microbatch by microbatch.

    Microbatch ``i`` of ``grad_accum`` is global rows ``[i*m, (i+1)*m)``,
    ``m = batch_size / grad_accum`` (the one-process step's split); the rank
    holds its ``1/world`` of each, so its own rows split into ``grad_accum``
    equal runs are its share of each microbatch. Raises ``ValueError`` where a
    microbatch's rows do not divide by ``world`` (JAX's GSPMD pads inside).
    """
    if batch_size % grad_accum:
        raise ValueError(f"batch size {batch_size} not divisible by grad_accum={grad_accum}")
    m = batch_size // grad_accum
    if m % world:
        raise ValueError(f"a microbatch of {m} rows (batch {batch_size}, grad_accum "
                         f"{grad_accum}) does not divide over {world} ranks")
    per = m // world
    return np.concatenate([np.arange(i * m + rank * per, i * m + (rank + 1) * per)
                           for i in range(grad_accum)])


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


def all_reduce_(tensors: Sequence[torch.Tensor]) -> None:
    """SUM every tensor over the ranks, in place: one collective over one flat
    fp32 buffer, not one call per tensor."""
    if not tensors:
        return
    flat = _flat(tensors)
    dist.all_reduce(flat)
    _unflat(flat, tensors)


def broadcast_(tensors: Sequence[torch.Tensor], src: int) -> None:
    """Rank ``src``'s values of ``tensors`` into every rank's, in place: one
    collective over one flat fp32 buffer."""
    if not tensors:
        return
    if dist.get_rank() == src:
        flat = _flat(tensors)
    else:
        flat = torch.empty(sum(t.numel() for t in tensors), dtype=torch.float32,
                           device=tensors[0].device)
    dist.broadcast(flat, src)
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
