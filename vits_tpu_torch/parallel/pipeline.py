"""GPipe pipeline parallelism over the text-encoder transformer stack.

Counterpart of ``vits_tpu/parallel/pipeline.py``, with its public names.
JAX runs the stack as one ``shard_map`` over a 'pipe' mesh axis, activations
hopping stage to stage with ``ppermute``. Here the stack runs in one process
over a :class:`~vits_tpu_torch.parallel.mesh.Mesh` of devices: each stage's
layers live on its device, microbatches move to the next stage's device with
``.to``, in GPipe order (step t runs microbatch t - s on stage s), and
autograd runs the reverse schedule. Embedding and the stats projection run
outside the stack, on the first stage's device.

The stacked layout: every ``text_encoder.encoder.layers.{i}.{suffix}`` becomes
one block per stage, ``text_encoder.encoder.pipeline.{s}.{suffix}`` of shape
``(layers_per_stage, *leaf)`` on stage s's device (a tensor cannot span
devices); the blocks stacked are JAX's ``(num_stages, per, *leaf)`` array.

Each stage applies ``models/encoder.py::encoder_layer`` on the trainable path:
on CUDA from ``FLASH_TRAIN_TOKENS`` tokens up its attention runs kernels A
(with lse) and 4, as the one-device step's does (JAX's pipeline runs its
plain layers: GSPMD cannot partition a custom call; the port has no kernel-off
switch). ``remat=True`` checkpoints each stage (``torch.utils.checkpoint``,
non-reentrant). On a ('pipe', 'data') mesh a microbatch's rows split over the
stage's data devices; each runs on a differentiable copy of the stage's block
(the copy on the first is the block itself), so the replicas' gradients sum
onto the block, as JAX's ``shard_map`` transpose inserts the psum.

Schedule and cost: with P stages and M microbatches the schedule runs
M + P - 1 steps, the bubble (P - 1) / (M + P - 1) of the time on distinct
devices; on one device (a mesh of one card repeated) the stages run in turn
and there is no overlap to win.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from vits_tpu_torch.config import VitsConfig
from vits_tpu_torch.io.params import ParamView
from vits_tpu_torch.models.encoder import EncoderOutput, encoder_layer
from vits_tpu_torch.ops.conv import conv1d, weak_scalar
from vits_tpu_torch.ops.cuda import booked_to
from vits_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, _mesh_device

PIPE_AXIS = "pipe"
_LAYER_PREFIX = "text_encoder.encoder.layers."
_STACK_PREFIX = "text_encoder.encoder.pipeline."


def make_pipe_mesh(pipe: int, data: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A ('pipe',) mesh, or ('pipe', 'data') when ``data > 1``, over the first
    ``pipe * data`` of ``devices`` (default: every visible CUDA device). A
    device may repeat (``[cuda:0] * 2``, ``[cpu] * 8``). Raises where there are
    too few devices."""
    if devices is None:
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if torch.cuda.is_available() else [])
    need = pipe * data
    if len(devices) < need:
        raise ValueError(f"need {need} devices for pipe={pipe} x data={data}, "
                         f"have {len(devices)}")
    arr = np.empty((need,), dtype=object)
    arr[:] = [_mesh_device(d) for d in list(devices)[:need]]
    if data > 1:
        return Mesh(arr.reshape(pipe, data), (PIPE_AXIS, DATA_AXIS))
    return Mesh(arr, (PIPE_AXIS,))


def layer_suffixes(params: Mapping) -> list[str]:
    """Per-layer parameter suffixes (e.g. 'attention.q_proj.weight'), sorted."""
    suffixes = sorted(k[len(_LAYER_PREFIX):].split(".", 1)[1] for k in params
                      if k.startswith(_LAYER_PREFIX + "0."))
    if not suffixes:
        raise ValueError("no text_encoder layer parameters found")
    return suffixes


def layer_suffixes_stacked(params: Mapping) -> list[str]:
    """Suffixes present in the stacked (pp) layout."""
    suffixes = sorted(k[len(_STACK_PREFIX):].split(".", 1)[1] for k in params
                      if k.startswith(_STACK_PREFIX + "0."))
    if not suffixes:
        raise ValueError("params are not in pipeline layout: call stack_pipeline_params first")
    return suffixes


def _num_stages(params: Mapping) -> int:
    return len({k[len(_STACK_PREFIX):].split(".", 1)[0] for k in params
                if k.startswith(_STACK_PREFIX)})


def _stage_devices(mesh: Mesh) -> np.ndarray:
    """(pipe, data) devices of the mesh."""
    return mesh.devices.reshape(mesh.shape[PIPE_AXIS], -1)


def stack_pipeline_params(params: Mapping, config: VitsConfig, num_stages: int,
                          mesh: Optional[Mesh] = None) -> dict:
    """Flat parameters -> pp layout: the per-layer entries become one block per
    stage (module docstring), the others pass through. Numpy in, numpy out;
    tensors in, tensors out. With ``mesh`` (tensors) each block lies on its
    stage's first device and the other entries on the first stage's."""
    n = config.num_hidden_layers
    if n % num_stages:
        raise ValueError(f"{n} layers not divisible into {num_stages} stages")
    per = n // num_stages
    suffixes = layer_suffixes(params)
    out = {k: v for k, v in params.items() if not k.startswith(_LAYER_PREFIX)}
    devices = None if mesh is None else _stage_devices(mesh)[:, 0]
    if devices is not None and len(devices) != num_stages:
        raise ValueError(f"{num_stages} stages on a mesh of {len(devices)}")
    for s in range(num_stages):
        for suffix in suffixes:
            leaves = [params[f"{_LAYER_PREFIX}{s * per + l}.{suffix}"] for l in range(per)]
            if torch.is_tensor(leaves[0]):
                block = torch.stack([t.detach() for t in leaves])
                if devices is not None:
                    block = block.to(devices[s])
            else:
                block = np.stack([np.asarray(x) for x in leaves])
            out[f"{_STACK_PREFIX}{s}.{suffix}"] = block
    if devices is not None:
        out = {k: v if k.startswith(_STACK_PREFIX) or not torch.is_tensor(v)
               else v.detach().to(devices[0]) for k, v in out.items()}
    return out


def unstack_pipeline_params(params: Mapping, config: VitsConfig) -> dict:
    """Exact inverse of :func:`stack_pipeline_params` (for checkpoint export); the
    layers come back on the first stage's device."""
    out = {k: v for k, v in params.items() if not k.startswith(_STACK_PREFIX)}
    num_stages = _num_stages(params)
    per = config.num_hidden_layers // num_stages
    first = next((v.device for k, v in params.items()
                  if k.startswith(_STACK_PREFIX + "0.") and torch.is_tensor(v)), None)
    for k, v in params.items():
        if not k.startswith(_STACK_PREFIX):
            continue
        s, suffix = k[len(_STACK_PREFIX):].split(".", 1)
        for l in range(per):
            leaf = v[l]
            out[f"{_LAYER_PREFIX}{int(s) * per + l}.{suffix}"] = (
                leaf.detach().to(first) if torch.is_tensor(leaf) else leaf)
    return out


def _stage_apply(config: VitsConfig, suffixes: list[str], per: int, h: torch.Tensor,
                 lengths: torch.Tensor, pad: torch.Tensor, *block: torch.Tensor) -> torch.Tensor:
    for l in range(per):
        view = ParamView({s: t[l] for s, t in zip(suffixes, block)})
        h = encoder_layer(view, h, lengths, pad, config, trainable=True)
    return h


def pipeline_text_encoder(
    params: Mapping[str, torch.Tensor],
    config: VitsConfig,
    input_ids: torch.Tensor,  # (B, T) int
    padding_mask: torch.Tensor,  # (B, T, 1) float, a prefix mask
    mesh: Mesh,
    microbatches: int = 4,
    remat: bool = False,
) -> EncoderOutput:
    """``models/encoder.py::text_encoder`` (trainable) with its layer stack run in
    GPipe order over the mesh's 'pipe' stages (module docstring); ``params`` in
    :func:`stack_pipeline_params`' layout for this mesh. The outputs lie on the
    first stage's device. Raises where the batch does not divide by
    ``microbatches``, or a microbatch by the 'data' axis."""
    devices = _stage_devices(mesh)
    num_stages, data = devices.shape
    B = input_ids.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} not divisible by microbatches={microbatches}")
    mb = B // microbatches
    if mb % data:
        raise ValueError(f"microbatch rows {mb} not divisible over ('{DATA_AXIS}',) ({data})")
    suffixes = layer_suffixes_stacked(params)
    if _num_stages(params) != num_stages:
        raise ValueError(f"params stacked for {_num_stages(params)} stages, mesh has "
                         f"{num_stages}")
    per = config.num_hidden_layers // num_stages
    blocks = [[params[f"{_STACK_PREFIX}{s}.{suffix}"] for suffix in suffixes]
              for s in range(num_stages)]

    p = ParamView(params).sub("text_encoder")
    hidden = p["embed_tokens.weight"][input_ids]
    hidden = hidden * weak_scalar(math.sqrt(config.hidden_size), hidden)
    hidden = hidden * padding_mask
    lengths = padding_mask[..., 0].float().sum(dim=1).to(torch.int32)

    rows = mb // data
    # (microbatch, data shard) pieces: each a contiguous run of rows
    pieces = [[(slice(i * mb + j * rows, i * mb + (j + 1) * rows)) for j in range(data)]
              for i in range(microbatches)]
    state = {(i, j): hidden[r] for i, shard in enumerate(pieces) for j, r in enumerate(shard)}
    for t in range(microbatches + num_stages - 1):
        for s in range(num_stages):
            i = t - s
            if not 0 <= i < microbatches:
                continue
            for j, r in enumerate(pieces[i]):
                device = devices[s, j]
                block = [w.to(device) for w in blocks[s]]  # the block itself on its device
                args = (config, suffixes, per, state[i, j].to(device), lengths[r].to(device),
                        padding_mask[r].to(device), *block)
                with booked_to(f"stage {s} | {device}"):
                    state[i, j] = (checkpoint(_stage_apply, *args, use_reentrant=False)
                                   if remat else _stage_apply(*args))
    first = devices[0, 0]
    hidden = torch.cat([state[i, j].to(first) for i in range(microbatches)
                        for j in range(data)])
    hidden = hidden * padding_mask
    stats = conv1d(hidden, p["project.weight"], p["project.bias"]) * padding_mask
    return EncoderOutput(hidden, stats[..., : config.flow_size], stats[..., config.flow_size:])


def make_pp_train_step(
    config: VitsConfig,
    params: Mapping[str, torch.Tensor],
    optimizer,
    mesh: Mesh,
    microbatches: int = 4,
    segment_frames: int = 32,
    mel_weight: float = 45.0,
    mel_kwargs: Optional[dict] = None,
    remat: bool = False,
):
    """Generator step with the encoder pipelined over the mesh's 'pipe' stages,
    ``step(batch, generator=None, noise=None) -> TrainMetrics`` (the calling
    convention of ``train/step.py::make_train_step``; JAX's
    ``make_pp_train_step``). ``params`` in :func:`stack_pipeline_params`'
    layout for ``mesh``: each stage's block lies on its stage's device, and so
    do its gradient and the optimizer's moments of it; everything outside the
    encoder runs on the first stage's device, where ``batch`` must lie."""
    from vits_tpu_torch.train.step import make_train_step

    def encoder_fn(prm, cfg, input_ids, padding_mask3):
        return pipeline_text_encoder(prm, cfg, input_ids, padding_mask3, mesh,
                                     microbatches=microbatches, remat=remat)

    return make_train_step(config, params, optimizer, segment_frames, mel_weight, mel_kwargs,
                           encoder_fn=encoder_fn)
