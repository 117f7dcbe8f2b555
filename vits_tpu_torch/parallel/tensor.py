"""Tensor-parallel compute over the model axis: the collectives the split layers need.

JAX names the split (``vits_tpu/parallel/mesh.py``'s rules) and GSPMD
partitions the jitted step. Here each rank of a model group holds its slices
(``parallel/mesh.py::shard_params``) and the model code computes on them,
pairing each column-split producer with a row-split consumer, as the rule
table intends: the replicated input enters the pair through
:meth:`TensorParallel.copy_in` (identity forward, SUM over the model group
backward) and the consumer's partial output leaves it through
:meth:`TensorParallel.reduce` (SUM forward, identity backward), after which
the consumer's bias is added once. A replicated tensor used inside a pair
(the attention's relative-position tables, shared by every head; the
WaveNet's ``res_skip`` weights and speaker conditioning) enters through
``copy_in`` too, so its gradient is summed over the group and every rank
holds the whole of it.

What splits its compute, and how:

* the encoder's attention: q/k/v by heads (``MODEL_AXIS`` on the out
  columns), then ``out_proj`` on the rank's rows; kernels A and 4 run on the
  rank's heads;
* the encoder's FFN: ``conv_1``'s out channels, then ``conv_2``'s in rows;
* every WaveNet (flow, posterior): ``in_layers.*`` by the rank's share of each
  gate half (tanh's and sigmoid's channels of one set of hidden units), then
  the ``res_skip`` layers on those units' rows;
* the decoder: ``conv_pre``'s out channels, then ``upsampler.0``'s in rows;
  each ``upsampler.i``, i >= 1, on the rank's in rows of the whole activation.

What splits only at rest (:meth:`TensorParallel.gather`, one flat SUM of
zero-filled slices a forward, the gradient's slice back to its owner): the
decoder's resblocks (kernel 5 fuses every conv of a trio, so a split would
put a collective between its convs), the posterior encoder's ``conv_pre``
(its consumer, the WaveNet, is not row-split), and an attention or gate whose
heads or halves do not divide over the group.

The collectives are ``all_reduce`` only, over flat fp32 buffers, so they run
over NCCL and over gloo (which carries CUDA tensors only for ``all_reduce``
and ``broadcast``).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch
import torch.distributed as dist

from vits_tpu_torch.parallel.mesh import (
    ModelParallel,
    Split,
    all_reduce_,
    shard_index,
    split_plan,
)


def _sum_over(group, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """SUM each tensor over ``group``, in one fp32 collective; new tensors, each
    in its own dtype."""
    flat = [t.detach().float().contiguous().clone() for t in tensors]
    all_reduce_(flat, group)
    return [f.to(t.dtype) for f, t in zip(flat, tensors)]


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_sum_over(ctx.group, list(grads)))


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        return _sum_over(group, [t])[0]

    @staticmethod
    def backward(ctx, grad):
        return None, grad


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tp, names, *slices):
        ctx.tp, ctx.names = tp, names
        wholes = []
        for name, value in zip(names, slices):
            split = tp.plan[name]
            shape = list(value.shape)
            shape[split.dim] *= tp.size
            full = torch.zeros(shape, dtype=torch.float32, device=value.device)
            wholes.append(full.index_copy_(split.dim, tp.index(split, shape[split.dim],
                                                               value.device), value.float()))
        all_reduce_(wholes, tp.group)
        return tuple(w.to(v.dtype) for w, v in zip(wholes, slices))

    @staticmethod
    def backward(ctx, *grads):
        tp = ctx.tp
        out = []
        for name, g in zip(ctx.names, grads):
            split = tp.plan[name]
            out.append(g.index_select(split.dim, tp.index(split, g.shape[split.dim], g.device)))
        return (None, None, *out)


class TensorParallel(NamedTuple):
    """A rank's model axis and the split of the parameters over it
    (``parallel/mesh.py::split_plan`` of the whole parameters)."""

    axis: ModelParallel
    plan: Mapping[str, Split]

    @property
    def size(self) -> int:
        return self.axis.size

    @property
    def rank(self) -> int:
        return self.axis.rank

    @property
    def group(self):
        return self.axis.group

    def index(self, split: Split, n: int, device) -> torch.Tensor:
        """The rank's indices along ``split.dim`` of a whole length ``n``."""
        return torch.as_tensor(shard_index(split, n, self.size, self.rank), device=device)

    def channels(self, n: int) -> slice:
        """The rank's contiguous share of ``n`` channels."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def gate_channels(self, n: int, device) -> torch.Tensor:
        """The rank's channels of a gate's ``n`` (= 2 * hidden) outputs: its
        share of the tanh half, then the same of the sigmoid half."""
        return self.index(Split(0, gate=True), n, device)

    def copy_in(self, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Replicated tensors entering a split region: themselves forward, their
        gradients summed over the model group backward (one collective)."""
        return _CopyIn.apply(self.group, *tensors)

    def reduce(self, partial: torch.Tensor) -> torch.Tensor:
        """A row-split consumer's partial output summed over the model group
        (one collective); its gradient passes through unchanged."""
        return _Reduce.apply(self.group, partial)

    def gather(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """``params`` with every tensor that splits only at rest (``Split.whole``)
        gathered whole, differentiably: one collective; the others as they are."""
        names = tuple(n for n in params if n in self.plan and self.plan[n].whole)
        if not names:
            return dict(params)
        wholes = dict(zip(names, _Gather.apply(self, names, *(params[n] for n in names))))
        return {name: wholes.get(name, value) for name, value in params.items()}


def tensor_parallel(params: Mapping, axis: ModelParallel,
                    head_dim: int | None = None) -> TensorParallel:
    """The :class:`TensorParallel` of ``axis`` for the whole ``params`` (numpy or
    tensors: only their names and shapes are read); ``head_dim``: ``split_plan``'s."""
    if not dist.is_initialized() and axis.size > 1:
        raise ValueError("tensor parallelism needs a process group")
    return TensorParallel(axis, split_plan(params, axis.size, head_dim))
