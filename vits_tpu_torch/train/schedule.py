"""Optimizer, learning-rate schedule and parameter EMA of VITS training.

Counterpart of ``vits_tpu/train/schedule.py``, matched to its optax chain:
``clip_by_global_norm(500)`` (no epsilon: ``torch.nn.utils.clip_grad_norm_``
adds 1e-6), then ``adamw(b1=0.8, b2=0.99, eps=1e-9, weight_decay=1e-4)``
(torch's AdamW default decay is 1e-2) at the per-step rate
``base_lr * (gamma ** (1 / steps_per_epoch)) ** count``, count 0 on the first
update. The EMA warms its decay up as ``min(decay, (1 + t) / (10 + t))``.

ZeRO-1 (``zero1=`` a ``parallel/mesh.py::DataParallel``): each parameter
tensor has one owner rank (``zero1_owners``, balanced by size), and a rank's
AdamW holds moments only for the tensors it owns, about 1/world of the
optimizer state. Every rank clips on the whole (already summed) gradient,
steps its own tensors and broadcasts them, one coalesced broadcast per owner
per step; the update is the replicated optimizer's, bit for bit. JAX splits
each moment along a dimension instead (``vits_tpu/parallel/mesh.py::
opt_state_shardings``); ownership by tensor needs only ``broadcast``, which
gloo has for CUDA tensors too. ``torch.distributed.optim.
ZeroRedundancyOptimizer`` does the same split, but its state gathers through
pickled objects indexed by parameter position; this keeps the checkpoint's
by-name moments, so a state saved under ZeRO-1 loads without it and the other
way round. With a model axis ZeRO-1 splits over the data group; with a slice
axis over the data ranks of the rank's slice alone (``DataParallel.in_slice``,
JAX's split over 'data'), so each slice keeps a whole copy of the moments and
the broadcasts stay inside the slice.

Tensor parallel (``model_parallel=``, a ``parallel/tensor.py::
TensorParallel``): the parameters are the rank's slices and so are their
moments. The clip's norm is the global gradient's: the squares of the split
tensors summed over the model group, each replicated tensor counted once, so
every rank clips by one scale. The state arrays gather whole moments under
their names (a collective over the model group) and load back into slices,
so a state saved at ``model=2`` loads at ``model=1`` and the other way round.
Parameters may lie on several devices (a pipeline's stages): the norm is
summed on the first one's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

import torch.distributed as dist

from vits_tpu_torch.parallel.mesh import (
    DataParallel,
    all_reduce_,
    broadcast_,
    gather_params,
    take_shards,
    zero1_owners,
)
from vits_tpu_torch.parallel.tensor import TensorParallel


class VitsOptimizer:
    """The VITS AdamW recipe over a flat dict of parameters (updated in place).

    ``step()`` reads each parameter's ``.grad``, as ``torch.optim`` does.
    ``zero1``: this rank's place on the data axis; it keeps the moments of the
    tensors it owns. ``model_parallel``: ``params`` are the rank's slices
    (module docstring).
    """

    def __init__(self, params: Mapping[str, torch.Tensor], base_lr: float = 2e-4,
                 steps_per_epoch: int = 1000, clip_norm: float | None = 500.0,
                 gamma_per_epoch: float = 0.999875, zero1: DataParallel | None = None,
                 model_parallel: TensorParallel | None = None):
        self.names = list(params)
        self.tp = model_parallel
        # the tensors whose gradients are slices, summed over the model group in the norm
        self.split = [model_parallel is not None and n in model_parallel.plan
                      for n in self.names]
        self.params = list(params.values())
        self.base_lr = base_lr
        self.per_step = gamma_per_epoch ** (1.0 / steps_per_epoch)
        self.clip_norm = clip_norm
        self.count = 0  # completed updates
        # each tensor's owner on the slice's data axis (the whole data axis without a
        # slice axis); None: every rank steps every tensor
        self.shard = None if zero1 is None else zero1.in_slice
        self.owners = (None if self.shard is None or self.shard[0] == 1
                       else zero1_owners([p.numel() for p in self.params], self.shard[0]))
        self.adamw = torch.optim.AdamW([p for i, p in enumerate(self.params) if self.owns(i)],
                                       lr=base_lr, betas=(0.8, 0.99), eps=1e-9,
                                       weight_decay=1e-4)

    def owns(self, i: int) -> bool:
        """Whether this rank keeps the moments of (and steps) parameter ``i``."""
        return self.owners is None or self.owners[i] == self.shard[1]

    def _owned_by(self, rank: int) -> list[int]:
        return [i for i, owner in enumerate(self.owners) if owner == rank]

    def _owner_rank(self, rank: int) -> int:
        """The world rank of index ``rank`` of the slice's data axis (ZeRO-1's
        broadcast source)."""
        group = self.shard[2]
        return rank if group is None else dist.get_global_rank(group, rank)

    def learning_rate(self) -> float:
        return self.base_lr * self.per_step ** self.count

    def _moment_plan(self) -> dict:
        """The split of each moment's state array: its parameter's."""
        return {f"{name}.{key}": split for name, split in self.tp.plan.items()
                for key in ("exp_avg", "exp_avg_sq")}

    @torch.no_grad()
    def grad_norm(self) -> torch.Tensor:
        """The global L2 norm of the parameters' ``.grad`` (module docstring), on the
        first parameter's device."""
        device = self.params[0].device
        norms = torch.stack([torch.linalg.vector_norm(p.grad).to(device) for p in self.params])
        if self.tp is None:
            return torch.linalg.vector_norm(norms)
        split = torch.tensor(self.split, device=device)
        squares = torch.stack([(norms[split] ** 2).sum(), (norms[~split] ** 2).sum()])
        split_sq = squares[:1].clone()
        all_reduce_([split_sq], self.tp.group)
        return torch.sqrt(split_sq[0] + squares[1])

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for p in self.params]
        if self.clip_norm:
            norm = self.grad_norm()
            scale = torch.where(norm < self.clip_norm, 1.0, self.clip_norm / norm)
            for g in grads:
                g.mul_(scale.to(g.device))
        for group in self.adamw.param_groups:
            group["lr"] = self.learning_rate()
        self.adamw.step()
        self.count += 1
        if self.owners is not None:
            for rank in range(self.shard[0]):
                broadcast_([self.params[i] for i in self._owned_by(rank)],
                           self._owner_rank(rank), self.shard[2])

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Adam moments by parameter name, and the update count, as numpy.

        Under ZeRO-1 or a model axis a collective: every rank calls it, each
        owner broadcasts its moments, the slices of split tensors are gathered
        whole, and every rank returns all of them."""
        out = {"count": np.asarray(self.count, np.int64)}
        moments = {}
        for i, p in enumerate(self.params):
            state = self.adamw.state.get(p) if self.owns(i) else None
            if state:
                moments[i] = (state["exp_avg"], state["exp_avg_sq"])
        if self.owners is not None and self.count:
            for rank in range(self.shard[0]):
                owned = self._owned_by(rank)
                for i in owned:
                    moments.setdefault(i, (torch.empty_like(self.params[i]),
                                           torch.empty_like(self.params[i])))
                broadcast_([m for i in owned for m in moments[i]], self._owner_rank(rank),
                           self.shard[2])
        named = {f"{self.names[i]}.{key}": m for i, pair in sorted(moments.items())
                 for key, m in zip(("exp_avg", "exp_avg_sq"), pair)}
        if self.tp is not None and self.count:
            named = gather_params(named, self._moment_plan(), self.tp.axis)
        for key, m in named.items():
            out[key] = m.detach().cpu().numpy()
        return out

    def load_state_arrays(self, arrays: Mapping[str, np.ndarray]) -> None:
        """Inverse of :meth:`state_arrays` (under ZeRO-1 each rank keeps the
        moments it owns, under a model axis its slices); raises if a parameter
        is missing."""
        self.count = int(arrays["count"])
        if self.tp is not None:  # the rank's slices of the whole moments
            arrays = take_shards(arrays, self._moment_plan(), self.tp.axis)
        for i, (name, p) in enumerate(zip(self.names, self.params)):
            if self.count and f"{name}.exp_avg" not in arrays:
                raise ValueError(f"optimizer state lacks parameter {name!r}")
            if f"{name}.exp_avg" in arrays and self.owns(i):
                self.adamw.state[p] = {
                    "step": torch.tensor(float(self.count)),
                    "exp_avg": torch.tensor(arrays[f"{name}.exp_avg"], device=p.device),
                    "exp_avg_sq": torch.tensor(arrays[f"{name}.exp_avg_sq"], device=p.device),
                }


def vits_optimizer(params: Mapping[str, torch.Tensor], base_lr: float = 2e-4,
                   steps_per_epoch: int = 1000, clip_norm: float | None = 500.0,
                   zero1: DataParallel | None = None,
                   model_parallel: TensorParallel | None = None) -> VitsOptimizer:
    return VitsOptimizer(params, base_lr, steps_per_epoch, clip_norm, zero1=zero1,
                         model_parallel=model_parallel)


class ParamEMA:
    """Exponential moving average of a flat parameter dict (the serving weights)."""

    def __init__(self, decay: float = 0.9999, warmup: bool = True):
        self.decay = decay
        self.warmup = warmup

    def init(self, params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in params.items()}

    def decay_at(self, step: int) -> float:
        """Effective decay after ``step`` completed updates (0-based), in fp32."""
        d = np.float32(self.decay)
        if self.warmup:
            t = np.float32(step)
            d = min(d, (np.float32(1.0) + t) / (np.float32(10.0) + t))
        return float(d)

    @torch.no_grad()
    def update(self, ema_params: dict[str, torch.Tensor], new_params: Mapping[str, torch.Tensor],
               step: int | None = None) -> dict[str, torch.Tensor]:
        """One EMA step in place; ``step`` is the 0-based update count."""
        d = self.decay if step is None else self.decay_at(step)
        ema = list(ema_params.values())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, [new_params[k].detach() for k in ema_params],
                            alpha=float(np.float32(1.0) - np.float32(d)))
        return ema_params
