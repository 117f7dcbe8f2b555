"""The precision tiers of the port's kernels, and their plain PyTorch emulation.

Counterpart of ``vits_tpu/ops/pallas/__init__.py``'s ``resolve_precision`` and
``kernel_dot``: a kernel's products run at one of three tiers, named as the
JAX package's ``pallas_precision`` names them, and its values are carried in
fp32 or bf16 (``pallas_value_dtype``).

=============  ==============================  ===================================
tier           JAX on the TPU                  the port (``mode``, ``csrc/common.cuh``)
=============  ==============================  ===================================
None, "fast"   one bf16 MXU pass, fp32 sums    FAST: both operands rounded to bf16,
                                               products exact, fp32 sums
"high"         bf16x3: hi = bf16(x),           HIGH: the same split, three bf16
               lo = bf16(x - hi),              passes (``mma.sync`` bf16 in B's
               hi*hi + hi*lo + lo*hi           conv, tf32 MMAs of bf16 values or
                                               FFMA elsewhere)
"highest"      six-pass fp32                   EXACT: 3xTF32 / fp32 FFMA
=============  ==============================  ===================================

With bf16 values every operand a vocoder kernel multiplies is a bf16 value
(its weights are cast to bf16, or are int8), so every tier's products are
exact and its sums fp32: :func:`resolve_tier` maps bf16 values to FAST
whatever the precision, and the kernel then also rounds its value carry to
bf16 where the JAX kernel casts to its value dtype (``Tier.bf16_values``).

bf16 serving (``EngineConfig.compute_dtype="bfloat16"``, :meth:`Tiers.bf16_compute`)
is a mode of its own, never inferred from a tensor's dtype (the ``fast`` tier also
hands the vocoder kernels a bf16 carry): ``Tier.bf16_compute``. The vocoder
kernels B, C and 7 then compute XLA's bf16 graph of the plain stage, which the
JAX package runs at bf16 (:data:`BF16_COMPUTE_TIER`: bf16 in and out, a rounding
to bf16 after every op); kernels A and 6 take and give bf16 at their tier,
staging fp32 as the JAX kernels do.

The plain helpers (:func:`round_bf16`, :func:`tier_product`) emulate a tier
on tensors; the kernels' plain twins use them, on the CPU and as the card's
reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from vits_tpu_torch.ops.conv import conv1d, conv_transpose1d
from vits_tpu_torch.ops.precision import reduce_precision, stage_precision

EXACT, FAST, HIGH = 0, 1, 2  # the kernels' tier modes (csrc/common.cuh TierMode)
MODE_NAMES = {EXACT: "highest", FAST: "fast", HIGH: "high"}


class Tier(NamedTuple):
    """One kernel call's arithmetic: the tier's mode, the value carry, and the
    bf16 serving mode (bf16 in and out; B, C and 7: XLA's bf16 graph)."""

    mode: int = EXACT
    bf16_values: bool = False
    bf16_compute: bool = False

    @property
    def name(self) -> str:
        if self.bf16_compute:
            return MODE_NAMES[self.mode] + " (bf16 compute)"
        return MODE_NAMES[self.mode] + (" (bf16 values)" if self.bf16_values else "")

    @property
    def value_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16_values or self.bf16_compute else torch.float32


EXACT_TIER = Tier()


def _dtype(value_dtype) -> torch.dtype:
    if value_dtype is None:
        return torch.float32
    if isinstance(value_dtype, torch.dtype):
        return value_dtype
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[str(value_dtype)]


def resolve_tier(precision: str | None, value_dtype=None) -> Tier:
    """A kernel's tier from one JAX ``pallas_precision`` name and its value dtype.

    ``precision``: None, "fast" or "default" (one bf16 pass), "high" (bf16x3),
    "highest" or "float32" (fp32); a per-stage comma spec must be resolved
    first (:func:`vits_tpu_torch.ops.precision.stage_precision`).
    ``value_dtype``: "float32" (None) or "bfloat16", a name or a torch dtype.
    """
    if _dtype(value_dtype) == torch.bfloat16:
        return Tier(FAST, True)
    if precision is not None and "," in precision:
        raise ValueError(f"a per-stage spec {precision!r} names several tiers: resolve a stage")
    name = stage_precision(precision, 0)
    if name is None or name in ("bfloat16", "fastest"):
        return Tier(FAST, False)
    if name == "high":
        return Tier(HIGH, False)
    if name in ("highest", "float32"):
        return Tier(EXACT, False)
    raise ValueError(f"unknown kernel precision {precision!r}")


class Tiers(NamedTuple):
    """The tiers of one engine's kernels, as the JAX engine passes its fields.

    ``vocoder``: the ``pallas_precision`` spec of the vocoder kernels (a tier
    or a per-stage comma spec); ``value_dtype`` their value dtype;
    ``attention`` and ``flow`` the tiers of kernels A and 6 (the JAX models
    pass them ``reduce_precision(pallas_precision)``). The default is the
    exact tier everywhere: fp32, what the plain PyTorch modules compute.
    """

    vocoder: str | None = "highest"
    value_dtype: torch.dtype = torch.float32
    attention: Tier = EXACT_TIER
    flow: Tier = EXACT_TIER
    compute_dtype: torch.dtype = torch.float32

    def stage(self, i: int) -> Tier:
        """Vocoder stage i's tier."""
        if self.compute_dtype == torch.bfloat16:
            return BF16_COMPUTE_TIER
        return resolve_tier(stage_precision(self.vocoder, i), self.value_dtype)

    @classmethod
    def of(cls, precision: str | None, value_dtype=None, *, vocoder: bool = True,
           attention: bool = True, flow: bool = True) -> "Tiers":
        """Every kernel at ``precision`` (a tier or a per-stage spec), as the
        JAX models take it; a kernel whose flag is off stays exact."""
        single = resolve_tier(reduce_precision(precision))
        return cls(
            vocoder=precision if vocoder else "highest",
            value_dtype=_dtype(value_dtype) if vocoder else torch.float32,
            attention=single if attention else EXACT_TIER,
            flow=single if flow else EXACT_TIER,
        )


    @classmethod
    def bf16_compute(cls, precision: str | None, *, attention: bool = True,
                     flow: bool = True) -> "Tiers":
        """bf16 serving, as the JAX engine runs ``compute_dtype="bfloat16"``: its
        vocoder kernels are off (no value dtype, a bf16 carry), so every stage
        is XLA's bf16 graph (:data:`BF16_COMPUTE_TIER` whatever ``precision``:
        each product is of bf16 values); kernel A (``attention``) and kernel 6
        take bf16 at the tier of ``precision`` (collapsed), as the JAX kernels
        take bf16 inputs. With ``attention`` off the encoder runs the module's
        bf16 graph (the JAX CPU engine's default); kernel 6 runs only under
        ``use_pallas_flow``, at the exact tier when ``flow`` is off."""
        single = resolve_tier(reduce_precision(precision))
        return cls(
            vocoder=precision, value_dtype=torch.bfloat16,
            attention=single._replace(bf16_compute=True) if attention else EXACT_TIER,
            flow=(single if flow else EXACT_TIER)._replace(bf16_compute=True),
            compute_dtype=torch.bfloat16)


EXACT_TIERS = Tiers()
BF16_TRAIN_TIER = Tier(FAST, True)
BF16_COMPUTE_TIER = Tier(FAST, True, True)  # bf16 serving's vocoder kernels
TRAIN_TIERS = (EXACT_TIER, BF16_TRAIN_TIER)  # the tiers the training kernels 4 and 5 are built for


def training_tiers(compute_dtype: torch.dtype) -> Tiers:
    """The tiers of the training kernels (A with lse, 4, 5) for a step's compute
    dtype: fp32 the exact tier everywhere (what the JAX package computes on the
    CPU); bf16 the fast tier with bf16 values, as the JAX kernels run at
    ``precision=None`` on bf16 inputs (:data:`BF16_TRAIN_TIER`: bf16 storage,
    bf16 products, fp32 sums)."""
    if compute_dtype == torch.bfloat16:
        return Tiers(vocoder="fast", value_dtype=torch.bfloat16, attention=BF16_TRAIN_TIER)
    if compute_dtype == torch.float32:
        return EXACT_TIERS
    raise ValueError(f"training compute dtype {compute_dtype}: float32 or bfloat16")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (to nearest even), in ``t``'s dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def split_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16x3 split: hi = bf16(t), lo = bf16(t - hi), both fp32 tensors."""
    hi = round_bf16(t)
    return hi, round_bf16(t - hi)


def tier_product(op: Callable, a: torch.Tensor, b: torch.Tensor, tier: Tier) -> torch.Tensor:
    """``op(a, b)`` (bilinear: a matmul, a conv) in fp32 at ``tier``'s arithmetic.

    EXACT: op in fp32. FAST: op on bf16-rounded operands (products exact,
    sums fp32). HIGH: ``kernel_dot``'s bf16x3, op(hi, hi) + op(hi, lo) +
    op(lo, hi).
    """
    a, b = a.float(), b.float()
    if tier.mode == EXACT:
        return op(a, b)
    if tier.mode == FAST:
        return op(round_bf16(a), round_bf16(b))
    a_hi, a_lo = split_bf16(a)
    b_hi, b_lo = split_bf16(b)
    return op(a_hi, b_hi) + op(a_hi, b_lo) + op(a_lo, b_hi)


def tier_matmul(a: torch.Tensor, b: torch.Tensor, tier: Tier) -> torch.Tensor:
    """``a @ b`` at ``tier``."""
    return tier_product(torch.matmul, a, b, tier)


def carry(t: torch.Tensor, tier: Tier) -> torch.Tensor:
    """A kernel's value carry: rounded to bf16 with bf16 values, else as it is."""
    return round_bf16(t) if tier.bf16_values else t


def carry_slope(slope: float, tier: Tier) -> float:
    """The leaky slope applied to the value carry: with bf16 values a bf16
    constant (the JAX kernels' ``_leaky`` multiplies a bf16 array by a weakly
    typed Python float, in bf16), else the fp32 slope."""
    return float(torch.tensor(slope, dtype=torch.bfloat16)) if tier.bf16_values else slope


def tier_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, tier: Tier,
                scale: torch.Tensor | None = None, **kw) -> torch.Tensor:
    """``conv1d(x, w) (* scale) + b`` at ``tier``; ``w`` in any format (int8
    with its per-out-channel ``scale``, applied to the sum before the bias, as
    the JAX kernels apply it). fp32 weights at the exact tier are plain ``conv1d``."""
    if tier.mode == EXACT and scale is None and w.dtype == torch.float32:
        return conv1d(x, w, b, **kw)
    y = tier_product(lambda a, k: conv1d(a, k, None, **kw), x, w, tier)
    if scale is not None:
        y = y * scale
    return y if b is None else y + b


def tier_conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, tier: Tier,
                          scale: torch.Tensor | None = None, **kw) -> torch.Tensor:
    """``conv_transpose1d`` as :func:`tier_conv1d` computes ``conv1d``."""
    if tier.mode == EXACT and scale is None and w.dtype == torch.float32:
        return conv_transpose1d(x, w, b, **kw)
    y = tier_product(lambda a, k: conv_transpose1d(a, k, None, **kw), x, w, tier)
    if scale is not None:
        y = y * scale
    return y if b is None else y + b


WEIGHT_FORMATS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # csrc WeightFormat


def weight_format(w: torch.Tensor) -> int:
    """The kernels' WeightFormat of a weight tensor; raises on other dtypes."""
    try:
        return WEIGHT_FORMATS[w.dtype]
    except KeyError:
        raise ValueError(f"weights of dtype {w.dtype}: the kernels take float32, bfloat16 "
                         "or int8 (with scales)") from None
