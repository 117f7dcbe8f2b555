"""Per-stage Pallas precision specs.

``pallas_precision`` everywhere accepts either one tier name or a
comma-joined PER-VOCODER-STAGE spec:

    None        -> fast single-pass bf16 multiplies (fp32 accumulation)
    "high"      -> 3-pass bf16x3 multiplies
    "highest"   -> 6-pass fp32-exact multiplies
    "high,high,highest,highest"
                -> vocoder stages 0-1 at 3-pass, stages 2-3 at 6-pass

The comma form exists because single-pass bf16 error is not uniform across
the vocoder: the round-5 per-stage attribution (BENCH_DETAIL
``stage_precision_r5``) shows which stages actually need the multi-pass
multiplies, and a mixed spec buys <1e-3 mel-L1 well under the uniform
"highest" tier's cost.  A spec string stays hashable/static under jit and
rides every existing plumbing path (EngineConfig, CLI, server) unchanged.

Stages beyond the spec's length reuse its last entry, so "high,highest" on a
4-stage vocoder means stage 0 at 3-pass and stages 1-3 at 6-pass.
Single-knob consumers (attention/flow kernels, which have no stage axis)
collapse a spec with :func:`reduce_precision` — the STRONGEST tier named,
the conservative choice for fidelity.
"""

from __future__ import annotations

from typing import Optional

_ALIASES = {"": None, "fast": None, "none": None, "default": None}
_ORDER = {None: 0, "high": 1, "highest": 2, "float32": 2}


def _canon(name: Optional[str]) -> Optional[str]:
    if name is None:
        return None
    name = name.strip().lower()
    return _ALIASES.get(name, name)


def stage_precision(spec: Optional[str], stage: int) -> Optional[str]:
    """Tier for vocoder ``stage`` under ``spec`` (scalar or comma-joined)."""
    if spec is None or "," not in spec:
        return _canon(spec)
    parts = spec.split(",")
    return _canon(parts[min(stage, len(parts) - 1)])


def reduce_precision(spec: Optional[str]) -> Optional[str]:
    """Collapse a spec to one tier for consumers without a stage axis.

    Returns the strongest tier named in the spec (unknown names rank as
    "highest" — jax itself treats e.g. "float32" as HIGHEST).
    """
    if spec is None or "," not in spec:
        return _canon(spec)
    best: Optional[str] = None
    for part in spec.split(","):
        p = _canon(part)
        if _ORDER.get(p, 2) > _ORDER.get(best, 0) or best is None:
            best = p
    return best
