"""The port's Monotonic Alignment Search against the JAX package's, on the CPU.

Identical seeded numpy inputs go through ``vits_tpu.ops.align.monotonic_align``
(two ``lax.scan``s) and the port's ``monotonic_align`` on CPU tensors (its
plain twin, the loop that the CUDA kernel ``csrc/align.cu`` is held equal to on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``). The two do the
same fp32 add and compare per cell, so the alignments must be equal. The
choice-storage rule of the kernel (shared memory or device scratch) is pure
Python and is pinned here with its byte counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vits_tpu.ops import align as jax_align
from vits_tpu_torch.ops import align
from vits_tpu_torch.ops.cuda import align as cuda_align


# jitted: one compile a shape (eagerly each op around the scans compiles on its own)
_jax_align = jax.jit(jax_align.monotonic_align)

# ops/cuda/align.py's MAS_CASES up to the training shape (the rest are the card's)
_CPU_CASES = list(cuda_align.MAS_CASES)[:list(cuda_align.MAS_CASES).index("training") + 1]


@pytest.mark.parametrize("case", sorted(_CPU_CASES))
def test_alignment_equals_jax(case):
    ll, fmask, tmask = cuda_align.mas_case(case)
    want = np.asarray(_jax_align(jnp.asarray(ll), jnp.asarray(fmask), jnp.asarray(tmask)))
    got = align.monotonic_align(torch.tensor(ll), torch.tensor(fmask), torch.tensor(tmask))
    assert got.dtype == torch.float32 and got.shape == ll.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # each valid frame on exactly one valid token
    np.testing.assert_array_equal(got.sum(dim=2).numpy(), fmask * (tmask.sum(1) > 0)[:, None])


def test_the_step_goes_through_the_wrapper():
    from vits_tpu_torch.train import step

    assert align.monotonic_align is cuda_align.monotonic_align
    assert step.monotonic_align is cuda_align.monotonic_align


def test_wrapper_never_takes_the_loop_off_the_cpu():
    """A tensor on another device than the CPU launches the kernel or raises;
    here (no card) a device that is neither raises, and nothing is counted."""
    before = cuda_align.monotonic_align.launches
    ll = torch.zeros((1, 4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        cuda_align.monotonic_align(ll, torch.ones((1, 4), device="meta"),
                                   torch.ones((1, 3), device="meta"))
    with pytest.raises(ValueError, match="several devices"):
        cuda_align.monotonic_align(torch.zeros((1, 4, 3)), torch.ones((1, 4), device="meta"),
                                   torch.ones((1, 3)))
    assert cuda_align.monotonic_align.launches == before


# (S, T) -> threads, values in registers, choice bytes, base bytes, choices in shared memory
_REGISTER_BASE = 4 * (8 * 512 + 2 * 16) + 4360  # the ring, the exchange, the tail at 512
PLANS = {
    # the training shape: (1280 - 1) frames x 16 words x 4 bytes = 81,856 bytes of choices
    (1280, 512): (512, True, 81856, _REGISTER_BASE, True),
    # the last frame count whose choices fit beside the ring (232,392 bytes in all) ...
    (3306, 512): (512, True, 211520, _REGISTER_BASE, True),
    # ... and the first that does not (232,456): mas_generic, its choices still shared
    (3307, 512): (512, False, 211584, 4360, True),
    # the last that fits beside mas_generic's 4,360 bytes (232,392) and the first that not
    (3564, 512): (512, False, 228032, 4360, True),
    (3565, 512): (512, False, 228096, 4360, False),
    # 2999 x 22 x 4 = 263,912 bytes: past the 232,448 a block may have, device scratch
    (3000, 700): (704, False, 263912, 4360, False),
    (1, 1): (32, True, 0, 4 * (8 * 32 + 2) + 4360, True),
    # mas_kernel's widest block, then past it the values in device scratch
    (640, 1024): (1024, True, 639 * 32 * 4, 4 * (8 * 1024 + 2 * 32) + 4360, True),
    (200, 1025): (1024, False, 199 * 33 * 4, 4360, True),
    (40, 4097): (1024, False, 39 * 129 * 4, 4360, True),
    (2000, 20000): (1024, False, 1999 * 625 * 4, 4360, False),
}


@pytest.mark.parametrize("shape", list(PLANS), ids=lambda s: f"S{s[0]}-T{s[1]}")
def test_choice_storage_rule(shape):
    plan = cuda_align.mas_plan(*shape)
    assert (plan.threads, plan.registers, plan.choice_bytes, plan.base_bytes,
            plan.choices_shared) == PLANS[shape]
    assert plan.choices_shared == (plan.base_bytes + plan.choice_bytes <= 232448)
    assert plan.base_bytes + plan.choice_bytes * plan.choices_shared <= 232448
    # mas_kernel: a thread a token, its choices in shared memory
    assert not plan.registers or (plan.threads >= shape[1] and plan.choices_shared)
    assert plan.threads % 32 == 0 and plan.threads <= 1024


def test_plan_refuses_an_empty_alignment():
    with pytest.raises(ValueError, match="S=0"):
        cuda_align.mas_plan(0, 5)
