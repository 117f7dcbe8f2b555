"""Piecewise rational-quadratic spline flow, vectorized and maskable.

Counterpart of ``vits_tpu/ops/spline.py``: the spline is evaluated at every
position on clamped inputs and the identity branch outside
[-tail_bound, tail_bound] is selected with ``torch.where`` (static shapes, no
compaction). Both directions return ``(outputs, log_abs_det)``. On bf16
tensors (bf16 serving) every op runs in bf16, as the JAX spline's do at
``compute_dtype="bfloat16"``: the bins, the cumulative sums, the bin search
and the root solve; each Python constant is rounded to bf16 first, as JAX
applies a weakly typed scalar (``ops/conv.py::weak_scalar``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vits_tpu_torch.ops.conv import softmax, softplus, weak_scalar


def unconstrained_rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    *,
    reverse: bool,
    tail_bound: float = 5.0,
    min_bin_width: float = 1e-3,
    min_bin_height: float = 1e-3,
    min_derivative: float = 1e-3,
):
    """inputs: (...,); unnormalized_*: (..., num_bins[-1 for derivatives]).

    Identity (log-det 0) outside [-tail_bound, tail_bound].
    """
    inside = (inputs >= -tail_bound) & (inputs <= tail_bound)
    constant = math.log(math.exp(1 - min_derivative) - 1)
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)
    clamped = torch.clamp(inputs, -tail_bound, tail_bound)
    spline_out, spline_logdet = rational_quadratic_spline(
        clamped,
        unnormalized_widths,
        unnormalized_heights,
        unnormalized_derivatives,
        reverse=reverse,
        tail_bound=tail_bound,
        min_bin_width=min_bin_width,
        min_bin_height=min_bin_height,
        min_derivative=min_derivative,
    )
    outputs = torch.where(inside, spline_out, inputs)
    log_abs_det = torch.where(inside, spline_logdet, torch.zeros_like(spline_logdet))
    return outputs, log_abs_det


def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the last axis; on bf16 each partial sum rounded to
    bf16 in order, as JAX's bf16 cumsum adds (PyTorch's sums in fp32)."""
    if x.dtype != torch.bfloat16:
        return torch.cumsum(x, dim=-1)
    sums = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        sums.append(sums[-1] + x[..., i])
    return torch.stack(sums, dim=-1)


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    *,
    reverse: bool,
    tail_bound: float,
    min_bin_width: float = 1e-3,
    min_bin_height: float = 1e-3,
    min_derivative: float = 1e-3,
):
    upper_bound = tail_bound
    lower_bound = -tail_bound
    num_bins = unnormalized_widths.shape[-1]
    if min_bin_width * num_bins > 1.0:
        raise ValueError(f"min_bin_width {min_bin_width} too large for {num_bins} bins")
    if min_bin_height * num_bins > 1.0:
        raise ValueError(f"min_bin_height {min_bin_height} too large for {num_bins} bins")

    def _cumulative(unnormalized, min_bin):
        fracs = softmax(unnormalized)
        fracs = (weak_scalar(min_bin, fracs)
                 + weak_scalar(1 - min_bin * num_bins, fracs) * fracs)
        cum = F.pad(_cumsum(fracs), (1, 0))
        cum = (upper_bound - lower_bound) * cum + lower_bound
        cum[..., 0] = lower_bound
        cum[..., -1] = upper_bound
        return cum, cum[..., 1:] - cum[..., :-1]

    cumwidths, widths = _cumulative(unnormalized_widths, min_bin_width)
    cumheights, heights = _cumulative(unnormalized_heights, min_bin_height)
    derivatives = (weak_scalar(min_derivative, unnormalized_derivatives)
                   + softplus(unnormalized_derivatives))

    bin_locations = (cumheights if reverse else cumwidths).clone()
    bin_locations[..., -1] += weak_scalar(1e-6, bin_locations)
    bin_idx = torch.sum(inputs[..., None] >= bin_locations, dim=-1) - 1
    bin_idx = torch.clamp(bin_idx, 0, num_bins - 1)[..., None]

    def gather(t):
        return torch.gather(t, -1, bin_idx)[..., 0]

    input_cumwidths = gather(cumwidths)
    input_bin_widths = gather(widths)
    input_cumheights = gather(cumheights)
    delta = heights / widths
    input_delta = gather(delta)
    input_derivatives = gather(derivatives)
    input_derivatives_plus_one = gather(derivatives[..., 1:])
    input_heights = gather(heights)

    intermediate1 = input_derivatives + input_derivatives_plus_one - 2 * input_delta
    if not reverse:
        theta = (inputs - input_cumwidths) / input_bin_widths
        theta_one_minus_theta = theta * (1 - theta)
        numerator = input_heights * (
            input_delta * theta**2 + input_derivatives * theta_one_minus_theta
        )
        denominator = input_delta + intermediate1 * theta_one_minus_theta
        outputs = input_cumheights + numerator / denominator
        derivative_numerator = input_delta**2 * (
            input_derivatives_plus_one * theta**2
            + 2 * input_delta * theta_one_minus_theta
            + input_derivatives * (1 - theta) ** 2
        )
        log_abs_det = torch.log(derivative_numerator) - 2 * torch.log(denominator)
        return outputs, log_abs_det

    intermediate2 = inputs - input_cumheights
    intermediate3 = intermediate2 * intermediate1
    a = input_heights * (input_delta - input_derivatives) + intermediate3
    b = input_heights * input_derivatives - intermediate3
    c = -input_delta * intermediate2
    discriminant = torch.clamp(b**2 - 4 * a * c, min=0.0)
    root = (2 * c) / (-b - torch.sqrt(discriminant))
    outputs = root * input_bin_widths + input_cumwidths
    theta_one_minus_theta = root * (1 - root)
    denominator = input_delta + intermediate1 * theta_one_minus_theta
    derivative_numerator = input_delta**2 * (
        input_derivatives_plus_one * root**2
        + 2 * input_delta * theta_one_minus_theta
        + input_derivatives * (1 - root) ** 2
    )
    log_abs_det = torch.log(derivative_numerator) - 2 * torch.log(denominator)
    return outputs, -log_abs_det
