"""1-D conv primitives in (batch, time, channels) layout.

Counterpart of ``vits_tpu/ops/conv.py``. The public functions keep the JAX
package's layouts -- activations ``(B, T, C)``, conv kernels ``(k, C_in/groups,
C_out)``, conv-transpose kernels ``(k, C_in, C_out)`` spatially reversed at
load (``vits_tpu/io/params.py``) -- so the parity tests compare like with
like and the CUDA kernels read the same weights. Inside, each op hands
PyTorch's own conv a channels-first view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int = 1,
    padding: int | tuple[int, int] = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """torch Conv1d semantics. x: (B, T, C_in), kernel: (k, C_in/groups, C_out)."""
    if isinstance(padding, int):
        padding = (padding, padding)
    k = kernel.shape[0]
    if k == 1 and stride == 1 and dilation == 1 and groups == 1 and padding == (0, 0):
        out = x @ kernel[0]
    else:
        xt = F.pad(x.transpose(1, 2), padding)
        out = F.conv1d(xt, kernel.permute(2, 1, 0), stride=stride,
                       dilation=dilation, groups=groups).transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out


def depthwise_conv1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    padding: int = 0,
    dilation: int = 1,
) -> torch.Tensor:
    """Depthwise conv (groups == channels). kernel: (k, 1, C)."""
    return conv1d(x, kernel, bias, padding=padding, dilation=dilation, groups=x.shape[-1])


def conv_transpose1d(
    x: torch.Tensor,
    kernel: torch.Tensor,
    bias: torch.Tensor | None = None,
    *,
    stride: int,
    padding: int = 0,
    method: str | None = None,
) -> torch.Tensor:
    """torch ConvTranspose1d(stride, padding).

    kernel: (k, C_in, C_out), spatially reversed at load: kernel[t, i, o] =
    W_torch[i, o, k-1-t]. Output length (T-1)*stride + k - 2*padding.

    bf16 on the CPU runs it as the direct conv it equals (``kernel`` over x
    with ``stride - 1`` zeros between steps, padded by k-1-padding): oneDNN's
    bf16 ConvTranspose1d gives a wrong input gradient on the CPU (relative
    error ~1 against fp32, PyTorch 2.x).

    ``method="phases"`` (k % stride == 0, 2 * padding == k - stride) is the JAX
    package's per-phase form (``vits_tpu/ops/conv.py::_conv_transpose_phases``),
    which its decoder runs: output step t * stride + sigma sums k / stride tap
    products, each a matmul of its own; in bf16 each product and each partial
    sum is rounded to bf16, as there.
    """
    if method == "phases":
        return _conv_transpose_phases(x, kernel, bias, stride, padding)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        B, T, C = x.shape
        stuffed = x.new_zeros((B, (T - 1) * stride + 1, C))
        stuffed[:, ::stride] = x
        return conv1d(stuffed, kernel, bias, padding=kernel.shape[0] - 1 - padding)
    weight = kernel.flip(0).permute(1, 2, 0)  # back to torch's (C_in, C_out, k)
    out = F.conv_transpose1d(x.transpose(1, 2), weight, stride=stride,
                             padding=padding).transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out


def _conv_transpose_phases(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor | None,
                           stride: int, padding: int) -> torch.Tensor:
    k, _, c_out = kernel.shape
    r = k // stride
    if r * stride != k or 2 * padding != k - stride:
        raise ValueError(f"phases need k % stride == 0 and 2 * padding == k - stride "
                         f"(k {k}, stride {stride}, padding {padding})")
    B, T, _ = x.shape
    xp = F.pad(x, (0, 0, r - 1, r))
    T2 = T + r
    products = torch.einsum("btc,kcd->btkd", xp, kernel)  # every tap's product, one matmul
    phases = []
    for sigma in range(stride):
        acc = None
        for g in range(r):  # the loaded layout is spatially reversed: tap tau is k - 1 - tau
            term = products[:, r - 1 - g: r - 1 - g + T2, k - 1 - (g * stride + sigma)]
            acc = term if acc is None else acc + term
        phases.append(acc)
    y = torch.stack(phases, dim=2).reshape(B, T2 * stride, c_out)[:, padding: padding + T * stride]
    return y if bias is None else y + bias


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing (channel) axis. On bf16 in the JAX package's
    steps (``vits_tpu/ops/conv.py::layer_norm``), each rounded to bf16 as its
    bf16 training computes them."""
    if x.dtype == torch.bfloat16:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
        # rsqrt in fp32, rounded once: PyTorch's bf16 rsqrt on the CPU is not
        # correctly rounded (4% of values off by an ulp)
        inv = torch.rsqrt((var + weak_scalar(eps, x)).float()).to(x.dtype)
        return (x - mean) * inv * weight + bias
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def weak_scalar(c: float, like: torch.Tensor) -> float:
    """A Python float as JAX applies it to an array of ``like``'s dtype: weakly
    typed, it takes the array's dtype, so on bf16 it is rounded to bf16 first
    (PyTorch would apply the full-precision scalar)."""
    return float(torch.tensor(c, dtype=torch.bfloat16)) if like.dtype == torch.bfloat16 else c


# Activations on bf16 as eager JAX computes them on bf16 arrays: op by op, each
# step rounded to bf16 (PyTorch's own bf16 kernels compute in fp32 and round
# once). On other dtypes PyTorch's.


def softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis (``jax.nn.softmax``: exp(x - max) / sum)."""
    if x.dtype != torch.bfloat16:
        return torch.softmax(x, dim=-1)
    e = torch.exp(x - x.amax(dim=-1, keepdim=True).detach())
    return e / e.sum(dim=-1, keepdim=True)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) (``jax.nn.softplus``: max(x, 0) + log1p(exp(-|x|)))."""
    if x.dtype != torch.bfloat16:
        return F.softplus(x)
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """1 / (1 + e^-x) (``jax.nn.sigmoid``)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The exact (erf) GELU (``jax.nn.gelu(approximate=False)``: 0.5 x erfc(-x / sqrt 2))."""
    if x.dtype != torch.bfloat16:
        return F.gelu(x)
    return (0.5 * x) * torch.erfc(-x * weak_scalar(0.5 ** 0.5, x))


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """On a bf16 tensor the slope is a bf16 constant (:func:`weak_scalar`)."""
    return torch.where(x >= 0, x, x * weak_scalar(slope, x))
