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
) -> torch.Tensor:
    """torch ConvTranspose1d(stride, padding).

    kernel: (k, C_in, C_out), spatially reversed at load: kernel[t, i, o] =
    W_torch[i, o, k-1-t]. Output length (T-1)*stride + k - 2*padding.
    """
    weight = kernel.flip(0).permute(1, 2, 0)  # back to torch's (C_in, C_out, k)
    out = F.conv_transpose1d(x.transpose(1, 2), weight, stride=stride,
                             padding=padding).transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing (channel) axis."""
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    """On a bf16 tensor the slope is a bf16 constant, as JAX multiplies a bf16
    array by a weakly typed Python float."""
    if x.dtype == torch.bfloat16:
        slope = float(torch.tensor(slope, dtype=torch.bfloat16))
    return torch.where(x >= 0, x, x * slope)
