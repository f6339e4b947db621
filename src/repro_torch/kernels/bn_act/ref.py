"""Plain PyTorch version of the fused batch-norm + leaky-ReLU kernel.

The formula of ``repro.kernels.bn_act.ref`` in the kernel's arithmetic:
fp32 math whatever x's dtype, the result cast back to x's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bn_leaky_relu(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                  scale: torch.Tensor, bias: torch.Tensor, *,
                  eps: float = 1e-5,
                  negative_slope: float = 0.01) -> torch.Tensor:
    """x: (..., C); mean/var/scale/bias: (C,). ``negative_slope=1.0``
    is the identity."""
    a = torch.rsqrt(var.float() + eps) * scale.float()
    y = x.float() - mean.float()
    y.mul_(a).add_(bias.float())
    if negative_slope != 1.0:
        F.leaky_relu_(y, negative_slope)
    return y.to(x.dtype)
