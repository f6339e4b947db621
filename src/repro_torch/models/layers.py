"""Building blocks of the port's language models: ``rmsnorm`` (the
reference's ``(1 + scale)`` convention, variance in fp32) and
``dense_init``. Attention and RoPE come with the hybrid slice."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * (1.0 + scale)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan_in) (``shape[0]`` unless
    given), drawn from ``generator`` on its device."""
    fi = fan_in if fan_in is not None else shape[0]
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device)
    return (w * math.sqrt(1.0 / fi)).to(dtype)
