"""Plain PyTorch version of the SSD chunked-scan kernel: the sequential
state-space recurrence of ``repro.kernels.ssd_scan.ref.ssd_scan``
(exact, one state update per step), in fp32 whatever the inputs'
dtype.

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t
"""
from __future__ import annotations

from typing import Tuple

import torch


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P); dt: (B, L, H); A: (H,); Bm/Cm: (B, L, N).
    Returns y (B, L, H, P) in x's dtype and the final state
    (B, H, P, N) in fp32."""
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    xf, dtf, Af = x.float(), dt.float(), A.float()
    Bf, Cf = Bm.float(), Cm.float()
    s = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = torch.empty((Bb, L, H, P), dtype=torch.float32, device=x.device)
    for t in range(L):
        decay = torch.exp(dtf[:, t] * Af)  # (B, H)
        s.mul_(decay[:, :, None, None]).add_(
            (dtf[:, t, :, None] * xf[:, t])[..., None]
            * Bf[:, t, None, None, :])
        ys[:, t] = torch.einsum("bhpn,bn->bhp", s, Cf[:, t])
    return ys.to(x.dtype), s
