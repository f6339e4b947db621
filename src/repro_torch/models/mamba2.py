"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) blocks.

Recurrence per head: h_t = exp(dt_t*A) h_{t-1} + dt_t * B_t x_t^T,
y_t = C_t . h_t + D x_t, with A < 0 so every decay factor is <= 1.

``block_forward`` runs the scan through the hand-written kernel
(``kernels/ssd_scan``) where the reference block calls ``ssd_chunked``;
``ssd_chunked`` is a plain copy of the reference's chunked scan (with
``init_state`` and the cumulative decays the context-parallel path
needs), kept in ``kernels/ssd_scan/ref.py`` and re-exported here: the
yardstick the kernel path is held against, and the graph whose
gradient the kernel wrapper's backward takes (the reference
differentiates it). The block is differentiable end to end.
Layouts are the reference's: ``in_proj`` (D, 2*d_inner + 2N + H),
``conv_w`` (K, C), activations (B, L, ...).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import halo as halo_lib
from repro_torch.core import seq_parallel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import SSDExtras, ssd_chunked
from repro_torch.models.layers import dense_init, rmsnorm

Params = Dict[str, torch.Tensor]
__all__ = ["SSDExtras", "block_decode", "block_forward", "init_block_params",
           "ssd_chunked", "ssd_decode_step"]


def ssd_decode_step(
    state: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,      # (B, H, P)
    dt: torch.Tensor,     # (B, H)
    A: torch.Tensor,      # (H,)
    Bm: torch.Tensor,     # (B, N)
    Cm: torch.Tensor,     # (B, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update. Returns (y (B, H, P), new_state)."""
    dtf = dt.float()
    decay = torch.exp(dtf * A.float())  # (B, H)
    upd = (dtf[:, :, None] * x.float())[..., None] \
        * Bm.float()[:, None, None, :]
    new_state = decay[:, :, None, None] * state.float() + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, Cm.float())
    return y.to(x.dtype), new_state.to(state.dtype)


# ------------------------------------------------------------- the block --
def init_block_params(generator: torch.Generator, d_model: int,
                      d_inner: int, ssm_state: int, num_heads: int,
                      conv_width: int,
                      dtype: torch.dtype = torch.float32) -> Params:
    """The reference's initialization law, drawn from ``generator`` on
    its device (A = -exp(A_log) = -1, D = 1, zero biases and norm)."""
    N = ssm_state
    d_in_proj = 2 * d_inner + 2 * N + num_heads
    conv_ch = d_inner + 2 * N
    dev = generator.device
    return {
        "in_proj": dense_init(generator, (d_model, d_in_proj), dtype),
        "conv_w": dense_init(generator, (conv_width, conv_ch), dtype,
                             fan_in=conv_width),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
        "dt_bias": torch.zeros((num_heads,), dtype=dtype, device=dev),
        "A_log": torch.zeros((num_heads,), dtype=dtype, device=dev),
        "D": torch.ones((num_heads,), dtype=dtype, device=dev),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": dense_init(generator, (d_inner, d_model), dtype),
    }


class _BiasRowMajor(torch.autograd.Function):
    """``out.transpose(1, 2) + b`` written row-major in one pass (the
    ``out=`` add autograd does not differentiate); its backward is the
    add's: the incoming gradient, transposed back, and its row sums."""

    @staticmethod
    def forward(ctx, out: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.add(out.transpose(1, 2), b,
                         out=out.new_empty(out.shape[0], out.shape[2],
                                           out.shape[1]))

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        return gy.transpose(1, 2), gy.sum((0, 1))


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (K, C). The result is
    (B, L, C) in row-major order: the bias add writes it so
    (``_BiasRowMajor``; the scan kernel reads its x, B and C columns in
    place)."""
    K, C = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))  # (B, C, K-1+L)
    out = F.conv1d(xp, w.t().unsqueeze(1), groups=C)  # (B, C, L)
    return _BiasRowMajor.apply(out, b)


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, N: int):
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * N,
                                zxbcdt.shape[-1] - 2 * d_inner - 2 * N],
                       dim=-1)


def block_forward(
    p: Params,
    h: torch.Tensor,  # (B, L, D)
    *,
    num_heads: int,
    head_dim: int,
    ssm_state: int,
    chunk: int = 256,
    seq_axis: Optional[str] = None,
) -> torch.Tensor:
    """Mamba2 block (pre-norm residual handled by caller); the scan runs
    through ``kernels/ssd_scan`` (the kernel on the card, its plain
    version on the CPU). ``seq_axis`` (inside ``spmd.run``): ``h`` is
    this shard's block of the sequence, cut over that mesh axis; the
    causal conv takes its K - 1 rows before the block from the previous
    shard (``core/halo.halo_exchange``, zeros on the first: the
    unsharded conv's padding), whose outputs it drops again, and the scan
    is ``seq_parallel.cp_ssd``."""
    d_inner = num_heads * head_dim
    N = ssm_state
    z, xBC, dt = _split_proj(h @ p["in_proj"], d_inner, N)
    lo = p["conv_w"].shape[0] - 1 if seq_axis is not None else 0
    if lo:
        xBC = halo_lib.halo_exchange(xBC, seq_axis, dim=1, lo=lo, hi=0)
    xBC = F.silu(_causal_conv1d(xBC, p["conv_w"], p["conv_b"])[:, lo:])
    x, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    Bb, L, _ = x.shape
    q = min(chunk, L)
    if L % q:
        raise ValueError(f"seq {L} must divide chunk {q}")
    xh = x.reshape(Bb, L, num_heads, head_dim)
    if seq_axis is not None:
        y = seq_parallel.cp_ssd(xh, dt, A, Bm, Cm, seq_axis, chunk=q)
    else:
        y, _ = ssd_ops.ssd_scan(xh, dt, A, Bm, Cm, chunk=q)  # views of xBC
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(Bb, L, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"]


def block_decode(
    p: Params,
    h: torch.Tensor,           # (B, D) one token
    conv_cache: torch.Tensor,  # (B, K-1, conv_ch)
    ssm_cache: torch.Tensor,   # (B, H, P, N)
    *,
    num_heads: int,
    head_dim: int,
    ssm_state: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    d_inner = num_heads * head_dim
    N = ssm_state
    z, xBC, dt = _split_proj(h @ p["in_proj"], d_inner, N)
    window = torch.cat([conv_cache, xBC[:, None, :]], dim=1)  # (B, K, C)
    new_conv_cache = window[:, 1:, :]
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    x, Bm, Cm = torch.split(F.silu(conv_out), [d_inner, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    xh = x.reshape(-1, num_heads, head_dim)
    y, new_state = ssd_decode_step(ssm_cache, xh, dt, A, Bm, Cm)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(-1, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"], new_conv_cache, new_state
