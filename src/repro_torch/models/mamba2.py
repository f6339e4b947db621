"""Mamba2 / SSD (state-space duality, arXiv:2405.21060) blocks.

Recurrence per head: h_t = exp(dt_t*A) h_{t-1} + dt_t * B_t x_t^T,
y_t = C_t . h_t + D x_t, with A < 0 so every decay factor is <= 1.

``block_forward`` runs the scan through the hand-written kernel
(``kernels/ssd_scan``) where the reference block calls ``ssd_chunked``;
``ssd_chunked`` is kept as a plain copy of the reference's chunked scan
(with ``init_state`` and the cumulative decays the context-parallel
path needs) and is the yardstick the kernel path is held against.
Layouts are the reference's: ``in_proj`` (D, 2*d_inner + 2N + H),
``conv_w`` (K, C), activations (B, L, ...).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers import dense_init, rmsnorm

Params = Dict[str, torch.Tensor]


class SSDExtras(NamedTuple):
    final_state: torch.Tensor  # (B, H, P, N) fp32
    cumdecay: torch.Tensor     # (B, L, H): sum of dA from shard start to t (<=0)


def ssd_chunked(
    x: torch.Tensor,       # (B, L, H, P)
    dt: torch.Tensor,      # (B, L, H) post-softplus
    A: torch.Tensor,       # (H,) negative
    Bm: torch.Tensor,      # (B, L, N)  (G=1 group)
    Cm: torch.Tensor,      # (B, L, N)
    *,
    chunk: int = 256,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
) -> Tuple[torch.Tensor, SSDExtras]:
    """Chunked SSD scan in plain PyTorch: fp32 math (fp64 for fp64
    inputs, as a yardstick). Returns y (B, L, H, P) in x's dtype and the
    extras."""
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"seq {L} must divide chunk {Q}")
    nc = L // Q
    ct = torch.promote_types(x.dtype, torch.float32)

    xc = x.to(ct).reshape(Bb, nc, Q, H, P)
    dtc = dt.to(ct).reshape(Bb, nc, Q, H)
    Bc = Bm.to(ct).reshape(Bb, nc, Q, N)
    Cc = Cm.to(ct).reshape(Bb, nc, Q, N)
    sig = torch.cumsum(dtc * A.to(ct), dim=2)  # (B, nc, Q, H)
    sig_last = sig[:, :, -1, :]                 # (B, nc, H)

    # --- intra-chunk: (C.B^T * exp(sig_q - sig_k) * dt_k)[k <= q] @ x ---
    # mask BEFORE exp: upper-triangle diffs are positive and overflow
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    w = sig[:, :, :, None, :] - sig[:, :, None, :, :]  # (B, nc, Q, Q, H)
    w.masked_fill_(upper[None, None, :, :, None], float("-inf")).exp_()
    w.mul_(torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[..., None])
    w.mul_(dtc[:, :, None, :, :])
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, xc)
    del w

    # --- per-chunk end-state contributions ---
    decay_states = torch.exp(sig_last[:, :, None, :] - sig) * dtc
    states = torch.einsum("bckhp,bckn->bchpn",
                          xc * decay_states[..., None], Bc)

    # --- inter-chunk sequential recurrence (1-element halo over chunks) ---
    chunk_decay = torch.exp(sig_last)  # (B, nc, H)
    s = (torch.zeros((Bb, H, P, N), dtype=ct, device=x.device)
         if init_state is None else init_state.to(ct))
    s_in = []
    for c in range(nc):
        s_in.append(s)  # the state *before* chunk c
        s = chunk_decay[:, c, :, None, None] * s + states[:, c]
    y += torch.einsum("bcqn,bchpn->bcqhp", Cc,
                      torch.stack(s_in, dim=1)) * torch.exp(sig)[..., None]
    y = y.reshape(Bb, L, H, P)

    # cumulative decay from shard start (for context-parallel pass 2)
    chunk_off = torch.cumsum(sig_last, dim=1) - sig_last  # (B, nc, H)
    cumdecay = (sig + chunk_off[:, :, None, :]).reshape(Bb, L, H)
    return y.to(x.dtype), SSDExtras(s, cumdecay)


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


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B, L, C); w: (K, C). The result is
    (B, L, C) in row-major order: the bias add writes it so (the scan
    kernel reads its x, B and C columns in place)."""
    K, C = w.shape
    xp = F.pad(x.transpose(1, 2), (K - 1, 0))  # (B, C, K-1+L)
    out = F.conv1d(xp, w.t().unsqueeze(1), groups=C)  # (B, C, L)
    return torch.add(out.transpose(1, 2), b,
                     out=out.new_empty(out.shape[0], out.shape[2], C))


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
) -> torch.Tensor:
    """Mamba2 block (pre-norm residual handled by caller); the scan runs
    through ``kernels/ssd_scan`` (the kernel on the card, its plain
    version on the CPU)."""
    d_inner = num_heads * head_dim
    N = ssm_state
    z, xBC, dt = _split_proj(h @ p["in_proj"], d_inner, N)
    xBC = F.silu(_causal_conv1d(xBC, p["conv_w"], p["conv_b"]))
    x, Bm, Cm = torch.split(xBC, [d_inner, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    Bb, L, _ = x.shape
    q = min(chunk, L)
    if L % q:
        raise ValueError(f"seq {L} must divide chunk {q}")
    xh = x.reshape(Bb, L, num_heads, head_dim)
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
