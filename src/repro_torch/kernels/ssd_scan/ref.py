"""Plain PyTorch versions of the SSD chunked-scan kernel.

``ssd_scan`` is the sequential state-space recurrence of
``repro.kernels.ssd_scan.ref.ssd_scan`` (exact, one state update per
step), in fp32 whatever the inputs' dtype:

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t

The CPU path of ``ops.ssd_scan`` runs it, and the card's kernel is held
against it.

``ssd_chunked`` is the reference's chunked scan
(``repro.models.mamba2.ssd_chunked``) in plain PyTorch, with
``init_state`` and the cumulative decays the context-parallel path
needs: the yardstick the kernel path is held against, and, since the
reference differentiates exactly this function, the graph whose
gradient ``ops.ssd_scan``'s backward takes. It writes into no tensor
that autograd saves. ``models/mamba2.py`` re-exports it.

``ssd_scan_tc``, for the tests only (nothing on the main path uses it),
is the kernel's own chunked arithmetic with each tensor-core operand
rounded as the kernel rounds it: 3xTF32 for fp32 inputs, the computed
operands split into three bf16 parts for bf16 inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.conv3d.ref import split_tf32


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


class SSDExtras(NamedTuple):
    final_state: torch.Tensor  # (B, H, P, N) fp32
    cumdecay: torch.Tensor     # (B, L, H): sum of dA from shard start
    #                            to t (<= 0)


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
    extras. Differentiable: every step makes a new tensor."""
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
    sig = decay_sums(dt, A, Q, ct)  # (B, nc, Q, H)
    sig_last = sig[:, :, -1, :]     # (B, nc, H)

    # --- intra-chunk: (C.B^T * exp(sig_q - sig_k) * dt_k)[k <= q] @ x ---
    # mask BEFORE exp: upper-triangle diffs are positive and overflow
    upper = ~torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    w = sig[:, :, :, None, :] - sig[:, :, None, :, :]  # (B, nc, Q, Q, H)
    w = torch.exp(w.masked_fill(upper[None, None, :, :, None],
                                float("-inf")))
    w = w * torch.einsum("bcqn,bckn->bcqk", Cc, Bc)[..., None]
    w = w * dtc[:, :, None, :, :]
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
    y = y + torch.einsum("bcqn,bchpn->bcqhp", Cc,
                         torch.stack(s_in, dim=1)) * torch.exp(sig)[..., None]
    y = y.reshape(Bb, L, H, P)

    return y.to(x.dtype), SSDExtras(s, cumdecay(sig))


def decay_sums(dt: torch.Tensor, A: torch.Tensor, Q: int,
               ct: torch.dtype) -> torch.Tensor:
    """sig (B, L / Q, Q, H): dt A summed from each chunk's start to each
    step, chunks of ``Q`` steps, in ``ct``."""
    Bb, L, H = dt.shape
    return torch.cumsum(dt.to(ct).reshape(Bb, L // Q, Q, H) * A.to(ct),
                        dim=2)


def cumdecay(sig: torch.Tensor) -> torch.Tensor:
    """(B, L, H): dt A summed from the sequence's (a shard's) start to each
    step, by the reference's chunked formula (each step's sum within its
    chunk plus the chunks' totals before it), from ``decay_sums``'s sig:
    the context-parallel scan's decays (``core/seq_parallel.cp_ssd``)."""
    Bb, nc, Q, H = sig.shape
    sig_last = sig[:, :, -1, :]
    chunk_off = torch.cumsum(sig_last, dim=1) - sig_last  # (B, nc, H)
    return (sig + chunk_off[:, :, None, :]).reshape(Bb, nc * Q, H)


def split_bf16(a: torch.Tensor, parts: int = 3) -> torch.Tensor:
    """a (fp32) as the kernel feeds a computed bf16 operand: ``parts``
    bf16 values, each the rounding of what the ones before it left (hi,
    mid, lo); returns their sum (exact in fp32), which multiplies an
    exact bf16 operand as the products part·b summed do."""
    rest = a.float()
    total = torch.zeros_like(rest)
    for _ in range(parts):
        part = rest.bfloat16().float()
        total += part
        rest = rest - part
    return total


def _product(bf16: bool):
    """a @ b with the kernel's operand treatment. fp32 inputs: 3xTF32,
    hi·hi + hi·lo + lo·hi of ``split_tf32``. bf16 inputs: an operand
    the kernel computed (``computed_a`` / ``computed_b``) in the three
    parts of ``split_bf16``, an input as it is (exact)."""
    def mm(a, b, computed_a=False, computed_b=False):
        if bf16:
            return ((split_bf16(a) if computed_a else a)
                    @ (split_bf16(b) if computed_b else b))
        ah, al = split_tf32(a)
        bh, bl = split_tf32(b)
        return al @ bh + ah @ bl + ah @ bh
    return mm


def ssd_scan_tc(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic on fp32 or bf16 inputs, in chunks of
    ``chunk`` steps (a divisor of L): C Bᵀ once per chunk; each chunk's
    state (w ⊙ x)ᵀ B with w = exp(sig_Q - sig) dt; the carry over the
    chunks in fp32; y = exp(sig_q) C s_inᵀ + (C Bᵀ ⊙ exp(sig_q - sig_k)
    ⊙ dt_k ⊙ [k <= q]) x, each product rounded as the kernel's tensor
    cores take it (``_product``). Returns y in x's dtype and the fp32
    final state."""
    Bb, L, H, P = x.shape
    N = Bm.shape[-1]
    Q = chunk
    if L % Q:
        raise ValueError(f"chunk {Q} must divide L = {L}")
    nc = L // Q
    mm = _product(x.dtype == torch.bfloat16)
    xc = x.float().reshape(Bb, nc, Q, H, P).permute(0, 1, 3, 2, 4)
    dtc = dt.float().reshape(Bb, nc, Q, H).permute(0, 1, 3, 2)  # (B, nc, H, Q)
    Bc = Bm.float().reshape(Bb, nc, 1, Q, N)
    Cc = Cm.float().reshape(Bb, nc, 1, Q, N)
    sig = torch.cumsum(dtc * A.float()[:, None], dim=-1)
    last = sig[..., -1:]
    cb = mm(Cc, Bc.transpose(-1, -2))  # (B, nc, 1, Q, Q)
    # mask BEFORE the exponential: sig_q - sig_k > 0 above the diagonal
    lower = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    decay = torch.where(lower, sig[..., :, None] - sig[..., None, :],
                        torch.tensor(float("-inf"))).exp()
    scores = cb * decay * dtc[..., None, :]  # (B, nc, H, Q, Q)
    y = mm(scores, xc, computed_a=True)
    w = torch.exp(last - sig) * dtc  # (B, nc, H, Q)
    states = mm((w[..., None] * xc).transpose(-1, -2), Bc,
                computed_a=True)  # (B, nc, H, P, N)
    s = torch.zeros((Bb, H, P, N), dtype=torch.float32)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = torch.exp(last[:, c, :, :, None]) * s + states[:, c]
    inter = mm(Cc, torch.stack(s_in, 1).transpose(-1, -2), computed_b=True)
    y = y + inter * torch.exp(sig)[..., None]
    return y.permute(0, 1, 3, 2, 4).reshape(Bb, L, H, P).to(x.dtype), s
