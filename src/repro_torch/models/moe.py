"""Top-k mixture-of-experts FFN, unsharded (the reference's
``models/moe.py::moe_ffn`` under ``NO_POLICY``).

Dispatch is sort-based (no (T, E, C) one-hot): token copies are sorted
by expert id (a stable sort, as ``jnp.argsort``), positioned within
their expert group by a cumulative count, and scattered into an
(E, C + 1, D) buffer whose last slot parks the copies beyond capacity C
(dropped, GShard-style) before it is sliced off; the combine adds each
kept copy, weighted by its gate, back to its token (``index_add_``).
Includes the Switch load-balancing loss (§2.2). The expert-parallel
variant (``moe_ffn_ep``) comes with the sequence-parallel slice.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int,
                    dtype: torch.dtype = torch.float32) -> Params:
    """The reference's law: 1/sqrt(fan_in) normal weights, fan-in d_model
    (d_ff for ``w_down``), drawn from ``generator`` on its device."""
    return {
        "router": dense_init(generator, (d_model, num_experts), dtype),
        "w_gate": dense_init(generator, (num_experts, d_model, d_ff), dtype,
                             fan_in=d_model),
        "w_up": dense_init(generator, (num_experts, d_model, d_ff), dtype,
                           fan_in=d_model),
        "w_down": dense_init(generator, (num_experts, d_ff, d_model), dtype,
                             fan_in=d_ff),
    }


def moe_ffn(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balance loss scalar),
    both in x's dtype."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)

    logits = xt @ p["router"]  # (T, E)
    probs = torch.softmax(logits.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # aux loss: fraction of tokens per expert * mean router prob per expert
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], num_experts).float().mean(dim=0)
    aux = num_experts * (me * ce).sum()

    # ---- sort-based dispatch ----
    C = max(int(math.ceil(capacity_factor * T * top_k / num_experts)), 1)
    flat_e = gate_idx.reshape(-1)                      # (T*k,)
    flat_t = torch.arange(T, device=x.device).repeat_interleave(top_k)
    flat_w = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, dim=0) - counts       # exclusive cumsum
    pos = torch.arange(T * top_k, device=x.device) - starts[se]
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                   # C -> dropped

    buf = torch.zeros((num_experts, C + 1, D), dtype=x.dtype,
                      device=x.device)
    buf[se, pos_c] = torch.where(keep[:, None], xt[st], 0.0)
    buf = buf[:, :C]                                    # (E, C, D)

    # ---- expert computation ----
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])                 # (E, C, D)

    # ---- combine ----
    gathered = out_buf[se, pos_c.clamp(0, C - 1)]       # (T*k, D)
    gathered = torch.where(keep[:, None], gathered, 0.0) \
        * sw[:, None].to(x.dtype)
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add_(
        0, st, gathered)
    return out.reshape(B, S, D), aux.to(x.dtype)
