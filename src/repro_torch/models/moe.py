"""Top-k mixture-of-experts FFN, unsharded (the reference's
``models/moe.py::moe_ffn`` under ``NO_POLICY``).

Dispatch is sort-based (no (T, E, C) one-hot): token copies are sorted
by expert id (a stable sort, as ``jnp.argsort``), positioned within
their expert group by a cumulative count, and scattered into an
(E, C + 1, D) buffer whose last slot parks the copies beyond capacity C
(dropped, GShard-style) before it is sliced off; the combine adds each
kept copy, weighted by its gate, back to its token (``index_add_``).
Includes the Switch load-balancing loss (§2.2).

Under a mesh (per-shard functions, inside ``spmd.run``):
``moe_ffn_ep`` is the reference's expert-parallel MoE: each shard routes
and dispatches its own tokens (capacity from the local token count) and
two ``all_to_all``s over the model axis move each expert's copies to and
from the shard holding it; its aux loss is the shard's, averaged over
the model and then the data axes. ``moe_ffn_gathered`` is what the
reference runs elsewhere, ``moe_ffn`` over the global tokens: the
tokens are all-gathered over the axes that split them, routed and
dropped as over B x S, the shard's own experts computed (where the
expert stacks are cut over the model axis: their outputs all-gathered
before the combine), and the shard's tokens sliced back out.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import spmd
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


def _route(xt: torch.Tensor, router: torch.Tensor, num_experts: int,
           top_k: int):
    """(gate values (T, k), expert choices (T, k), aux loss) of tokens
    ``xt`` (T, D): the top-k of the router's softmax, renormalized; aux
    = E x sum(mean prob x fraction routed first) (Switch §2.2)."""
    probs = torch.softmax((xt @ router).float(), dim=-1)  # (T, E)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)  # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_idx[:, 0], num_experts).float().mean(dim=0)
    return gate_vals, gate_idx, num_experts * (me * ce).sum()


def _dispatch_local(xt: torch.Tensor, gate_idx: torch.Tensor,
                    gate_vals: torch.Tensor, num_experts: int, C: int):
    """Sort-based dispatch of tokens ``xt`` (T, D) into an (E, C, D)
    buffer: (buffer, then what the combine needs: each copy's expert,
    token, gate, slot and whether it was kept)."""
    T, D = xt.shape
    top_k = gate_idx.shape[1]
    flat_e = gate_idx.reshape(-1)                      # (T*k,)
    flat_t = torch.arange(T, device=xt.device).repeat_interleave(top_k)
    flat_w = gate_vals.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]
    counts = torch.bincount(flat_e, minlength=num_experts)
    starts = torch.cumsum(counts, dim=0) - counts       # exclusive cumsum
    pos = torch.arange(T * top_k, device=xt.device) - starts[se]
    keep = pos < C
    pos_c = torch.where(keep, pos, C)                   # C -> dropped
    buf = torch.zeros((num_experts, C + 1, D), dtype=xt.dtype,
                      device=xt.device)
    buf[se, pos_c] = torch.where(keep[:, None], xt[st], 0.0)
    return buf[:, :C], se, st, sw, pos_c, keep


def _experts(buf: torch.Tensor, p: Params) -> torch.Tensor:
    """The experts' gated MLPs over their buffers (E, C, D)."""
    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    return torch.bmm(h, p["w_down"])


def _combine_local(out_buf: torch.Tensor, se, st, sw, pos_c, keep, T: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Each kept copy's expert output, weighted by its gate, added back
    to its token: (T, D)."""
    C, D = out_buf.shape[1], out_buf.shape[2]
    gathered = out_buf[se, pos_c.clamp(0, C - 1)]       # (T*k, D)
    gathered = torch.where(keep[:, None], gathered, 0.0) \
        * sw[:, None].to(dtype)
    return torch.zeros((T, D), dtype=dtype, device=out_buf.device
                       ).index_add_(0, st, gathered)


def _capacity(capacity_factor: float, T: int, top_k: int,
              num_experts: int) -> int:
    return max(int(math.ceil(capacity_factor * T * top_k / num_experts)), 1)


def moe_ffn(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, expert_axis: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux load-balance loss scalar),
    both in x's dtype. ``expert_axis`` (inside ``spmd.run``): the expert
    stacks in ``p`` are this shard's block of the experts, cut over that
    axis; the shard computes its own experts' buffers and all-gathers
    their outputs before the combine."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, gate_idx, aux = _route(xt, p["router"], num_experts, top_k)
    C = _capacity(capacity_factor, T, top_k, num_experts)
    buf, se, st, sw, pos_c, keep = _dispatch_local(
        xt, gate_idx, gate_vals, num_experts, C)
    e_loc = p["w_gate"].shape[0]
    if e_loc == num_experts:
        out_buf = _experts(buf, p)
    else:
        g = spmd.axis(expert_axis)
        out_buf = g.all_gather(_experts(
            buf.narrow(0, g.index * e_loc, e_loc), p), 0)
    out = _combine_local(out_buf, se, st, sw, pos_c, keep, T, x.dtype)
    return out.reshape(B, S, D), aux.to(x.dtype)


def moe_ffn_ep(p: Params, x: torch.Tensor, *, num_experts: int, top_k: int,
               policy, capacity_factor: float = 1.25
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's expert-parallel MoE on this shard's tokens x
    (B, s, D) and its block of the experts (cut over the model axis):
    routing and capacity from the local tokens, an (E, C, D) buffer sent
    to the experts' shards by one ``all_to_all`` (each shard's experts
    get (E / n, n C, D)) and their outputs back by another; aux is the
    local aux averaged over the model axis, then the data axes."""
    Bl, Sl, D = x.shape
    T = Bl * Sl
    xt = x.reshape(T, D)
    gm = spmd.axis(policy.model_axis)
    gd = spmd.axis(policy.data_axes)
    gate_vals, gate_idx, aux = _route(xt, p["router"], num_experts, top_k)
    aux = gd.psum(gm.psum(aux) / gm.size) / gd.size
    C = _capacity(capacity_factor, T, top_k, num_experts)
    buf, se, st, sw, pos_c, keep = _dispatch_local(
        xt, gate_idx, gate_vals, num_experts, C)
    buf = gm.all_to_all(buf, 0, 1)       # (E / n, n C, D): my experts'
    out_buf = gm.all_to_all(_experts(buf, p), 1, 0)  # (E, C, D)
    out = _combine_local(out_buf, se, st, sw, pos_c, keep, T, x.dtype)
    return out.reshape(Bl, Sl, D), aux.to(x.dtype)


def moe_ffn_gathered(p: Params, x: torch.Tensor, *, num_experts: int,
                     top_k: int, policy, seq_split: bool,
                     capacity_factor: float = 1.25
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn`` over the global tokens, from this shard's x (B, s, D):
    gathered over the model axis along the sequence (``seq_split``: x
    is this shard's block of it) and over the data axes along the
    batch, routed with the global capacity and drops, the shard's
    experts computed (``expert_axis``: the model axis), and this shard's
    (B, s) tokens of the output sliced back. aux is the global
    tokens'."""
    gm = spmd.axis(policy.model_axis)
    gd = spmd.axis(policy.data_axes)
    Bl, Sl, _ = x.shape
    if seq_split:
        x = gm.all_gather(x, 1)
    x = gd.all_gather(x, 0)
    out, aux = moe_ffn(p, x, num_experts=num_experts, top_k=top_k,
                       capacity_factor=capacity_factor,
                       expert_axis=policy.model_axis)
    out = out.narrow(0, gd.index * Bl, Bl)
    if seq_split:
        out = out.narrow(1, gm.index * Sl, Sl)
    return out, aux
