"""Sequence and head parallelism of the language models (the reference's
``core/seq_parallel.py``): the paper's spatial partitioning on the
sequence axis.

* Sliding-window attention: a 1-D halo of the previous shards' K/V
  (``ppermute`` hops, as many as the window needs).
* Full attention: an all-gather of K/V over the sequence shards (the
  "halo = the whole domain" case).
* The SSD scan: each shard's own scan, then an all-gather of every
  shard's (decay, final state) pair, an exclusive prefix in rank order
  and a correction of the shard's outputs: the sequence model's
  counterpart of the halo carry.

The reference's functions take global arrays and wrap ``shard_map``.
These are per-shard functions: each takes this shard's blocks inside
``spmd.run`` and names its collectives through ``spmd.axis(axis)``, so a
process mesh needs no change here. Gradients flow through every
collective (``core/spmd.py``); ``pmax`` (the decode merge's shift) has
none, and decode runs without gradients.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import spmd
from repro_torch.core.halo import _shift_perm
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.layers import (cache_write, chunked_attention,
                                       decode_attention)


def _gather_prev_shards(x: torch.Tensor, group, hops: int,
                        dim: int) -> torch.Tensor:
    """The ``hops`` previous shards' blocks along ``dim``,
    concatenated oldest first; a shard before the first gives zeros
    (masked by their negative positions)."""
    blocks = []
    buf = x
    for _ in range(hops):
        buf = group.ppermute(buf, _shift_perm(group.size, +1))
        blocks.append(buf)
    return torch.cat(blocks[::-1], dim)


def cp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 axis: str = "model", *, causal: bool = True,
                 window: int = 0, attn_softcap: float = 0.0,
                 kv_chunk: int = 1024) -> torch.Tensor:
    """Context-parallel attention: q (B, s, H, hd), k, v (B, s, Hkv, hd),
    this shard's block of the sequence (cut in equal blocks over
    ``axis`` in rank order). Full attention gathers every shard's K/V;
    a causal window takes ``hops = min(ceil((window - 1) / s), n - 1)``
    previous shards' blocks by ``ppermute``. Returns this shard's
    (B, s, H, hd)."""
    g = spmd.axis(axis)
    n, s_loc = g.size, q.shape[1]
    dev = q.device
    off = g.index * s_loc
    q_pos = off + torch.arange(s_loc, device=dev)
    hops = (min(int(math.ceil((window - 1) / s_loc)), n - 1)
            if window > 0 and causal else None)
    if hops is None:
        kg, vg = g.all_gather(k, 1), g.all_gather(v, 1)
        kv_pos = torch.arange(s_loc * n, device=dev)
    elif hops == 0:
        kg, vg, kv_pos = k, v, q_pos
    else:
        kg = torch.cat([_gather_prev_shards(k, g, hops, 1), k], 1)
        vg = torch.cat([_gather_prev_shards(v, g, hops, 1), v], 1)
        # a shard before the first sent zeros: negative positions, which
        # chunked_attention masks out
        kv_pos = off - hops * s_loc + torch.arange((hops + 1) * s_loc,
                                                   device=dev)
    return chunked_attention(q, kg, vg, q_pos=q_pos, kv_pos=kv_pos,
                             causal=causal, window=window,
                             attn_softcap=attn_softcap, kv_chunk=kv_chunk)


def tp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 axis: str = "model", *, causal: bool = True,
                 window: int = 0, attn_softcap: float = 0.0,
                 kv_chunk: int = 1024) -> torch.Tensor:
    """Head-parallel attention: q (B, S, h, hd) this shard's h = H / n
    query heads (cut over ``axis`` in rank order), k, v (B, S, Hkv, hd)
    every key/value head; each shard takes the key/value heads its query
    heads read. Returns (B, S, h, hd)."""
    g = spmd.axis(axis)
    h_loc, Hkv = q.shape[2], k.shape[2]
    H = h_loc * g.size
    group = H // Hkv
    if h_loc % group and group % h_loc:
        raise ValueError(f"{h_loc} query heads a shard straddle the "
                         f"groups of {group} query heads a key/value head")
    kv_start = (g.index * h_loc) // group
    kv_count = max(h_loc // group, 1)
    kc = k.narrow(2, kv_start, kv_count)
    vc = v.narrow(2, kv_start, kv_count)
    pos = torch.arange(q.shape[1], device=q.device)
    return chunked_attention(q, kc, vc, q_pos=pos, kv_pos=pos, causal=causal,
                             window=window, attn_softcap=attn_softcap,
                             kv_chunk=kv_chunk)


def cp_ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, axis: str = "model", *,
           chunk: int = 256) -> torch.Tensor:
    """Context-parallel SSD scan of this shard's block of the sequence:
    x (B, s, H, P), dt (B, s, H), A (H,), Bm/Cm (B, s, N). The shard's
    own scan runs through ``kernels/ssd_scan/ops.ssd_scan`` (the
    hand-written kernel on a card, the plain scan on the CPU; the
    reference's chunked-scan gradient), from a zero state; then every
    shard's (total decay, final state) is all-gathered, the state
    entering this shard is their exclusive prefix in rank order, and
    ``C exp(cumdecay)`` times it is added to y. Returns y (B, s, H, P) in
    x's dtype, without the D skip (the block adds it)."""
    q = ssd_ops.chunk_len(x.shape[1], chunk)
    y, final = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=q)
    g = spmd.axis(axis)
    if g.size == 1:
        return y
    ct = torch.promote_types(x.dtype, torch.float32)
    cum = ssd_ref.cumdecay(ssd_ref.decay_sums(dt, A, q, ct))  # (B, s, H)
    decays = g.all_gather(torch.exp(cum[:, -1])[None], 0)    # (n, B, H)
    states = g.all_gather(final[None].to(ct), 0)      # (n, B, H, P, N)
    s_in = torch.zeros_like(states[0])
    for j in range(g.index):
        s_in = decays[j][:, :, None, None] * s_in + states[j]
    corr = torch.einsum("bsn,bsh,bhpn->bshp", Cm.to(ct), torch.exp(cum),
                        s_in)
    return y + corr.to(y.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int, num_kv_heads: int, pos: torch.Tensor,
              causal: bool = True, window: int = 0,
              attn_softcap: float = 0.0, lay=None) -> torch.Tensor:
    """The language models' attention under a plan (``lay``: a
    ``core/sharding.Layout``, None unsharded): ``chunked_attention`` over
    the whole sequence at positions ``pos``; under a plan that cuts the
    sequence ``cp_attention``; with the query heads cut (``tp``), each
    shard's own heads against its key/value heads (cut alike) or against
    every key/value head (``tp_attention``)."""
    if lay is not None and lay.seq_split:
        return cp_attention(q, k, v, lay.axis, causal=causal, window=window,
                            attn_softcap=attn_softcap)
    if lay is not None and q.shape[2] < num_heads \
            and k.shape[2] == num_kv_heads:
        return tp_attention(q, k, v, lay.axis, causal=causal, window=window,
                            attn_softcap=attn_softcap)
    return chunked_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=causal,
                             window=window, attn_softcap=attn_softcap)


def all_heads(x: torch.Tensor, num_heads: int, lay=None) -> torch.Tensor:
    """(B, S, h, hd) this shard's heads all-gathered over the model axis
    to (B, S, num_heads, hd) (as it is where not cut)."""
    if lay is None or x.shape[2] == num_heads:
        return x
    return lay.model.all_gather(x, 2)


def cache_update_sharded(cache: torch.Tensor, new: torch.Tensor, cur: int,
                         axis: str = "model") -> torch.Tensor:
    """Write the token ``new`` (B, 1, ...) at global position ``cur`` into
    this shard's slots of a cache cut on its sequence dim over ``axis``
    (``cache`` (B, s, ...): positions index * s to (index + 1) * s - 1):
    only the shard owning ``cur`` writes, in place. Returns ``cache``."""
    s_loc = cache.shape[1]
    pos = cur - spmd.axis(axis).index * s_loc
    if 0 <= pos < s_loc:
        cache[:, pos:pos + 1] = new.to(cache.dtype)
    return cache


def decode_attention_sharded_kv(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, cur_len: int,
                                axis: str = "model", *, window: int = 0,
                                attn_softcap: float = 0.0) -> torch.Tensor:
    """Flash-decoding over a cache cut on its sequence dim: q (B, 1, H,
    hd) the query at position ``cur_len - 1`` (every shard's), k/v_cache
    (B, s, Hkv, hd) this shard's slots. Each shard's partial softmax
    (max, sum, weighted values) over its valid slots, then one merge in
    log space: the max over shards (``pmax``), each shard's sums rescaled
    to it and summed (``psum``). Returns (B, 1, H, hd) in q's dtype."""
    g = spmd.axis(axis)
    s_loc = k_cache.shape[1]
    dev = q.device
    ct = torch.promote_types(q.dtype, torch.float32)
    raw = g.index * s_loc + torch.arange(s_loc, device=dev)
    kv_pos = torch.where(raw < cur_len, raw, -1)
    q_pos = cur_len - 1
    B, _, H, hd = q.shape
    Hkv = k_cache.shape[2]
    qg = (q.reshape(B, 1, Hkv, H // Hkv, hd)
          * torch.tensor(hd ** -0.5, dtype=q.dtype, device=dev)).to(ct)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache.to(ct))
    if attn_softcap > 0:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    valid = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window > 0:
        valid = valid & (q_pos - kv_pos < window)
    s = s.masked_fill(~valid, float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isinf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None]).masked_fill(~valid, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_cache.dtype).to(ct),
                       v_cache.to(ct))
    if g.size > 1:
        m_glob = g.pmax(m_safe)
        r = torch.exp(m_safe - m_glob) * (l > 0)
        l, acc = g.psum((l * r, acc * r[..., None]))
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, hd).to(q.dtype)


def sharded_cache(lay) -> bool:
    """Whether decode keeps the KV cache cut on its sequence (more than
    one model shard, under every plan)."""
    return lay is not None and lay.model.size > 1


def decode_attend(q, k, v, kc, vc, cur: int, *, num_heads: int,
                  num_kv_heads: int, window: int = 0,
                  attn_softcap: float = 0.0, lay=None) -> torch.Tensor:
    """One token's attention against the cache (``kc``/``vc``, written
    with its keys and values at slot ``cur`` in place): every head's
    output (B, 1, H, hd). Under a cache cut on its sequence the token's
    heads are gathered first, only the owner of slot ``cur`` writes, and
    the shards' partial softmaxes merge."""
    if not sharded_cache(lay):
        return decode_attention(q, cache_write(kc, k, cur),
                                cache_write(vc, v, cur), cur, window=window,
                                attn_softcap=attn_softcap)
    q = all_heads(q, num_heads, lay)
    k = all_heads(k, num_kv_heads, lay)
    v = all_heads(v, num_kv_heads, lay)
    kc = cache_update_sharded(kc, k, cur, lay.axis)
    vc = cache_update_sharded(vc, v, cur, lay.axis)
    return decode_attention_sharded_kv(
        q, kc, vc, cur + 1, lay.axis, window=window,
        attn_softcap=attn_softcap)


def to_cache_slots(t: torch.Tensor, num_heads: int, max_len: int,
                   lay=None) -> torch.Tensor:
    """A prefill's keys or values (B, s, h, hd) as decode's cache
    (B, slots, Hkv, hd): every head (gathered where cut), every
    position (gathered where the plan cuts the sequence), zeros to
    ``max_len``, then this shard's ``max_len / n`` slots where the cache
    is cut on its sequence."""
    if lay is not None:
        t = all_heads(t, num_heads, lay)
        if lay.seq_split:
            t = lay.model.all_gather(t, 1)
    t = F.pad(t, (0, 0, 0, 0, 0, max(max_len - t.shape[1], 0)))
    if not sharded_cache(lay):
        return t
    slots = max_len // lay.model.size
    return t.narrow(1, lay.model.index * slots, slots)


def check_slots(max_len: int, lay=None) -> None:
    """Raise unless ``max_len`` cuts into the model shards' slot
    ranges (the reference's shard_map cannot split it either)."""
    if sharded_cache(lay) and max_len % lay.model.size:
        raise ValueError(
            f"max_len {max_len} does not cut into {lay.model.size} equal "
            f"slot ranges of the sequence-sharded KV cache over "
            f"{lay.axis!r}")


__all__ = ["all_heads", "attention", "cache_update_sharded", "check_slots",
           "cp_attention", "cp_ssd", "decode_attend",
           "decode_attention_sharded_kv", "sharded_cache", "to_cache_slots",
           "tp_attention"]
