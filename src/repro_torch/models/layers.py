"""Building blocks of the port's language models (the reference's
``models/layers.py``): ``rmsnorm`` (the ``(1 + scale)`` convention,
variance in fp32), ``layernorm``, ``rope``, ``chunked_attention`` (the
online-softmax GQA attention over KV chunks), ``gated_mlp`` /
``plain_mlp``, ``softcap`` and ``dense_init``.

The reference computes all of these in plain JAX, outside any Pallas
kernel, and so does the port in plain PyTorch. The attention is the
reference's scan over KV chunks as it is (its masks, softcap, padding
and fully-masked-row guard), not ``scaled_dot_product_attention``: peak
memory is O(S_q * chunk), and the same function serves the forward,
prefill and decode. Where the reference multiplies bf16 operands with
fp32 accumulation (``preferred_element_type``), the port upcasts the
operands to fp32 (exact) and multiplies there.

Under a sharding policy (per-shard, inside ``spmd.run``; ``lay`` a
``core/sharding.Layout``): ``vocab_embed`` looks tokens up in this
shard's block of the vocabulary (the others' rows zero) and sums over
the model axis; ``lm_cross_entropy`` is the vocabulary-parallel loss
(each shard's logits over its block of the vocabulary, the log-sum-exp
from a detached ``pmax`` and a ``psum`` of the exponentials, the target
logit by a ``psum``), summed over the shards that split the positions:
the global mean on every shard.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.core import spmd


# ---------------------------------------------------------------- norms ---
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * (1.0 + scale)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


# ----------------------------------------------------------------- RoPE ---
def rope(x: torch.Tensor, positions, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (S,) or (B, S). The angles in fp32
    (fp64 for fp64 x), the result in x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    ct = torch.promote_types(x.dtype, torch.float32)
    positions = torch.as_tensor(positions, device=x.device)
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=ct, device=x.device) / half)
    if positions.dim() == 1:
        ang = positions.to(ct)[:, None] * freqs[None, :]
        ang = ang[None, :, None, :]  # (1, S, 1, half)
    else:
        ang = positions.to(ct)[..., None] * freqs
        ang = ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention ---
def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk", x, w) as one matrix product."""
    d, H, hd = w.shape
    return (x @ w.reshape(d, H * hd)).unflatten(-1, (H, hd))


def merge_heads(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd", o, w) as one matrix product."""
    H, hd, d = w.shape
    return o.flatten(-2) @ w.reshape(H * hd, d)


def chunked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    q_pos,
    kv_pos,
    causal: bool = True,
    window: int = 0,
    attn_softcap: float = 0.0,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax GQA attention.

    q: (B, Sq, H, hd); k, v: (B, Skv, Hkv, hd); q_pos: (Sq,) global
    positions; kv_pos: (Skv,) global positions (-1 entries = invalid/pad).
    ``window > 0``: only kv with q_pos - kv_pos < window attend (sliding
    window); combined with ``causal``. Returns (B, Sq, H, hd) in q's
    dtype. Accumulates in fp32 (fp64 for fp64 inputs, as a yardstick).
    """
    B, Sq, H, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5
    ct = torch.promote_types(q.dtype, torch.float32)
    dev = q.device
    q_pos = torch.as_tensor(q_pos, device=dev)
    kv_pos = torch.as_tensor(kv_pos, device=dev)

    kv_chunk = min(kv_chunk, Skv)
    pad = (-Skv) % kv_chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = F.pad(kv_pos, (0, pad), value=-1)
    nck = (Skv + pad) // kv_chunk

    # q scaled in its storage dtype (the scale rounded to it), as the
    # reference does before its fp32-accumulating product
    qg = (q.reshape(B, Sq, Hkv, G, hd)
          * torch.tensor(scale, dtype=q.dtype, device=dev)).to(ct)
    m = torch.full((B, Hkv, G, Sq), float("-inf"), dtype=ct, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=ct, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, hd), dtype=ct, device=dev)
    for c in range(nck):
        sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
        kc, vc, pc = k[:, sl], v[:, sl], kv_pos[sl]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.to(ct))
        if attn_softcap > 0.0:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        valid = (pc >= 0)[None, :]
        if causal:
            valid = valid & (pc[None, :] <= q_pos[:, None])
        if window > 0:
            valid = valid & (q_pos[:, None] - pc[None, :] < window)
        s.masked_fill_(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m_new == -inf)
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        del s
        p = p.masked_fill(~valid, 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        # p cast to v's dtype before the PV product, as the reference
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).to(ct),
                          vc.to(ct))
        del p
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, kc: torch.Tensor, vc: torch.Tensor,
                     cur: int, *, window: int = 0,
                     attn_softcap: float = 0.0) -> torch.Tensor:
    """One query token at position ``cur`` against a cache whose first
    ``cur + 1`` slots are filled (the rest masked as padding)."""
    kv_pos = torch.arange(kc.shape[1], device=kc.device)
    kv_pos = torch.where(kv_pos < cur + 1, kv_pos, -1)
    return chunked_attention(
        q, kc, vc, q_pos=torch.full((1,), cur, device=kc.device),
        kv_pos=kv_pos, causal=True, window=window,
        attn_softcap=attn_softcap)


def cache_write(cache: torch.Tensor, x: torch.Tensor,
                cur: int) -> torch.Tensor:
    """``x`` (B, 1, ...) written into slot ``cur`` of ``cache`` (B,
    max_len, ...) in place, as XLA updates the reference's cache buffer;
    returns ``cache``."""
    cache[:, cur:cur + 1] = x.to(cache.dtype)
    return cache


# ---------------------------------------------------- under a policy ---
def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, vocab: int,
                lay=None) -> torch.Tensor:
    """``table[tokens]``; under ``lay`` with ``table`` this shard's block
    of the ``vocab`` rows (cut over the model axis), each shard's rows
    for the tokens it holds, zeros for the others, summed over the model
    axis."""
    if lay is None or table.shape[0] == vocab:
        return table[tokens]
    n = table.shape[0]
    local = tokens - lay.model.index * n
    valid = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    return lay.model.psum(torch.where(valid[..., None], rows, 0.0))


def gather_vocab(logits: torch.Tensor, vocab: int, lay=None) -> torch.Tensor:
    """Logits (..., V / n) of this shard's block of the vocabulary
    all-gathered to (..., V) (as they are where not cut)."""
    if lay is None or logits.shape[-1] == vocab:
        return logits
    return lay.model.all_gather(logits, logits.dim() - 1)


def lm_cross_entropy(h: torch.Tensor, unembed: torch.Tensor, labels,
                     *, vocab: int, cap: float = 0.0, masked: bool = True,
                     drop: int = 0, lay=None) -> torch.Tensor:
    """The mean next-token cross entropy of the final hidden states ``h``
    (B, s, D) against ``labels`` (B, S) over the labels >= 0 (all of
    them unless ``masked``), the logits ``softcap(h @ unembed.T, cap)``
    in fp32 from the first ``drop`` positions on (a VLM's image prefix).
    Unsharded it is the models' loss. Under ``lay`` (per shard): ``h``
    is this shard's block of the positions under a plan that cuts the
    sequence, and ``labels`` every position of the shard's batch rows;
    ``unembed`` may be this shard's block of the vocabulary. A cut
    vocabulary (or a prefix to drop) gathers the sequence first; the
    loss is summed over the shards that split the positions (the data
    axes, and the model axis where the positions stay cut): the global
    mean, on every shard."""
    dt = h.dtype
    labels = torch.as_tensor(labels, device=h.device).long()
    cut = lay is not None and unembed.shape[0] < vocab
    split = lay is not None and lay.seq_split
    if split and (cut or drop):
        h, split = lay.model.all_gather(h, 1), False
    logits = softcap(h @ unembed.t(), cap)
    if drop:
        logits = logits[:, drop:]
    if split:
        labels = lay.local_rows(labels)
    lf = logits.float()
    if cut:
        n = unembed.shape[0]
        m = lay.model.pmax(lf.amax(dim=-1))
        lse = m + torch.log(lay.model.psum(
            torch.exp(lf - m[..., None]).sum(dim=-1)))
        local = labels - lay.model.index * n
        valid = (local >= 0) & (local < n)
        picked = lf.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
        true_logit = lay.model.psum(torch.where(valid, picked, 0.0))
    else:
        lse = torch.logsumexp(lf, dim=-1)
        true_logit = lf.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    if lay is None:
        if not masked:
            return (lse - true_logit).mean().to(dt)
        mask = (labels >= 0).float()
        return (((lse - true_logit) * mask).sum()
                / torch.clamp(mask.sum(), min=1.0)).to(dt)
    mask = ((labels >= 0) if masked else torch.ones_like(labels)).float()
    axes = tuple(lay.policy.data_axes) + ((lay.axis,) if split else ())
    total, count = spmd.axis(axes).psum((((lse - true_logit) * mask).sum(),
                                         mask.sum()))
    return (total / torch.clamp(count, min=1.0)).to(dt)


def head_out(o: torch.Tensor, wo: torch.Tensor, num_heads: int,
             lay=None) -> torch.Tensor:
    """``o`` (B, S, h, hd) through ``wo`` (h, hd, D); summed over the
    model axis where the heads are cut."""
    out = merge_heads(o, wo)
    if lay is not None and wo.shape[0] < num_heads:
        out = lay.model.psum(out)
    return out


def own_heads(o: torch.Tensor, wo: torch.Tensor, lay=None) -> torch.Tensor:
    """This shard's heads of every head's output (B, S, H, hd), where
    ``wo`` holds its block of the heads."""
    if lay is None or wo.shape[0] == o.shape[2]:
        return o
    return o.narrow(2, lay.model.index * wo.shape[0], wo.shape[0])


def ffn_out(out: torch.Tensor, w_down: torch.Tensor, d_ff: int,
            lay=None) -> torch.Tensor:
    """An MLP's output, summed over the model axis where its d_ff is
    cut."""
    if lay is not None and w_down.shape[0] < d_ff:
        out = lay.model.psum(out)
    return out


# ------------------------------------------------------------------ MLP ---
def _act(name: str):
    # jax.nn.gelu's default is the tanh approximation
    return F.silu if name == "silu" else (
        lambda x: F.gelu(x, approximate="tanh"))


def gated_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              w_down: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    h = _act(activation)(x @ w_gate) * (x @ w_up)
    return h @ w_down


def plain_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
              activation: str = "gelu") -> torch.Tensor:
    act = _act("gelu" if activation == "gelu" else "silu")
    return act(x @ w_up) @ w_down


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------- init ---
def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan_in) (``shape[0]`` unless
    given), drawn from ``generator`` on its device."""
    fi = fan_in if fan_in is not None else shape[0]
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device)
    return (w * math.sqrt(1.0 / fi)).to(dtype)
