"""Decoder/encoder transformer stacks of the assigned architectures,
unsharded (the reference's ``models/transformer.py`` under
``NO_POLICY``).

Layers are stacked on a leading L axis in the reference's tree
(``params["layers"][name]`` is (num_layers, ...)) and run as a Python
loop. Variants:

* GQA attention with RoPE, optional QKV bias (qwen1.5), attention and
  final-logit softcapping (gemma2), alternating local/global layers
  (gemma2: even layers take the sliding window, odd ones attend
  globally, as the reference's scan over pairs).
* SwiGLU / plain-GELU FFN, or the MoE FFN (phi3.5-moe; arctic adds a
  dense residual FFN beside it).
* Encoder mode (hubert): bidirectional attention, per-frame logits,
  float inputs (``embed_inputs=False``).
* VLM mode (phi-3-vision): precomputed patch embeddings prepended to
  the text embeddings (``extra_embeds``).

The forward is differentiable. Under ``core/flags.REMAT`` each layer
(each local/global pair under ``alt_local_global``) is rematerialized
(``flags.maybe_remat``) where the reference wraps its scan body in
``jax.checkpoint``. The reference's behaviour is kept where it is odd:
the attention sub-block normalizes only when ``cfg.norm == "rmsnorm"``
(the FFN and the final norm always use rmsnorm, and so does
``decode_step``); the embedding is scaled by sqrt(d_model) whenever
``logit_softcap`` is set; ``lm_loss`` adds 0.01 x the MoE aux loss. Entry points run where the
parameters are; ``init_params`` and ``params_from_numpy`` put them on
the card unless given a device.

Under a sharding policy over an in-process mesh (``core/sharding.py``)
the entry points are per-shard functions, called inside ``spmd.run``
with each shard's blocks of the parameters
(``core/param_specs.infer_param_specs``) and of the batch (its rows of
the data axes, every position); they write out the dataflow the
reference leaves to GSPMD:

* ``tp``: the query/key/value heads a shard holds attend locally (its
  query heads against every key/value head, ``tp_attention``, where the
  key/value heads are not cut), and one ``psum`` over the model axis
  follows ``wo``; the MLP's d_ff columns are local and one ``psum``
  follows ``w_down``; the embedding looks up this shard's block of the
  vocabulary and sums (``layers.vocab_embed``); the loss is
  vocabulary-parallel (``layers.lm_cross_entropy``).
* ``cp``/``ep``: each shard runs its block of the sequence (RoPE and
  positions offset by the block's start); attention through
  ``seq_parallel.cp_attention``; weights whole.
* MoE: under ``ep`` with ``flags.EP_ALLTOALL`` and the experts cut,
  ``moe.moe_ffn_ep``; else ``moe.moe_ffn_gathered`` (the global
  tokens' routing and drops, the reference's ``moe_ffn``).
* Weights a block cannot use cut (``sharding.LOCAL_DIMS``) are
  all-gathered before use, each adjoint a reduce-scatter: q/k/v and
  their biases cut on ``hd`` (H not dividing), ``wo`` on ``hd``, and
  every dimension FSDP cuts over the data axes.
* Decode with more than one model shard keeps the KV cache cut on its
  sequence (``max_len / n`` slots a shard) under every plan: the
  token's heads gathered, the owner writes its slot
  (``cache_update_sharded``), ``decode_attention_sharded_kv`` merges;
  ``prefill`` moves its keys and values into that layout.
* ``lm_loss`` returns the global mean on every shard.

Under ``flags.REMAT`` each layer (pair) is rematerialized through
``flags.maybe_remat``, which inside a run goes through
``spmd.checkpoint``. A ``ProcessMesh`` raises (a later slice).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.core import flags, seq_parallel
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_specs import infer_param_specs
from repro_torch.core.sharding import Layout, check_policy
from repro_torch.launch.mesh import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (ffn_out, gather_vocab, gated_mlp,
                                       head_out, lm_cross_entropy, own_heads,
                                       plain_mlp, project_heads, rmsnorm,
                                       rope, softcap, vocab_embed)

Params = Dict[str, Any]


def check_supported(cfg, policy=None, mesh=None) -> bool:
    """Raise for what this module does not run, naming where it runs;
    whether the call is sharded (``sharding.check_policy``)."""
    if not isinstance(cfg, TransformerConfig):
        raise NotImplementedError(
            f"{getattr(cfg, 'name', cfg)!r}: transformer runs "
            "TransformerConfig models; SSMConfig and HybridConfig run "
            "through repro_torch.models.ssm_lm")
    return check_policy(policy, mesh)


def layout(cfg: TransformerConfig, policy=None, mesh=None
           ) -> Optional[Layout]:
    """This shard's ``Layout`` under ``policy`` (None unsharded)."""
    if not check_supported(cfg, policy, mesh):
        return None
    return Layout(policy, infer_param_specs(param_shapes(cfg), policy))


# ----------------------------------------------------------------- init ---
def _layer_param_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, Hkv, Fd = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    shapes = {
        "ln1": (d,),
        "ln2": (d,),
        "wq": (d, H, hd),
        "wk": (d, Hkv, hd),
        "wv": (d, Hkv, hd),
        "wo": (H, hd, d),
    }
    if cfg.qkv_bias:
        shapes.update({"bq": (H, hd), "bk": (Hkv, hd), "bv": (Hkv, hd)})
    if cfg.num_experts:
        shapes.update({
            "router": (d, cfg.num_experts),
            "w_gate_e": (cfg.num_experts, d, Fd),
            "w_up_e": (cfg.num_experts, d, Fd),
            "w_down_e": (cfg.num_experts, Fd, d),
        })
        if cfg.moe_dense_residual:
            Fr = cfg.dense_residual_d_ff or Fd
            shapes.update({
                "w_gate_r": (d, Fr), "w_up_r": (d, Fr), "w_down_r": (Fr, d),
            })
    elif cfg.gated_mlp:
        shapes.update({"w_gate": (d, Fd), "w_up": (d, Fd), "w_down": (Fd, d)})
    else:
        shapes.update({"w_up": (d, Fd), "w_down": (Fd, d)})
    return shapes


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's shapes: ``layers`` nested, each (L, ...)."""
    d = cfg.d_model
    shapes: Dict[str, Any] = {
        "layers": {name: (cfg.num_layers,) + shp
                   for name, shp in _layer_param_shapes(cfg).items()},
        "final_norm": (d,),
    }
    if cfg.embed_inputs:
        shapes["embed"] = (cfg.vocab_size, d)
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_size, d)
    return shapes


def _fan_in(name: str, shp: Tuple[int, ...]) -> int:
    if name == "wo":
        return shp[0] * shp[1]
    if len(shp) <= 2:
        return shp[0]
    return shp[1] if name.endswith("_e") else shp[0]


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters by the reference's law: zero norms and biases,
    1/sqrt(fan_in) normal weights (fan-in d_model, H x hd for ``wo``,
    an expert's input width for the ``_e`` stacks), embeddings
    N(0, 0.02), the unembedding 1/sqrt(d_model). Drawn in ``dtype``
    directly (as the reference draws), from ``generator`` on its device,
    then moved to ``device`` (the card when None): draw on the card with
    a CUDA generator where the weights are large."""
    check_supported(cfg)
    dev = resolve_device(device)
    gd = generator.device
    L, d = cfg.num_layers, cfg.d_model

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=gd, dtype=dtype)
        return w.mul_(torch.tensor(scale, dtype=dtype, device=gd)).to(dev)

    layers = {}
    for name, shp in sorted(_layer_param_shapes(cfg).items()):
        if name.startswith(("ln", "b")):
            layers[name] = torch.zeros((L,) + shp, dtype=dtype, device=dev)
        else:
            layers[name] = normal((L,) + shp,
                                  math.sqrt(1.0 / _fan_in(name, shp)))
    params: Params = {"layers": layers,
                      "final_norm": torch.zeros((d,), dtype=dtype,
                                                device=dev)}
    if cfg.embed_inputs:
        params["embed"] = normal((cfg.vocab_size, d), 0.02)
    if not cfg.tie_embeddings:
        params["unembed"] = normal((cfg.vocab_size, d), math.sqrt(1.0 / d))
    return params


def params_from_numpy(tree: Mapping[str, Any], cfg: TransformerConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's parameter tree (``repro.models.transformer.
    init_params`` as numpy arrays) as the port's: the same layouts, so a
    device and dtype move with name and shape checks against ``cfg``.
    ``device=None`` is the card; ``dtype=None`` keeps each array's."""
    check_supported(cfg)
    return tree_lib.from_numpy(tree, param_shapes(cfg), cfg.name,
                               resolve_device(device), dtype)


# ------------------------------------------------------------- blocks -----
def _dtype(params: Params) -> torch.dtype:
    return params["final_norm"].dtype


def _device(params: Params) -> torch.device:
    return params["final_norm"].device


def _layer(params: Params, i: int, lay=None) -> Dict[str, torch.Tensor]:
    if lay is not None:
        return lay.layer(params["layers"], lay.specs["layers"], i)
    return {k: v[i] for k, v in params["layers"].items()}


def _top(params: Params, name: str, lay=None) -> torch.Tensor:
    if lay is None:
        return params[name]
    return lay.leaf(name, params[name], lay.specs[name])


def _unembed(params: Params, lay=None) -> torch.Tensor:
    return _top(params, "unembed" if "unembed" in params else "embed", lay)


def _embed(params: Params, tokens: torch.Tensor, cfg: TransformerConfig,
           lay=None) -> torch.Tensor:
    h = vocab_embed(_top(params, "embed", lay), tokens, cfg.vocab_size, lay)
    if cfg.logit_softcap:  # gemma-style embed scaling
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def _qkv(lp, hn, cfg: TransformerConfig, pos):
    q = project_heads(hn, lp["wq"])
    k = project_heads(hn, lp["wk"])
    v = project_heads(hn, lp["wv"])
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def _attn(lp, h, cfg: TransformerConfig, *, window: int, pos, lay=None):
    """One attention sub-block over the whole sequence (this shard's
    block of it under a plan that cuts it): (h, (k, v))."""
    hn = rmsnorm(h, lp["ln1"]) if cfg.norm == "rmsnorm" else h
    q, k, v = _qkv(lp, hn, cfg, pos)
    o = seq_parallel.attention(
        q, k, v, num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        pos=pos, causal=cfg.causal, window=window,
        attn_softcap=cfg.attn_softcap, lay=lay)
    return h + head_out(o, lp["wo"], cfg.num_heads, lay), (k, v)


def _ffn(lp, h, cfg: TransformerConfig, lay=None, decode: bool = False):
    hn = rmsnorm(h, lp["ln2"])
    aux = torch.zeros((), dtype=h.dtype, device=h.device)
    if cfg.num_experts:
        p = {"router": lp["router"], "w_gate": lp["w_gate_e"],
             "w_up": lp["w_up_e"], "w_down": lp["w_down_e"]}
        kw = dict(num_experts=cfg.num_experts, top_k=cfg.top_k)
        if lay is None:
            out, aux = moe_lib.moe_ffn(p, hn, **kw)
        elif (not decode and flags.EP_ALLTOALL and lay.policy.plan == "ep"
              and lay.seq_split and p["w_gate"].shape[0] < cfg.num_experts):
            out, aux = moe_lib.moe_ffn_ep(p, hn, policy=lay.policy, **kw)
        else:
            out, aux = moe_lib.moe_ffn_gathered(
                p, hn, policy=lay.policy,
                seq_split=lay.seq_split and not decode, **kw)
        if cfg.moe_dense_residual:
            out = out + ffn_out(
                gated_mlp(hn, lp["w_gate_r"], lp["w_up_r"], lp["w_down_r"]),
                lp["w_down_r"], cfg.dense_residual_d_ff or cfg.d_ff, lay)
    elif cfg.gated_mlp:
        out = ffn_out(gated_mlp(hn, lp["w_gate"], lp["w_up"], lp["w_down"]),
                      lp["w_down"], cfg.d_ff, lay)
    else:
        out = ffn_out(plain_mlp(hn, lp["w_up"], lp["w_down"]), lp["w_down"],
                      cfg.d_ff, lay)
    return h + out, aux


def window_for_layer(cfg: TransformerConfig, li: int) -> int:
    """Layer ``li``'s attention window (0: global). Under
    ``alt_local_global`` even layers are local and odd ones global (the
    reference's (local, global) pairs)."""
    if not cfg.sliding_window:
        return 0
    if cfg.alt_local_global:
        return cfg.sliding_window if li % 2 == 0 else 0
    return cfg.sliding_window


def _positions(h: torch.Tensor, lay=None) -> torch.Tensor:
    if lay is None:
        return torch.arange(h.shape[1], device=h.device)
    return lay.positions(h.shape[1], h.device)


def _unit(cfg: TransformerConfig, names, lo: int, hi: int, lay=None):
    """Layers ``lo`` to ``hi - 1`` as one function of tensors, ``(h, aux,
    *stacks) -> (h, aux)`` (each stack the layers' slice of one leaf,
    ``names`` order): a ``flags.maybe_remat`` unit. It holds nothing of
    its shard (positions from the shard's index), as a rematerialized
    block under ``spmd.checkpoint`` must."""
    def unit(h, aux, *stacks):
        pos = _positions(h, lay)
        stack = dict(zip(names, stacks))
        for j, li in enumerate(range(lo, hi)):
            lp = ({n: t[j] for n, t in stack.items()} if lay is None else
                  lay.layer(stack, lay.specs["layers"], j))
            h, _ = _attn(lp, h, cfg, window=window_for_layer(cfg, li),
                         pos=pos, lay=lay)
            h, a = _ffn(lp, h, cfg, lay)
            aux = aux + a
        return h, aux
    return unit


def _stack(params: Params, h: torch.Tensor, cfg: TransformerConfig,
           keep_kv: bool = False, lay=None):
    """Every layer over the whole sequence (this shard's block of it
    under a plan that cuts it): (h, aux, [(k, v)] if ``keep_kv``).
    Without ``keep_kv`` each layer (a local/global pair under
    ``alt_local_global``, as the reference's scan over pairs) is one
    ``flags.maybe_remat`` unit."""
    aux = torch.zeros((), dtype=h.dtype, device=h.device)
    kvs = []
    if keep_kv:
        pos = _positions(h, lay)
        for li in range(cfg.num_layers):
            lp = _layer(params, li, lay)
            h, kv = _attn(lp, h, cfg, window=window_for_layer(cfg, li),
                          pos=pos, lay=lay)
            h, _ = _ffn(lp, h, cfg, lay)
            kvs.append(kv)
        return h, aux, kvs
    step = 2 if cfg.alt_local_global else 1
    names = sorted(params["layers"])
    for lo in range(0, cfg.num_layers, step):
        hi = min(lo + step, cfg.num_layers)
        body = flags.maybe_remat(_unit(cfg, names, lo, hi, lay))
        h, aux = body(h, aux, *(params["layers"][n][lo:hi] for n in names))
    return h, aux, kvs


def _logits(params: Params, h: torch.Tensor, cfg: TransformerConfig,
            lay=None) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"])
    return softcap(h @ _unembed(params, lay).t(), cfg.logit_softcap)


def _hidden(params: Params, inputs, cfg: TransformerConfig, lay=None,
            extra_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the last layer's hidden states, the MoE aux loss): of every
    position, or of this shard's block of them under a plan that cuts
    the sequence (the whole sequence embedded, then cut)."""
    dev, dt = _device(params), _dtype(params)
    inputs = torch.as_tensor(inputs, device=dev)
    if cfg.embed_inputs and not inputs.is_floating_point():
        h = _embed(params, inputs.long(), cfg, lay)
    else:
        h = inputs.to(dt)
    if extra_embeds is not None:
        h = torch.cat([torch.as_tensor(extra_embeds, device=dev).to(h.dtype),
                       h], dim=1)
    if lay is not None:
        h = lay.local_rows(h)
    h, aux, _ = _stack(params, h, cfg, lay=lay)
    return h, aux


# ------------------------------------------------------------- forward ----
def forward(params: Params, inputs, cfg: TransformerConfig, policy=None,
            mesh=None, *, extra_embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. ``inputs``: tokens (B, S), or embeddings
    (B, S, D) when ``cfg.embed_inputs`` is False; ``extra_embeds`` (B,
    S_img, D) is prepended (the VLM's image prefix). Returns (logits
    (B, S_img + S, vocab), the MoE aux loss), in the parameters' dtype
    and on their device. Under a policy (per shard): this shard's rows,
    and its block of the positions under a plan that cuts them, every
    vocabulary entry."""
    lay = layout(cfg, policy, mesh)
    h, aux = _hidden(params, inputs, cfg, lay, extra_embeds)
    return gather_vocab(_logits(params, h, cfg, lay), cfg.vocab_size,
                        lay), aux


def lm_loss(params: Params, batch: Mapping[str, Any], cfg: TransformerConfig,
            policy=None, mesh=None) -> torch.Tensor:
    """Next-token (decoder) or per-frame (encoder) cross entropy over the
    labels >= 0 (fp32 log-sum-exp; the image prefix has no labels), plus
    0.01 x the MoE aux loss, in the logits' dtype. Under a policy (per
    shard, on the shard's rows of the batch): the global mean on every
    shard."""
    lay = layout(cfg, policy, mesh)
    extra = batch.get("image_embeds")
    h, aux = _hidden(params, batch["tokens"], cfg, lay, extra)
    h = rmsnorm(h, params["final_norm"])
    ce = lm_cross_entropy(
        h, _unembed(params, lay), batch["labels"], vocab=cfg.vocab_size,
        cap=cfg.logit_softcap, drop=0 if extra is None else extra.shape[1],
        lay=lay)
    return ce + 0.01 * aux


# --------------------------------------------------------------- decode ---
def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero ``k``/``v`` caches (num_layers, batch, max_len, num_kv_heads,
    head_dim) and ``pos`` 0 (under a policy: a shard's batch rows and
    its ``max_len / n`` slots)."""
    check_supported(cfg)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "pos": 0}


def decode_step(params: Params, cache: Mapping[str, Any], tokens,
                cfg: TransformerConfig, policy=None, mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One token (B, 1) against the KV cache: (logits (B, vocab), the
    cache at ``pos + 1``). The token's keys and values are written into
    the cache's ``k``/``v`` in place (one slot a layer, as XLA updates the
    reference's buffer), so the cache passed in is consumed: use the one
    returned. Layer li attends within ``window_for_layer(cfg, li)``.
    Under a policy (per shard): the shard's rows, its cache's slots."""
    lay = layout(cfg, policy, mesh)
    tokens = torch.as_tensor(tokens, device=_device(params)).long()
    h = _embed(params, tokens, cfg, lay)
    cur = cache["pos"]
    pos = torch.full((1,), cur, device=h.device)
    for li in range(cfg.num_layers):
        lp = _layer(params, li, lay)
        q, k, v = _qkv(lp, rmsnorm(h, lp["ln1"]), cfg, pos)
        o = seq_parallel.decode_attend(
            q, k, v, cache["k"][li], cache["v"][li], cur,
            num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
            window=window_for_layer(cfg, li), attn_softcap=cfg.attn_softcap,
            lay=lay)
        o = own_heads(o, lp["wo"], lay)
        h, _ = _ffn(lp, h + head_out(o, lp["wo"], cfg.num_heads, lay), cfg,
                    lay, decode=True)
    logits = gather_vocab(_logits(params, h, cfg, lay), cfg.vocab_size, lay)
    return logits[:, 0], dict(cache, pos=cur + 1)


def prefill(params: Params, tokens, cfg: TransformerConfig, policy=None,
            mesh=None, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The whole prompt (B, S), building the KV cache: (the last
    position's logits (B, vocab), the cache padded with zeros to
    ``max_len`` (S when None), ``pos`` S). Under a policy (per shard):
    the shard's rows; its cache the shard's ``max_len / n`` slots where
    decode cuts it (``to_cache_slots``)."""
    lay = layout(cfg, policy, mesh)
    tokens = torch.as_tensor(tokens, device=_device(params)).long()
    B, S = tokens.shape
    max_len = max_len or S
    seq_parallel.check_slots(max_len, lay)
    h = _embed(params, tokens, cfg, lay)
    if lay is not None:
        h = lay.local_rows(h)
    h, _, kvs = _stack(params, h, cfg, keep_kv=True, lay=lay)
    H = cfg.num_kv_heads
    slots = seq_parallel.to_cache_slots
    ks = torch.stack([slots(k, H, max_len, lay) for k, _ in kvs])
    vs = torch.stack([slots(v, H, max_len, lay) for _, v in kvs])
    del kvs
    last = h[:, -1]
    if lay is not None and lay.seq_split:  # the last shard's last row
        last = lay.model.all_gather(h[:, -1:], 1)[:, -1]
    logits = gather_vocab(_logits(params, last, cfg, lay), cfg.vocab_size,
                          lay)
    return logits, {"k": ks, "v": vs, "pos": S}
