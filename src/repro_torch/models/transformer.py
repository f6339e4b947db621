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
the card unless given a device. Sharding (a ``policy`` or ``mesh``)
comes with the sequence-parallel slice and raises here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import TransformerConfig
from repro_torch.core import flags
from repro_torch.core import tree as tree_lib
from repro_torch.launch.mesh import DeviceLike, resolve_device
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import (cache_write, chunked_attention,
                                       decode_attention, gated_mlp,
                                       merge_heads, plain_mlp, project_heads,
                                       rmsnorm, rope, softcap)
from repro_torch.models.ssm_lm import check_policy

Params = Dict[str, Any]


def check_supported(cfg, policy=None, mesh=None) -> None:
    """Raise for what this module does not run, naming where it runs."""
    if not isinstance(cfg, TransformerConfig):
        raise NotImplementedError(
            f"{getattr(cfg, 'name', cfg)!r}: transformer runs "
            "TransformerConfig models; SSMConfig and HybridConfig run "
            "through repro_torch.models.ssm_lm")
    check_policy(policy, mesh)


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


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _unembed(params: Params) -> torch.Tensor:
    return params["unembed"] if "unembed" in params else params["embed"]


def _embed(params: Params, tokens: torch.Tensor,
           cfg: TransformerConfig) -> torch.Tensor:
    h = params["embed"][tokens]
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


def _attn(lp, h, cfg: TransformerConfig, *, window: int, pos):
    """One attention sub-block over the whole sequence: (h, (k, v))."""
    hn = rmsnorm(h, lp["ln1"]) if cfg.norm == "rmsnorm" else h
    q, k, v = _qkv(lp, hn, cfg, pos)
    o = chunked_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=cfg.causal,
                          window=window, attn_softcap=cfg.attn_softcap)
    return h + merge_heads(o, lp["wo"]), (k, v)


def _ffn(lp, h, cfg: TransformerConfig):
    hn = rmsnorm(h, lp["ln2"])
    aux = torch.zeros((), dtype=h.dtype, device=h.device)
    if cfg.num_experts:
        p = {"router": lp["router"], "w_gate": lp["w_gate_e"],
             "w_up": lp["w_up_e"], "w_down": lp["w_down_e"]}
        out, aux = moe_lib.moe_ffn(p, hn, num_experts=cfg.num_experts,
                                   top_k=cfg.top_k)
        if cfg.moe_dense_residual:
            out = out + gated_mlp(hn, lp["w_gate_r"], lp["w_up_r"],
                                  lp["w_down_r"])
    elif cfg.gated_mlp:
        out = gated_mlp(hn, lp["w_gate"], lp["w_up"], lp["w_down"])
    else:
        out = plain_mlp(hn, lp["w_up"], lp["w_down"])
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


def _layers(params: Params, lo: int, hi: int, h: torch.Tensor,
            aux: torch.Tensor, cfg: TransformerConfig, pos: torch.Tensor,
            kvs: Optional[list] = None):
    """Layers ``lo`` to ``hi - 1``: (h, aux), each layer's (k, v)
    appended to ``kvs`` when given."""
    for li in range(lo, hi):
        lp = _layer(params, li)
        h, kv = _attn(lp, h, cfg, window=window_for_layer(cfg, li), pos=pos)
        h, a = _ffn(lp, h, cfg)
        aux = aux + a
        if kvs is not None:
            kvs.append(kv)
    return h, aux


def _stack(params: Params, h: torch.Tensor, cfg: TransformerConfig,
           pos: torch.Tensor, keep_kv: bool = False):
    """Every layer over the whole sequence: (h, aux, [(k, v)] if
    ``keep_kv``). Without ``keep_kv`` each layer (a local/global pair
    under ``alt_local_global``, as the reference's scan over pairs) is
    one ``flags.maybe_remat`` unit."""
    aux = torch.zeros((), dtype=h.dtype, device=h.device)
    kvs = []
    if keep_kv:
        h, aux = _layers(params, 0, cfg.num_layers, h, aux, cfg, pos, kvs)
        return h, aux, kvs
    unit = 2 if cfg.alt_local_global else 1
    body = flags.maybe_remat(_layers)
    for lo in range(0, cfg.num_layers, unit):
        h, aux = body(params, lo, min(lo + unit, cfg.num_layers), h, aux,
                      cfg, pos)
    return h, aux, kvs


def _logits(params: Params, h: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    h = rmsnorm(h, params["final_norm"])
    return softcap(h @ _unembed(params).t(), cfg.logit_softcap)


# ------------------------------------------------------------- forward ----
def forward(params: Params, inputs, cfg: TransformerConfig, policy=None,
            mesh=None, *, extra_embeds=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. ``inputs``: tokens (B, S), or embeddings
    (B, S, D) when ``cfg.embed_inputs`` is False; ``extra_embeds`` (B,
    S_img, D) is prepended (the VLM's image prefix). Returns (logits
    (B, S_img + S, vocab), the MoE aux loss), in the parameters' dtype
    and on their device."""
    check_supported(cfg, policy, mesh)
    dev, dt = _device(params), _dtype(params)
    inputs = torch.as_tensor(inputs, device=dev)
    if cfg.embed_inputs and not inputs.is_floating_point():
        h = _embed(params, inputs.long(), cfg)
    else:
        h = inputs.to(dt)
    if extra_embeds is not None:
        h = torch.cat([torch.as_tensor(extra_embeds, device=dev).to(h.dtype),
                       h], dim=1)
    pos = torch.arange(h.shape[1], device=dev)
    h, aux, _ = _stack(params, h, cfg, pos)
    return _logits(params, h, cfg), aux


def lm_loss(params: Params, batch: Mapping[str, Any], cfg: TransformerConfig,
            policy=None, mesh=None) -> torch.Tensor:
    """Next-token (decoder) or per-frame (encoder) cross entropy over the
    labels >= 0 (fp32 log-sum-exp; the image prefix has no labels), plus
    0.01 x the MoE aux loss, in the logits' dtype."""
    logits, aux = forward(params, batch["tokens"], cfg, policy, mesh,
                          extra_embeds=batch.get("image_embeds"))
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    if logits.shape[1] != labels.shape[1]:  # VLM: image prefix
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = lf.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ((lse - true_logit) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce.to(logits.dtype) + 0.01 * aux


# --------------------------------------------------------------- decode ---
def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero ``k``/``v`` caches (num_layers, batch, max_len, num_kv_heads,
    head_dim) and ``pos`` 0."""
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
    returned. Layer li attends within ``window_for_layer(cfg, li)``."""
    check_supported(cfg, policy, mesh)
    tokens = torch.as_tensor(tokens, device=_device(params)).long()
    h = _embed(params, tokens, cfg)
    cur = cache["pos"]
    pos = torch.full((1,), cur, device=h.device)
    for li in range(cfg.num_layers):
        lp = _layer(params, li)
        q, k, v = _qkv(lp, rmsnorm(h, lp["ln1"]), cfg, pos)
        o = decode_attention(q, cache_write(cache["k"][li], k, cur),
                             cache_write(cache["v"][li], v, cur), cur,
                             window=window_for_layer(cfg, li),
                             attn_softcap=cfg.attn_softcap)
        h, _ = _ffn(lp, h + merge_heads(o, lp["wo"]), cfg)
    logits = _logits(params, h, cfg)
    return logits[:, 0], dict(cache, pos=cur + 1)


def prefill(params: Params, tokens, cfg: TransformerConfig, policy=None,
            mesh=None, max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The whole prompt (B, S), building the KV cache: (the last
    position's logits (B, vocab), the cache padded with zeros to
    ``max_len`` (S when None), ``pos`` S)."""
    check_supported(cfg, policy, mesh)
    tokens = torch.as_tensor(tokens, device=_device(params)).long()
    B, S = tokens.shape
    max_len = max_len or S
    h = _embed(params, tokens, cfg)
    h, _, kvs = _stack(params, h, cfg, torch.arange(S, device=h.device),
                       keep_kv=True)
    pad = (0, 0, 0, 0, 0, max(max_len - S, 0))
    ks = torch.stack([F.pad(k, pad) for k, _ in kvs])
    vs = torch.stack([F.pad(v, pad) for _, v in kvs])
    del kvs
    logits = _logits(params, h[:, -1], cfg)
    return logits, {"k": ks, "v": vs, "pos": S}
