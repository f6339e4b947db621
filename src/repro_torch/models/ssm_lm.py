"""Mamba2 language model (SSM family) and Zamba2 hybrid.

mamba2-370m: 48 attention-free SSD blocks, each ``h + block(rmsnorm(h))``,
then a final norm and the unembedding (tied to ``embed`` when
``tie_embeddings``). zamba2-1.2b (``HybridConfig``): 38 Mamba2 blocks in
groups of ``attn_every``, each group followed by the ONE shared
attention + gated-MLP block (the same parameters at every application,
as the reference simplifies arXiv:2411.15242), then the remaining
blocks. The shared attention's heads are ``d_model // num_heads`` wide,
not ``head_dim`` (the SSD head width); its KV cache keeps one slot per
application.

Parameters keep the reference's tree and layouts, layers stacked on a
leading axis (``params["blocks"][name]`` is (num_layers, ...)), so a
reference parameter tree carries over with no transpose
(``params_from_numpy``). The layers run as a Python loop; each block's
scan goes through the hand-written SSD kernel (``models/mamba2.py``).
The forward is differentiable; under ``core/flags.REMAT`` each Mamba2
block is rematerialized (``flags.maybe_remat``) where the reference
wraps it in ``jax.checkpoint``, the shared attention block not
(``kernel_launches`` counts the recompute's scans).

Entry points run where the parameters are; ``init_params`` and
``params_from_numpy`` put them on the card unless given a device.
Sequence- or tensor-parallel sharding (a ``policy`` or ``mesh``) comes
with a later slice and raises here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.configs.base import HybridConfig, SSMConfig
from repro_torch.core import flags
from repro_torch.core import tree as tree_lib
from repro_torch.launch.mesh import DeviceLike, resolve_device
from repro_torch.models import mamba2
from repro_torch.models.layers import (cache_write, chunked_attention,
                                       decode_attention, dense_init,
                                       gated_mlp, merge_heads, project_heads,
                                       rmsnorm, rope)

Params = Dict[str, Any]
LMConfig = Union[SSMConfig, HybridConfig]
BLOCK_PARAMS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                "norm_scale", "out_proj")


def check_policy(policy=None, mesh=None) -> None:
    """Raise for a sharding policy or mesh, naming the slice that brings
    them."""
    if policy is not None or mesh is not None:
        raise NotImplementedError(
            "sharding policies and meshes (tensor and context parallelism, "
            "seq_parallel.cp_ssd / cp_attention, expert parallelism) come "
            "with the sequence-parallel slice of the port; call without "
            "policy and mesh")


def check_supported(cfg, policy=None, mesh=None) -> None:
    """Raise for what this module does not run, naming where it runs."""
    if not isinstance(cfg, (SSMConfig, HybridConfig)):
        raise NotImplementedError(
            f"{getattr(cfg, 'name', cfg)!r}: ssm_lm runs SSMConfig and "
            "HybridConfig language models; a TransformerConfig runs "
            "through repro_torch.models.transformer "
            "(repro_torch.models.lm_module)")
    check_policy(policy, mesh)


def _head_width(cfg: HybridConfig) -> int:
    """The shared attention's head width: d_model // num_heads (not
    ``cfg.head_dim``, the SSD head width)."""
    return cfg.d_model // cfg.num_heads


def param_shapes(cfg: LMConfig) -> Dict[str, Any]:
    """The parameter tree's shapes: name -> shape, ``blocks`` (and the
    hybrid's ``shared_attn``) nested."""
    L, d, di = cfg.num_layers, cfg.d_model, cfg.d_inner
    N, H, K = cfg.ssm_state, cfg.num_ssm_heads, cfg.conv_width
    conv_ch = di + 2 * N
    shapes: Dict[str, Any] = {
        "embed": (cfg.vocab_size, d),
        "blocks": {
            "in_proj": (L, d, 2 * di + 2 * N + H),
            "conv_w": (L, K, conv_ch), "conv_b": (L, conv_ch),
            "dt_bias": (L, H), "A_log": (L, H), "D": (L, H),
            "norm_scale": (L, di), "out_proj": (L, di, d),
        },
        "block_norms": (L, d),
        "final_norm": (d,),
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab_size, d)
    if isinstance(cfg, HybridConfig):
        hd, nh, nkv = _head_width(cfg), cfg.num_heads, cfg.num_kv_heads
        shapes["shared_attn"] = {
            "ln1": (d,), "ln2": (d,),
            "wq": (d, nh, hd), "wk": (d, nkv, hd), "wv": (d, nkv, hd),
            "wo": (nh, hd, d),
            "w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
            "w_down": (cfg.d_ff, d),
        }
    return shapes


def init_params(cfg: LMConfig, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.float32) -> Params:
    """Random parameters by the reference's law (embeddings N(0, 0.02),
    1/sqrt(fan_in) dense weights, A = -1, D = 1, zero norms and
    biases), drawn from ``generator`` on its device (a CPU generator
    gives the same weights on every device), then moved to ``device``
    (the card when None)."""
    check_supported(cfg)
    dev = resolve_device(device)
    gd = generator.device
    per = [mamba2.init_block_params(generator, cfg.d_model, cfg.d_inner,
                                    cfg.ssm_state, cfg.num_ssm_heads,
                                    cfg.conv_width, dtype)
           for _ in range(cfg.num_layers)]
    params: Params = {
        "embed": (torch.randn((cfg.vocab_size, cfg.d_model),
                              generator=generator, device=gd)
                  * 0.02).to(dtype),
        "blocks": {k: torch.stack([p[k] for p in per]) for k in BLOCK_PARAMS},
        "block_norms": torch.zeros((cfg.num_layers, cfg.d_model),
                                   dtype=dtype, device=gd),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dtype, device=gd),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = (torch.randn((cfg.vocab_size, cfg.d_model),
                                         generator=generator, device=gd)
                             * math.sqrt(1.0 / cfg.d_model)).to(dtype)
    if isinstance(cfg, HybridConfig):
        fan_in = {"wo": cfg.num_heads * _head_width(cfg)}
        params["shared_attn"] = {
            name: (torch.zeros(shape, dtype=dtype, device=gd)
                   if name.startswith("ln") else
                   dense_init(generator, shape, dtype,
                              fan_in=fan_in.get(name)))
            for name, shape in param_shapes(cfg)["shared_attn"].items()}
    return tree_lib.tree_map(lambda t: t.to(dev), params)


def params_from_numpy(tree: Mapping[str, Any], cfg: LMConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's parameter tree (``repro.models.ssm_lm.init_params``
    as numpy arrays) as the port's: the layouts are identical, so this is
    a device and dtype move with name and shape checks against ``cfg``.
    ``device=None`` is the card; ``dtype=None`` keeps each array's."""
    check_supported(cfg)
    return tree_lib.from_numpy(tree, param_shapes(cfg), cfg.name,
                               resolve_device(device), dtype)


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["blocks"].items()}


def _unembed(params: Params) -> torch.Tensor:
    return params.get("unembed", params["embed"])


def _tokens(params: Params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def kernel_launches(cfg: LMConfig, train: bool = False) -> int:
    """ssd_scan launches of one forward (one a Mamba2 block), or of one
    training step: the forward's, and again each block's under
    ``flags.REMAT`` (its recompute; the scan's backward launches none)."""
    check_supported(cfg)
    return cfg.num_layers * (2 if train and flags.REMAT else 1)


def _mamba_block(params: Params, i: int, h: torch.Tensor,
                 cfg: LMConfig) -> torch.Tensor:
    hn = rmsnorm(h, params["block_norms"][i])
    return h + mamba2.block_forward(
        _layer(params, i), hn, num_heads=cfg.num_ssm_heads,
        head_dim=cfg.head_dim, ssm_state=cfg.ssm_state,
        chunk=cfg.chunk_size)


def _shared_mlp(sp: Params, h: torch.Tensor) -> torch.Tensor:
    hn = rmsnorm(h, sp["ln2"])
    return h + gated_mlp(hn, sp["w_gate"], sp["w_up"], sp["w_down"])


def _shared_qkv(sp: Params, h: torch.Tensor, pos, cfg: HybridConfig):
    hn = rmsnorm(h, sp["ln1"])
    q = rope(project_heads(hn, sp["wq"]), pos, cfg.rope_theta)
    k = rope(project_heads(hn, sp["wk"]), pos, cfg.rope_theta)
    return q, k, project_heads(hn, sp["wv"])


def _shared_attn_block(sp: Params, h: torch.Tensor, cfg: HybridConfig,
                       pos: torch.Tensor) -> torch.Tensor:
    q, k, v = _shared_qkv(sp, h, pos, cfg)
    o = chunked_attention(q, k, v, q_pos=pos, kv_pos=pos, causal=True)
    return _shared_mlp(sp, h + merge_heads(o, sp["wo"]))


def forward(params: Params, tokens, cfg: LMConfig, policy=None,
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab) in the parameters' dtype,
    on the parameters' device."""
    check_supported(cfg, policy, mesh)
    tokens = _tokens(params, tokens)
    h = params["embed"][tokens]
    hybrid = isinstance(cfg, HybridConfig)
    pos = torch.arange(tokens.shape[1], device=h.device)
    block = flags.maybe_remat(_mamba_block)
    for i in range(cfg.num_layers):
        h = block(params, i, h, cfg)
        if hybrid and (i + 1) % cfg.attn_every == 0:  # a group ends
            h = _shared_attn_block(params["shared_attn"], h, cfg, pos)
    h = rmsnorm(h, params["final_norm"])
    return h @ _unembed(params).t()


def lm_loss(params: Params, batch: Mapping[str, Any], cfg: LMConfig,
            policy=None, mesh=None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (fp32 log-sum-exp), in the logits' dtype."""
    logits = forward(params, batch["tokens"], cfg, policy, mesh)
    labels = _tokens(params, batch["labels"])
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = lf.gather(-1, labels[..., None])[..., 0]
    return (lse - true_logit).mean().to(logits.dtype)


# --------------------------------------------------------------- decode ---
def init_cache(cfg: LMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero conv and SSM caches, layers stacked; the hybrid adds zero
    ``k``/``v`` caches, (num_attn_applications, batch, max_len,
    num_kv_heads, d_model // num_heads). ``max_len`` is unused by an
    attention-free model (kept for the reference's signature)."""
    check_supported(cfg)
    dev = resolve_device(device)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    cache = {
        "conv": torch.zeros((cfg.num_layers, batch, cfg.conv_width - 1,
                             conv_ch), dtype=dtype, device=dev),
        "ssm": torch.zeros((cfg.num_layers, batch, cfg.num_ssm_heads,
                            cfg.head_dim, cfg.ssm_state), dtype=dtype,
                           device=dev),
        "pos": 0,
    }
    if isinstance(cfg, HybridConfig):
        shape = (cfg.num_attn_applications, batch, max_len,
                 cfg.num_kv_heads, _head_width(cfg))
        cache["k"] = torch.zeros(shape, dtype=dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def decode_step(params: Params, cache: Mapping[str, Any], tokens,
                cfg: LMConfig, policy=None, mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1) -> (logits (B, vocab), the cache at ``pos + 1``).
    The new conv and SSM states, and the hybrid's keys and values (one
    slot of its application's cache), are written into the cache's
    tensors in place, so the cache passed in is consumed: use the one
    returned."""
    check_supported(cfg, policy, mesh)
    h = params["embed"][_tokens(params, tokens)[:, 0]]  # (B, D)
    cur = cache["pos"]
    hybrid = isinstance(cfg, HybridConfig)
    g = 0  # the next shared attention application
    for i in range(cfg.num_layers):
        hn = rmsnorm(h, params["block_norms"][i])
        out, conv_c, ssm_c = mamba2.block_decode(
            _layer(params, i), hn, cache["conv"][i], cache["ssm"][i],
            num_heads=cfg.num_ssm_heads, head_dim=cfg.head_dim,
            ssm_state=cfg.ssm_state)
        h = h + out
        cache["conv"][i].copy_(conv_c)
        cache["ssm"][i].copy_(ssm_c)
        if hybrid and (i + 1) % cfg.attn_every == 0:  # a group ends
            sp = params["shared_attn"]
            hs = h[:, None, :]
            pos1 = torch.full((1,), cur, device=h.device)
            q, k, v = _shared_qkv(sp, hs, pos1, cfg)
            o = decode_attention(q, cache_write(cache["k"][g], k, cur),
                                 cache_write(cache["v"][g], v, cur), cur)
            h = _shared_mlp(sp, hs + merge_heads(o, sp["wo"]))[:, 0]
            g += 1
    h = rmsnorm(h, params["final_norm"])
    return h @ _unembed(params).t(), dict(cache, pos=cur + 1)


def prefill(params: Params, tokens, cfg: LMConfig, policy=None, mesh=None,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The prompt (B, S) replayed through ``decode_step`` (simple and
    exact, as the reference's serving does): (the last position's logits
    (B, vocab), the cache at ``pos`` S, its KV caches ``max_len`` long (S
    when None))."""
    check_supported(cfg, policy, mesh)
    tokens = _tokens(params, tokens)
    embed = params["embed"]
    cache = init_cache(cfg, tokens.shape[0], max_len or tokens.shape[1],
                       embed.dtype, embed.device)
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg)
    return logits, cache
