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

Under a sharding policy over an in-process mesh (``core/sharding.py``)
the entry points are per-shard functions, called inside ``spmd.run`` with
each shard's blocks of the parameters
(``core/param_specs.infer_param_specs``) and of the batch (its rows of
the data axes, every position), as in ``models/transformer.py``:

* ``tp``: a Mamba2 block cannot use its cut weights (``in_proj``'s
  z | xBC | dt boundaries do not fall on the model axis's cut, and
  ``out_proj`` follows the block's full-width RMSNorm), so both are
  all-gathered before use (the adjoint a reduce-scatter) and every
  shard scans the whole sequence through the kernel; the hybrid's
  shared attention and MLP run their heads and d_ff columns locally
  with a ``psum`` after ``wo`` and ``w_down``; the embedding and the
  loss are vocabulary-parallel.
* ``cp``/``ep``: each shard runs its block of the sequence: the causal
  conv takes a (conv_width - 1)-row halo from the previous shard
  (``core/halo.halo_exchange``, the paper's halo in 1-D) and the scan is
  ``seq_parallel.cp_ssd`` (the kernel on the shard's block, then the
  cross-shard state carry); the shared attention goes through
  ``seq_parallel.cp_attention``.
* Decode keeps the conv and SSM states whole on every shard and, with
  more than one model shard, the hybrid's KV caches cut on their
  sequence (``max_len / n`` slots); ``prefill`` replays the prompt
  through the sharded ``decode_step``.
* ``lm_loss`` returns the global mean on every shard; a
  ``ProcessMesh`` raises (a later slice).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch

from repro_torch.configs.base import HybridConfig, SSMConfig
from repro_torch.core import flags, seq_parallel
from repro_torch.core import tree as tree_lib
from repro_torch.core.param_specs import infer_param_specs
from repro_torch.core.sharding import Layout, check_policy
from repro_torch.launch.mesh import DeviceLike, resolve_device
from repro_torch.models import mamba2
from repro_torch.models.layers import (dense_init, ffn_out, gated_mlp,
                                       gather_vocab, head_out,
                                       lm_cross_entropy, own_heads,
                                       project_heads, rmsnorm, rope,
                                       vocab_embed)

Params = Dict[str, Any]
LMConfig = Union[SSMConfig, HybridConfig]
BLOCK_PARAMS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                "norm_scale", "out_proj")


def check_supported(cfg, policy=None, mesh=None) -> bool:
    """Raise for what this module does not run, naming where it runs;
    whether the call is sharded (``sharding.check_policy``)."""
    if not isinstance(cfg, (SSMConfig, HybridConfig)):
        raise NotImplementedError(
            f"{getattr(cfg, 'name', cfg)!r}: ssm_lm runs SSMConfig and "
            "HybridConfig language models; a TransformerConfig runs "
            "through repro_torch.models.transformer "
            "(repro_torch.models.lm_module)")
    return check_policy(policy, mesh)


def layout(cfg: "LMConfig", policy=None, mesh=None) -> Optional[Layout]:
    """This shard's ``Layout`` under ``policy`` (None unsharded)."""
    if not check_supported(cfg, policy, mesh):
        return None
    return Layout(policy, infer_param_specs(param_shapes(cfg), policy))


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


def _layer(params: Params, i: int, lay=None) -> Dict[str, torch.Tensor]:
    if lay is not None:
        return lay.layer(params["blocks"], lay.specs["blocks"], i)
    return {k: v[i] for k, v in params["blocks"].items()}


def _top(params: Params, name: str, lay=None) -> torch.Tensor:
    if lay is None:
        return params[name]
    return lay.leaf(name, params[name], lay.specs[name])


def _unembed(params: Params, lay=None) -> torch.Tensor:
    return _top(params, "unembed" if "unembed" in params else "embed", lay)


def _embed(params: Params, tokens: torch.Tensor, cfg: "LMConfig",
           lay=None) -> torch.Tensor:
    return vocab_embed(_top(params, "embed", lay), tokens, cfg.vocab_size,
                       lay)


def _tokens(params: Params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def kernel_launches(cfg: LMConfig, train: bool = False) -> int:
    """ssd_scan launches of one forward (one a Mamba2 block), or of one
    training step: the forward's, and again each block's under
    ``flags.REMAT`` (its recompute; the scan's backward launches none).
    Under a policy, each shard's (every shard scans: its whole sequence
    under ``tp``, its block under ``cp``/``ep``)."""
    check_supported(cfg)
    return cfg.num_layers * (2 if train and flags.REMAT else 1)


def _block_fn(cfg: LMConfig, names, lay=None):
    """One Mamba2 block as a function of tensors, ``(h, norm, *leaves)
    -> h`` (``names`` order): a ``flags.maybe_remat`` unit, holding
    nothing of its shard."""
    def block(h, norm, *leaves):
        bp = dict(zip(names, leaves))
        if lay is not None:  # a layer's leaves: the specs past the stack
            bp = {n: lay.leaf(n, t, lay.specs["blocks"][n][1:])
                  for n, t in bp.items()}
        return h + mamba2.block_forward(
            bp, rmsnorm(h, norm), num_heads=cfg.num_ssm_heads,
            head_dim=cfg.head_dim, ssm_state=cfg.ssm_state,
            chunk=cfg.chunk_size,
            seq_axis=lay.axis if lay is not None and lay.seq_split else None)
    return block


def _shared_mlp(sp: Params, h: torch.Tensor, cfg: HybridConfig,
                lay=None) -> torch.Tensor:
    hn = rmsnorm(h, sp["ln2"])
    return h + ffn_out(gated_mlp(hn, sp["w_gate"], sp["w_up"],
                                 sp["w_down"]), sp["w_down"], cfg.d_ff, lay)


def _shared_qkv(sp: Params, h: torch.Tensor, pos, cfg: HybridConfig):
    hn = rmsnorm(h, sp["ln1"])
    q = rope(project_heads(hn, sp["wq"]), pos, cfg.rope_theta)
    k = rope(project_heads(hn, sp["wk"]), pos, cfg.rope_theta)
    return q, k, project_heads(hn, sp["wv"])


def _shared_attn_block(sp: Params, h: torch.Tensor, cfg: HybridConfig,
                       pos: torch.Tensor, lay=None) -> torch.Tensor:
    q, k, v = _shared_qkv(sp, h, pos, cfg)
    o = seq_parallel.attention(q, k, v, num_heads=cfg.num_heads,
                               num_kv_heads=cfg.num_kv_heads, pos=pos,
                               lay=lay)
    return _shared_mlp(sp, h + head_out(o, sp["wo"], cfg.num_heads, lay),
                       cfg, lay)


def _hidden(params: Params, tokens, cfg: LMConfig, lay=None
            ) -> torch.Tensor:
    """The last block's hidden states: of every position, or of this
    shard's block of them under a plan that cuts the sequence (the whole
    sequence embedded, then cut)."""
    tokens = _tokens(params, tokens)
    h = _embed(params, tokens, cfg, lay)
    if lay is not None:
        h = lay.local_rows(h)
    hybrid = isinstance(cfg, HybridConfig)
    pos = (torch.arange(h.shape[1], device=h.device) if lay is None
           else lay.positions(h.shape[1], h.device))
    names = sorted(params["blocks"])
    block = flags.maybe_remat(_block_fn(cfg, names, lay))
    shared = (None if not hybrid else params["shared_attn"] if lay is None
              else lay.layer(params["shared_attn"], lay.specs["shared_attn"]))
    for i in range(cfg.num_layers):
        h = block(h, params["block_norms"][i],
                  *(params["blocks"][n][i] for n in names))
        if hybrid and (i + 1) % cfg.attn_every == 0:  # a group ends
            h = _shared_attn_block(shared, h, cfg, pos, lay)
    return h


def forward(params: Params, tokens, cfg: LMConfig, policy=None,
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab) in the parameters' dtype,
    on the parameters' device. Under a policy (per shard): this shard's
    rows, and its block of the positions under a plan that cuts them,
    every vocabulary entry."""
    lay = layout(cfg, policy, mesh)
    h = rmsnorm(_hidden(params, tokens, cfg, lay), params["final_norm"])
    return gather_vocab(h @ _unembed(params, lay).t(), cfg.vocab_size, lay)


def lm_loss(params: Params, batch: Mapping[str, Any], cfg: LMConfig,
            policy=None, mesh=None) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (fp32 log-sum-exp), in the logits' dtype. Under
    a policy (per shard, on the shard's rows of the batch): the global
    mean on every shard."""
    lay = layout(cfg, policy, mesh)
    h = rmsnorm(_hidden(params, batch["tokens"], cfg, lay),
                params["final_norm"])
    return lm_cross_entropy(h, _unembed(params, lay),
                            _tokens(params, batch["labels"]),
                            vocab=cfg.vocab_size, masked=False, lay=lay)


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
    returned. Under a policy (per shard): the shard's rows, its slots of
    the KV caches."""
    lay = layout(cfg, policy, mesh)
    h = _embed(params, _tokens(params, tokens)[:, 0], cfg, lay)  # (B, D)
    cur = cache["pos"]
    hybrid = isinstance(cfg, HybridConfig)
    sp = (None if not hybrid else params["shared_attn"] if lay is None
          else lay.layer(params["shared_attn"], lay.specs["shared_attn"]))
    g = 0  # the next shared attention application
    for i in range(cfg.num_layers):
        hn = rmsnorm(h, params["block_norms"][i])
        out, conv_c, ssm_c = mamba2.block_decode(
            _layer(params, i, lay), hn, cache["conv"][i], cache["ssm"][i],
            num_heads=cfg.num_ssm_heads, head_dim=cfg.head_dim,
            ssm_state=cfg.ssm_state)
        h = h + out
        cache["conv"][i].copy_(conv_c)
        cache["ssm"][i].copy_(ssm_c)
        if hybrid and (i + 1) % cfg.attn_every == 0:  # a group ends
            hs = h[:, None, :]
            pos1 = torch.full((1,), cur, device=h.device)
            q, k, v = _shared_qkv(sp, hs, pos1, cfg)
            o = seq_parallel.decode_attend(
                q, k, v, cache["k"][g], cache["v"][g], cur,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                lay=lay)
            o = own_heads(o, sp["wo"], lay)
            h = _shared_mlp(sp, hs + head_out(o, sp["wo"], cfg.num_heads,
                                               lay), cfg, lay)[:, 0]
            g += 1
    h = rmsnorm(h, params["final_norm"])
    logits = gather_vocab(h @ _unembed(params, lay).t(), cfg.vocab_size, lay)
    return logits, dict(cache, pos=cur + 1)


def prefill(params: Params, tokens, cfg: LMConfig, policy=None, mesh=None,
            max_len: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The prompt (B, S) replayed through ``decode_step`` (simple and
    exact, as the reference's serving does): (the last position's logits
    (B, vocab), the cache at ``pos`` S, its KV caches ``max_len`` long (S
    when None)). Under a policy (per shard): the shard's rows, its
    ``max_len / n`` slots of the KV caches where decode cuts them."""
    lay = layout(cfg, policy, mesh)
    tokens = _tokens(params, tokens)
    max_len = max_len or tokens.shape[1]
    seq_parallel.check_slots(max_len, lay)
    slots = (max_len // lay.model.size if seq_parallel.sharded_cache(lay)
             else max_len)
    embed = params["embed"]
    cache = init_cache(cfg, tokens.shape[0], slots, embed.dtype,
                       embed.device)
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg,
                                    policy, mesh)
    return logits, cache
