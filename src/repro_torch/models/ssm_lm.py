"""Mamba2 language model (SSM family): mamba2-370m's 48 attention-free
SSD blocks, each ``h + block(rmsnorm(h))``, then a final norm and the
unembedding (tied to ``embed`` when ``tie_embeddings``).

Parameters keep the reference's tree and layouts, layers stacked on a
leading axis (``params["blocks"][name]`` is (num_layers, ...)), so a
reference parameter tree carries over with no transpose
(``params_from_numpy``). The layers run as a Python loop; each block's
scan goes through the hand-written SSD kernel (``models/mamba2.py``).

Entry points run where the parameters are; ``init_params`` and
``params_from_numpy`` put them on the card unless given a device.
``HybridConfig`` (zamba2: the shared attention block) and sequence- or
tensor-parallel sharding come with later slices and raise here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import SSMConfig
from repro_torch.launch.mesh import DeviceLike, resolve_device
from repro_torch.models import mamba2
from repro_torch.models.layers import rmsnorm

Params = Dict[str, Any]
BLOCK_PARAMS = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                "norm_scale", "out_proj")


def check_supported(cfg, policy=None, mesh=None) -> None:
    """Raise for what this slice does not run, naming the slice that
    brings it."""
    if getattr(cfg, "family", None) == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: HybridConfig (zamba2's shared attention block, "
            "RoPE, chunked attention) comes with the hybrid slice of the "
            "port")
    if not isinstance(cfg, SSMConfig):
        raise NotImplementedError(
            f"{getattr(cfg, 'name', cfg)!r}: the port runs SSMConfig "
            "language models; the transformer and MoE families come with "
            "their slices")
    if policy is not None or mesh is not None:
        raise NotImplementedError(
            "sharding policies and meshes (tensor and context parallelism, "
            "seq_parallel.cp_ssd) come with the sequence-parallel slice of "
            "the port; call without policy and mesh")


def param_shapes(cfg: SSMConfig) -> Dict[str, Any]:
    """The parameter tree's shapes: name -> shape, ``blocks`` nested."""
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
    return shapes


def init_params(cfg: SSMConfig, generator: torch.Generator,
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
    return _map(params, lambda t: t.to(dev))


def params_from_numpy(tree: Mapping[str, Any], cfg: SSMConfig,
                      device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Params:
    """The reference's parameter tree (``repro.models.ssm_lm.init_params``
    as numpy arrays) as the port's: the layouts are identical, so this is
    a device and dtype move with name and shape checks against ``cfg``.
    ``device=None`` is the card; ``dtype=None`` keeps each array's."""
    check_supported(cfg)
    dev = resolve_device(device)

    def convert(sub, want, path):
        if set(sub) != set(want):
            raise ValueError(
                f"{path or 'params'}: names differ from {cfg.name}'s: "
                f"missing {sorted(set(want) - set(sub))}, unexpected "
                f"{sorted(set(sub) - set(want))}")
        out = {}
        for name, shape in want.items():
            if isinstance(shape, dict):
                out[name] = convert(sub[name], shape, f"{path}{name}.")
                continue
            v = sub[name]
            t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v))  # a copy: reference arrays are read-only
            if tuple(t.shape) != shape:
                raise ValueError(f"{path}{name}: shape {tuple(t.shape)}, "
                                 f"expected {shape} for {cfg.name}")
            out[name] = t.to(device=dev, dtype=dtype or t.dtype).contiguous()
        return out

    return convert(tree, param_shapes(cfg), "")


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["blocks"].items()}


def _unembed(params: Params) -> torch.Tensor:
    return params.get("unembed", params["embed"])


def _tokens(params: Params, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params["embed"].device).long()


def forward(params: Params, tokens, cfg: SSMConfig, policy=None,
            mesh=None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, vocab) in the parameters' dtype,
    on the parameters' device."""
    check_supported(cfg, policy, mesh)
    tokens = _tokens(params, tokens)
    h = params["embed"][tokens]
    for i in range(cfg.num_layers):
        hn = rmsnorm(h, params["block_norms"][i])
        h = h + mamba2.block_forward(
            _layer(params, i), hn, num_heads=cfg.num_ssm_heads,
            head_dim=cfg.head_dim, ssm_state=cfg.ssm_state,
            chunk=cfg.chunk_size)
    h = rmsnorm(h, params["final_norm"])
    return h @ _unembed(params).t()


def lm_loss(params: Params, batch: Mapping[str, Any], cfg: SSMConfig,
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
def init_cache(cfg: SSMConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zero conv and SSM caches, layers stacked; ``max_len`` is unused
    by an attention-free model (kept for the reference's signature)."""
    check_supported(cfg)
    dev = resolve_device(device)
    conv_ch = cfg.d_inner + 2 * cfg.ssm_state
    return {
        "conv": torch.zeros((cfg.num_layers, batch, cfg.conv_width - 1,
                             conv_ch), dtype=dtype, device=dev),
        "ssm": torch.zeros((cfg.num_layers, batch, cfg.num_ssm_heads,
                            cfg.head_dim, cfg.ssm_state), dtype=dtype,
                           device=dev),
        "pos": 0,
    }


def decode_step(params: Params, cache: Mapping[str, Any], tokens,
                cfg: SSMConfig, policy=None, mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens (B, 1) -> (logits (B, vocab), the new cache); the cache
    passed in is not modified."""
    check_supported(cfg, policy, mesh)
    h = params["embed"][_tokens(params, tokens)[:, 0]]  # (B, D)
    new_conv, new_ssm = [], []
    for i in range(cfg.num_layers):
        hn = rmsnorm(h, params["block_norms"][i])
        out, conv_c, ssm_c = mamba2.block_decode(
            _layer(params, i), hn, cache["conv"][i], cache["ssm"][i],
            num_heads=cfg.num_ssm_heads, head_dim=cfg.head_dim,
            ssm_state=cfg.ssm_state)
        h = h + out
        new_conv.append(conv_c)
        new_ssm.append(ssm_c)
    h = rmsnorm(h, params["final_norm"])
    logits = h @ _unembed(params).t()
    return logits, {"conv": torch.stack(new_conv),
                    "ssm": torch.stack(new_ssm), "pos": cache["pos"] + 1}
