"""LM decode path: prefill a batch of prompts, then greedy or sampled
decoding (the reference's ``repro.serve.lm``), for every language-model
family, on one device or over an in-process mesh.

Prefill is the model module's ``prefill``: an SSM or hybrid config
replays the prompt through ``decode_step`` (simple and exact, as the
reference does), so serving runs no scan; a transformer runs the prompt
in one pass. ``decode_step`` writes into the cache in place. An
encoder-only config (``supports_decode=False``, hubert) has no decode
step and raises.

Under a ``ShardingPolicy`` over an in-process ``launch.mesh.Mesh``
(``policy`` and ``mesh``): the parameters are cut by
``infer_param_specs`` (``core/sharding.shard_tree``) and each prefill
and decode step runs every shard's function through one ``spmd.run``,
each shard on its rows of the batch (cut over the data axes) with its
cache; with more than one model shard the KV caches are cut on their
sequence, ``max_len / n`` slots a shard (``max_len`` must divide). The
serving functions then take and return per-shard parameter and cache
lists (rank order) and the global logits (B, vocab); ``generate`` takes
the global parameters, as the reference's. A ``ProcessMesh`` raises (a
later slice).
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import sharding, spmd
from repro_torch.core.param_specs import infer_param_specs
from repro_torch.models import lm_module


def _specs(cfg, policy):
    return infer_param_specs(lm_module(cfg).param_shapes(cfg), policy)


def make_serve_fns(cfg, policy=None, mesh=None):
    """(prefill_fn(params, tokens, max_len) -> (last logits, cache),
    decode_fn(params, cache, tokens) -> (logits, cache)); under a policy
    over a mesh, ``params`` and the caches are per-shard lists (module
    docstring)."""
    mod = lm_module(cfg)
    mod.check_supported(cfg)
    sharded = sharding.sharded_policy(policy, mesh)
    if not cfg.supports_decode:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-only model has no decode step; score "
            "it with repro_torch.models.transformer.forward")
    if not sharded:
        def prefill_fn(params, tokens, max_len):
            return mod.prefill(params, tokens, cfg, max_len=max_len)

        def decode_fn(params, cache, tokens):
            return mod.decode_step(params, cache, tokens, cfg)

        return prefill_fn, decode_fn

    pm = policy.mesh

    def logits_of(outs):
        return sharding.join_shards([logits for logits, _ in outs],
                                    sharding.data_spec(policy), pm)

    def prefill_fn(params, tokens, max_len):
        with torch.no_grad():
            outs = spmd.run(pm, lambda p, t: mod.prefill(
                p, t, cfg, policy, pm, max_len=max_len), params,
                sharding.shard_rows(tokens, policy))
        return logits_of(outs), [c for _, c in outs]

    def decode_fn(params, caches, tokens):
        with torch.no_grad():
            outs = spmd.run(pm, lambda p, c, t: mod.decode_step(
                p, c, t, cfg, policy, pm), params, caches,
                sharding.shard_rows(tokens, policy))
        return logits_of(outs), [c for _, c in outs]

    return prefill_fn, decode_fn


def generate(params: Any, prompts, cfg, num_steps: int, policy=None,
             mesh=None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation, on the parameters'
    device (under a policy, from the global parameters, cut here; the
    tokens come back on the mesh's first device). Returns (B, num_steps)
    int64 tokens. Sampling draws from ``generator``, which must be given
    (on the parameters' device)."""
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) draws from an "
                         "explicit torch.Generator: pass generator=")
    prefill_fn, decode_fn = make_serve_fns(cfg, policy, mesh)
    prompts = torch.as_tensor(prompts, device=params["embed"].device)
    if prompts.dim() != 2 or prompts.shape[1] < 1:
        raise ValueError(f"prompts must be (B, S) with S >= 1; got "
                         f"{tuple(prompts.shape)}")
    if sharding.sharded_policy(policy, mesh):
        params = sharding.shard_tree(params, _specs(cfg, policy),
                                     policy.mesh)
    B, S = prompts.shape
    logits, cache = prefill_fn(params, prompts, S + num_steps)
    out = []
    for _ in range(num_steps):
        if temperature > 0:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        out.append(tok)
        logits, cache = decode_fn(params, cache, tok[:, None])
    return torch.stack(out, dim=1)
