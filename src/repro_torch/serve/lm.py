"""LM decode path: prefill a batch of prompts, then greedy or sampled
decoding (the reference's ``repro.serve.lm``), for every language-model
family on one device.

Prefill is the model module's ``prefill``: an SSM or hybrid config
replays the prompt through ``decode_step`` (simple and exact, as the
reference does), so serving runs no scan; a transformer runs the prompt
in one pass. ``decode_step`` writes into the cache in place. An
encoder-only config (``supports_decode=False``, hubert) has no decode
step and raises. A ``policy`` or ``mesh`` (the sequence-sharded cache)
comes with the sequence-parallel slice and raises.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import lm_module


def make_serve_fns(cfg, policy=None, mesh=None):
    """(prefill_fn(params, tokens, max_len) -> (last logits, cache),
    decode_fn(params, cache, tokens) -> (logits, cache))."""
    mod = lm_module(cfg)
    mod.check_supported(cfg, policy, mesh)
    if not cfg.supports_decode:
        raise NotImplementedError(
            f"{cfg.name}: an encoder-only model has no decode step; score "
            "it with repro_torch.models.transformer.forward")

    def prefill_fn(params, tokens, max_len):
        return mod.prefill(params, tokens, cfg, max_len=max_len)

    def decode_fn(params, cache, tokens):
        return mod.decode_step(params, cache, tokens, cfg)

    return prefill_fn, decode_fn


def generate(params: Any, prompts, cfg, num_steps: int, policy=None,
             mesh=None, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation, on the parameters'
    device. Returns (B, num_steps) int64 tokens. Sampling draws from
    ``generator``, which must be given (on the parameters' device)."""
    if temperature > 0 and generator is None:
        raise ValueError("sampling (temperature > 0) draws from an "
                         "explicit torch.Generator: pass generator=")
    prefill_fn, decode_fn = make_serve_fns(cfg, policy, mesh)
    prompts = torch.as_tensor(prompts, device=params["embed"].device)
    if prompts.dim() != 2 or prompts.shape[1] < 1:
        raise ValueError(f"prompts must be (B, S) with S >= 1; got "
                         f"{tuple(prompts.shape)}")
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
