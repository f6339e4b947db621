"""LM decode path: prefill a batch of prompts, then greedy or sampled
decoding, for SSM configs (the reference's ``repro.serve.lm``).

An SSM prefills by replaying the prompt through ``decode_step`` (simple
and exact, as the reference does), so serving runs no scan. Transformer
and hybrid configs come with their slices and raise.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models import ssm_lm


def make_serve_fns(cfg, policy=None, mesh=None):
    """(prefill_fn(params, tokens, max_len) -> (last logits, cache),
    decode_fn(params, cache, tokens) -> (logits, cache))."""
    ssm_lm.check_supported(cfg, policy, mesh)

    def prefill_fn(params, tokens, max_len):
        embed = params["embed"]
        tokens = torch.as_tensor(tokens, device=embed.device)
        cache = ssm_lm.init_cache(cfg, tokens.shape[0], max_len,
                                  embed.dtype, embed.device)
        logits = None
        for t in range(tokens.shape[1]):
            logits, cache = ssm_lm.decode_step(params, cache,
                                               tokens[:, t:t + 1], cfg)
        return logits, cache

    def decode_fn(params, cache, tokens):
        return ssm_lm.decode_step(params, cache, tokens, cfg)

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
    prompts = torch.as_tensor(prompts, device=params["embed"].device)
    if prompts.dim() != 2 or prompts.shape[1] < 1:
        raise ValueError(f"prompts must be (B, S) with S >= 1; got "
                         f"{tuple(prompts.shape)}")
    B, S = prompts.shape
    prefill_fn, decode_fn = make_serve_fns(cfg, policy, mesh)
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
