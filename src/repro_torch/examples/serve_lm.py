"""Serve a small LM with batched requests: train briefly on a synthetic
Markov corpus (``train_step.make_lm_train_step``), then prefill and
batched greedy decode through the KV cache (``serve.lm.generate``), as
the reference's ``examples/serve_lm.py`` does, on one device.

    python -m repro_torch.examples.serve_lm --arch qwen1.5-0.5b
    python -m repro_torch.examples.serve_lm --arch mamba2-370m --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.api.cli import add_device_arg
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.launch.mesh import resolve_device
from repro_torch.models import lm_module
from repro_torch.optim.adam import Adam, warmup_cosine
from repro_torch.serve.lm import generate
from repro_torch.train.train_step import make_lm_train_step

SEQ = 64  # tokens a training sequence
PROMPT = 16  # tokens a prompt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    choices=[a for a in configs.ASSIGNED
                             if configs.get_config(a).supports_decode])
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen-steps", type=int, default=16)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    cfg = configs.get_smoke_config(args.arch)  # reduced same-family variant
    mod = lm_module(cfg)
    device = resolve_device(args.device)
    print(f"serving {cfg.name} (smoke variant of {args.arch}), "
          f"{cfg.param_count() / 1e6:.2f}M params, on {device}")

    # brief training so generations are non-degenerate
    toks = make_token_dataset(40_000, cfg.vocab_size, seed=0)
    params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                             device=device)
    opt = Adam(lr=warmup_cosine(3e-3, 10, args.train_steps))
    state = opt.init(params)
    step = make_lm_train_step(mod.lm_loss, cfg, None, None, opt)
    rng = np.random.default_rng(0)
    for i in range(args.train_steps):
        starts = rng.integers(0, len(toks) - SEQ - 1, args.batch)
        x = np.stack([toks[s:s + SEQ] for s in starts])
        y = np.stack([toks[s + 1:s + SEQ + 1] for s in starts])
        params, state, loss = step(params, state, {
            "tokens": torch.from_numpy(x).to(device),
            "labels": torch.from_numpy(y).to(device)})
        if i % 20 == 0 or i == args.train_steps - 1:
            print(f"train step {i:3d} loss {float(loss):.3f} "
                  f"(log V = {np.log(cfg.vocab_size):.3f})")

    # batched serving
    prompts = torch.from_numpy(np.stack(
        [toks[s:s + PROMPT] for s in rng.integers(0, 1000, args.batch)]))
    t0 = time.time()
    out = generate(params, prompts, cfg, num_steps=args.gen_steps)
    dt = time.time() - t0
    print(f"generated {args.batch}x{args.gen_steps} tokens in {dt:.2f}s "
          f"({args.batch * args.gen_steps / dt:.1f} tok/s)")
    for b in range(args.batch):
        print(f"  req{b}: prompt={prompts[b, :8].tolist()}... "
              f"-> {out[b].tolist()}")
    return out


if __name__ == "__main__":
    main()
