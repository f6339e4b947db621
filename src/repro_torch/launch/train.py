"""The training launcher (the conv-net path of the reference's
``launch/train.py``): ``--arch`` picks a registered architecture, its
smoke variant unless ``--full-config``, and trains it through
``repro_torch.api.compile`` on synthetic volumes from the session's
loader.

    python -m repro_torch.launch.train --arch cosmoflow-128 --full-config \\
        --steps 3
    python -m repro_torch.launch.train --arch cosmoflow-512 --steps 10 \\
        --device cpu
    python -m repro_torch.launch.train --arch cosmoflow-128 --full-config \\
        --model 2 --device cuda:0          # both shards on one card

A language model's ``--arch`` raises: LM training comes with the LM
slice of the port.
"""
from __future__ import annotations

import argparse
import time

from repro_torch import configs


def train_convnet(args) -> None:
    """One declarative config, one ``compile`` call: the session owns the
    mesh, the plan, the precision, the optimizer state and the step."""
    from repro_torch.api import RunConfig, compile as api_compile
    from repro_torch.api.cli import placement

    config = RunConfig(
        model=args.arch, smoke=not args.full_config, data=args.data,
        spatial=args.model, global_batch=args.batch,
        lr=1e-3, lr_schedule="linear_decay", grad_clip=1.0,
        total_steps=args.steps, checkpoint_dir=args.ckpt)
    where = placement(args, config.data * config.spatial)
    with api_compile(config, **where) as session:
        print(f"{session.cfg.name}: "
              f"{session.cfg.param_count() / 1e6:.2f}M params")
        print(session.describe())
        n = max(2 * args.batch, 8)
        loader = session.make_loader(num_samples=n)
        order = loader.epoch_schedule()
        t0 = time.time()
        for i in range(args.steps):
            lo = (i * args.batch) % n
            ids = order[lo:lo + args.batch]
            if len(ids) < args.batch:
                order, lo = loader.epoch_schedule(), 0
                ids = order[:args.batch]
            loss = session.step(loader.load_batch(ids))
            if i % 5 == 0 or i == args.steps - 1:
                sps = (i + 1) * args.batch / (time.time() - t0)
                print(f"step {i:4d}  loss {float(loss):.4f}  "
                      f"{sps:.2f} samples/s")
        if args.ckpt:
            session.save()
            print("checkpoint ->", args.ckpt)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel degree (conv nets: spatial)")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda:0', ... (default: the card)")
    args = ap.parse_args(argv)

    cfg = (configs.get_config(args.arch) if args.full_config
           else configs.get_smoke_config(args.arch))
    if not isinstance(cfg, configs.ConvNetConfig):
        raise NotImplementedError(
            f"--arch {args.arch}: training a language model comes with the "
            "LM-training slice of the port (score and decode it with "
            "repro_torch.models.ssm_lm and repro_torch.serve.lm)")
    return train_convnet(args)


if __name__ == "__main__":
    main()
