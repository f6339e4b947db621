"""Train the ~100M-parameter CosmoFlow variant on synthetic cosmology
volumes through ``repro_torch.api``: the spatially parallel loader and
its cache, the hybrid train step, the LR schedule, eval and a
checkpoint. The hyperparameters live in
``repro_torch.configs.cosmoflow.run_preset``; the command line only
overrides them.

    python -m repro_torch.examples.train_cosmoflow --steps 300
    python -m repro_torch.examples.train_cosmoflow --device cpu \\
        --width 16 --steps 2 --num-train 4 --eval-every 2
    python -m repro_torch.examples.train_cosmoflow --data 2 --model 2 \\
        --device cuda:0 --steps 100     # four shards on one card
    torchrun --nproc-per-node 4 -m repro_torch.examples.train_cosmoflow \\
        --memory-budget 1.0 --device cuda:0   # the planner over 4 ranks

Under ``torchrun`` each process is one shard (``--plan`` and
``--memory-budget`` plan over the world; a rank the plan leaves out is
released and exits).
"""
import argparse
import time

import numpy as np

from repro_torch.api import compile
from repro_torch.api.cli import add_session_args, config_from_args, placement
from repro_torch.configs import cosmoflow as cosmoflow_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--num-train", type=int, default=32)
    ap.add_argument("--eval-every", type=int, default=50)
    add_session_args(ap)
    args = ap.parse_args(argv)

    config = config_from_args(cosmoflow_cfg.run_preset(args.width), args)
    where = placement(args, config.data * config.spatial)
    with compile(config, **where) as session:
        if session.released:  # over processes, a rank the plan leaves out
            print(session.describe())
            return
        print(f"model {session.cfg.name}: "
              f"{session.cfg.param_count() / 1e6:.1f}M params")
        print(session.describe())
        n, batch = args.num_train, config.global_batch
        loader = session.make_loader(num_samples=n + 8)
        xe, ye = loader.load_batch(np.arange(n, n + 8))

        t0 = time.time()
        order = loader.epoch_schedule()
        order = order[order < n]
        pos = 0
        for i in range(config.total_steps):
            if pos + batch > len(order):
                order, pos = loader.epoch_schedule(), 0
                order = order[order < n]
            ids = order[pos:pos + batch]
            pos += batch
            loss = session.step(loader.load_batch(ids))
            if i % 10 == 0:
                dt = time.time() - t0
                print(f"step {i:4d}  loss {float(loss):.4f}  "
                      f"{(i + 1) * batch / dt:.2f} samples/s  "
                      f"pfs {loader.stats.pfs_bytes / 2**20:.0f} MiB  "
                      f"cache {loader.stats.cache_bytes_local / 2**20:.0f} "
                      f"MiB")
            if args.eval_every and (i + 1) % args.eval_every == 0:
                ev_loss, _ = session.evaluate(xe, ye)
                print(f"  eval mse {float(ev_loss):.4f}")
        if config.checkpoint_dir:
            # fp32 masters, plan, precision and config, in the manifest
            session.save()
            print(f"checkpoint -> {config.checkpoint_dir} "
                  f"(precision={session.precision})")
    print("done.")


if __name__ == "__main__":
    main()
