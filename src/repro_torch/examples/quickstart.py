"""Quickstart: hybrid-parallel CosmoFlow through the one-call public API.

One declarative ``RunConfig``; ``repro_torch.api.compile`` builds the
mesh, the plan, the step and the optimizer state.

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.quickstart --device cpu --steps 2
    # 2-way data x 2-way spatial, every shard on one card:
    python -m repro_torch.examples.quickstart --data 2 --model 2 \\
        --device cuda:0
"""
import argparse

from repro_torch.api import RunConfig, compile
from repro_torch.api.cli import add_device_arg, placement


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1)
    ap.add_argument("--steps", type=int, default=10)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    config = RunConfig(model="cosmoflow-512", smoke=True,  # 32^3 variant
                       data=args.data, spatial=args.model, global_batch=4,
                       total_steps=args.steps * 4)
    where = placement(args, config.data * config.spatial)
    with compile(config, **where) as session:
        print(session.describe())
        loader = session.make_loader(num_samples=16)
        order = loader.epoch_schedule()
        for i in range(args.steps):
            ids = order[(i * 4) % 16:(i * 4) % 16 + 4]
            loss = session.step(loader.load_batch(ids))
            print(f"step {i:3d}  loss {float(loss):.4f}  "
                  f"pfs_bytes {loader.stats.pfs_bytes}")
    print("done.")


if __name__ == "__main__":
    main()
