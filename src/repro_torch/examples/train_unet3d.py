"""3D U-Net segmentation on synthetic LiTS-like volumes, with the
per-voxel labels split over the shards like the inputs (the paper's
§II-C: the ground truth is as large as the input), driven through
``repro_torch.api``. The hyperparameters come from
``repro_torch.configs.unet3d.run_preset``.

    python -m repro_torch.examples.train_unet3d --steps 30
    python -m repro_torch.examples.train_unet3d --device cpu --steps 2
    python -m repro_torch.examples.train_unet3d --model 2 --device cuda:0
"""
import argparse

import numpy as np

from repro_torch.api import compile
from repro_torch.api.cli import add_session_args, config_from_args, placement
from repro_torch.configs import unet3d as unet3d_cfg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_session_args(ap)
    args = ap.parse_args(argv)

    config = config_from_args(unet3d_cfg.run_preset(), args)
    where = placement(args, config.data * config.spatial)
    with compile(config, **where) as session:
        if session.released:  # over processes, a rank the plan leaves out
            print(session.describe())
            return
        print(f"{session.cfg.name}: "
              f"{session.cfg.param_count() / 1e3:.0f}k params, "
              f"mesh {dict(session.mesh.shape)}")
        print(session.describe())
        batch = config.global_batch
        loader = session.make_loader(num_samples=8)
        order = loader.epoch_schedule()
        for i in range(config.total_steps):
            ids = order[(i * batch) % 8:(i * batch) % 8 + batch]
            loss = session.step(loader.load_batch(ids))
            if i % 5 == 0:
                print(f"step {i:3d}  voxel CE {float(loss):.4f} "
                      f"(log C = {np.log(session.cfg.out_dim):.3f})")
    print("done.")


if __name__ == "__main__":
    main()
