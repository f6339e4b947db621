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
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch cosmoflow-128 --full-config --model 2   # a process a shard
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch cosmoflow-128 --full-config --data 2 --model 2 \\
        --grad-comm reduce_scatter --device cuda:0     # ZeRO-1
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch cosmoflow-128 --full-config --data 4 --pipeline 2 \\
        --micro-batches 2 --device cuda:0              # two groups of 2
    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --arch cosmoflow-128 --full-config --model 2 --remat

Under ``torchrun`` each process is one shard of a process mesh
(``launch.mesh.ProcessMesh``; with ``--pipeline P`` one of P groups'
meshes, ``--data`` the total) and each rank reads its own blocks of the
same batches through its per-rank loader (rank 0 writes the synthetic
store); rank 0 prints. A pipelined run trains without a gradient clip (the clip
needs the norm across groups).

A language model's ``--arch`` raises: LM training comes with the LM
slice of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
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
        lr=1e-3, lr_schedule="linear_decay",
        grad_clip=1.0 if args.pipeline == 1 else 0.0,
        grad_comm=args.grad_comm, pipeline=args.pipeline,
        micro_batches=args.micro_batches,
        total_steps=args.steps, checkpoint_dir=args.ckpt)
    if args.remat:
        config = _with_remat(config)
    where = placement(args, config.data * config.spatial)
    with api_compile(config, **where) as session:
        rank = getattr(session.mesh, "rank", 0)
        say = print if rank == 0 else (lambda *a, **k: None)
        say(f"{session.cfg.name}: "
            f"{session.cfg.param_count() / 1e6:.2f}M params")
        say(session.describe())
        batch_for = _batches(session, args.batch)
        t0 = time.time()
        for i in range(args.steps):
            loss = session.step(batch_for(i))
            if i % 5 == 0 or i == args.steps - 1:
                sps = (i + 1) * args.batch / (time.time() - t0)
                say(f"step {i:4d}  loss {float(loss):.4f}  "
                    f"{sps:.2f} samples/s")
        if args.ckpt:
            session.save()
            say("checkpoint ->", args.ckpt)


def _with_remat(config):
    """``config`` pinned to the fixed plan it resolves to, every stage of
    it rematerialized."""
    from repro_torch.api import session as session_lib

    plan, _ = session_lib._resolve_plan(
        config, config.resolve_model(), "overlap" if config.grad_comm ==
        "auto" else config.grad_comm, config.data * config.spatial)
    return dataclasses.replace(config, plan=dataclasses.replace(
        plan, stages=tuple(dataclasses.replace(s, remat=True)
                           for s in plan.stages)))


def _batches(session, batch: int):
    """``batch_for(i)``: step i's batch from the session's loader over a
    synthetic store, each epoch's schedule in turn (over processes each
    rank's blocks of it)."""
    n = max(2 * batch, 8)
    loader = session.make_loader(num_samples=n)
    state = {"order": loader.epoch_schedule()}

    def from_loader(i: int):
        lo = (i * batch) % n
        ids = state["order"][lo:lo + batch]
        if len(ids) < batch:
            state["order"] = loader.epoch_schedule()
            ids = state["order"][:batch]
        return loader.load_batch(ids)
    return from_loader


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel degree (conv nets: spatial)")
    ap.add_argument("--grad-comm", default="auto",
                    choices=("auto", "monolithic", "overlap",
                             "reduce_scatter"),
                    help="gradient-reduction lowering (reduce_scatter: "
                         "ZeRO-1)")
    ap.add_argument("--pipeline", type=int, default=1, metavar="P",
                    help="pipeline groups (--data the total data degree)")
    ap.add_argument("--micro-batches", type=int, default=4, metavar="M",
                    help="micro-batches a step when --pipeline > 1")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize every stage of the plan")
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
            "LM-training slice of the port (score it with "
            "repro_torch.models.lm_module(cfg) and decode it with "
            "repro_torch.serve.lm)")
    return train_convnet(args)


if __name__ == "__main__":
    main()
