"""The training launcher (the reference's ``launch/train.py``):
``--arch`` picks a registered architecture, its smoke variant unless
``--full-config``, and trains it. A conv net trains through
``repro_torch.api.compile`` on synthetic volumes from the session's
loader; a language model through ``train_step.make_lm_train_step`` on
the synthetic Markov corpus (``train_lm``).

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

A language model trains unsharded on one device, as the reference's
does without a mesh: Adam at ``warmup_cosine(3e-3, 10, steps)`` with a
gradient clip of 1.0, ``--batch`` windows of ``--seq`` tokens a step
drawn from ``make_token_dataset(100_000, vocab, seed=0)`` by the
reference's numpy generator (hubert takes N(0, 0.1) frame embeddings
in their place, drawn from a ``torch.Generator`` seeded with the step:
the reference's shape and scale, not its bits), its parameters from
``init_params`` with a generator seeded 0 unless given; ``--remat``
rematerializes every layer (``core/flags.REMAT``). ``--data D --model M``
above 1 x 1 train it over an in-process ``Mesh((("data", D), ("model",
M)))`` whose shards all sit on ``--device`` under
``ShardingPolicy(mesh, plan=--plan)`` (``tp``, ``cp`` or ``ep``; by
default the arch's training plan, ``configs.plan_for(arch,
"train_4k")``; the reference's launcher sets no FSDP), as the
reference's ``main`` does;
the step is ``make_lm_train_step`` over the mesh, the parameters cut by
``infer_param_specs`` and put back together at the end. A language model
takes none of the conv nets' ``--pipeline``, ``--micro-batches`` and
``--grad-comm`` (the reference's LM loop has no such options), and under
``torchrun`` (a process a shard) it raises: the LM over the process mesh
is a later slice.

    python -m repro_torch.launch.train --arch mamba2-370m --steps 20 \
        --device cpu
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --full-config \
        --steps 3 --seq 4096 --batch 1
    python -m repro_torch.launch.train --arch qwen1.5-0.5b --data 1 \
        --model 2 --plan tp --steps 3 --device cuda:0   # both on one card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

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


def lm_batches(cfg, batch: int, seq: int, steps: int,
               device) -> Iterator[dict]:
    """The reference launcher's batches: ``batch`` windows of ``seq``
    tokens and their next tokens a step, starts drawn by
    ``np.random.default_rng(0)`` over ``make_token_dataset(100_000,
    vocab, seed=0)``; an audio model's tokens replaced by frame
    embeddings (module docstring)."""
    from repro_torch.data.synthetic import make_token_dataset

    toks = make_token_dataset(100_000, cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    for i in range(steps):
        starts = rng.integers(0, len(toks) - seq - 1, batch)
        x = np.stack([toks[s:s + seq] for s in starts])
        y = np.stack([toks[s + 1:s + seq + 1] for s in starts])
        out = {"tokens": torch.from_numpy(x).to(device),
               "labels": torch.from_numpy(y).to(device)}
        if getattr(cfg, "family", "") == "audio":
            frames = torch.randn((batch, seq, cfg.d_model),
                                 generator=torch.Generator().manual_seed(i))
            out["tokens"] = (frames * 0.1).to(device)
        yield out


# the conv-net options the reference's LM loop does not take, at the
# values that leave them unused
CONV_NET_OPTIONS = {"pipeline": 1, "micro_batches": 4, "grad_comm": "auto"}


def train_lm(args, cfg, params: Optional[Any] = None,
             say=print) -> Tuple[Any, List[float]]:
    """The reference launcher's LM loop on ``args.device``: ``args.steps``
    steps of ``make_lm_train_step`` from ``params`` (seeded
    ``init_params`` when None; e.g. the reference's, carried across by
    ``params_from_numpy``), unsharded or over ``--data`` x ``--model``
    shards on the device under ``--plan``. Returns (the trained
    parameters, global; every step's loss)."""
    import os

    from repro_torch.configs import plan_for
    from repro_torch.core import flags
    from repro_torch.core import sharding
    from repro_torch.core.param_specs import infer_param_specs
    from repro_torch.launch.mesh import Mesh, resolve_device
    from repro_torch.models import lm_module
    from repro_torch.optim.adam import Adam, warmup_cosine
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import make_lm_train_step

    set_away = [f"--{name.replace('_', '-')} {getattr(args, name)}"
                for name, default in CONV_NET_OPTIONS.items()
                if getattr(args, name) != default]
    if set_away:
        raise NotImplementedError(
            f"{' '.join(set_away)}: conv-net options; the reference's "
            f"language-model loop takes none of them; train {cfg.name} "
            "without them")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(
            f"{cfg.name} under torchrun (a process a shard): the LM over "
            "the process mesh comes with the next slice of the port; run "
            "one process with --data/--model shards on its device")
    device = resolve_device(args.device)
    mod = lm_module(cfg)
    shards = args.data * args.model
    plan = args.plan or plan_for(args.arch, "train_4k")
    mesh, policy = None, None
    if shards > 1:
        mesh = Mesh((("data", args.data), ("model", args.model)),
                    [device] * shards)
        policy = sharding.ShardingPolicy(mesh, plan=plan)
    say(f"{cfg.name}: {cfg.param_count() / 1e6:.2f}M params, plan "
        f"{plan}, mesh {args.data}x{args.model}, {device}")
    if params is None:
        params = mod.init_params(cfg, torch.Generator().manual_seed(0),
                                 device=device)
    opt = Adam(lr=warmup_cosine(3e-3, 10, args.steps), grad_clip=1.0)
    step = make_lm_train_step(mod.lm_loss, cfg, mesh, policy, opt)
    if mesh is not None:
        specs = infer_param_specs(mod.param_shapes(cfg), policy)
        params = sharding.shard_tree(params, specs, mesh)
        state = [opt.init(p) for p in params]
    else:
        state = opt.init(params)
    losses: List[float] = []
    remat_before = flags.REMAT
    flags.REMAT = remat_before or args.remat
    try:
        t0 = time.time()
        for i, batch in enumerate(lm_batches(cfg, args.batch, args.seq,
                                             args.steps, device)):
            params, state, loss = step(params, state, batch)
            losses.append(float(loss))
            if i % 5 == 0 or i == args.steps - 1:
                tokps = (i + 1) * args.batch * args.seq / (time.time() - t0)
                say(f"step {i:4d}  loss {losses[-1]:.3f}  {tokps:.0f} tok/s")
    finally:
        flags.REMAT = remat_before
    if mesh is not None:
        params = sharding.join_shards(params, specs, mesh)
    if args.ckpt:
        checkpoint.save(args.ckpt, params, step=args.steps)
        say("checkpoint ->", args.ckpt)
    return params, losses


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True, choices=configs.ALL_ARCHS)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64,
                    help="tokens a sequence (language models)")
    ap.add_argument("--data", type=int, default=1)
    ap.add_argument("--model", type=int, default=1,
                    help="model-parallel degree (conv nets: spatial)")
    ap.add_argument("--plan", default=None, choices=("tp", "cp", "ep"),
                    help="a language model's sharding plan over --data x "
                         "--model; default the arch's training plan "
                         "(configs.plan_for(arch, 'train_4k')); conv nets "
                         "plan through repro_torch.api")
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
                    help="rematerialize every stage of the plan (a "
                         "language model: every layer, flags.REMAT)")
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-smoke) config")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None,
                    help="'cpu', 'cuda:0', ... (default: the card)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = (configs.get_config(args.arch) if args.full_config
           else configs.get_smoke_config(args.arch))
    if not isinstance(cfg, configs.ConvNetConfig):
        train_lm(args, cfg)
        return None
    return train_convnet(args)


if __name__ == "__main__":
    main()
