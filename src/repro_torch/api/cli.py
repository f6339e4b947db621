"""The drivers' shared command line (the reference's ``api/cli.py``):
argparse flags that map one to one onto ``RunConfig`` fields, so that
every driver has the same knobs and ``repro_torch.api.compile`` is the
only assembly path. ``--device`` says where the run goes (default: the
card); ``placement(args, shards)`` turns it into ``compile``'s
``device=`` / ``devices=``. Under ``torchrun`` (``WORLD_SIZE`` > 1) the
same flags build a process mesh, one process a shard: ``--device
cuda:0`` puts every rank on that card (gloo), and without ``--device``
each rank takes ``cuda:LOCAL_RANK`` (NCCL where those are cards of their
own). ``--grad-comm reduce_scatter`` (ZeRO-1) and ``--pipeline P`` run
there as in one process.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.api.config import RunConfig


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="where every shard runs: 'cpu', 'cuda:0', ... "
                         "(default: the card; a run of n shards without "
                         "--device takes cuda:0..n-1)")


def add_session_args(ap) -> None:
    """The standard Session knobs. ``--model`` keeps the reference's
    meaning (the spatial degree on the mesh's ``model`` axis)."""
    ap.add_argument("--steps", type=int, default=None,
                    help="override the preset's total_steps")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the preset's global_batch")
    ap.add_argument("--data", type=int, default=1,
                    help="data-parallel degree")
    ap.add_argument("--model", type=int, default=1,
                    help="spatial-parallel degree (mesh 'model' axis)")
    ap.add_argument("--pipeline", type=int, default=1, metavar="P",
                    help="pipeline-parallel degree: split the layer chain "
                         "into P stages on disjoint device groups, trained "
                         "over micro-batches (1F1B or the sequential "
                         "oracle); --data stays the TOTAL data degree, "
                         "--data/P shards a group; no --model, --grad-clip "
                         "or fp16 with it")
    ap.add_argument("--micro-batches", type=int, default=4, metavar="M",
                    help="micro-batches per step when --pipeline > 1")
    ap.add_argument("--pipeline-schedule", default="1f1b",
                    choices=("1f1b", "sequential"),
                    help="1F1B interleaving, or the blocking GPipe-style "
                         "oracle (equivalence baseline)")
    ap.add_argument("--plan", action="store_true",
                    help="let the cost model pick a per-stage parallelism "
                         "plan instead of the fixed degree")
    ap.add_argument("--memory-budget", type=float, default=None,
                    metavar="GIB",
                    help="per-device budget: the planner argmins time over "
                         "(boundary x kind x remat x precision) subject to "
                         "the memory model fitting this")
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "fp16"),
                    help="mixed-precision policy (default: fp32, or the "
                         "budgeted plan's choice)")
    ap.add_argument("--grad-comm", default=None,
                    choices=("monolithic", "overlap", "reduce_scatter"),
                    help="gradient-reduction lowering")
    ap.add_argument("--grad-clip", type=float, default=None,
                    metavar="NORM",
                    help="global grad-norm clip (0 disables)")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (final save; restore with "
                         "Session.restore)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace of the run to PATH "
                         "on Session.close (open at ui.perfetto.dev)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="append one JSON metrics row per step to PATH")
    add_device_arg(ap)


def add_serve_args(ap) -> None:
    """The batched-serving harness knobs, one to one onto
    ``InferenceSession.serve``'s keywords."""
    ap.add_argument("--max-batch", type=int, default=8, metavar="B",
                    help="coalesce up to B queued requests per forward")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    metavar="MS",
                    help="max time a worker waits to fill a batch before "
                         "running a partial one")
    ap.add_argument("--max-queue", type=int, default=64, metavar="N",
                    help="bounded request queue: submit() blocks "
                         "(backpressure) once N requests are waiting")
    ap.add_argument("--workers", type=int, default=1,
                    help="serving worker threads")


def harness_kwargs(args) -> dict:
    """Parsed ``add_serve_args`` flags -> ``InferenceSession.serve``
    keywords."""
    return {"max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
            "max_queue": args.max_queue, "workers": args.workers}


def config_from_args(base: RunConfig, args) -> RunConfig:
    """Apply parsed ``add_session_args`` flags over a preset config."""
    over = {"data": args.data, "spatial": args.model,
            "pipeline": args.pipeline, "micro_batches": args.micro_batches,
            "pipeline_schedule": args.pipeline_schedule}
    if args.steps is not None:
        over["total_steps"] = args.steps
    if args.batch is not None:
        over["global_batch"] = args.batch
    if args.plan or args.memory_budget is not None:
        over["plan"] = "auto"
    if args.memory_budget is not None:
        over["memory_budget_gib"] = args.memory_budget
    if args.precision:
        over["precision"] = args.precision
    if args.grad_comm:
        over["grad_comm"] = args.grad_comm
    if args.grad_clip is not None:
        over["grad_clip"] = args.grad_clip
    if args.ckpt:
        over["checkpoint_dir"] = args.ckpt
    if args.trace:
        over["trace"] = args.trace
    if args.metrics:
        over["metrics_jsonl"] = args.metrics
    return dataclasses.replace(base, **over)


def placement(args, shards: int) -> Dict[str, Any]:
    """``compile``'s placement keywords for ``--device`` and a run of
    ``shards`` shards: the device for one shard, that device once a
    shard for more (every shard on it), or none (the card; ``cuda:0..n-1``
    for n shards)."""
    if args.device is None:
        return {}
    if shards == 1:
        return {"device": args.device}
    return {"devices": [args.device] * shards}


__all__ = ["add_device_arg", "add_serve_args", "add_session_args",
           "config_from_args", "harness_kwargs", "placement"]
