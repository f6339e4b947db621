"""The plan-sharded serving forward (the reference's
``train/train_step.py`` ``make_convnet_forward_step``; the train and
eval steps come with the training slice).

The step splits each input batch along the entry stage's partitioned
dims into the mesh's shards, each made contiguous on its shard's device,
runs ``models/cosmoflow.forward`` once per shard through
``core.spmd.run``, and returns shard 0's predictions: the FC stage of a
plan with data degree 1 is replicated, so every shard holds them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch

from repro_torch.configs.base import ConvNetConfig
from repro_torch.core import plan as plan_lib
from repro_torch.core import spmd
from repro_torch.models import cosmoflow as cosmoflow_lib

Params = Dict[str, torch.Tensor]


def replicate(params: Mapping[str, torch.Tensor],
              devices: Sequence[torch.device]) -> List[Params]:
    """One parameter dict per shard: ``params`` itself on its own device,
    one copy for each other device (shared by the shards on it)."""
    home = next(iter(params.values())).device
    copies: Dict[torch.device, Params] = {home: dict(params)}
    for d in devices:
        if d not in copies:
            copies[d] = {k: v.to(d) for k, v in params.items()}
    return [copies[d] for d in devices]


def split_input(x: torch.Tensor, mesh, stage: plan_lib.Stage
                ) -> List[torch.Tensor]:
    """Shard r's block of ``x`` (N, D, H, W, C): each dim ``stage``
    partitions cut into the mesh degree of its axis and the piece at r's
    coordinate, contiguous on r's device."""
    out = []
    for r, device in enumerate(mesh.devices):
        t, at = x, mesh.coords(r)
        for d, a in stage.part.active:
            k = mesh.degree(a)
            if t.shape[d + 1] % k:
                raise ValueError(
                    f"dim {d + 1} of the input ({t.shape[d + 1]}) does not "
                    f"divide over the {k}-way axis {a!r}")
            w = t.shape[d + 1] // k
            t = t.narrow(d + 1, at[a] * w, w)
        out.append(t.to(device).contiguous())
    return out


def make_convnet_forward_step(
    cfg: ConvNetConfig,
    mesh,
    *,
    plan: plan_lib.ParallelPlan,
    overlap: Optional[bool] = None,
    precision=None,
) -> Callable[[Sequence[Params], torch.Tensor], torch.Tensor]:
    """Returns ``fwd(params_per_shard, x) -> (N, out_dim)`` predictions
    on shard 0's device. ``params_per_shard``: one dict per shard on its
    device (``replicate``); ``x``: the whole batch, on any device."""
    if cfg.arch != "cosmoflow":
        raise NotImplementedError(
            f"{cfg.arch} comes with the U-Net slice of the port")
    if plan.data_degree != 1:
        raise NotImplementedError(
            f"plan {plan.name!r} has data degree {plan.data_degree}; "
            "batch sharding comes with the data-parallel slice of the port")
    head = plan.stage_for(cosmoflow_lib.num_blocks(cfg))
    if head.part.active:
        raise NotImplementedError(
            f"plan {plan.name!r} partitions the FC head; the port serves "
            "plans whose FC stage is replicated")
    entry = plan.stages[0]

    def body(params: Params, x: torch.Tensor) -> torch.Tensor:
        return cosmoflow_lib.forward(params, x, cfg, plan=plan,
                                     overlap=overlap, precision=precision)

    def fwd(params_per_shard: Sequence[Params],
            x: torch.Tensor) -> torch.Tensor:
        return spmd.run(mesh, body, params_per_shard,
                        split_input(x, mesh, entry))[0]

    return fwd


__all__ = ["make_convnet_forward_step", "replicate", "split_input"]
