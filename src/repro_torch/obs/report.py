"""Modeled-against-measured drift reports (the reference's
``obs/report.py``).

``Session.report()`` sets the time model's predicted seconds for each
phase (``core/perf_model.py``) beside measured span aggregates
(``Tracer.span_seconds``) in a drift table: one row a phase with the
measured/modeled ratio, flagged when off by more than ``flag_ratio``
(default 2x) either way. The measured column comes from spans only: the
phase probes record ``probe.*`` spans, each ending after the device has
finished the phase, and the table reads the tracer's aggregates.

The phases (the probes are cumulative prefixes of the step):

* ``fwd``  — modeled ``fp``; measured ``probe.fwd``'s mean.
* ``bwd``  — modeled ``bp``; measured ``probe.bwd - probe.fwd``.
* ``comm`` — modeled ``grad_comm + reshard``; measured
  ``probe.grad_comm - probe.bwd``.
* ``opt``  — the model has no optimizer term, so the prior is Adam's
  memory traffic (read p/g/m/v, write p/m/v: 7 parameter-sized fp32
  arrays at ``hw.mem_bw``); measured ``probe.step - probe.grad_comm``.
* ``io``   — prior: the global batch once through memory at
  ``hw.mem_bw``; measured the mean of the loader's ``io.load`` span
  (``io.load.sync`` for the synchronous loader).
* ``step`` — modeled ``total``; measured ``probe.step``.

A plan with a pipeline axis raises: its pricing
(``pipeline_iteration_time``) comes with the pipeline slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.core import perf_model
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib

PHASES = ("fwd", "bwd", "comm", "io", "opt", "step")


@dataclasses.dataclass(frozen=True)
class DriftRow:
    phase: str
    modeled_s: Optional[float]
    measured_s: Optional[float]
    ratio: Optional[float]  # measured / modeled; None when either missing
    flagged: bool

    def __str__(self) -> str:
        f = lambda v: "      —" if v is None else f"{v * 1e3:9.3f}ms"
        r = "     —" if self.ratio is None else f"{self.ratio:6.2f}x"
        mark = "  <-- drift" if self.flagged else ""
        return (f"  {self.phase:<5} modeled {f(self.modeled_s)}  "
                f"measured {f(self.measured_s)}  ratio {r}{mark}")


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One drift table. ``source`` records where the measured column
    came from (``"spans"`` for a Session's report)."""

    rows: Tuple[DriftRow, ...]
    flag_ratio: float
    source: str = "spans"

    def phases(self) -> Tuple[str, ...]:
        return tuple(r.phase for r in self.rows)

    def row(self, phase: str) -> DriftRow:
        for r in self.rows:
            if r.phase == phase:
                return r
        raise KeyError(phase)

    def flagged(self) -> Tuple[DriftRow, ...]:
        return tuple(r for r in self.rows if r.flagged)

    def to_json(self) -> Dict[str, Any]:
        return {
            "flag_ratio": self.flag_ratio, "source": self.source,
            "rows": [dataclasses.asdict(r) for r in self.rows],
        }

    def __str__(self) -> str:
        head = (f"drift table (measured/{self.source} vs perf model, "
                f"flag >{self.flag_ratio:g}x)")
        return "\n".join([head] + [str(r) for r in self.rows])


def drift(modeled: Dict[str, float], measured: Dict[str, float],
          flag_ratio: float = 2.0, source: str = "spans") -> DriftReport:
    """Merge per-phase dicts into a ``DriftReport``. A phase on only one
    side gets a row with a ``None`` ratio, never flagged."""
    rows = []
    order = list(PHASES) + sorted(
        (set(modeled) | set(measured)) - set(PHASES))
    for ph in order:
        if ph not in modeled and ph not in measured:
            continue
        mo = modeled.get(ph)
        me = measured.get(ph)
        ratio = (me / mo if mo is not None and me is not None and mo > 0
                 else None)
        flagged = (ratio is not None
                   and (ratio > flag_ratio or ratio < 1.0 / flag_ratio))
        rows.append(DriftRow(ph, mo, me, ratio, flagged))
    return DriftReport(tuple(rows), flag_ratio, source)


# ---------------------------------------------------------- modeled side --
def modeled_phases(cfg, hw: "perf_model.Hardware",
                   plan: "plan_lib.ParallelPlan", *,
                   global_batch: int, grad_comm: str,
                   precision: Optional[str] = None) -> Dict[str, float]:
    """Predicted seconds per phase for ``plan``: ``plan.price_plan``'s
    routing, keeping the whole phase dict instead of only ``total``."""
    if plan.pipeline is not None and plan.n_groups > 1:
        raise plan_lib._no_pipeline(f"modeled_phases of {plan.name!r}")
    pol = precision_lib.get(precision or plan.precision)
    act_bytes = None if pol.act_bytes == 4 else pol.act_bytes
    n_params = cfg.param_count()
    # priors for the phases the time model does not price: Adam's
    # parameter-sized memory traffic, and the input batch through memory
    opt_s = 7.0 * n_params * 4 / hw.mem_bw
    io_s = (global_batch * cfg.input_width ** 3 * cfg.in_channels * 4
            / hw.mem_bw)
    ways = 1
    for a in plan.spatial_axis_names:
        ways *= plan.degree(a)
    data = 1
    for a in plan.stages[0].batch_axes:
        data *= plan.degree(a)
    r = perf_model.iteration_time(
        cfg, hw, num_gpus=max(ways, 1) * data, ways=max(ways, 1),
        global_batch=global_batch, grad_comm=grad_comm,
        schedule=plan_lib.plan_schedule(cfg, plan),
        remat_schedule=plan_lib.plan_remat_schedule(cfg, plan),
        act_bytes=act_bytes)
    return {"fwd": r["fp"], "bwd": r["bp"],
            "comm": r["grad_comm"] + r["reshard"],
            "opt": opt_s, "io": io_s, "step": r["total"]}


# --------------------------------------------------------- measured side --
def measured_phases(tracer) -> Dict[str, float]:
    """Seconds per phase from a tracer's span aggregates. The probes are
    cumulative (fwd ⊂ bwd ⊂ grad_comm ⊂ step), so successive differences
    attribute each phase; io comes from the loader's ``io.load`` span (or
    the synchronous loader's ``io.load.sync``)."""
    s = tracer.span_seconds()

    def mean(name: str) -> float:
        return s[name][1]

    out: Dict[str, float] = {}
    if "probe.fwd" in s:
        out["fwd"] = mean("probe.fwd")
    if "probe.bwd" in s and "probe.fwd" in s:
        out["bwd"] = max(mean("probe.bwd") - mean("probe.fwd"), 0.0)
    if "probe.grad_comm" in s and "probe.bwd" in s:
        out["comm"] = max(mean("probe.grad_comm") - mean("probe.bwd"), 0.0)
    if "probe.step" in s:
        out["step"] = mean("probe.step")
        if "probe.grad_comm" in s:
            out["opt"] = max(mean("probe.step")
                             - mean("probe.grad_comm"), 0.0)
    if "io.load" in s:
        out["io"] = mean("io.load")
    elif "io.load.sync" in s:
        out["io"] = mean("io.load.sync")
    return out


__all__ = ["PHASES", "DriftReport", "DriftRow", "drift", "measured_phases",
           "modeled_phases"]
