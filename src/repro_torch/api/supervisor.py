"""The auto-resume training supervisor (the reference's
``api/supervisor.py``).

``run(config, steps)`` wraps the training ``Session`` in the recovery
loop a long campaign needs: it drives guarded steps under a wall-clock
watchdog, checkpoints into a keep-last-K retention root, and on a
failure — an injected fault, a hung step, a corrupt checkpoint, a
persistent store error, a diverging loss — resumes from the newest
checkpoint that still validates.

Recovery has three classes, as in the reference:

* **transient** (an I/O error past the store's retries, a step the
  watchdog caught, a ``DeviceLost`` with no count): restore the newest
  valid checkpoint at the same degrees and replay. Batches are a pure
  function of the step index and the dropout masks of (step, layer,
  sample), so the replayed losses and parameters are bitwise those of
  an uninterrupted run.
* **divergence** (``divergence_patience`` consecutive guard-skipped or
  non-finite steps): roll back to the last checkpoint.
* **elastic** (``DeviceLost(available=k)``): re-degree for ``k``
  devices (``degrade_config``), compile the smaller run, and move the
  state across: parameters exactly; ZeRO-1's global padded buckets
  re-padded for the new shard count; an incompatible layout resets the
  optimizer state, with an event saying so.

Only what the reference catches is recovered: ``InjectedFault``,
``StepTimeout``, ``Divergence``, ``CheckpointError`` and ``OSError``. A
kernel that fails to launch, or a CUDA error, propagates and ends the
run. The devices: ``device=`` / ``devices=`` as ``compile`` takes them
(the card unless the caller says otherwise); a re-degreed run keeps the
first data x spatial entries of the list.

Over processes (a process group is up, or torchrun's ``WORLD_SIZE`` > 1:
every rank calls ``run``, one process a shard, ``devices`` every rank's
as ``compile`` takes them) every rank must take the same recovery, or a
failure on one rank would leave its peers waiting in the step's first
collective. So each step has two agreement points (``_Agreement``): one
before the step's compute, after the batch and the pre-step fault
sites, and one after ``float(loss)`` (the watchdog and divergence). At
each every rank gives a status word (ok, or the failure's class, its
message and ``DeviceLost.available``) in one small all-gather, and
every rank raises the lowest failing rank's failure, or none. Rank 0
writes the checkpoints and their garbage collection, the agreement
after it the barrier; at a resume rank 0 picks the newest checkpoint
that validates and broadcasts its step, so every rank restores the
same one. An elastic re-degree to n shards keeps the first n ranks
(``dist.sub_world``); the others close their session and return a
report with ``released`` set and no session.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.api.config import (_MIN_LOCAL_WIDTH, RunConfig,
                                    RunConfigError)
from repro_torch.api.session import (_META_FILE, Session, _build_optimizer,
                                     _resolve_plan)
from repro_torch.api.session import compile as api_compile
from repro_torch.core import faults
from repro_torch.core import grad_comm as grad_comm_lib
from repro_torch.core import plan as plan_lib
from repro_torch.core import precision as precision_lib
from repro_torch.core import reshard, spmd
from repro_torch.core import tree as tree_lib
from repro_torch.data import store as store_lib
from repro_torch.launch import dist as dist_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import DeviceLike
from repro_torch.models import for_config
from repro_torch.obs import trace as trace_lib
from repro_torch.train import checkpoint
from repro_torch.train import train_step as train_step_lib


class StepTimeout(RuntimeError):
    """A step exceeded the supervisor's watchdog budget."""


class Divergence(RuntimeError):
    """Too many consecutive skipped / non-finite-loss steps."""


class SupervisorError(RuntimeError):
    """The supervisor exhausted ``max_restarts`` and gave up."""


@dataclasses.dataclass
class SupervisorReport:
    """What happened: the trajectory plus every recovery the loop took."""

    steps: int
    losses: List[float]
    restarts: int = 0        # failures handled (any class)
    resumes: int = 0         # checkpoint restores (incl. rollbacks)
    cold_starts: int = 0     # fresh compiles (no usable checkpoint)
    rollbacks: int = 0       # divergence-triggered restores
    replans: int = 0         # elastic degree changes
    skipped_steps: int = 0   # guard-vetoed updates over the final session
    recovery_s: List[float] = dataclasses.field(default_factory=list)
    events: List[str] = dataclasses.field(default_factory=list)
    final_data: int = 0
    final_spatial: int = 0
    # over processes: this rank left the run at an elastic re-degree
    released: bool = False
    session: Optional[Session] = dataclasses.field(default=None, repr=False)


def _default_batch_fn(config: RunConfig, device: torch.device
                      ) -> Callable[[int], Tuple]:
    """Deterministic synthetic batches drawn on ``device``: a pure
    function of (seed, step), so a replay after a resume feeds the bytes
    the failed run saw. (The bits differ from the reference's
    ``jax.random`` draws; parity tests pass one ``batch_fn`` to both.)"""
    cfg = config.resolve_model()
    w, gb = cfg.input_width, config.global_batch

    def make(t: int):
        g = torch.Generator(device=device).manual_seed(
            ((config.seed + 101) << 32) + t)
        x = torch.randn((gb, w, w, w, cfg.in_channels), generator=g,
                        device=device)
        if cfg.arch == "cosmoflow":
            y = torch.randn((gb, cfg.out_dim), generator=g, device=device)
        else:
            y = torch.randint(0, cfg.out_dim, (gb, w, w, w), generator=g,
                              device=device, dtype=torch.int32)
        return x, y

    return make


def _loader_batch_fn(sess: Session, config: RunConfig
                     ) -> Callable[[int], Tuple]:
    """Batches from the session's (possibly prefetching) loader over
    ``config.data_dir`` as a pure function of ``t``: step ``t`` is chunk
    ``t % bpe`` of ``schedule_for_epoch(t // bpe)``, so a resumed run
    replays the failed run's batches bitwise, synchronous or prefetched.
    Built again for each session: its loader closes with it."""
    loader = sess.make_loader(config.data_dir)
    gb = config.global_batch
    bpe = loader.store.num_samples // gb  # batches per epoch
    if bpe < 1:
        raise RunConfigError(
            "data_dir",
            f"dataset has {loader.store.num_samples} samples < "
            f"global_batch={gb}", "add samples or shrink the batch")

    def make(t: int):
        epoch, b = divmod(t, bpe)
        order = loader.schedule_for_epoch(epoch)
        return loader.load_batch(order[b * gb:(b + 1) * gb])

    return make


def degrade_config(config: RunConfig, available: int) -> RunConfig:
    """Feasible degrees for a shrunken device count: halve spatial until
    it fits ``available`` and still divides the volume above the width
    floor, then give data the largest remaining degree that divides the
    global batch. A pinned ``ParallelPlan`` drops back to ``"auto"`` so
    the planner chooses again at the new mesh."""
    if available < 1:
        raise SupervisorError(f"no devices left (available={available})")
    cfg = config.resolve_model()
    spatial = max(config.spatial, 1)
    while spatial > 1 and (
            spatial > available or cfg.input_width % spatial
            or cfg.input_width // spatial < _MIN_LOCAL_WIDTH):
        spatial //= 2
    data = max(available // spatial, 1)
    while config.global_batch % data:
        data -= 1
    plan = ("auto" if isinstance(config.plan, plan_lib.ParallelPlan)
            else config.plan)
    return dataclasses.replace(config, data=data, spatial=spatial, plan=plan)


class _Incompatible(Exception):
    pass


def _adapt_leaf(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    old = torch.as_tensor(old)
    if old.shape == new.shape:
        return old.to(device=new.device, dtype=new.dtype)
    if old.dim() == 1 and new.dim() == 1:
        n = new.shape[0]
        v = old[:n]
        if n > old.shape[0]:
            v = torch.cat([v, v.new_zeros(n - old.shape[0])])
        return v.to(device=new.device, dtype=new.dtype)
    raise _Incompatible


def _adapt_opt_state(old, new_template):
    """Re-place a restored optimizer state onto a new session's layout.
    Returns ``(state, reset)``. Identical layouts pass through (cast to
    the template's dtype and device); 1-D leaves of different length are
    ZeRO-1's global bucket states, whose padding is trailing zeros:
    truncated or zero-extended to the new padded size (exact). Any other
    mismatch returns the template, ``reset`` True."""
    if tree_lib.structure(old) != tree_lib.structure(new_template):
        return new_template, True
    try:
        return tree_lib.tree_map(_adapt_leaf, new_template, old), False
    except _Incompatible:
        return new_template, True


def _state_template(config: RunConfig):
    """The ``{"params", "opt"}`` tree a checkpoint of ``config``'s run
    holds (ZeRO-1's state as global padded buckets; a pipelined run's as
    one state a group, ``make_pipeline_opt_state``'s layout), on the
    meta device: its structure selects the leaves to read."""
    cfg = config.resolve_model()
    grad_comm = "overlap" if config.grad_comm == "auto" else config.grad_comm
    plan, precision = _resolve_plan(config, cfg, grad_comm,
                                    config.data * config.spatial)
    params = {k: torch.empty(s, device="meta")
              for k, s in for_config(cfg).param_shapes(cfg).items()}
    if plan.n_groups > 1:
        return {"params": params, "opt": train_step_lib.make_pipeline_opt_state(
            cfg, _build_optimizer(config), params, plan=plan,
            precision=precision)}
    optimizer = precision_lib.wrap_optimizer(_build_optimizer(config),
                                             precision)
    if grad_comm == "reduce_scatter":
        opt = grad_comm_lib.init_sharded_opt_state(
            optimizer, train_step_lib.convnet_grad_plan(cfg),
            num_shards=train_step_lib.data_degree(plan), device="meta")
    else:
        opt = optimizer.init(params)
    return {"params": params, "opt": opt}


# the failures the loop recovers from (the reference's), and what an
# agreement carries of each: its class by index (the most derived first,
# so a rebuilt failure has the raising rank's class)
_CAUGHT = (faults.InjectedFault, StepTimeout, Divergence,
           checkpoint.CheckpointError, OSError)
_KINDS = (faults.DeviceLost, faults.InjectedCrash, faults.InjectedIOError,
          faults.InjectedFault, StepTimeout, Divergence,
          checkpoint.CheckpointCorrupt, checkpoint.CheckpointError,
          store_lib.StoreReadError, OSError)
_WORD = 512  # bytes of a status word: kind, available, message length, text


class _Agreement:
    """Where the ranks of a run over processes agree on a failure: one
    all-gather of a fixed-size status word over ``ranks``' gloo group.
    In one process (``ranks`` None) the failure is this process's own."""

    def __init__(self, ranks: Optional[Tuple[int, ...]]):
        self.group = None if ranks is None else dist_lib.group(ranks, "gloo")
        self.rank = 0 if self.group is None else self.group.index

    def settle(self, failure: Optional[BaseException]
               ) -> Optional[BaseException]:
        """The failure every rank takes: the lowest failing rank's (its
        own exception on that rank, one of its class and message on the
        others), or None."""
        if self.group is None:
            return failure
        word = torch.zeros(_WORD, dtype=torch.uint8)
        if failure is not None:
            kind = next(i for i, c in enumerate(_KINDS)
                        if isinstance(failure, c))
            text = str(failure).encode()[:_WORD - 24]
            avail = getattr(failure, "available", None)
            head = torch.tensor([kind + 1, -1 if avail is None else avail,
                                 len(text)], dtype=torch.int64)
            word[:24] = head.view(torch.uint8)
            word[24:24 + len(text)] = torch.frombuffer(bytearray(text),
                                                       dtype=torch.uint8)
        rows = [torch.empty_like(word) for _ in self.group.ranks]
        self.group.all_gather(rows, word)
        for r, row in enumerate(rows):
            kind, avail, n = row[:24].view(torch.int64).tolist()
            if kind:
                if r == self.rank:
                    return failure
                return _rebuild(_KINDS[kind - 1],
                                bytes(row[24:24 + n].tolist()).decode(),
                                None if avail < 0 else avail)
        return None

    def __call__(self, failure: Optional[BaseException]) -> None:
        """``settle``, raising the agreed failure."""
        agreed = self.settle(failure)
        if agreed is not None:
            raise agreed

    def from_rank0(self, value: int) -> int:
        """Rank 0's ``value`` (an int) on every rank."""
        if self.group is None:
            return value
        buf = torch.tensor([value], dtype=torch.int64)
        self.group.broadcast(buf, 0)
        return int(buf.item())


def _rebuild(cls, message: str, available: Optional[int]) -> BaseException:
    """A failure of class ``cls`` whose ``str`` is ``message`` (another
    rank's), without running its constructor."""
    e = cls.__new__(cls)
    e.args = (message,)
    if issubclass(cls, faults.InjectedFault):
        e.site = "peer"
    if cls is faults.DeviceLost:
        e.available = available
    return e


def _elastic_restore(path: str, new_config: RunConfig,
                     report: SupervisorReport,
                     devices: Optional[Sequence[DeviceLike]] = None,
                     device: DeviceLike = None) -> Session:
    """Resume a checkpoint saved at DIFFERENT degrees: read it through
    the old run's tree structure, compile the new run, and move the
    parameters and the adapted optimizer state across, a pipelined run's
    each group's on its group's device (as ``Session.restore`` places
    them; over processes this rank's group's and its ZeRO-1 chunk)."""
    with open(os.path.join(path, _META_FILE)) as f:
        old_config = RunConfig.from_json(json.load(f)["run_config"])
    tree = checkpoint.restore(path, _state_template(old_config))
    sess = api_compile(new_config, device=device, devices=devices)
    world = sess._pipeline_world
    params = for_config(sess.cfg).params_from_numpy(
        tree["params"], sess.device, torch.float32, cfg=sess.cfg)
    if world is not None:  # this rank's group's part alone
        sess.params = {k: params[k] for k in sess.params}
    else:
        sess.params = params
    if sess.meshes is not None and world is None:
        for pg, m in zip(train_step_lib.pipeline_group_params(
                sess.cfg, sess.plan, sess.params), sess.meshes):
            sess.params.update(reshard.to_group(pg, m.devices[0]))
    zero1 = sess.grad_comm == "reduce_scatter"
    mesh, entry = sess.mesh, sess.plan.stages[0]
    # the new run's state in the checkpoint's layout: global padded
    # buckets under ZeRO-1 (over processes every rank's chunk gathered),
    # each shard's chunk cut again below from them
    if zero1:
        chunks = spmd.all_shard_trees(mesh, sess.opt_state)
        fresh = grad_comm_lib.global_opt_state(
            [chunks[r] for r in train_step_lib.data_shards(mesh, entry)])
    elif world is not None:  # the old run's state of this group, if any
        fresh = sess.opt_state[world.group]
        if old_config.pipeline == sess.plan.n_groups:
            tree["opt"] = tree["opt"][world.group]
    else:
        fresh = sess.opt_state
    state, reset = _adapt_opt_state(tree["opt"], fresh)
    step = checkpoint.latest_step(path)
    if reset:
        report.events.append(
            f"optimizer state reset at step {step}"
            " (layout incompatible across the replan)")
    elif zero1:
        buckets = train_step_lib.convnet_grad_plan(sess.cfg)
        n = train_step_lib.data_degree(sess.plan)
        sess.opt_state = [grad_comm_lib.local_opt_state(
            state, buckets, train_step_lib.batch_slice(mesh, r, entry)[0], n,
            sess.device) for r in mesh.local_ranks]
    elif world is not None:
        sess.opt_state = tuple(state if g == world.group else None
                               for g in range(sess.plan.n_groups))
    else:
        sess.opt_state = state
    sess._t = step
    return sess


def _start_session(cfg_now: RunConfig, root: str, report: SupervisorReport,
                   verbose: bool, place: dict,
                   agreement: _Agreement) -> Session:
    """A session to continue from: the newest checkpoint that validates
    (rank 0's pick, broadcast), restored at the same degrees bitwise or
    re-degreed, or a cold start; every rank's restore agreed on."""
    found = checkpoint.latest_valid_step(root) if agreement.rank == 0 \
        else None
    step = agreement.from_rank0(-1 if found is None else found[0])
    sess, failure = None, None
    try:
        if step < 0:
            sess = api_compile(cfg_now, **place)
        else:
            path = checkpoint.step_dir(root, step)
            with open(os.path.join(path, _META_FILE)) as f:
                saved = RunConfig.from_json(json.load(f)["run_config"])
            if (saved.data, saved.spatial) == (cfg_now.data,
                                               cfg_now.spatial):
                sess = Session.restore(path, **place)  # bitwise
            else:
                sess = _elastic_restore(path, cfg_now, report, **place)
    except _CAUGHT as e:
        failure = e
    try:
        agreement(failure)
    except BaseException:
        if sess is not None:
            sess.close()
        raise
    if step < 0:
        report.cold_starts += 1
        _event(report, verbose, "cold start at step 0 "
               f"(data={cfg_now.data} spatial={cfg_now.spatial})")
    else:
        report.resumes += 1
        _event(report, verbose, f"resumed from step {step} "
               f"(data={cfg_now.data} spatial={cfg_now.spatial})")
    sess.resumes = report.resumes
    return sess


def _save(sess: Session, agreement: _Agreement, root: str, step: int,
          keep_last: int) -> None:
    """Checkpoint ``step`` into the retention root and collect the old
    ones: every rank takes part in the gathers, rank 0 writes, and the
    agreement after it is the barrier (a write that fails on rank 0
    fails every rank, where a barrier would leave them waiting)."""
    held = sess._checkpoint()
    failure = None
    if agreement.rank == 0:
        try:
            checkpoint.save(checkpoint.step_dir(root, step), **held)
            checkpoint.gc_steps(root, keep_last)
        except _CAUGHT as e:
            failure = e
    agreement(failure)


def _event(report: SupervisorReport, verbose: bool, msg: str) -> None:
    report.events.append(msg)
    # into whichever trace is active now: a failure's event fires before
    # the dying session's close() disables its tracer
    trace_lib.instant("supervisor.event", msg=msg)
    if verbose:
        print(f"[supervisor] {msg}")


def run(config: RunConfig, steps: int, *,
        batch_fn: Optional[Callable[[int], Tuple]] = None,
        save_every: Optional[int] = None,
        keep_last: Optional[int] = None,
        max_restarts: int = 8,
        watchdog_timeout_s: Optional[float] = None,
        divergence_patience: Optional[int] = None,
        verbose: bool = False,
        device: DeviceLike = None,
        devices: Optional[Sequence[DeviceLike]] = None
        ) -> SupervisorReport:
    """Train ``config`` for ``steps`` steps under the recovery loop, on
    ``device`` or ``devices`` (one per shard, as ``compile`` takes them;
    neither: the card). Over processes every rank calls it (the module
    docstring).

    ``batch_fn(t)`` gives the global batch of step ``t`` and must be a
    pure function of ``t`` for bitwise replay (the default synthetic
    source is; with ``config.data_dir`` set the default streams the
    store through ``Session.make_loader``, equally pure in ``t``, each
    rank reading its own blocks over processes).
    ``save_every``/``keep_last`` default to the config's policy (else
    every ``max(1, steps // 4)`` steps, keep 3). ``watchdog_timeout_s``
    bounds one step's wall time, read after ``float(loss)`` has waited
    for the device (each session's first TWO steps are exempt: kernels
    build and caches fill at first use). ``divergence_patience`` rolls
    back after that many consecutive skipped/non-finite steps. The final
    session rides along on the report (``report.session``); close it
    when done."""
    if config.checkpoint_dir is None:
        raise RunConfigError(
            "checkpoint_dir", "the supervisor recovers from checkpoints "
            "but has nowhere to write them",
            "set RunConfig.checkpoint_dir to a retention root")
    config.validate(device_count=None)
    ranks: Optional[Tuple[int, ...]] = None
    if dist_lib.wanted():  # every rank runs this loop: one a shard
        dist_lib.init()
        ranks = dist_lib.world()
        place = {"device": device, "devices": devices}
    else:
        place = {"devices": list(mesh_lib.mesh_devices(
            config.data * config.spatial, device=device, devices=devices))}
    root = config.checkpoint_dir
    save_every = save_every or config.save_every or max(1, steps // 4)
    keep_last = keep_last or config.keep_last or 3
    # the Session must not ALSO auto-save: the supervisor owns the
    # retention root, so intervals and GC stay consistent across resumes
    cfg_now = dataclasses.replace(config, save_every=None, keep_last=None)
    loader_mode = batch_fn is None and config.data_dir is not None

    report = SupervisorReport(
        steps=steps, losses=[float("nan")] * steps,
        final_data=config.data, final_spatial=config.spatial)
    sess: Optional[Session] = None
    pending: Optional[Tuple[float, int]] = None  # (t_fail_wall, fail_step)
    consec_bad = 0
    prev_skipped = 0.0
    warming = 2

    while True:
        agreement = _Agreement(ranks)
        try:
            if sess is None:
                with (dist_lib.sub_world(ranks) if ranks is not None
                      else contextlib.nullcontext()):
                    sess = _start_session(cfg_now, root, report, verbose,
                                          place, agreement)
                if loader_mode:
                    batch_fn = _loader_batch_fn(sess, cfg_now)
                elif batch_fn is None:
                    batch_fn = _default_batch_fn(config, sess.device)
                prev_skipped = (sess._guarded_steps
                                - float(sess._applied_acc))
                warming = 2  # first use: builds, caches, allocations
            while sess.step_count < steps:
                t = sess.step_count
                t0 = time.perf_counter()
                try:
                    batch = batch_fn(t)
                except _CAUGHT as e:  # agreed on before any collective
                    agreement(e)
                    raise
                # waits: the watchdog
                loss = float(sess.step(batch, agree=agreement))
                dt = time.perf_counter() - t0
                failure: Optional[BaseException] = None
                if (watchdog_timeout_s is not None and warming == 0
                        and dt > watchdog_timeout_s):
                    failure = StepTimeout(
                        f"step {t} took {dt:.2f}s > watchdog "
                        f"{watchdog_timeout_s:.2f}s")
                skipped = (sess._guarded_steps - float(sess._applied_acc)
                           if config.resolved_guard else 0.0)
                bad = skipped > prev_skipped or not math.isfinite(loss)
                if (failure is None and divergence_patience is not None
                        and (consec_bad + 1 if bad else 0)
                        >= divergence_patience):
                    failure = Divergence(
                        f"{divergence_patience} consecutive skipped/"
                        f"non-finite steps ending at step {t}")
                failure = agreement.settle(failure)
                if isinstance(failure, StepTimeout):
                    raise failure
                warming = max(warming - 1, 0)
                report.losses[t] = loss
                if pending is not None and sess.step_count > pending[1]:
                    report.recovery_s.append(time.perf_counter()
                                             - pending[0])
                    pending = None
                consec_bad = consec_bad + 1 if bad else 0
                prev_skipped = skipped
                if failure is not None:
                    consec_bad = 0
                    raise failure
                if (t + 1) % save_every == 0 or (t + 1) == steps:
                    _save(sess, agreement, root, t + 1, keep_last)
            break
        except _CAUGHT as e:
            fail_step = sess.step_count if sess is not None else 0
            report.restarts += 1
            _event(report, verbose,
                   f"failure at step {fail_step}: {type(e).__name__}: {e}")
            if report.restarts > max_restarts:
                if sess is not None:
                    sess.close()
                raise SupervisorError(
                    f"gave up after {max_restarts} restarts "
                    f"(last failure at step {fail_step}: {e})") from e
            if isinstance(e, faults.DeviceLost) and e.available is not None:
                cfg_now = degrade_config(cfg_now, e.available)
                n = cfg_now.data * cfg_now.spatial
                if place.get("devices") is not None:
                    place["devices"] = list(place["devices"])[:n]
                report.replans += 1
                report.final_data = cfg_now.data
                report.final_spatial = cfg_now.spatial
                _event(report, verbose,
                       f"replanned for {e.available} devices: "
                       f"data={cfg_now.data} spatial={cfg_now.spatial}")
                if ranks is not None:
                    if agreement.rank >= n:
                        if sess is not None:
                            sess.close()
                        report.released = True
                        _event(report, verbose,
                               f"released: rank {agreement.rank} is not "
                               f"among the {n} that continue")
                        return report
                    ranks = ranks[:n]
            if isinstance(e, Divergence):
                report.rollbacks += 1
            if pending is None:
                pending = (time.perf_counter(), fail_step)
            if sess is not None:
                sess.close()
            sess = None

    report.skipped_steps = int(sess.telemetry()["skipped_steps"])
    report.session = sess
    return report


__all__ = ["run", "SupervisorReport", "SupervisorError", "StepTimeout",
           "Divergence", "degrade_config"]
