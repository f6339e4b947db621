"""Seeded deterministic fault injection (DESIGN.md §11).

The paper's operating regime — multi-day campaigns on up to 2K GPUs —
makes node failures, transient I/O errors, and non-finite gradients
routine, but they are impossible to test against if they only happen in
production. This registry lets tests, the resilience bench, and the
verify gate *schedule* failures at named sites in the pipeline and get
the exact same failure on every run:

* ``loader.read``       — a transient store read error (``data/store.py``
                          raises ``InjectedIOError``; the retry/backoff
                          wrapper is expected to absorb bounded ones).
* ``grads.nonfinite``   — poison the step's batch so the loss and every
                          gradient go non-finite (the guarded step must
                          skip the update; ``Session.step`` consults it).
* ``checkpoint.write``  — kill the checkpoint writer between leaf writes
                          (``train/checkpoint.py``; the atomic temp+rename
                          protocol must leave the previous checkpoint
                          restorable, bitwise).
* ``device.loss``       — a node failure surfacing as ``DeviceLost``; with
                          ``available=`` set, the supervisor must re-plan
                          for the smaller device count (elastic recovery),
                          otherwise it resumes at the same degrees.
* ``comm.stall``        — a host-side sleep standing in for a hung
                          collective; the supervisor's step watchdog must
                          classify the over-long step as a failure.
* ``serve.forward``     — a serving worker's batched forward dies
                          mid-call (``serve/harness.py``; the failure
                          must surface on that batch's futures — never
                          as a hung queue).

Sites are instrumented with ``faults.fire(site, ...)``: a no-op (and, by
design, nearly free — one dict lookup) when nothing is armed, so the
hooks stay in production code paths. Arming is explicit and scoped:

    with faults.active(faults.FaultSpec("device.loss", at_steps=(5,))):
        supervisor.run(config, steps=8)

Determinism: call-indexed (``at_calls``) and step-indexed (``at_steps``)
schedules are exact; probabilistic firing draws from a per-site
``numpy`` generator seeded from ``(seed, site)``, so a seeded run fires
at the same calls every time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

SITES = ("loader.read", "grads.nonfinite", "checkpoint.write",
         "device.loss", "comm.stall", "serve.forward")


class InjectedFault(RuntimeError):
    """Base class for every scheduled failure; carries its site."""

    def __init__(self, site: str, msg: str):
        self.site = site
        super().__init__(msg)


class InjectedIOError(InjectedFault, IOError):
    """A (possibly transient) store/loader I/O failure."""


class InjectedCrash(InjectedFault):
    """The process 'dies' mid-operation (e.g. between checkpoint leaf
    writes). Handlers must NOT clean up after it — that is the point."""


class DeviceLost(InjectedFault):
    """A device/node failure. ``available`` is the device count the
    restarted job sees (None: a transient loss — same count on resume)."""

    def __init__(self, site: str, msg: str, available: Optional[int] = None):
        super().__init__(site, msg)
        self.available = available


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault at one site.

    ``at_calls``: 0-based indices into the site's call sequence (as
    counted from arming). ``at_steps``: fire when the caller passes a
    matching ``step=``. ``probability``: seeded Bernoulli per call on top
    of (or instead of) the exact schedules. ``max_fires`` bounds the
    total fires — the knob that makes an injected I/O error *transient*
    (fire twice, then let the retry succeed). ``available``/``stall_s``
    parameterize ``device.loss``/``comm.stall``."""

    site: str
    at_calls: Tuple[int, ...] = ()
    at_steps: Tuple[int, ...] = ()
    probability: float = 0.0
    max_fires: Optional[int] = None
    available: Optional[int] = None   # device.loss only
    stall_s: float = 0.25             # comm.stall only

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; "
                             f"sites: {', '.join(SITES)}")
        if not (self.at_calls or self.at_steps or self.probability):
            raise ValueError(f"FaultSpec({self.site!r}) has no schedule: "
                             "set at_calls, at_steps, or probability")


class _Armed:
    def __init__(self, spec: FaultSpec, seed: int):
        import numpy as np
        self.spec = spec
        self.calls = 0
        self.fires = 0
        self._rng = np.random.default_rng(
            (seed & 0xFFFFFFFF) ^ zlib.crc32(spec.site.encode()))

    def should_fire(self, step: Optional[int]) -> bool:
        call, self.calls = self.calls, self.calls + 1
        if (self.spec.max_fires is not None
                and self.fires >= self.spec.max_fires):
            return False
        hit = (call in self.spec.at_calls
               or (step is not None and step in self.spec.at_steps)
               or (self.spec.probability > 0
                   and self._rng.random() < self.spec.probability))
        if hit:
            self.fires += 1
        return hit


_ARMED: Dict[str, List[_Armed]] = {}
_CALLS: Dict[str, int] = {}
# ``loader.read`` fires from prefetch worker threads (DESIGN.md §12);
# the lock keeps call-indexed schedules exact under concurrency
# (unsynchronized counters would make ``at_calls`` nondeterministic)
_LOCK = threading.Lock()


def configure(*specs: FaultSpec, seed: int = 0) -> None:
    """Arm fault specs (cumulative; ``clear()`` disarms everything)."""
    for spec in specs:
        _ARMED.setdefault(spec.site, []).append(_Armed(spec, seed))


def clear() -> None:
    _ARMED.clear()
    _CALLS.clear()


@contextlib.contextmanager
def active(*specs: FaultSpec, seed: int = 0):
    """Scope-arm specs; restores the previous arming on exit."""
    saved_armed, saved_calls = dict(_ARMED), dict(_CALLS)
    _ARMED.clear()
    _CALLS.clear()
    configure(*specs, seed=seed)
    try:
        yield
    finally:
        _ARMED.clear()
        _ARMED.update(saved_armed)
        _CALLS.clear()
        _CALLS.update(saved_calls)


def stats() -> Dict[str, Dict[str, int]]:
    """Per-site call/fire counters for the currently armed specs."""
    out: Dict[str, Dict[str, int]] = {}
    for site, armed in _ARMED.items():
        out[site] = {"calls": _CALLS.get(site, 0),
                     "fires": sum(a.fires for a in armed)}
    return out


def fire(site: str, step: Optional[int] = None, **info) -> bool:
    """Instrumentation hook: called at each named site.

    Raises the site's failure (``loader.read``/``checkpoint.write``/
    ``device.loss``), sleeps (``comm.stall``), or returns True for
    condition sites the caller acts on (``grads.nonfinite``). Returns
    False — at the cost of one dict lookup — when nothing is armed.
    Thread-safe: worker-thread sites (``loader.read`` under a prefetch
    loader) count calls under a lock so schedules stay exact."""
    armed = _ARMED.get(site)
    if not armed:
        return False
    with _LOCK:
        _CALLS[site] = _CALLS.get(site, 0) + 1
        hit = next((a for a in armed if a.should_fire(step)), None)
    if hit is None:
        return False
    where = f" at {info}" if info else ""
    at = f" (step {step})" if step is not None else ""
    if site == "loader.read":
        raise InjectedIOError(site, f"injected store read error{where}")
    if site == "checkpoint.write":
        raise InjectedCrash(
            site, f"injected writer kill between leaf writes{where}")
    if site == "device.loss":
        n = hit.spec.available
        detail = (f"{n} devices remain" if n is not None
                  else "transient, same count on resume")
        raise DeviceLost(site, f"injected device loss{at}: {detail}",
                         available=n)
    if site == "comm.stall":
        time.sleep(hit.spec.stall_s)
    if site == "serve.forward":
        # a serving worker's batched forward dies mid-call; the harness
        # must surface it on THAT batch's futures, not hang the queue
        raise InjectedFault(site, f"injected serving forward error{where}")
    return True  # comm.stall done; grads.nonfinite: caller poisons batch


__all__ = [
    "SITES", "FaultSpec", "InjectedFault", "InjectedIOError",
    "InjectedCrash", "DeviceLost", "configure", "clear", "active",
    "fire", "stats",
]
