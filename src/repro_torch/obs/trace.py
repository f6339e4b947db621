"""Thread-safe monotonic span tracer (DESIGN.md §14).

One process-wide *active* tracer serves every instrumentation site —
the pipeline dispatcher threads, prefetch workers, checkpoint publish,
the guarded step — because those sites live in modules that never see a
``Session``. ``Session`` owns a ``Tracer`` and registers it while the
run is live; when nothing is registered, ``span()`` / ``instant()`` /
``count()`` are near-free no-ops (one global load, one ``is None``
test, one cached-singleton return), which is what keeps the
trace-off overhead inside the ≤2% gate.

Spans use ``time.perf_counter_ns`` (monotonic) and record the emitting
thread's id and name, so the Chrome export gets one track per
dispatcher/worker thread for free — the 1F1B bubble shows up as the
gaps between ops on a ``pipe-dispatch_*`` track.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.metrics import MetricsRegistry

__all__ = [
    "Event", "Tracer", "NULL_SPAN", "active", "enable", "disable",
    "span", "instant", "count",
]


class Event:
    """One recorded trace event. ``dur_ns`` is ``None`` for instants."""

    __slots__ = ("name", "ts_ns", "dur_ns", "tid", "thread", "attrs")

    def __init__(self, name: str, ts_ns: int, dur_ns: Optional[int],
                 tid: int, thread: str,
                 attrs: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.ts_ns = ts_ns
        self.dur_ns = dur_ns
        self.tid = tid
        self.thread = thread
        self.attrs = attrs


class _NullSpan:
    """Cached no-op context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """Live span: records a complete event on ``__exit__``."""

    __slots__ = ("_tracer", "_name", "_attrs", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]) -> None:
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._tracer._record(self._name, self._t0, t1 - self._t0,
                             self._attrs)
        return False


class Tracer:
    """Append-only event log + span-duration aggregates.

    Every finished span also feeds a ``span.<name>`` histogram in
    ``self.metrics`` — that aggregate view is the *measured* side of
    the drift table (``repro_torch.obs.report``), so reports are
    sourced from spans rather than from any probe's return value.
    """

    def __init__(self, max_events: int = 1_000_000) -> None:
        self._lock = threading.Lock()
        self._events: List[Event] = []
        self._max_events = max_events
        self._dropped = 0
        self.metrics = MetricsRegistry()
        self.epoch_ns = time.perf_counter_ns()

    # ------------------------------------------------------- recording ----
    def span(self, name: str, **attrs: Any) -> _Span:
        return _Span(self, name, attrs or None)

    def instant(self, name: str, **attrs: Any) -> None:
        self._record(name, time.perf_counter_ns(), None, attrs or None)

    def count(self, name: str, n: float = 1.0) -> None:
        self.metrics.counter(name).inc(n)

    def _record(self, name: str, ts_ns: int, dur_ns: Optional[int],
                attrs: Optional[Dict[str, Any]]) -> None:
        th = threading.current_thread()
        ev = Event(name, ts_ns - self.epoch_ns, dur_ns, th.ident or 0,
                   th.name, attrs)
        with self._lock:
            if len(self._events) >= self._max_events:
                self._dropped += 1
                return
            self._events.append(ev)
        if dur_ns is not None:
            self.metrics.histogram("span." + name).observe(dur_ns * 1e-9)

    # --------------------------------------------------------- reading ----
    def events(self) -> List[Event]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def span_seconds(self) -> Dict[str, Tuple[int, float]]:
        """``{span name: (count, mean seconds)}`` from the aggregates."""
        out: Dict[str, Tuple[int, float]] = {}
        for name, h in self.metrics.histograms().items():
            if name.startswith("span."):
                out[name[len("span."):]] = (h.count, h.mean)
        return out

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
        self.epoch_ns = time.perf_counter_ns()

    # ---------------------------------------------------------- export ----
    def export_chrome(self, path: str) -> str:
        from repro_torch.obs.export import write_chrome_trace
        return write_chrome_trace(path, self)


# ---------------------------------------------------------------------------
# Process-wide active tracer. Module-level function lookups keep the
# disabled path at one global load + one comparison per call site.
# ---------------------------------------------------------------------------
_ACTIVE: Optional[Tracer] = None


def active() -> Optional[Tracer]:
    """The currently registered tracer, or ``None`` when tracing is off."""
    return _ACTIVE


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Register ``tracer`` (or a fresh one) as the process-active tracer."""
    global _ACTIVE
    if tracer is None:
        tracer = Tracer()
    _ACTIVE = tracer
    return tracer


def disable(tracer: Optional[Tracer] = None) -> None:
    """Deactivate tracing. With ``tracer`` given, only deactivates if that
    tracer is the active one — so closing an old session never silently
    disables a newer session's tracer."""
    global _ACTIVE
    if tracer is None or _ACTIVE is tracer:
        _ACTIVE = None


def span(name: str, **attrs: Any):
    """A span on the active tracer, or the cached no-op when off."""
    t = _ACTIVE
    if t is None:
        return NULL_SPAN
    return t.span(name, **attrs)


def instant(name: str, **attrs: Any) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, **attrs)


def count(name: str, n: float = 1.0) -> None:
    t = _ACTIVE
    if t is not None:
        t.count(name, n)
