"""Counters / gauges / histograms behind one registry (DESIGN.md §14).

``MetricsRegistry`` is the landing zone for what used to be scattered
``telemetry()`` dicts: ``Session.telemetry()`` now routes every value
through registry gauges and reads the returned dict *back out of the
registry*, so the key set and values are bitwise-unchanged while any
other consumer (JSONL sink, drift report, benches) sees the same
numbers through one interface.

Histograms keep count/sum/min/max (no reservoir): enough for the span
aggregates the drift table consumes, cheap enough for per-op pipeline
spans.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, IO, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "MetricsJsonlSink"]


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("_lock", "value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """Last-set value; preserves the type it was set with (int stays
    int) so telemetry values round-trip bitwise."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value: Any = 0.0

    def set(self, v: Any) -> None:
        self.value = v


class Histogram:
    """Streaming count/sum/min/max aggregate of observed values."""

    __slots__ = ("_lock", "count", "total", "min", "max")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.total += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Name → instrument map. Creation is get-or-create and
    thread-safe; reads hand back the live instrument."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram()
            return h

    def counters(self) -> Dict[str, Counter]:
        with self._lock:
            return dict(self._counters)

    def gauges(self) -> Dict[str, Gauge]:
        with self._lock:
            return dict(self._gauges)

    def histograms(self) -> Dict[str, Histogram]:
        with self._lock:
            return dict(self._histograms)

    def absorb(self, values: Dict[str, Any]) -> Dict[str, Any]:
        """Route a telemetry dict through gauges and read it back out,
        preserving key order and value identity (the telemetry-key
        stability contract)."""
        for k, v in values.items():
            self.gauge(k).set(v)
        return {k: self.gauge(k).value for k in values}

    def snapshot(self) -> Dict[str, Any]:
        """Flat dict of every instrument: gauges by name, counters by
        name, histograms expanded to ``.count`` / ``.mean`` /
        ``.min`` / ``.max``."""
        out: Dict[str, Any] = {}
        for k, g in self.gauges().items():
            out[k] = g.value
        for k, c in self.counters().items():
            out[k] = c.value
        for k, h in self.histograms().items():
            out[k + ".count"] = h.count
            out[k + ".mean"] = h.mean
            if h.count:
                out[k + ".min"] = h.min
                out[k + ".max"] = h.max
        return out


class MetricsJsonlSink:
    """Append-only JSONL sink: one ``write(row)`` per step, flushed so
    a crashed run keeps every completed row. Idempotent ``close``."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._f: Optional[IO[str]] = open(path, "a")

    def write(self, row: Dict[str, Any]) -> None:
        with self._lock:
            if self._f is None:
                return
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
