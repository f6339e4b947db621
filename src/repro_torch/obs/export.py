"""Chrome/Perfetto trace export + a minimal schema checker.

The exported file is the Chrome Trace Event JSON-object format
(``{"traceEvents": [...]}``) that both ``chrome://tracing`` and
Perfetto's UI load directly. Every emitting thread gets its own track:
events carry the thread id as ``tid`` and a ``thread_name`` metadata
("M") event names the track, so the per-group 1F1B dispatcher threads
(``pipe-dispatch_*``), link threads (``pipe-link_*``) and prefetch
workers (``io-prefetch_*``) each render as one lane — the pipeline
bubble is the empty space between ops on a dispatcher lane.

``validate_chrome_trace`` is the verify-gate checker: a deliberately
minimal structural validation (the fields Perfetto actually requires),
not a full spec implementation.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

__all__ = ["chrome_trace_events", "write_chrome_trace",
           "validate_chrome_trace"]

_PID = 1  # single-process runtime: one process row, many thread tracks


def _json_safe(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def chrome_trace_events(tracer) -> List[Dict[str, Any]]:
    """Lower a ``Tracer``'s event log to Chrome trace-event dicts."""
    events = tracer.events()
    out: List[Dict[str, Any]] = []
    seen_threads: Dict[int, str] = {}
    for ev in events:
        if ev.tid not in seen_threads:
            seen_threads[ev.tid] = ev.thread
            out.append({
                "name": "thread_name", "ph": "M", "pid": _PID,
                "tid": ev.tid, "args": {"name": ev.thread},
            })
        rec: Dict[str, Any] = {
            "name": ev.name,
            "cat": ev.name.split(".", 1)[0],
            "pid": _PID,
            "tid": ev.tid,
            "ts": ev.ts_ns / 1e3,          # microseconds
        }
        if ev.dur_ns is None:
            rec["ph"] = "i"
            rec["s"] = "t"                 # thread-scoped instant
        else:
            rec["ph"] = "X"
            rec["dur"] = ev.dur_ns / 1e3
        if ev.attrs:
            rec["args"] = {k: _json_safe(v) for k, v in ev.attrs.items()}
        out.append(rec)
    return out


def write_chrome_trace(path: str, tracer) -> str:
    """Write the tracer's log as a Perfetto-loadable ``trace.json``."""
    payload = {
        "traceEvents": chrome_trace_events(tracer),
        "displayTimeUnit": "ms",
    }
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


def validate_chrome_trace(path: str) -> Tuple[bool, List[str]]:
    """Minimal Chrome-trace structural check; ``(ok, problems)``.

    Requires: a JSON object with a ``traceEvents`` list; every event an
    object with string ``name`` / ``ph`` and numeric ``pid`` / ``tid``;
    "X" events additionally need numeric ``ts`` and non-negative
    ``dur``; "i" events a numeric ``ts``; "M" thread_name events an
    ``args.name`` string. At most 20 problems are reported.
    """
    problems: List[str] = []

    def bad(i: int, msg: str) -> None:
        if len(problems) < 20:
            problems.append(f"event[{i}]: {msg}")

    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return False, [f"unreadable: {e}"]
    if not isinstance(doc, dict) or not isinstance(
            doc.get("traceEvents"), list):
        return False, ["top level must be an object with a "
                       "'traceEvents' list"]
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            bad(i, "not an object")
            continue
        if not isinstance(ev.get("name"), str):
            bad(i, "missing string 'name'")
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            bad(i, "missing string 'ph'")
            continue
        for k in ("pid", "tid"):
            if not isinstance(ev.get(k), (int, float)):
                bad(i, f"missing numeric '{k}'")
        if ph in ("X", "i", "B", "E"):
            if not isinstance(ev.get("ts"), (int, float)):
                bad(i, "missing numeric 'ts'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                bad(i, "'X' event needs non-negative numeric 'dur'")
        if ph == "M" and ev.get("name") == "thread_name":
            args = ev.get("args")
            if not (isinstance(args, dict)
                    and isinstance(args.get("name"), str)):
                bad(i, "'thread_name' metadata needs args.name string")
    return (not problems), problems
