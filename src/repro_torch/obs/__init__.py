"""Observability of the port: thread-safe monotonic span tracing, a
metrics registry, and Chrome/Perfetto trace export — copies of the
reference's ``obs.trace``, ``obs.metrics`` and ``obs.export``, which
import only the standard library. ``repro_torch.obs.report`` (the drift
table) pulls in the time model and is imported by its consumer,
``Session.report``, not from here. Span and counter names are the
reference's (``serve.enqueue/batch/forward/reply``, ``serve.*``)."""
from repro_torch.obs.trace import (  # noqa: F401
    NULL_SPAN,
    Tracer,
    active,
    count,
    disable,
    enable,
    instant,
    span,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsJsonlSink,
    MetricsRegistry,
)
from repro_torch.obs.export import (  # noqa: F401
    chrome_trace_events,
    validate_chrome_trace,
    write_chrome_trace,
)
