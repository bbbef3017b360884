"""repro_torch.obs — unified tracing & metrics for the write/read/serving stack.

Dependency-free (stdlib only).  Three pieces:

* ``obs.trace``   — context-local span tracer (``span``/``event``/
  ``tracing``), thread-aware via ``wrap_for_thread``, plus the
  ``ContextLocal`` home for per-context stats objects.
* ``obs.metrics`` — typed counters/gauges/histograms with ``snapshot()``.
* ``obs.export``  — Chrome-trace / Perfetto JSON export with per-device
  tracks; ``tracing(torch_profiler=True)`` bridges spans into
  ``torch.profiler.record_function``.

A copy of the reference's ``repro.obs`` (docs/observability.md describes
the span model and metric names).
"""
from repro_torch.obs import export, metrics, trace
from repro_torch.obs.export import chrome_trace, write_chrome_trace
from repro_torch.obs.trace import (ContextLocal, Span, SpanEvent, Tracer,
                             current_span, current_tracer, event, span,
                             tracing, wrap_for_thread)

__all__ = [
    "export", "metrics", "trace",
    "chrome_trace", "write_chrome_trace",
    "ContextLocal", "Span", "SpanEvent", "Tracer",
    "current_span", "current_tracer", "event", "span", "tracing",
    "wrap_for_thread",
]
