"""Typed counters / gauges / histograms with a snapshot API.

The metrics registry is the *numeric* half of ``repro_torch.obs`` (the tracer is
the *temporal* half): always-on, context-local (``trace.ContextLocal``),
thread-safe, stdlib-only.  The stack records into it unconditionally —
counter increments are a dict lookup plus a lock, cheap against the device
work they annotate — and benchmarks/CI read one ``snapshot()`` dict.

Canonical names used across the stack (labels in parentheses):

  counters    ``store.bytes_raw`` / ``store.bytes_stored`` (var),
              ``codec.bytes_in`` / ``codec.bytes_out`` (codec, group),
              ``codec.groups`` (codec, group),
              ``backend.bytes_served`` / ``backend.bytes_fetched``,
              ``backend.cache_hits`` / ``backend.cache_misses``,
              ``serve.requests`` / ``serve.bytes_fetched``
  gauges      ``store.compression_ratio`` (var) — raw/stored, >= 1 is a win,
              ``write.syncs_per_chunk`` / ``write.dispatches_per_chunk``
  histograms  ``serve.retrieve_s``, ``serve.decode_s`` — p50/p99 in the
              snapshot

Labels are free-form keyword arguments; a labelled series snapshots under
``name{k=v,...}`` (sorted keys, Prometheus-flavored) so budgets in
``benchmarks/check_regressions.py`` can address exact series.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.obs import trace as _trace

# histogram sample retention: bounded ring so long-running services cannot
# grow without bound; count/sum/min/max stay exact, quantiles are computed
# over the retained window (documented approximation)
HIST_WINDOW = 4096


class StatCounters:
    """Base of the engines' thread-safe ``STATS`` objects: a dataclass
    subclass declares integer fields; ``add``/``snapshot``/``reset`` act on
    all of them under one lock."""

    def __post_init__(self):
        self._lock = threading.Lock()

    def add(self, **kw: int) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {f.name: getattr(self, f.name)
                    for f in dataclasses.fields(self)}

    def reset(self) -> None:
        with self._lock:
            for f in dataclasses.fields(self):
                setattr(self, f.name, 0)


def _series(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank quantile: the smallest value with at least q of the
    sample at or below it (p50 of [1,2,3,4] is 2, p99 is 4)."""
    if not sorted_vals:
        return 0.0
    idx = max(math.ceil(q * len(sorted_vals)) - 1, 0)
    return sorted_vals[min(idx, len(sorted_vals) - 1)]


class _Hist:
    __slots__ = ("count", "sum", "min", "max", "window")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.window: List[float] = []

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self.window) < HIST_WINDOW:
            self.window.append(v)
        else:
            self.window[self.count % HIST_WINDOW] = v

    def snapshot(self) -> Dict[str, float]:
        vals = sorted(self.window)
        return {"count": self.count, "sum": self.sum,
                "min": self.min if self.min is not None else 0.0,
                "max": self.max if self.max is not None else 0.0,
                "mean": self.sum / self.count if self.count else 0.0,
                "p50": _quantile(vals, 0.50), "p99": _quantile(vals, 0.99)}


class Metrics:
    """One registry: counters, gauges, histograms keyed by labelled series."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, _Hist] = {}

    def inc(self, name: str, value: float = 1, **labels: Any) -> None:
        k = _series(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def gauge(self, name: str, value: float, **labels: Any) -> None:
        with self._lock:
            self._gauges[_series(name, labels)] = value

    def observe(self, name: str, value: float, **labels: Any) -> None:
        k = _series(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Hist()
            h.observe(value)

    def counter_value(self, name: str, **labels: Any) -> float:
        with self._lock:
            return self._counters.get(_series(name, labels), 0)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {k: h.snapshot()
                               for k, h in self._hists.items()},
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


# Context-local registry with a process-global default: services and tests
# isolate with ``scope()``; everything else lands in the default registry.
REGISTRY = _trace.ContextLocal(Metrics)


def get() -> Metrics:
    """The current context's registry."""
    return REGISTRY.get()


def inc(name: str, value: float = 1, **labels: Any) -> None:
    REGISTRY.get().inc(name, value, **labels)


def gauge(name: str, value: float, **labels: Any) -> None:
    REGISTRY.get().gauge(name, value, **labels)


def observe(name: str, value: float, **labels: Any) -> None:
    REGISTRY.get().observe(name, value, **labels)


def snapshot() -> Dict[str, Any]:
    return REGISTRY.get().snapshot()


def reset() -> None:
    REGISTRY.get().reset()


@contextlib.contextmanager
def scope(registry: Optional[Metrics] = None) -> Iterator[Metrics]:
    """Fresh (or given) registry for the current context — benchmarks wrap
    each run so artifacts snapshot only their own numbers."""
    with REGISTRY.scope(registry) as m:
        yield m
