"""Context-local span tracer: attribute time, syncs, and dispatches.

The write/read/serving stack spreads its work across the main thread, the
chunked pipeline's prefetch/serialize workers, ``overlap_map`` feeder
threads, and (sharded) several devices.  Ad-hoc process-global counters
(``lossless_batch.STATS`` & friends) can say *how many* host syncs happened
but not *who* caused them — this module adds the missing attribution.

Model
-----
* A ``Tracer`` collects finished ``Span``\\ s.  Tracing is **opt-in and
  context-local**: ``with tracing() as tr:`` installs a tracer for the
  current :mod:`contextvars` context; code outside a tracing context pays
  a single ContextVar read per ``span()``/``event()`` call (the <2%%
  disabled-overhead contract, checked by ``benchmarks/refactor_benchmarks``).
* ``span(name, **attrs)`` opens a nested span.  Spans record wall-clock
  start/duration, the opening thread, free-form attributes (``chunk=3``,
  ``device=1``), and typed point events.
* ``event(name, **attrs)`` records a typed point event (``host_sync``,
  ``dispatch``, ``device_put``, ``serialize``, ``backend_read``) on the
  current span — the event inherits the span's identity, so every host sync
  in a trace knows its originating span.

Threads
-------
ContextVars do NOT flow into new threads by default.  Worker threads that
should attribute their spans to the caller's trace (and mutate the caller's
context-local stats) must run under a copy of the caller's context:
``threading.Thread(target=contextvars.copy_context().run, args=(fn,))`` —
``wrap_for_thread`` packages that idiom.  The chunked pipelines and the
store's overlap feeders already do this, so dispatch-ahead work lands in
the right trace.

``ContextLocal`` is the shared home for per-context stats objects
(``lossless_batch.STATS`` et al.): each context gets its own instance on
demand (falling back to a process-global default), and a context *copy*
shares the instance — worker threads add to the caller's counters, while
unrelated contexts never race on one global.

Everything here is stdlib-only at import time (torch is imported only
when the profiler bridge is asked for): the tracer must be usable from
serialization helpers and benchmarks without dragging in a backend.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

# Typed event names used across the stack (free-form names are fine too;
# these are the ones the exporters and benchmarks aggregate on).
EV_HOST_SYNC = "host_sync"
EV_DISPATCH = "dispatch"
EV_DEVICE_PUT = "device_put"
EV_SERIALIZE = "serialize"
EV_BACKEND_READ = "backend_read"


@dataclasses.dataclass
class SpanEvent:
    """A typed point event inside a span."""
    name: str
    ts: float                       # perf_counter seconds
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Span:
    name: str
    span_id: int
    parent_id: Optional[int]
    t0: float
    t1: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events: List[SpanEvent] = dataclasses.field(default_factory=list)
    thread: str = ""

    @property
    def duration_s(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) - self.t0


class Tracer:
    """Thread-safe collector of finished spans (and span-less events)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: List[Span] = []
        self._orphans: List[SpanEvent] = []
        self._ids = itertools.count(1)
        self.t_epoch = time.perf_counter()

    # -- recording (internal) ------------------------------------------------
    def _next_id(self) -> int:
        return next(self._ids)

    def _add_span(self, s: Span) -> None:
        with self._lock:
            self._spans.append(s)

    def _add_orphan(self, ev: SpanEvent) -> None:
        with self._lock:
            self._orphans.append(ev)

    # -- inspection ----------------------------------------------------------
    def spans(self) -> List[Span]:
        """Snapshot of all *finished* spans, in completion order."""
        with self._lock:
            return list(self._spans)

    def orphan_events(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._orphans)

    def events(self, name: Optional[str] = None
               ) -> List[Tuple[Optional[Span], SpanEvent]]:
        """All (span, event) pairs, optionally filtered by event name.
        Orphan events (recorded outside any span) pair with ``None``."""
        out: List[Tuple[Optional[Span], SpanEvent]] = []
        for s in self.spans():
            for ev in s.events:
                if name is None or ev.name == name:
                    out.append((s, ev))
        for ev in self.orphan_events():
            if name is None or ev.name == name:
                out.append((None, ev))
        return out

    def event_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for _, ev in self.events():
            out[ev.name] = out.get(ev.name, 0) + 1
        return out

    def attribute_events(self, name: str = EV_HOST_SYNC,
                         key: str = "label") -> Dict[str, int]:
        """Count ``name`` events by originating span.

        The attribution key is the event's ``key`` attribute when present
        (e.g. ``host_sync(label=...)`` call-site tags), else the enclosing
        span's name, else ``"<none>"`` — this is how the benchmarks answer
        "whose syncs are these?"."""
        out: Dict[str, int] = {}
        for span_, ev in self.events(name):
            k = ev.attrs.get(key) or (span_.name if span_ else "<none>")
            out[str(k)] = out.get(str(k), 0) + 1
        return out

    def total_s(self, span_name: str) -> float:
        """Summed wall seconds of all finished spans named ``span_name``."""
        return sum(s.duration_s for s in self.spans() if s.name == span_name)

    def summary(self) -> Dict[str, Any]:
        """Compact JSON-able digest: per-span-name count/total wall seconds
        plus global event counts (what the benchmark artifacts embed)."""
        per: Dict[str, Dict[str, float]] = {}
        for s in self.spans():
            d = per.setdefault(s.name, {"count": 0, "total_s": 0.0})
            d["count"] += 1
            d["total_s"] += s.duration_s
        return {"spans": per, "events": self.event_counts(),
                "host_syncs_by_span": self.attribute_events(EV_HOST_SYNC)}


# ------------------------------------------------------------ context state --

_tracer_var: "contextvars.ContextVar[Optional[Tracer]]" = \
    contextvars.ContextVar("repro_obs_tracer", default=None)
_span_var: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("repro_obs_span", default=None)


def current_tracer() -> Optional[Tracer]:
    return _tracer_var.get()


def current_span() -> Optional[Span]:
    return _span_var.get()


def enabled() -> bool:
    return _tracer_var.get() is not None


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None,
            torch_profiler: bool = False) -> Iterator[Tracer]:
    """Install a tracer for the current context (and threads that run under
    a copy of it — see ``wrap_for_thread``).

    ``torch_profiler=True`` additionally bridges every span into
    ``torch.profiler.record_function`` so repro spans line up with the
    card's kernels in a ``torch.profiler`` trace."""
    t = tracer if tracer is not None else Tracer()
    if torch_profiler:
        t._annotation = _profiler_annotation_cls()  # type: ignore[attr-defined]
    tok = _tracer_var.set(t)
    try:
        yield t
    finally:
        _tracer_var.reset(tok)


@contextlib.contextmanager
def no_tracing() -> Iterator[None]:
    """Uninstall any active tracer for the dynamic extent of the block —
    the disabled-overhead measurement's off-switch (span() returns the
    shared null manager inside)."""
    tok = _tracer_var.set(None)
    try:
        yield
    finally:
        _tracer_var.reset(tok)


def _profiler_annotation_cls():
    from torch.profiler import record_function  # deferred: stdlib import
    return record_function


class _NullSpan:
    """Shared no-op context manager: the disabled-tracing fast path."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _SpanCtx:
    __slots__ = ("_tracer", "_span", "_token", "_ann_ctx")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        parent = _span_var.get()
        self._span = Span(name=name, span_id=tracer._next_id(),
                          parent_id=parent.span_id if parent else None,
                          t0=time.perf_counter(), attrs=attrs,
                          thread=threading.current_thread().name)
        self._token = None
        self._ann_ctx = None

    def __enter__(self) -> Span:
        self._token = _span_var.set(self._span)
        ann = getattr(self._tracer, "_annotation", None)
        if ann is not None:
            self._ann_ctx = ann(self._span.name)
            self._ann_ctx.__enter__()
        return self._span

    def __exit__(self, *exc):
        if self._ann_ctx is not None:
            self._ann_ctx.__exit__(*exc)
        self._span.t1 = time.perf_counter()
        _span_var.reset(self._token)
        self._tracer._add_span(self._span)
        return False


def span(name: str, /, **attrs: Any):
    """Open a span under the context's tracer; near-free no-op when tracing
    is off (one ContextVar read, shared null context manager).  ``name`` is
    positional-only so an attribute may also be called ``name``
    (``span("encode.dispatch", name="vx")``)."""
    t = _tracer_var.get()
    if t is None:
        return NULL_SPAN
    return _SpanCtx(t, name, attrs)


def event(name: str, /, **attrs: Any) -> None:
    """Record a typed point event on the current span (or as an orphan on
    the tracer when no span is open).  No-op when tracing is off."""
    t = _tracer_var.get()
    if t is None:
        return
    ev = SpanEvent(name=name, ts=time.perf_counter(), attrs=attrs)
    s = _span_var.get()
    if s is not None:
        s.events.append(ev)  # span is thread-confined while open
    else:
        t._add_orphan(ev)


def wrap_for_thread(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Bind ``fn`` to a copy of the *caller's* context, for use as a thread
    target: spans/events in the thread join the caller's trace, and
    ``ContextLocal`` stats mutations land in the caller's instances.  Each
    call copies the context once (a Context cannot be entered twice
    concurrently, so one copy per thread)."""
    ctx = contextvars.copy_context()

    def run(*args, **kw):
        return ctx.run(fn, *args, **kw)

    return run


# ------------------------------------------------------- context-local stats --

class ContextLocal:
    """A per-context instance of ``factory()`` with a process-global default.

    ``get()`` returns the instance installed for the current context (or the
    shared default when none is).  ``scope()`` installs a fresh (or given)
    instance for the dynamic extent of a ``with`` block — threads started
    via ``wrap_for_thread`` inside the block share the *same* instance, so
    counters from dispatch-ahead workers attribute to the scope that
    spawned them, while unrelated contexts never observe it."""

    def __init__(self, factory: Callable[[], Any]):
        self._factory = factory
        self._default = factory()
        self._var: "contextvars.ContextVar[Any]" = contextvars.ContextVar(
            f"repro_obs_ctxlocal_{id(self):x}", default=None)

    @property
    def default(self) -> Any:
        """The process-global fallback instance."""
        return self._default

    def get(self) -> Any:
        v = self._var.get()
        return self._default if v is None else v

    @contextlib.contextmanager
    def scope(self, value: Any = None) -> Iterator[Any]:
        v = self._factory() if value is None else value
        tok = self._var.set(v)
        try:
            yield v
        finally:
            self._var.reset(tok)
