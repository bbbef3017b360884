"""Chrome-trace (``chrome://tracing`` / Perfetto) export for ``obs.trace``.

``chrome_trace(tracer)`` renders a tracer's spans and events into the
Trace Event Format dict (``{"traceEvents": [...]}``); load the written JSON
in Perfetto (https://ui.perfetto.dev) or ``chrome://tracing``.

Track model: one process (pid 0, "repro").  Spans that carry a ``device``
attribute land on a ``device:<d>`` track — the sharded write path tags its
per-chunk dispatch/finish spans with the owning device ordinal, so a
2-device write renders as two device tracks and the round-boundary idle
gaps of ``ShardedRefactorPlan`` are directly visible as track whitespace.
Spans without a device land on a per-thread track named after the opening
thread (main / prefetch / serialize / feeder workers).

Point events (``host_sync``, ``dispatch``, ``backend_read``, ...) render as
instant events on their span's track, so every sync sits visually inside
the span that caused it.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from repro_torch.obs.trace import Span, SpanEvent, Tracer

PROCESS_NAME = "repro"


def _track_label(span: Optional[Span]) -> str:
    if span is None:
        return "events"
    dev = span.attrs.get("device")
    if dev is not None:
        return f"device:{dev}"
    return f"thread:{span.thread}"


def _jsonable(v: Any) -> Any:
    return v if isinstance(v, (bool, int, float, str, type(None))) else str(v)


def _args(attrs: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _jsonable(v) for k, v in attrs.items()}


def chrome_trace(tracer: Tracer) -> Dict[str, Any]:
    """Render ``tracer`` to a Trace Event Format dict."""
    tids: Dict[str, int] = {}

    def tid(label: str) -> int:
        if label not in tids:
            # device tracks get low tids so they sort to the top of the UI
            tids[label] = (len([t for t in tids if t.startswith("device:")])
                           if label.startswith("device:")
                           else 100 + len(tids))
        return tids[label]

    t0 = tracer.t_epoch
    events: List[Dict[str, Any]] = []
    for s in tracer.spans():
        label = _track_label(s)
        end = s.t1 if s.t1 is not None else s.t0
        events.append({
            "ph": "X", "name": s.name, "cat": "span",
            "pid": 0, "tid": tid(label),
            "ts": (s.t0 - t0) * 1e6, "dur": max(end - s.t0, 0.0) * 1e6,
            "args": _args({**s.attrs, "span_id": s.span_id,
                           "parent_id": s.parent_id, "thread": s.thread}),
        })
        for ev in s.events:
            events.append(_instant(ev, tid(label), t0, span_name=s.name))
    for ev in tracer.orphan_events():
        events.append(_instant(ev, tid("events"), t0, span_name=None))

    meta = [{"ph": "M", "name": "process_name", "pid": 0,
             "args": {"name": PROCESS_NAME}}]
    for label, t in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"ph": "M", "name": "thread_name", "pid": 0, "tid": t,
                     "args": {"name": label}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def _instant(ev: SpanEvent, tid: int, t0: float,
             span_name: Optional[str]) -> Dict[str, Any]:
    args = _args(ev.attrs)
    if span_name is not None:
        args["span"] = span_name
    return {"ph": "i", "name": ev.name, "cat": "event", "s": "t",
            "pid": 0, "tid": tid, "ts": (ev.ts - t0) * 1e6, "args": args}


def device_tracks(trace_json: Dict[str, Any]) -> List[str]:
    """Names of the per-device tracks in an exported trace (test/CI hook:
    a 2-device sharded write must show two distinct device tracks)."""
    return sorted({e["args"]["name"] for e in trace_json["traceEvents"]
                   if e.get("ph") == "M" and e.get("name") == "thread_name"
                   and str(e["args"].get("name", "")).startswith("device:")})


def event_count(trace_json: Dict[str, Any], name: str) -> int:
    """Count instant events named ``name`` in an exported trace."""
    return sum(1 for e in trace_json["traceEvents"]
               if e.get("ph") == "i" and e.get("name") == name)


def write_chrome_trace(path: str, tracer: Tracer) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer), f)
    return path
