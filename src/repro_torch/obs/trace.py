"""Structured span tracer — where a round or a request spent its time,
as a Perfetto-loadable trace (the port's own copy of
``repro/obs/trace.py``, same span API and names).

A span is a named, attributed wall-clock interval::

    from repro_torch.obs import trace

    with trace.span("serve.batch", batch_size=B, n_valid=n):
        ...

Spans nest (a per-thread stack records the parent), are thread-safe
(serving dispatch threads and the federation loop trace into one
buffer), and export to the Chrome trace event format, which Perfetto
(ui.perfetto.dev) and ``chrome://tracing`` load directly.  Host clock
only: a span around device work measures it only where the work ends in
a sync, as a served batch does.

**Disabled is free.**  The default tracer starts disabled and ``span()``
then returns one shared module-level no-op context manager — no object
allocation, no clock read, no lock.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional


class _NoopSpan:
    """The shared do-nothing span returned while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self


NOOP_SPAN = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_id", "_parent")

    def __init__(self, tracer: "Tracer", name: str, attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs

    def set(self, **attrs: Any) -> "_Span":
        """Attach attributes after the span opened (e.g. a result size)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        tr = self._tracer
        stack = tr._stack()
        self._parent = stack[-1] if stack else None
        self._id = tr._next_id()
        stack.append(self._id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.perf_counter()
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        tr._record(
            {
                "name": self.name,
                "ph": "X",
                "ts": round(self._t0 * 1e6, 3),
                "dur": round((t1 - self._t0) * 1e6, 3),
                "pid": os.getpid(),
                "tid": threading.get_ident(),
                "args": {
                    **self.attrs,
                    "span_id": self._id,
                    "parent_id": self._parent,
                },
            }
        )
        return False


class Tracer:
    """Span buffer + enable switch.  One process-wide default instance
    (``TRACER``) is what the module-level helpers drive; tests build
    their own."""

    def __init__(self):
        self.enabled = False
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = 0

    # -- spans --------------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, attrs)

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _next_id(self) -> int:
        with self._lock:
            self._ids += 1
            return self._ids

    def _record(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(event)

    # -- lifecycle ----------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events = []
            self._ids = 0

    # -- export -------------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace event JSON object Perfetto loads."""
        return {"traceEvents": self.events(), "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        from pathlib import Path

        Path(path).write_text(json.dumps(self.chrome_trace()))

    # -- host-side aggregation (the launchers' phase tables) -----------------
    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name aggregates: count, total/mean seconds."""
        out: Dict[str, Dict[str, float]] = {}
        for e in self.events():
            s = out.setdefault(e["name"], {"count": 0, "total_s": 0.0})
            s["count"] += 1
            s["total_s"] += e["dur"] / 1e6
        for s in out.values():
            s["mean_ms"] = s["total_s"] / s["count"] * 1e3
        return out

    def format_summary(self, title: str = "phase summary") -> str:
        """The human phase-time table fl_run/serve_fl print after a
        traced run — total/mean per span name, sorted by total."""
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        if not rows:
            return f"{title}: no spans recorded"
        wall = sum(s["total_s"] for n, s in rows if "." not in n) or sum(
            s["total_s"] for _, s in rows
        )
        lines = [
            f"{title}:",
            f"  {'span':<28} {'count':>7} {'total_s':>9} {'mean_ms':>9} {'%':>6}",
        ]
        for name, s in rows:
            pct = 100.0 * s["total_s"] / wall if wall else 0.0
            lines.append(
                f"  {name:<28} {s['count']:>7d} {s['total_s']:>9.3f} "
                f"{s['mean_ms']:>9.2f} {pct:>6.1f}"
            )
        return "\n".join(lines)


# -- the default process tracer ---------------------------------------------

TRACER = Tracer()


def span(name: str, **attrs: Any):
    """``with trace.span("round.fit", round=r): ...`` — no-op (shared
    singleton, zero allocation) while the default tracer is disabled."""
    if not TRACER.enabled:
        return NOOP_SPAN
    return _Span(TRACER, name, attrs)


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def export(path) -> None:
    TRACER.export(path)


def format_summary(title: str = "phase summary") -> str:
    return TRACER.format_summary(title)
