"""Structured span tracer — where a round, a request or a model step spent
its time, as a Perfetto-loadable trace (the port's own copy of
``repro/obs/trace.py``, same span API and names), and the port's one
span API: ``torch.profiler.record_function`` is entered here and nowhere
else in ``repro_torch``.

A span is a named, attributed wall-clock interval::

    from repro_torch.obs import trace

    with trace.span("serve.batch", batch_size=B, n_valid=n):
        ...

Two recorders read spans.

* **The port's tracer** (``enable()``, the launchers' ``--trace``).  Spans
  nest (a per-thread stack records the parent), are thread-safe (serving
  dispatch threads and the federation loop trace into one buffer), and
  export to the Chrome trace event format, which Perfetto
  (ui.perfetto.dev) and ``chrome://tracing`` load directly.  Timestamps
  are on ``torch.profiler``'s clock, Unix-epoch nanoseconds
  (``time.time_ns``), so the launchers' JSON lines up with a device trace
  of the same run.  Host clock only: a span around device work measures
  it only where the work ends in a sync, as a served batch does.
* **``torch.profiler``.**  While a profiler records, a span also opens a
  ``record_function`` range of its name, so the kernels launched under it,
  and the idle gaps that begin inside it, are attributed to it on the
  profiler's own timeline.

While either records, ``open_spans()`` gives the names of the spans open
on this thread (the MoE counters read their phase from it), and
``recording()`` is true: counters that cost device work count only then.

**Off is free.**  With neither recorder on, ``span()`` returns one shared
module-level no-op context manager after one read of a flag and one of
``torch._C._autograd._profiler_enabled()``: no object allocation, no
clock read, no lock, no ``record_function``.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Tuple

import torch
from torch.autograd.profiler import record_function

_profiler_enabled = torch._C._autograd._profiler_enabled
_OPEN = threading.local()  # .names: the spans open on this thread while a recorder is on


def _open_names() -> list:
    names = getattr(_OPEN, "names", None)
    if names is None:
        names = _OPEN.names = []
    return names


def open_spans() -> Tuple[str, ...]:
    """The names of the spans open on this thread, outermost first (only
    spans opened while a recorder was on)."""
    return tuple(_open_names())


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


class _Range:
    """A span while only ``torch.profiler`` records: its ``record_function``
    range, nothing else."""

    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name

    def set(self, **attrs: Any) -> "_Range":
        return self

    def __enter__(self) -> "_Range":
        self._rf = record_function(self.name).__enter__()
        _open_names().append(self.name)
        return self

    def __exit__(self, *exc: Any) -> bool:
        _open_names().pop()
        self._rf.__exit__(*exc)
        return False


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_t0", "_id", "_parent", "_rf")

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
        _open_names().append(self.name)
        self._t0 = time.time_ns()  # before the range opens: a first range's set-up is not on the profiler's clock
        self._rf = record_function(self.name).__enter__() if _profiler_enabled() else None
        return self

    def __exit__(self, *exc: Any) -> bool:
        t1 = time.time_ns()
        _open_names().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        tr = self._tracer
        stack = tr._stack()
        if stack and stack[-1] == self._id:
            stack.pop()
        ts = self._t0 / 1000  # µs; ts + dur is t1 / 1000 exactly, so a child ends inside its parent
        tr._record(
            {
                "name": self.name,
                "ph": "X",
                "ts": ts,
                "dur": t1 / 1000 - ts,
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
        if self.enabled:
            return _Span(self, name, attrs)
        if _profiler_enabled():
            return _Range(name)
        return NOOP_SPAN

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
    singleton, zero allocation) while neither the default tracer nor
    ``torch.profiler`` records; a ``record_function`` range alone while
    only the profiler does."""
    if TRACER.enabled:
        return _Span(TRACER, name, attrs)
    if _profiler_enabled():
        return _Range(name)
    return NOOP_SPAN


def recording() -> bool:
    """Whether the default tracer or ``torch.profiler`` records."""
    return TRACER.enabled or _profiler_enabled()


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
