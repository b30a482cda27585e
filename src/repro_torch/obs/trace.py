"""Lightweight span tracing: monotonic clocks, thread-local span stacks,
Chrome-trace/Perfetto export.

LLAMP's pitch is *measurement without hardware*; this module is the same
idea turned inward — the serving stack's own phases (canonicalize, cache
lookup, compile, device execute, λ backtrace) become first-class measured
quantities instead of ad-hoc ``perf_counter`` pairs scattered through
an analysis service.  A copy of the JAX package's
``repro/obs/trace.py`` (standard library only): the same span names and
the same Chrome-trace export.

Design constraints, in order:

1. **Zero overhead when disabled.**  ``span()`` on a disabled tracer
   returns a shared no-op context manager — no allocation beyond the
   kwargs dict, no clock read, no lock.  Instrumentation can therefore
   live permanently on the hot path (``sweep/api.py``'s ``Engine.run``).
2. **Cheap when enabled.**  A span is two ``perf_counter_ns`` reads and
   one deque append under a lock; nesting comes from a thread-local name
   stack (events record their parent), not from object graphs.
3. **Exportable.**  ``to_chrome_trace()`` / ``export(path)`` emit the
   Chrome trace-event JSON that Perfetto (https://ui.perfetto.dev) and
   ``chrome://tracing`` load directly — attach the file to a bug report
   and the reader sees the exact phase breakdown you saw.

Two recording scopes compose:

* the **global buffer** (``enable()`` / ``disable()``), a bounded deque of
  the most recent events across all threads — what ``export()`` writes;
* **thread-local collection** (``collect()``), which records the spans of
  one request on one thread into a private list even while the global
  tracer is disabled — how an analysis service builds each response's
  per-phase ``timings`` without turning tracing on process-wide.

Trace ids (``trace_context()``) stamp every span finished on the thread
with a request-scoped id, so one Perfetto file of a busy service still
separates interleaved requests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional


def new_trace_id() -> str:
    """A fresh request-scoped trace id (short uuid4 hex)."""
    return uuid.uuid4().hex[:16]


@dataclasses.dataclass
class SpanEvent:
    """One finished span.  Times are ``perf_counter_ns`` stamps — a shared
    monotonic clock, so events from different threads order correctly
    within one process (and mean nothing across processes)."""

    name: str
    t0_ns: int
    t1_ns: int
    tid: int
    parent: Optional[str] = None
    trace: Optional[str] = None
    args: Optional[dict] = None

    @property
    def dur_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class _NoopSpan:
    """The disabled-tracer span: context manager with empty methods."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_tracer", "name", "args", "t0_ns")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        tls = self._tracer._tls
        stack = getattr(tls, "stack", None)
        if stack is None:
            stack = tls.stack = []
        stack.append(self.name)
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._tracer
        stack = tr._tls.stack
        stack.pop()
        tr._record(SpanEvent(
            name=self.name, t0_ns=self.t0_ns, t1_ns=t1,
            tid=threading.get_ident(),
            parent=stack[-1] if stack else None,
            trace=getattr(tr._tls, "trace", None),
            args=self.args or None))
        return False


class Tracer:
    """Span recorder with a bounded global buffer + thread-local sinks."""

    def __init__(self, max_events: int = 65536):
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._enabled = False

    # -- enablement ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    # -- recording -----------------------------------------------------------
    def span(self, name: str, **args):
        """Context manager timing one phase.  No-op unless the global
        buffer is enabled or this thread is inside :meth:`collect`."""
        if not self._enabled and getattr(self._tls, "sinks", None) is None:
            return _NOOP
        return _Span(self, name, args)

    def add_event(self, name: str, t0_ns: int, t1_ns: int, **args) -> None:
        """Record a span retrospectively from explicit clock stamps — for
        phases detected only after the fact (e.g. a kernel build attributed
        to a dispatch once the program count is seen to have grown)."""
        if not self._enabled and getattr(self._tls, "sinks", None) is None:
            return
        self._record(SpanEvent(
            name=name, t0_ns=int(t0_ns), t1_ns=int(t1_ns),
            tid=threading.get_ident(),
            trace=getattr(self._tls, "trace", None), args=args or None))

    def _record(self, ev: SpanEvent) -> None:
        if self._enabled:
            with self._lock:
                self._events.append(ev)
        sinks = getattr(self._tls, "sinks", None)
        if sinks:
            for sink in sinks:
                sink.append(ev)

    # -- scopes --------------------------------------------------------------
    @contextlib.contextmanager
    def collect(self):
        """Collect this thread's spans into a private list, independent of
        the global buffer — spans fire inside this scope even when the
        tracer is disabled (the per-request ``timings`` mechanism)."""
        spans: list = []
        sinks = getattr(self._tls, "sinks", None)
        if sinks is None:
            sinks = self._tls.sinks = []
        sinks.append(spans)
        try:
            yield spans
        finally:
            sinks.remove(spans)
            if not sinks:
                self._tls.sinks = None

    @contextlib.contextmanager
    def trace_context(self, trace_id: Optional[str] = None):
        """Stamp every span finished on this thread with ``trace_id``
        (generated when None).  Yields the id."""
        tid = trace_id if trace_id else new_trace_id()
        prev = getattr(self._tls, "trace", None)
        self._tls.trace = tid
        try:
            yield tid
        finally:
            self._tls.trace = prev

    def current_trace(self) -> Optional[str]:
        return getattr(self._tls, "trace", None)

    # -- export --------------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def to_chrome_trace(self, events: Optional[list] = None) -> dict:
        """Chrome trace-event JSON (``ph: "X"`` complete events, µs
        timestamps) — loads directly in Perfetto / chrome://tracing."""
        evs = self.events() if events is None else events
        pid = os.getpid()
        out = []
        for e in evs:
            rec = {"name": e.name, "cat": "repro", "ph": "X",
                   "ts": e.t0_ns / 1e3, "dur": (e.t1_ns - e.t0_ns) / 1e3,
                   "pid": pid, "tid": e.tid}
            args = dict(e.args) if e.args else {}
            if e.trace:
                args["trace"] = e.trace
            if e.parent:
                args["parent"] = e.parent
            if args:
                rec["args"] = args
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str, events: Optional[list] = None) -> str:
        """Write the Chrome/Perfetto trace JSON to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(events), f, default=str)
        return path


def summarize(events: list) -> dict:
    """Aggregate a span list to ``{name: {"ms": total, "n": count}}`` — the
    per-phase breakdown shape ``AnalysisResponse.timings`` carries.  Nested
    spans each report their own wall time (a parent includes its
    children), so rows are a breakdown by phase *name*, not a partition."""
    out: dict = {}
    for e in events:
        row = out.setdefault(e.name, {"ms": 0.0, "n": 0})
        row["ms"] += e.dur_ms
        row["n"] += 1
    for row in out.values():
        row["ms"] = round(row["ms"], 3)
    return out


#: Process-global tracer: library instrumentation records here.
TRACER = Tracer()


def span(name: str, **args):
    return TRACER.span(name, **args)


def enable() -> None:
    TRACER.enable()


def disable() -> None:
    TRACER.disable()


def enabled() -> bool:
    return TRACER.enabled


def collect():
    return TRACER.collect()


def trace_context(trace_id: Optional[str] = None):
    return TRACER.trace_context(trace_id)


def export(path: str) -> str:
    return TRACER.export(path)
