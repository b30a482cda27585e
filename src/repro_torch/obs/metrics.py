"""Process-global metrics registry: counters, gauges, histograms.

The sweep engine and analysis service report operational state here —
cache hit/miss/eviction counts, per-kind request latency histograms,
CUDA kernel-library builds, envelope occupancy.  A copy of the JAX
package's ``repro/obs/metrics.py`` (standard library only): the same
registry, metric names and exports.  Two render paths:

* :meth:`Registry.render` — Prometheus text exposition (version 0.0.4),
  what an analysis service's ``--metrics HOST:PORT`` serves at ``/metrics``;
* :meth:`Registry.snapshot` — a plain-dict JSON form, what the service's
  ``metrics`` query kind returns and ``bench_sweep --metrics-json`` dumps.

Metrics are always on: an increment is a dict update under a per-metric
lock, cheap enough for once-per-query call sites (never per graph edge).
Create metrics at module import via the get-or-create helpers — two call
sites naming the same metric share one series table:

    from repro_torch.obs import metrics
    HITS = metrics.counter("sweep_cache_hits_total",
                           "Sweep cache hits.", labels=("patched",))
    HITS.inc(patched="false")

Label values are stringified; a metric's label *names* are fixed at
creation and every observation must supply exactly that set.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, Optional, Tuple


class _Metric:
    """Shared plumbing: one series table keyed by label-value tuples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()

    def _key(self, kv: dict) -> Tuple[str, ...]:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} expects labels {self.labelnames}, "
                f"got {tuple(sorted(kv))}")
        return tuple(str(kv[k]) for k in self.labelnames)

    def _label_dict(self, key: Tuple[str, ...]) -> dict:
        return dict(zip(self.labelnames, key))

    @staticmethod
    def _fmt_labels(labelnames, key, extra: str = "") -> str:
        parts = [f'{n}="{v}"' for n, v in zip(labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    def _render(self, lines: list) -> None:
        for key in sorted(self._series):
            lines.append(f"{self.name}"
                         f"{self._fmt_labels(self.labelnames, key)}"
                         f" {_num(self._series[key])}")

    def _snapshot(self) -> list:
        return [{"labels": self._label_dict(k), "value": v}
                for k, v in sorted(self._series.items())]


class Gauge(_Metric):
    """Instantaneous value, settable up or down."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = float(v)

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return float(self._series.get(self._key(labels), 0.0))

    _render = Counter._render
    _snapshot = Counter._snapshot


#: Default latency buckets (seconds): 0.5 ms … 10 s, roughly log-spaced —
#: spans a warm cache hit through a cold kernel build.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        v = float(v)
        with self._lock:
            row = self._series.get(key)
            if row is None:
                row = self._series[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0, "count": 0}
            i = bisect.bisect_left(self.buckets, v)
            if i < len(self.buckets):
                row["counts"][i] += 1
            row["sum"] += v
            row["count"] += 1

    def _render(self, lines: list) -> None:
        for key in sorted(self._series):
            row = self._series[key]
            cum = 0
            for b, c in zip(self.buckets, row["counts"]):
                cum += c
                le = 'le="%s"' % _num(b)
                lines.append(
                    f"{self.name}_bucket"
                    f"{self._fmt_labels(self.labelnames, key, le)} {cum}")
            inf = self._fmt_labels(self.labelnames, key, 'le="+Inf"')
            lines.append(f"{self.name}_bucket{inf} {row['count']}")
            lbl = self._fmt_labels(self.labelnames, key)
            lines.append(f"{self.name}_sum{lbl} {_num(row['sum'])}")
            lines.append(f"{self.name}_count{lbl} {row['count']}")

    def _snapshot(self) -> list:
        out = []
        for key in sorted(self._series):
            row = self._series[key]
            out.append({"labels": self._label_dict(key),
                        "sum": row["sum"], "count": row["count"],
                        "buckets": dict(zip((_num(b) for b in self.buckets),
                                            row["counts"]))})
        return out


def _num(v: float) -> str:
    """Render 3.0 as "3" but keep real fractions — Prometheus accepts
    both; the short form keeps the exposition and tests readable."""
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


class Registry:
    """Name → metric table with get-or-create semantics."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, **kw)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: list = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            m._render(lines)
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-safe dict of every metric's series."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: {"type": m.kind, "help": m.help,
                       "series": m._snapshot()}
                for name, m in metrics}

    def reset(self) -> None:
        """Drop all series (metric objects survive) — test isolation."""
        with self._lock:
            for m in self._metrics.values():
                with m._lock:
                    m._series.clear()


#: Process-global registry: library metrics register here.
REGISTRY = Registry()


def counter(name: str, help: str = "", labels: Iterable[str] = ()) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Iterable[str] = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labels)


def histogram(name: str, help: str = "", labels: Iterable[str] = (),
              buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labels, buckets)


def render() -> str:
    return REGISTRY.render()


def snapshot() -> dict:
    return REGISTRY.snapshot()
