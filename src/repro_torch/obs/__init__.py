"""repro_torch.obs — observability for the sweep engine.

The counterpart of the JAX package's ``repro/obs``, three pieces:

* :mod:`repro_torch.obs.trace` — span tracer (monotonic clocks,
  thread-local nesting, per-request ``collect()`` sinks) with
  Chrome-trace/Perfetto JSON export.  Disabled by default; disabled spans
  are a shared no-op object.
* :mod:`repro_torch.obs.metrics` — process-global registry of counters /
  gauges / histograms with a Prometheus text renderer and a JSON
  snapshot.  Always on (per-query increments only).
* :mod:`repro_torch.obs.compile` — :class:`CompileWatcher`, which counts
  the CUDA kernel libraries the package builds and loads at first use
  (the reference counts XLA programs).

Typical use::

    from repro_torch import obs

    obs.enable()                       # global span buffer on
    eng.run(query)                     # sweep.* spans recorded
    obs.TRACER.export("trace.json")    # open in https://ui.perfetto.dev

    with obs.collect() as spans:       # per-request capture, tracer off
        eng.run(query)
    obs.trace.summarize(spans)         # {name: {"ms": ..., "n": ...}}

    print(obs.metrics.render())        # Prometheus text exposition
"""

from . import metrics, trace  # noqa: F401
from .compile import WATCHER, CompileEvent, CompileWatcher, forward_cell  # noqa: F401
from .metrics import REGISTRY  # noqa: F401
from .trace import (TRACER, SpanEvent, collect, disable, enable,  # noqa: F401
                    enabled, new_trace_id, span, trace_context)
