"""CompileWatcher — kernel-build accounting for the sweep engine.

The JAX package's watcher (``repro/obs/compile.py``) counts the XLA
programs its jitted forwards have built.  The PyTorch package compiles no
programs at run time but its CUDA kernel libraries: each ``csrc/*.cu`` is
built with ``nvcc`` (or found built under ``build/kernels/``) and loaded
on its first launch (:func:`repro_torch.kernels.build.load`).  Here a
*program* is such a library loaded into this process, so "did this query
build a new program?" means "did it load a kernel library for the first
time?".  On the CPU no library is ever loaded and every count is 0.

    w = CompileWatcher()
    with w.watch("warm-rerun") as rec:
        eng.run(q)
    assert rec.new_programs == 0          # warm path must not rebuild

``Engine.run`` itself calls :data:`WATCHER` ``.attribute(...)`` around
every device dispatch, stamping new loads with the query's backend / axes
/ envelope signature, bumping the ``sweep_compiles_total`` counter and
``sweep_compile_seconds`` histogram, and emitting a retrospective
``sweep.compile`` span — the reference's names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import threading
import time
from collections import deque
from typing import Optional

from . import metrics as _metrics
from . import trace as _trace

COMPILES = _metrics.counter(
    "sweep_compiles_total",
    "New kernel libraries built or loaded by sweep forward dispatches.",
    labels=("backend",))
COMPILE_SECONDS = _metrics.histogram(
    "sweep_compile_seconds",
    "Wall time of sweep dispatches that built or loaded kernel libraries.",
    labels=("backend",))

#: the kernel libraries each forward kind (``ExecPolicy.kind``) launches:
#: its level loop's, and for dense λ the walk's (``sparse_levels``)
_KIND_LIBRARIES = {"segment": ("sparse_levels",),
                   "congestion": ("sparse_levels",),
                   "sparse": ("sparse_levels",),
                   "sparse32": ("sparse_levels",),
                   "dense": ("dense_levels",)}


def _loaded() -> dict:
    """The kernel libraries this process has loaded (empty if the build
    module was never imported — watching costs nothing until it is)."""
    build = sys.modules.get("repro_torch.kernels.build")
    return {} if build is None else dict(build.LOADED)


def forward_cell(kind: str, want_lam: bool = False) -> tuple:
    """The kernel libraries one engine forward kind launches — the cells a
    watcher scoped to that forward counts (e.g. "did dense λ load the
    walk's library?")."""
    try:
        libs = _KIND_LIBRARIES[kind]
    except KeyError:
        raise ValueError(f"unknown forward kind {kind!r} "
                         f"(one of {sorted(_KIND_LIBRARIES)})") from None
    if kind == "dense" and want_lam:
        libs = libs + ("sparse_levels",)
    return libs


@dataclasses.dataclass
class CompileEvent:
    """One dispatch that loaded ≥1 new kernel library."""

    signature: dict
    new_programs: int
    wall_s: float


class WatchResult:
    """Mutable result handle yielded by :meth:`CompileWatcher.watch`."""

    __slots__ = ("label", "new_programs", "wall_s")

    def __init__(self, label: Optional[str]):
        self.label = label
        self.new_programs = 0
        self.wall_s = 0.0


class CompileWatcher:
    """Counts the kernel libraries loaded into this process and attributes
    growth to the dispatch that caused it.

    ``cells=None`` (the default, and what the global :data:`WATCHER`
    uses) watches every library; pass library names (see
    :func:`forward_cell`) to scope the count.
    """

    def __init__(self, cells: Optional[list] = None, max_events: int = 256):
        self._cells = None if cells is None else tuple(
            c for cell in cells
            for c in ((cell,) if isinstance(cell, str) else cell))
        self._events: deque = deque(maxlen=max_events)
        self._lock = threading.Lock()

    def programs(self) -> int:
        """Kernel libraries currently loaded across the watched cells."""
        loaded = _loaded()
        if self._cells is None:
            return len(loaded)
        return sum(1 for c in set(self._cells) if c in loaded)

    def snapshot(self) -> dict:
        """Per-library counts (0 or 1), keyed by library name."""
        loaded = _loaded()
        names = self._cells if self._cells is not None else tuple(loaded)
        return {n: int(n in loaded) for n in names}

    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def attribute(self, before: int, wall_s: float,
                  t0_ns: Optional[int] = None, **signature) -> int:
        """Compare the current program count against ``before``; if it
        grew, record a :class:`CompileEvent` carrying ``signature``, bump
        the compile metrics, and emit a ``sweep.compile`` trace span over
        the dispatch window.  Returns the number of new programs."""
        new = self.programs() - before
        if new <= 0:
            return 0
        with self._lock:
            self._events.append(CompileEvent(
                signature=dict(signature), new_programs=new,
                wall_s=float(wall_s)))
        backend = str(signature.get("backend", "unknown"))
        COMPILES.inc(new, backend=backend)
        COMPILE_SECONDS.observe(wall_s, backend=backend)
        if t0_ns is not None:
            _trace.TRACER.add_event(
                "sweep.compile", t0_ns, t0_ns + int(wall_s * 1e9),
                new_programs=new, **signature)
        return new

    @contextlib.contextmanager
    def watch(self, label: Optional[str] = None, **signature):
        """Measure a block: yields a :class:`WatchResult` whose
        ``new_programs`` / ``wall_s`` are filled in on exit.  Loads are
        attributed (events + metrics) just like engine-internal
        dispatches."""
        rec = WatchResult(label)
        before = self.programs()
        t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        try:
            yield rec
        finally:
            rec.wall_s = time.perf_counter() - t0
            sig = dict(signature)
            if label:
                sig.setdefault("label", label)
            sig.setdefault("backend", "unknown")
            rec.new_programs = self.attribute(
                before, rec.wall_s, t0_ns=t0_ns, **sig)


#: Process-global watcher over every kernel library — what ``Engine.run``
#: reports dispatches to.
WATCHER = CompileWatcher()
