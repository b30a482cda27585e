"""Scenario grids: the parameter axes a sweep fans out over.

A :class:`ScenarioBatch` is the engine's unit of work — S rows of
(L per class, bandwidth scale γ per class).  Grid builders produce batches:

    latency_grid     — ΔL sweep on one class (Fig 9 / Algorithm 2 probes)
    bandwidth_grid   — γ sweep on one class (G_eff = γ·G_build)

Graph-changing axes stamp one graph per variant instead:

    collective_variants — one graph per collective algorithm (Fig 10)

The counterpart of the JAX package's ``repro/sweep/scenarios.py`` (numpy
only, copied); cartesian and sampled grids, topology variants and fault
families belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.loggps import LogGPS, resolve_class


@dataclasses.dataclass
class ScenarioBatch:
    """S scenarios: absolute per-class latencies and bandwidth scales."""

    L: np.ndarray                      # [S, nclass] float64, absolute µs
    gscale: np.ndarray                 # [S, nclass] float64, γ (1 = build G)
    meta: Optional[list] = None        # per-scenario dicts (labels, axes)

    def __post_init__(self):
        self.L = np.atleast_2d(np.asarray(self.L, dtype=np.float64))
        self.gscale = np.atleast_2d(np.asarray(self.gscale, dtype=np.float64))
        # real exceptions, not asserts: shape/NaN bugs must surface under
        # ``python -O`` too, and a single non-finite row would poison the
        # whole batched forward (max-reductions propagate NaN everywhere)
        if self.L.shape != self.gscale.shape:
            raise ValueError(
                f"scenario L and gscale shapes disagree: L is {self.L.shape}, "
                f"gscale is {self.gscale.shape}")
        bad = ~(np.isfinite(self.L).all(axis=1)
                & np.isfinite(self.gscale).all(axis=1))
        if bad.any():
            rows = np.nonzero(bad)[0]
            shown = rows[:8].tolist()
            more = "" if rows.size <= 8 else f" (+{rows.size - 8} more)"
            raise ValueError(
                f"non-finite scenario rows {shown}{more}: "
                f"L={self.L[rows[0]]}, gscale={self.gscale[rows[0]]} — "
                "NaN/inf would poison every vertex the batched forward "
                "touches")

    @property
    def S(self) -> int:
        return int(self.L.shape[0])

    @property
    def nclass(self) -> int:
        return int(self.L.shape[1])

    def concat(self, other: "ScenarioBatch") -> "ScenarioBatch":
        meta = None
        if self.meta is not None and other.meta is not None:
            meta = list(self.meta) + list(other.meta)
        return ScenarioBatch(L=np.concatenate([self.L, other.L]),
                             gscale=np.concatenate([self.gscale, other.gscale]),
                             meta=meta)


def base_batch(params: LogGPS) -> ScenarioBatch:
    nc = params.nclass
    return ScenarioBatch(L=np.asarray([params.L]), gscale=np.ones((1, nc)),
                         meta=[{"delta": 0.0}])


def latency_grid(params: LogGPS, deltas: Sequence[float], cls=0,
                 absolute: bool = False) -> ScenarioBatch:
    """One scenario per ΔL (or absolute L with ``absolute=True``) on ``cls``
    (a class index, or a registered class name like ``"dcn"``)."""
    cls = resolve_class(params, cls)
    d = np.asarray(deltas, dtype=np.float64).ravel()
    S, nc = d.shape[0], params.nclass
    L = np.tile(np.asarray(params.L, dtype=np.float64), (S, 1))
    L[:, cls] = d if absolute else L[:, cls] + d
    return ScenarioBatch(L=L, gscale=np.ones((S, nc)),
                         meta=[{"cls": cls, "L": float(x)} for x in L[:, cls]])


def bandwidth_grid(params: LogGPS, gscales: Sequence[float],
                   cls=0) -> ScenarioBatch:
    """One scenario per bandwidth scale γ on ``cls`` (an index or a
    registered class name; γ>1 = slower links)."""
    cls = resolve_class(params, cls)
    gs = np.asarray(gscales, dtype=np.float64).ravel()
    S, nc = gs.shape[0], params.nclass
    L = np.tile(np.asarray(params.L, dtype=np.float64), (S, 1))
    G = np.ones((S, nc))
    G[:, cls] = gs
    return ScenarioBatch(L=L, gscale=G,
                         meta=[{"cls": cls, "gscale": float(x)} for x in gs])



# -- graph-changing axes: stamped variants ------------------------------------

@dataclasses.dataclass
class GraphVariant:
    """A scenario axis that required rebuilding the graph itself."""

    name: str
    graph: ExecutionGraph
    params: LogGPS
    meta: dict = dataclasses.field(default_factory=dict)


def collective_variants(factory: Callable[[str], ExecutionGraph],
                        algos: Sequence[str], params: LogGPS) -> list:
    """Stamp one graph per collective algorithm (the Fig 10 axis).

    ``factory(algo)`` builds the workload with that allreduce/collective
    implementation, e.g. ``lambda a: synth.allreduce_chain(16, 8, algo=a)``.
    Pass ``[(v.graph, v.params) for v in variants]`` and
    ``names=[v.name for v in variants]`` to :class:`~.api.Engine` to run
    them packed.
    """
    return [GraphVariant(name=f"algo={a}", graph=factory(a), params=params,
                         meta={"algo": a}) for a in algos]
