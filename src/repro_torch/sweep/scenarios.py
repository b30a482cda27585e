"""Scenario grids: the parameter axes a sweep fans out over.

A :class:`ScenarioBatch` is the engine's unit of work — S rows of
(L per class, bandwidth scale γ per class).  Grid builders produce batches:

    latency_grid     — ΔL sweep on one class (Fig 9 / Algorithm 2 probes)
    bandwidth_grid   — γ sweep on one class (G_eff = γ·G_build)
    cartesian_grid   — cartesian product of per-class ΔL and γ axes
    sample_grid      — n seeded random (ΔL, γ) scenarios on one class

Graph-changing axes stamp one graph per variant instead:

    collective_variants — one graph per collective algorithm (Fig 10)
    topology_variants   — one wire-class graph per topology (Fig 11)

The counterpart of the JAX package's ``repro/sweep/scenarios.py`` (numpy
only, copied); the fault families and the deprecated ``sweep_variants``
shim are not ported yet.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import topology as topo_mod
from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.loggps import LogGPS, resolve_class
from repro_torch.core.rng import as_rng


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


def cartesian_grid(params: LogGPS,
                   lat_deltas: Optional[dict] = None,
                   gscales: Optional[dict] = None) -> ScenarioBatch:
    """Cartesian product of per-class ΔL axes × per-class γ axes.

    ``lat_deltas`` / ``gscales`` map class id (or registered class name,
    e.g. ``"dcn"``) → sequence of values; omitted classes stay at the base
    point.  E.g. a 2-class TPU sweep::

        cartesian_grid(p, lat_deltas={0: ici_dl, 1: dcn_dl}, gscales={1: gs})
    """
    nc = params.nclass
    axes, keys = [], []
    for kind, table in (("L", lat_deltas), ("G", gscales)):
        seen: dict = {}
        for c, vals in sorted((table or {}).items(),
                              key=lambda kv: resolve_class(params, kv[0])):
            idx = resolve_class(params, c)
            if idx in seen:
                # {1: [...], "dcn": [...]} on a model whose class 1 is
                # "dcn" would mint two axes writing the same column, the
                # later silently clobbering the earlier
                raise ValueError(
                    f"duplicate {'lat_deltas' if kind == 'L' else 'gscales'} "
                    f"axis: keys {seen[idx]!r} and {c!r} both resolve to "
                    f"class {idx} ({params.class_names[idx]!r})")
            seen[idx] = c
            axes.append(np.asarray(vals, dtype=np.float64))
            keys.append((kind, idx))
    if not axes:
        return base_batch(params)
    rows_L, rows_G, meta = [], [], []
    baseL = np.asarray(params.L, dtype=np.float64)
    for combo in itertools.product(*axes):
        L = baseL.copy()
        G = np.ones(nc)
        m = {}
        for (kind, c), v in zip(keys, combo):
            if kind == "L":
                L[c] = L[c] + v
                m[f"dL[{c}]"] = float(v)
            else:
                G[c] = v
                m[f"gscale[{c}]"] = float(v)
        rows_L.append(L)
        rows_G.append(G)
        meta.append(m)
    return ScenarioBatch(L=np.stack(rows_L), gscale=np.stack(rows_G), meta=meta)


def sample_grid(params: LogGPS, n: int, rng, *,
                lat_deltas: tuple = (0.0, 50.0),
                gscales: tuple = (1.0, 1.0), cls=0) -> ScenarioBatch:
    """``n`` randomly sampled scenarios on one class: ΔL uniform over
    ``lat_deltas`` and γ uniform over ``gscales`` (degenerate ranges pin
    the value).  Search drivers use this for robust objectives — the same
    seed reproduces the same grid bit-for-bit, so two identical searches
    share result-cache entries.

    ``rng`` is REQUIRED (an int seed or ``numpy.random.Generator``,
    normalized by :func:`repro_torch.core.rng.as_rng`); there is
    deliberately no default and no global-``np.random`` fallback.
    """
    rng = as_rng(rng)
    cls = resolve_class(params, cls)
    n = int(n)
    nc = params.nclass
    dl = rng.uniform(float(lat_deltas[0]), float(lat_deltas[1]), n)
    gs = rng.uniform(float(gscales[0]), float(gscales[1]), n)
    L = np.tile(np.asarray(params.L, dtype=np.float64), (n, 1))
    L[:, cls] = L[:, cls] + dl
    G = np.ones((n, nc))
    G[:, cls] = gs
    return ScenarioBatch(L=L, gscale=G,
                         meta=[{"cls": cls, "dL": float(d), "gscale": float(g)}
                               for d, g in zip(dl, gs)])


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


def topology_variants(factory: Callable[[topo_mod.Topology, LogGPS],
                                        ExecutionGraph],
                      topos: Sequence[topo_mod.Topology],
                      l_wire_us: float = 0.274,
                      d_switch_us: float = 0.108) -> list:
    """Stamp one wire-class graph per topology (the Fig 11 axis).

    ``factory(topo, params)`` builds the workload with messages expanded via
    :class:`repro_torch.core.topology.TopologyStamper` under ``params`` (whose
    latency classes are the topology's wire classes).
    """
    out = []
    for t in topos:
        p = topo_mod.topology_params(t, l_wire_us=l_wire_us,
                                     d_switch_us=d_switch_us)
        out.append(GraphVariant(name=t.name, graph=factory(t, p), params=p,
                                meta={"topology": t.name}))
    return out
