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

Fault distributions lower onto the engine's batch axes instead
(:func:`fault_axes`): a straggler rides the cost axis K, a link fault the
scenario axis S, a device fault the structure axis B (and K for its
recovery cost), so a whole distribution is one ``Query``.

The counterpart of the JAX package's ``repro/sweep/scenarios.py`` (numpy
only, copied); the deprecated ``sweep_variants`` shim is not ported.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
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

# -- resilience: fault & straggler degraded states ----------------------------
#
# Each fault family lowers onto exactly one engine batch axis, so an entire
# fault distribution runs as ONE batched Query (B variants × K cost
# candidates × S scenarios — one level-loop launch):
#
#   StragglerFault → K   (per-vertex compute slowdown as a patch_costs row)
#   LinkFault      → S   (per-class ΔL / γ·G as an extra ScenarioBatch row)
#   DeviceFault    → B   (patch_structure variant dropping the failed
#                         rank's message edges) + K (checkpoint-restart
#                         recovery cost on the makespan sinks)


@dataclasses.dataclass(frozen=True)
class StragglerFault:
    """A slow device: the named vertices' compute cost is multiplied by
    ``slowdown``.

    Rides the K (cost-candidate) axis: under max-plus, adding δ to every
    in-edge of v shifts value(v) — and everything downstream of it — by
    exactly δ, so the fault is the zero-recompile ``patch_costs`` row
    ``(slowdown−1)·vcost[v]`` scattered onto v's in-edges.  A vertex with
    no in-edges (a source) cannot be expressed this way and is dropped
    from the row with a warning.
    """

    vertices: tuple                    # vertex ids slowed down together
    slowdown: float                    # ≥ 1: compute-cost multiplier
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "vertices",
                           tuple(int(v) for v in np.atleast_1d(self.vertices)))
        if self.slowdown < 1.0:
            raise ValueError(
                f"straggler slowdown must be ≥ 1, got {self.slowdown}")


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """A degraded or flapping link class: +ΔL µs latency and γ× gap on one
    registered network class.  ``duty`` < 1 models flapping — the link is
    degraded that fraction of the time, so the *effective* inflation is
    duty-scaled (ΔL·duty; 1 + (γ−1)·duty).  Rides the S (scenario) axis.
    """

    cls: object                        # class index or registered name
    extra_L_us: float = 0.0
    gscale: float = 1.0
    duty: float = 1.0
    name: str = ""

    def __post_init__(self):
        if not 0.0 < self.duty <= 1.0:
            raise ValueError(f"duty must be in (0, 1], got {self.duty}")
        if self.gscale < 1.0:
            raise ValueError(f"link-fault gscale must be ≥ 1 (slower), "
                             f"got {self.gscale}")


@dataclasses.dataclass(frozen=True)
class DeviceFault:
    """A failed device: message edges incident to ``rank`` are dropped
    (communication with the device ceases for the outage — a
    ``patch_structure`` B variant), and the checkpoint-restart cost of
    bringing it back rides the K axis: ``recovery_us`` added to every
    in-edge of every makespan sink raises T by exactly ``recovery_us``
    (nonnegative costs ⇒ the makespan is attained at a sink).  Model
    ``recovery_us`` from checkpoint accounting via
    :func:`recovery_cost_us`.
    """

    rank: int
    recovery_us: float = 0.0
    name: str = ""

    def __post_init__(self):
        if self.recovery_us < 0.0:
            raise ValueError(
                f"recovery_us must be ≥ 0, got {self.recovery_us}")


def recovery_cost_us(step_us: float, restore_us: float = 0.0,
                     ckpt_every: Optional[int] = None,
                     lost_steps: Optional[float] = None) -> float:
    """Checkpoint-restart recovery cost: restore + lost-work replay (µs).

    ``lost_steps`` is the work discarded by restarting from the last
    committed checkpoint — ``crash_step − CheckpointManager.latest_step()``
    when the failure point is known.  When it isn't, ``ckpt_every`` gives
    the expectation ``(ckpt_every − 1)/2`` for a failure uniform in the
    checkpoint interval.  ``restore_us`` is the measured
    ``CheckpointManager.restore`` wall time.
    """
    if lost_steps is None:
        if ckpt_every is None:
            raise ValueError("recovery_cost_us needs lost_steps or "
                             "ckpt_every (to take the expectation)")
        if ckpt_every < 1:
            raise ValueError(f"ckpt_every must be ≥ 1, got {ckpt_every}")
        lost_steps = (ckpt_every - 1) / 2.0
    if lost_steps < 0:
        raise ValueError(f"lost_steps must be ≥ 0, got {lost_steps}")
    return float(restore_us) + float(lost_steps) * float(step_us)


@dataclasses.dataclass
class FaultAxes:
    """A fault list lowered onto the engine's batch axes (see
    :func:`fault_axes`).  ``structure``/``extras`` are ``None`` when no
    fault rides that axis; ``cells[i]`` is the (b, k, s) cell of fault i
    in the batched result (index 0 on every axis = the intact system)."""

    scenarios: ScenarioBatch
    extras: Optional[np.ndarray]       # [K, ne] patch_costs rows, row 0 = 0
    structure: object                  # StructureBatch (variant 0 intact), or None
    cells: list                        # per-fault (b, k, s)
    names: tuple                       # per-fault labels


def fault_axes(g: ExecutionGraph, params: LogGPS, faults: Sequence,
               plan=None) -> FaultAxes:
    """Lower a fault list onto the engine's B/K/S batch axes.

    Index 0 of every produced axis is the intact system (zero cost row,
    base scenario, unpatched structure), so cell (0, 0, 0) of the batched
    result is the plain forward — the bit-identity anchor — and each
    fault occupies exactly one off-baseline cell (``cells``).  ``plan``
    (a :class:`~repro_torch.sweep.compile.CompiledPlan` of ``g``) is required
    only when device faults are present; it is compiled on demand
    otherwise left untouched.
    """
    faults = list(faults)
    for f in faults:
        if not isinstance(f, (StragglerFault, LinkFault, DeviceFault)):
            raise TypeError(
                f"faults must be StragglerFault / LinkFault / DeviceFault, "
                f"got {type(f).__name__}")
    ne, nv, nc = g.num_edges, g.num_vertices, params.nclass

    # K axis: zero row + one row per straggler + deduped recovery costs
    k_rows: list = [np.zeros(ne)]
    # S axis: base row + one row per link fault
    rows_L = [np.asarray(params.L, dtype=np.float64)]
    rows_G = [np.ones(nc)]
    meta: list = [{"fault": None}]
    # B axis: intact variant + one per device fault
    keeps: list = []

    outdeg = np.bincount(g.esrc, minlength=nv)
    sink_edges = (outdeg == 0)[g.edst]
    recovery_k: dict = {}              # recovery cost → K row index
    cells, names = [], []
    for i, f in enumerate(faults):
        name = f.name or f"{type(f).__name__}[{i}]"
        b = k = s = 0
        if isinstance(f, StragglerFault):
            row = np.zeros(ne)
            for v in f.vertices:
                if not 0 <= v < nv:
                    raise ValueError(
                        f"straggler vertex {v} out of range for {nv}-vertex "
                        f"graph")
                mask = g.edst == v
                if not mask.any():
                    warnings.warn(
                        f"straggler vertex {v} has no in-edges (a source): "
                        "its slowdown cannot ride the cost axis and is "
                        "dropped from the fault row", stacklevel=2)
                    continue
                row[mask] += (f.slowdown - 1.0) * float(g.vcost[v])
            k = len(k_rows)
            k_rows.append(row)
        elif isinstance(f, LinkFault):
            c = resolve_class(params, f.cls)
            L = rows_L[0].copy()
            L[c] += f.extra_L_us * f.duty
            G = np.ones(nc)
            G[c] = 1.0 + (f.gscale - 1.0) * f.duty
            s = len(rows_L)
            rows_L.append(L)
            rows_G.append(G)
            meta.append({"fault": name, "cls": c})
        else:                          # DeviceFault
            drop = (g.ebytes > 0) & ((g.vrank[g.esrc] == f.rank)
                                     | (g.vrank[g.edst] == f.rank))
            if not drop.any():
                warnings.warn(
                    f"device fault on rank {f.rank}: no message edges touch "
                    "that rank — the structural variant equals the intact "
                    "graph", stacklevel=2)
            b = 1 + len(keeps)
            keeps.append(~drop)
            if f.recovery_us > 0.0:
                k = recovery_k.get(f.recovery_us, 0)
                if k == 0:
                    if not sink_edges.any():
                        warnings.warn(
                            "graph has no sink with in-edges: the recovery "
                            "cost cannot ride the cost axis and is dropped",
                            stacklevel=2)
                    else:
                        k = len(k_rows)
                        k_rows.append(np.where(sink_edges, f.recovery_us, 0.0))
                        recovery_k[f.recovery_us] = k
        cells.append((b, k, s))
        names.append(name)

    structure = None
    if keeps:
        if plan is None:
            from .compile import compile_plan
            plan = compile_plan(g, params)
        keep = np.vstack([np.ones(ne, dtype=bool)] + keeps)
        structure = plan.patch_structure(
            keep=keep,
            names=("intact",) + tuple(n for (b, _, _), n in zip(cells, names)
                                      if b > 0))
    extras = np.vstack(k_rows) if len(k_rows) > 1 else None
    scen = ScenarioBatch(L=np.vstack(rows_L), gscale=np.vstack(rows_G),
                         meta=meta)
    return FaultAxes(scenarios=scen, extras=extras, structure=structure,
                     cells=cells, names=tuple(names))


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
