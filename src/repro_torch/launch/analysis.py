"""Warm-plan analysis service: what-if latency queries over staged engines.

The LLAMP workflow an operator runs is interactive: "here are my candidate
collective algorithms / topologies / placements — how does each behave as
latency degrades, and which one should I deploy?"  This service keeps the
expensive artifacts warm — one :class:`~repro_torch.sweep.api.Engine` per
registered variant (its plan compiled and staged on the device), one
packed engine per shape bucket, and a shared
:class:`~repro_torch.sweep.cache.SweepCache` of results — so every query
after the first is a few kernel launches (or a cache hash).  The
counterpart of the JAX package's ``repro/launch/analysis.py``, field for
field, on the port's engine:

    svc = AnalysisService()                # device=None: the CUDA card
    svc.register(variant)                  # GraphVariant, or register_graph()
    svc.warm()                             # compile, stage, pack now
    resp = svc.handle(AnalysisRequest(kind="rank", deltas=[0, 50, 100]))
    resp.payload["ranking"]                # best-first [(name, objective)]

Query kinds: ``curve`` (T/λ/ρ over ΔL), ``bandwidth`` (T over γ·G),
``tolerance`` (p%-degradation ΔL budgets), ``rank`` (variant ordering over
a shared grid — one packed forward per shape bucket), ``placement``
(Algorithm-3 rank-mapping suggestion on a two-tier Φ), ``resilience``
(expected slowdown + p50/p95/p99 under a fault distribution, one batched
query; ``sensitivity.resilience_curve``), ``explore`` (design-space search
through one warm :class:`~repro_torch.explore.Stamper`), ``stats`` and
``metrics`` (the ``repro_torch.obs`` registry snapshot + cache stats).

Observability (``repro_torch.obs``): every request carries a trace id —
the client's ``trace`` field, or a fresh one — echoed on the response, and
every successful response carries ``timings``, a per-phase span breakdown
(``analysis.<kind>`` plus the engine's ``sweep.*`` spans).  The metrics
``analysis_requests_total`` and ``analysis_request_seconds`` count and time
the requests; ``--metrics HOST:PORT`` serves the Prometheus text at
``/metrics`` (JSON at ``/metrics.json``).

Execution policy rides each request as one ``policy`` block, parsed by
:meth:`~repro_torch.sweep.api.ExecPolicy.from_dict` (unknown keys rejected
by name); the top-level ``backend`` / ``shard`` fields overlay it::

    {"kind": "curve", "policy": {"backend": "dense", "lam": "fd"}}

Departures from the reference: the port's backend names ("dense" where the
reference says "pallas"; "pallas" is refused); ``device`` (the CUDA card
unless ``"cpu"`` is asked for) passed to every engine, placement,
resilience curve and stamper the service makes; and a variant whose graph
the engine compiled sparse-only (its dense envelope over the guard, the
engine's own warned switch) keeps that route: its queries run on the
sparse backend unless a request names one, and ``rank`` evaluates it with
one sparse forward beside the packed buckets of the rest (the reference
asks its segment backend of such a variant and fails).

CLI (a JSON-lines protocol): one-shot

    PYTHONPATH=src python -m repro_torch.launch.analysis --demo --query rank

a stdin/stdout serve loop (one request object a line, one response a line)

    PYTHONPATH=src python -m repro_torch.launch.analysis --demo --serve

or the same protocol on a TCP or UNIX-domain socket, every connection
against the one warm service:

    PYTHONPATH=src python -m repro_torch.launch.analysis --demo \\
        --serve-socket 127.0.0.1:0        # or a filesystem path (UNIX)

``--device cpu`` runs it all on the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import placement as placement_mod
from repro_torch.core.graph import ExecutionGraph
from repro_torch.core.loggps import LogGPS, resolve_class
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs import trace as _obs_trace
from repro_torch.sweep import (DEFAULT_CACHE, Engine, ExecPolicy,
                               GraphVariant, SweepCache, bandwidth_grid,
                               group_plans, latency_grid, tolerance_batched)

_REQUESTS = _obs_metrics.counter(
    "analysis_requests_total", "Analysis requests by kind and outcome.",
    labels=("kind", "ok"))
_REQUEST_SECONDS = _obs_metrics.histogram(
    "analysis_request_seconds", "Analysis request latency by kind.",
    labels=("kind",))


@dataclasses.dataclass
class AnalysisRequest:
    """One what-if query.  Unused fields are ignored by other kinds."""

    kind: str                                   # see module docstring
    variant: Optional[str] = None               # default: first registered
    cls: object = 0                             # latency class under study
                                                # (index, or a registered
                                                # class name like "dcn")
    deltas: Optional[Sequence[float]] = None    # ΔL grid (curve / rank)
    gscales: Optional[Sequence[float]] = None   # γ grid (bandwidth)
    degradations: Optional[Sequence[float]] = None  # p levels (tolerance)
    reduce: str = "mean"                        # rank objective: mean|max|final
    topo: Optional[dict] = None                 # placement Φ spec (two_tier kw)
    topk: int = 1                               # placement candidate width
    faults: Optional[Sequence[dict]] = None     # fault specs (resilience):
                                                # {"type": "straggler"|"link"
                                                #  |"device", ...field kwargs}
    weights: Optional[Sequence[float]] = None   # per-fault probabilities
                                                # (resilience; sum ≤ 1)
    space: Optional[str] = None                 # explore: preset name
    space_args: Optional[dict] = None           # explore: preset kwargs
                                                # (P, iters, pod, ...)
    searcher: Optional[str] = None              # explore: random|evolution
                                                # |halving
    generations: int = 4                        # explore: search generations
    population: int = 16                        # explore: candidates per gen
    seed: int = 0                               # explore: search rng seed
    budget: int = 50                            # explore: scenario-grid size
    objective: Optional[dict] = None            # explore: ObjectiveSpec wire
                                                # dict (default robust q95)
    policy: Optional[dict] = None               # ExecPolicy block (wire fields)
    backend: Optional[str] = None               # overlays policy
    shard: Optional[int] = None                 # overlays policy
    trace: Optional[str] = None                 # client trace id (echoed back;
                                                # stamped when absent)

    @staticmethod
    def from_json(line: str) -> "AnalysisRequest":
        d = json.loads(line)
        if not isinstance(d, dict):
            raise ValueError("a request is a JSON object, got "
                             f"{type(d).__name__}")
        known = {f.name for f in dataclasses.fields(AnalysisRequest)}
        bad = set(d) - known
        if bad:
            raise ValueError(f"unknown request fields: {sorted(bad)}")
        req = AnalysisRequest(**d)
        if req.policy is not None:
            # the nested block is checked at the protocol edge: a typo like
            # {"policy": {"bakend": ...}} comes back as a bad request naming
            # the field, never runs under the defaults
            if not isinstance(req.policy, dict):
                raise ValueError("policy must be an object of ExecPolicy "
                                 f"fields, got {type(req.policy).__name__}")
            ExecPolicy.from_dict(req.policy)
        return req

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


@dataclasses.dataclass
class AnalysisResponse:
    kind: str
    ok: bool
    payload: dict
    elapsed_ms: float
    error: Optional[str] = None
    trace: Optional[str] = None                 # request trace id (always set)
    #: per-phase span breakdown {name: {"ms", "n"}} — ``analysis.<kind>``
    #: plus the engine's ``sweep.*`` spans; None on pre-dispatch failures
    timings: Optional[dict] = None

    def to_json(self) -> str:
        return json.dumps(_jsonable(dataclasses.asdict(self)),
                          allow_nan=False)


def _jsonable(x):
    """A payload as strict JSON: numpy and torch values → builtins, and
    non-finite floats → the strings "inf" / "-inf" / "nan" (a bare
    ``Infinity`` token breaks strict consumers of the JSON-lines protocol,
    and an unbounded tolerance is a legitimate answer)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if isinstance(x, np.ndarray):
        x = x.tolist()
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        x = x.item()
    if isinstance(x, float) and not np.isfinite(x):
        return repr(x)                          # 'inf' / '-inf' / 'nan'
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    return x


def _reduce_T(T: np.ndarray, reduce: str) -> float:
    """Scalar makespan objective over a scenario-only T — the reduce
    vocabulary of :meth:`repro_torch.sweep.api.Result.rank`."""
    if reduce == "mean":
        return float(T.mean())
    if reduce == "max":
        return float(T.max())
    if reduce == "final":
        return float(T.ravel()[-1])
    raise ValueError(f"unknown reduce {reduce!r}")


class AnalysisService:
    """Registered variants + warm staged plans behind a query API.

    All engines are :class:`repro_torch.sweep.api.Engine` instances on
    ``device`` (None: the CUDA card) under one service-level
    :class:`~repro_torch.sweep.api.ExecPolicy` that names the service's
    result cache; a request's ``policy`` block overlays it field by field,
    once, at parse time.

    The cache, as the reference chooses it: ``cache`` when given; else the
    cache a ``policy`` names, unless that is the shared
    :data:`~repro_torch.sweep.cache.DEFAULT_CACHE`; else a private
    ``SweepCache(capacity=256)``.  (The port's engines name no cache by
    default, so the service opts in here.)
    """

    def __init__(self, backend: str = "segment",
                 cache: Optional[SweepCache] = None,
                 default_deltas: Sequence[float] = (0.0, 25.0, 50.0, 100.0),
                 policy: Optional[ExecPolicy] = None,
                 device: DeviceLike = None):
        if cache is None and policy is not None \
                and policy.cache is not None \
                and policy.cache is not DEFAULT_CACHE:
            # a policy carrying its own cache object is the caller's cache
            # choice (e.g. one cache shared by two services)
            cache = policy.cache
        self.cache = cache if cache is not None else SweepCache(capacity=256)
        self.policy = (policy if policy is not None
                       else ExecPolicy(backend=backend)).replace(
                           cache=self.cache)
        self.backend = self.policy.backend
        self.device = resolve_device(device)
        self.default_deltas = tuple(default_deltas)
        self._variants: dict = {}               # name → GraphVariant (ordered)
        self._engines: dict = {}                # name → Engine (single graph)
        self._groups: Optional[list] = None     # cached bucket index groups
        self._multi: dict = {}                  # group index → Engine (G axis)
        self._stamper = None                    # warm explore Stamper (lazy)

    # -- registration --------------------------------------------------------
    def register(self, variant: GraphVariant) -> str:
        if variant.name in self._variants:
            raise ValueError(f"variant {variant.name!r} already registered")
        self._variants[variant.name] = variant
        self._groups = None                     # packing is stale
        self._multi.clear()
        return variant.name

    def register_graph(self, name: str, graph: ExecutionGraph,
                       params: LogGPS, **meta) -> str:
        return self.register(GraphVariant(name=name, graph=graph,
                                          params=params, meta=dict(meta)))

    @property
    def variant_names(self) -> tuple:
        return tuple(self._variants)

    def _variant(self, name: Optional[str]) -> GraphVariant:
        if not self._variants:
            raise ValueError("no variants registered")
        if name is None:
            return next(iter(self._variants.values()))
        if name not in self._variants:
            raise ValueError(f"unknown variant {name!r} "
                             f"(have {list(self._variants)})")
        return self._variants[name]

    def _policy(self, req: AnalysisRequest,
                eng: Optional[Engine] = None) -> ExecPolicy:
        """One request's effective ExecPolicy: the service policy (on the
        sparse backend for ``eng`` when that engine compiled its graph
        sparse-only), overlaid by the request's ``policy`` block (unknown
        keys rejected), overlaid by the top-level ``backend`` / ``shard``
        fields."""
        pol = self.policy
        if eng is not None and self._sparse_only(eng):
            pol = pol.replace(backend="sparse")
        if req.policy is not None:
            pol = ExecPolicy.from_dict(req.policy, base=pol)
        if req.backend is not None:
            pol = pol.replace(backend=req.backend)
        if req.shard is not None:
            pol = pol.replace(shard=req.shard)
        return pol

    @staticmethod
    def _sparse_only(eng: Engine) -> bool:
        """Whether the engine compiled its graph to slot lists alone (the
        dense envelope over its guard), so no dense or segment view of it
        exists."""
        return eng.plan is None and eng.multi is None

    # -- warm plans ----------------------------------------------------------
    def engine(self, name: Optional[str] = None) -> Engine:
        """Per-variant warm engine (compiled and staged on first use, then
        kept)."""
        v = self._variant(name)
        eng = self._engines.get(v.name)
        if eng is None:
            eng = self._engines[v.name] = Engine(
                v.graph, params=v.params, policy=self.policy,
                device=self.device)
        return eng

    def _bucket_engines(self) -> list:
        """[(names, Engine)] — one packed graph-axis engine per shape
        bucket of the variants that have a compiled plan (a sparse-only
        variant is evaluated alone)."""
        if self.policy.backend == "sparse":
            # sparse plans are one graph a forward (no dense envelope to
            # share): rank traffic loops per-variant engines
            return []
        names = [n for n in self._variants
                 if not self._sparse_only(self.engine(n))]
        if self._groups is None:
            plans = [self.engine(n).plan for n in names]
            self._groups = group_plans(plans)
            self._multi = {}
            for gi, idx in enumerate(self._groups):
                self._multi[gi] = Engine(
                    [plans[i] for i in idx],
                    names=[names[i] for i in idx], policy=self.policy,
                    device=self.device)
        return [([names[i] for i in idx], self._multi[gi])
                for gi, idx in enumerate(self._groups)]

    def warm(self, jit: bool = True) -> dict:
        """Compile and stage every variant's plan and pack every bucket now
        (instead of on the first query).  With ``jit=True`` each engine —
        each variant's (curve/bandwidth/tolerance) and each bucket's (rank)
        — also runs a probe over the default ΔL grid, uncached, which loads
        the kernel libraries (the compile watcher counts them) and stages
        the views the queries read.  Returns packing stats."""
        t0 = time.perf_counter()
        buckets = self._bucket_engines()
        if jit:
            deltas = np.asarray(self.default_deltas, dtype=np.float64)
            for name, v in self._variants.items():
                self.engine(name).run(latency_grid(v.params, deltas),
                                      use_cache=False)
            for names, meng in buckets:
                batches = [latency_grid(self._variants[n].params, deltas)
                           for n in names]
                meng.run(batches, use_cache=False)
                # rank queries run values-only
                meng.run(batches, compute_lam=False, use_cache=False)
        return {"variants": len(self._variants), "buckets": len(buckets),
                "bucket_sizes": [len(ns) for ns, _ in buckets],
                "warm_s": time.perf_counter() - t0}

    # -- queries -------------------------------------------------------------
    def curve(self, req: AnalysisRequest) -> dict:
        """T/λ/ρ over a ΔL grid.  The request's policy block picks the
        route per query (backend, λ mode, device sharding)."""
        v = self._variant(req.variant)
        cls = resolve_class(v.params, req.cls)
        deltas = np.asarray(req.deltas if req.deltas is not None
                            else self.default_deltas, dtype=np.float64)
        eng = self.engine(v.name)
        res = eng.run(latency_grid(v.params, deltas, cls=cls),
                      policy=self._policy(req, eng))
        return {"variant": v.name, "cls": cls, "deltas": deltas,
                "backend": res.backend,
                "T": res.T, "lam": res.lam[:, cls],
                "rho": res.rho[:, cls], "from_cache": res.from_cache}

    def bandwidth(self, req: AnalysisRequest) -> dict:
        v = self._variant(req.variant)
        cls = resolve_class(v.params, req.cls)
        gs = np.asarray(req.gscales if req.gscales is not None
                        else (1.0, 2.0, 4.0), dtype=np.float64)
        eng = self.engine(v.name)
        # values only: the payload exposes T alone, so no walk
        res = eng.run(bandwidth_grid(v.params, gs, cls=cls), outputs=("T",),
                      policy=self._policy(req, eng))
        return {"variant": v.name, "cls": cls, "gscales": gs,
                "backend": res.backend,
                "T": res.T, "from_cache": res.from_cache}

    def tolerance(self, req: AnalysisRequest) -> dict:
        v = self._variant(req.variant)
        cls = resolve_class(v.params, req.cls)
        degr = tuple(req.degradations if req.degradations is not None
                     else (0.01, 0.02, 0.05))
        eng = self.engine(v.name)
        tol = tolerance_batched(eng, v.params, degr, cls=cls,
                                backend=self._policy(req, eng).backend)
        return {"variant": v.name, "cls": cls, "tolerance": tol}

    def rank(self, req: AnalysisRequest) -> dict:
        """Order every registered variant over a shared ΔL grid — one
        packed forward per shape bucket, not one per variant (a
        sparse-only variant: one sparse forward of its own).  Ranking needs
        only T, so every forward is values-only (no walk)."""
        if not self._variants:
            raise ValueError("no variants registered")
        deltas = np.asarray(req.deltas if req.deltas is not None
                            else self.default_deltas, dtype=np.float64)
        # resolved per variant — a class *name* may map to different
        # indexes across registries, but every variant must know it
        lacking = []
        for n, v in self._variants.items():
            try:
                resolve_class(v.params, req.cls)
            except (ValueError, KeyError):
                lacking.append(n)
        if lacking:
            raise ValueError(
                f"cls={req.cls!r} is unknown to variants {lacking} — "
                "a ranking must sweep every variant on the same class")
        scored: list = []
        calls = 0
        pol = self._policy(req)
        alone = list(self._variants)
        buckets = []
        if not (pol.backend == "sparse" or self.policy.backend == "sparse"):
            buckets = self._bucket_engines()
            packed = {n for names, _ in buckets for n in names}
            alone = [n for n in alone if n not in packed]
        for name in alone:
            # one slot-list forward a variant, same ranking contract
            v, eng = self._variants[name], self.engine(name)
            before = eng.calls
            res = eng.run(latency_grid(v.params, deltas, cls=req.cls),
                          outputs=("T",), policy=self._policy(req, eng))
            calls += eng.calls - before
            scored.append((name, _reduce_T(res.T, req.reduce)))
        for names, meng in buckets:
            batches = [latency_grid(self._variants[n].params, deltas,
                                    cls=req.cls)
                       for n in names]
            before = meng.calls
            # shard rides the packed graph axis by default
            res = meng.run(batches, outputs=("T",), policy=pol)
            calls += meng.calls - before
            scored.extend(res.rank(reduce=req.reduce))
        scored.sort(key=lambda kv: kv[1])
        return {"cls": req.cls, "deltas": deltas, "reduce": req.reduce,
                "ranking": scored, "best": scored[0][0],
                "compiled_calls": calls}

    def placement(self, req: AnalysisRequest) -> dict:
        """Algorithm-3 rank-mapping suggestion on a two-tier Φ.

        Placement's cost model requires the variant's graph to be built
        with zero link costs (``core.placement``: all network cost comes
        from Φ via the mapping) — a variant registered with real LogGPS
        link parameters would count every message twice, so that is
        refused rather than answered wrongly."""
        v = self._variant(req.variant)
        if np.any(np.asarray(v.params.L)) or np.any(np.asarray(v.params.G)):
            raise ValueError(
                f"variant {v.name!r} was registered with nonzero link "
                "params — placement queries need a zero-link-cost build "
                "(L=0, G=0; all network cost comes from the Φ topology; "
                "see core.placement)")
        spec = dict(req.topo or {})
        P = int(spec.pop("P", v.graph.nranks))
        pod = int(spec.pop("pod", max(P // 2, 1)))
        phi = placement_mod.ArchTopology.two_tier(P, pod, **spec)
        pts = (placement_mod.latency_points(v.params, req.deltas,
                                            cls=resolve_class(v.params,
                                                              req.cls))
               if req.deltas is not None else None)
        # one compiled plan, candidates patched in as cost lanes; the
        # service cache memoizes candidate evaluations (the patched costs
        # are in the keys), so a repeated question costs hash lookups
        stats: dict = {}
        pi, hist = placement_mod.place(v.graph, phi, params=v.params,
                                       scenarios=pts, topk=req.topk,
                                       policy=self._policy(req),
                                       stats=stats, device=self.device)
        return {"variant": v.name, "mapping": pi, "history": hist,
                "improvement": (1.0 - hist[-1] / hist[0]) if hist[0] else 0.0,
                "stats": stats}

    @staticmethod
    def _parse_faults(specs: Sequence[dict]) -> list:
        """Wire fault specs → fault dataclasses (checked at the protocol
        edge: an unknown type or field comes back as a bad request naming
        the spec, never a server traceback)."""
        from repro_torch.sweep import DeviceFault, LinkFault, StragglerFault
        kinds = {"straggler": StragglerFault, "link": LinkFault,
                 "device": DeviceFault}
        out = []
        for i, d in enumerate(specs):
            if not isinstance(d, dict):
                raise ValueError(f"fault[{i}] must be an object, "
                                 f"got {type(d).__name__}")
            d = dict(d)
            typ = d.pop("type", None)
            cls = kinds.get(typ)
            if cls is None:
                raise ValueError(f"fault[{i}]: type must be one of "
                                 f"{sorted(kinds)}, got {typ!r}")
            try:
                out.append(cls(**d))
            except TypeError as e:
                raise ValueError(f"fault[{i}] ({typ}): {e}") from None
        return out

    def resilience(self, req: AnalysisRequest) -> dict:
        """Expected slowdown under a fault distribution, as one batched
        query per variant: the request's ``faults`` (straggler / link /
        device specs) lower onto the engine's K/S/B axes and the whole
        distribution, intact baseline included, runs in one forward
        (``sensitivity.resilience_curve``).  ``weights`` are per-fault
        probabilities (sum ≤ 1; the shortfall is the no-fault mass)."""
        from repro_torch.core import sensitivity
        v = self._variant(req.variant)
        if not req.faults:
            raise ValueError(
                "resilience queries need a nonempty 'faults' list, e.g. "
                '[{"type": "straggler", "vertices": [5], "slowdown": 2}]')
        faults = self._parse_faults(req.faults)
        rep = sensitivity.resilience_curve(v.graph, v.params, faults,
                                           weights=req.weights,
                                           policy=self._policy(req),
                                           device=self.device)
        return {"variant": v.name, "T0": rep.T0,
                "faults": list(rep.names),
                "T_fault": rep.T_fault, "slowdown": rep.slowdown,
                "expected_slowdown": rep.expected_slowdown,
                "quantiles": rep.quantiles, "rank": rep.rank(),
                "axes": None if rep.result is None else list(rep.result.axes),
                "cells": rep.cells}

    def explore(self, req: AnalysisRequest) -> dict:
        """Design-space search over a ``repro_torch.explore`` preset.

        ``space`` names the preset (default ``"codesign"``),
        ``space_args`` parameterizes it (``P``, ``iters``, ``pod``, …),
        ``searcher``/``generations``/``population``/``seed`` drive the
        ask/tell loop, ``budget`` sizes the scenario grid (``deltas``,
        when given, bound its ΔL range) and ``objective`` is an
        :class:`~repro_torch.explore.ObjectiveSpec` wire dict.  The service
        keeps one warm :class:`~repro_torch.explore.Stamper` on its device
        and its cache, so a follow-up search over the same preset reuses
        its plans and staged engines and is served by the cache."""
        from repro_torch import explore as explore_mod
        from repro_torch.sweep import sample_grid
        kw = dict(req.space_args or {})
        P = int(kw.pop("P", 16))
        iters = int(kw.pop("iters", 3))
        params = kw.pop("params", None) or LogGPS()
        space, lower = explore_mod.preset(req.space or "codesign",
                                          P=P, iters=iters, params=params,
                                          **kw)
        objective = (explore_mod.ObjectiveSpec.from_dict(req.objective)
                     if req.objective else explore_mod.robust_makespan())
        lo, hi = ((min(req.deltas), max(req.deltas))
                  if req.deltas else (0.0, 100.0))
        scen = sample_grid(params, int(req.budget), rng=int(req.seed),
                           lat_deltas=(lo, hi))
        name = req.searcher or "random"
        skw = ({"population_size": max(2, int(req.population))}
               if name == "evolution" else {})
        searcher = explore_mod.make_searcher(name, space, int(req.seed),
                                             **skw)
        if self._stamper is None:
            self._stamper = explore_mod.Stamper(policy=self._policy(req),
                                                device=self.device)
        res = explore_mod.run_search(
            searcher, lower, scen, generations=int(req.generations),
            population=int(req.population), objective=objective,
            stamper=self._stamper)
        return {"space": req.space or "codesign", "searcher": searcher.name,
                "best": res.best, "best_objective": res.best_objective,
                "n_evaluated": res.n_evaluated,
                "generations": res.generations,
                "objective": objective.to_dict(),
                "history": [{"gen": h["gen"],
                             "best_objective": h["best_objective"],
                             "stamp": h["stamp"]} for h in res.history],
                "stamper": dict(self._stamper.stats)}

    def stats(self, req: AnalysisRequest) -> dict:
        return {"variants": list(self._variants),
                "warm_engines": list(self._engines),
                "buckets": None if self._groups is None else len(self._groups),
                "cache": self.cache.stats.snapshot(),
                "cache_entries": len(self.cache)}

    def metrics(self, req: AnalysisRequest) -> dict:
        """The process-global ``repro_torch.obs`` registry snapshot — every
        counter/gauge/histogram series (cache hit rates, request latency,
        kernel-library loads, envelope occupancy) in the shape the
        ``/metrics.json`` endpoint serves."""
        return {"metrics": _obs_metrics.snapshot(),
                "cache": self.cache.stats.snapshot(),
                "trace_enabled": _obs_trace.TRACER.enabled}

    _KINDS = {"curve": curve, "bandwidth": bandwidth, "tolerance": tolerance,
              "rank": rank, "placement": placement,
              "resilience": resilience, "explore": explore,
              "stats": stats, "metrics": metrics}

    def handle(self, req: AnalysisRequest) -> AnalysisResponse:
        """Dispatch one request; errors come back as ``ok=False`` responses
        (a malformed query must not take the serve loop down).

        Every response carries the request's trace id (``req.trace`` or a
        fresh one) and, on dispatch, a per-phase ``timings`` breakdown
        collected from this thread's spans, tracer enabled or not."""
        t0 = time.perf_counter()
        trace_id = req.trace or _obs_trace.new_trace_id()
        fn = self._KINDS.get(req.kind)
        if fn is None:
            _REQUESTS.inc(kind="?", ok="false")
            return AnalysisResponse(
                kind=req.kind, ok=False, payload={},
                elapsed_ms=0.0, trace=trace_id,
                error=f"unknown kind {req.kind!r} "
                      f"(have {sorted(self._KINDS)})")
        try:
            with _obs_trace.collect() as spans, \
                    _obs_trace.trace_context(trace_id), \
                    _obs_trace.span(f"analysis.{req.kind}"):
                payload = fn(self, req)
            elapsed = time.perf_counter() - t0
            _REQUESTS.inc(kind=req.kind, ok="true")
            _REQUEST_SECONDS.observe(elapsed, kind=req.kind)
            return AnalysisResponse(
                kind=req.kind, ok=True, payload=payload,
                elapsed_ms=elapsed * 1e3, trace=trace_id,
                timings=_obs_trace.summarize(spans))
        except Exception as e:  # noqa: BLE001 — the serve loop survives
            elapsed = time.perf_counter() - t0
            _REQUESTS.inc(kind=req.kind, ok="false")
            _REQUEST_SECONDS.observe(elapsed, kind=req.kind)
            return AnalysisResponse(
                kind=req.kind, ok=False, payload={},
                elapsed_ms=elapsed * 1e3, trace=trace_id,
                error=f"{type(e).__name__}: {e}")

    def handle_json(self, line: str) -> str:
        """One serve-loop turn: JSON request line → JSON response line."""
        try:
            req = AnalysisRequest.from_json(line)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return AnalysisResponse(kind="?", ok=False, payload={},
                                    elapsed_ms=0.0,
                                    error=f"bad request: {e}").to_json()
        return self.handle(req).to_json()


# -- socket transport ---------------------------------------------------------

def serve_socket(svc: AnalysisService, address: str, poll_s: float = 0.5,
                 ready=None):
    """Serve the JSON-lines protocol over a TCP or UNIX-domain socket.

    ``address``: ``"host:port"`` (TCP; port 0 picks a free one) or a
    filesystem path (UNIX socket).  Connections are handled on threads,
    but every request runs under one lock against the one warm service —
    all clients share the staged engines and the result cache, so a curve
    another client already asked for is a hash lookup.

    Prints ``[analysis] listening on <bound-address>`` to stderr once the
    socket is bound (with port 0 the chosen port is known only there) and
    calls ``ready(server)`` when given.  Runs until interrupted or until
    ``server.shutdown()``.
    """
    import os
    import socketserver
    import threading

    lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            for raw in self.rfile:
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    continue
                with lock:
                    out = svc.handle_json(line)
                self.wfile.write(out.encode("utf-8") + b"\n")
                self.wfile.flush()

    if ":" in address and "/" not in address:
        host, port = address.rsplit(":", 1)

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        srv = Server((host or "127.0.0.1", int(port)), Handler)
        bound = "%s:%d" % srv.server_address[:2]
    else:
        if not hasattr(socketserver, "ThreadingUnixStreamServer"):
            raise SystemExit("UNIX-domain sockets are not available on "
                             "this platform; use host:port")

        class Server(socketserver.ThreadingUnixStreamServer):  # type: ignore[name-defined]
            daemon_threads = True

        if os.path.exists(address):
            os.unlink(address)
        srv = Server(address, Handler)
        bound = address
    print(f"[analysis] listening on {bound}", file=sys.stderr, flush=True)
    if ready is not None:
        ready(srv)
    try:
        srv.serve_forever(poll_interval=poll_s)
    finally:
        srv.server_close()
    return srv


# -- metrics transport ---------------------------------------------------------

def serve_metrics(address: str):
    """Serve the ``repro_torch.obs`` metrics registry over HTTP on a daemon
    thread: ``GET /metrics`` (and ``/``) returns the Prometheus text
    exposition, ``GET /metrics.json`` the JSON snapshot.

    ``address`` is ``host:port`` (port 0 picks a free one).  Prints
    ``[analysis] metrics on http://<bound>/metrics`` to stderr once bound.
    Returns the server (its ``server_address`` carries the chosen port;
    ``shutdown()`` stops it); the thread dies with the process.
    """
    import http.server
    import threading

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path in ("/", "/metrics"):
                body = _obs_metrics.render().encode("utf-8")
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/metrics.json":
                body = json.dumps(_jsonable(_obs_metrics.snapshot())) \
                    .encode("utf-8")
                ctype = "application/json"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):            # scrapes are not log events
            pass

    host, port = address.rsplit(":", 1)
    srv = http.server.ThreadingHTTPServer(
        (host or "127.0.0.1", int(port)), Handler)
    srv.daemon_threads = True
    bound = "%s:%d" % srv.server_address[:2]
    t = threading.Thread(target=srv.serve_forever, daemon=True,
                         name="analysis-metrics")
    t.start()
    print(f"[analysis] metrics on http://{bound}/metrics",
          file=sys.stderr, flush=True)
    return srv


# -- CLI ----------------------------------------------------------------------

def _demo_service(backend: str, device: DeviceLike = None) -> AnalysisService:
    """A small self-contained study: four allreduce expansions of the same
    compute/collective chain (the Fig 10 axis at toy scale)."""
    from repro_torch.core import synth
    from repro_torch.core.loggps import cluster_params
    from repro_torch.sweep import collective_variants

    p = cluster_params(L_us=3.0, o_us=5.0)
    svc = AnalysisService(backend=backend, device=device)
    for v in collective_variants(
            lambda a: synth.allreduce_chain(8, 3, params=p, algo=a),
            ["ring", "bidir_ring", "recursive_doubling", "tree"], p):
        svc.register(v)
    return svc


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="what-if analysis over warm staged sweep plans")
    ap.add_argument("--demo", action="store_true",
                    help="register the built-in 4-variant collective study")
    ap.add_argument("--backend", default="segment",
                    choices=("segment", "dense", "sparse"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain "
                         "versions)")
    ap.add_argument("--serve", action="store_true",
                    help="JSON-lines request/response loop on stdin/stdout")
    ap.add_argument("--serve-socket", default=None, metavar="ADDR",
                    help="serve the JSON-lines protocol on a socket: "
                         "host:port (TCP, port 0 = pick free) or a "
                         "filesystem path (UNIX); connections share one "
                         "warm service + result cache")
    ap.add_argument("--metrics", default=None, metavar="HOST:PORT",
                    help="serve the repro_torch.obs metrics registry over "
                         "HTTP (Prometheus text at /metrics, JSON at "
                         "/metrics.json) on a daemon thread next to "
                         "either serve loop; port 0 picks a free one")
    ap.add_argument("--query", default=None,
                    help="one-shot query kind (curve/tolerance/rank/...)")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--cls", default=0,
                    type=lambda s: int(s) if s.lstrip("-").isdigit() else s,
                    help="latency class index or registered name (e.g. dcn)")
    ap.add_argument("--deltas", default=None,
                    help="ΔL grid as start:stop:num, e.g. 0:100:25")
    ap.add_argument("--shard", type=int, default=None,
                    help="split one-shot queries over this many local "
                         "devices (scenario axis for curve/bandwidth, "
                         "graph axis for rank)")
    args = ap.parse_args(argv)

    if not args.demo:
        raise SystemExit("no workload source: pass --demo (or embed "
                         "AnalysisService in your own driver)")
    svc = _demo_service(args.backend, args.device)
    t0 = time.perf_counter()
    info = svc.warm()
    print(f"[analysis] warmed {info['variants']} variants into "
          f"{info['buckets']} shape bucket(s) in "
          f"{time.perf_counter() - t0:.2f}s on {svc.device}",
          file=sys.stderr)

    if args.metrics:
        serve_metrics(args.metrics)

    if args.serve_socket:
        serve_socket(svc, args.serve_socket)
        return svc

    if args.serve:
        print("[analysis] serving; one JSON request per line "
              '(e.g. {"kind": "rank"})', file=sys.stderr)
        for line in sys.stdin:
            line = line.strip()
            if not line:
                continue
            print(svc.handle_json(line), flush=True)
        return svc

    deltas = None
    if args.deltas:
        lo, hi, num = args.deltas.split(":")
        deltas = np.linspace(float(lo), float(hi), int(num)).tolist()
    req = AnalysisRequest(kind=args.query or "rank", variant=args.variant,
                          cls=args.cls, deltas=deltas, shard=args.shard)
    resp = svc.handle(req)
    print(resp.to_json())
    return svc


if __name__ == "__main__":
    main()
