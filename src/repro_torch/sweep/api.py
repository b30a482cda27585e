"""The PyTorch package's sweep API: :class:`ExecPolicy`, :class:`Query`,
:class:`Engine`, :class:`Result`.

A reduced counterpart of the JAX package's ``repro/sweep/api.py``.  One
engine binds one graph (or compiled plan), G graphs packed into one
:class:`~repro_torch.sweep.compile.MultiPlan`, or a
:class:`~repro_torch.sweep.compile.StructureBatch` of B structural
variants, stages the plan's tensors on its device once, and evaluates
queries through the segment forward (float64, the default, as in the
reference), the dense forward (float32 kernels), their packed twins, or
the sparse slot-list forwards of :mod:`.engine`:

    >>> eng = Engine(graph, params=p)                  # on the CUDA card
    >>> res = eng.run(scenarios=latency_grid(p, deltas))
    >>> res.T, res.lam, res.rho                        # [S], [S, nc], [S, nc]

    >>> eng = Engine([(g1, p), (g2, p)], names=["ring", "tree"])
    >>> res = eng.run(latency_grid(p, deltas))         # axes ("G", "S")
    >>> res.rank(), res["ring"].T

    >>> res = eng1.run(Query(batch, costs=extras))     # [K, ne]: ("K", "S")
    >>> res.argbest()                                  # the best candidate
    >>> sb = plan.patch_structure(keep=keeps)          # B edge removals
    >>> res = Engine(plan).run(Query(batch, structure=sb, costs=extras))
    >>> res.axes                                       # ("B", "K", "S")

A graph whose padded dense envelope exceeds the dense-size guard is
compiled to compact slot lists instead (with a warning), as the
reference's engine does.

The axes, in the reference's canonical [G|B, K, S] order: scenarios S on
all three backends; the graph axis G, the candidate-cost axis K
(:class:`~repro_torch.sweep.compile.CostBatch`, or raw [K, ne] extra edge
costs the engine patches) and the structure-variant axis B on the dense
and segment backends, G×K×S and B×K×S included, G and B never together.
Every (G or B, K) pair is a lane of one forward: one level-loop launch
and one walk, whatever G, B and K are.  ``ExecPolicy()`` defaults to
segment float64, as the reference's does, so a call with no policy gives
the scalar engine's answers bit for bit.

Also as in the reference: finite-difference λ (``ExecPolicy(lam="fd")``,
one values forward over an (nc+1)× scenario grid, on every backend), the
congestion fixed point (``congestion="fixed_point"``, segment, over the S
and K axes: :func:`~repro_torch.sweep.engine.congestion_forward`), the
result cache (``ExecPolicy(cache=SweepCache())``; a hit launches nothing
and returns a copy), per-call overrides (``run(backend=, policy=,
use_cache=)``) and the detached engine (``Query(graphs=, params=)`` and
the module-level :func:`run`, engines memoized by content).  One
departure: a policy's ``cache`` defaults to None, not the shared
:data:`~repro_torch.sweep.cache.DEFAULT_CACHE`, so a repeated query runs
again unless a cache is named (the port's callers count the forwards they
run).

    >>> pol = ExecPolicy(congestion="fixed_point", max_iters=32, tol=1e-9)
    >>> res = Engine(graph, params=p, policy=pol).run(batch)
    >>> res.T, res.congestion_iters                    # [S], [S] int32
    >>> res = run(Query(batch, graphs=graph, params=p))  # a memoized engine

Instrumented as the reference's (:mod:`repro_torch.obs`): the spans
``sweep.canonicalize``, ``sweep.cost_patch``, ``sweep.cache_lookup``,
``sweep.stage``, ``sweep.execute``, ``sweep.congestion_fixed_point`` and
``sweep.lam_backtrace``; the metrics ``sweep_queries_total``,
``sweep_envelope_occupancy``, ``sweep_dense_bytes`` and
``sweep_congestion_iters``; every dispatch reported to the compile
watcher, which counts the kernel libraries loaded.  Tracing changes no
result bit.

Sharding (``ExecPolicy(shard=, shard_axis=)``, or per call
``run(shard=, shard_axis=, shard_devices=)``) cuts one populated axis —
S, G or K — into equal contiguous chunks, one forward a device
(:func:`~repro_torch.sweep.engine.split_forward`), bit-identical to the
unsplit forward; on one card ``shard=True`` resolves to that card alone.

    >>> res = eng.run(batch, shard_devices=["cuda:0", "cuda:0"],
    ...               shard_axis="S")                  # two chunks, one card

Not ported yet: a ``CostBatch`` that varies ``egap``, ``egclass`` or
``elat`` (refused: the K lanes share their structure's records but the
constants).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import os
import threading
import time
import warnings
from collections import OrderedDict
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.device import DeviceLike, device_name, resolve_device
from repro_torch.obs import metrics as _obs_metrics
from repro_torch.obs.compile import WATCHER as _WATCHER
from repro_torch.obs.trace import span as _span

from . import engine as _eng
from .cache import (SweepCache, array_hash, canonical_bytes,
                    graph_content_key, query_key)
from .compile import (STRUCT_FIELDS, CompiledPlan, CostBatch, MultiPlan,
                      SparsePlan, StructureBatch, _bucket, compile_plan,
                      compile_sparse, estimate_dense_bytes, pack_plans)
from .scenarios import ScenarioBatch

#: ExecPolicy fields that may arrive over the wire (the JSON ``policy``
#: blocks of ``launch.analysis`` requests; reference ``api.py:72-74``).
#: ``cache`` is left out: a result cache is a process-local object.
POLICY_WIRE_FIELDS = ("backend", "shard", "shard_axis", "lam", "fd_eps",
                      "dtype", "congestion", "max_iters", "tol",
                      "max_dense_bytes")

#: what a query can ask for (reference ``api.py:76``)
_OUTPUTS = ("T", "lam", "rho")

# the reference's engine metrics (``api.py:78-93``), by the same names; the
# ``backend`` label carries the port's backend names
_QUERIES = _obs_metrics.counter(
    "sweep_queries_total", "Engine.run calls by backend/axes/cache outcome.",
    labels=("backend", "axes", "cache"))
_OCCUPANCY = _obs_metrics.gauge(
    "sweep_envelope_occupancy",
    "Fraction of the padded envelope carrying real work (1 - padding "
    "waste), per batch axis, as of the last uncached dispatch.",
    labels=("axis",))
_DENSE_BYTES = _obs_metrics.gauge(
    "sweep_dense_bytes",
    "Bytes of plan tensors staged per backend view (dense views report "
    "the full padded footprint, λ tie-break arrays included — the number "
    "the dense→sparse auto-switch compares to MAX_DENSE_BYTES; the "
    "sparse view reports its compact slot-list bytes).",
    labels=("view",))
_CONGESTION_ITERS = _obs_metrics.histogram(
    "sweep_congestion_iters",
    "Fixed-point iterations to convergence per scenario lane "
    "(congestion='fixed_point' dispatches only).",
    buckets=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0))


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """How a query executes.

    ``backend``
        "segment" (the default, as the reference's) — the float64
        gather/max forward over the plan's per-edge view with the scalar
        engine's ATOL tie rules, T, λ and ρ bit-identical to the scalar
        engine, solo or packed; its level loop runs on the
        ``segment_levels_f64`` CUDA kernel, one launch a forward, which
        forms the edge weights itself.
        "dense" — the (max,+) CUDA kernels over each level's padded 0/−1e30
        indicator (the reference's ``"pallas"`` backend): they decide every
        maximum and λ tie in float32, end times are carried in float64; T
        and λ within 1e-5 relative of the float64 scalar engine.
        "sparse" — compact slot lists at O(nv + ne) memory instead of the
        padded dense envelope; the engine selects it by itself when a
        graph's estimated dense footprint exceeds the dense-size guard.
    ``dtype``
        "auto" (the backend's own: segment and sparse → float64, dense →
        float32), "float32" or "float64".  Sparse float64 runs the
        slot-list level loop on the ``sparse_levels_f64`` CUDA kernel with
        the scalar engine's ATOL tie rules, T and λ bit-identical to the
        scalar engine; sparse float32 decides every maximum and λ tie in
        float32 (``sparse_levels_f32``), within 1e-5 relative.  Dense
        computes float32 only, segment float64 only.
    ``max_dense_bytes``
        Per-engine override of :data:`Engine.MAX_DENSE_BYTES` (the
        dense→sparse threshold).  None defers to the
        ``REPRO_MAX_DENSE_BYTES`` environment variable, then the class
        attribute.
    ``lam`` / ``fd_eps``
        "exact" — λ from the critical-path walk.  "fd" — finite-difference
        λ from one values forward over an (nc+1)× scenario grid, λ_c =
        (T(L + h·e_c) − T(L)) / h with h = ``fd_eps`` µs (reference
        ``api.py:115-130``): T is piecewise linear in L, so away from a
        breakpoint fd λ equals exact λ to round-off (~ulp(T)/h); at one
        the two may differ.  Under congestion fd λ is the total derivative
        of the fixed point, every expanded row its own fixed point.
    ``congestion`` / ``max_iters`` / ``tol``
        "none" — the plain forward.  "fixed_point" (segment only, the S
        and K axes) — the forward iterated with each physical link's gap
        scale inflated by ``1 + α_c·max(util − β_c, 0)`` (α, β the bound
        params' per-class registry), damped by 0.5, each (lane, scenario)
        stopping once no link's scale moves more than ``tol`` or after
        ``max_iters`` iterations (:func:`~repro_torch.sweep.engine.
        congestion_forward`).  With every α = 0 the result is bit-identical
        to "none".
    ``cache``
        A :class:`~repro_torch.sweep.cache.SweepCache` that memoizes
        results by content, or None (the default: no cache; the reference
        defaults to its shared cache).
    ``shard`` / ``shard_axis``
        Device fan-out (reference ``api.py:110-116``): ``shard`` is
        None/False (off), True/"auto" (every local device: the engine's
        card count, 1 on the CPU) or an int cap; ``shard_axis`` picks the
        populated axis that splits — "G" (graphs), "K" (candidate cost
        blocks), "S" (scenarios) or "auto" (G when populated, else S).
        The count is walked down to a divisor of the axis
        (:func:`~repro_torch.sweep.engine._resolve_shard`) and each device
        runs one contiguous chunk's forward
        (:func:`~repro_torch.sweep.engine.split_forward`): every lane and
        scenario is computed as in the unsplit forward, so the results are
        bit-identical, and a result-cache key does not depend on either
        field.
    """

    backend: str = "segment"
    dtype: str = "auto"
    max_dense_bytes: Optional[int] = None
    lam: str = "exact"
    fd_eps: float = 2.0 ** -10
    congestion: str = "none"
    max_iters: int = 16
    tol: float = 1e-6
    cache: Optional[SweepCache] = None
    shard: Union[None, bool, int, str] = None
    shard_axis: str = "auto"

    def validate(self) -> "ExecPolicy":
        if self.backend not in ("dense", "segment", "sparse"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(use 'dense', 'segment' or 'sparse')")
        if self.shard_axis not in ("auto", "G", "K", "S"):
            raise ValueError(f"unknown shard_axis {self.shard_axis!r} "
                             "(use 'auto', 'G', 'K' or 'S')")
        if self.shard is not None and self.shard != "auto" \
                and not isinstance(self.shard, (bool, int, np.integer)):
            # a wire-format typo ({"shard": "always"}) fails at the
            # protocol edge, not in _resolve_shard
            raise ValueError("shard must be None, a bool, an int device "
                             f"count or 'auto', got {self.shard!r}")
        if self.dtype not in ("auto", "float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r} "
                             "(use 'auto', 'float32' or 'float64')")
        if self.lam not in ("exact", "fd"):
            raise ValueError(f"unknown lam mode {self.lam!r} "
                             "(use 'exact' or 'fd')")
        if not float(self.fd_eps) > 0.0:
            raise ValueError(f"fd_eps must be positive, got {self.fd_eps!r}")
        if self.congestion not in ("none", "fixed_point"):
            raise ValueError(f"unknown congestion mode {self.congestion!r} "
                             "(use 'none' or 'fixed_point')")
        if self.congestion != "none" and self.backend != "segment":
            raise ValueError(
                "congestion='fixed_point' runs on the segment backend only "
                f"(got backend={self.backend!r}) — the fixed point wraps "
                "the float64 segment forward")
        if int(self.max_iters) < 1:
            raise ValueError(f"max_iters must be >= 1, got "
                             f"{self.max_iters!r}")
        if not float(self.tol) > 0.0:
            raise ValueError(f"tol must be positive, got {self.tol!r}")
        if self.max_dense_bytes is not None \
                and int(self.max_dense_bytes) <= 0:
            raise ValueError("max_dense_bytes must be a positive byte "
                             f"count, got {self.max_dense_bytes!r}")
        if self.cache is not None and not isinstance(self.cache, SweepCache):
            raise ValueError("cache must be a SweepCache or None, got "
                             f"{type(self.cache).__name__}")
        native = {"dense": "float32", "segment": "float64"}.get(self.backend)
        if native is not None and self.dtype not in ("auto", native):
            raise ValueError(f"backend {self.backend!r} computes in {native}; "
                             f"dtype={self.dtype!r} is not available on it")
        return self

    def replace(self, **kw) -> "ExecPolicy":
        return dataclasses.replace(self, **kw).validate()

    @classmethod
    def from_dict(cls, d: dict,
                  base: Optional["ExecPolicy"] = None) -> "ExecPolicy":
        """Parse a wire-format policy block (reference ``api.py:229-240``)
        over ``base`` (default ``ExecPolicy()``), rejecting unknown keys by
        name: a typo like ``{"bakend": "dense"}`` must fail, never run under
        the defaults."""
        bad = sorted(set(d) - set(POLICY_WIRE_FIELDS))
        if bad:
            raise ValueError(
                f"unknown ExecPolicy fields: {bad} "
                f"(known: {sorted(POLICY_WIRE_FIELDS)})")
        return dataclasses.replace(base if base is not None else cls(),
                                   **d).validate()

    def key(self) -> tuple:
        """A hashable identity for engine memoization: the fields, and the
        cache *object* (two policies alike but for the cache they name do
        not share a memoized engine)."""
        return (self.backend, self.shard, self.shard_axis, self.dtype,
                self.max_dense_bytes, self.lam, float(self.fd_eps),
                self.congestion, int(self.max_iters), float(self.tol),
                None if self.cache is None else id(self.cache))

    @property
    def float32(self) -> bool:
        """Whether the forward computes with float32 kernels."""
        return self.backend == "dense" or self.dtype == "float32"

    @property
    def kind(self) -> str:
        """The staged arrays and the forward this policy runs on: "dense",
        "segment", "sparse" (float64), "sparse32" or "congestion"."""
        if self.congestion == "fixed_point":
            return "congestion"
        if self.backend == "sparse":
            return "sparse32" if self.dtype == "float32" else "sparse"
        return self.backend


@dataclasses.dataclass
class Query:
    """A declarative sweep: which batch axes are populated (reference:
    ``repro/sweep/api.py:254-290``).

    ``scenarios``
        One :class:`~repro_torch.sweep.scenarios.ScenarioBatch` (broadcast
        to every graph) or, on a packed engine, one per graph with equal S.
    ``costs``
        The candidate axis K: a
        :class:`~repro_torch.sweep.compile.CostBatch` (or raw [K, ne]
        extra edge costs) for a one-plan engine; one of those a graph for a
        packed engine, all with the same K.
    ``structure``
        The variant axis B: a
        :class:`~repro_torch.sweep.compile.StructureBatch`
        (``CompiledPlan.patch_structure()`` of the engine's plan, or
        ``StructureBatch.from_plans()``).  Not with a packed engine's G.
    ``outputs``
        A subset of ("T", "lam", "rho"); "lam" or "rho" computes both.
    ``graphs`` / ``params``
        The detached workload: when ``graphs`` is set, :func:`run` (or
        ``Engine.run``) evaluates these instead of the engine's own
        graphs — anything :class:`Engine` takes — on an engine memoized by
        content (:func:`detached_engine`), compiled with ``params`` (or
        the engine's).
    """

    scenarios: object = None
    costs: object = None
    structure: object = None
    outputs: Sequence[str] = _OUTPUTS
    graphs: object = None
    params: object = None


@dataclasses.dataclass
class Result:
    """Sweep tensors (float64 numpy): ``T`` has one dim per populated axis,
    in canonical [G|B, K, S] order (``axes`` names them); ``lam``/``rho``
    carry a trailing latency-class dim (reference:
    ``repro/sweep/api.py:292-386``).
    """

    T: np.ndarray                    # [G|B?, K?, S] µs
    lam: Optional[np.ndarray]        # [..., S, nclass], or None (values)
    rho: Optional[np.ndarray]        # [..., S, nclass], or None
    scenarios: object                # ScenarioBatch, or one per graph
    backend: str
    device: str                      # name of the device the forward ran on
    axes: tuple = ("S",)             # a subset of ("G"|"B", "K", "S")
    names: Optional[tuple] = None    # graph or variant names on G / B
    from_cache: bool = False         # served by the result cache
    lam_mode: str = "exact"          # "exact" (the walk) or "fd"
    #: [K?, S] int32 fixed-point iterations (congestion runs only)
    congestion_iters: Optional[np.ndarray] = None

    @property
    def S(self) -> int:
        return int(self.T.shape[-1])

    @property
    def K(self) -> Optional[int]:
        return (int(self.T.shape[self.axes.index("K")]) if "K" in self.axes
                else None)

    @property
    def G(self) -> Optional[int]:
        return int(self.T.shape[0]) if "G" in self.axes else None

    @property
    def B(self) -> Optional[int]:
        return int(self.T.shape[0]) if "B" in self.axes else None

    def _lead_axis(self, what: str) -> None:
        if self.axes[0] not in ("G", "B"):
            raise TypeError(f"result has no graph axis (G) or variant axis "
                            f"(B) to {what}")

    def __getitem__(self, key) -> "Result":
        """One graph's or variant's result, by index or name."""
        self._lead_axis("index")
        g = self.names.index(key) if isinstance(key, str) else int(key)
        # a structure-batched run shares one scenario batch; a packed run
        # carries one a graph
        scen = self.scenarios[g] if self.axes[0] == "G" else self.scenarios
        return Result(
            T=self.T[g].copy(),
            lam=None if self.lam is None else self.lam[g].copy(),
            rho=None if self.rho is None else self.rho[g].copy(),
            scenarios=scen, backend=self.backend, device=self.device,
            axes=self.axes[1:], from_cache=self.from_cache,
            lam_mode=self.lam_mode)

    def split(self) -> dict:
        """{name: per-graph or per-variant Result}, the variant-study
        return shape."""
        self._lead_axis("split")
        return {name: self[i] for i, name in enumerate(self.names)}

    def _objective(self, reduce: str, axis: int) -> np.ndarray:
        """Every axis but ``axis`` collapsed to a makespan objective."""
        T = np.moveaxis(self.T, axis, 0).reshape(self.T.shape[axis], -1)
        if reduce == "mean":
            return T.mean(axis=1)
        if reduce == "max":
            return T.max(axis=1)
        if reduce == "final":
            return T[:, -1]
        raise ValueError(f"unknown reduce {reduce!r}")

    def rank(self, reduce: str = "mean") -> list:
        """[(name, objective)] of the graphs or variants, best (smallest
        makespan objective over the grid) first: ``reduce`` is "mean",
        "max" or "final" (the last scenario)."""
        self._lead_axis("rank")
        obj = self._objective(reduce, 0)
        order = np.argsort(obj, kind="stable")
        return [(self.names[i], float(obj[i])) for i in order]

    def argbest(self, reduce: str = "mean") -> int:
        """The candidate index with the best objective (K axis), or the
        scenario index with the smallest makespan (a scenario-only result).
        A graph- or variant-axis result without K has no single best
        index: ``rank()`` it, or index one out first
        (``res[g].argbest()``)."""
        if "K" in self.axes:
            return int(np.argmin(self._objective(reduce,
                                                 self.axes.index("K"))))
        if self.axes[0] in ("G", "B"):
            raise TypeError("argbest() on a graph/variant-axis result is "
                            "ambiguous (a flat index would conflate it "
                            "with scenarios) — use rank(), or index one "
                            "out first: res[g].argbest()")
        return int(np.argmin(self.T))


def _copy(res: Result, **replace) -> Result:
    """A result with private copies of its arrays (reference
    ``api.py:384-390``): what the cache stores and what a hit returns, so a
    caller's edits never reach the cache."""
    return dataclasses.replace(
        res, T=res.T.copy(),
        lam=None if res.lam is None else res.lam.copy(),
        rho=None if res.rho is None else res.rho.copy(),
        congestion_iters=(None if res.congestion_iters is None
                          else res.congestion_iters.copy()), **replace)


def _variant_names(sb: StructureBatch) -> tuple:
    return sb.names if sb.names is not None else tuple(
        f"v{i}" for i in range(sb.B))


# -- the detached-engine memo (reference ``api.py:403-535``) -----------------
#
# ``Engine.run(Query(graphs=...))`` and the module-level :func:`run` key
# engines by content (graph or plan hashes, params, policy, device), never
# by ``id()``: a study that rebuilds the same graph lands on the staged
# engine, with no plan compile and no staging.  Bounded LRU; inputs that
# cannot be keyed (a params object with a callable field other than
# ``rank_of_class``) build a fresh engine.

_DETACHED_ENGINES: OrderedDict = OrderedDict()
_DETACHED_LOCK = threading.Lock()
_DETACHED_CAP = 16
_DETACHED_STATS = {"hits": 0, "misses": 0}


def _params_content_key(params, nranks: Optional[int] = None):
    """A content key of a LogGPS params object, or None if it cannot be
    keyed: its fields, a ``rank_of_class`` callable by the rank-to-rank
    class matrix it computes over ``nranks`` ranks."""
    if params is None:
        return ("none",)
    parts = []
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        if f.name == "rank_of_class":
            continue
        if callable(v):
            return None
        try:
            hash(v)
        except TypeError:
            return None
        parts.append((f.name, v))
    if getattr(params, "rank_of_class", None) is not None:
        if nranks is None:
            return None
        m = np.asarray([[params.link_class(i, j) for j in range(int(nranks))]
                        for i in range(int(nranks))], dtype=np.int32)
        parts.append(("rank_of_class", b"".join(canonical_bytes(m))))
    return (type(params).__name__, tuple(parts))


def _graphs_content_key(graphs, params):
    """A content key of anything :class:`Engine` takes, or None when a
    member cannot be keyed."""
    if isinstance(graphs, StructureBatch):
        if graphs.base is None:
            return None
        return ("sb", _batch_hash(graphs, STRUCT_FIELDS),
                graphs.base.content_hash(), graphs.names)
    if isinstance(graphs, MultiPlan):
        return (None if graphs.plan_hashes is None
                else ("multi",) + tuple(graphs.plan_hashes))
    if isinstance(graphs, CompiledPlan):
        return ("plan", graphs.content_hash(), graphs.link_hash())
    if isinstance(graphs, SparsePlan):
        return ("sparse", graphs.content_hash())
    if isinstance(graphs, (list, tuple)):
        keys = []
        for item in graphs:
            if isinstance(item, CompiledPlan):
                keys.append(("plan", item.content_hash()))
            elif isinstance(item, (list, tuple)) and len(item) == 2:
                pk = _params_content_key(item[1],
                                         getattr(item[0], "nranks", None))
                if pk is None or not isinstance(item[0], ExecutionGraph):
                    return None
                keys.append(("graph", graph_content_key(item[0]), pk))
            elif isinstance(item, ExecutionGraph):
                keys.append(("graph", graph_content_key(item)))
            else:
                return None
        return ("seq",) + tuple(keys)
    if isinstance(graphs, ExecutionGraph):
        return ("graph", graph_content_key(graphs))
    return None


def detached_engine(graphs, params, policy: "ExecPolicy",
                    device: DeviceLike = None) -> "Engine":
    """The memoized engine of a detached workload (reference
    ``api.py:493-526``), built and kept on first sight of its content;
    a fresh, unkept engine when the inputs cannot be keyed."""
    dev = resolve_device(device)
    gk = _graphs_content_key(graphs, params)
    key = None
    if gk is not None:
        pk = _params_content_key(params, getattr(graphs, "nranks", None))
        if pk is not None:
            key = (gk, pk, policy.key(), str(dev))
    if key is None:
        return Engine(graphs, params=params, policy=policy, device=dev)
    with _DETACHED_LOCK:
        eng = _DETACHED_ENGINES.get(key)
        if eng is not None:
            _DETACHED_ENGINES.move_to_end(key)
            _DETACHED_STATS["hits"] += 1
            return eng
        _DETACHED_STATS["misses"] += 1
    eng = Engine(graphs, params=params, policy=policy, device=dev)
    with _DETACHED_LOCK:
        _DETACHED_ENGINES[key] = eng
        _DETACHED_ENGINES.move_to_end(key)
        while len(_DETACHED_ENGINES) > _DETACHED_CAP:
            _DETACHED_ENGINES.popitem(last=False)
    return eng


def detached_engine_stats() -> dict:
    """The detached-engine memo's hits, misses and live size."""
    with _DETACHED_LOCK:
        return {**_DETACHED_STATS, "size": len(_DETACHED_ENGINES)}


class Engine:
    """Compile once, evaluate any number of scenario batches.

    ``graphs``: an ``ExecutionGraph`` (compiled with ``params``), a
    :class:`~repro_torch.sweep.compile.CompiledPlan` (dense), a
    :class:`~repro_torch.sweep.compile.SparsePlan` (sparse), a
    :class:`~repro_torch.sweep.compile.MultiPlan`, a
    :class:`~repro_torch.sweep.compile.StructureBatch` (its base plan is
    bound and the batch is every run's default ``structure=``, the B
    axis), or a list or tuple of plans, graphs (compiled with ``params``)
    or ``(graph, params)`` pairs, packed with
    :func:`~repro_torch.sweep.compile.pack_plans` into one MultiPlan (the
    member plans kept, for raw per-graph cost extras): the graph axis G,
    on the dense and segment backends.  ``names`` names the G graphs
    (default ``g0``, ``g1``, ...) or a StructureBatch's B variants.
    ``device=None`` runs on the CUDA card and raises without one;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.  ``params``
    also binds the (α, β) registry the congestion fixed point reads.

    The dense-size guard is ``policy.max_dense_bytes``, else the
    ``REPRO_MAX_DENSE_BYTES`` environment variable, else
    :data:`MAX_DENSE_BYTES`; a packed plan counts all G graphs.  A graph
    whose estimated dense footprint
    (:func:`~repro_torch.sweep.compile.estimate_dense_bytes`, taken before
    anything dense is laid out) exceeds it compiles to slot lists: on the
    segment backend (the default), and on the dense backend with dtype
    "auto", the engine warns and switches to sparse float64, as the
    reference's does; dense
    with an explicit dtype "float32" raises.  A compiled or packed plan
    over the guard is refused.
    """

    MAX_DENSE_BYTES = 256 << 20

    def __init__(self, graphs, params=None,
                 policy: Optional[ExecPolicy] = None,
                 device: DeviceLike = None, names: Optional[Sequence] = None):
        self.policy = (policy if policy is not None
                       else ExecPolicy()).validate()
        mdb = self.policy.max_dense_bytes
        if mdb is None:
            env = os.environ.get("REPRO_MAX_DENSE_BYTES", "")
            mdb = int(env) if env else None
        if mdb is not None:
            self.MAX_DENSE_BYTES = int(mdb)
        self.device = resolve_device(device)
        self.params = params
        self.plan = self.sparse = self.multi = None
        self.names = self.plans = self.structure = None
        self._staged_structure = None
        self._dev: dict = {}          # staged arrays by kind (ExecPolicy.kind)
        self.calls = 0                # forwards run (cache hits excluded)
        self._occupancy = None        # the plan's share of real slots
        backend = self.policy.backend
        if isinstance(graphs, (list, tuple, MultiPlan)) \
                and backend == "sparse":
            raise ValueError(
                "the sparse backend evaluates one graph at a time — build "
                "one Engine per graph, or pack them on backend='dense' or "
                "'segment'")
        if isinstance(graphs, StructureBatch):
            if graphs.base is None:
                raise ValueError(
                    "StructureBatch carries no base plan — build it with "
                    "CompiledPlan.patch_structure() or "
                    "StructureBatch.from_plans()")
            self.structure = (graphs if names is None else
                              dataclasses.replace(graphs, names=tuple(names)))
            graphs, names = graphs.base, None
        if isinstance(graphs, (list, tuple)):
            if not graphs:
                raise ValueError("need at least one graph or plan")
            self.plans = [_compiled(item, params) for item in graphs]
            graphs = pack_plans(self.plans)
        if isinstance(graphs, MultiPlan):
            self.multi = graphs
            self.names = (tuple(names) if names is not None
                          else tuple(f"g{i}" for i in range(graphs.G)))
            if len(self.names) != graphs.G:
                raise ValueError(
                    f"{len(self.names)} names for {graphs.G} graphs")
            self._check_dense_bytes(graphs)
            self.arrays = self._arrays(self._plain_kind())
            return
        if names is not None:
            raise ValueError("names= names the graphs of a packed engine or "
                             "the variants of a StructureBatch; pass a list "
                             "of graphs or plans, or a StructureBatch")
        if isinstance(graphs, SparsePlan):
            if backend != "sparse":
                raise ValueError("a SparsePlan runs on backend='sparse'")
            self.sparse = graphs
        elif isinstance(graphs, CompiledPlan):
            if backend == "sparse":
                raise ValueError(
                    "an Engine on backend='sparse' takes an ExecutionGraph "
                    "or a SparsePlan; an engine on a compiled plan re-lays "
                    "it as slot lists for one call with run(backend="
                    "'sparse')")
            self.plan = graphs
        elif isinstance(graphs, ExecutionGraph):
            if backend != "sparse":
                est = estimate_dense_bytes(graphs)
                if est > self.MAX_DENSE_BYTES:
                    # the dense materialization is itself the memory cliff,
                    # so the switch is decided before compile_plan
                    if self.policy.dtype == "float32":
                        raise ValueError(
                            f"graph's padded dense envelope needs "
                            f"~{est >> 20} MiB (> "
                            f"{self.MAX_DENSE_BYTES >> 20} MiB) and "
                            "dtype='float32' pins the dense contract — "
                            "pass backend='sparse' explicitly, or raise "
                            "Engine.MAX_DENSE_BYTES")
                    warnings.warn(
                        f"graph's padded dense envelope needs ~{est >> 20} "
                        f"MiB (> {self.MAX_DENSE_BYTES >> 20} MiB); "
                        "auto-switching to backend='sparse' (compact slot "
                        "lists, float64, T/λ bit-identical to the scalar "
                        "engine)", RuntimeWarning, stacklevel=2)
                    self.policy = dataclasses.replace(self.policy,
                                                      backend="sparse")
            if self.policy.backend == "sparse":
                self.sparse = compile_sparse(graphs, params)
            else:
                self.plan = compile_plan(graphs, params)
        else:
            raise ValueError("need an ExecutionGraph, a CompiledPlan, a "
                             "SparsePlan, a MultiPlan, a StructureBatch or a "
                             f"list of graphs, got {type(graphs).__name__}")
        if self.plan is not None:
            self._check_dense_bytes(self.plan)
        self.arrays = self._arrays(self._plain_kind())

    def _check_dense_bytes(self, plan) -> None:
        if plan.dense_bytes() > self.MAX_DENSE_BYTES:
            what = ("the packed plan of all G graphs"
                    if isinstance(plan, MultiPlan)
                    else f"the {self.policy.backend} backend")
            raise ValueError(
                f"{what} needs {plan.dense_bytes() >> 20} MiB of plan "
                f"tensors (> {self.MAX_DENSE_BYTES >> 20} MiB); raise "
                "ExecPolicy(max_dense_bytes=...) or compile the graph with "
                "backend='sparse' instead")

    def _plain_kind(self) -> str:
        """The kind of the engine's own forward without the fixed point
        (the view ``self.arrays`` holds; a congestion run stages its links
        on first use)."""
        return dataclasses.replace(self.policy, congestion="none").kind

    def _arrays(self, kind: str, device: Optional[torch.device] = None):
        """The plan staged for ``kind`` (:attr:`ExecPolicy.kind`) on the
        engine's device, or on ``device`` for a sharded run's chunk, staged
        on first use and kept: a per-call backend override stages its view
        once (reference ``api.py:682-701``), and so does each device of a
        sharded run."""
        dev = self.device if device is None else _canonical(device)
        key = kind if dev == _canonical(self.device) else (kind, str(dev))
        if key in self._dev:
            return self._dev[key]
        plan = self.plan if self.multi is None else self.multi
        if kind.startswith("sparse"):
            sp = self._sparse_plan()
            a = _eng.stage_sparse(sp, dev,
                                  torch.float32 if kind == "sparse32"
                                  else torch.float64)
            _DENSE_BYTES.set(float(sp.sparse_bytes()), view="sparse")
        elif plan is None:
            raise ValueError(
                "this engine compiled its graph sparse-only (dense envelope "
                f"over MAX_DENSE_BYTES); {kind!r} cannot evaluate it — run "
                "with backend='sparse'")
        elif kind == "segment":
            a = _eng.stage_segment(plan, dev)
        else:
            a = (_eng.stage_multi if self.multi is not None
                 else _eng.stage)(plan, dev)
        if not kind.startswith("sparse"):
            _DENSE_BYTES.set(float(plan.dense_bytes()), view=kind)
        self._dev[key] = a
        return a

    def _lane_arrays(self, a, kind: str, device: torch.device,
                     graphs=None):
        """The arrays a lane forward reads, from the plan's arrays ``a``
        staged on ``device``: a one-plan engine's as a packed plan of one
        graph, the packed plan's, or its graphs ``g0..g1-1`` (``graphs``
        (g0, g1), a sharded run's G chunk), each kept."""
        device = _canonical(device)
        if self.multi is None:
            key = ("packed", kind, str(device))
            if key not in self._dev:
                self._dev[key] = _eng.packed_view(a, self.plan.nlevels)
            return self._dev[key]
        if graphs is None or graphs == (0, self.multi.G):
            return a
        key = ("G", kind, str(device)) + tuple(graphs)
        if key not in self._dev:
            self._dev[key] = _eng.graph_slice(a, *graphs)
        return self._dev[key]

    def _sparse_plan(self) -> SparsePlan:
        """The engine's slot lists: its own, or its plan re-laid on the
        first sparse run (:meth:`SparsePlan.from_plan`)."""
        if self.sparse is None:
            if self.plan is None:
                raise ValueError(
                    "the sparse backend evaluates one graph at a time — "
                    "build one Engine per graph, or pack them on "
                    "backend='dense' or 'segment'")
            self.sparse = SparsePlan.from_plan(self.plan)
        return self.sparse

    @property
    def G(self) -> Optional[int]:
        return None if self.multi is None else self.multi.G

    @property
    def nclass(self) -> int:
        return next(p for p in (self.plan, self.sparse, self.multi)
                    if p is not None).nclass

    def _batches(self, scenarios) -> list:
        """One ScenarioBatch per graph: a single batch is broadcast to
        every graph of a packed engine (reference ``api.py:693-717``)."""
        if self.multi is None:
            batches = [scenarios]
        elif isinstance(scenarios, ScenarioBatch):
            batches = [scenarios] * self.multi.G
        else:
            batches = list(scenarios)
            if len(batches) != self.multi.G:
                raise ValueError(f"{len(batches)} scenario batches for "
                                 f"{self.multi.G} graphs")
        for b in batches:
            if not isinstance(b, ScenarioBatch):
                raise ValueError("scenarios must be a ScenarioBatch, or one "
                                 "per graph of a packed engine")
            if b.nclass != self.nclass:
                raise ValueError(f"scenario batch has {b.nclass} classes, "
                                 f"graph has {self.nclass}")
            if b.S != batches[0].S:
                raise ValueError("per-graph scenario batches must share S "
                                 f"(got {b.S} vs {batches[0].S})")
        return batches

    def _costs(self, costs) -> Optional[list]:
        """The K axis as one validated cost block set a graph, or None
        (reference ``api.py:733-793``): a CostBatch (repadded onto the
        packed envelope when G is populated), or raw [K, ne] float64
        extras, which the forward adds to the staged constants on the
        device (:meth:`_lane_blocks`).  A CostBatch's gap shares, gap
        classes and latency rows may vary across its blocks and differ
        from the plan's: the lanes then own them."""
        if costs is None:
            return None
        if self.multi is None:
            cb = costs
            if not isinstance(cb, CostBatch):
                return [_raw_extras(self.plan, cb)]
            if cb.econst.shape[1:] != self.plan.econst.shape:
                raise ValueError(
                    f"cost block envelope {cb.econst.shape[1:]} does not "
                    f"match the plan's {self.plan.econst.shape} — "
                    "patch_costs() the same plan this engine compiled")
            if cb.plan_hash is not None and \
                    cb.plan_hash != self.plan.content_hash():
                # bucketing gives distinct graphs one envelope, so the
                # shape check alone cannot catch a foreign batch
                raise ValueError(
                    "cost batch was patched from a different plan than "
                    "this engine compiled (same envelope, different "
                    "content) — patch_costs() the engine's own plan")
            return [cb]
        if isinstance(costs, CostBatch):
            raise ValueError(
                "a multi-graph engine needs one cost batch (or [K, ne] "
                "extras array) per graph — got a single CostBatch; pass a "
                f"length-{self.multi.G} sequence")
        cbs = list(costs)
        if len(cbs) != self.multi.G:
            raise ValueError(f"{len(cbs)} cost batches for "
                             f"{self.multi.G} graphs")
        mp = self.multi
        out = []
        for i, cb in enumerate(cbs):
            if not isinstance(cb, CostBatch):
                if self.plans is None:
                    raise ValueError(
                        "raw cost extras need the member plans; construct "
                        "the Engine from plans/graphs (not a bare "
                        "MultiPlan), or pass per-graph CostBatches")
                out.append(_raw_extras(self.plans[i], cb))
                continue
            if cb.plan_hash is not None and mp.plan_hashes is not None \
                    and cb.plan_hash != mp.plan_hashes[i]:
                raise ValueError(
                    f"cost batch {i} was patched from a different plan "
                    f"than graph {i} of this MultiPlan — patch_costs() "
                    "the member plan it rides")
            out.append(cb.repad(mp.nlv_p, mp.Vmax, mp.Dmax, mp.Emax))
        Ks = [_blocks(cb) for cb in out]
        if any(k != Ks[0] for k in Ks):
            raise ValueError(f"per-graph cost batches must share K (got "
                             f"{Ks})")
        return out

    def _structure(self, structure) -> Optional[StructureBatch]:
        """The B axis: an explicit batch, else the engine's own (an Engine
        built from a StructureBatch), checked against the base plan the
        variants ride (reference ``api.py:795-832``)."""
        sb = structure if structure is not None else self.structure
        if sb is None:
            return None
        if not isinstance(sb, StructureBatch):
            raise ValueError(
                "structure must be a StructureBatch — mint one with "
                "CompiledPlan.patch_structure() or "
                "StructureBatch.from_plans()")
        if self.multi is not None:
            raise ValueError(
                "structure blocks and a multi-graph engine cannot combine "
                "(pick one variant axis: pack plans into a MultiPlan OR "
                "batch them with StructureBatch.from_plans)")
        if self.plan is None:
            raise ValueError(
                "this engine compiled its graph sparse-only; structure "
                "batching needs a dense base plan")
        env = (sb.elat.shape[1:], sb.vcost_lv.shape[1:])
        if env != (self.plan.elat.shape, self.plan.vcost_lv.shape):
            raise ValueError(
                f"structure block envelope {env} does not match the plan's "
                f"{(self.plan.elat.shape, self.plan.vcost_lv.shape)} — "
                "patch or re-batch onto the plan this engine compiled")
        if sb.plan_hash is not None and \
                sb.plan_hash != self.plan.content_hash():
            # from_plans batches (plan_hash None) hold every tensor per
            # variant, so the envelope check alone is sound for them
            raise ValueError(
                "structure batch was patched from a different plan than "
                "this engine compiled (same envelope, different content) "
                "— patch_structure() the engine's own plan")
        return sb

    def _structure_arrays(self, sb: StructureBatch, kind: str):
        """The B variants staged as a packed plan of B graphs, each with
        its own lists (rebuilt from its sources and masks, never patched:
        a rewired source may be a row the base plan never listed); kept
        for the next run with the same batch and backend."""
        if self._staged_structure is None \
                or self._staged_structure[0] is not sb \
                or self._staged_structure[1] != kind:
            stage = (_eng.stage_segment if kind == "segment"
                     else _eng.stage_multi)
            self._staged_structure = (sb, kind,
                                      stage(sb.as_multi(), self.device))
        return self._staged_structure[2]

    def run(self, query=None, *, scenarios=None, costs=None,
            structure=None, outputs=None,
            compute_lam: Optional[bool] = None,
            backend: Optional[str] = None, shard=None,
            shard_axis: Optional[str] = None,
            shard_devices: Optional[Sequence] = None,
            use_cache: bool = True,
            policy: Optional[ExecPolicy] = None) -> Result:
        """One forward over a :class:`Query` (or a bare ``ScenarioBatch``,
        or one a graph of a packed engine, or keyword axes): T, and λ/ρ
        unless ``outputs`` asks for T only.  ``compute_lam`` is the short
        spelling of ``outputs`` (True: T, λ, ρ; False: T) and wins over a
        query's.  A packed engine takes one ScenarioBatch (broadcast to
        every graph) or one per graph, all of equal S (reference
        ``api.py:834-1053``).

        Per call: ``policy`` replaces the engine's policy; ``backend``,
        ``shard`` and ``shard_axis`` override its fields (a view this
        engine has not staged is staged once); ``use_cache=False`` skips
        the policy's result cache.  A query with ``graphs`` runs on the
        memoized detached engine of those graphs (:func:`detached_engine`).

        Sharding (reference ``api.py:1112-1126``): ``shard`` resolves to a
        device count (:func:`~repro_torch.sweep.engine._resolve_shard`;
        the local devices are the host's cards for an engine on the card,
        one on the CPU, where a run is never split), and the forward is cut
        along ``shard_axis`` over the first that many cards
        (:func:`~repro_torch.sweep.engine.split_forward`).
        ``shard_devices`` names the devices outright (a device may repeat:
        ``["cuda:0", "cuda:0"]`` runs the split on one card).  Refused, as
        in the reference: the sparse backend, a structure batch and the
        congestion fixed point; ``shard_axis="G"`` without a graph axis and
        ``"K"`` without cost blocks."""
        if isinstance(query, Query):
            if query.graphs is not None:
                sub = detached_engine(
                    query.graphs,
                    query.params if query.params is not None
                    else self.params,
                    policy if policy is not None else self.policy,
                    self.device)
                return sub.run(dataclasses.replace(query, graphs=None,
                                                   params=None),
                               scenarios=scenarios, costs=costs,
                               structure=structure, outputs=outputs,
                               compute_lam=compute_lam, backend=backend,
                               shard=shard, shard_axis=shard_axis,
                               shard_devices=shard_devices,
                               use_cache=use_cache)
            scenarios = query.scenarios if scenarios is None else scenarios
            costs = query.costs if costs is None else costs
            structure = query.structure if structure is None else structure
            outputs = query.outputs if outputs is None else outputs
        elif query is not None:
            if scenarios is not None:
                raise ValueError("pass scenarios positionally or by "
                                 "keyword, not both")
            scenarios = query
        if scenarios is None:
            raise ValueError("a query needs scenarios")
        pol = policy if policy is not None else self.policy
        over = {k: v for k, v in (("backend", backend), ("shard", shard),
                                  ("shard_axis", shard_axis))
                if v is not None}
        if over:
            pol = dataclasses.replace(pol, **over)
        pol.validate()
        sharded = bool(pol.shard) or shard_devices is not None
        if compute_lam is not None:
            outputs = _OUTPUTS if compute_lam else ("T",)
        elif outputs is None:
            outputs = _OUTPUTS
        outputs = tuple(outputs)
        if set(outputs) - set(_OUTPUTS) or not outputs:
            raise ValueError(f"outputs must name a subset of {_OUTPUTS}, "
                             f"got {outputs}")
        want_lam = "lam" in outputs or "rho" in outputs
        sb = self._structure(structure)
        kind = pol.kind
        if pol.backend == "sparse":
            if sb is not None:
                raise ValueError("the sparse backend does not take "
                                 "structure blocks yet — use "
                                 "backend='segment'")
            if costs is not None:
                raise ValueError("the sparse backend does not take cost "
                                 "blocks yet — use backend='segment'")
            if self.multi is not None:
                raise ValueError("the sparse backend evaluates one graph "
                                 "at a time — build a single-graph Engine "
                                 "per member")
            if sharded:
                raise ValueError("the sparse backend does not shard yet")
        elif self.plan is None and self.multi is None:
            raise ValueError(
                "this engine compiled its graph sparse-only (dense "
                f"envelope over MAX_DENSE_BYTES); backend={pol.backend!r} "
                "cannot evaluate it — run with backend='sparse'")
        if sb is not None and sharded:
            raise ValueError("sharding a structure-batched query is not "
                             "supported yet")
        if sb is not None and costs is not None and sb.plan_hash is None:
            raise ValueError(
                "a from_plans() StructureBatch cannot combine with cost "
                "blocks — its variants share no base plan to patch costs "
                "into (use patch_structure() variants for B×K studies)")
        if kind == "congestion":
            if sb is not None:
                raise ValueError("congestion='fixed_point' populates the "
                                 "S and K axes only — no structure blocks "
                                 "yet (run variants through separate "
                                 "engines)")
            if self.multi is not None:
                raise ValueError("congestion='fixed_point' populates the "
                                 "S and K axes only — no multi-graph G "
                                 "axis (build one engine per graph)")
            if sharded:
                raise ValueError("congestion='fixed_point' does not shard "
                                 "yet (the fixed point's lanes iterate in "
                                 "lockstep on one device)")
            if self.params is None:
                raise ValueError(
                    "congestion needs the engine's bound LogGPS params "
                    "for the per-class (α, β) congestion registry — "
                    "construct Engine(graph_or_plan, params=...)")
        with _span("sweep.canonicalize"):
            batches = self._batches(scenarios)
        cbs = None
        if costs is not None:
            with _span("sweep.cost_patch", backend=pol.backend):
                cbs = self._costs(costs)
        axes_s = self._axes_tag(cbs, sb)
        split = (self._split(pol, batches, cbs, want_lam, shard_devices)
                 if sharded else None)
        cache = pol.cache if use_cache else None
        key = None
        if cache is not None:
            with _span("sweep.cache_lookup", axes=axes_s):
                key = self._key(batches, cbs, sb, want_lam, pol)
                hit = cache.get(key,
                                patched=cbs is not None or sb is not None)
            if hit is not None:
                _QUERIES.inc(backend=pol.backend, axes=axes_s, cache="hit")
                # the key is content-addressed: restamp what may differ
                return _copy(hit, scenarios=(batches if self.multi is not None
                                             else batches[0]),
                             names=(_variant_names(sb) if sb is not None
                                    else self.names),
                             device=device_name(self.device),
                             from_cache=True)
        _QUERIES.inc(backend=pol.backend, axes=axes_s,
                     cache="miss" if cache is not None else "off")
        res = self._forward(batches, cbs, sb, want_lam, pol, split)
        if cache is not None:
            # a private copy: the caller's edits never reach later hits
            cache.put(key, _copy(res))
        return res

    def _split(self, pol: ExecPolicy, batches: list, cbs: Optional[list],
               want_lam: bool, devices: Optional[Sequence]):
        """(axis, devices) of a sharded run, or None when it runs whole:
        ``shard_axis`` resolved ("auto": G when populated, else S) and
        checked against the populated axes, and the devices named, or the
        first cards that ``shard`` resolves to over the axis (its padded
        scenario rows, its graphs or its cost blocks)."""
        axis = pol.shard_axis
        if axis == "auto":
            axis = "G" if self.multi is not None else "S"
        if axis == "G" and self.multi is None:
            raise ValueError("shard_axis='G' needs a multi-graph engine (no "
                             "graph axis is populated)")
        if axis == "K" and cbs is None:
            raise ValueError("shard_axis='K' needs a cost batch (no "
                             "candidate axis is populated)")
        if devices is None:
            fd = want_lam and pol.lam == "fd"
            S = batches[0].S * (self.nclass + 1 if fd else 1)
            size = {"G": len(batches), "K": _blocks(cbs[0]) if cbs else 1,
                    "S": _bucket(S, lo=4)}[axis]
            ndev = _eng._resolve_shard(pol.shard, size,
                                       _eng.local_devices(self.device))
            if ndev is None:
                return None
            devices = [torch.device(self.device.type, i)
                       for i in range(ndev)]
        return axis, [torch.device(d) for d in devices]

    def _key(self, batches: list, cbs: Optional[list],
             sb: Optional[StructureBatch], want_lam: bool,
             pol: ExecPolicy) -> str:
        """The cache key of a validated query (reference ``api.py:
        983-1033``): the plan's or packed plan's content hash, the scenario
        batches, the outputs, the λ mode and fd step, the kind (sparse
        float32 and congestion each their own), the cost blocks' and the
        structure batch's hashes, and under congestion a hash of the
        links, the (α, β) registry and the stopping rule."""
        kind = pol.kind
        if kind.startswith("sparse"):
            ph = self._sparse_plan().content_hash()
        elif self.multi is not None:
            ph = self.multi.content_hash()
        else:
            ph = self.plan.content_hash()
        cost_hash = None
        if cbs is not None:
            plans = ([self.plan] if self.multi is None
                     else self.plans or [None] * len(cbs))
            hashes = [_cost_hash(pl, cb) for pl, cb in zip(plans, cbs)]
            cost_hash = (hashes[0] if len(hashes) == 1 else hashlib.sha1(
                "|".join(hashes).encode()).hexdigest())
        congestion_hash = None
        if kind == "congestion":
            ch = hashlib.sha1(b"congestion-v1|")
            ch.update(self.plan.link_hash().encode())
            ch.update(repr((tuple(self.params.alpha_full),
                            tuple(self.params.beta_full),
                            int(pol.max_iters), float(pol.tol))).encode())
            congestion_hash = ch.hexdigest()
        return query_key(
            ph, batches, want_lam, kind, cost_hash,
            lam_mode=pol.lam if want_lam else "exact", fd_eps=pol.fd_eps,
            structure_hash=(None if sb is None
                            else _batch_hash(sb, STRUCT_FIELDS)),
            congestion_hash=congestion_hash)

    def _chunk(self, kind: str, dev: torch.device, Lmat: np.ndarray,
               GSmat: np.ndarray, cbs: Optional[list],
               sb: Optional[StructureBatch], want: bool,
               axis: Optional[str], lo: int, hi: int):
        """One forward on ``dev`` (T, λ or None with the lead axes
        [G|B|1, K?] in front): the whole query when ``axis`` is None, else
        its chunk ``lo..hi-1`` of ``axis`` — scenario rows of Lmat / GSmat
        [G, Sp, nc] ("S"), graphs with their arrays and cost blocks ("G"),
        or cost lanes ("K"; the structures and scenarios whole)."""
        g = (lo, hi) if axis == "G" else None
        if axis == "S":
            Lmat, GSmat = Lmat[:, lo:hi], GSmat[:, lo:hi]
        elif g is not None:
            Lmat, GSmat, cbs = Lmat[lo:hi], GSmat[lo:hi], cbs and cbs[lo:hi]
        to = functools.partial(torch.as_tensor, device=dev)
        has_G, has_B, has_K = (self.multi is not None, sb is not None,
                               cbs is not None)
        if has_B:
            arrays = self._structure_arrays(sb, kind)
            Lmat, GSmat = (np.repeat(x, sb.B, axis=0) for x in (Lmat, GSmat))
        else:
            # the whole query reads the engine's own arrays
            a = self._arrays(kind) if axis is None else self._arrays(kind,
                                                                      dev)
            if not (has_G or has_K):
                fwd = {"segment": _eng.segment_forward,
                       "dense": _eng.dense_forward,
                       "sparse": _eng.sparse_forward_f64,
                       "sparse32": _eng.sparse_forward_f32}[kind]
                T, lam = fwd(a, to(Lmat[0]), to(GSmat[0]), want)
                return T[None], None if lam is None else lam[None]
            arrays = self._lane_arrays(a, kind, dev, g)
        lanes = None
        if has_K:
            blocks = self._lane_blocks(cbs, arrays, g[0] if g else 0)
            for n, x in blocks.items():
                if x is not None and axis == "K":
                    x = x[:, lo:hi]
                if x is not None and has_B:
                    # the base plan's blocks, as every variant's
                    x = x.expand((sb.B,) + x.shape[1:])
                blocks[n] = x
            lanes = _eng.stage_lanes(arrays, **blocks)
        fwd = (_eng.segment_forward_multi if kind == "segment"
               else _eng.dense_forward_multi)
        T, lam = fwd(arrays, to(Lmat), to(GSmat), want, lanes=lanes)
        lead = ((Lmat.shape[0] if has_G else sb.B if has_B else 1,)
                + ((lanes.K,) if has_K else ()))
        return (T.view(lead + T.shape[1:]),
                None if lam is None else lam.view(lead + lam.shape[1:]))

    def _forward(self, batches: list, cbs: Optional[list],
                 sb: Optional[StructureBatch], want_lam: bool,
                 pol: ExecPolicy, split: Optional[tuple] = None) -> Result:
        """The forward of a validated query: one lane a (graph or variant,
        candidate) pair, all lanes in one level-loop launch and one walk,
        or one such forward a chunk when ``split`` (axis, devices) cuts it
        (:func:`~repro_torch.sweep.engine.split_forward`); under congestion
        the fixed point's loop of such launches; with fd λ one values
        forward over the (nc+1)× grid."""
        kind = pol.kind
        nc = self.nclass
        fd = want_lam and pol.lam == "fd"
        h = float(pol.fd_eps)
        S = batches[0].S
        Sext = S * (nc + 1) if fd else S
        Sp = _bucket(Sext, lo=4)

        def padded(a, rows):
            """[Sp, nc]: the scenario rows (the fd grid's base rows, then
            one block of +h·e_c a class) padded with copies of the last
            (reference ``api.py:1073-1089``)."""
            if fd:
                a = np.concatenate([a] + [a + h * np.eye(nc)[c]
                                          for c in range(nc)]
                                   if rows else [a] * (nc + 1))
            out = np.repeat(a[-1:], Sp, axis=0)
            out[:Sext] = a
            return out

        has_G, has_B, has_K = (self.multi is not None, sb is not None,
                               cbs is not None)
        with _span("sweep.stage", backend=pol.backend):
            Lmat = np.stack([padded(b.L, True) for b in batches])
            GSmat = np.stack([padded(b.gscale, False) for b in batches])
        self._set_occupancy(pol, Sext / Sp, has_K, has_B)
        cong = kind == "congestion"
        lanes = None
        iters = None
        to = functools.partial(torch.as_tensor, device=self.device)
        axes_s = self._axes_tag(cbs, sb)
        n_prog0 = _WATCHER.programs()
        t0_ns = time.perf_counter_ns()
        t0 = time.perf_counter()
        with _span("sweep.execute", backend=pol.backend, axes=axes_s):
            if cong:
                arrays = self._arrays("segment")
                if arrays.links is None:
                    arrays.links = _eng.stage_links(self.plan, arrays)
                arrays = _eng.packed_view(arrays, self.plan.nlevels)
                if has_K:
                    lanes = _eng.stage_lanes(
                        arrays, **self._lane_blocks(cbs, arrays))
                with _span("sweep.congestion_fixed_point",
                           max_iters=int(pol.max_iters)):
                    T, lam, iters = _eng.congestion_forward(
                        arrays, to(Lmat), to(GSmat), want_lam and not fd,
                        self.params.alpha_full, self.params.beta_full,
                        pol.max_iters, pol.tol, lanes)
                lead = (1,) + ((lanes.K,) if has_K else ())
                T = T.view(lead + T.shape[1:])
                lam = None if lam is None else lam.view(lead + lam.shape[1:])
            else:
                def chunk(dev, lo, hi):
                    return self._chunk(kind, dev, Lmat, GSmat, cbs, sb,
                                       want_lam and not fd,
                                       None if split is None else split[0],
                                       lo, hi)
                if split is None:
                    T, lam = chunk(self.device, 0, 0)
                else:
                    axis, devices = split
                    size = {"G": Lmat.shape[0], "S": Lmat.shape[1],
                            "K": _blocks(cbs[0]) if has_K else 1}[axis]
                    T, lam = _eng.split_forward(
                        chunk, devices, size, {"G": 0, "K": 1, "S": -1}[axis],
                        self.device)
            if not (has_G or has_B):
                T = T[0]
                lam = None if lam is None else lam[0]
            T = T[..., :Sext].double().cpu().numpy()
        _WATCHER.attribute(
            n_prog0, time.perf_counter() - t0, t0_ns=t0_ns,
            backend=pol.backend, axes=axes_s,
            lam=("exact" if want_lam and not fd else
                 "fd" if fd else "none"),
            envelope=self._envelope(kind), S=Sp,
            **({"K": _blocks(cbs[0])} if has_K else {}),
            **({"G": len(batches)} if has_G else {}),
            **({"B": sb.B} if has_B else {}))
        self.calls += 1
        if iters is not None:
            iters = iters[..., :Sext].cpu().numpy()
            if not has_K:
                iters = iters[0]
            if fd:
                # every expanded row ran its own fixed point: the base
                # rows' counts (reference ``api.py:1334-1339``)
                iters = iters.reshape(iters.shape[:-1] + (nc + 1, S))[
                    ..., 0, :]
            for v in iters.ravel():
                _CONGESTION_ITERS.observe(float(v))
        rho = None
        if want_lam:
            # fd implies want_lam, so its reduction nests under the span
            with _span("sweep.lam_backtrace", mode=pol.lam):
                if fd:
                    Tr = T.reshape(T.shape[:-1] + (nc + 1, S))
                    T = Tr[..., 0, :]
                    lam = np.moveaxis(
                        (Tr[..., 1:, :] - T[..., None, :]) / h, -2, -1)
                else:
                    lam = lam[..., :S, :].double().cpu().numpy()
                Lb = (np.stack([b.L for b in batches]) if has_G
                      else batches[0].L)
                if has_G and has_K:
                    Lb = Lb[:, None]
                rho = np.where(T[..., None] > 0,
                               Lb * lam / np.maximum(T[..., None], 1e-300),
                               0.0)
        else:
            lam = None
        axes = (("G",) if has_G else ()) + (("B",) if has_B else ()) \
            + (("K",) if has_K else ()) + ("S",)
        return Result(T=np.ascontiguousarray(T),
                      lam=None if lam is None else np.ascontiguousarray(lam),
                      rho=rho,
                      scenarios=batches if has_G else batches[0],
                      backend=pol.backend,
                      device=device_name(self.device), axes=axes,
                      names=_variant_names(sb) if has_B else self.names,
                      lam_mode=pol.lam if want_lam else "exact",
                      congestion_iters=iters)

    def _axes_tag(self, cbs, sb) -> str:
        """The populated axes as the metrics and spans label them ("S",
        "KS", "GKS", "BKS", ...)."""
        return ("G" if self.multi is not None else "") \
            + ("B" if sb is not None else "") \
            + ("K" if cbs is not None else "") + "S"

    def _set_occupancy(self, pol: ExecPolicy, s_share: float, has_K: bool,
                       has_B: bool) -> None:
        """The envelope-occupancy gauges of one dispatch (reference
        ``api.py:1099-1110``): the plan's real slots, and the scenario
        rows' share of the padded S; the port pads neither K nor B, so
        their share is 1."""
        if self._occupancy is None:
            vf = (self._sparse_plan().valid if pol.kind.startswith("sparse")
                  else (self.plan if self.multi is None
                        else self.multi).valid_flat)
            self._occupancy = float(np.count_nonzero(vf) / vf.size)
        _OCCUPANCY.set(self._occupancy, axis="slots")
        _OCCUPANCY.set(s_share, axis="S")
        if has_K:
            _OCCUPANCY.set(1.0, axis="K")
        if has_B:
            _OCCUPANCY.set(1.0, axis="B")

    def _envelope(self, kind: str) -> str:
        """The compile watcher's envelope tag of a dispatch (reference
        ``api.py:1237-1242``)."""
        if kind.startswith("sparse"):
            sp = self._sparse_plan()
            return f"ne{sp.esrc_slot.shape[0]}v{sp.vcost.shape[0]}"
        plan = self.plan if self.multi is None else self.multi
        return f"{plan.nlv_p}x{plan.Vmax}x{plan.Dmax}"

    def _lane_blocks(self, cbs: list, arrays, first: int = 0) -> dict:
        """The keyword arguments of :func:`~repro_torch.sweep.engine.
        stage_lanes` on the device: ``econst`` [G, K, nlv_p, Emax] float64,
        each graph's K blocks of edge constants (G = 1 without a graph
        axis; a structure batch's variants share the base plan's), and each
        of :data:`~repro_torch.sweep.engine.LANE_FIELDS` that some graph's
        blocks own (:func:`_owned`), every graph's K blocks of it (a graph
        whose blocks do not own it repeats its structure's), else None.  A
        CostBatch's come from the host; raw extras are added on the device
        to the staged constants at each edge's recorded slot, the one
        float64 add ``patch_costs`` makes (an edge has one slot), so the
        lanes are bit-identical either way and a placement step moves [K,
        ne] extras, not K padded blocks.  ``cbs`` are graphs ``first..`` of
        the engine's, ``arrays`` on the device the lanes run on."""
        dev = arrays.econst.device
        econst = []
        for i, cb in enumerate(cbs):
            if isinstance(cb, CostBatch):
                econst.append(torch.from_numpy(np.ascontiguousarray(
                    cb.econst)).to(dev))
                continue
            plan = self.plan if self.multi is None else self.plans[first + i]
            base = arrays.econst[i]                       # [nlv_p, Emax]
            flat = torch.from_numpy(plan.epos_lvl.astype(np.int64)
                                    * base.shape[1] + plan.epos_e).to(dev)
            ec = base.reshape(1, -1).repeat(cb.shape[0], 1)
            ec[:, flat] += torch.from_numpy(cb).to(dev)
            econst.append(ec.view((cb.shape[0],) + base.shape))
        out = {"econst": torch.stack(econst)}
        plans = ([self.plan] * len(cbs) if self.multi is None
                 else self.plans[first:first + len(cbs)] if self.plans
                 else [None] * len(cbs))
        owned = [_owned(cb, self._fields(first + i), _real(pl))
                 if isinstance(cb, CostBatch) else ()
                 for i, (cb, pl) in enumerate(zip(cbs, plans))]
        for n in _eng.LANE_FIELDS:
            staged = getattr(arrays, n)                   # [G, nlv_p, ...]
            out[n] = None if not any(n in o for o in owned) else torch.stack([
                torch.from_numpy(np.ascontiguousarray(getattr(cb, n))).to(
                    dev, staged.dtype) if n in o
                else staged[i].expand((_blocks(cb),) + staged.shape[1:])
                for i, (cb, o) in enumerate(zip(cbs, owned))])
        return out

    def _fields(self, g: int) -> dict:
        """Graph ``g``'s (or the one plan's) per-edge fields that a cost
        block may own, on the host."""
        if self.multi is None:
            return {n: getattr(self.plan, n) for n in _eng.LANE_FIELDS}
        return {n: getattr(self.multi, n)[g] for n in _eng.LANE_FIELDS}


def _canonical(device: torch.device) -> torch.device:
    """``device`` with its card index filled in (``cuda`` is the current
    card), so one card under two spellings stages its arrays once."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _raw_extras(plan: CompiledPlan, extras) -> np.ndarray:
    """[K, ne] float64 extra edge costs checked against ``plan`` as
    ``patch_costs`` checks them."""
    plan._need_epos("cost patching")
    ex = np.atleast_2d(np.asarray(extras, dtype=np.float64))
    if ex.ndim != 2 or ex.shape[1] != plan.epos_lvl.shape[0]:
        raise ValueError(f"extra_edge_cost has {ex.shape[-1]} edges, plan "
                         f"was compiled from {plan.epos_lvl.shape[0]}")
    return ex


def _blocks(cb) -> int:
    """K of a CostBatch or of raw [K, ne] extras."""
    return cb.K if isinstance(cb, CostBatch) else int(cb.shape[0])


def _owned(cb: CostBatch, fields: dict, real=None) -> tuple:
    """The per-edge fields (:data:`~repro_torch.sweep.engine.LANE_FIELDS`)
    whose blocks in ``cb`` are not all the structure's ``fields``: those
    that vary across the blocks, or that a hand-assembled batch sets
    otherwise.  ``real``, the plan's ``(epos_lvl, epos_e)`` where it has
    them, limits the compare to the real edges' slots (no lane reads a
    padding slot), so staging and the result cache's key
    (:func:`_cost_hash`) take one decision.  A field that ``patch_costs``
    left as a stride-0 view of the plan's own array is the structure's
    without a compare, so a batch of extras stages the bytes it staged
    before its lanes could own any."""
    out = []
    for n in _eng.LANE_FIELDS:
        a, own = getattr(cb, n), fields[n]
        if a.strides[0] == 0:
            a0 = a[0]
            if (a0.ctypes.data == own.ctypes.data
                    and a0.strides == own.strides and a0.shape == own.shape):
                continue
            a = a[:1]
        if a.shape[1:] != own.shape:
            out.append(n)
            continue
        if real is not None:
            a, own = a[:, real[0], real[1]], own[real]
        if (a != own).any():
            out.append(n)
    return tuple(out)


def _real(plan: Optional[CompiledPlan]):
    """``plan``'s real-edge slots ``(epos_lvl, epos_e)``, or None without
    the plan or its edge-position records."""
    if plan is None or plan.epos_lvl is None:
        return None
    return plan.epos_lvl, plan.epos_e


def _compiled(item, params) -> CompiledPlan:
    """A member of a packed engine's list: a CompiledPlan, a ``(graph,
    params)`` pair, or a graph compiled with the engine's ``params``."""
    if isinstance(item, CompiledPlan):
        return item
    if isinstance(item, (list, tuple)) and len(item) == 2:
        return compile_plan(*item)
    if isinstance(item, ExecutionGraph):
        return compile_plan(item, params)
    raise ValueError("a packed engine takes CompiledPlans, graphs or "
                     f"(graph, params) pairs, got {type(item).__name__}")


def _batch_hash(batch, fields) -> str:
    """SHA1 over a cost or structure batch's fields: a stride-0 (unpatched)
    field by its one block, tagged, so a broadcast is never materialized
    and never collides with a batch that stacks the same block."""
    sha = hashlib.sha1(b"batch-v1|")
    for n in fields:
        a = getattr(batch, n)
        sha.update(n.encode() + (b"|b|" if a.strides[0] == 0 else b"|k|"))
        for chunk in canonical_bytes(a[0] if a.strides[0] == 0 else a):
            sha.update(chunk)
    return sha.hexdigest()


def _cost_hash(plan: Optional[CompiledPlan], cb) -> str:
    """The hash of one graph's K cost blocks as its lanes consume them:
    the real edges' constants, [K, ne] in original edge order, so raw
    extras and ``patch_costs()`` of the same extras (one float64 add at an
    edge's slot either way) share a key; and, by name, each gap-share,
    gap-class or latency field that the blocks own (:func:`_owned`, the
    rule staging follows), since two batches of equal constants then give
    different answers.  A batch that owns none keys as its constants
    alone.  Without the plan's edge-position records, a CostBatch hashes
    by all its fields."""
    real = _real(plan)
    if real is None:
        if not isinstance(cb, CostBatch):
            raise ValueError("raw cost extras need the member plans")
        return _batch_hash(cb, ("econst", "egap", "egclass", "elat"))
    if not isinstance(cb, CostBatch):
        return array_hash(np.ascontiguousarray(plan.econst[real][None]
                                               + cb))
    econst = array_hash(np.ascontiguousarray(cb.econst[:, real[0],
                                                       real[1]]))
    owned = _owned(cb, {n: getattr(plan, n) for n in _eng.LANE_FIELDS},
                   real)
    if not owned:
        return econst
    parts = [econst]
    for n in owned:
        a = getattr(cb, n)
        blocks = (a[:1] if a.strides[0] == 0 else a)[:, real[0], real[1]]
        parts.append(n + ":" + array_hash(np.ascontiguousarray(
            np.broadcast_to(blocks, (cb.K,) + blocks.shape[1:]))))
    return hashlib.sha1("|".join(parts).encode()).hexdigest()


def run(query: Query, policy: Optional[ExecPolicy] = None, params=None,
        device: DeviceLike = None) -> Result:
    """One detached evaluation (reference ``api.py:1380-1393``): compile
    ``query.graphs`` (with ``query.params``, else ``params``), run the
    query, return its :class:`Result`.  Engines are memoized by content
    (:func:`detached_engine`), so a query whose graphs were rebuilt with
    equal arrays reuses the staged engine: one-shot calls in a loop cost
    what a kept :class:`Engine` costs.  ``device`` as :class:`Engine`'s."""
    if query.graphs is None:
        raise ValueError("a detached run() needs query.graphs")
    eng = detached_engine(
        query.graphs, query.params if query.params is not None else params,
        policy if policy is not None else ExecPolicy(), device)
    return eng.run(dataclasses.replace(query, graphs=None, params=None))
