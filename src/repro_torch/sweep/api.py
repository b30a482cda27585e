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
and one walk, whatever G, B and K are.  The congestion fixed point,
sharding, finite-difference λ, the per-call backend override, the
result cache and the detached ``Query.graphs`` / ``params`` are not
ported yet.  ``ExecPolicy()`` defaults to segment float64, as the
reference's does, so a call with no policy gives the scalar engine's
answers bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.device import DeviceLike, device_name, resolve_device

from . import engine as _eng
from .compile import (CompiledPlan, CostBatch, MultiPlan, SparsePlan,
                      StructureBatch, _bucket, compile_plan, compile_sparse,
                      estimate_dense_bytes, pack_plans)
from .scenarios import ScenarioBatch

#: what a query can ask for (reference ``api.py:76``)
_OUTPUTS = ("T", "lam", "rho")


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
    """

    backend: str = "segment"
    dtype: str = "auto"
    max_dense_bytes: Optional[int] = None

    def validate(self) -> "ExecPolicy":
        if self.backend not in ("dense", "segment", "sparse"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(use 'dense', 'segment' or 'sparse')")
        if self.dtype not in ("auto", "float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r} "
                             "(use 'auto', 'float32' or 'float64')")
        if self.max_dense_bytes is not None \
                and int(self.max_dense_bytes) <= 0:
            raise ValueError("max_dense_bytes must be a positive byte "
                             f"count, got {self.max_dense_bytes!r}")
        native = {"dense": "float32", "segment": "float64"}.get(self.backend)
        if native is not None and self.dtype not in ("auto", native):
            raise ValueError(f"backend {self.backend!r} computes in {native}; "
                             f"dtype={self.dtype!r} is not available on it")
        return self

    @property
    def float32(self) -> bool:
        """Whether the forward computes with float32 kernels."""
        return self.backend == "dense" or self.dtype == "float32"


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
        The reference's detached-engine override, which comes with the
        result cache in a later slice: setting either raises
        ``NotImplementedError``.
    """

    scenarios: object = None
    costs: object = None
    structure: object = None
    outputs: Sequence[str] = _OUTPUTS
    graphs: object = None
    params: object = None

    def __post_init__(self):
        if self.graphs is not None or self.params is not None:
            raise NotImplementedError(
                "Query.graphs / Query.params (the detached engine) are not "
                "ported yet: they come with the result cache in a later "
                "slice.  Build an Engine on the graphs and run the query "
                "on it")


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
            axes=self.axes[1:])

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


def _variant_names(sb: StructureBatch) -> tuple:
    return sb.names if sb.names is not None else tuple(
        f"v{i}" for i in range(sb.B))


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
    ``device="cpu"`` runs the kernels' plain PyTorch versions.

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
        self.plan = self.sparse = self.multi = None
        self.names = self.plans = self.structure = None
        self._packed_arrays = self._staged_structure = None
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
            self.arrays = (_eng.stage_segment if backend == "segment"
                           else _eng.stage_multi)(graphs, self.device)
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
                    "backend='sparse' takes an ExecutionGraph or a "
                    "SparsePlan (re-laying a dense plan is not ported)")
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
        if self.sparse is not None:
            self.arrays = _eng.stage_sparse(
                self.sparse, self.device,
                torch.float32 if self.policy.float32 else torch.float64)
            return
        self._check_dense_bytes(self.plan)
        self.arrays = (_eng.stage_segment if self.policy.backend == "segment"
                       else _eng.stage)(self.plan, self.device)

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
        device (:func:`_lane_constants`)."""
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
            _lane_fields(cb, self.plan)
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
            cb = cb.repad(mp.nlv_p, mp.Vmax, mp.Dmax, mp.Emax)
            _lane_fields(cb, *(getattr(mp, n)[i] for n in _LANE_SHARED))
            out.append(cb)
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

    def _structure_arrays(self, sb: StructureBatch):
        """The B variants staged as a packed plan of B graphs, each with
        its own lists (rebuilt from its sources and masks, never patched:
        a rewired source may be a row the base plan never listed); kept
        for the next run with the same batch."""
        if self._staged_structure is None \
                or self._staged_structure[0] is not sb:
            stage = (_eng.stage_segment
                     if self.policy.backend == "segment"
                     else _eng.stage_multi)
            self._staged_structure = (sb, stage(sb.as_multi(), self.device))
        return self._staged_structure[1]

    def run(self, query=None, *, scenarios=None, costs=None,
            structure=None, outputs=None,
            compute_lam: Optional[bool] = None) -> Result:
        """One forward over a :class:`Query` (or a bare ``ScenarioBatch``,
        or one a graph of a packed engine, or keyword axes): T, and λ/ρ
        unless ``outputs`` asks for T only.  ``compute_lam`` is the short
        spelling of ``outputs`` (True: T, λ, ρ; False: T) and wins over a
        query's.  A packed engine takes one ScenarioBatch (broadcast to
        every graph) or one per graph, all of equal S (reference
        ``api.py:834-1053``, without the cache, sharding, finite-difference
        λ and the congestion fixed point)."""
        if isinstance(query, Query):
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
        if self.policy.backend == "sparse":
            if sb is not None:
                raise ValueError("the sparse backend does not take "
                                 "structure blocks yet — use "
                                 "backend='segment'")
            if costs is not None:
                raise ValueError("the sparse backend does not take cost "
                                 "blocks yet — use backend='segment'")
        if sb is not None and costs is not None and sb.plan_hash is None:
            raise ValueError(
                "a from_plans() StructureBatch cannot combine with cost "
                "blocks — its variants share no base plan to patch costs "
                "into (use patch_structure() variants for B×K studies)")
        batches = self._batches(scenarios)
        return self._forward(batches, self._costs(costs), sb, want_lam)

    def _forward(self, batches: list, cbs: Optional[list],
                 sb: Optional[StructureBatch], want_lam: bool) -> Result:
        """The forward of a validated query: one lane a (graph or variant,
        candidate) pair, all lanes in one level-loop launch and one walk."""
        S = batches[0].S
        Sp = _bucket(S, lo=4)

        def padded(a):
            """[Sp, nc]: the scenario axis padded with copies of the last
            row (reference ``api.py:1082-1089``)."""
            out = np.repeat(a[-1:], Sp, axis=0)
            out[:S] = a
            return out

        has_G, has_B, has_K = (self.multi is not None, sb is not None,
                               cbs is not None)
        Lmat = np.stack([padded(b.L) for b in batches])
        GSmat = np.stack([padded(b.gscale) for b in batches])
        segment = self.policy.backend == "segment"
        lanes = None
        if not (has_G or has_B or has_K):
            arrays = self.arrays
            Lmat, GSmat = Lmat[0], GSmat[0]
            if segment:
                fwd = _eng.segment_forward
            elif self.sparse is None:
                fwd = _eng.dense_forward
            elif self.policy.float32:
                fwd = _eng.sparse_forward_f32
            else:
                fwd = _eng.sparse_forward_f64
        else:
            if has_B:
                arrays = self._structure_arrays(sb)
                Lmat, GSmat = (np.repeat(x, sb.B, axis=0)
                               for x in (Lmat, GSmat))
            elif has_G:
                arrays = self.arrays
            else:
                if self._packed_arrays is None:
                    self._packed_arrays = _eng.packed_view(
                        self.arrays, self.plan.nlevels)
                arrays = self._packed_arrays
            if has_K:
                econst = self._lane_constants(cbs, arrays)
                if has_B:
                    econst = econst.expand((sb.B,) + econst.shape[1:])
                lanes = _eng.stage_lanes(arrays, econst)
            fwd = functools.partial(_eng.segment_forward_multi if segment
                                    else _eng.dense_forward_multi,
                                    lanes=lanes)

        T, lam = fwd(arrays, torch.from_numpy(Lmat).to(self.device),
                     torch.from_numpy(GSmat).to(self.device), want_lam)
        lead = ((len(batches) if has_G else sb.B if has_B else 1,)
                + ((_blocks(cbs[0]),) if has_K else ()))
        if has_G or has_B or has_K:
            T = T.view(lead + T.shape[1:])
            lam = None if lam is None else lam.view(lead + lam.shape[1:])
            if not (has_G or has_B):
                T = T[0]
                lam = None if lam is None else lam[0]
        T = T[..., :S].double().cpu().numpy()
        rho = None
        if want_lam:
            lam = lam[..., :S, :].double().cpu().numpy()
            Lb = np.stack([b.L for b in batches]) if has_G else batches[0].L
            if has_G and has_K:
                Lb = Lb[:, None]
            rho = np.where(T[..., None] > 0,
                           Lb * lam / np.maximum(T[..., None], 1e-300), 0.0)
        else:
            lam = None
        axes = (("G",) if has_G else ()) + (("B",) if has_B else ()) \
            + (("K",) if has_K else ()) + ("S",)
        return Result(T=T, lam=lam, rho=rho,
                      scenarios=batches if has_G else batches[0],
                      backend=self.policy.backend,
                      device=device_name(self.device), axes=axes,
                      names=_variant_names(sb) if has_B else self.names)


    def _lane_constants(self, cbs: list, arrays) -> torch.Tensor:
        """[G, K, nlv_p, Emax] float64 on the device: each graph's K blocks
        of edge constants (G = 1 without a graph axis; a structure batch's
        variants share the base plan's).  A CostBatch's come from the host;
        raw extras are added on the device to the staged constants at each
        edge's recorded slot, the one float64 add ``patch_costs`` makes
        (an edge has one slot), so the lanes are bit-identical either way
        and a placement step moves [K, ne] extras, not K padded blocks."""
        out = []
        for i, cb in enumerate(cbs):
            if isinstance(cb, CostBatch):
                out.append(torch.from_numpy(np.ascontiguousarray(
                    cb.econst)).to(self.device))
                continue
            plan = self.plan if self.multi is None else self.plans[i]
            base = arrays.econst[i]                       # [nlv_p, Emax]
            flat = torch.from_numpy(plan.epos_lvl.astype(np.int64)
                                    * base.shape[1] + plan.epos_e).to(
                self.device)
            ec = base.reshape(1, -1).repeat(cb.shape[0], 1)
            ec[:, flat] += torch.from_numpy(cb).to(self.device)
            out.append(ec.view((cb.shape[0],) + base.shape))
        return torch.stack(out)


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


#: the per-edge fields the K lanes of a structure share: a cost batch may
#: vary its edge constants only
_LANE_SHARED = ("egap", "egclass", "elat")


def _lane_fields(cb: CostBatch, *shared) -> None:
    """Refuse a cost batch whose gap shares, gap classes or latency rows
    vary across its blocks, or (hand-assembled, no plan hash) differ from
    the plan's: the port's K lanes share their structure's and vary only
    the edge constants, all ``patch_costs`` patches."""
    if len(shared) == 1:
        shared = tuple(getattr(shared[0], n) for n in _LANE_SHARED)
    for n, own in zip(_LANE_SHARED, shared):
        a = getattr(cb, n)
        if (a.strides[0] != 0 and (a != a[:1]).any()) or (
                cb.plan_hash is None and not np.array_equal(a[0], own)):
            raise ValueError(
                f"the cost batch's {n} differs across its blocks or from "
                "the plan's: the K axis varies the edge constants only "
                "(patch_costs() extras)")


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
