"""The PyTorch package's sweep API: :class:`ExecPolicy`, :class:`Engine`,
:class:`Result`.

A reduced counterpart of the JAX package's ``repro/sweep/api.py``.  One
engine binds one graph (or compiled plan), or G graphs packed into one
:class:`~repro_torch.sweep.compile.MultiPlan`, stages the plan's tensors on
its device once, and evaluates scenario batches through the segment forward
(float64, the default, as in the reference), the dense forward (float32
kernels), their packed twins, or the sparse slot-list forwards of
:mod:`.engine`:

    >>> eng = Engine(graph, params=p)                  # on the CUDA card
    >>> res = eng.run(scenarios=latency_grid(p, deltas))
    >>> res.T, res.lam, res.rho                        # [S], [S, nc], [S, nc]

    >>> eng = Engine([(g1, p), (g2, p)], names=["ring", "tree"])
    >>> res = eng.run(latency_grid(p, deltas))         # axes ("G", "S")
    >>> res.rank(), res["ring"].T

A graph whose padded dense envelope exceeds the dense-size guard is
compiled to compact slot lists instead (with a warning), as the
reference's engine does.

The scenario (S) and graph (G) axes are populated, on the dense and the
segment backends (G) and on all three (S); the candidate-cost (K) and
structure (B) axes, the congestion fixed point, sharding,
finite-difference λ, the per-call backend override and the result cache
are not ported yet.  ``ExecPolicy()`` defaults to segment float64, as
the reference's does, so a call with no policy gives the scalar engine's
answers bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.device import DeviceLike, device_name, resolve_device

from . import engine as _eng
from .compile import (CompiledPlan, MultiPlan, SparsePlan, _bucket,
                      compile_plan, compile_sparse, estimate_dense_bytes,
                      pack_plans)
from .scenarios import ScenarioBatch


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
class Result:
    """Sweep tensors (float64 numpy): ``T`` has one dim per populated axis,
    in [G?, S] order (``axes`` names them); ``lam``/``rho`` carry a
    trailing latency-class dim (reference: ``repro/sweep/api.py:292-386``).
    """

    T: np.ndarray                    # [G?, S] µs
    lam: Optional[np.ndarray]        # [G?, S, nclass], or None (values-only)
    rho: Optional[np.ndarray]        # [G?, S, nclass], or None
    scenarios: object                # ScenarioBatch, or one per graph
    backend: str
    device: str                      # name of the device the forward ran on
    axes: tuple = ("S",)             # ("S",) or ("G", "S")
    names: Optional[tuple] = None    # graph names on the G axis

    @property
    def S(self) -> int:
        return int(self.T.shape[-1])

    @property
    def G(self) -> Optional[int]:
        return int(self.T.shape[0]) if "G" in self.axes else None

    def _graph_axis(self, what: str) -> None:
        if self.axes[0] != "G":
            raise TypeError(f"result has no graph axis to {what}")

    def __getitem__(self, key) -> "Result":
        """One graph's result, by index or name."""
        self._graph_axis("index")
        g = self.names.index(key) if isinstance(key, str) else int(key)
        return Result(
            T=self.T[g].copy(),
            lam=None if self.lam is None else self.lam[g].copy(),
            rho=None if self.rho is None else self.rho[g].copy(),
            scenarios=self.scenarios[g], backend=self.backend,
            device=self.device, axes=self.axes[1:])

    def split(self) -> dict:
        """{name: per-graph Result}, the variant-study return shape."""
        self._graph_axis("split")
        return {name: self[i] for i, name in enumerate(self.names)}

    def rank(self, reduce: str = "mean") -> list:
        """[(name, objective)] of the graphs, best (smallest makespan
        objective over the scenario grid) first: ``reduce`` is "mean",
        "max" or "final" (the last scenario)."""
        self._graph_axis("rank")
        if reduce == "mean":
            obj = self.T.mean(axis=1)
        elif reduce == "max":
            obj = self.T.max(axis=1)
        elif reduce == "final":
            obj = self.T[:, -1]
        else:
            raise ValueError(f"unknown reduce {reduce!r}")
        order = np.argsort(obj, kind="stable")
        return [(self.names[i], float(obj[i])) for i in order]

    def argbest(self) -> int:
        """Index of the scenario with the smallest makespan.  A graph-axis
        result has no single best index: ``rank()`` the graphs, or index
        one out first (``res[g].argbest()``)."""
        if self.axes[0] == "G":
            raise TypeError("argbest() on a graph-axis result is ambiguous "
                            "— use rank(), or index one out first: "
                            "res[g].argbest()")
        return int(np.argmin(self.T))


class Engine:
    """Compile once, evaluate any number of scenario batches.

    ``graphs``: an ``ExecutionGraph`` (compiled with ``params``), a
    :class:`~repro_torch.sweep.compile.CompiledPlan` (dense), a
    :class:`~repro_torch.sweep.compile.SparsePlan` (sparse), a
    :class:`~repro_torch.sweep.compile.MultiPlan`, or a list or tuple of
    plans, graphs (compiled with ``params``) or ``(graph, params)`` pairs,
    packed with :func:`~repro_torch.sweep.compile.pack_plans` into one
    MultiPlan: the graph axis G, on the dense and segment backends.  ``names``
    names the G graphs (default ``g0``, ``g1``, ...).
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
        self.names = None
        backend = self.policy.backend
        if isinstance(graphs, (list, tuple, MultiPlan)) \
                and backend == "sparse":
            raise ValueError(
                "the sparse backend evaluates one graph at a time — build "
                "one Engine per graph, or pack them on backend='dense' or "
                "'segment'")
        if isinstance(graphs, (list, tuple)):
            if not graphs:
                raise ValueError("need at least one graph or plan")
            graphs = pack_plans([_compiled(item, params) for item in graphs])
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
            raise ValueError("names= names the graphs of a packed engine; "
                             "pass a list of graphs or plans")
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
                             "SparsePlan, a MultiPlan or a list of graphs, "
                             f"got {type(graphs).__name__}")
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

    def run(self, scenarios, compute_lam: bool = True) -> Result:
        """One forward over ``scenarios``: T, and λ/ρ unless
        ``compute_lam=False``.  A packed engine takes one ScenarioBatch
        (broadcast to every graph) or one per graph, all of equal S."""
        batches = self._batches(scenarios)
        S = batches[0].S
        Sp = _bucket(S, lo=4)

        def padded(a):
            """[Sp, nc]: the scenario axis padded with copies of the last
            row (reference ``api.py:1082-1089``)."""
            out = np.repeat(a[-1:], Sp, axis=0)
            out[:S] = a
            return out

        Lmat = np.stack([padded(b.L) for b in batches])
        GSmat = np.stack([padded(b.gscale) for b in batches])
        segment = self.policy.backend == "segment"
        if self.multi is not None:
            fwd = (_eng.segment_forward_multi if segment
                   else _eng.dense_forward_multi)
        else:
            Lmat, GSmat = Lmat[0], GSmat[0]
            if segment:
                fwd = _eng.segment_forward
            elif self.sparse is None:
                fwd = _eng.dense_forward
            elif self.policy.float32:
                fwd = _eng.sparse_forward_f32
            else:
                fwd = _eng.sparse_forward_f64

        T, lam = fwd(self.arrays, torch.from_numpy(Lmat).to(self.device),
                     torch.from_numpy(GSmat).to(self.device), compute_lam)
        T = T[..., :S].double().cpu().numpy()
        rho = None
        if compute_lam:
            lam = lam[..., :S, :].double().cpu().numpy()
            L = np.stack([b.L for b in batches]).reshape(lam.shape)
            rho = np.where(T[..., None] > 0,
                           L * lam / np.maximum(T[..., None], 1e-300), 0.0)
        multi = self.multi is not None
        return Result(T=T, lam=lam, rho=rho,
                      scenarios=batches if multi else batches[0],
                      backend=self.policy.backend,
                      device=device_name(self.device),
                      axes=("G", "S") if multi else ("S",),
                      names=self.names)


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
