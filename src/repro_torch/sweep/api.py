"""The PyTorch package's sweep API: :class:`ExecPolicy`, :class:`Engine`,
:class:`Result`.

A reduced counterpart of the JAX package's ``repro/sweep/api.py``.  One
engine binds one graph (or compiled plan), stages the plan's tensors on its
device once, and evaluates scenario batches through the dense float32
forward or the sparse slot-list forwards of :mod:`.engine`:

    >>> eng = Engine(graph, params=p)                  # on the CUDA card
    >>> res = eng.run(scenarios=latency_grid(p, deltas))
    >>> res.T, res.lam, res.rho                        # [S], [S, nc], [S, nc]

A graph whose padded dense envelope exceeds the dense-size guard is
compiled to compact slot lists instead (with a warning), as the
reference's engine does.

Only the scenario axis S is populated in this slice; the candidate-cost
(K), structure (B) and graph (G) axes, the float64 segment backend,
sharding, finite-difference λ, the per-call backend override and the
result cache are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.device import DeviceLike, device_name, resolve_device

from . import engine as _eng
from .compile import (CompiledPlan, SparsePlan, _bucket, compile_plan,
                      compile_sparse, estimate_dense_bytes)
from .scenarios import ScenarioBatch


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """How a query executes.

    ``backend``
        "dense" — the (max,+) CUDA kernels over each level's padded 0/−1e30
        indicator, float32 accumulators, T and λ within 1e-5 relative of
        the float64 scalar engine (the reference's ``"pallas"`` backend).
        "sparse" — compact slot lists at O(nv + ne) memory instead of the
        padded dense envelope; the engine selects it by itself when a
        graph's estimated dense footprint exceeds the dense-size guard.
        The reference's "segment" backend is not ported yet and is refused.
    ``dtype``
        "auto" (the backend's own: dense → float32, sparse → float64),
        "float32" or "float64".  Sparse float64 is the plain PyTorch
        slot-list forward, T and λ bit-identical to the scalar engine;
        sparse float32 runs each level's reduction on the slot-list
        (max,+) CUDA kernel, within 1e-5 relative.  Dense computes float32
        only.
    ``max_dense_bytes``
        Per-engine override of :data:`Engine.MAX_DENSE_BYTES` (the
        dense→sparse threshold).  None defers to the
        ``REPRO_MAX_DENSE_BYTES`` environment variable, then the class
        attribute.
    """

    backend: str = "dense"
    dtype: str = "auto"
    max_dense_bytes: Optional[int] = None

    def validate(self) -> "ExecPolicy":
        if self.backend == "segment":
            raise ValueError(
                "backend 'segment' is not ported to the PyTorch package yet; "
                "use backend='dense' or 'sparse'")
        if self.backend not in ("dense", "sparse"):
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(use 'dense' or 'sparse')")
        if self.dtype not in ("auto", "float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r} "
                             "(use 'auto', 'float32' or 'float64')")
        if self.max_dense_bytes is not None \
                and int(self.max_dense_bytes) <= 0:
            raise ValueError("max_dense_bytes must be a positive byte "
                             f"count, got {self.max_dense_bytes!r}")
        if self.backend == "dense" and self.dtype == "float64":
            raise ValueError("backend 'dense' computes in float32; "
                             "dtype='float64' is not available on it")
        return self

    @property
    def float32(self) -> bool:
        """Whether the forward computes with float32 kernels."""
        return self.backend == "dense" or self.dtype == "float32"


@dataclasses.dataclass
class Result:
    """Sweep tensors over the scenario axis (float64 numpy)."""

    T: np.ndarray                    # [S] µs
    lam: Optional[np.ndarray]        # [S, nclass], or None (values-only run)
    rho: Optional[np.ndarray]        # [S, nclass], or None
    scenarios: ScenarioBatch
    backend: str
    device: str                      # name of the device the forward ran on

    @property
    def S(self) -> int:
        return int(self.T.shape[0])


class Engine:
    """Compile once, evaluate any number of scenario batches.

    ``graph_or_plan``: an ``ExecutionGraph`` (compiled with ``params``), a
    :class:`~repro_torch.sweep.compile.CompiledPlan` (dense) or a
    :class:`~repro_torch.sweep.compile.SparsePlan` (sparse).
    ``device=None`` runs on the CUDA card and raises without one;
    ``device="cpu"`` runs the kernels' plain PyTorch versions.

    The dense-size guard is ``policy.max_dense_bytes``, else the
    ``REPRO_MAX_DENSE_BYTES`` environment variable, else
    :data:`MAX_DENSE_BYTES`.  A graph whose estimated dense footprint
    (:func:`~repro_torch.sweep.compile.estimate_dense_bytes`, taken before
    anything dense is laid out) exceeds it compiles to slot lists: with
    dtype "auto" the engine warns and switches to sparse float64; with an
    explicit dtype "float32" it raises.  A dense plan over the guard is
    refused.
    """

    MAX_DENSE_BYTES = 256 << 20

    def __init__(self, graph_or_plan, params=None,
                 policy: Optional[ExecPolicy] = None,
                 device: DeviceLike = None):
        self.policy = (policy if policy is not None
                       else ExecPolicy()).validate()
        mdb = self.policy.max_dense_bytes
        if mdb is None:
            env = os.environ.get("REPRO_MAX_DENSE_BYTES", "")
            mdb = int(env) if env else None
        if mdb is not None:
            self.MAX_DENSE_BYTES = int(mdb)
        self.device = resolve_device(device)
        self.plan = self.sparse = None
        backend = self.policy.backend
        if isinstance(graph_or_plan, SparsePlan):
            if backend != "sparse":
                raise ValueError("a SparsePlan runs on backend='sparse'")
            self.sparse = graph_or_plan
        elif isinstance(graph_or_plan, CompiledPlan):
            if backend != "dense":
                raise ValueError(
                    "backend='sparse' takes an ExecutionGraph or a "
                    "SparsePlan (re-laying a dense plan is not ported)")
            self.plan = graph_or_plan
        elif isinstance(graph_or_plan, ExecutionGraph):
            if backend == "dense":
                est = estimate_dense_bytes(graph_or_plan)
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
                self.sparse = compile_sparse(graph_or_plan, params)
            else:
                self.plan = compile_plan(graph_or_plan, params)
        else:
            raise ValueError("need an ExecutionGraph, a CompiledPlan or a "
                             f"SparsePlan, got {type(graph_or_plan).__name__}")
        if self.sparse is not None:
            self.arrays = _eng.stage_sparse(
                self.sparse, self.device,
                torch.float32 if self.policy.float32 else torch.float64)
            return
        if self.plan.dense_bytes() > self.MAX_DENSE_BYTES:
            raise ValueError(
                f"the dense backend needs {self.plan.dense_bytes() >> 20} "
                f"MiB of plan tensors (> {self.MAX_DENSE_BYTES >> 20} MiB); "
                "compile the graph with backend='sparse' instead")
        self.arrays = _eng.stage(self.plan, self.device)

    @property
    def nclass(self) -> int:
        return (self.plan if self.plan is not None else self.sparse).nclass

    def run(self, scenarios: ScenarioBatch,
            compute_lam: bool = True) -> Result:
        """One forward over ``scenarios``: T, and λ/ρ unless
        ``compute_lam=False``."""
        if not isinstance(scenarios, ScenarioBatch):
            raise ValueError("scenarios must be a ScenarioBatch")
        if scenarios.nclass != self.nclass:
            raise ValueError(f"scenario batch has {scenarios.nclass} "
                             f"classes, graph has {self.nclass}")
        S = scenarios.S
        Sp = _bucket(S, lo=4)
        # pad the scenario axis with copies of the last row (api.py:1082-1089)
        Lmat = np.repeat(scenarios.L[-1:], Sp, axis=0)
        Lmat[:S] = scenarios.L
        GSmat = np.repeat(scenarios.gscale[-1:], Sp, axis=0)
        GSmat[:S] = scenarios.gscale

        if self.sparse is None:
            fwd, dt = _eng.dense_forward, np.float32
        else:
            dt = np.float64
            fwd = (_eng.sparse_forward_f32 if self.policy.float32
                   else _eng.sparse_forward_f64)

        def put(a):
            return torch.from_numpy(a.astype(dt)).to(self.device)

        T, lam = fwd(self.arrays, put(Lmat), put(GSmat), compute_lam)
        T = T[:S].double().cpu().numpy()
        rho = None
        if compute_lam:
            lam = lam[:S].double().cpu().numpy()
            rho = np.where(T[:, None] > 0,
                           scenarios.L * lam / np.maximum(T[:, None], 1e-300),
                           0.0)
        return Result(T=T, lam=lam, rho=rho, scenarios=scenarios,
                      backend=self.policy.backend,
                      device=device_name(self.device))
