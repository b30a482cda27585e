"""The PyTorch package's sweep API: :class:`ExecPolicy`, :class:`Engine`,
:class:`Result`.

A reduced counterpart of the JAX package's ``repro/sweep/api.py``.  One
engine binds one graph (or compiled plan), stages the plan's tensors on its
device once, and evaluates scenario batches through the dense float32
forward of :mod:`.engine`:

    >>> eng = Engine(graph, params=p)                  # on the CUDA card
    >>> res = eng.run(scenarios=latency_grid(p, deltas))
    >>> res.T, res.lam, res.rho                        # [S], [S, nc], [S, nc]

Only the scenario axis S is populated in this slice; the candidate-cost
(K), structure (B) and graph (G) axes, the float64 segment and the sparse
backends, sharding, finite-difference λ and the result cache are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import ExecutionGraph
from repro_torch.device import DeviceLike, device_name, resolve_device

from . import engine as _eng
from .compile import CompiledPlan, _bucket, compile_plan
from .scenarios import ScenarioBatch

_NOT_PORTED = ("segment", "sparse")


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """How a query executes.

    ``backend``
        "dense" — the (max,+) CUDA kernels over each level's padded 0/−1e30
        indicator, float32 accumulators, T and λ within 1e-5 relative of
        the float64 scalar engine.  The counterpart of the reference's
        ``"pallas"`` backend.  The reference's "segment" and "sparse"
        backends are not ported yet and are refused.
    """

    backend: str = "dense"

    def validate(self) -> "ExecPolicy":
        if self.backend in _NOT_PORTED:
            raise ValueError(
                f"backend {self.backend!r} is not ported to the PyTorch "
                "package yet; use backend='dense'")
        if self.backend != "dense":
            raise ValueError(f"unknown backend {self.backend!r} "
                             "(use 'dense')")
        return self


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

    ``graph_or_plan``: an ``ExecutionGraph`` (compiled with ``params``) or
    a :class:`~repro_torch.sweep.compile.CompiledPlan`.  ``device=None``
    runs on the CUDA card and raises without one; ``device="cpu"`` runs the
    kernels' plain PyTorch versions.

    The plan's padded dense footprint must stay within
    :data:`MAX_DENSE_BYTES` (the reference's dense-size guard).
    """

    MAX_DENSE_BYTES = 256 << 20

    def __init__(self, graph_or_plan, params=None,
                 policy: Optional[ExecPolicy] = None,
                 device: DeviceLike = None):
        self.policy = (policy if policy is not None
                       else ExecPolicy()).validate()
        self.device = resolve_device(device)
        if isinstance(graph_or_plan, CompiledPlan):
            self.plan = graph_or_plan
        elif isinstance(graph_or_plan, ExecutionGraph):
            self.plan = compile_plan(graph_or_plan, params)
        else:
            raise ValueError("need an ExecutionGraph or a CompiledPlan, got "
                             f"{type(graph_or_plan).__name__}")
        if self.plan.dense_bytes() > self.MAX_DENSE_BYTES:
            raise ValueError(
                f"the dense backend needs {self.plan.dense_bytes() >> 20} "
                f"MiB of plan tensors (> {self.MAX_DENSE_BYTES >> 20} MiB); "
                "the sparse backend that takes such graphs is not ported yet")
        self.arrays = _eng.stage(self.plan, self.device)

    @property
    def nclass(self) -> int:
        return self.plan.nclass

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

        def put(a):
            return torch.from_numpy(a.astype(np.float32)).to(self.device)

        T, lam = _eng.dense_forward(self.arrays, put(Lmat), put(GSmat),
                                    compute_lam)
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
