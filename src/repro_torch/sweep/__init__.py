"""Batched scenario sweeps on the (max,+) CUDA kernels.

    compile.compile_plan   — graph → padded per-level tensors (dense)
    compile.compile_sparse — graph → compact slot lists (sparse)
    scenarios              — ScenarioBatch / latency_grid / bandwidth_grid
    api.Engine             — stage once, run scenario batches (T, λ, ρ)
    engine                 — the dense and sparse forwards, tolerance_batched
"""

from .api import Engine, ExecPolicy, Result  # noqa: F401
from .compile import (CompiledPlan, SparsePlan, compile_plan,  # noqa: F401
                      compile_sparse, estimate_dense_bytes)
from .engine import tolerance_batched  # noqa: F401
from .scenarios import (ScenarioBatch, bandwidth_grid, base_batch,  # noqa: F401
                        latency_grid)
