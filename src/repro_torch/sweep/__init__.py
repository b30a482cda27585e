"""Batched scenario sweeps on the (max,+) CUDA kernels.

    compile.compile_plan   — graph → padded per-level tensors (dense)
    compile.pack_plans     — G plans → one MultiPlan on their common envelope
    compile.CostBatch      — K candidate cost blocks (plan.patch_costs)
    compile.StructureBatch — B structural variants (plan.patch_structure,
                             StructureBatch.from_plans)
    compile.compile_sparse — graph → compact slot lists (sparse)
    scenarios              — ScenarioBatch / latency_grid / bandwidth_grid /
                             cartesian_grid / sample_grid,
                             collective_variants / topology_variants,
                             the fault families and fault_axes
    api.Engine / Query     — stage once, run queries over the G|B, K and S
                             axes (T, λ, ρ); api.run, the detached engine
    cache.SweepCache       — the content-addressed result cache
    engine                 — the dense, packed, sparse and segment forwards,
                             the congestion fixed point,
                             tolerance_batched, breakpoints_batched
"""

from .api import (Engine, ExecPolicy, Query, Result,  # noqa: F401
                  detached_engine, detached_engine_stats, run)
from .cache import (DEFAULT_CACHE, CacheStats, SweepCache,  # noqa: F401
                    canonical_bytes, graph_content_key, query_key,
                    result_key)
from .compile import (CompiledPlan, CostBatch, MultiPlan,  # noqa: F401
                      SparsePlan, StructureBatch, compile_plan,
                      compile_sparse, estimate_dense_bytes, group_plans,
                      pack_plans, repad_plan)
from .engine import breakpoints_batched, tolerance_batched  # noqa: F401
from .scenarios import (DeviceFault, FaultAxes, GraphVariant,  # noqa: F401
                        LinkFault, ScenarioBatch, StragglerFault,
                        bandwidth_grid, base_batch, cartesian_grid,
                        collective_variants, fault_axes, latency_grid,
                        recovery_cost_us, sample_grid, topology_variants)
