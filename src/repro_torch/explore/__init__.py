"""repro_torch.explore — design-space exploration on top of the sweep engine.

The sweep engine answers "evaluate THESE B×K×S points"; this package
turns it into a gym that answers "FIND the best design".  Four pieces:

* :mod:`~repro_torch.explore.space` — declarative :class:`DesignSpace`
  (categorical / int / log-float dims, named validity constraints,
  deterministic encode/decode, explicit-rng sampling and mutation);
* :mod:`~repro_torch.explore.stamp` — the :class:`Stamper` lowers a whole
  generation of candidates onto the engine's existing axes (rewirings →
  ``patch_structure`` B-rows, cost deltas → ``patch_costs`` K-rows,
  shape-distinct designs → per-bucket ``from_plans`` packs), so one
  generation is a handful of packed dispatches, not N solo runs;
* :mod:`~repro_torch.explore.objectives` — vectorized scalarization of
  ``T[N, S]`` / ``λ`` (robust quantiles, latency tolerance, expected
  slowdown), bit-identical packed vs. solo;
* :mod:`~repro_torch.explore.search` — ask/tell searchers (random,
  regularized evolution, successive halving) and the
  :func:`~repro_torch.explore.search.run_search` generation loop with
  deterministic JSON-lines trajectories and ``explore_*`` metrics.

Quick start::

    from repro_torch import explore

    space, lower = explore.preset("codesign", P=16, iters=3)
    scen = sample_grid(params, 50, rng=0, lat_deltas=(0.0, 100.0))
    s = explore.RegularizedEvolution(space, seed=7, population_size=32)
    res = explore.run_search(s, lower, scen, generations=8, population=32)
    res.best, res.best_objective

The counterpart of the JAX package's ``repro/explore`` on the port's
engine (pass ``device="cpu"`` to the :class:`Stamper` off the card).  One
departure: the reference's engines name its shared result cache by
default; the port's have none, so the stamper owns a named
:class:`~repro_torch.sweep.cache.SweepCache` that ``use_cache=True``
uses (a repeated generation is then served with no launch).
"""

from .objectives import ObjectiveSpec, Term, robust_makespan  # noqa: F401
from .presets import PRESETS, codesign_space, lower_codesign, preset  # noqa: F401
from .search import (SEARCHERS, RandomSearch,  # noqa: F401
                     RegularizedEvolution, Searcher, SearchResult,
                     SuccessiveHalving, make_searcher, run_search)
from .space import (Categorical, DesignSpace, Dim, IntDim,  # noqa: F401
                    LogFloat)
from .stamp import EvalBatch, Lowered, StampInfo, Stamper, solo_objective  # noqa: F401
