"""Ready-made design spaces + lowering callbacks for the search loop.

The co-design preset searches the knobs the paper's case studies turn by
hand — parallelism split, collective algorithm, process placement — over
the CG-like synthetic proxy app on a two-tier (pod) topology:

``px`` × ``py``
    the 2-D domain decomposition, constrained to ``px * py == P``
    (changes graph SHAPE → the stamper's pack lane);
``algo``
    the allreduce algorithm for the dot products (shape again);
``mapping`` / ``place_seed``
    ``block`` keeps ranks pod-contiguous (near-optimal on a two-tier Φ,
    no extra cost array); ``random`` draws the permutation from
    ``place_seed`` and re-costs message edges via
    :func:`~repro_torch.core.placement.mapping_edge_cost` (cost-only delta →
    the stamper's cost lane).  ``place_seed`` is deliberately a TRAP
    dimension under ``block`` — it changes nothing, and the lowering
    dedupes those candidates to a single evaluation.

Lowering is content-memoized per (px, py, algo) so re-visiting a split
costs a dict lookup, not a Python graph rebuild.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.core import synth
from repro_torch.core.collectives import ALGORITHMS
from repro_torch.core.loggps import LogGPS
from repro_torch.core.placement import (ArchTopology, block_mapping,
                                  mapping_edge_cost, random_mapping)

from .space import Categorical, DesignSpace, IntDim
from .stamp import Lowered


def _splits(P: int) -> tuple:
    return tuple((d, P // d) for d in range(1, P + 1) if P % d == 0)


def codesign_space(P: int = 16) -> DesignSpace:
    """Split × collective × placement space for :func:`lower_codesign`."""
    pow2 = (P & (P - 1)) == 0 and P > 0
    algos = ALGORITHMS if pow2 else ("ring", "bidir_ring")
    return DesignSpace(
        dims=(
            Categorical("px", tuple(s[0] for s in _splits(P))),
            Categorical("py", tuple(s[1] for s in _splits(P))),
            Categorical("algo", algos),
            Categorical("mapping", ("block", "random")),
            IntDim("place_seed", 0, 4095),
        ),
        constraints=(
            ("px*py==P", lambda c: c["px"] * c["py"] == P),
        ),
    )


def lower_codesign(P: int = 16, iters: int = 3, *, pod: int = 4,
                   halo_bytes: float = 32e3, comp_us: float = 800.0,
                   params: LogGPS = None,
                   phi=None) -> Callable[[dict], Lowered]:
    """Candidate dict → :class:`Lowered` for the co-design space.

    ``phi`` defaults to a two-tier pod topology; pass ``"ideal"`` for a
    placement-free network (every candidate then lowers without an extra
    cost array — the stamper's pack lane end to end).
    """
    params = params if params is not None else LogGPS()
    if phi is None:
        phi = ArchTopology.two_tier(P, pod)
    elif phi == "ideal":
        phi = None
    graphs = {}

    def lower(cand: dict) -> Lowered:
        gk = (cand["px"], cand["py"], cand["algo"])
        g = graphs.get(gk)
        if g is None:
            g = graphs[gk] = synth.cg_like(
                cand["px"], cand["py"], iters, halo_bytes=halo_bytes,
                comp_us=comp_us, params=params,
                allreduce_algo=cand["algo"])
        extra = None
        if phi is not None:
            if cand["mapping"] == "block":
                pi = block_mapping(P)
            else:
                pi = random_mapping(P, int(cand["place_seed"]))
            extra = mapping_edge_cost(g, phi, pi)
            # an all-zero extra is no delta at all — drop it so the
            # candidate shares the plain plan (pack lane)
            if not np.any(extra):
                extra = None
        return Lowered(graph=g, params=params, extra_edge_cost=extra,
                       meta=dict(cand))

    return lower


PRESETS = {"codesign": (codesign_space, lower_codesign)}


def preset(name: str, P: int = 16, iters: int = 3, **kw):
    """(space, lower) pair for a named preset — the analysis-service hook."""
    try:
        mk_space, mk_lower = PRESETS[name]
    except KeyError:
        raise ValueError(f"unknown explore preset {name!r} "
                         f"(one of {sorted(PRESETS)})") from None
    return mk_space(P), mk_lower(P, iters, **kw)
