"""Rank placement via LP sensitivity matrices (paper Appendix I/J, Alg. 3).

Heterogeneous LogGP: L and G become P×P matrices (here: generated from an
architecture topology Φ — e.g. intra-pod ICI vs cross-pod DCN).  Each
longest-path solve yields pairwise sensitivity matrices D_L (critical-path
message counts per rank pair) and D_G (bytes); Algorithm 3 greedily swaps
the rank pair with the best predicted gain, re-solves, and stops when the
objective stops improving.

The counterpart of the JAX package's ``repro/core/placement.py``: the
topology, the mapping helpers and the gain matrices are its numpy code,
copied, on the port's ``core.dag``; the batched loop runs its candidate
queries on the port's :class:`~repro_torch.sweep.api.Engine`.

``place(engine="scalar")`` — the reference loop: one ``core.dag`` forward
per step on the host, per-pair Python ``swap_gain`` scoring (O(P³) per
step).  A host oracle, asked for by name.

``place(engine="auto")`` (default, or ``"sweep"``) — the batched loop:
pairwise counts are aggregated over a *scenario grid* on the host, all P²
candidate swaps are scored at once from the vectorized gain matrix
(:func:`swap_gain_matrix`), and the top-k candidate mappings are evaluated
exactly in ONE engine query per greedy step.  With ``cost_eval="patch"``
(the default) the graph compiles ONCE and each step is one
``Engine.run(Query(scenarios, costs=[K, ne] extras, outputs=("T",)))``:
one level-loop launch of K lanes and no walk.  ``cost_eval="rebuild"``
compiles K plans a step and packs them on the graph axis G — the
equivalence reference, the same objectives bit for bit.

One departure from the reference: no engine fallback.  The reference's
``"auto"`` falls back to scalar re-solves on any engine error; here an
engine error reaches the caller, and ``stats["scalar_fallbacks"]`` is
always 0.  The backends are the port's: ``"segment"`` (float64, the
default) and ``"dense"`` (the float32 kernels, where the reference names
``"pallas"``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.device import DeviceLike

from . import dag
from .graph import ExecutionGraph
from .loggps import LogGPS

#: the batched loop's backends (the reference's "pallas" is "dense" here)
BACKENDS = ("segment", "dense")


@dataclasses.dataclass
class ArchTopology:
    """Φ: physical pairwise latency/bandwidth between processor slots."""

    L: np.ndarray   # (P, P) µs
    G: np.ndarray   # (P, P) µs/byte

    @staticmethod
    def two_tier(P: int, pod: int, L_fast: float = 1.0, L_slow: float = 10.0,
                 G_fast: float = 2e-5, G_slow: float = 4e-5) -> "ArchTopology":
        idx = np.arange(P)
        same = (idx[:, None] // pod) == (idx[None, :] // pod)
        L = np.where(same, L_fast, L_slow)
        G = np.where(same, G_fast, G_slow)
        np.fill_diagonal(L, 0.0)
        np.fill_diagonal(G, 0.0)
        return ArchTopology(L=L, G=G)


def evaluate_mapping(g: ExecutionGraph, params: LogGPS, phi: ArchTopology,
                     pi: np.ndarray, plan: Optional[dag.LevelPlan] = None):
    """Objective value (predicted runtime) for a process mapping π.

    π[i] = physical slot of rank i.  Message edges are re-costed with the
    pairwise L/G of the mapped slots (``extra_edge_cost`` keeps the graph
    immutable).  Build the graph with L=(0,), G=(0,) so that the mapped Φ
    cost is the whole network cost.
    """
    plan = plan or dag.LevelPlan(g)
    sched = plan.forward(params,
                         extra_edge_cost=mapping_edge_cost(plan.g, phi, pi))
    return sched, plan


def sensitivity_matrices(g: ExecutionGraph, sched, plan: dag.LevelPlan):
    """D_L, D_G from the critical path (Appendix I reduced costs)."""
    return plan.pairwise_counts(sched)


def mapping_edge_cost(g: ExecutionGraph, phi: ArchTopology,
                      pi: np.ndarray) -> np.ndarray:
    """Per-edge Φ link cost of mapping π, in *original* edge order — fed to
    ``dag.LevelPlan.forward(extra_edge_cost=)``,
    ``sweep.compile_plan(extra_edge_cost=)`` or a query's ``costs=``
    interchangeably."""
    is_msg = g.ebytes > 0
    ps, pd = pi[g.vrank[g.esrc]], pi[g.vrank[g.edst]]
    return np.where(is_msg,
                    phi.L[ps, pd] + phi.G[ps, pd] * np.maximum(g.ebytes - 1, 0),
                    0.0)


def swap_gain_matrix(D_L: np.ndarray, D_G: np.ndarray, pi: np.ndarray,
                     phi: ArchTopology) -> np.ndarray:
    """All-pairs first-order swap gains in one shot (vectorized Alg. 3 l.15).

    gain[i, j] = Σ_{k≠i,j} (A_ik − A_jk)(D_L,ik − D_L,jk)
                          + (B_ik − B_jk)(D_G,ik − D_G,jk)

    with A/B the mapped pairwise L/G — algebraically identical to summing
    :func:`swap_gain`'s old−new terms over both swap directions.  O(P³)
    memory/work as dense numpy.
    """
    A = phi.L[np.ix_(pi, pi)]
    B = phi.G[np.ix_(pi, pi)]
    dA = A[:, None, :] - A[None, :, :]          # [P, P, P] over (i, j, k)
    dL = D_L[:, None, :] - D_L[None, :, :]
    dB = B[:, None, :] - B[None, :, :]
    dG = D_G[:, None, :] - D_G[None, :, :]
    terms = dA * dL + dB * dG
    P = pi.shape[0]
    idx = np.arange(P)
    terms[idx, :, idx] = 0.0                    # k == i
    terms[:, idx, idx] = 0.0                    # k == j
    return terms.sum(axis=2)


def swap_gain(i: int, j: int, D_L: np.ndarray, D_G: np.ndarray,
              pi: np.ndarray, phi: ArchTopology) -> float:
    """Predicted runtime reduction from swapping ranks i and j (Alg. 3 l.15).

    First-order estimate: messages between (i,k) will traverse
    (π[j],π[k]) links after the swap; gain = Σ_k D[i,k]·(L_old − L_new) + …
    """
    P = D_L.shape[0]
    gain = 0.0
    for k in range(P):
        if k == i or k == j:
            continue
        for (a, b) in ((i, j), (j, i)):
            dl = D_L[a, k]
            db = D_G[a, k]
            if dl or db:
                old = phi.L[pi[a], pi[k]] * dl + phi.G[pi[a], pi[k]] * db
                new = phi.L[pi[b], pi[k]] * dl + phi.G[pi[b], pi[k]] * db
                gain += old - new
    return gain


def _select_swap(gains: np.ndarray) -> tuple:
    """The reference loop's pair selection: scan i<j in lexicographic order,
    keep the pair that beats the running best by >1e-12 (so fp-noise ties
    resolve identically to the scalar implementation)."""
    P = gains.shape[0]
    best, bi, bj = 0.0, -1, -1
    for i in range(P):
        for j in range(i + 1, P):
            gv = gains[i, j]
            if gv > best + 1e-12:
                best, bi, bj = gv, i, j
    return best, bi, bj


def _place_scalar(g, phi, params, pi0, max_iters, verbose):
    """Reference Algorithm 3 on the host (``core.dag``), kept verbatim."""
    P = g.nranks
    pi = np.arange(P) if pi0 is None else pi0.copy()
    plan = dag.LevelPlan(g)

    sched, plan = evaluate_mapping(g, params, phi, pi, plan)
    f_star = sched.T
    history = [f_star]
    prev_pi = pi.copy()

    for _ in range(max_iters):
        D_L, D_G = plan.pairwise_counts(sched)
        best, bi, bj = 0.0, -1, -1
        for i in range(P):
            for j in range(i + 1, P):
                gv = swap_gain(i, j, D_L, D_G, pi, phi)
                if gv > best + 1e-12:
                    best, bi, bj = gv, i, j
        if bi < 0:
            break  # no positive-gain swap (termination cond. 1)
        prev_pi = pi.copy()
        pi[bi], pi[bj] = pi[bj], pi[bi]
        sched, plan = evaluate_mapping(g, params, phi, pi, plan)
        f = sched.T
        if verbose:
            print(f"swap ({bi},{bj}) predicted_gain={best:.2f} T={f:.2f}")
        if f >= f_star - 1e-9:
            pi = prev_pi  # revert (termination cond. 2)
            sched, plan = evaluate_mapping(g, params, phi, pi, plan)
            break
        f_star = f
        history.append(f)
    return pi, history


def _candidate_objectives(g, scen_batch, extras, policy, device):
    """Rebuild-loop candidate evaluation (the equivalence reference): each
    candidate's Φ costs bake into a fresh CompiledPlan and the K plans pack
    onto the engine's graph axis G — one level-loop launch for all K."""
    from repro_torch.sweep import compile_plan
    from repro_torch.sweep.api import Engine

    plans = [compile_plan(g, extra_edge_cost=ex) for ex in extras]
    eng = Engine(plans, policy=dataclasses.replace(policy, cache=None),
                 device=device)
    res = eng.run(scen_batch, compute_lam=False)
    return res.T.mean(axis=1)                  # [K] mean over the grid


def _place_batched(g, phi, params, pi0, max_iters, verbose, scenario_points,
                   topk, policy, cost_eval="patch", stats=None, device=None):
    """Batched Algorithm 3: grid-aggregated D matrices, vectorized gains,
    one engine query per greedy step for exact candidate evaluation.

    ``cost_eval="patch"`` compiles ONE plan up front and runs a
    ``Query(costs=[K, ne] extras)`` against the warm engine per greedy step
    — zero plan recompiles after the first step, bit-identical objectives
    (and therefore final mapping) to ``cost_eval="rebuild"``.  ``stats`` (a
    dict, if given) is filled with the loop's cost accounting."""
    from repro_torch.sweep import ScenarioBatch, compile_plan
    from repro_torch.sweep.api import Engine, Query

    P = g.nranks
    pi = np.arange(P) if pi0 is None else pi0.copy()
    plan = dag.LevelPlan(g)
    pts = list(scenario_points) if scenario_points else [params]
    nc = g.nclass
    scen_batch = ScenarioBatch(
        L=np.asarray([pt.L for pt in pts], dtype=np.float64),
        gscale=np.ones((len(pts), nc)))
    st = stats if stats is not None else {}
    st.update({"cost_eval": cost_eval, "steps": 0, "plan_compiles": 0,
               "engine_calls": 0, "candidates": 0, "scalar_fallbacks": 0})

    eng = None
    if cost_eval == "patch":
        base_plan = compile_plan(g)
        st["plan_compiles"] += 1
        eng = Engine(base_plan, policy=policy, device=device)

    def forwards(pi_):
        ex = mapping_edge_cost(g, phi, pi_)
        return [plan.forward(pt, extra_edge_cost=ex) for pt in pts]

    scheds = forwards(pi)
    f_star = float(np.mean([s.T for s in scheds]))
    history = [f_star]

    for _ in range(max_iters):
        D_L = np.zeros((P, P))
        D_G = np.zeros((P, P))
        for s in scheds:                       # grid-aggregated sensitivities
            dl, dgm = plan.pairwise_counts(s)
            D_L += dl
            D_G += dgm
        D_L /= len(scheds)
        D_G /= len(scheds)
        gains = swap_gain_matrix(D_L, D_G, pi, phi)
        best, bi, bj = _select_swap(gains)
        if bi < 0:
            break  # no positive-gain swap (termination cond. 1)
        # top-k predicted swaps, best-first (k=1 ≡ the reference loop)
        iu, ju = np.triu_indices(P, k=1)
        order = np.argsort(-gains[iu, ju], kind="stable")
        cand = [(bi, bj)]
        for o in order[:max(int(topk), 1)]:
            pair = (int(iu[o]), int(ju[o]))
            if pair != (bi, bj) and len(cand) < max(int(topk), 1):
                cand.append(pair)
        extras = []
        for (ci, cj) in cand:
            pc = pi.copy()
            pc[ci], pc[cj] = pc[cj], pc[ci]
            extras.append(mapping_edge_cost(g, phi, pc))
        st["candidates"] += len(cand)
        if eng is not None:
            # K candidate cost blocks through the once-compiled plan: one
            # level-loop launch of K lanes, no walk
            res = eng.run(Query(scenarios=scen_batch, costs=np.stack(extras),
                                outputs=("T",)))
            fs = res.T.mean(axis=1)
        else:
            fs = _candidate_objectives(g, scen_batch, extras, policy, device)
            st["plan_compiles"] += len(extras)
        st["engine_calls"] += 1
        k = int(np.argmin(fs))
        f = float(fs[k])
        if verbose:
            print(f"swap {cand[k]} predicted_gain={best:.2f} T={f:.2f} "
                  f"(evaluated {len(cand)} candidates)")
        if f >= f_star - 1e-9:
            break  # best candidate doesn't improve (termination cond. 2)
        ci, cj = cand[k]
        pi[ci], pi[cj] = pi[cj], pi[ci]
        scheds = forwards(pi)
        f_star = f
        history.append(f)
        st["steps"] += 1
    return pi, history


def place(g: ExecutionGraph, phi: ArchTopology, params: Optional[LogGPS] = None,
          pi0: Optional[np.ndarray] = None, max_iters: int = 64,
          verbose: bool = False, engine: str = "auto",
          scenarios: Optional[Sequence[LogGPS]] = None,
          topk: int = 1, backend: str = "segment",
          cost_eval: str = "patch", cache=None,
          stats: Optional[dict] = None,
          policy=None, device: DeviceLike = None,
          shard=None) -> tuple[np.ndarray, list]:
    """Algorithm 3. Returns (mapping, history of objective values).

    The graph should be built with zero link costs (L=(0,), G=(0,)) so that
    all network cost comes from Φ via the mapping.

    ``engine="auto"`` (default) or ``"sweep"`` runs the batched loop on the
    port's engine (on ``device``: the CUDA card unless ``device="cpu"``):
    swap gains for all P² pairs come from one vectorized gain matrix,
    candidate mappings are verified in one engine query per greedy step,
    and ``scenarios`` (a sequence of LogGPS points, e.g.
    ``latency_points(params, deltas)``) aggregates the sensitivity matrices
    over a grid instead of the single build-time point.  Defaults (single
    point, ``topk=1``) reproduce the reference loop exactly;
    ``engine="scalar"`` runs the reference loop on the host.  An engine
    error reaches the caller: there is no fallback to the host loop.

    ``cost_eval="patch"`` (default) is the zero-recompile path;
    ``cost_eval="rebuild"`` recompiles K plans per step (the equivalence
    reference — same objectives bit for bit, so the same final mapping).
    ``backend`` picks the evaluator, ``"segment"`` (float64, bit-equal to
    ``core.dag``) or ``"dense"`` (the float32 kernels; the reference's
    ``"pallas"``); ``cache`` (a ``SweepCache``) memoizes candidate
    evaluations across repeated queries; ``stats`` (a dict) receives the
    loop's cost accounting — plan_compiles, engine_calls, candidates,
    steps, and scalar_fallbacks (always 0).

    ``policy`` (a :class:`repro_torch.sweep.api.ExecPolicy`) supersedes
    the loose ``backend``/``cache`` kwargs when given; the candidate
    queries run under it wholesale, device sharding included
    (``policy.shard`` / ``shard_axis``, e.g. over the candidate axis "K").
    ``shard`` overrides the policy's: the engine splits each step's query
    over the local devices (:meth:`repro_torch.sweep.api.Engine.run`),
    bit-identical to the unsplit query.
    """
    from repro_torch.sweep.api import ExecPolicy

    if engine not in ("auto", "scalar", "sweep"):
        raise ValueError(f"engine must be 'auto', 'scalar' or 'sweep', "
                         f"got {engine!r}")
    if cost_eval not in ("patch", "rebuild"):
        raise ValueError(f"cost_eval must be 'patch' or 'rebuild', "
                         f"got {cost_eval!r}")
    if policy is not None:
        backend = policy.backend
    if backend not in BACKENDS:
        raise ValueError(f"backend must be 'segment' or 'dense', "
                         f"got {backend!r}")
    params = params or LogGPS(L=(0.0,), G=(0.0,), o=0.5, S=1e18)
    if engine == "scalar":
        if scenarios is not None or topk != 1:
            raise ValueError("scenario grids / topk need the batched engine")
        return _place_scalar(g, phi, params, pi0, max_iters, verbose)
    pol = (policy if policy is not None
           else ExecPolicy(backend=backend, cache=cache)).validate()
    if shard is not None:
        pol = pol.replace(shard=shard)
    return _place_batched(g, phi, params, pi0, max_iters, verbose,
                          scenarios, topk, pol, cost_eval=cost_eval,
                          stats=stats, device=device)


def latency_points(params: LogGPS, deltas: Sequence[float],
                   cls: int = 0) -> list:
    """ΔL grid as LogGPS points — the ``scenarios=`` axis of :func:`place`."""
    return [params.with_delta(float(d), cls) for d in deltas]


def block_mapping(P: int) -> np.ndarray:
    """Default scheme the paper compares against (ranks in order)."""
    return np.arange(P)


def random_mapping(P: int, rng) -> np.ndarray:
    """A uniformly random rank→slot permutation from an EXPLICIT stream.

    ``rng`` is an int seed or ``numpy.random.Generator``
    (:func:`repro_torch.core.rng.as_rng`; ``None`` raises) — search
    trajectories must be bit-reproducible from their seed alone, so the
    global ``np.random`` state is never consulted.
    """
    from .rng import as_rng
    return as_rng(rng).permutation(int(P))


def volume_greedy_mapping(g: ExecutionGraph, phi: ArchTopology) -> np.ndarray:
    """Scotch-like baseline: group heavy-traffic rank pairs onto fast links,
    using *total* traffic volume (ignores temporal structure — the paper's
    point is that this can mis-rank placements)."""
    P = g.nranks
    vol = np.zeros((P, P))
    msg = g.ebytes > 0
    np.add.at(vol, (g.vrank[g.esrc[msg]], g.vrank[g.edst[msg]]), g.ebytes[msg])
    vol = vol + vol.T
    order = np.argsort(-vol.sum(axis=1))
    pi = np.empty(P, dtype=int)
    pi[order] = np.arange(P)
    return pi
