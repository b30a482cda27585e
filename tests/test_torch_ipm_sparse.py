"""The sparse Newton route of the PyTorch package's IPM
(``repro_torch.core.ipm.SparseNewton``) and its tree kernels
(``repro_torch.kernels.ipm``).

* ``tree_factor`` / ``tree_solve``'s plain versions against a dense
  ``torch.linalg.solve`` of the explicit preconditioner P on random
  forests (rtol 1e-10: P is strictly diagonally dominant, its condition
  number below ~10³ here).
* The sparse route, reached through the private seam ``ipm._solve(...,
  newton=SparseNewton)``, on ``test_torch_lp.py``'s seven workloads:
  against ``core.dag`` (T and λ within 1e-5 relative, as the dense route
  is held), against the dense route (T within 1e-7 relative: the PCG stops
  at a relative residual of 1e-10, and the iterates then differ from the
  dense route's in the last digits), and against the reference's IPM and
  HiGHS: no farther from HiGHS than the reference's IPM, up to one part in
  10¹² of T (on ``stencil2c`` the reference and the dense route land on the
  same T, and the PCG's rounding moves the sparse route's by ~5e-16).
* ``tolerance_lp`` on the sparse route against ``core.dag.tolerance``
  (1e-5), the route chosen from n alone, the shape check's ``ValueError``
  and the PCG limit's ``RuntimeError``.

The ``gpu`` tests hold the kernels bit for bit against their plain
versions on the card, one launch each (forests whose hubs' children lie
past the window, levels wider than a ring slot, the block and the window,
one position a level, one level, no position; R 1, 2 and 3), and the
card's sparse route against the CPU's
(T within 1e-8 relative, λ within 1e-6: M₁₁·v sums with cuSPARSE, in
another order than the CPU).  The JAX package is imported inside a
fixture: the card's machine has none.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import dag, ipm, loggps, lp, synth
from repro_torch.kernels.ipm import (Forest, tree_factor, tree_factor_ref,
                                     tree_solve, tree_solve_ref)

WORKLOADS = ("stencil2d", "cg", "sweep", "allreduce_ring", "allreduce_rd",
             "pipeline", "stencil2c")
SEEDS = (0, 1, 2, 3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain sweeps launch thousands of tiny tensor operations, which
    intra-op threads only slow down (and which take every core of the
    machine from the other test workers): one thread for this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build(name, S, L):
    """``tests/test_torch_lp.py``'s workloads."""
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    p2 = L.pod_model(pod_size=2).params()
    return {
        "stencil2d": lambda: (S.stencil2d(3, 3, 4, params=p), p),
        "cg": lambda: (S.cg_like(2, 2, 3, params=p), p),
        "sweep": lambda: (S.sweep2d(3, 3, 2, params=p), p),
        "allreduce_ring": lambda: (
            S.allreduce_chain(8, 3, params=p, algo="ring"), p),
        "allreduce_rd": lambda: (S.allreduce_chain(
            8, 3, params=p, algo="recursive_doubling"), p),
        "pipeline": lambda: (S.ring_pipeline(5, 4, params=p), p),
        "stencil2c": lambda: (S.stencil2d(2, 2, 3, params=p2), p2),
    }[name]()


def random_forest(seed: int, device="cpu", nv: int = 300, nlv: int = 24):
    """A forest in level order (parents on lower levels, some roots above
    level 0, some vertices with many children) and a diagonal that makes
    P strictly diagonally dominant: (forest, diag, the dense P, or None
    past 5,000 positions)."""
    rng = np.random.default_rng(seed)
    level = np.sort(np.concatenate([np.arange(nlv),
                                    rng.integers(0, nlv, nv - nlv)]))
    levels = np.searchsorted(level, np.arange(nlv + 1))
    parent = np.full(nv, -1, dtype=np.int64)
    for v in range(levels[1], nv):
        if rng.random() < 0.9:
            hub = rng.random() < 0.3     # many children on level 0's
            parent[v] = rng.integers(0, levels[1 if hub else level[v]])
    w = np.where(parent >= 0, rng.uniform(0.1, 50.0, nv), 0.0)
    off = np.zeros(nv)
    np.add.at(off, parent[parent >= 0], w[parent >= 0])
    diag = w + off + rng.uniform(0.01, 1.0, nv)
    kid = np.flatnonzero(parent >= 0)
    P = None
    if nv <= 5000:
        P = np.diag(diag)
        P[kid, parent[kid]] -= w[kid]
        P[parent[kid], kid] -= w[kid]
    ch = kid[np.argsort(parent[kid], kind="stable")]
    ch_ptr = np.zeros(nv + 1, dtype=np.int64)
    np.cumsum(np.bincount(parent[kid], minlength=nv), out=ch_ptr[1:])
    put = lambda a, t: torch.as_tensor(a, dtype=t, device=device)  # noqa: E731
    f = Forest(put(parent, torch.int32), put(w, torch.float64),
               put(ch_ptr, torch.int32), put(ch, torch.int32),
               put(levels, torch.int32), tuple(int(x) for x in levels))
    return f, put(diag, torch.float64), P


@pytest.mark.parametrize("R", (1, 3))
@pytest.mark.parametrize("seed", SEEDS)
def test_tree_plain_versions_against_dense_solve(seed, R):
    f, diag, P = random_forest(seed)
    piv, g = tree_factor(f, diag)
    np.testing.assert_array_equal(piv.numpy(), tree_factor_ref(f, diag)[0])
    r = torch.from_numpy(np.random.default_rng(seed + 10).standard_normal(
        (f.nv, R)))
    x = tree_solve(f, piv, g, r)
    want = torch.linalg.solve(torch.from_numpy(P), r)
    np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))
    # the pivots are those of P's LDLᵀ, so their product is det P
    assert float(torch.log(piv).sum()) == pytest.approx(
        float(np.linalg.slogdet(P)[1]), rel=1e-10)


@pytest.fixture(scope="module", params=WORKLOADS)
def solved(request):
    """A workload, its makespan LP and the LP on the sparse route (CPU)."""
    g, p = build(request.param, synth, loggps)
    prob = lp.build_lp(g, p)
    sol = ipm._solve(prob, torch.device("cpu"), newton=ipm.SparseNewton)
    return request.param, g, p, prob, sol


def test_sparse_route_against_dag(solved):
    _, g, p, _, sol = solved
    s = dag.evaluate(g, p)
    assert sol.status == "optimal" and sol.device == "cpu"
    assert sol.T == pytest.approx(s.T, rel=1e-5)
    np.testing.assert_allclose(sol.lam, s.lam, rtol=1e-5)
    # a predictor and a corrector PCG every iteration but the last
    assert len(sol.pcg_steps) == 2 * (sol.iterations - 1)
    assert min(sol.pcg_steps) >= 1


def test_sparse_route_against_dense_route(solved):
    _, _, _, prob, sol = solved
    dense = ipm._solve(prob, torch.device("cpu"), newton=ipm.NewtonSystem)
    assert dense.pcg_steps is None
    assert sol.T == pytest.approx(dense.T, rel=1e-7)
    np.testing.assert_allclose(sol.lam, dense.lam, rtol=1e-7)
    assert abs(sol.iterations - dense.iterations) <= 1


def test_sparse_route_against_reference_and_highs(solved):
    from repro.core import ipm as ref_ipm, loggps as ref_loggps
    from repro.core import lp as ref_lp, synth as ref_synth
    name, _, _, _, sol = solved
    g_ref, p_ref = build(name, ref_synth, ref_loggps)
    highs = ref_lp.predict_runtime(g_ref, p_ref, solver="highs")
    ref = ref_ipm.solve_ipm(ref_lp.build_lp(g_ref, p_ref))
    assert abs(sol.T - highs.T) <= abs(ref.T - highs.T) + 1e-12 * abs(highs.T)
    assert sol.iterations <= ref.iterations + 2


def test_sparse_route_tolerance_lp_against_dag(solved, monkeypatch):
    """Every LP past a zero cap: both of ``tolerance_lp``'s LPs take the
    sparse route."""
    _, g, p, _, _ = solved
    monkeypatch.setattr(ipm, "MAX_NEWTON_BYTES", 0)
    for cls in range(p.nclass):
        want = dag.tolerance(g, p, 0.01, cls=cls)
        got = lp.tolerance_lp(g, p, 0.01, cls=cls, device="cpu")
        assert got == pytest.approx(want, rel=1e-5), cls


def test_route_chosen_from_n(monkeypatch):
    """Up to the cap the dense route, past it the sparse one, with no
    argument: ``predict_runtime`` answers on both."""
    g, p = build("cg", synth, loggps)
    n = lp.build_lp(g, p).nvars
    s = dag.evaluate(g, p)
    dense = lp.predict_runtime(g, p, device="cpu")
    monkeypatch.setattr(ipm, "MAX_NEWTON_BYTES", ipm.newton_bytes(n))
    assert lp.predict_runtime(g, p, device="cpu").pcg_steps is None
    monkeypatch.setattr(ipm, "MAX_NEWTON_BYTES", ipm.newton_bytes(n) - 1)
    sparse = lp.predict_runtime(g, p, device="cpu")
    assert dense.pcg_steps is None and sparse.pcg_steps
    assert sparse.status == "optimal"
    assert sparse.T == pytest.approx(s.T, rel=1e-5)
    assert sparse.T == pytest.approx(dense.T, rel=1e-7)


def test_shape_check_names_the_first_bad_row():
    g, p = build("pipeline", synth, loggps)
    A, _, _ = ipm._fold_bounds(lp.build_lp(g, p))
    nc, cpu = p.nclass, torch.device("cpu")
    ipm.SparseNewton(A, cpu, nc)                 # Algorithm 1's shape
    bad = A.tolil()
    bad[5, nc + 7] = 1.0                         # a third vertex entry
    bad[9, :] = 0.0
    bad[9, nc], bad[9, nc + 1] = 1.0, 1.0        # two sources
    with pytest.raises(ValueError, match=r"^row 5 of the folded"):
        ipm.SparseNewton(bad.tocsr(), cpu, nc)
    # a vertex column with no bound row
    keep = np.ones(A.shape[0], dtype=bool)
    keep[A.shape[0] - A.shape[1] + nc + 3] = False   # t_3's lower bound
    with pytest.raises(ValueError, match=f"vertex column {nc + 3} has no "
                       "bound row"):
        ipm.SparseNewton(A[keep], cpu, nc)
    # a cycle among the arcs
    cyc = sp.csr_matrix(np.array([[0, 1, -1, 0], [0, -1, 1, 0],
                                  [0, -1, 0, 0], [0, 0, -1, 0],
                                  [0, 0, 0, -1], [-1, 0, 0, 0]], float))
    with pytest.raises(ValueError, match="cycle"):
        ipm.SparseNewton(cyc, cpu, 1)


def test_pcg_step_limit_raises(monkeypatch):
    g, p = build("sweep", synth, loggps)
    monkeypatch.setattr(ipm, "PCG_MAX_STEPS", 1)
    with pytest.raises(RuntimeError, match=r"PCG of IPM iteration 1: lane "
                       r"\d of 2 is at relative residual .* after 1 steps"):
        ipm._solve(lp.build_lp(g, p), torch.device("cpu"),
                   newton=ipm.SparseNewton)


def empty_forest(device):
    """A forest of no position and no level: (forest, diag)."""
    z = lambda n, t: torch.zeros(n, dtype=t, device=device)  # noqa: E731
    return (Forest(z(0, torch.int32), z(0, torch.float64), z(1, torch.int32),
                   z(0, torch.int32), z(1, torch.int32), (0,)),
            z(0, torch.float64))


# the card's cases: (nv, nlv) of random_forest, or None for no position.
# 60,000 positions put hubs' children farther back than the window (16,384
# positions on an H100) and 2 levels make a level wider than it; 3 levels
# of 5,000 are wider than a ring slot (512 positions) and than the block
CARD_FORESTS = {"random": (5000, 300), "hubs past the window": (60000, 300),
                "wide levels": (5000, 3), "wider than the window": (60000, 2),
                "one position a level": (3000, 3000), "one level": (500, 1),
                "no position": None}


@pytest.mark.gpu
@pytest.mark.parametrize("R", (1, 2, 3))
@pytest.mark.parametrize("case", CARD_FORESTS)
def test_tree_kernels_bit_equal_on_card(case, R):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.ipm import ops, stage
    W = ops.window_positions()
    for seed in SEEDS:
        if CARD_FORESTS[case] is None:
            f, diag = empty_forest("cuda")
        else:
            nv, nlv = CARD_FORESTS[case]
            f, diag, _ = random_forest(seed, "cuda", nv=nv, nlv=nlv)
        if case == "hubs past the window":
            misses = stage.window_misses(f, W)
            assert misses["up"] > 0 and misses["down"] > 0, misses
        n0, m0 = tree_factor.launches, tree_solve.launches
        piv, g = tree_factor(f, diag)
        piv_r, g_r = tree_factor_ref(f, diag)
        assert torch.equal(piv, piv_r) and torch.equal(g, g_r)
        r = torch.randn(f.nv, R, dtype=torch.float64, device="cuda")
        assert torch.equal(tree_solve(f, piv, g, r),
                           tree_solve_ref(f, piv, g, r))
        torch.cuda.synchronize()
        assert (tree_factor.launches - n0, tree_solve.launches - m0) == (1, 1)


@pytest.mark.gpu
def test_sparse_route_card_against_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in WORKLOADS:
        g, p = build(name, synth, loggps)
        prob = lp.build_lp(g, p)
        card = ipm._solve(prob, torch.device("cuda"),
                          newton=ipm.SparseNewton)
        host = ipm._solve(prob, torch.device("cpu"),
                          newton=ipm.SparseNewton)
        assert card.status == host.status == "optimal"
        assert card.T == pytest.approx(host.T, rel=1e-8), name
        np.testing.assert_allclose(card.lam, host.lam, atol=1e-6)
