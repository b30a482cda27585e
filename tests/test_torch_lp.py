"""The PyTorch package's explicit LP (Algorithm 1, ``repro_torch.core.lp``)
and its interior-point solver (``repro_torch.core.ipm``) against the JAX
package's ``repro.core.lp`` / ``ipm`` and the scalar engine ``core.dag``.

* ``build_lp``: A, b, c, lb and ub equal to the reference's, for the
  makespan and the maximize-ℓ objectives.
* ``solve_highs``: the same scipy HiGHS call, so T, x, λ and the status
  equal.
* ``solve_ipm(device="cpu")``: T within 1e-5 relative of ``core.dag``, as
  ``tests/test_solvers.py`` holds the reference's IPM, and no farther from
  HiGHS than the reference's IPM is; λ within 1e-5 relative of
  ``core.dag``'s (an interior point approaches the integer count from
  inside).
* ``tolerance_lp`` on both solvers within 1e-5 relative of
  ``core.dag.tolerance``, as ``tests/test_solvers.py`` holds the
  reference's; ``math.inf`` for the unbounded maximize-ℓ LP.
* The dense route's size guard (past it ``solve_ipm`` takes the sparse
  route, held in ``tests/test_torch_ipm_sparse.py``) and the device
  policy.

The ``gpu`` test holds the card's IPM against the CPU's.  The card forms
the Newton matrix with atomic adds and factorizes with cuSOLVER, so its
iterates differ from the CPU's in the last bits: T within 1e-8 relative, λ
within 1e-6, not bit for bit.
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import dag as ref_dag, ipm as ref_ipm, lp as ref_lp
from repro.core import loggps as ref_loggps, synth as ref_synth
from repro.core.graph import GraphBuilder as RefBuilder

from repro_torch.core import dag, ipm, loggps, lp, synth
from repro_torch.core.graph import GraphBuilder

WORKLOADS = ("stencil2d", "cg", "sweep", "allreduce_ring", "allreduce_rd",
             "pipeline", "stencil2c")


def build(name, S, L):
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


@pytest.fixture(scope="module", params=WORKLOADS)
def pair(request):
    return (build(request.param, ref_synth, ref_loggps),
            build(request.param, synth, loggps))


def _problems(g, p, L):
    """The makespan LP, and the maximize-ℓ LP of every class."""
    yield L.build_lp(g, p)
    for cls in range(p.nclass):
        yield L.build_lp(g, p, objective="tolerance", max_cls=cls,
                         T_budget=1234.5)


def test_build_lp_equal_field_for_field(pair):
    (g_ref, p_ref), (g, p) = pair
    for got, want in zip(_problems(g, p, lp), _problems(g_ref, p_ref, ref_lp),
                         strict=True):
        assert isinstance(got.A, sp.csr_matrix)
        assert got.A.shape == want.A.shape
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(got.A, f),
                                          getattr(want.A, f))
        for f in ("b", "c", "lb", "ub"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert (got.nclass, got.nv, got.nvars, got.idx_T) \
            == (want.nclass, want.nv, want.nvars, want.idx_T)


def test_solve_highs_equal(pair):
    (g_ref, p_ref), (g, p) = pair
    got = lp.predict_runtime(g, p, solver="highs")
    want = ref_lp.predict_runtime(g_ref, p_ref, solver="highs")
    assert (got.T, got.status, got.iterations) \
        == (want.T, want.status, want.iterations)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.lam, want.lam)
    assert got.device == "cpu"


def test_ipm_on_cpu_against_dag_and_reference(pair):
    (g_ref, p_ref), (g, p) = pair
    s = dag.evaluate(g, p)
    got = ipm.solve_ipm(lp.build_lp(g, p), device="cpu")
    assert got.status == "optimal" and got.device == "cpu"
    assert got.T == pytest.approx(s.T, rel=1e-5)
    np.testing.assert_allclose(got.lam, s.lam, rtol=1e-5)
    highs = ref_lp.predict_runtime(g_ref, p_ref, solver="highs")
    ref = ref_ipm.solve_ipm(ref_lp.build_lp(g_ref, p_ref))
    assert abs(got.T - highs.T) <= abs(ref.T - highs.T)
    assert got.iterations <= ref.iterations + 2


@pytest.mark.parametrize("solver", lp.SOLVERS)
def test_tolerance_lp_against_dag(pair, solver):
    _, (g, p) = pair
    for cls in range(p.nclass):
        for deg in (0.01, 0.05):
            want = dag.tolerance(g, p, deg, cls=cls)
            got = lp.tolerance_lp(g, p, deg, cls=cls, solver=solver,
                                  device="cpu")
            assert got == pytest.approx(want, rel=1e-5), (cls, deg)


def _no_latency_graph(B):
    b = B(2, 1)
    b.add_calc(0, 10.0)
    b.add_calc(0, 5.0)
    b.add_calc(1, 7.0)
    return b.finalize()


@pytest.mark.parametrize("solver", lp.SOLVERS)
def test_tolerance_lp_unbounded_returns_inf(solver):
    """No latency-bearing edge: the maximize-ℓ LP is unbounded and the
    tolerance is ``math.inf``, as the reference's HiGHS route returns."""
    p = loggps.cluster_params(L_us=3.0, o_us=5.0)
    t = lp.tolerance_lp(_no_latency_graph(GraphBuilder), p, 0.05,
                        solver=solver, device="cpu")
    assert isinstance(t, float) and math.isinf(t) and t > 0
    assert t == ref_lp.tolerance_lp(_no_latency_graph(RefBuilder),
                                    ref_loggps.cluster_params(L_us=3.0,
                                                              o_us=5.0), 0.05)
    # the HiGHS route's own unbounded status, without the structural test
    g = _no_latency_graph(GraphBuilder)
    prob = lp.build_lp(g, p, objective="tolerance", max_cls=0, T_budget=20.0)
    assert lp.solve_highs(prob).status == "unbounded"


def test_ipm_iteration_limit_is_reported(monkeypatch):
    g, p = build("stencil2d", synth, loggps)
    monkeypatch.setattr(ipm, "MAX_ITER", 3)
    sol = ipm.solve_ipm(lp.build_lp(g, p), device="cpu")
    assert sol.status == "iteration_limit" and sol.iterations == 3


def test_newton_size_guard(monkeypatch):
    """The stencil of ``chip_smoke.py`` (23,042 columns, 4.25 GB) fits the
    dense route's limit; a 10⁵-column LP is refused by the dense Newton
    system before anything is allocated, and so is any LP past a lowered
    limit, with n and the bytes named.  ``predict_runtime`` past the
    lowered limit answers through the sparse route."""
    assert ipm.newton_bytes(23_042) == 4_247_470_112
    assert 2 * ipm.newton_bytes(23_042) < ipm.MAX_NEWTON_BYTES
    wide = sp.csr_matrix((1, 100_000))
    with pytest.raises(ValueError, match=r"n = 100000 .* 80000000000 B"):
        ipm.NewtonSystem(wide, torch.device("cpu"))
    g, p = build("cg", synth, loggps)
    prob = lp.build_lp(g, p)
    monkeypatch.setattr(ipm, "MAX_NEWTON_BYTES",
                        ipm.newton_bytes(prob.nvars) - 1)
    with pytest.raises(ValueError, match=f"n = {prob.nvars} columns"):
        ipm.NewtonSystem(ipm._fold_bounds(prob)[0], torch.device("cpu"))
    sol = lp.predict_runtime(g, p, device="cpu")
    assert sol.status == "optimal" and sol.pcg_steps
    assert sol.T == pytest.approx(dag.evaluate(g, p).T, rel=1e-5)
    # HiGHS on the host is the caller's explicit route; it has no such guard
    assert lp.predict_runtime(g, p, solver="highs").status == "optimal"


def test_device_policy_and_solver_names(monkeypatch):
    g, p = build("cg", synth, loggps)
    with pytest.raises(ValueError, match="unknown solver"):
        lp.predict_runtime(g, p, solver="gurobi")
    with pytest.raises(ValueError, match="unknown solver"):
        lp.tolerance_lp(g, p, 0.01, solver="gurobi")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: ipm.solve_ipm(lp.build_lp(g, p)),
                 lambda: lp.predict_runtime(g, p),
                 lambda: lp.tolerance_lp(g, p, 0.01)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_newton_system_forms_normal_matrix():
    """M = Aᵀ diag(d) A + 1e-10·I against scipy, and its factor solves."""
    g, p = build("stencil2c", synth, loggps)
    A, _, _ = ipm._fold_bounds(lp.build_lp(g, p))
    d = np.random.default_rng(0).uniform(0.1, 10.0, A.shape[0])
    ns = ipm.NewtonSystem(A, torch.device("cpu"))
    ns.form(torch.from_numpy(d))
    want = (A.T @ sp.diags(d) @ A).toarray() + 1e-10 * np.eye(A.shape[1])
    np.testing.assert_allclose(ns.M.numpy(), want, rtol=1e-14, atol=0)
    ns.factor()
    rhs = np.arange(A.shape[1], dtype=np.float64)
    x = ns.solve(torch.from_numpy(rhs)).numpy()
    np.testing.assert_allclose(want @ x, rhs, rtol=1e-8, atol=1e-8)


@pytest.mark.gpu
def test_ipm_card_against_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in WORKLOADS:
        g, p = build(name, synth, loggps)
        prob = lp.build_lp(g, p)
        card = ipm.solve_ipm(prob)
        host = ipm.solve_ipm(prob, device="cpu")
        assert card.status == host.status == "optimal"
        assert card.device == torch.cuda.get_device_name(0)
        assert card.T == pytest.approx(host.T, rel=1e-8), name
        np.testing.assert_allclose(card.lam, host.lam, atol=1e-6)
        for deg in (0.01, 0.05):
            assert lp.tolerance_lp(g, p, deg) == pytest.approx(
                dag.tolerance(g, p, deg), rel=1e-5), (name, deg)
