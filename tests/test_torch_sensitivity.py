"""The PyTorch package's sensitivity entry points against the JAX
package's scalar engine, on the quickstart graph (a 16-rank 2-D stencil,
``examples/quickstart.py``), and its breakpoint search (Algorithm 2)
against ``repro.core.dag.breakpoints`` on a 3 × 3 sweep (no kink in
[0.5, 500] µs, the reference's ``tests/test_sweep.py`` case) and random
DAGs with several kinks: equal kinks on the sparse float64 forward (its T
and λ are bit-identical to the scalar engine's), the same count within
1e-6 relative on the float32 forwards.

T, λ and ρ of the curves follow the engine contract: 1e-5 relative on T and
λ, 1e-4 on ρ.  The latency tolerances are bisections of the f32 curve
against the f64 one, so they differ by the shift that T's error moves the
crossing: a T error δT moves the ΔL where T meets the budget by δT/λ.
The bound below adds, for both engines, the bisection's own stopping rule
(|T(x) − budget| ≤ 1e-6·budget) to the T contract (δT ≤ 1e-5·T, on the
budget and on T(x)), divided by the base point's λ (T is convex in L, so
λ at the crossing is at least that), plus 1e-6 relative for ΔL itself.
"""

import numpy as np
import pytest
import torch

from repro.core import dag as ref_dag, loggps as ref_loggps
from repro.core import sensitivity as ref_sens, synth as ref_synth

from repro_torch.core import dag, loggps, sensitivity, synth
from repro_torch.sweep import Engine, ExecPolicy
from repro_torch.sweep.engine import breakpoints_batched

DELTAS = np.linspace(0.0, 50.0, 11)
GSCALES = np.linspace(1.0, 8.0, 8)
DEGRADATIONS = (0.01, 0.02, 0.05)


def _graph(S, L):
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    return S.stencil2d(4, 4, 10, halo_bytes=64e3, comp_us=500.0, params=p), p


@pytest.fixture(scope="module")
def graphs():
    return _graph(ref_synth, ref_loggps), _graph(synth, loggps)


def _same_curve(got, want):
    np.testing.assert_allclose(got.T, want.T, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got.rho, want.rho, rtol=1e-4, atol=0)
    np.testing.assert_array_equal(got.deltas, want.deltas)


def test_latency_curve_matches_scalar(graphs):
    (g_ref, p_ref), (g, p) = graphs
    want = ref_sens.latency_curve(g_ref, p_ref, DELTAS, engine="scalar")
    got = sensitivity.latency_curve(g, p, DELTAS, device="cpu")
    _same_curve(got, want)
    assert got.rrmse_vs(want.T) < 1e-5


def test_bandwidth_curve_matches_scalar(graphs):
    (g_ref, p_ref), (g, p) = graphs
    want = ref_sens.bandwidth_curve(g_ref, p_ref, GSCALES, engine="scalar")
    got = sensitivity.bandwidth_curve(g, p, GSCALES, device="cpu")
    _same_curve(got, want)


def test_latency_tolerance_matches_scalar(graphs):
    (g_ref, p_ref), (g, p) = graphs
    want = ref_sens.latency_tolerance(g_ref, p_ref, DEGRADATIONS,
                                      engine="scalar")
    got = sensitivity.latency_tolerance(g, p, DEGRADATIONS, device="cpu")
    assert list(got) == list(DEGRADATIONS)
    base = ref_sens.analyze(g_ref, p_ref)
    for deg in DEGRADATIONS:
        budget = (1.0 + deg) * base.T
        atol = (2 * 1e-6 * budget + (2 + deg) * 1e-5 * budget) / base.lam[0]
        assert abs(got[deg] - want[deg]) <= atol + 1e-6 * abs(want[deg]), \
            (deg, got[deg], want[deg], atol)
    assert got[0.01] < got[0.02] < got[0.05]


def test_named_class_and_no_scalar_fallback(graphs, monkeypatch):
    """A registered class name selects the class; an engine error reaches
    the caller (no scalar loop behind it)."""
    _, (g, p) = graphs
    by_name = sensitivity.latency_curve(g, p, DELTAS[:3], cls="ib",
                                        device="cpu")
    by_idx = sensitivity.latency_curve(g, p, DELTAS[:3], cls=0, device="cpu")
    np.testing.assert_array_equal(by_name.T, by_idx.T)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: sensitivity.latency_curve(g, p, DELTAS),
                 lambda: sensitivity.latency_tolerance(g, p),
                 lambda: sensitivity.bandwidth_curve(g, p, GSCALES)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_tolerance_fixed_point_exit_matches_reference_loop():
    """Where the bisection reaches a fixed point (T's error exceeds the
    stopping rule's tol, as a float32-stored T's does: a few 1e-6 of T on
    a 16-rank stencil of 20 iterations), the port's early exit returns
    exactly what the reference loop (``repro.sweep.engine.
    tolerance_batched``) returns after all ``max_iter`` rounds, both driven
    through the same port engine.  The port's dense engine carries end
    times in float64, so the engine here rounds T up to a grid of 3e-5 of
    the base makespan: an error no secant step can bring within tol."""
    from repro.sweep.engine import tolerance_batched as ref_tolerance
    from repro_torch.sweep import Engine, ScenarioBatch, base_batch
    from repro_torch.sweep.engine import dense_forward, tolerance_batched

    p = loggps.cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(4, 4, 20, halo_bytes=64e3, comp_us=500.0, params=p)
    eng = Engine(g, params=p, policy=ExecPolicy("dense"), device="cpu")
    quantum = 3e-5 * eng.run(base_batch(p)).T[0]

    class OnPortEngine:
        def run(self, batch, compute_lam=True, use_cache=True, backend=None):
            res = eng.run(ScenarioBatch(L=batch.L, gscale=batch.gscale),
                          compute_lam=compute_lam)
            res.T = np.ceil(res.T / quantum) * quantum
            return res

    dense_forward.runs.clear()
    want = ref_tolerance(OnPortEngine(), p, DEGRADATIONS, max_iter=12)
    n_ref = dense_forward.runs["lam"]
    dense_forward.runs.clear()
    got = tolerance_batched(OnPortEngine(), p, DEGRADATIONS, max_iter=12)
    assert got == want
    assert n_ref == 2 + 2 * 12                # the reference ran every round
    assert dense_forward.runs["lam"] < n_ref


# -- analyze ------------------------------------------------------------------

F64 = ExecPolicy(backend="sparse", dtype="float64")
F32_POLICIES = {"dense": ExecPolicy("dense"),
                "sparse32": ExecPolicy(backend="sparse", dtype="float32")}


def test_analyze_matches_reference(graphs):
    """The default (dense float32) forward within the engine contract; the
    sparse float64 forward bit-equal to the reference's scalar ``analyze``."""
    (g_ref, p_ref), (g, p) = graphs
    want = ref_sens.analyze(g_ref, p_ref)
    got = sensitivity.analyze(g, p, device="cpu")
    assert got.T == pytest.approx(want.T, rel=1e-5)
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5)
    np.testing.assert_allclose(got.rho, want.rho, rtol=1e-4)
    exact = sensitivity.analyze(g, p, device="cpu", policy=F64)
    assert exact.T == want.T
    np.testing.assert_array_equal(exact.lam, want.lam)
    np.testing.assert_array_equal(exact.rho, want.rho)
    assert str(got).splitlines()[1:] == str(want).splitlines()[1:]


# -- critical latencies (Algorithm 2) -------------------------------------------

BP_SEEDS = (1, 2, 3, 6, 7)
BP_RANGE = (0.5, 500.0)


def _bp_case(name, S, L):
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    if name == "sweep":
        return S.sweep2d(3, 3, 3, params=p), p
    rng = np.random.default_rng(int(name.removeprefix("random")))
    return S.random_dag(rng, nranks=8, nops=200, params=p), p


BP_CASES = ("sweep",) + tuple(f"random{s}" for s in BP_SEEDS)


@pytest.fixture(scope="module", params=BP_CASES)
def bp_pair(request):
    (g_ref, p_ref) = _bp_case(request.param, ref_synth, ref_loggps)
    g, p = _bp_case(request.param, synth, loggps)
    return request.param, ref_dag.breakpoints(g_ref, p_ref, *BP_RANGE), g, p


def test_critical_latencies_float64_equal_scalar(bp_pair):
    name, want, g, p = bp_pair
    got = sensitivity.critical_latencies(g, p, *BP_RANGE, device="cpu",
                                         policy=F64)
    assert got == want
    assert (len(want) == 0) == (name == "sweep")
    assert dag.breakpoints(g, p, *BP_RANGE) == want


@pytest.mark.parametrize("policy", sorted(F32_POLICIES))
def test_critical_latencies_float32_policies(bp_pair, policy):
    _, want, g, p = bp_pair
    got = sensitivity.critical_latencies(g, p, *BP_RANGE, device="cpu",
                                         policy=F32_POLICIES[policy])
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-6)


# -- the default policy: segment float64, as the reference's ----------------

DEFAULT_CASES = {"stencil": lambda: _graph(synth, loggps),
                 "random_dag": lambda: _bp_case("random1", synth, loggps)}


@pytest.mark.parametrize("name", sorted(DEFAULT_CASES))
def test_default_critical_latencies_equal_core_dag(name):
    """With no policy, Algorithm 2's kinks are ``core.dag.breakpoints``'s
    exactly: the default backend is segment, whose T and λ are the scalar
    engine's bit for bit."""
    g, p = DEFAULT_CASES[name]()
    assert Engine(g, params=p, device="cpu").policy.backend == "segment"
    got = sensitivity.critical_latencies(g, p, *BP_RANGE, device="cpu")
    assert got == dag.breakpoints(g, p, *BP_RANGE)


@pytest.mark.parametrize("name", sorted(DEFAULT_CASES))
def test_default_latency_tolerance_equals_core_dag(name):
    """With no policy, every level's tolerance is ``core.dag.tolerance``'s
    bit for bit (the lockstep bisection probes the same points as the
    scalar one, on the same T and λ)."""
    g, p = DEFAULT_CASES[name]()
    got = sensitivity.latency_tolerance(g, p, DEGRADATIONS, device="cpu")
    assert got == {d: dag.tolerance(g, p, d) for d in DEGRADATIONS}


def test_breakpoints_batched_rounds_and_class_names(bp_pair):
    """One batched forward a frontier round: the rounds are the recursion's
    depth + 1, the probes the scalar search's forwards; a class name
    resolves like its index."""
    name, want, g, p = bp_pair
    eng = Engine(g, params=p, policy=F64, device="cpu")
    breakpoints_batched.stats.clear()
    assert breakpoints_batched(eng, p, *BP_RANGE) == want
    stats = dict(breakpoints_batched.stats)
    scalar = []
    plan = dag.LevelPlan(g)
    orig = plan.forward
    plan.forward = lambda *a, **k: scalar.append(1) or orig(*a, **k)
    dag.breakpoints(g, p, *BP_RANGE, plan=plan)
    assert stats["probes"] == len(scalar)
    assert stats["rounds"] <= stats["probes"]
    assert sensitivity.critical_latencies(g, p, *BP_RANGE, cls="ib",
                                          device="cpu", policy=F64) == want


def test_analyze_and_critical_latencies_need_the_card(graphs, monkeypatch):
    """Without a card, ``device=None`` raises (no host loop behind it)."""
    _, (g, p) = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: sensitivity.analyze(g, p),
                 lambda: sensitivity.critical_latencies(g, p, *BP_RANGE),
                 lambda: sensitivity.critical_latencies(g, p, *BP_RANGE,
                                                        policy=F64)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.gpu
def test_critical_latencies_card_against_cpu():
    """The card's float64 search equal to the CPU's and to the scalar
    engine's; the float32 policies' kinks as many as the CPU's, within
    1e-6 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in BP_CASES:
        g, p = _bp_case(name, synth, loggps)
        want = dag.breakpoints(g, p, *BP_RANGE)
        for pol in (F64, *F32_POLICIES.values()):
            card = sensitivity.critical_latencies(g, p, *BP_RANGE, policy=pol)
            host = sensitivity.critical_latencies(g, p, *BP_RANGE,
                                                  device="cpu", policy=pol)
            assert len(card) == len(host) == len(want), (name, pol)
            np.testing.assert_allclose(card, host, rtol=1e-6)
        assert sensitivity.critical_latencies(g, p, *BP_RANGE,
                                              policy=F64) == want
        rep = sensitivity.analyze(g, p)
        assert rep.T == pytest.approx(dag.evaluate(g, p).T, rel=1e-5)
