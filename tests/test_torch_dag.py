"""The PyTorch package's scalar engine (``repro_torch.core.dag``, a numpy
copy) against the JAX package's ``repro.core.dag``, bit for bit.

Cases: the five conformance cases of ``tests/test_torch_engine.py`` and
random DAGs (``synth.random_dag``, 8 ranks, 200 ops, seeds below), each
built by both packages' ``synth`` from the same arguments.  Both copies run
the same float64 numpy operations in the same order, so every output is
compared with ``array_equal`` / ``==``: the schedule's T, λ, ρ, start and
end times and slopes, the critical edges, the pairwise counts, the
multi-delta forward, the runtime curve, the breakpoints and the
tolerances.
"""

import numpy as np
import pytest

from repro.core import dag as ref_dag, loggps as ref_loggps
from repro.core import synth as ref_synth

from repro_torch.core import dag, loggps, synth

NAMES = ("stencil", "cg", "allreduce", "stencil2c", "stencil3c")
SEEDS = (1, 3, 6, 7)
CASES = NAMES + tuple(f"random{s}" for s in SEEDS)
DELTAS = np.linspace(0.0, 60.0, 7)


def case(name, S, L):
    """One case built with a package's ``synth``/``loggps`` (the
    conformance cases as ``tests/test_torch_engine.py`` builds them)."""
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    if name.startswith("random"):
        rng = np.random.default_rng(int(name.removeprefix("random")))
        return S.random_dag(rng, nranks=8, nops=200, params=p1), p1
    p2 = L.pod_model(pod_size=2).params()
    p3 = L.pod_model(pod_size=4, ranks_per_host=2).params()
    return {
        "stencil": lambda: (S.stencil2d(3, 3, 4, params=p1), p1),
        "cg": lambda: (S.cg_like(2, 2, 3, params=p1), p1),
        "allreduce": lambda: (S.allreduce_chain(8, 3, params=p1), p1),
        "stencil2c": lambda: (S.stencil2d(2, 2, 3, params=p2), p2),
        "stencil3c": lambda: (S.stencil2d(4, 2, 3, params=p3), p3),
    }[name]()


@pytest.fixture(scope="module", params=CASES)
def pair(request):
    name = request.param
    return (name, case(name, ref_synth, ref_loggps), case(name, synth, loggps))


def test_schedule_bit_equal(pair):
    _, (g_ref, p_ref), (g, p) = pair
    want = ref_dag.evaluate(g_ref, p_ref)
    got = dag.evaluate(g, p)
    assert got.T == want.T
    for f in ("lam", "t_start", "t_end", "slope"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.rho(), want.rho())
    assert got.lam_total == want.lam_total
    assert dag.l_ratio(got) == ref_dag.l_ratio(want)


def test_critical_edges_pairwise_counts_and_path(pair):
    _, (g_ref, p_ref), (g, p) = pair
    plan_ref, plan = ref_dag.LevelPlan(g_ref), dag.LevelPlan(g)
    s_ref, s = plan_ref.forward(p_ref), plan.forward(p)
    np.testing.assert_array_equal(plan.critical_edges(s),
                                  plan_ref.critical_edges(s_ref))
    for a, b in zip(plan.pairwise_counts(s), plan_ref.pairwise_counts(s_ref)):
        np.testing.assert_array_equal(a, b)
    assert plan._trace_one_path(s) == plan_ref._trace_one_path(s_ref)


def test_forward_multi_and_runtime_curve(pair):
    _, (g_ref, p_ref), (g, p) = pair
    np.testing.assert_array_equal(
        dag.LevelPlan(g).forward_multi(p, DELTAS),
        ref_dag.LevelPlan(g_ref).forward_multi(p_ref, DELTAS))
    for a, b in zip(dag.runtime_curve(g, p, DELTAS),
                    ref_dag.runtime_curve(g_ref, p_ref, DELTAS)):
        np.testing.assert_array_equal(a, b)


def test_breakpoints_bit_equal(pair):
    _, (g_ref, p_ref), (g, p) = pair
    for cls in range(g.nclass):
        assert dag.breakpoints(g, p, 0.5, 500.0, cls=cls) \
            == ref_dag.breakpoints(g_ref, p_ref, 0.5, 500.0, cls=cls)


@pytest.mark.parametrize("degradation", [0.0, 0.01, 0.05, 0.5])
def test_tolerance_bit_equal(pair, degradation):
    _, (g_ref, p_ref), (g, p) = pair
    assert dag.tolerance(g, p, degradation) \
        == ref_dag.tolerance(g_ref, p_ref, degradation)


def test_random_cases_have_kinks():
    """The random DAGs are picked to give the breakpoint search work."""
    for s in SEEDS:
        g, p = case(f"random{s}", synth, loggps)
        assert len(dag.breakpoints(g, p, 0.5, 500.0)) >= 2, s
