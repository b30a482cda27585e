"""The PyTorch package's discrete-event simulator
(``repro_torch.core.simulator``, a numpy copy) against the JAX package's
``repro.core.simulator``, bit for bit.

Graphs: the solver workloads of ``tests/test_solvers.py``, the injector
graphs of ``tests/test_injector.py`` (back-to-back eager messages, one
message), the incast of ``tests/test_congestion.py`` (with and without
recorded link ids) and the 3 × 3 stencil on a 4-pod model of
``tests/test_resilience.py``, each built by both packages from the same
arguments.  Every injector (flow, sender, progress, contention, fault, the
last with the ``fault`` dicts of ``tests/test_resilience.py``) at ΔL = 0,
7 and 42 µs: T, start and end times and the event count equal.  Both
copies run the same float64 numpy operations in the same order.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import graph as ref_graph, loggps as ref_loggps
from repro.core import simulator as ref_sim, synth as ref_synth

from repro_torch.core import graph, loggps, simulator, synth

INJECTORS = ("flow", "sender", "progress", "contention")
DELTAS = (0.0, 7.0, 42.0)


def _back_to_back(G, p):
    b = G.GraphBuilder(2, 1)
    b.add_message(0, 1, 100.0, p)
    b.add_message(0, 1, 100.0, p)
    b.add_calc(1, 0.001)
    return b.finalize()


def _one_message(G, p):
    b = G.GraphBuilder(2, 1)
    b.add_calc(0, 5.0)
    b.add_message(0, 1, 64.0, p)
    b.add_calc(1, 1.0)
    return b.finalize()


def _incast(G, p, n=6, nbytes=1e6):
    b = G.GraphBuilder(nclass=p.nclass, nranks=2)
    for _ in range(n):
        b.add_message(0, 1, nbytes=nbytes, params=p)
    return b.finalize()


def build(name, S, G, L):
    """(graph, params) of one case with a package's modules."""
    cl = L.cluster_params(L_us=3.0, o_us=5.0)
    inj = L.LogGPS(L=(2.0,), G=(1e-3,), o=1.0, S=1e9)
    pod2 = L.pod_model(pod_size=2).params()
    pod4 = L.pod_model(pod_size=4).params()
    return {
        "stencil2d": lambda: (S.stencil2d(3, 3, 4, params=cl), cl),
        "cg": lambda: (S.cg_like(2, 2, 3, params=cl), cl),
        "sweep": lambda: (S.sweep2d(3, 3, 2, params=cl), cl),
        "allreduce_ring": lambda: (
            S.allreduce_chain(8, 3, params=cl, algo="ring"), cl),
        "allreduce_rd": lambda: (S.allreduce_chain(
            8, 3, params=cl, algo="recursive_doubling"), cl),
        "pipeline": lambda: (S.ring_pipeline(5, 4, params=cl), cl),
        "back_to_back": lambda: (_back_to_back(G, inj), inj),
        "one_message": lambda: (_one_message(G, inj), inj),
        "incast": lambda: (_incast(G, pod2, n=4), pod2),
        "incast_bare": lambda: (dataclasses.replace(
            _incast(G, pod2, n=4), elink=None, nlinks=0, link_classes=None),
            pod2),
        "resilience": lambda: (S.stencil2d(3, 3, 3, params=pod4), pod4),
    }[name]()


NAMES = ("stencil2d", "cg", "sweep", "allreduce_ring", "allreduce_rd",
         "pipeline", "back_to_back", "one_message", "incast", "incast_bare",
         "resilience")


@pytest.fixture(scope="module", params=NAMES)
def pair(request):
    return (build(request.param, ref_synth, ref_graph, ref_loggps),
            build(request.param, synth, graph, loggps))


def _same(got, want):
    assert got.T == want.T
    assert got.events == want.events
    np.testing.assert_array_equal(got.t_start, want.t_start)
    np.testing.assert_array_equal(got.t_end, want.t_end)


@pytest.mark.parametrize("injector", INJECTORS)
def test_simulate_bit_equal(pair, injector):
    (g_ref, p_ref), (g, p) = pair
    for dL in DELTAS:
        _same(simulator.simulate(g, p, dL, injector=injector),
              ref_sim.simulate(g_ref, p_ref, dL, injector=injector))


def test_inject_class_and_no_gap_bit_equal(pair):
    (g_ref, p_ref), (g, p) = pair
    for cls in range(p.nclass):
        _same(simulator.simulate(g, p, 7.0, inject_class=cls),
              ref_sim.simulate(g_ref, p_ref, 7.0, inject_class=cls))
    p_g, p_ref_g = p.replace(g=0.5), p_ref.replace(g=0.5)
    for gap in (True, False):
        _same(simulator.simulate(g, p_g, 7.0, model_gap=gap),
              ref_sim.simulate(g_ref, p_ref_g, 7.0, model_gap=gap))


def _faults(g, p):
    """The fault dicts of ``tests/test_resilience.py``: stragglers (a dict
    and a per-vertex array), added latency and gap inflation per class."""
    cls = p.class_names[-1]
    v = int(np.argmax(g.vcost))
    slow = np.ones(g.num_vertices)
    slow[::3] = 1.7
    return [{"slowdown": {v: 1.5}}, {"slowdown": {v: 3.0}},
            {"slowdown": slow}, {"extra_L": {cls: 25.0}},
            {"gscale": {cls: 2.0}},
            {"slowdown": {v: 2.5}, "extra_L": {0: 10.0}, "gscale": {0: 2.0}}]


def test_fault_injector_bit_equal(pair):
    (g_ref, p_ref), (g, p) = pair
    for fault in _faults(g, p):
        for dL in DELTAS:
            _same(simulator.simulate(g, p, dL, injector="fault", fault=fault),
                  ref_sim.simulate(g_ref, p_ref, dL, injector="fault",
                                   fault=fault))


@pytest.mark.parametrize("injector", INJECTORS)
def test_runtime_sweep_bit_equal(pair, injector):
    (g_ref, p_ref), (g, p) = pair
    deltas = np.linspace(0.0, 50.0, 6)
    np.testing.assert_array_equal(
        simulator.runtime_sweep(g, p, deltas, injector=injector),
        ref_sim.runtime_sweep(g_ref, p_ref, deltas, injector=injector))


@pytest.mark.parametrize("kw, match", [
    ({"injector": "teleport"}, "injector"),
    ({"injector": "fault"}, "fault="),
    ({"injector": "flow", "fault": {}}, "fault="),
    ({"injector": "fault", "fault": {"melt": 1}}, "unknown fault"),
])
def test_bad_arguments_raise(kw, match):
    g, p = build("one_message", synth, graph, loggps)
    with pytest.raises(ValueError, match=match):
        simulator.simulate(g, p, **kw)
