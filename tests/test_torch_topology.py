"""The PyTorch package's network topologies, explicit-RNG helper and
scenario grids against the JAX package's, field for field.

``repro_torch.core.topology`` / ``core.rng`` and the grids of
``repro_torch.sweep.scenarios`` (``cartesian_grid``, ``sample_grid``,
``topology_variants``) are numpy copies of the reference's: every hop
count, wire-class split, parameter object, stamped graph and grid must
equal the reference's exactly.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import graph as ref_graph, loggps as ref_loggps
from repro.core import rng as ref_rng, topology as ref_topology
from repro.sweep import scenarios as ref_scenarios

from repro_torch.core import graph, loggps, rng, topology
from repro_torch.sweep import scenarios

TOPOS = {
    "fat_tree4": lambda T: T.fat_tree(4),
    "fat_tree16": lambda T: T.fat_tree(16),
    "dragonfly": lambda T: T.dragonfly(2, 3, 2),
    "dragonfly_fig11": lambda T: T.dragonfly(8, 4, 8),
    "torus2d": lambda T: T.torus((4, 4)),
    "torus3d": lambda T: T.torus((2, 3, 4)),
    "multipod": lambda T: T.multipod_torus(2, (4, 4)),
}


def assert_graph_equal(got, want):
    """Every field of two ExecutionGraphs equal, arrays bit for bit."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def assert_params_equal(got, want):
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


@pytest.mark.parametrize("name", list(TOPOS))
def test_topology_hops_and_wire_classes(name):
    t, r = TOPOS[name](topology), TOPOS[name](ref_topology)
    assert (t.name, t.nranks, t.nclasses) == (r.name, r.nranks, r.nclasses)
    assert (t.wire_classes is None) == (r.wire_classes is None)
    n = t.nranks
    for a in range(n):
        for b in range(n):
            assert t.hops(a, b) == r.hops(a, b), (a, b)
            if r.wire_classes is not None:
                assert t.wire_classes(a, b) == r.wire_classes(a, b), (a, b)
            assert topology.message_lat_spec(t, a, b) == \
                ref_topology.message_lat_spec(r, a, b)


@pytest.mark.parametrize("kw", [{}, {"l_wire_us": 0.5, "ici_gbps": 100.0,
                                     "o_us": 1.25}])
@pytest.mark.parametrize("name", list(TOPOS))
def test_topology_params(name, kw):
    assert_params_equal(
        topology.topology_params(TOPOS[name](topology), **kw),
        ref_topology.topology_params(TOPOS[name](ref_topology), **kw))


def workload(T, G, topo, params, nranks=16, iters=2):
    """``examples/topology_study.py``'s workload at 16 ranks."""
    stamp = T.TopologyStamper(topo, params)
    b = G.GraphBuilder(nranks, topo.nclasses)
    for _ in range(iters):
        for r in range(nranks):
            b.add_calc(r, 2_000.0)
        for k in range(4):
            for r in range(nranks):
                peer = r ^ (1 << k)
                if r < peer < nranks:
                    stamp.message(b, r, peer, 4e5)
                    stamp.message(b, peer, r, 4e5)
    return b.finalize()


@pytest.mark.parametrize("name", ["fat_tree4", "dragonfly", "torus2d",
                                  "multipod"])
def test_topology_stamper_graphs(name):
    t, r = TOPOS[name](topology), TOPOS[name](ref_topology)
    nranks = min(16, t.nranks)
    got = workload(topology, graph, t, topology.topology_params(t), nranks)
    want = workload(ref_topology, ref_graph, r,
                    ref_topology.topology_params(r), nranks)
    assert_graph_equal(got, want)
    assert got.nclass == t.nclasses and got.num_edges > 0


def test_topology_variants():
    kw = dict(l_wire_us=0.3, d_switch_us=0.2)
    names = ["fat_tree4", "dragonfly", "torus2d"]
    got = scenarios.topology_variants(
        lambda t, p: workload(topology, graph, t, p),
        [TOPOS[n](topology) for n in names], **kw)
    want = ref_scenarios.topology_variants(
        lambda t, p: workload(ref_topology, ref_graph, t, p),
        [TOPOS[n](ref_topology) for n in names], **kw)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert (a.name, a.meta) == (b.name, b.meta)
        assert_params_equal(a.params, b.params)
        assert_graph_equal(a.graph, b.graph)


def _models(L):
    return {"cluster": L.cluster_params(L_us=3.0, o_us=5.0),
            "pod": L.pod_model(pod_size=4).params(),
            "pod3": L.pod_model(pod_size=4, ranks_per_host=2).params()}


def assert_batch_equal(got, want):
    np.testing.assert_array_equal(got.L, want.L)
    np.testing.assert_array_equal(got.gscale, want.gscale)
    assert got.meta == want.meta


CARTESIAN = [
    ("none", {}, {}),
    ("lat", {0: [0.0, 1.5, 3.0]}, {}),
    ("lat-gs", {0: [0.0, 2.0]}, {0: [1.0, 1.5, 2.0]}),
    ("two-classes", {0: [0.0, 1.0], 1: [0.0, 5.0, 10.0]}, {1: [1.0, 4.0]}),
    ("names", {"dcn": [0.0, 7.0]}, {"ici": [0.5, 1.0]}),
]


@pytest.mark.parametrize("model", ["cluster", "pod", "pod3"])
@pytest.mark.parametrize("case", [pytest.param(c[1:], id=c[0])
                                  for c in CARTESIAN])
def test_cartesian_grid(case, model):
    lat, gs = case
    p, pr = _models(loggps)[model], _models(ref_loggps)[model]
    try:
        want = ref_scenarios.cartesian_grid(pr, lat_deltas=lat, gscales=gs)
    except (ValueError, KeyError, IndexError) as e:
        with pytest.raises(type(e)):
            scenarios.cartesian_grid(p, lat_deltas=lat, gscales=gs)
        return
    assert_batch_equal(scenarios.cartesian_grid(p, lat_deltas=lat,
                                                gscales=gs), want)


@pytest.mark.parametrize("kind", ["lat_deltas", "gscales"])
def test_cartesian_grid_duplicate_axis(kind):
    """{1: ..., "dcn": ...} names class 1 twice on a pod model: refused."""
    p = loggps.pod_model(pod_size=4).params()
    pr = ref_loggps.pod_model(pod_size=4).params()
    table = {1: [0.0, 1.0], "dcn": [2.0]}
    for mod, params in ((ref_scenarios, pr), (scenarios, p)):
        with pytest.raises(ValueError, match="duplicate"):
            mod.cartesian_grid(params, **{kind: table})


@pytest.mark.parametrize("kw", [{}, {"lat_deltas": (5.0, 5.0)},
                                {"gscales": (1.0, 3.0), "cls": "dcn"}])
@pytest.mark.parametrize("seed", [0, 17, (3, 4)])
def test_sample_grid_same_seed_same_grid(seed, kw):
    p = loggps.pod_model(pod_size=4).params()
    pr = ref_loggps.pod_model(pod_size=4).params()
    got = scenarios.sample_grid(p, 9, seed, **kw)
    assert_batch_equal(got, ref_scenarios.sample_grid(pr, 9, seed, **kw))
    assert_batch_equal(got, scenarios.sample_grid(p, 9, seed, **kw))
    # a Generator passes through: one stream threads two grids
    g1 = np.random.default_rng(seed)
    g2 = np.random.default_rng(seed)
    a = [scenarios.sample_grid(p, 4, g1, **kw) for _ in range(2)]
    b = [ref_scenarios.sample_grid(pr, 4, g2, **kw) for _ in range(2)]
    for x, y in zip(a, b):
        assert_batch_equal(x, y)


def test_sample_grid_requires_an_rng():
    p = loggps.cluster_params()
    with pytest.raises(TypeError, match="explicit rng"):
        scenarios.sample_grid(p, 3, None)


@pytest.mark.parametrize("bad", [None, "seed", 1.5, object()])
def test_as_rng_errors(bad):
    with pytest.raises(TypeError) as got:
        rng.as_rng(bad)
    with pytest.raises(TypeError) as want:
        ref_rng.as_rng(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 5, np.int64(9), (1, 2), [3, 4],
                                  np.random.SeedSequence(8)])
def test_as_rng_seeds(seed):
    a, b = rng.as_rng(seed), ref_rng.as_rng(seed)
    np.testing.assert_array_equal(a.uniform(size=5), b.uniform(size=5))
    g = np.random.default_rng(1)
    assert rng.as_rng(g) is g
