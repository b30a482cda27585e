"""Algorithm 3's placement search on the port (``repro_torch.core.placement``)
against the JAX package's ``repro.core.placement``.

On the CPU (``device="cpu"``, the kernels' plain versions), at small sizes
(the reference's biased two-tier fixture, P 8; a 4 × 4 × 2 stencil on
``two_tier(16, 4)``), inputs from numpy seeds:

* the numpy helpers (``ArchTopology.two_tier``, ``mapping_edge_cost``,
  ``swap_gain_matrix``, ``swap_gain``, ``_select_swap``,
  ``evaluate_mapping``, ``latency_points``, the three mappings) equal the
  reference's bit for bit;
* ``engine="scalar"``: mapping and history bit-equal to the reference's
  scalar loop;
* the batched loop on segment: at ``topk=1`` on one point, history and
  mapping bit-equal to the reference's ``engine="scalar"``; at ``topk>1``
  over a grid, every candidate objective of every step equal to the
  port's ``core.dag`` on that candidate's mapping;
* ``backend="dense"`` within 1e-5 of the reference's ``backend="pallas"``
  (``engine="sweep"``, so the reference cannot fall back to its host
  loop; the reference's segment engine fails on this JAX);
* ``cost_eval="rebuild"`` ≡ ``"patch"`` bit for bit, the ``stats``
  counts, one level-loop launch and no walk a step;
* an engine error reaches the caller under ``engine="auto"``.

On the card (``-m gpu``): one placement step bit-equal to the same call
on the CPU.
"""

import numpy as np
import pytest
import torch

from repro.core import placement as ref_placement
from repro.core import synth as ref_synth
from repro.core.graph import GraphBuilder as RefGraphBuilder
from repro.core.loggps import LogGPS as RefLogGPS

from repro_torch.core import dag, placement, synth
from repro_torch.core.graph import GraphBuilder
from repro_torch.core.loggps import LogGPS
from repro_torch.sweep import api
from repro_torch.sweep import engine as eng


def _biased(GB, LG, PL):
    """The reference's biased two-tier fixture (tests/
    test_topology_placement.py) with a package's GraphBuilder: chatty pairs
    of distinct sizes, an adversarial cross-pod start, a fast/slow Φ."""
    P, pod = 8, 4
    zero = LG(L=(0.0,), G=(0.0,), o=0.5, S=1e18)
    b = GB(P, 1)
    for it in range(6):
        for idx, r in enumerate(range(0, P, 2)):
            b.add_calc(r, 1.0)
            sz = 65536.0 * (1.0 + 0.5 * idx)
            b.add_message(r, r + 1, sz, zero)
            b.add_message(r + 1, r, sz, zero)
    g = b.finalize()
    phi = PL.ArchTopology.two_tier(P, pod, L_fast=1.0, L_slow=20.0,
                                   G_fast=1e-5, G_slow=4e-5)
    pi0 = np.array([0, 4, 1, 5, 2, 6, 3, 7])
    return g, zero, phi, pi0


def _stencil(S, LG, PL):
    """A 4 × 4 × 2 stencil built under zero link costs on two_tier(16, 4),
    from a seeded random start mapping."""
    zero = LG(L=(0.0,), G=(0.0,), o=0.5, S=1e18)
    g = S.stencil2d(4, 4, 2, halo_bytes=64e3, comp_us=500.0, params=zero)
    phi = PL.ArchTopology.two_tier(16, 4)
    pi0 = np.random.default_rng(11).permutation(16)
    return g, zero, phi, pi0


def case(name, port=True):
    if name == "biased":
        return (_biased(GraphBuilder, LogGPS, placement) if port
                else _biased(RefGraphBuilder, RefLogGPS, ref_placement))
    return (_stencil(synth, LogGPS, placement) if port
            else _stencil(ref_synth, RefLogGPS, ref_placement))


CASES = ("biased", "stencil")
DELTAS = (0.0, 1.0, 5.0, 10.0)


# -- the numpy helpers ---------------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_numpy_helpers_equal_reference(name):
    g, zero, phi, pi0 = case(name)
    rg, rzero, rphi, _ = case(name, port=False)
    for f in ("L", "G"):
        np.testing.assert_array_equal(getattr(phi, f), getattr(rphi, f))
    assert np.array_equal(placement.mapping_edge_cost(g, phi, pi0),
                          ref_placement.mapping_edge_cost(rg, rphi, pi0))
    sched, plan = placement.evaluate_mapping(g, zero, phi, pi0)
    rsched, rplan = ref_placement.evaluate_mapping(rg, rzero, rphi, pi0)
    assert sched.T == rsched.T
    D = placement.sensitivity_matrices(g, sched, plan)
    rD = ref_placement.sensitivity_matrices(rg, rsched, rplan)
    for a, b in zip(D, rD):
        np.testing.assert_array_equal(a, b)
    gains = placement.swap_gain_matrix(*D, pi0, phi)
    np.testing.assert_array_equal(gains,
                                  ref_placement.swap_gain_matrix(*rD, pi0, rphi))
    assert placement._select_swap(gains) == ref_placement._select_swap(gains)
    for i, j in ((0, 1), (1, 5), (2, 7)):
        assert placement.swap_gain(i, j, *D, pi0, phi) == \
            ref_placement.swap_gain(i, j, *rD, pi0, rphi)
    pts = placement.latency_points(zero, DELTAS)
    rpts = ref_placement.latency_points(rzero, DELTAS)
    assert [p.L for p in pts] == [p.L for p in rpts]
    P = g.nranks
    np.testing.assert_array_equal(placement.block_mapping(P),
                                  ref_placement.block_mapping(P))
    np.testing.assert_array_equal(placement.random_mapping(P, 5),
                                  ref_placement.random_mapping(P, 5))
    np.testing.assert_array_equal(
        placement.volume_greedy_mapping(g, phi),
        ref_placement.volume_greedy_mapping(rg, rphi))
    with pytest.raises(TypeError):
        placement.random_mapping(P, None)


@pytest.mark.parametrize("name", CASES)
def test_scalar_loop_bit_equal_to_reference(name):
    g, zero, phi, pi0 = case(name)
    rg, rzero, rphi, _ = case(name, port=False)
    pi, hist = placement.place(g, phi, params=zero, pi0=pi0.copy(),
                               engine="scalar", max_iters=6)
    rpi, rhist = ref_placement.place(rg, rphi, params=rzero, pi0=pi0.copy(),
                                     engine="scalar", max_iters=6)
    np.testing.assert_array_equal(pi, rpi)
    assert hist == rhist


# -- the batched loop on segment -------------------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_segment_topk1_equals_reference_scalar(name):
    """One point, topk 1: the batched loop's mapping and history are the
    reference's host loop's, bit for bit."""
    g, zero, phi, pi0 = case(name)
    rg, rzero, rphi, _ = case(name, port=False)
    pi, hist = placement.place(g, phi, params=zero, pi0=pi0.copy(),
                               max_iters=6, device="cpu")
    rpi, rhist = ref_placement.place(rg, rphi, params=rzero, pi0=pi0.copy(),
                                     engine="scalar", max_iters=6)
    np.testing.assert_array_equal(pi, rpi)
    assert hist == rhist


def _recording(monkeypatch):
    """Wrap ``Engine.run`` to record each query's extras and T."""
    calls = []
    run = api.Engine.run

    def rec(self, query=None, **kw):
        res = run(self, query, **kw)
        calls.append((np.array(query.costs), res.T.copy()))
        return res
    monkeypatch.setattr(api.Engine, "run", rec)
    return calls


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("topk", [3, 8])
def test_segment_candidates_equal_core_dag(name, topk, monkeypatch):
    """Over a 4-point grid, every candidate objective of every step equals
    the port's ``core.dag`` forward under that candidate's extras."""
    g, zero, phi, pi0 = case(name)
    pts = placement.latency_points(zero, DELTAS)
    calls = _recording(monkeypatch)
    st = {}
    pi, hist = placement.place(g, phi, params=zero, pi0=pi0.copy(),
                               scenarios=pts, topk=topk, max_iters=4,
                               stats=st, device="cpu")
    assert calls and st["engine_calls"] == len(calls)
    plan = dag.LevelPlan(g)
    for extras, T in calls:
        assert T.shape == (extras.shape[0], len(pts))
        for k, ex in enumerate(extras):
            want = [plan.forward(pt, extra_edge_cost=ex).T for pt in pts]
            assert T[k].tolist() == want
    # the accepted objectives are the grid means of their candidates
    for (extras, T), f in zip(calls, hist[1:]):
        assert f == float(T.mean(axis=1).min())
    assert hist[-1] <= hist[0]


@pytest.mark.parametrize("name", CASES)
def test_rebuild_equals_patch(name):
    g, zero, phi, pi0 = case(name)
    pts = placement.latency_points(zero, DELTAS)
    out = {}
    for ce in ("patch", "rebuild"):
        st = {}
        out[ce] = placement.place(g, phi, params=zero, pi0=pi0.copy(),
                                  scenarios=pts, topk=4, max_iters=4,
                                  cost_eval=ce, stats=st, device="cpu") + (st,)
    (pa, ha, sa), (pb, hb, sb) = out["patch"], out["rebuild"]
    np.testing.assert_array_equal(pa, pb)
    assert ha == hb
    assert sa["plan_compiles"] == 1
    assert sb["plan_compiles"] == sb["candidates"]
    assert sa["engine_calls"] == sb["engine_calls"]


@pytest.mark.parametrize("name", CASES)
def test_stats_counts(name):
    g, zero, phi, pi0 = case(name)
    pts = placement.latency_points(zero, DELTAS[:2])
    st = {}
    pi, hist = placement.place(g, phi, params=zero, pi0=pi0.copy(),
                               scenarios=pts, topk=5, max_iters=3, stats=st,
                               device="cpu")
    assert st["cost_eval"] == "patch" and st["plan_compiles"] == 1
    assert st["scalar_fallbacks"] == 0
    assert st["steps"] == len(hist) - 1
    assert st["engine_calls"] in (st["steps"], st["steps"] + 1)
    assert st["candidates"] <= 5 * st["engine_calls"]
    assert st["candidates"] >= st["engine_calls"]


def test_one_level_loop_and_no_walk_a_step(monkeypatch):
    """A greedy step is one values forward of K lanes: one level-loop call,
    no walk."""
    g, zero, phi, pi0 = case("stencil")
    calls = {"segment_levels_f64": 0, "sparse_backtrace": 0}
    for name in calls:
        fn = getattr(eng, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(eng, name, counted)
    st = {}
    placement.place(g, phi, params=zero, pi0=pi0.copy(), topk=8,
                    scenarios=placement.latency_points(zero, DELTAS),
                    max_iters=3, stats=st, device="cpu")
    assert calls == {"segment_levels_f64": st["engine_calls"],
                     "sparse_backtrace": 0}


# -- dense against the reference's pallas ---------------------------------------

@pytest.mark.parametrize("name", CASES)
def test_dense_within_1e5_of_reference_pallas(name):
    pytest.importorskip("jax")
    g, zero, phi, pi0 = case(name)
    rg, rzero, rphi, _ = case(name, port=False)
    pts = placement.latency_points(zero, DELTAS)
    rpts = ref_placement.latency_points(rzero, DELTAS)
    pi, hist = placement.place(g, phi, params=zero, pi0=pi0.copy(),
                               scenarios=pts, topk=4, max_iters=4,
                               backend="dense", device="cpu")
    rst = {}
    rpi, rhist = ref_placement.place(rg, rphi, params=rzero, pi0=pi0.copy(),
                                     scenarios=rpts, topk=4, max_iters=4,
                                     backend="pallas", engine="sweep",
                                     stats=rst)
    assert rst["scalar_fallbacks"] == 0
    np.testing.assert_array_equal(pi, rpi)
    np.testing.assert_allclose(hist, rhist, rtol=1e-5)


# -- no fallback, refusals -------------------------------------------------------

def test_engine_error_reaches_the_caller(monkeypatch):
    g, zero, phi, pi0 = case("biased")

    def boom(self, *a, **kw):
        raise RuntimeError("engine failed")
    monkeypatch.setattr(api.Engine, "run", boom)
    for engine in ("auto", "sweep"):
        with pytest.raises(RuntimeError, match="engine failed"):
            placement.place(g, phi, params=zero, pi0=pi0.copy(),
                            engine=engine, device="cpu")
    # the host loop is still there by name
    placement.place(g, phi, params=zero, pi0=pi0.copy(), engine="scalar")


def test_refusals():
    g, zero, phi, pi0 = case("biased")
    with pytest.raises(ValueError, match="engine"):
        placement.place(g, phi, params=zero, engine="fastest")
    with pytest.raises(ValueError, match="batched"):
        placement.place(g, phi, params=zero, engine="scalar", topk=3)
    with pytest.raises(ValueError, match="cost_eval"):
        placement.place(g, phi, params=zero, cost_eval="recompile")
    with pytest.raises(ValueError, match="'segment' or 'dense'"):
        placement.place(g, phi, params=zero, backend="pallas", device="cpu")


@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_sharded_place_equals_unsharded(backend, monkeypatch):
    """``place(shard=)`` passes through to the engine: on the CPU ``shard``
    resolves to one device, and with each step's query split over a device
    listed twice (on the candidate axis K and on the scenario axis S) the
    mapping and history equal the unsharded search's bit for bit."""
    g, zero, phi, pi0 = case("stencil")
    pts = placement.latency_points(zero, [0.0, 2.0, 5.0, 9.0])
    kw = dict(params=zero, pi0=pi0.copy(), scenarios=pts, topk=4,
              max_iters=3, backend=backend, device="cpu")
    want = placement.place(g, phi, **kw)
    got = placement.place(g, phi, shard=True, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    run = api.Engine.run
    for axis in ("K", "S"):
        monkeypatch.setattr(api.Engine, "run", lambda self, q=None, **k: run(
            self, q, shard_axis=axis, shard_devices=["cpu", "cpu"], **k))
        n0, st = eng.split_forward.calls, {}
        got = placement.place(g, phi, stats=st, **kw)
        assert eng.split_forward.calls - n0 == st["engine_calls"] > 0
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("backend", ["segment", "dense"])
def test_placement_step_on_card_equals_cpu(backend):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g, zero, phi, pi0 = case("stencil")
    pts = placement.latency_points(zero, DELTAS)
    out = [placement.place(g, phi, params=zero, pi0=pi0.copy(),
                           scenarios=pts, topk=8, max_iters=1,
                           backend=backend, device=dev)
           for dev in (None, "cpu")]
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1]
