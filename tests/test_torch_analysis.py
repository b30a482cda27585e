"""The analysis service on the port (``repro_torch.launch.analysis``)
against the port's own entry points, ``core.dag`` and the JAX package's
``repro.launch.analysis``, case for case with the reference's
``tests/test_analysis_service.py``.

On the CPU (``device="cpu"``, the kernels' plain versions), on the
reference test's study (the ring and recursive-doubling expansions of
``allreduce_chain(8, 2)`` under CSCS constants):

* every kind on the segment backend bit-equal to the same call on the
  port's ``Engine`` / ``place`` / ``resilience_curve`` / stamper, and T, λ
  and the tolerance held against the port's ``core.dag`` (bit for bit;
  the tolerance's bisection within 1e-6 relative of ``dag.tolerance``);
* every kind on the dense backend within 1e-5 (relative) of the
  reference's ``AnalysisService(backend="pallas")``, the same ranking;
* the protocol: unknown fields and policy typos rejected by name (the
  reference's "pallas" too), strict JSON for an infinite tolerance, trace
  ids and timings, the cache rule, the JSON lines on stdin, a TCP socket
  and a UNIX socket (each in a subprocess), ``/metrics`` over HTTP, and the
  CLI's ``--demo --query rank --device cpu``;
* ``ExecPolicy``'s wire format (``from_dict``, ``POLICY_WIRE_FIELDS``,
  ``shard`` / ``shard_axis`` validation), as the reference's
  ``tests/test_sweep_api.py`` checks it.

The reference's segment service fails on this JAX (its ``enable_x64``
import), so the segment answers are held against ``core.dag`` and the
port's own engine.
"""

import dataclasses
import json
import os
import pathlib
import re
import socket
import subprocess
import sys
import tempfile
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch import explore, sweep
from repro_torch.core import dag, loggps, placement, sensitivity, synth
from repro_torch.core.graph import GraphBuilder
from repro_torch.core.loggps import LogGPS, cluster_params
from repro_torch.launch.analysis import (AnalysisRequest, AnalysisResponse,
                                         AnalysisService, _demo_service,
                                         _jsonable)
from repro_torch.sweep.api import POLICY_WIRE_FIELDS, ExecPolicy

CPU = "cpu"
ALGOS = ["ring", "recursive_doubling"]
DELTAS = (0.0, 10.0, 20.0)
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
# float32 (max,+) decisions on both sides; the port carries end times in
# float64 where the reference stores float32 (sweep.engine's docstring)
DENSE_RTOL = 1e-5


def variants(S, L, sweep_mod):
    """The study's variants with one package's modules."""
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    return sweep_mod.collective_variants(
        lambda a: S.allreduce_chain(8, 2, params=p, algo=a), ALGOS, p)


def make_svc(**kw):
    s = AnalysisService(default_deltas=DELTAS, device=CPU, **kw)
    for v in variants(synth, loggps, sweep):
        s.register(v)
    return s


@pytest.fixture(scope="module")
def svc():
    return make_svc()


@pytest.fixture(scope="module")
def dense_svc():
    return make_svc(backend="dense")


@pytest.fixture(scope="module")
def ref_svc():
    """The reference's pallas service over the same study."""
    pytest.importorskip("jax")
    from repro import sweep as ref_sweep
    from repro.core import loggps as ref_loggps
    from repro.core import synth as ref_synth
    from repro.launch.analysis import AnalysisService as RefService
    s = RefService(backend="pallas", default_deltas=DELTAS)
    for v in variants(ref_synth, ref_loggps, ref_sweep):
        s.register(v)
    return s


def close(a, b, rtol=DENSE_RTOL):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=rtol,
                               atol=0.0)


def ok(resp):
    assert resp.ok, resp.error
    return resp.payload


def zero_graph(GB, LG):
    """The reference test's placement graph (zero link costs, 4 ranks)."""
    zero = LG(L=(0.0,), G=(0.0,), o=0.5, S=1e18)
    b = GB(4, 1)
    for _ in range(4):
        b.add_calc(0, 1.0)
        b.add_message(0, 1, 65536.0, zero)
        b.add_message(2, 3, 131072.0, zero)
    return b.finalize(), zero


TOPO = {"pod": 2, "L_fast": 1.0, "L_slow": 20.0, "G_fast": 1e-5,
        "G_slow": 4e-5}
# vertex 233: a compute vertex of the second step (it has in-edges, so its
# slowdown rides the cost axis)
FAULTS = [{"type": "straggler", "vertices": [233], "slowdown": 2.0},
          {"type": "link", "cls": 0, "extra_L_us": 4.0, "gscale": 1.5},
          {"type": "device", "rank": 3, "recovery_us": 100.0}]


# -- registration and warm plans --------------------------------------------

def test_register_and_warm(svc):
    assert svc.variant_names == ("algo=ring", "algo=recursive_doubling")
    with pytest.raises(ValueError, match="already registered"):
        svc.register(svc._variants["algo=ring"])
    info = svc.warm()
    assert info["variants"] == 2
    assert info["buckets"] >= 1
    assert sum(info["bucket_sizes"]) == 2
    assert all(e.device.type == "cpu" for e in svc._engines.values())
    # the warm probes are never cached
    assert len(svc.cache) == 0


# -- the kinds on segment: the port's own entry points and core.dag ----------

def test_curve_matches_direct_engine_and_core_dag(svc):
    resp = svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                      deltas=[0.0, 15.0, 30.0]))
    pl = ok(resp)
    v = svc._variants["algo=ring"]
    ref = sweep.Engine(v.graph, params=v.params, device=CPU).run(
        sweep.latency_grid(v.params, [0.0, 15.0, 30.0]))
    np.testing.assert_array_equal(pl["T"], ref.T)
    np.testing.assert_array_equal(pl["lam"], ref.lam[:, 0])
    np.testing.assert_array_equal(pl["rho"], ref.rho[:, 0])
    lp = dag.LevelPlan(v.graph)
    for d, T, lam in zip((0.0, 15.0, 30.0), pl["T"], pl["lam"]):
        s = lp.forward(v.params.with_delta(d, 0))
        assert T == s.T and lam == s.lam[0]
    assert pl["backend"] == "segment" and not pl["from_cache"]
    # the service's engine stays warm: the same query again is a cache hit
    again = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                          deltas=[0.0, 15.0, 30.0])))
    assert again["from_cache"]
    np.testing.assert_array_equal(again["T"], pl["T"])


def test_rank_orders_variants_one_call_per_bucket(svc):
    pl = ok(svc.handle(AnalysisRequest(kind="rank", deltas=[0.0, 25.0, 50.0],
                                       reduce="final")))
    # under rising latency, recursive doubling beats ring (Fig 10)
    assert pl["best"] == "algo=recursive_doubling"
    assert len(pl["ranking"]) == 2
    assert pl["compiled_calls"] <= len(svc.variant_names)
    for name, obj in pl["ranking"]:
        v = svc._variants[name]
        assert obj == dag.LevelPlan(v.graph).forward(
            v.params.with_delta(50.0, 0)).T


def test_tolerance_matches_engine_and_scalar(svc):
    pl = ok(svc.handle(AnalysisRequest(kind="tolerance",
                                       variant="algo=ring",
                                       degradations=[0.05])))
    v = svc._variants["algo=ring"]
    direct = sweep.tolerance_batched(
        sweep.Engine(v.graph, params=v.params, device=CPU), v.params,
        (0.05,))
    assert pl["tolerance"] == direct
    want = dag.tolerance(v.graph, v.params, 0.05)
    assert pl["tolerance"][0.05] == pytest.approx(want, rel=1e-6)


def test_bandwidth_query(svc):
    pl = ok(svc.handle(AnalysisRequest(kind="bandwidth", variant="algo=ring",
                                       gscales=[1.0, 4.0])))
    T = np.asarray(pl["T"])
    assert T[1] > T[0]                  # 4× slower links ⇒ longer step
    v = svc._variants["algo=ring"]
    ref = sweep.Engine(v.graph, params=v.params, device=CPU).run(
        sweep.bandwidth_grid(v.params, [1.0, 4.0]), compute_lam=False)
    np.testing.assert_array_equal(T, ref.T)


def test_placement_query_matches_direct_place():
    """Placement suggestions ride the same service (two-tier Φ spec), equal
    to ``core.placement.place`` called directly."""
    g, zero = zero_graph(GraphBuilder, LogGPS)
    s = AnalysisService(device=CPU)
    s.register_graph("app", g, zero)
    pl = ok(s.handle(AnalysisRequest(kind="placement", topo=TOPO,
                                     deltas=[0.0, 2.0], topk=2)))
    assert sorted(pl["mapping"]) == [0, 1, 2, 3]
    hist = pl["history"]
    assert hist[-1] <= hist[0]
    spec = dict(TOPO)
    phi = placement.ArchTopology.two_tier(4, spec.pop("pod"), **spec)
    pi, want = placement.place(
        g, phi, params=zero, topk=2, device=CPU,
        scenarios=placement.latency_points(zero, [0.0, 2.0]))
    np.testing.assert_array_equal(pl["mapping"], pi)
    assert hist == want
    assert pl["stats"]["scalar_fallbacks"] == 0


def test_placement_rejects_nonzero_link_params(svc):
    """A variant registered with real link params would count every
    message twice under Φ — the service refuses."""
    resp = svc.handle(AnalysisRequest(kind="placement"))
    assert not resp.ok and "zero-link-cost" in resp.error


def test_resilience_matches_direct_curve_and_core_dag(svc):
    v = svc._variants["algo=ring"]
    pl = ok(svc.handle(AnalysisRequest(kind="resilience",
                                       variant="algo=ring", faults=FAULTS,
                                       weights=[0.2, 0.3, 0.1])))
    faults = AnalysisService._parse_faults(FAULTS)
    rep = sensitivity.resilience_curve(v.graph, v.params, faults,
                                       weights=[0.2, 0.3, 0.1], device=CPU)
    np.testing.assert_array_equal(pl["T_fault"], rep.T_fault)
    assert pl["T0"] == rep.T0 == dag.evaluate(v.graph, v.params).T
    assert pl["expected_slowdown"] == rep.expected_slowdown
    assert pl["faults"] == list(rep.names) and pl["rank"] == rep.rank()
    # the straggler's T against core.dag on the slowed graph
    g = v.graph
    vc = g.vcost.copy()
    vc[233] *= 2.0
    assert pl["T_fault"][0] == dag.evaluate(
        dataclasses.replace(g, vcost=vc), v.params).T
    bad = svc.handle(AnalysisRequest(kind="resilience",
                                     faults=[{"type": "meteor"}]))
    assert not bad.ok and "meteor" in bad.error
    assert not svc.handle(AnalysisRequest(kind="resilience")).ok


EXPLORE = dict(kind="explore", space="codesign",
               space_args={"P": 8, "iters": 2}, generations=2,
               population=4, budget=6, seed=1)


def test_explore_matches_direct_search(svc):
    pl = ok(svc.handle(AnalysisRequest(**EXPLORE)))
    space, lower = explore.preset("codesign", P=8, iters=2, params=LogGPS())
    scen = sweep.sample_grid(LogGPS(), 6, rng=1, lat_deltas=(0.0, 100.0))
    res = explore.run_search(
        explore.make_searcher("random", space, 1), lower, scen,
        generations=2, population=4,
        objective=explore.robust_makespan(),
        stamper=explore.Stamper(device=CPU))
    assert pl["best"] == res.best
    assert pl["best_objective"] == res.best_objective
    assert pl["n_evaluated"] == res.n_evaluated
    assert [h["best_objective"] for h in pl["history"]] == \
        [h["best_objective"] for h in res.history]
    # the service's stamper stays warm: a repeat is served by its cache
    again = ok(svc.handle(AnalysisRequest(**EXPLORE)))
    assert again["best_objective"] == pl["best_objective"]
    assert again["stamper"]["plan_hits"] > pl["stamper"]["plan_hits"]


# -- the kinds on dense: the reference's pallas service ----------------------

def test_dense_curve_bandwidth_tolerance_within_1e5_of_reference(
        dense_svc, ref_svc):
    for name in dense_svc.variant_names:
        for kind, kw in (("curve", {"deltas": [0.0, 15.0, 30.0]}),
                         ("bandwidth", {"gscales": [1.0, 4.0]})):
            got = ok(dense_svc.handle(AnalysisRequest(kind=kind,
                                                      variant=name, **kw)))
            want = ok(ref_svc.handle(AnalysisRequest(kind=kind,
                                                     variant=name, **kw)))
            assert got["backend"] == "dense" and want["backend"] == "pallas"
            close(got["T"], want["T"])
            if kind == "curve":
                close(got["lam"], want["lam"])
                close(got["rho"], want["rho"])
        got = ok(dense_svc.handle(AnalysisRequest(
            kind="tolerance", variant=name, degradations=[0.01, 0.05])))
        want = ok(ref_svc.handle(AnalysisRequest(
            kind="tolerance", variant=name, degradations=[0.01, 0.05])))
        for d in (0.01, 0.05):
            close(got["tolerance"][d], want["tolerance"][d])


def test_dense_rank_same_ranking_as_reference(dense_svc, ref_svc):
    for reduce, top in (("final", 50.0), ("mean", 40.0)):
        req = AnalysisRequest(kind="rank", deltas=[0.0, 25.0, top],
                              reduce=reduce)
        got, want = ok(dense_svc.handle(req)), ok(ref_svc.handle(req))
        assert [n for n, _ in got["ranking"]] == \
            [n for n, _ in want["ranking"]]
        close([o for _, o in got["ranking"]], [o for _, o in want["ranking"]])
        assert got["compiled_calls"] == want["compiled_calls"] == 1


def test_dense_placement_resilience_explore_within_1e5_of_reference(
        ref_svc):
    from repro.core.graph import GraphBuilder as RefGB
    from repro.core.loggps import LogGPS as RefLogGPS
    from repro.launch.analysis import AnalysisRequest as RefRequest
    from repro.launch.analysis import AnalysisService as RefService
    g, zero = zero_graph(GraphBuilder, LogGPS)
    rg, rzero = zero_graph(RefGB, RefLogGPS)
    mine = AnalysisService(backend="dense", device=CPU)
    mine.register_graph("app", g, zero)
    ref = RefService(backend="pallas")
    ref.register_graph("app", rg, rzero)
    kw = dict(kind="placement", topo=TOPO, deltas=[0.0, 2.0], topk=2)
    got = ok(mine.handle(AnalysisRequest(**kw)))
    want = ok(ref.handle(RefRequest(**kw)))
    np.testing.assert_array_equal(got["mapping"], want["mapping"])
    close(got["history"], want["history"])
    # resilience and explore on the study's service pair
    dense = make_svc(backend="dense")
    kw = dict(kind="resilience", variant="algo=ring", faults=FAULTS)
    got = ok(dense.handle(AnalysisRequest(**kw)))
    want = ok(ref_svc.handle(RefRequest(**kw)))
    close(got["T_fault"], want["T_fault"])
    close(got["expected_slowdown"], want["expected_slowdown"])
    assert [n for n, _ in got["rank"]] == [n for n, _ in want["rank"]]
    got = ok(dense.handle(AnalysisRequest(**EXPLORE)))
    want = ok(ref_svc.handle(RefRequest(**EXPLORE)))
    assert got["best"] == want["best"]
    close(got["best_objective"], want["best_objective"])
    close([h["best_objective"] for h in got["history"]],
          [h["best_objective"] for h in want["history"]])


def test_per_request_backend_plumbs_to_engine(svc, ref_svc):
    """A query picks the backend per request: dense answers λ natively,
    within the float32 contract of segment and of the reference's
    pallas."""
    seg = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                        deltas=[0.0, 10.0, 20.0])))
    den = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                        deltas=[0.0, 10.0, 20.0],
                                        backend="dense")))
    assert den["backend"] == "dense" and seg["backend"] == "segment"
    close(den["T"], seg["T"])
    np.testing.assert_array_equal(den["lam"], seg["lam"])
    pal = ok(ref_svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                            deltas=[0.0, 10.0, 20.0])))
    close(den["T"], pal["T"])
    r = ok(svc.handle(AnalysisRequest(kind="rank", deltas=[0.0, 25.0],
                                      backend="dense", reduce="final")))
    assert r["best"] == "algo=recursive_doubling"
    bad = svc.handle(AnalysisRequest(kind="curve", backend="pallas"))
    assert not bad.ok and "unknown backend 'pallas'" in bad.error


# -- the protocol -------------------------------------------------------------

def test_stats_and_unknown_kind(svc):
    svc.handle(AnalysisRequest(kind="curve", variant="algo=ring"))
    svc.handle(AnalysisRequest(kind="curve", variant="algo=ring"))
    pl = ok(svc.handle(AnalysisRequest(kind="stats")))
    assert pl["variants"] == list(svc.variant_names)
    assert pl["cache"]["hits"] >= 1    # the repeated curve query
    bad = svc.handle(AnalysisRequest(kind="explode"))
    assert not bad.ok and "unknown kind" in bad.error


def test_query_errors_become_responses(svc):
    """A failing query produces ok=False, not an exception."""
    resp = svc.handle(AnalysisRequest(kind="curve", variant="nope"))
    assert not resp.ok and "unknown variant" in resp.error
    # a rank over a class some variant lacks is an error, never a ranking
    # of incomparable sweeps
    resp = svc.handle(AnalysisRequest(kind="rank", cls=1))
    assert not resp.ok and "unknown to variants" in resp.error


def test_json_lines_protocol(svc):
    line = AnalysisRequest(kind="rank", deltas=[0.0, 30.0]).to_json()
    out = json.loads(svc.handle_json(line))
    assert out["ok"] and out["kind"] == "rank"
    assert out["payload"]["best"] == "algo=recursive_doubling"
    assert isinstance(out["payload"]["deltas"], list)   # ndarray serialized
    assert not json.loads(svc.handle_json("{not json"))["ok"]
    assert not json.loads(svc.handle_json("[1, 2]"))["ok"]
    bad = json.loads(svc.handle_json('{"kind": "rank", "frobnicate": 1}'))
    assert not bad["ok"] and "frobnicate" in bad["error"]


def test_response_serialization_roundtrip():
    resp = AnalysisResponse(kind="curve", ok=True,
                            payload={"T": np.asarray([1.0, 2.0]),
                                     "n": np.int64(3),
                                     "t": torch.tensor([4.0, float("inf")]),
                                     "b": np.bool_(True)},
                            elapsed_ms=1.5)
    out = json.loads(resp.to_json())
    assert out["payload"]["T"] == [1.0, 2.0] and out["payload"]["n"] == 3
    assert out["payload"]["t"] == [4.0, "inf"] and out["payload"]["b"]
    assert _jsonable((np.float32(2.5), float("nan"))) == [2.5, "nan"]


def test_unbounded_tolerance_serializes_as_strict_json():
    """An unbounded tolerance (a class never on the critical path) comes
    back as the string "inf", never the bare Infinity token."""
    p = LogGPS(L=(1.0,), G=(1e-6,), o=0.5, S=1e18)
    b = GraphBuilder(2, 1)
    for _ in range(3):                  # pure compute: no latency edges
        b.add_calc(0, 10.0)
        b.add_calc(1, 10.0)
    s = AnalysisService(device=CPU)
    s.register_graph("compute_only", b.finalize(), p)
    line = s.handle_json('{"kind": "tolerance", "degradations": [0.01]}')
    assert "Infinity" not in line
    out = json.loads(line)
    assert out["ok"], out["error"]
    assert out["payload"]["tolerance"]["0.01"] == "inf"


def test_policy_block_per_request(svc):
    """One ``policy`` block overlays the service policy for one query."""
    den = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                        deltas=[0.0, 10.0],
                                        policy={"backend": "dense"})))
    assert den["backend"] == "dense"
    # fd λ per query: T bit for bit, λ equal to the walk's away from kinks
    fd = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                       deltas=[0.31, 9.73],
                                       policy={"lam": "fd"})))
    ex = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                       deltas=[0.31, 9.73])))
    np.testing.assert_array_equal(fd["T"], ex["T"])
    np.testing.assert_allclose(fd["lam"], ex["lam"], atol=1e-6)
    # a split per query: bit for bit
    sh = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                       deltas=[0.5, 1.5],
                                       policy={"shard": True,
                                               "shard_axis": "S"})))
    ex = ok(svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                       deltas=[0.5, 1.5])))
    np.testing.assert_array_equal(sh["T"], ex["T"])
    assert ex["from_cache"]             # the key does not hold the shard


def test_policy_typo_rejected(svc):
    """Unknown keys anywhere in a request — the nested policy block too —
    are rejected with the offending names."""
    resp = svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                      policy={"bakend": "dense"}))
    assert not resp.ok and "bakend" in resp.error
    bad = json.loads(svc.handle_json(
        '{"kind": "curve", "policy": {"bakend": "dense"}}'))
    assert not bad["ok"] and "bakend" in bad["error"]
    for pol in ('{"backend": "cuda"}', '{"backend": "pallas"}'):
        bad2 = json.loads(svc.handle_json(
            f'{{"kind": "curve", "policy": {pol}}}'))
        assert not bad2["ok"] and "backend" in bad2["error"]
    bad3 = json.loads(svc.handle_json('{"kind": "curve", "policy": 7}'))
    assert not bad3["ok"]
    bad4 = json.loads(svc.handle_json(
        '{"kind": "curve", "policy": {"shard": "always"}}'))
    assert not bad4["ok"] and "shard" in bad4["error"]


def test_service_honors_policy_cache():
    """A policy carrying its own cache is the caller's choice; the shared
    DEFAULT_CACHE is not, and an explicit ``cache=`` wins."""
    p = cluster_params(L_us=3.0, o_us=5.0)
    shared = sweep.SweepCache(capacity=16)
    s = AnalysisService(policy=ExecPolicy(cache=shared), device=CPU)
    assert s.cache is shared and s.policy.cache is shared
    s.register_graph("g", synth.stencil2d(2, 2, 2, params=p), p)
    resp = s.handle(AnalysisRequest(kind="curve", deltas=[0.0, 5.0]))
    assert resp.ok and shared.stats.misses >= 1
    own = sweep.SweepCache(capacity=4)
    s2 = AnalysisService(cache=own, policy=ExecPolicy(cache=shared),
                         device=CPU)
    assert s2.cache is own and s2.policy.cache is own
    s3 = AnalysisService(policy=ExecPolicy(cache=sweep.DEFAULT_CACHE),
                         device=CPU)
    assert s3.cache is not sweep.DEFAULT_CACHE
    assert s3.cache.capacity == 256 and s3.policy.cache is s3.cache
    s4 = AnalysisService(device=CPU)
    assert s4.cache.capacity == 256 and s4.policy.cache is s4.cache
    # every engine the service makes names the service's cache
    s.warm()
    assert all(e.policy.cache is shared for e in s._engines.values())


def test_trace_id_and_timings_on_responses(svc):
    """Every response carries a trace id (the client's, echoed, or a fresh
    one) and a dispatched one the per-phase timings."""
    resp = svc.handle(AnalysisRequest(kind="curve", variant="algo=ring",
                                      deltas=[0.17, 7.39], trace="req-42"))
    assert resp.ok, resp.error
    assert resp.trace == "req-42"
    assert "analysis.curve" in resp.timings
    assert any(k.startswith("sweep.") for k in resp.timings), resp.timings
    assert resp.timings["analysis.curve"]["n"] == 1
    resp2 = svc.handle(AnalysisRequest(kind="stats"))
    assert resp2.trace and len(resp2.trace) == 16
    bad = svc.handle(AnalysisRequest(kind="curve", variant="nope",
                                     trace="req-43"))
    assert not bad.ok and bad.trace == "req-43"
    out = json.loads(svc.handle_json(json.dumps(
        {"kind": "curve", "variant": "algo=ring",
         "deltas": [0.0, 10.0], "trace": "req-44"})))
    assert out["trace"] == "req-44" and "analysis.curve" in out["timings"]


def test_metrics_query_kind(svc):
    svc.handle(AnalysisRequest(kind="curve", variant="algo=ring"))
    pl = ok(svc.handle(AnalysisRequest(kind="metrics")))
    snap = pl["metrics"]
    assert "sweep_cache_hits_total" in snap
    assert "analysis_requests_total" in snap
    assert snap["analysis_request_seconds"]["type"] == "histogram"
    curve_ok = [s for s in snap["analysis_requests_total"]["series"]
                if s["labels"] == {"kind": "curve", "ok": "true"}]
    assert curve_ok and curve_ok[0]["value"] >= 1
    assert "hit_rate" in pl["cache"]
    assert pl["trace_enabled"] in (True, False)
    json.loads(AnalysisResponse(kind="metrics", ok=True, payload=pl,
                                elapsed_ms=0.0).to_json())


# -- transport: stdin, sockets, HTTP, the CLI ---------------------------------

def _env():
    return {**os.environ,
            "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}


def _cli(*args):
    return [sys.executable, "-m", "repro_torch.launch.analysis", "--demo",
            "--device", "cpu", *args]


def _ask(addr, payload: dict) -> dict:
    family = socket.AF_UNIX if isinstance(addr, str) else socket.AF_INET
    with socket.socket(family, socket.SOCK_STREAM) as s:
        s.settimeout(120)
        s.connect(addr)
        f = s.makefile("rw", encoding="utf-8")
        f.write(json.dumps(payload) + "\n")
        f.flush()
        return json.loads(f.readline())


@pytest.mark.parametrize("transport", ["tcp", "unix"])
def test_socket_server_round_trip(transport):
    """The JSON-lines protocol over a socket: a subprocess serves --demo;
    two connections share one warm service — the second connection's
    identical query is a cache hit — and equal the in-process service."""
    with tempfile.TemporaryDirectory() as tmp:
        where = ("127.0.0.1:0" if transport == "tcp"
                 else os.path.join(tmp, "analysis.sock"))
        proc = subprocess.Popen(_cli("--serve-socket", where), env=_env(),
                                stderr=subprocess.PIPE, text=True)
        try:
            addr = None
            for line in proc.stderr:        # warm line, then the bind
                m = re.search(r"listening on (\S+)", line)
                if m:
                    bound = m.group(1)
                    addr = bound if transport == "unix" else (
                        bound.rsplit(":", 1)[0], int(bound.rsplit(":", 1)[1]))
                    break
            assert addr is not None, "server never reported a bound address"
            q = {"kind": "curve", "variant": "algo=ring",
                 "deltas": [0.0, 10.0, 20.0]}
            r1 = _ask(addr, q)
            assert r1["ok"], r1.get("error")
            assert r1["payload"]["from_cache"] is False
            r2 = _ask(addr, q)              # a new connection, same service
            assert r2["ok"] and r2["payload"]["from_cache"] is True
            np.testing.assert_array_equal(r1["payload"]["T"],
                                          r2["payload"]["T"])
            local = json.loads(_demo_service("segment", CPU).handle_json(
                json.dumps(q)))
            assert local["payload"] == dict(r1["payload"])
            bad = _ask(addr, {"kind": "curve", "policy": {"bakend": "x"}})
            assert not bad["ok"] and "bakend" in bad["error"]
        finally:
            proc.terminate()
            proc.wait(timeout=30)
            proc.stderr.close()


def test_serve_loop_on_stdin():
    """``--serve``: one response line a request line, a bad line as an
    ok=false response, the loop surviving it."""
    lines = [json.dumps({"kind": "rank", "deltas": [0.0, 40.0]}),
             "{not json", json.dumps({"kind": "tolerance",
                                      "degradations": [0.01]})]
    out = subprocess.run(_cli("--serve"), env=_env(), capture_output=True,
                         text=True, input="\n".join(lines) + "\n",
                         timeout=600)
    assert out.returncode == 0, out.stderr
    resp = [json.loads(x) for x in out.stdout.splitlines()]
    assert [r["ok"] for r in resp] == [True, False, True]
    local = _demo_service("segment", CPU)
    assert resp[0]["payload"]["ranking"] == json.loads(
        local.handle_json(lines[0]))["payload"]["ranking"]


def test_metrics_endpoint_http_scrape():
    """The Prometheus endpoint beside the socket protocol: queries through
    the socket move the series the scrape reports."""
    proc = subprocess.Popen(
        _cli("--serve-socket", "127.0.0.1:0", "--metrics", "127.0.0.1:0"),
        env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        metrics_url = addr = None
        for line in proc.stderr:        # warm → metrics bind → socket bind
            m = re.search(r"metrics on (http://[\d.]+:\d+)/metrics", line)
            if m:
                metrics_url = m.group(1)
            m = re.search(r"listening on ([\d.]+):(\d+)", line)
            if m:
                addr = (m.group(1), int(m.group(2)))
                break
        assert metrics_url and addr, "server never reported its addresses"
        q = {"kind": "curve", "variant": "algo=ring",
             "deltas": [0.0, 10.0], "trace": "scrape-1"}
        r1 = _ask(addr, q)
        assert r1["ok"] and r1["trace"] == "scrape-1"
        r2 = _ask(addr, dict(q, trace="scrape-2"))   # same query → cache hit
        assert r2["ok"] and r2["trace"] == "scrape-2"
        assert r2["payload"]["from_cache"] is True
        text = urllib.request.urlopen(metrics_url + "/metrics",
                                      timeout=60).read().decode()
        assert "# TYPE sweep_cache_hits_total counter" in text
        assert re.search(r'sweep_cache_hits_total\{patched="false"\} [1-9]',
                         text), text
        assert 'analysis_requests_total{kind="curve",ok="true"} 2' in text
        assert re.search(r'analysis_request_seconds_bucket\{kind="curve",'
                         r'le="\+Inf"\} 2', text), text
        js = json.loads(urllib.request.urlopen(
            metrics_url + "/metrics.json", timeout=60).read().decode())
        assert "analysis_request_seconds" in js
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()


def test_demo_service_cli_rank(ref_svc):
    """The --demo study: 4 collective variants, rank end to end in one
    packed forward, in process and through the CLI; its dense ranking is
    the reference's pallas demo's."""
    svc = _demo_service("segment", CPU)
    assert len(svc.variant_names) == 4
    pl = ok(svc.handle(AnalysisRequest(kind="rank", deltas=[0.0, 40.0])))
    assert pl["compiled_calls"] < 4   # packed, not per-variant
    out = subprocess.run(_cli("--query", "rank", "--deltas", "0:40:2"),
                         env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    assert "warmed 4 variants" in out.stderr
    cli = json.loads(out.stdout.strip().splitlines()[-1])
    assert cli["ok"] and cli["payload"]["ranking"] == [
        list(r) for r in pl["ranking"]]
    from repro.launch.analysis import _demo_service as ref_demo
    want = ok(ref_demo("pallas").handle(AnalysisRequest(
        kind="rank", deltas=[0.0, 40.0])))
    got = ok(_demo_service("dense", CPU).handle(AnalysisRequest(
        kind="rank", deltas=[0.0, 40.0])))
    assert [n for n, _ in got["ranking"]] == [n for n, _ in want["ranking"]]
    close([o for _, o in got["ranking"]], [o for _, o in want["ranking"]])


def test_sparse_only_variant_keeps_its_route():
    """A variant past the dense guard compiles sparse-only, as the engine
    switches by itself; the service keeps that route for its queries and
    ranks it beside the packed buckets of the rest, equal to core.dag."""
    p = cluster_params(L_us=3.0, o_us=5.0)
    small = synth.stencil2d(2, 2, 2, params=p)
    big = synth.stencil2d(4, 4, 3, params=p)
    s = AnalysisService(policy=ExecPolicy(max_dense_bytes=sweep.
                                          estimate_dense_bytes(small) * 2),
                        device=CPU)
    s.register_graph("small", small, p)
    s.register_graph("big", big, p)
    with pytest.warns(RuntimeWarning, match="auto-switching"):
        s.warm()
    assert s.engine("big").sparse is not None
    pl = ok(s.handle(AnalysisRequest(kind="curve", variant="big",
                                     deltas=[0.0, 3.0])))
    assert pl["backend"] == "sparse"
    lp = dag.LevelPlan(big)
    for d, T, lam in zip((0.0, 3.0), pl["T"], pl["lam"]):
        st = lp.forward(p.with_delta(d, 0))
        assert T == st.T and lam == st.lam[0]
    tol = ok(s.handle(AnalysisRequest(kind="tolerance", variant="big",
                                      degradations=[0.05])))["tolerance"]
    assert tol[0.05] == pytest.approx(dag.tolerance(big, p, 0.05), rel=1e-6)
    r = ok(s.handle(AnalysisRequest(kind="rank", deltas=[0.0, 3.0],
                                    reduce="final")))
    assert r["compiled_calls"] == 2 and r["best"] == "small"
    assert dict(r["ranking"])["big"] == lp.forward(p.with_delta(3.0, 0)).T
    bad = s.handle(AnalysisRequest(kind="curve", variant="big",
                                   backend="segment"))
    assert not bad.ok and "sparse-only" in bad.error


# -- ExecPolicy's wire format (reference tests/test_sweep_api.py) -------------

def test_policy_validation():
    with pytest.raises(ValueError, match="backend"):
        ExecPolicy(backend="cuda").validate()
    with pytest.raises(ValueError, match="backend"):
        ExecPolicy(backend="pallas").validate()
    with pytest.raises(ValueError, match="shard_axis"):
        ExecPolicy(shard_axis="Z").validate()
    with pytest.raises(ValueError, match="lam mode"):
        ExecPolicy(lam="approx").validate()
    with pytest.raises(ValueError, match="fd_eps"):
        ExecPolicy(fd_eps=0.0).validate()
    with pytest.raises(ValueError, match="dtype"):
        ExecPolicy(dtype="bfloat16").validate()
    with pytest.raises(ValueError, match="float64"):
        ExecPolicy(backend="segment", dtype="float32").validate()
    with pytest.raises(ValueError, match="float32"):
        ExecPolicy(backend="dense", dtype="float64").validate()
    ExecPolicy(backend="segment", dtype="float64").validate()
    ExecPolicy(backend="dense", dtype="float32").validate()


def test_policy_from_dict_rejects_unknown_and_wire_fields():
    assert POLICY_WIRE_FIELDS == (
        "backend", "shard", "shard_axis", "lam", "fd_eps", "dtype",
        "congestion", "max_iters", "tol", "max_dense_bytes")
    with pytest.raises(ValueError, match=r"bakend"):
        ExecPolicy.from_dict({"bakend": "dense"})
    with pytest.raises(ValueError, match=r"\['bakend', 'sahrd'\]"):
        ExecPolicy.from_dict({"bakend": "dense", "sahrd": 2})
    # cache is a process-local object, never wire state
    with pytest.raises(ValueError, match="cache"):
        ExecPolicy.from_dict({"cache": None})
    pol = ExecPolicy.from_dict({"backend": "dense", "lam": "fd"},
                               base=ExecPolicy(shard=2))
    assert (pol.backend, pol.lam, pol.shard) == ("dense", "fd", 2)
    assert ExecPolicy.from_dict({}) == ExecPolicy()


def test_policy_shard_validation_and_key():
    with pytest.raises(ValueError, match="shard"):
        ExecPolicy(shard="always").validate()
    with pytest.raises(ValueError, match="shard"):
        ExecPolicy.from_dict({"shard": "always"})
    for ok_shard in ("auto", 2, True, False, None, np.int64(4)):
        ExecPolicy(shard=ok_shard).validate()
    # engines are memoized apart by shard; results are not
    assert ExecPolicy(shard=2).key() != ExecPolicy().key()
    assert ExecPolicy(shard_axis="K").key() != ExecPolicy().key()
