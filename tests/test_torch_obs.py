"""Observability on the port (``repro_torch.obs``) against the JAX
package's ``repro.obs``, and the port engine's spans and counters.

On the CPU:

* the tracer and the metrics registry behave as the reference's (the
  reference's own cases, run on the port's copies), and the same sequence
  of metric and span calls gives the same Prometheus text, the same JSON
  snapshot and the same Chrome-trace events (names, parents, arguments,
  trace ids) on both;
* the port's ``Engine.run`` emits the reference's spans under
  ``collect()`` and counts its queries, cache outcomes, occupancy,
  staged bytes and congestion iterations by the reference's metric names;
* results are bit-identical with tracing on and off;
* the compile watcher counts the kernel libraries loaded (0 on the CPU):
  a warm rerun reports 0 new programs, and a load attributed to a
  dispatch bumps ``sweep_compiles_total`` and emits ``sweep.compile``;
* an engine error under ``collect()`` reaches the caller of
  ``place(engine="auto")``.
"""

import json
import threading

import numpy as np
import pytest

from repro import obs as ref_obs
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace

from repro_torch import obs
from repro_torch.core import loggps, placement, synth
from repro_torch.kernels import build
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import Tracer, summarize
from repro_torch.sweep import (Engine, ExecPolicy, Query, SweepCache, api,
                               latency_grid)
from repro_torch.sweep.cache import SweepCache as PortCache


# -- the same calls, the same exports -------------------------------------------

def _drive(metrics_mod, trace_mod):
    """One sequence of metric and span calls on fresh objects of a
    package; returns (render, snapshot, chrome events without clocks)."""
    reg = metrics_mod.Registry()
    c = reg.counter("req_total", "Requests.", labels=("kind",))
    c.inc(kind="rank")
    c.inc(3, kind="curve")
    g = reg.gauge("occ", "Occupancy.", labels=("axis",))
    g.set(0.25, axis="S")
    g.inc(0.5, axis="S")
    h = reg.histogram("lat_seconds", "Latency.", labels=("kind",),
                      buckets=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.003, 0.05, 2.0):
        h.observe(v, kind="rank")
    reg.gauge("plain", "No labels.").set(7)
    tr = trace_mod.Tracer()
    tr.enable()
    with tr.trace_context("abc123"):
        with tr.span("outer", a=1):
            with tr.span("inner", b="x"):
                pass
        tr.add_event("late", 10, 30, k=2)
    evs = tr.to_chrome_trace()["traceEvents"]
    events = [{k: v for k, v in e.items() if k not in ("ts", "pid", "tid",
                                                       "dur")}
              for e in evs]
    return reg.render(), json.dumps(reg.snapshot(), sort_keys=True), events


def test_same_calls_same_exports_as_reference():
    assert _drive(obs.metrics, obs.trace) == _drive(ref_metrics, ref_trace)
    assert obs.trace.summarize([]) == ref_trace.summarize([])


# -- the tracer ---------------------------------------------------------------------

def test_disabled_span_is_shared_noop():
    tr = Tracer()
    s1, s2 = tr.span("a"), tr.span("b", k=1)
    assert s1 is s2
    with s1:
        pass
    assert tr.events() == []


def test_span_nesting_records_parent_and_order():
    tr = Tracer()
    tr.enable()
    with tr.span("outer"):
        with tr.span("inner", k="v"):
            pass
    inner, outer = tr.events()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == "outer" and outer.parent is None
    assert inner.args == {"k": "v"}
    assert inner.t0_ns >= outer.t0_ns and inner.t1_ns <= outer.t1_ns


def test_collect_works_while_disabled_and_is_thread_local():
    tr = Tracer()
    with tr.collect() as spans:
        with tr.span("only-here"):
            pass

        def other():
            with tr.span("other-thread"):
                pass
        t = threading.Thread(target=other)
        t.start()
        t.join()
    assert [e.name for e in spans] == ["only-here"]
    assert tr.events() == []


def test_trace_export_summary_and_bounded_buffer(tmp_path):
    tr = Tracer(max_events=4)
    tr.enable()
    with tr.trace_context("t1") as tid:
        for i in range(6):
            with tr.span("s", i=i):
                pass
    evs = tr.events()
    assert len(evs) == 4 and all(e.trace == tid == "t1" for e in evs)
    path = tr.export(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    assert len(doc["traceEvents"]) == 4
    assert doc["traceEvents"][0]["args"]["trace"] == "t1"
    assert summarize(evs)["s"]["n"] == 4


def test_registry_semantics():
    reg = Registry()
    c = reg.counter("c_total", labels=("k",))
    assert reg.counter("c_total", labels=("k",)) is c
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")
    with pytest.raises(ValueError, match="expects labels"):
        c.inc(wrong="x")
    c.inc(k="a")
    reg.reset()
    assert reg.get("c_total") is c and c.value(k="a") == 0.0

    def work():
        for _ in range(1000):
            c.inc(k="x")
    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert c.value(k="x") == 4000


def test_sweep_cache_metrics_flow_to_registry():
    hits = obs.REGISTRY.get("sweep_cache_hits_total")
    misses = obs.REGISTRY.get("sweep_cache_misses_total")
    ev = obs.REGISTRY.get("sweep_cache_evictions_total")
    h0, m0, e0 = (hits.value(patched="false"), misses.value(patched="false"),
                  ev.value())
    cache = PortCache(capacity=1)
    assert cache.get("nope") is None
    cache.put("yes", 1)
    assert cache.get("yes") == 1
    cache.put("other", 2)
    assert hits.value(patched="false") == h0 + 1
    assert misses.value(patched="false") == m0 + 1
    assert ev.value() == e0 + 1


# -- the engine ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    p = loggps.cluster_params(L_us=3.0, o_us=5.0)
    g = synth.stencil2d(4, 4, 2, params=p)
    eng = Engine(g, params=p, device="cpu")
    grid = latency_grid(p, np.linspace(0.0, 40.0, 7))
    eng.run(grid)
    return eng, grid, p


def test_engine_emits_spans_under_collect(engine):
    eng, grid, p = engine
    assert not obs.enabled()
    with obs.collect() as spans:
        eng.run(grid)
        eng.run(Query(grid, costs=np.zeros((2, eng.plan.epos_e.size))),
                compute_lam=False)
    names = [e.name for e in spans]
    assert {"sweep.canonicalize", "sweep.stage", "sweep.execute",
            "sweep.lam_backtrace", "sweep.cost_patch"} <= set(names)
    ex = [e for e in spans if e.name == "sweep.execute"]
    assert [e.args["axes"] for e in ex] == ["S", "KS"]
    assert all(e.args["backend"] == "segment" for e in ex)
    assert names.count("sweep.lam_backtrace") == 1
    cached = Engine(eng.plan, device="cpu",
                    policy=ExecPolicy(cache=SweepCache()))
    with obs.collect() as spans:
        cached.run(grid)
        cached.run(grid)
    assert [e.name for e in spans].count("sweep.cache_lookup") == 2
    assert [e.name for e in spans].count("sweep.execute") == 1


def test_congestion_spans_and_iterations_histogram():
    p = loggps.pod_model(pod_size=4, ranks_per_host=2,
                         alpha={"ici": 1.0, "dcn": 2.0}).params()
    g = synth.stencil2d(4, 4, 2, params=p)
    hist = obs.REGISTRY.get("sweep_congestion_iters")
    before = sum(r["count"] for r in hist._snapshot())
    eng = Engine(g, params=p, device="cpu",
                 policy=ExecPolicy(congestion="fixed_point", max_iters=8))
    with obs.collect() as spans:
        res = eng.run(latency_grid(p, [0.0, 5.0, 10.0]))
    assert "sweep.congestion_fixed_point" in {e.name for e in spans}
    after = sum(r["count"] for r in hist._snapshot())
    assert after - before == res.congestion_iters.size == 3


def test_results_bit_identical_tracing_on_vs_off(engine):
    eng, grid, p = engine
    was = obs.enabled()
    try:
        obs.disable()
        off = eng.run(grid)
        obs.enable()
        with obs.collect():
            on = eng.run(grid)
    finally:
        obs.enable() if was else obs.disable()
    for f in ("T", "lam", "rho"):
        assert np.array_equal(getattr(on, f), getattr(off, f))


def test_query_counter_occupancy_and_bytes(engine):
    eng, grid, p = engine
    qc = obs.REGISTRY.get("sweep_queries_total")
    off0 = qc.value(backend="segment", axes="S", cache="off")
    eng.run(grid)
    assert qc.value(backend="segment", axes="S", cache="off") == off0 + 1
    occ = obs.REGISTRY.get("sweep_envelope_occupancy")
    assert 0.0 < occ.value(axis="slots") <= 1.0
    assert occ.value(axis="S") == 7 / 8
    cached = Engine(eng.plan, device="cpu",
                    policy=ExecPolicy(cache=SweepCache()))
    # the gauge is the last staged view's
    assert obs.REGISTRY.get("sweep_dense_bytes").value(view="segment") == \
        float(eng.plan.dense_bytes())
    miss0 = qc.value(backend="segment", axes="S", cache="miss")
    hit0 = qc.value(backend="segment", axes="S", cache="hit")
    cached.run(grid)
    cached.run(grid)
    assert qc.value(backend="segment", axes="S", cache="miss") == miss0 + 1
    assert qc.value(backend="segment", axes="S", cache="hit") == hit0 + 1


# -- the compile watcher ------------------------------------------------------------

def test_watcher_warm_rerun_counts_zero(engine):
    eng, grid, p = engine
    w = obs.CompileWatcher()
    with w.watch("warm") as rec:
        eng.run(grid)
    assert rec.new_programs == 0 and rec.wall_s > 0.0
    assert w.programs() == len(build.LOADED)
    scoped = obs.CompileWatcher(cells=[obs.forward_cell("segment", True)])
    assert scoped.programs() <= w.programs()
    assert obs.forward_cell("dense", True) == ("dense_levels",
                                               "sparse_levels")
    with pytest.raises(ValueError, match="unknown forward kind"):
        obs.forward_cell("pallas")


def test_watcher_attributes_a_load_to_its_dispatch(engine, monkeypatch):
    """A library loaded during a dispatch is one new program: an event with
    the query's signature, the compile counter and a ``sweep.compile``
    span (simulated here by recording a load as ``build.load`` does)."""
    eng, grid, p = engine
    run = eng._arrays
    monkeypatch.setattr(build, "LOADED", dict(build.LOADED))

    def loading(kind):
        build.LOADED.setdefault("simulated_library", "lib.so")
        return run(kind)
    monkeypatch.setattr(eng, "_arrays", loading)
    compiles = obs.REGISTRY.get("sweep_compiles_total")
    c0 = compiles.value(backend="segment")
    n0 = len(obs.WATCHER.events())
    with obs.collect() as spans:
        eng.run(grid)
    evs = obs.WATCHER.events()[n0:]
    assert len(evs) == 1 and evs[0].new_programs == 1
    sig = evs[0].signature
    assert sig["backend"] == "segment" and sig["axes"] == "S"
    assert sig["envelope"] == (f"{eng.plan.nlv_p}x{eng.plan.Vmax}x"
                               f"{eng.plan.Dmax}") and sig["S"] == 8
    assert compiles.value(backend="segment") == c0 + 1
    assert "sweep.compile" in {e.name for e in spans}


def test_engine_error_under_collect_reaches_the_caller(monkeypatch):
    zero = loggps.LogGPS(L=(0.0,), G=(0.0,), o=0.5, S=1e18)
    g = synth.stencil2d(4, 4, 2, params=zero)
    phi = placement.ArchTopology.two_tier(16, 4)

    def boom(self, *a, **kw):
        raise RuntimeError("engine failed")
    monkeypatch.setattr(api.Engine, "run", boom)
    with obs.collect():
        with pytest.raises(RuntimeError, match="engine failed"):
            placement.place(g, phi, params=zero, engine="auto", device="cpu",
                            pi0=np.random.default_rng(2).permutation(16))


def test_reference_watcher_names_are_the_ports():
    """The reference's metric and span names are the port's."""
    for name in ("sweep_compiles_total", "sweep_compile_seconds"):
        assert type(ref_obs.REGISTRY.get(name)).__name__ == \
            type(obs.REGISTRY.get(name)).__name__
