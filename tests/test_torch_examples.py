"""The example flows on the port (``repro_torch.examples``), narrow, on the
CPU (``device="cpu"``, the kernels' plain versions).

Each flow is held against the port's ``core.dag`` and the JAX package's
``repro.core.dag`` on the same inputs built with each package's modules
(T and λ bit for bit on the float64 routes; tolerances within 1e-6
relative of ``dag.tolerance``, the bisections' own stopping rule; the LP
within 1e-6), and a flow that ranks, on the dense backend, against the
reference's ``AnalysisService(backend="pallas")`` (the same ranking, the
objectives within 1e-5 relative).  Each module also runs as ``python -m
repro_torch.examples.<name> --device cpu`` at a narrow size.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import configs, explore
from repro_torch.core import dag, topology
from repro_torch.core.tracer import TraceSpec, trace_step
from repro_torch.examples import (collective_study, explore_study,
                                  latency_tolerance, quickstart, sweep_study,
                                  topology_study)
from repro_torch.models.config import TRAIN_4K
from repro_torch.sweep import ExecPolicy

CPU = "cpu"
SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
MESH = (1, 2, 2)
SMALL_TOPOS = [("fat_tree(k=4)", lambda T: T.fat_tree(4)),
               ("dragonfly(2,2,4)", lambda T: T.dragonfly(2, 2, 4)),
               ("torus(4x4)", lambda T: T.torus((4, 4)))]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules the flows are held against."""
    pytest.importorskip("jax")
    from repro import configs as rc
    from repro.core import dag as rdag
    from repro.core import topology as rtopo
    from repro.core import tracer as rtracer
    from repro.launch import analysis as ranalysis
    from repro.models import config as rconfig
    return {"configs": rc, "dag": rdag, "topology": rtopo,
            "tracer": rtracer, "analysis": ranalysis, "config": rconfig}


def same_dag(g, p, rg, rp, deltas=(0.0,), cls=0):
    """T and λ at each ΔL of the port's core.dag, equal to the reference's
    on its own graph."""
    out = []
    for d in deltas:
        s = dag.LevelPlan(g).forward(p.with_delta(d, cls))
        r = ref_forward(rg, rp, d, cls)
        assert s.T == r.T
        np.testing.assert_array_equal(s.lam, r.lam)
        out.append(s)
    return out


def ref_forward(rg, rp, d, cls):
    from repro.core import dag as rdag
    return rdag.LevelPlan(rg).forward(rp.with_delta(d, cls))


def run_main(name, *args):
    env = {**os.environ,
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    out = subprocess.run([sys.executable, "-m", f"repro_torch.examples.{name}",
                          "--device", "cpu", *args], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


# -- quickstart ------------------------------------------------------------------

def test_quickstart_flow(ref):
    out = quickstart.flow(3, 3, 4, device=CPU)
    g, p = out["graph"], out["params"]
    from repro.core import synth as rsynth
    from repro.core.loggps import cluster_params as rcluster
    rp = rcluster(L_us=3.0, o_us=5.0)
    rg = rsynth.stencil2d(3, 3, 4, halo_bytes=64e3, comp_us=500.0, params=rp)
    scheds = same_dag(g, p, rg, rp, out["deltas"])
    np.testing.assert_array_equal(out["curve"].T, [s.T for s in scheds])
    np.testing.assert_array_equal(out["curve"].lam,
                                  [s.lam[0] for s in scheds])
    rep = out["report"]
    assert rep.T == scheds[0].T and np.array_equal(rep.lam, scheds[0].lam)
    assert out["lp"].T == pytest.approx(rep.T, rel=1e-6)
    for d, t in out["tolerance"].items():
        assert t == pytest.approx(dag.tolerance(g, p, d), rel=1e-6)
    assert out["critical"] == pytest.approx(dag.breakpoints(g, p, 0.5, 500.0))
    assert out["rrmse"] <= 1e-9


def test_quickstart_main():
    text = run_main("quickstart")
    assert "RRMSE" in text and "critical latencies" in text


# -- latency tolerance ------------------------------------------------------------

ARCHS = ("llama3.2-3b", "jamba-1.5-large-398b")


def test_latency_tolerance_flow(ref):
    out = latency_tolerance.flow(ARCHS, *MESH, smoke=True, device=CPU)
    p = out["params"]
    rts = ref["tracer"].TraceSpec(pods=1, data=2, model=2, mfu=0.5)
    rp = rts.params()
    for arch, (g, s, tol) in out["rows"].items():
        rg = ref["tracer"].trace_step(ref["configs"].get(arch)[1],
                                      ref["config"].TRAIN_4K, rts)
        r = ref["dag"].LevelPlan(rg).forward(rp)
        assert s.T == r.T and np.array_equal(s.lam, r.lam)
        for d, t in tol.items():
            want = ref["dag"].tolerance(rg, rp, d, cls=1)
            assert t == pytest.approx(want, rel=1e-6)
            assert t == pytest.approx(dag.tolerance(g, p, d, cls=1),
                                      rel=1e-6)


def test_latency_tolerance_main():
    text = run_main("latency_tolerance", "--pods", "1", "--data", "2",
                    "--model", "2", "--smoke", "--archs", *ARCHS)
    assert all(a in text for a in ARCHS) and "DCN +5%" in text


# -- sweep study -----------------------------------------------------------------

SWEEP = dict(cg=(2, 2, 3), pod=2, lat_points=6, gscales=(1.0, 2.0),
             chain=(8, 2), deltas=np.linspace(0.0, 100.0, 5))


def test_sweep_study_flow(ref):
    out = sweep_study.flow(**SWEEP, device=CPU)
    g, p, res, grid = out["graph"], out["params"], out["res"], out["grid"]
    from repro.core import synth as rsynth
    from repro.core.loggps import pod_model as rpod
    rp = rpod(2, L_ici_us=1.0, L_dcn_us=10.0).params()
    rg = rsynth.cg_like(2, 2, 3, params=rp)
    assert res.S == 12 and out["again"].from_cache
    _equal_arrays(out["again"], res)
    plan = dag.LevelPlan(g)
    for i in np.flatnonzero(grid.gscale[:, 1] == 1.0):
        pt = p.replace(L=tuple(grid.L[i]))
        s = plan.forward(pt)
        r = ref["dag"].LevelPlan(rg).forward(rp.replace(L=tuple(grid.L[i])))
        assert res.T[i] == s.T == r.T
        np.testing.assert_array_equal(res.lam[i], s.lam)
    # a slower DCN never shortens the step
    T = res.T.reshape(6, 2)
    assert (T[:, 1] >= T[:, 0]).all()
    for v in out["variants"]:
        one = out["by_algo"][v.name]
        lp = dag.LevelPlan(v.graph)
        for d, T, lam in zip(out["deltas"], one.T, one.lam):
            s = lp.forward(v.params.with_delta(d, 0))
            assert T == s.T and np.array_equal(lam, s.lam)


def _equal_arrays(a, b):
    for f in ("T", "lam", "rho"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_sweep_study_main():
    text = run_main("sweep_study")
    assert "re-run from cache: True" in text and "λ_L at base point" in text


# -- collective study (Fig 10) -----------------------------------------------------

COLL_DELTAS = np.linspace(0.0, 50.0, 5)


@pytest.fixture(scope="module")
def coll_graphs(ref):
    """{algo: (port graph, params, reference graph, params)} of jamba's
    SMOKE step at MESH."""
    cfg = configs.get(collective_study.ARCH)[1]
    rcfg = ref["configs"].get(collective_study.ARCH)[1]
    out = {}
    for algo in collective_study.ALGOS:
        ts = TraceSpec(*MESH, allreduce_algo=algo)
        rts = ref["tracer"].TraceSpec(*MESH, allreduce_algo=algo)
        out[algo] = (trace_step(cfg, TRAIN_4K, ts), ts.params(),
                     ref["tracer"].trace_step(rcfg, ref["config"].TRAIN_4K,
                                              rts), rts.params())
    return out


def test_collective_study_flow(coll_graphs):
    out = collective_study.flow(configs.get(collective_study.ARCH)[1],
                                mesh=MESH, deltas=COLL_DELTAS, device=CPU)
    for algo, (curve, tol) in out["rows"].items():
        g, p, rg, rp = coll_graphs[algo]
        s, = same_dag(g, p, rg, rp)
        assert curve["T"][0] == s.T and curve["lam"][0] == s.lam[0]
        assert curve["backend"] == "segment"
        assert tol == pytest.approx(dag.tolerance(g, p, 0.05), rel=1e-6)
    for name, obj in out["rank"]["ranking"]:
        g, p, rg, rp = coll_graphs[name]
        s, = same_dag(g, p, rg, rp, [50.0])
        assert obj == s.T
    assert out["rank"]["compiled_calls"] <= len(collective_study.ALGOS)


def test_collective_study_dense_ranks_as_reference_pallas(coll_graphs, ref):
    out = collective_study.flow(configs.get(collective_study.ARCH)[1],
                                mesh=MESH, deltas=COLL_DELTAS, device=CPU,
                                policy=ExecPolicy("dense"))
    rsvc = ref["analysis"].AnalysisService(backend="pallas")
    for algo, (_, _, rg, rp) in coll_graphs.items():
        rsvc.register_graph(algo, rg, rp)
    want = rsvc.handle(ref["analysis"].AnalysisRequest(
        kind="rank", deltas=COLL_DELTAS.tolist(), reduce="final"))
    assert want.ok, want.error
    got = out["rank"]["ranking"]
    assert [n for n, _ in got] == [n for n, _ in want.payload["ranking"]]
    np.testing.assert_allclose([o for _, o in got],
                               [o for _, o in want.payload["ranking"]],
                               rtol=1e-5, atol=0)


def test_collective_study_main():
    text = run_main("collective_study", "--mesh", *map(str, MESH), "--smoke")
    assert "recursive-doubling tolerates" in text


# -- topology study (Fig 11) --------------------------------------------------------

TOPO_DELTAS = np.linspace(0.0, 0.5, 3)


def topo_flow(**kw):
    topos = [(n, f(topology)) for n, f in SMALL_TOPOS]
    return topology_study.flow(topos, nranks=16, iters=1,
                               deltas=TOPO_DELTAS, device=CPU, **kw)


def test_topology_study_flow():
    out = topo_flow()
    svc = out["service"]
    for name, (curve, tol) in out["rows"].items():
        v = svc._variants[name]
        s = dag.LevelPlan(v.graph).forward(v.params)
        assert curve["T"][0] == s.T and curve["lam"][0] == s.lam[0]
        assert tol == pytest.approx(dag.tolerance(v.graph, v.params, 0.01),
                                    rel=1e-6)
    for name, obj in out["rank"]["ranking"]:
        v = svc._variants[name]
        assert obj == dag.LevelPlan(v.graph).forward(
            v.params.with_delta(0.5, 0)).T


def test_topology_study_dense_ranks_as_reference_pallas(ref):
    out = topo_flow(policy=ExecPolicy("dense"))
    rsvc = ref["analysis"].AnalysisService(backend="pallas")
    rt = ref["topology"]
    from repro.core.graph import GraphBuilder as RGB
    for name, f in SMALL_TOPOS:
        topo = f(rt)
        rp = rt.topology_params(topo, l_wire_us=0.274, d_switch_us=0.108)
        stamp = rt.TopologyStamper(topo, rp)
        b = RGB(16, topo.nclasses)
        for r in range(16):
            b.add_calc(r, 2_000.0)
        for k in range(8):
            for r in range(16):
                peer = r ^ (1 << k)
                if r < peer < 16:
                    stamp.message(b, r, peer, 4e5)
                    stamp.message(b, peer, r, 4e5)
        rg = b.finalize()
        # the port's workload is the reference's graph
        v = out["service"]._variants[name]
        np.testing.assert_array_equal(v.graph.econst, rg.econst)
        rsvc.register_graph(name, rg, rp)
    want = rsvc.handle(ref["analysis"].AnalysisRequest(
        kind="rank", deltas=TOPO_DELTAS.tolist(), reduce="final"))
    assert want.ok, want.error
    got = out["rank"]["ranking"]
    assert [n for n, _ in got] == [n for n, _ in want.payload["ranking"]]
    np.testing.assert_allclose([o for _, o in got],
                               [o for _, o in want.payload["ranking"]],
                               rtol=1e-5, atol=0)


def test_topology_study_main():
    text = run_main("topology_study", "--ranks", "16", "--iters", "1")
    assert "fastest fabric" in text and "torus(16x16) ICI" in text


# -- explore study ------------------------------------------------------------------

def test_explore_study_flow(ref):
    out = explore_study.flow(P=8, iters=2, generations=2, population=4,
                             budget=6, device=CPU)
    best = out["best"]
    assert out["solo"] == best.best_objective
    low = out["lower"](best.best)
    scen = out["scenarios"]
    Ts = np.array([dag.LevelPlan(low.graph).forward(
        low.params.replace(L=tuple(L)), extra_edge_cost=low.extra_edge_cost).T
        for L in scen.L])
    assert float(out["objective"](Ts[None])[0]) == best.best_objective
    # the stamper served the second searcher's revisits from its memos
    assert out["stamper"].stats["plan_hits"] > 0
    for res in out["results"].values():
        assert res.n_evaluated == 2 * 4


def test_explore_study_main():
    text = run_main("explore_study")
    assert "bit-identical: True" in text
