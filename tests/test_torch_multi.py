"""The PyTorch package's graph axis against the JAX package's: packed
multi-graph plans and the packed dense forward.

Each case is a set of graphs built by both packages' ``synth`` from the
same arguments: the four allreduce algorithms of the paper's study (Fig 10)
at 8 ranks × 2 steps, mixes of conformance graphs of 1, 2 and 3 latency
classes, and integer-cost DAGs whose λ is decided by the slope tie keys.  ``repad_plan`` / ``pack_plans`` / ``group_plans`` must
reproduce the reference's dense-view arrays and groups bit for bit, and
``multi_plan_from_arrays`` must carry a reference ``MultiPlan`` across.
The port's packed ``Engine(device="cpu")`` (the batched kernels' plain
versions) is held against the reference's packed ``Engine`` on its pallas
backend (kernels in interpret mode) within the reference pallas backend's
contract (``tests/test_conformance.py``): T and λ within 1e-5 relative,
ρ within 1e-4; and against the port's own solo engines bit for bit.

The JAX package is imported inside fixtures, as in the other port tests.
"""

import numpy as np
import pytest
import torch

from repro_torch.carry import multi_plan_from_arrays
from repro_torch.core import loggps, synth
from repro_torch.kernels.maxplus import (maxplus_matvec_argmax_batched,
                                         maxplus_matvec_batched)
from repro_torch.sweep import (Engine, ExecPolicy, MultiPlan,
                               collective_variants, compile_plan,
                               group_plans, latency_grid, pack_plans,
                               repad_plan)
from repro_torch.sweep import engine as eng_mod
from repro_torch.sweep.compile import MULTI_ARRAYS

RTOL_T = RTOL_LAM = 1e-5
RTOL_RHO = 1e-4
# the packed dense backend this file holds against the reference's "pallas"
# one (the default is segment, as the reference's is)
DENSE = ExecPolicy("dense")
ALGOS = ("ring", "bidir_ring", "recursive_doubling", "tree")
CASES = ("allreduce", "mixed1", "mixed2", "mixed3", "ties")
#: seeds of integer-cost DAGs whose λ depends on the slope tie keys (a
#: forward that ignores the keys gets a different λ on each of them)
TIE_SEEDS = (60, 62, 76, 113)
DELTAS = np.linspace(0.0, 60.0, 5)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules the tests compare against."""
    pytest.importorskip("jax")
    from repro import sweep as ref_sweep
    from repro.core import loggps as ref_loggps, synth as ref_synth
    from repro.sweep.api import ExecPolicy as RefPolicy
    return ref_sweep, ref_synth, ref_loggps, RefPolicy


def build(case, S, L):
    """[(name, graph, params)] of one case, built with a package's
    ``synth``/``loggps``."""
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    p2 = L.pod_model(pod_size=2).params()
    p3 = L.pod_model(pod_size=4, ranks_per_host=2).params()
    if case == "allreduce":
        return [(f"algo={a}", S.allreduce_chain(8, 2, params=p1, algo=a), p1)
                for a in ALGOS]
    if case == "ties":
        p0 = L.cluster_params(L_us=3.0, G_ns_per_byte=0.0, o_us=5.0)
        return [(f"ties{s}", int_dag(S, s, p0), p0) for s in TIE_SEEDS]
    return {
        "mixed1": lambda: [
            ("stencil", S.stencil2d(3, 3, 4, params=p1), p1),
            ("cg", S.cg_like(2, 2, 3, params=p1), p1),
            ("allreduce", S.allreduce_chain(8, 3, params=p1), p1)],
        "mixed2": lambda: [
            ("stencil2c", S.stencil2d(2, 2, 3, params=p2), p2),
            ("cg2c", S.cg_like(2, 2, 2, params=p2), p2)],
        "mixed3": lambda: [
            ("stencil3c", S.stencil2d(4, 2, 3, params=p3), p3),
            ("ring3c", S.allreduce_chain(8, 1, params=p3, algo="ring"), p3),
            ("cg3c", S.cg_like(2, 2, 2, params=p3), p3)],
    }[case]()


def int_dag(S, seed, p, P=4, nops=40):
    """A random DAG of integer compute costs and 1-byte messages at zero
    gap: values are small integers, so paths tie exactly in float32."""
    rng = np.random.default_rng(seed)
    b = S.GraphBuilder(P, p.nclass)
    for _ in range(nops):
        if rng.random() < 0.5:
            src, dst = rng.choice(P, size=2, replace=False)
            b.add_message(int(src), int(dst), 1.0, p)
        else:
            b.add_calc(int(rng.integers(P)), float(rng.integers(1, 6)))
    return b.finalize()


def batches(items, S_mod, per_graph: bool):
    """One latency grid for every graph, or per-graph batches at different
    base points: graph g's class-0 latency starts 1.5·g µs higher and its
    class-0 bandwidth is scaled by 1 + 0.25·g."""
    if not per_graph:
        return S_mod.latency_grid(items[0][2], DELTAS)
    out = []
    for g, (_, _, p) in enumerate(items):
        L = np.tile(np.asarray(p.L, dtype=np.float64), (len(DELTAS), 1))
        L[:, 0] += 1.5 * g + DELTAS
        gs = np.ones_like(L)
        gs[:, 0] = 1.0 + 0.25 * g
        out.append(S_mod.ScenarioBatch(L=L, gscale=gs))
    return out


@pytest.fixture(scope="module")
def packed(ref):
    """Per case: the reference's packed plan, the port's own and the
    carried one, and both engines' results (λ and values-only, broadcast
    and per-graph batches)."""
    ref_sweep, ref_synth, ref_loggps, RefPolicy = ref
    import repro.sweep.scenarios as ref_scen
    from repro_torch.sweep import scenarios as scen
    out = {}
    for case in CASES:
        items_ref = build(case, ref_synth, ref_loggps)
        items = build(case, synth, loggps)
        names = [n for n, _, _ in items]
        ref_plans = [ref_sweep.compile_plan(g, p) for _, g, p in items_ref]
        plans = [compile_plan(g, p) for _, g, p in items]
        ref_mp = ref_sweep.pack_plans(ref_plans)
        own = pack_plans(plans)
        carried = multi_plan_from_arrays(
            {f: getattr(ref_mp, f) for f in MULTI_ARRAYS}, ref_mp.nv,
            ref_mp.nlevels, ref_mp.nclass, ref_mp.vsrc.shape[3])
        ref_eng = ref_sweep.Engine(
            ref_plans, names=names,
            policy=RefPolicy(backend="pallas", cache=None))
        port = Engine([(g, p) for _, g, p in items], names=names,
                      policy=DENSE, device="cpu")
        port_carried = Engine(carried, names=names, policy=DENSE,
                              device="cpu")
        res = {}
        for per_graph in (False, True):
            rb = batches(items_ref, ref_scen, per_graph)
            pb = batches(items, scen, per_graph)
            for lam in (True, False):
                key = (per_graph, lam)
                r = ref_eng.run(rb, compute_lam=lam)
                res[key] = {"ref": r, "port": port.run(pb, compute_lam=lam),
                            "carried": port_carried.run(pb, compute_lam=lam),
                            "batches": pb}
        out[case] = {"items": items, "plans": plans, "ref_plans": ref_plans,
                     "ref_mp": ref_mp, "own": own, "carried": carried,
                     "port": port, "res": res, "names": names}
    return out


# -- plans -------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_pack_plans_equals_reference(packed, case):
    c = packed[case]
    ref_mp, own = c["ref_mp"], c["own"]
    for f in MULTI_ARRAYS:
        a, b = getattr(own, f), getattr(ref_mp, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(own.nv, ref_mp.nv)
    np.testing.assert_array_equal(own.nlevels, ref_mp.nlevels)
    assert own.nclass == ref_mp.nclass and own.G == ref_mp.G
    assert own.shape_key == ref_mp.shape_key
    assert own.Dmax == ref_mp.vsrc.shape[3]
    assert own.dense_bytes() == ref_mp.dense_bytes()
    np.testing.assert_array_equal(own.dense_indicator(),
                                  ref_mp.dense_indicator(-1e30))


@pytest.mark.parametrize("case", CASES)
def test_repad_plan_equals_reference(packed, case):
    """Each member onto a larger envelope than the packed one: every dense
    field equals the reference's repad of the same plan."""
    from repro.sweep.compile import repad_plan as ref_repad_plan
    c = packed[case]
    env = tuple(2 * x for x in c["own"].shape_key[1:5])
    for plan, rplan in zip(c["plans"], c["ref_plans"]):
        mine = repad_plan(plan, *env)
        theirs = ref_repad_plan(rplan, *env)
        for f in MULTI_ARRAYS:
            np.testing.assert_array_equal(getattr(mine, f),
                                          getattr(theirs, f), err_msg=f)
        assert mine.envelope == env and mine.Dmax == theirs.vsrc.shape[2]
        assert repad_plan(plan, *plan.envelope) is plan
        with pytest.raises(ValueError, match="smaller"):
            repad_plan(plan, plan.nlv_p // 2, plan.Vmax, plan.Dmax,
                       plan.Emax)


@pytest.mark.parametrize("max_inflation", [64.0, 8.0, 2.0, 1.0])
def test_group_plans_equals_reference(packed, max_inflation):
    """Plans of every case, mixed classes and sizes, grouped as the
    reference groups them."""
    from repro.sweep.compile import group_plans as ref_group_plans
    plans, ref_plans = [], []
    for case in CASES:
        plans += packed[case]["plans"]
        ref_plans += packed[case]["ref_plans"]
    order = np.random.default_rng(7).permutation(len(plans))
    plans = [plans[i] for i in order]
    ref_plans = [ref_plans[i] for i in order]
    got = group_plans(plans, max_inflation=max_inflation)
    assert got == ref_group_plans(ref_plans, max_inflation=max_inflation)
    assert sorted(i for g in got for i in g) == list(range(len(plans)))


@pytest.mark.parametrize("case", CASES)
def test_multi_plan_from_arrays_reproduces_reference(packed, case):
    c = packed[case]
    carried, own = c["carried"], c["own"]
    for f in MULTI_ARRAYS:
        np.testing.assert_array_equal(getattr(carried, f), getattr(own, f))
    assert carried.shape_key == own.shape_key
    assert carried.dense_bytes() == c["ref_mp"].dense_bytes()
    np.testing.assert_array_equal(carried.nlevels, own.nlevels)


def test_multi_plan_from_arrays_refuses_bad_shapes(packed):
    ref_mp = packed["allreduce"]["ref_mp"]
    fields = {f: getattr(ref_mp, f) for f in MULTI_ARRAYS}
    args = (ref_mp.nv, ref_mp.nlevels, ref_mp.nclass, ref_mp.vsrc.shape[3])
    with pytest.raises(ValueError, match="missing"):
        multi_plan_from_arrays({k: v for k, v in fields.items()
                                if k != "egap"}, *args)
    with pytest.raises(ValueError, match="elat"):
        multi_plan_from_arrays(fields, args[0], args[1], 2, args[3])
    with pytest.raises(ValueError, match="per graph"):
        multi_plan_from_arrays(fields, args[0][:2], *args[1:])
    bad = dict(fields, vcost_lv=fields["vcost_lv"][:, :-1])
    with pytest.raises(ValueError, match="vcost_lv"):
        multi_plan_from_arrays(bad, *args)


def test_collective_variants_equal_reference(ref):
    ref_sweep, ref_synth, ref_loggps, _ = ref
    p = loggps.cluster_params(L_us=3.0, o_us=5.0)
    rp = ref_loggps.cluster_params(L_us=3.0, o_us=5.0)
    mine = collective_variants(
        lambda a: synth.allreduce_chain(8, 2, params=p, algo=a), ALGOS, p)
    theirs = ref_sweep.collective_variants(
        lambda a: ref_synth.allreduce_chain(8, 2, params=rp, algo=a),
        ALGOS, rp)
    for m, t in zip(mine, theirs):
        assert (m.name, m.meta) == (t.name, t.meta) and m.params is p
        for f in ("esrc", "edst", "econst", "elat", "vcost", "level"):
            np.testing.assert_array_equal(getattr(m.graph, f),
                                          getattr(t.graph, f))


# -- the packed forward --------------------------------------------------------

@pytest.mark.parametrize("lam", [True, False], ids=["lam", "values"])
@pytest.mark.parametrize("per_graph", [False, True],
                         ids=["broadcast", "per-graph"])
@pytest.mark.parametrize("case", CASES)
def test_packed_engine_matches_reference(packed, case, per_graph, lam):
    c = packed[case]
    runs = c["res"][(per_graph, lam)]
    r = runs["ref"]
    for key in ("port", "carried"):
        res = runs[key]
        assert res.axes == r.axes == ("G", "S")
        assert res.names == r.names == tuple(c["names"])
        assert res.T.shape == r.T.shape and res.device == "cpu"
        np.testing.assert_allclose(res.T, r.T, rtol=RTOL_T, atol=0)
        if lam:
            np.testing.assert_allclose(res.lam, r.lam, rtol=RTOL_LAM, atol=0)
            np.testing.assert_allclose(res.rho, r.rho, rtol=RTOL_RHO, atol=0)
        else:
            assert res.lam is None and res.rho is None
        for reduce in ("mean", "max", "final"):
            assert [n for n, _ in res.rank(reduce)] \
                == [n for n, _ in r.rank(reduce)]


@pytest.mark.parametrize("per_graph", [False, True],
                         ids=["broadcast", "per-graph"])
@pytest.mark.parametrize("case", CASES)
def test_packed_equals_solo(packed, case, per_graph):
    """Each graph of a packed run equals its own solo engine, bit for bit:
    T, λ and ρ of the λ run, and T of the values-only run."""
    c = packed[case]
    res = c["res"][(per_graph, True)]["port"]
    vals = c["res"][(per_graph, False)]["port"]
    pb = c["res"][(per_graph, True)]["batches"]
    for g, (name, graph, p) in enumerate(c["items"]):
        b = pb[g] if per_graph else pb
        solo = Engine(graph, params=p, policy=DENSE, device="cpu").run(b)
        one = res[name]
        np.testing.assert_array_equal(one.T, solo.T)
        np.testing.assert_array_equal(one.lam, solo.lam)
        np.testing.assert_array_equal(one.rho, solo.rho)
        np.testing.assert_array_equal(vals.T[g], solo.T)
        assert one.scenarios is b


@pytest.mark.parametrize("case", ["allreduce", "mixed3"])
def test_padded_levels_change_nothing(packed, case):
    """The forward stops at the largest nlevels of the G graphs; walking
    all nlv_p padded levels, as the reference does, gives identical T and
    λ."""
    c = packed[case]
    d = c["port"].arrays
    assert int(d.nlevels.max()) < c["own"].nlv_p
    pb = c["res"][(True, True)]["batches"]
    Lmat = torch.from_numpy(np.stack([b.L for b in pb]).astype(np.float32))
    GSmat = torch.from_numpy(
        np.stack([b.gscale for b in pb]).astype(np.float32))
    for lam in (True, False):
        short = eng_mod.dense_forward_multi(d, Lmat, GSmat, lam)
        full = eng_mod.dense_forward_multi(d, Lmat, GSmat, lam,
                                           nlv=c["own"].nlv_p)
        assert torch.equal(short[0], full[0])
        if lam:
            assert torch.equal(short[1], full[1])


def test_staged_indicator_is_the_plans_level_major(packed):
    c = packed["mixed1"]
    A = c["port"].arrays.A.numpy()
    np.testing.assert_array_equal(
        A, c["own"].dense_indicator().transpose(1, 0, 2, 3))


def test_cpu_run_counts_forwards_and_no_launch(packed):
    c = packed["allreduce"]
    b = latency_grid(c["items"][0][2], DELTAS)
    n = (maxplus_matvec_batched.launches,
         maxplus_matvec_argmax_batched.launches)
    runs = dict(eng_mod.dense_forward_multi.runs)
    c["port"].run(b)
    c["port"].run(b, compute_lam=False)
    assert (maxplus_matvec_batched.launches,
            maxplus_matvec_argmax_batched.launches) == n
    for kind in ("lam", "values"):
        assert eng_mod.dense_forward_multi.runs[kind] == runs.get(kind, 0) + 1


# -- the Result's graph axis ---------------------------------------------------

def test_result_graph_axis_helpers(packed):
    c = packed["allreduce"]
    res = c["res"][(True, True)]["port"]
    assert res.G == 4 and res.S == len(DELTAS)
    by_name, by_idx = res["algo=tree"], res[3]
    np.testing.assert_array_equal(by_name.T, by_idx.T)
    np.testing.assert_array_equal(by_name.lam, res.lam[3])
    assert by_name.axes == ("S",) and by_name.G is None
    assert by_name.argbest() == int(np.argmin(res.T[3]))
    split = res.split()
    assert list(split) == list(res.names)
    np.testing.assert_array_equal(split["algo=ring"].rho, res.rho[0])
    order = res.rank("final")
    assert [v for _, v in order] == sorted(res.T[:, -1].tolist())
    with pytest.raises(TypeError, match="ambiguous"):
        res.argbest()
    with pytest.raises(ValueError, match="reduce"):
        res.rank("median")
    for call in (lambda: by_name[0], by_name.split, by_name.rank):
        with pytest.raises(TypeError, match="graph axis"):
            call()


def test_default_names_and_plan_inputs(packed):
    c = packed["mixed2"]
    eng = Engine(c["plans"], device="cpu")
    assert eng.names == ("g0", "g1") and eng.G == 2
    eng2 = Engine(tuple(g for _, g, _ in c["items"]),
                  params=c["items"][0][2], device="cpu")
    b = latency_grid(c["items"][0][2], DELTAS)
    np.testing.assert_array_equal(eng.run(b).T, eng2.run(b).T)
    assert Engine(c["own"], device="cpu").multi is c["own"]


# -- errors ---------------------------------------------------------------------

def test_mixed_class_counts_refused(packed):
    plans = packed["mixed1"]["plans"][:1] + packed["mixed2"]["plans"][:1]
    with pytest.raises(ValueError, match="latency-class"):
        pack_plans(plans)
    with pytest.raises(ValueError, match="latency-class"):
        Engine(plans, device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        pack_plans([])
    with pytest.raises(ValueError, match="at least one"):
        Engine([], device="cpu")


def test_run_refuses_bad_batches(packed):
    c = packed["mixed3"]
    eng = c["port"]
    p = c["items"][0][2]
    b = latency_grid(p, DELTAS)
    with pytest.raises(ValueError, match="2 scenario batches for 3"):
        eng.run([b, b])
    with pytest.raises(ValueError, match="share S"):
        eng.run([b, b, latency_grid(p, DELTAS[:3])])
    p1 = loggps.cluster_params(L_us=3.0, o_us=5.0)
    with pytest.raises(ValueError, match="classes"):
        eng.run(latency_grid(p1, DELTAS))
    with pytest.raises(ValueError, match="ScenarioBatch"):
        eng.run([b, b, "b"])


def test_sparse_backend_refuses_a_graph_axis(packed):
    c = packed["allreduce"]
    sparse = ExecPolicy(backend="sparse")
    with pytest.raises(ValueError, match="one graph at a time"):
        Engine([(g, p) for _, g, p in c["items"]], policy=sparse,
               device="cpu")
    with pytest.raises(ValueError, match="one graph at a time"):
        Engine(c["own"], policy=sparse, device="cpu")


def test_names_checked(packed):
    c = packed["allreduce"]
    with pytest.raises(ValueError, match="3 names for 4 graphs"):
        Engine(c["own"], names=["a", "b", "c"], device="cpu")
    with pytest.raises(ValueError, match="names"):
        Engine(c["plans"][0], names=["a"], device="cpu")
    with pytest.raises(ValueError, match="CompiledPlans"):
        Engine([c["plans"][0], "graph"], device="cpu")


def test_dense_guard_counts_all_graphs(packed, monkeypatch):
    """The guard compares the packed plan of all G graphs, which is G times
    one member's envelope, and ``max_dense_bytes`` lifts it."""
    c = packed["allreduce"]
    mp = c["own"]
    one = mp.dense_bytes() // mp.G
    assert isinstance(mp, MultiPlan) and mp.dense_bytes() == 4 * one
    monkeypatch.delenv("REPRO_MAX_DENSE_BYTES", raising=False)
    tight = ExecPolicy(max_dense_bytes=2 * one)
    with pytest.raises(ValueError, match="all G graphs"):
        Engine(c["plans"], policy=tight, device="cpu")
    with pytest.raises(ValueError, match="max_dense_bytes"):
        Engine(mp, policy=tight, device="cpu")
    eng = Engine(c["plans"], policy=ExecPolicy(max_dense_bytes=4 * one),
                 device="cpu")
    assert eng.G == 4
    monkeypatch.setenv("REPRO_MAX_DENSE_BYTES", str(2 * one))
    with pytest.raises(ValueError, match="all G graphs"):
        Engine(mp, device="cpu")
    assert Engine(mp, policy=ExecPolicy(max_dense_bytes=4 * one),
                  device="cpu").G == 4


def test_no_device_means_the_card(packed, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(packed["allreduce"]["own"])
