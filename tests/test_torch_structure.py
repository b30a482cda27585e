"""The structure-variant axis B: ``CompiledPlan.patch_structure``,
``StructureBatch.from_plans``, and B lanes of
``Engine.run(Query(structure=...))`` on the segment and dense backends,
alone and with the candidate-cost axis (B×K).

On the CPU (the kernels' plain versions, ``device="cpu"``):

* ``patch_structure`` (edge removals, source rewirings, both) and
  ``from_plans`` equal the reference's edge-view fields bit for bit;
* segment B and B×K lanes are bit-equal (T, λ, ρ) to ``repro.core.dag`` on
  the rebuilt graph (the edges filtered and rewired, the levels
  recomputed: a tighter schedule than the envelope's), to a solo forward
  of the rebuilt plan, and to the reference's ``_segment_core_axes`` with
  the structure axis (and the cost axis) under ``jax.enable_x64(True)``;
* dense B and B×K lanes are within T 1e-5, λ 1e-5 and ρ 1e-4 relative of
  the reference's pallas ``Engine.run(Query(...))``;
* a ``from_plans`` batch equals the same plans packed on the graph axis,
  bit for bit; an Engine built from a StructureBatch uses it as its
  default B axis;
* the refusals of the reference's ``_structure`` and ``run`` raise
  ``ValueError``; one level-loop run and one walk a forward whatever B.

On the card (``-m gpu``): the lane kernels over B variants (and B×K) of a
patched plan and of a ``from_plans`` batch against their plain versions at
S 1056, 37 and 1, bit for bit.  JAX is imported inside fixtures only.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import dag as ref_dag, graph as ref_graph
from repro.core import loggps as ref_loggps, synth as ref_synth
from repro.sweep import compile as ref_compile, engine as ref_engine

from repro_torch.core import graph, loggps, synth
from repro_torch.kernels.maxplus import (dense_levels_f32, segment_levels_f64,
                                         sparse_backtrace)
from repro_torch.sweep import (Engine, ExecPolicy, Query, StructureBatch,
                               compile_plan, latency_grid)
from repro_torch.sweep import engine as eng
from repro_torch.sweep.compile import STRUCT_FIELDS

SEG = ExecPolicy("segment")
DENSE = ExecPolicy("dense")
CASES = ("random", "stencil", "stencil2c")
MODES = ("keep", "src", "both")
B = 3
K = 2


def build(name, S, L):
    """(graph, params) of one case with a package's ``synth``/``loggps``."""
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    if name.startswith("random"):
        seed = int(name.removeprefix("random") or 3)
        return S.random_dag(np.random.default_rng(seed), nranks=4, nops=40,
                            p_msg=0.5, params=p1), p1
    if name == "stencil2c":
        p2 = L.pod_model(pod_size=4).params()
        return S.stencil2d(4, 4, 3, params=p2), p2
    return S.stencil2d(4, 4, 3, params=p1), p1


def port_case(name):
    return build(name, synth, loggps)


def ref_case(name):
    return build(name, ref_synth, ref_loggps)


def variants(g, mode, seed, n=B):
    """(src, keep) of n variants from a numpy seed: ``keep`` drops ~10 %
    of the edges; ``src`` rewires ~20 % of them to a random vertex on a
    lower level than the destination (None: that part unpatched)."""
    rng = np.random.default_rng(seed)
    ne = g.num_edges
    keep = rng.random((n, ne)) > 0.1 if mode != "src" else None
    if mode == "keep":
        return None, keep
    order = np.argsort(g.level, kind="stable")
    below = np.searchsorted(g.level[order], g.level[g.edst])   # [ne]
    src = np.broadcast_to(g.esrc.astype(np.int64), (n, ne)).copy()
    pick = rng.random((n, ne)) < 0.2
    r = (rng.random((n, ne)) * below).astype(np.int64)
    src[pick] = order[r[pick]]
    return src, keep


def rebuilt(g, src, keep, G):
    """A ground-up rebuild of one variant with a package's ``graph``
    module: the kept edges with their new sources, levels recomputed."""
    keep = np.ones(g.num_edges, bool) if keep is None else keep
    esrc = (g.esrc if src is None else src.astype(g.esrc.dtype))[keep]
    edst = g.edst[keep]
    nv = g.num_vertices
    level = G._topo_levels(nv, esrc, edst)
    in_ptr = np.zeros(nv + 1, np.int64)
    np.cumsum(np.bincount(edst, minlength=nv), out=in_ptr[1:])
    return dataclasses.replace(
        g, esrc=esrc, edst=edst, econst=g.econst[keep],
        ebytes=g.ebytes[keep], elat=g.elat[keep],
        egap=None if g.egap is None else g.egap[keep],
        egclass=None if g.egclass is None else g.egclass[keep],
        elink=None if g.elink is None else g.elink[keep],
        in_ptr=in_ptr,
        in_edge=np.argsort(edst, kind="stable").astype(np.int32),
        level=level, nlevels=int(level.max(initial=0)) + 1)


def grid(p, S=6, top=40.0):
    return latency_grid(p, np.linspace(0.0, top, S))


def _rho(T, lam, L):
    return np.where(T[..., None] > 0,
                    L * lam / np.maximum(T[..., None], 1e-300), 0.0)


def _same(got, want, msg=""):
    for a, b in zip(got, want):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b, err_msg=msg)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.T, want.T, rtol=1e-5, atol=1e-7,
                               err_msg=msg)
    np.testing.assert_allclose(got.lam, want.lam, rtol=1e-5, atol=1e-5,
                               err_msg=msg)
    np.testing.assert_allclose(got.rho, want.rho, rtol=1e-4, atol=1e-5,
                               err_msg=msg)


def _at(res, *idx):
    return res.T[idx], res.lam[idx], res.rho[idx]


def _ref_grid(ref_sweep, p_ref, batch):
    """The reference's ScenarioBatch of the same latencies as ``batch``."""
    b = ref_sweep.latency_grid(p_ref, batch.L[:, 0] - p_ref.L[0])
    np.testing.assert_array_equal(b.L, batch.L)
    return b


@pytest.fixture(scope="module")
def ref_sweep():
    pytest.importorskip("jax")
    from repro import sweep
    return sweep


@pytest.fixture(scope="module")
def ref_axes():
    """``run(plan, sb, L, GS, vconst)`` → (T, λ, ρ) of the reference's
    ``_segment_core_axes`` with the structure axis over the variants'
    sources and masks (and, with ``vconst``, the candidate axis over the
    patched constants), under 64-bit JAX."""
    jax = pytest.importorskip("jax")
    fwds = {}
    structure = (0, 0) + (None,) * 10

    def run(plan, sb, L, GS, vconst=None):
        costs = None if vconst is None else (0, None, None, None, None)
        key = costs is not None
        if key not in fwds:
            fwds[key] = jax.jit(ref_engine._segment_core_axes(
                True, False, costs, structure=structure))
        with jax.enable_x64(True):
            arrs = list(ref_engine._stage_arrays(plan, "segment", 1 << 40))
            arrs[0] = jax.numpy.asarray(sb.vsrc)
            arrs[1] = jax.numpy.asarray(sb.vmaskd)
            if vconst is not None:
                arrs[2] = jax.numpy.asarray(vconst)
            T, lam = fwds[key](*arrs, L, GS)
            T, lam = np.asarray(T), np.asarray(lam)
        assert T.dtype == lam.dtype == np.float64
        return T, lam, _rho(T, lam, L)

    return run


# -- fields -------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_patch_structure_equals_reference(name, mode):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    src, keep = variants(g, mode, 1)
    plan, ref = compile_plan(g, p), ref_compile.compile_plan(g_ref, p_ref)
    sb = plan.patch_structure(src=src, keep=keep, names=["a", "b", "c"])
    sb_ref = ref.patch_structure(src=src, keep=keep)
    assert sb.B == sb_ref.B == B and sb.names == ("a", "b", "c")
    assert sb.base is plan and sb.plan_hash == plan.content_hash()
    for f in STRUCT_FIELDS:
        a, b = getattr(sb, f), getattr(sb_ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # only the sources and masks are per variant
    assert {f for f in STRUCT_FIELDS if getattr(sb, f).strides[0]} == \
        {"esrc", "emask"}
    pd, pd_ref = sb.padded(5), sb_ref.padded(5)
    for f in STRUCT_FIELDS:
        np.testing.assert_array_equal(getattr(pd, f), getattr(pd_ref, f))
    assert pd.B == 5 and pd.names == sb.names
    with pytest.raises(ValueError, match="pad"):
        sb.padded(1)
    mp = sb.as_multi()
    np.testing.assert_array_equal(mp.nv, [plan.nv] * B)
    np.testing.assert_array_equal(mp.nlevels, [plan.nlevels] * B)


def test_from_plans_equals_reference():
    names = ("random", "stencil", "random4")
    plans = [compile_plan(*port_case(n)) for n in names]
    refs = [ref_compile.compile_plan(*ref_case(n)) for n in names]
    sb = StructureBatch.from_plans(plans, names=names)
    sb_ref = ref_compile.StructureBatch.from_plans(refs)
    assert sb.plan_hash is None and sb.names == names
    for f in STRUCT_FIELDS:
        a, b = getattr(sb, f), getattr(sb_ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    mp = sb.as_multi()
    np.testing.assert_array_equal(mp.nv, [pl.nv for pl in plans])
    np.testing.assert_array_equal(mp.nlevels, [pl.nlevels for pl in plans])
    with pytest.raises(ValueError, match="at least one"):
        StructureBatch.from_plans([])
    with pytest.raises(ValueError, match="names"):
        StructureBatch.from_plans(plans, names=["x"])
    p2 = compile_plan(*port_case("stencil2c"))
    with pytest.raises(ValueError, match="latency-class"):
        StructureBatch.from_plans([plans[0], p2])


# -- segment B and B×K lanes ---------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_segment_b_lanes_equal_core_dag_rebuild_and_reference(name, mode,
                                                              ref_axes):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    src, keep = variants(g, mode, 2)
    plan = compile_plan(g, p)
    batch = grid(p)
    res = Engine(plan, policy=SEG, device="cpu").run(
        Query(batch, structure=plan.patch_structure(src=src, keep=keep)))
    assert res.axes == ("B", "S") and res.B == B
    assert res.names == ("v0", "v1", "v2")
    for b in range(B):
        s_b = None if src is None else src[b]
        k_b = None if keep is None else keep[b]
        gb = rebuilt(g, s_b, k_b, graph)
        solo = Engine(gb, params=p, policy=SEG, device="cpu").run(batch)
        _same(_at(res, b), (solo.T, solo.lam, solo.rho), f"rebuild b={b}")
        lp = ref_dag.LevelPlan(rebuilt(g_ref, s_b, k_b, ref_graph))
        out = [lp.forward(p_ref.replace(L=tuple(batch.L[i])))
               for i in range(batch.S)]
        _same(_at(res, b), (np.array([s.T for s in out]),
                            np.stack([s.lam for s in out]),
                            np.stack([s.rho() for s in out])),
              f"core.dag b={b}")
    ref = ref_compile.compile_plan(g_ref, p_ref)
    _same((res.T, res.lam, res.rho),
          ref_axes(ref, ref.patch_structure(src=src, keep=keep), batch.L,
                   batch.gscale), "reference _segment_core_axes")


@pytest.mark.parametrize("name", ("random", "stencil2c"))
def test_segment_bk_lanes_equal_rebuild_and_reference(name, ref_axes):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    src, keep = variants(g, "both", 3)
    ex = np.random.default_rng(4).uniform(0.0, 5.0, (K, g.num_edges))
    plan = compile_plan(g, p)
    batch = grid(p)
    res = Engine(plan, policy=SEG, device="cpu").run(
        Query(batch, structure=plan.patch_structure(src=src, keep=keep),
              costs=ex))
    assert res.axes == ("B", "K", "S") and (res.B, res.K) == (B, K)
    for b in range(B):
        for k in range(K):
            gb = rebuilt(dataclasses.replace(g, econst=g.econst + ex[k]),
                         src[b], keep[b], graph)
            solo = Engine(gb, params=p, policy=SEG, device="cpu").run(batch)
            _same(_at(res, b, k), (solo.T, solo.lam, solo.rho),
                  f"b={b} k={k}")
    ref = ref_compile.compile_plan(g_ref, p_ref)
    _same((res.T, res.lam, res.rho), ref_axes(
        ref, ref.patch_structure(src=src, keep=keep), batch.L, batch.gscale,
        ref.patch_costs(ex).vconst), "reference B x K")


def test_from_plans_equals_the_packed_graph_axis():
    """A from_plans batch runs as the same plans packed on G, bit for bit,
    values and λ; an Engine built from the batch uses it by default."""
    names = ("random", "stencil", "random4")
    plans = [compile_plan(*port_case(n)) for n in names]
    batch = grid(port_case("random")[1])
    for pol in (SEG, DENSE):
        packed = Engine(plans, names=list(names), policy=pol,
                        device="cpu").run(batch)
        sb = StructureBatch.from_plans(plans, names=names)
        e = Engine(sb, policy=pol, device="cpu")
        res = e.run(batch)
        assert res.axes == ("B", "S") and res.names == names
        _same((res.T, res.lam, res.rho), (packed.T, packed.lam, packed.rho))
        assert list(res.split()) == list(names)
        np.testing.assert_array_equal(res["stencil"].T, packed.T[1])
        assert res["stencil"].scenarios is batch
        assert [n for n, _ in res.rank()] == [n for n, _ in packed.rank()]
        vals = e.run(batch, compute_lam=False)
        assert vals.lam is None
        np.testing.assert_array_equal(vals.T, res.T)
        # the variants' staging is kept for the next run with the batch
        staged = e._staged_structure[1]
        e.run(batch)
        assert e._staged_structure[1] is staged
        renamed = Engine(sb, names=["x", "y", "z"], policy=pol,
                         device="cpu").run(batch)
        assert renamed.names == ("x", "y", "z")


# -- dense B and B×K lanes against the reference pallas backend ------------------

@pytest.mark.parametrize("name", CASES)
def test_dense_lanes_match_reference_pallas(name, ref_sweep):
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    src, keep = variants(g, "both", 5)
    ex = np.random.default_rng(6).uniform(0.0, 5.0, (K, g.num_edges))
    batch = grid(p)
    plan = compile_plan(g, p)
    e = Engine(plan, policy=DENSE, device="cpu")
    ref = ref_sweep.compile_plan(g_ref, p_ref)
    ref_eng = ref_sweep.Engine(ref, params=p_ref, policy=ref_sweep.ExecPolicy(
        backend="pallas", cache=None))
    rb = _ref_grid(ref_sweep, p_ref, batch)
    for costs in (None, ex):
        res = e.run(Query(batch, costs=costs,
                          structure=plan.patch_structure(src=src, keep=keep)))
        want = ref_eng.run(ref_sweep.Query(
            rb, costs=costs, structure=ref.patch_structure(src=src,
                                                           keep=keep)))
        assert res.axes == want.axes
        _close(res, want, name)
        for b in range(B):
            ecost = g.econst + (0.0 if costs is None else ex[0])
            gb = rebuilt(dataclasses.replace(g, econst=ecost), src[b],
                         keep[b], graph)
            solo = Engine(gb, params=p, policy=DENSE, device="cpu").run(batch)
            got = _at(res, b) if costs is None else _at(res, b, 0)
            _same(got, (solo.T, solo.lam, solo.rho), f"b={b}")


# -- refusals -----------------------------------------------------------------

def test_structure_refusals():
    """The reference's ``_structure`` and ``run`` refusals, each a
    ValueError: not a StructureBatch, B with a packed G, a foreign
    envelope, a batch patched from another plan of the same envelope, a
    from_plans batch with cost blocks, the sparse backend, a batch without
    a base plan; and patch_structure's own: the level schedule, vertex ids,
    shapes, nothing to patch."""
    g, p = port_case("random")
    g4, _ = port_case("random4")
    gs, ps = port_case("stencil")
    plan, plan4 = compile_plan(g, p), compile_plan(g4, p)
    assert plan.envelope == plan4.envelope
    batch = grid(p)
    src, keep = variants(g, "keep", 7)
    sb = plan.patch_structure(keep=keep)
    e = Engine(plan, policy=SEG, device="cpu")
    with pytest.raises(ValueError, match="StructureBatch"):
        e.run(Query(batch, structure=keep))
    packed = Engine([plan, plan4], policy=SEG, device="cpu")
    with pytest.raises(ValueError, match="multi-graph"):
        packed.run(Query(batch, structure=sb))
    with pytest.raises(ValueError, match="envelope"):
        e.run(Query(batch, structure=compile_plan(gs, ps).patch_structure(
            keep=np.ones(gs.num_edges, bool))))
    with pytest.raises(ValueError, match="different plan"):
        e.run(Query(batch, structure=plan4.patch_structure(
            keep=np.ones(g4.num_edges, bool))))
    fp = StructureBatch.from_plans([plan, plan4])
    e.run(Query(batch, structure=fp))               # no hash: shape only
    with pytest.raises(ValueError, match="from_plans"):
        e.run(Query(batch, structure=fp, costs=np.zeros((2, g.num_edges))))
    with pytest.raises(ValueError, match="from_plans"):
        Engine(fp, policy=SEG, device="cpu").run(
            Query(batch, costs=np.zeros((2, g.num_edges))))
    sparse = Engine(g, params=p, policy=ExecPolicy("sparse"), device="cpu")
    with pytest.raises(ValueError):
        sparse.run(Query(batch, structure=sb))
    with pytest.raises(ValueError, match="base plan"):
        Engine(dataclasses.replace(sb, base=None), device="cpu")
    with pytest.raises(ValueError, match="scenario"):
        e.run(Query([batch, batch], structure=sb))
    # patch_structure's own checks
    below = g.level[g.edst] - 1
    back = np.array([np.flatnonzero(g.level >= lv + 1)[0] for lv in below])
    with pytest.raises(ValueError, match="level schedule"):
        plan.patch_structure(src=back)
    with pytest.raises(ValueError, match="outside"):
        plan.patch_structure(src=np.full(g.num_edges, g.num_vertices))
    with pytest.raises(ValueError, match="original edge order"):
        plan.patch_structure(keep=keep[:, :-1])
    with pytest.raises(ValueError, match="src and/or keep"):
        plan.patch_structure()
    stripped = dataclasses.replace(plan, epos_lvl=None, epos_dst=None,
                                   epos_e=None)
    with pytest.raises(ValueError, match="edge-position"):
        stripped.patch_structure(keep=keep)


# -- counters -----------------------------------------------------------------

@pytest.mark.parametrize("backend", ("segment", "dense"))
def test_one_level_loop_and_one_walk_whatever_b(backend, monkeypatch):
    """A B (or B×K) forward makes one level-loop call and one walk, and
    one forward run, at B = 1, 3 and 6."""
    loop = ("segment_levels_f64" if backend == "segment"
            else "dense_levels_f32")
    fwd = (eng.segment_forward_multi if backend == "segment"
           else eng.dense_forward_multi)
    g, p = port_case("stencil")
    plan = compile_plan(g, p)
    e = Engine(plan, policy=SEG if backend == "segment" else DENSE,
               device="cpu")
    batch = grid(p)
    for nb in (1, 3, 6):
        sb = plan.patch_structure(keep=variants(g, "keep", nb, n=nb)[1])
        for costs in (None, np.zeros((2, g.num_edges))):
            for lam in (True, False):
                calls = {loop: 0, "sparse_backtrace": 0}
                for name in calls:
                    fn = getattr(eng, name)

                    def counted(*a, _fn=fn, _name=name, **kw):
                        calls[_name] += 1
                        return _fn(*a, **kw)
                    monkeypatch.setattr(eng, name, counted)
                runs = dict(fwd.runs)
                r = e.run(Query(batch, structure=sb, costs=costs),
                          compute_lam=lam)
                assert r.B == nb
                assert calls == {loop: 1, "sparse_backtrace": int(lam)}
                kind = "lam" if lam else "values"
                assert fwd.runs[kind] == runs.get(kind, 0) + 1
                monkeypatch.undo()


# -- on the card ------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("Kl", [None, 3])
def test_structure_lanes_match_plain_versions_on_card(Kl, monkeypatch):
    """The level loops and the walk over B variants (B×K with Kl cost
    lanes) of a patched stencil and of a from_plans batch, against their
    plain versions on the same card tensors, bit for bit, values and λ,
    at S 1056, 37 and 1; one launch each a forward; and the card's engine
    equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.maxplus import (dense_levels_f32_ref,
                                             segment_levels_f64_ref,
                                             sparse_walk_ref)

    def plain_segment(t, ssum, cho, *rest):
        *rest, lv0, lv1, csrc = rest
        segment_levels_f64_ref(t, ssum, cho, *rest[:10], lv0, lv1, csrc)

    def plain_dense(t, ssum, cho, w, A, esrc, lv_ptr, rows, row_ptr,
                    in_edges, elat_sum, vcost, csrc):
        dense_levels_f32_ref(t, ssum, cho, w, A, esrc, elat_sum, vcost, csrc)

    cuda = torch.device("cuda")
    g, p = port_case("stencil2c")
    plan = compile_plan(g, p)
    src, keep = variants(g, "both", 8)
    batches = [plan.patch_structure(src=src, keep=keep)]
    if Kl is None:
        batches.append(StructureBatch.from_plans(
            [compile_plan(*port_case(n)) for n in ("random", "random4")]))
    for sb in batches:
        q = p if sb.plan_hash is not None else port_case("random")[1]
        mp = sb.as_multi()
        for stage, loop, plain in (
                (eng.stage_segment, segment_levels_f64, plain_segment),
                (eng.stage_multi, dense_levels_f32, plain_dense)):
            a = stage(mp, cuda)
            lanes = None
            if Kl is not None:
                ex = np.random.default_rng(9).uniform(0.0, 5.0,
                                                      (Kl, g.num_edges))
                lanes = eng.stage_lanes(a, torch.from_numpy(
                    np.ascontiguousarray(np.broadcast_to(
                        plan.patch_costs(ex).econst,
                        (sb.B, Kl) + plan.econst.shape))).cuda())
            fwd = (eng.segment_forward_multi if loop is segment_levels_f64
                   else eng.dense_forward_multi)
            name = loop.__name__
            for S in (1056, 37, 1):
                b = grid(q, S)
                LG = [torch.from_numpy(np.stack([x] * sb.B)).cuda()
                      for x in (b.L, b.gscale)]
                for lam in (False, True):
                    n0 = (loop.launches, sparse_backtrace.launches)
                    got = fwd(a, *LG, lam, lanes=lanes)
                    torch.cuda.synchronize()
                    assert (loop.launches - n0[0],
                            sparse_backtrace.launches - n0[1]) == (1, int(lam))
                    monkeypatch.setattr(eng, name, plain)
                    monkeypatch.setattr(eng, "sparse_backtrace",
                                        sparse_walk_ref)
                    want = fwd(a, *LG, lam, lanes=lanes)
                    monkeypatch.undo()
                    for u, v in zip(got, want):
                        assert torch.equal(u, v) if u is not None \
                            else v is None, (name, sb.B, Kl, S, lam)
            del a
        for pol in (SEG, DENSE):
            card = Engine(sb.base if sb.plan_hash else sb, policy=pol).run(
                Query(grid(q), structure=sb if sb.plan_hash else None))
            host = Engine(sb.base if sb.plan_hash else sb, policy=pol,
                          device="cpu").run(
                Query(grid(q), structure=sb if sb.plan_hash else None))
            np.testing.assert_array_equal(card.T, host.T)
            np.testing.assert_array_equal(card.lam, host.lam)
