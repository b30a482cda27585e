"""The segment backend (``ExecPolicy("segment")``): the float64 gather/max
forward, solo and packed, and its level-loop kernel ``segment_levels_f64``.

On the CPU (the kernel's plain version, ``device="cpu"``):

* T, λ and ρ are bit-equal to the reference's own segment forward,
  ``jax.jit(_segment_core(want_lam))`` and ``_segment_core_multi``, run
  under ``jax.enable_x64(True)`` on the reference's ``compile_plan``
  tensors: random DAGs, a small 2-D stencil (one and two latency classes),
  a CG-like graph and a tie graph (integer costs, 1e-13 offsets inside the
  ATOL = 1e-12 tie rules, rows of 7 in-edges), at S = 1, 5 and 37 and on a
  grid with bandwidth scales γ ≠ 1;
* the same T, λ and ρ are bit-equal to ``repro.core.dag`` and to the
  port's sparse float64 forward;
* a packed engine of three graphs of different depths, each with its own
  scenario batch, equals each graph's solo engine and the reference's
  packed forward, in one launch or with the level range split one level a
  launch;
* the in-edge lists the kernel reads, and their records in list order,
  hold for every real row the reference's per-vertex view (``vsrc``,
  ``vconst``, ``vgap``, ``vgclass``, ``vlat``) in its ordinal order, and
  every row they leave out ends in the fresh state the kernel leaves it in;
* the plain version forms each level's weights with ``_weights``, bit for
  bit, and on a plan of three latency classes with edges on several of
  them and gap scales ≠ 1 the forward equals the reference's;
* the policy: segment computes in float64 only; past the dense-size guard
  one graph switches to sparse float64 with a warning and a packed plan is
  refused; ``critical_latencies`` and ``latency_tolerance`` on segment
  equal ``core.dag.breakpoints`` and ``core.dag.tolerance``;
* the wrapper runs the plain version on CPU tensors without counting a
  launch, and refuses bad inputs.

On the card (``-m gpu``): the kernel against its plain version, bit for
bit on t, ssum, cho and csrc, solo and packed, values and λ, one launch a
forward, and with the level range split.  JAX is imported inside a
fixture only: the card's host has none.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import dag as ref_dag, graph as ref_graph
from repro.core import loggps as ref_loggps, synth as ref_synth
from repro.sweep import compile as ref_compile, engine as ref_engine

from repro_torch.core import graph, loggps, sensitivity, synth
from repro_torch.kernels.maxplus import (segment_levels_f64,
                                         segment_levels_f64_ref)
from repro_torch.kernels.maxplus.ref import segment_level_weights
from repro_torch.sweep import (Engine, ExecPolicy, cartesian_grid,
                               compile_plan, latency_grid, pack_plans)
from repro_torch.sweep import engine as eng

SEG = ExecPolicy(backend="segment")
F64 = ExecPolicy(backend="sparse", dtype="float64")
CASES = ("random0", "random3", "stencil", "stencil2c", "cg", "ties")
WIDTHS = (1, 5, 37)
PACKED = ("random3", "stencil", "cg")          # three depths
CPU = torch.device("cpu")


def _ties(G, L):
    """8 ranks x 3 rounds of integer-cost compute and 1-byte ring and skip
    messages, each round closed on every rank by a join of its own and six
    other ranks' tails (rows of 7 in-edges, past the kernel's two in
    registers) through edges of integer cost, some carrying a class-0
    latency, some 1e-13 off (ties within the ATOL rules); one isolated
    vertex (a row with no in-edge)."""
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    R = 8
    rng = np.random.default_rng(5)
    b = G.GraphBuilder(R, p.nclass)
    for _ in range(3):
        for r in range(R):
            b.add_calc(r, 10.0 * float(rng.integers(1, 4)))
        for r in range(R):
            b.add_message(r, (r + 1) % R, 1.0, p)
            b.add_message(r, (r + 3) % R, 1.0, p)
        tails = [b.tail(r) for r in range(R)]
        for r in range(R):
            v = b.add_sync_vertex(r)
            others = rng.choice([q for q in range(R) if q != r], 6,
                                replace=False)
            for q in [r, *others]:
                off = 1e-13 if rng.random() < 0.25 else 0.0
                b.add_edge(tails[q], v,
                           const_us=float(rng.integers(0, 3)) + off,
                           lat=((0, int(rng.integers(0, 2))),))
            b.set_tail(r, v)
    b.add_sync_vertex(0)
    return b.finalize(), p


def _multiclass(G, L):
    """8 ranks x 3 rounds under a three-class pod model (hosts of 2, pods of
    4): compute, ring and skip messages on the class their ranks' link
    takes, 1 MB ones among them (gap terms), and each round closed on every
    rank by a join of its own and two other ranks' tails through edges on
    all three latency classes at once (random multiplicities), each with a
    gap share on a random class."""
    p = L.pod_model(pod_size=4, ranks_per_host=2).params()
    R = 8
    rng = np.random.default_rng(9)
    b = G.GraphBuilder(R, p.nclass)
    for _ in range(3):
        for r in range(R):
            b.add_calc(r, float(rng.integers(5, 40)))
        for r in range(R):
            b.add_message(r, (r + 1) % R, 1e6, p)
            b.add_message(r, (r + 3) % R, 64.0, p)
        tails = [b.tail(r) for r in range(R)]
        for r in range(R):
            v = b.add_sync_vertex(r)
            for q in (r, (r + 2) % R, (r + 5) % R):
                gap = float(rng.integers(1, 6))
                b.add_edge(tails[q], v, const_us=gap + float(rng.integers(0, 4)),
                           lat=tuple((c, int(rng.integers(1, 4)))
                                     for c in range(3)),
                           gap_us=gap, gclass=int(rng.integers(0, 3)))
            b.set_tail(r, v)
    return b.finalize(), p


def build(name, S, L, G):
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    if name == "multiclass":
        return _multiclass(G, L)
    if name.startswith("random"):
        rng = np.random.default_rng(int(name.removeprefix("random")))
        return S.random_dag(rng, nranks=8, nops=200, params=p1), p1
    if name == "stencil2c":
        p2 = L.pod_model(pod_size=4).params()
        return S.stencil2d(4, 4, 3, params=p2), p2
    return {"ties": lambda: _ties(G, L),
            "stencil": lambda: (S.stencil2d(3, 3, 4, params=p1), p1),
            "cg": lambda: (S.cg_like(2, 2, 3, params=p1), p1)}[name]()


def port_case(name):
    return build(name, synth, loggps, graph)


def ref_case(name):
    return build(name, ref_synth, ref_loggps, ref_graph)


def _grid(p, S, top=12.0):
    return latency_grid(p, np.linspace(0.0, top, S))


def _gscale_grid(p):
    return cartesian_grid(p, lat_deltas={0: [0.0, 7.5]},
                          gscales={0: [1.0, 2.5, 4.0]})


def _rho(T, lam, L):
    return np.where(T[..., None] > 0,
                    L * lam / np.maximum(T[..., None], 1e-300), 0.0)


@pytest.fixture(scope="module")
def reference():
    """``run(plan, L, GS, multi)`` → (T, λ, ρ) of the reference's segment
    forward under 64-bit JAX (one jitted forward per layout)."""
    jax = pytest.importorskip("jax")
    fwds = {m: jax.jit((ref_engine._segment_core_multi if m
                        else ref_engine._segment_core)(True))
            for m in (False, True)}

    def run(plan, L, GS, multi=False):
        with jax.enable_x64(True):
            arrs = ref_engine._stage_arrays(plan, "segment", 1 << 40)
            T, lam = fwds[multi](*arrs, L, GS)
            T, lam = np.asarray(T), np.asarray(lam)
        assert T.dtype == lam.dtype == np.float64
        return T, lam, _rho(T, lam, L)

    return run


def _same(res, want):
    for got, ref in zip((res.T, res.lam, res.rho), want):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, ref)


def _seg(name):
    g, p = port_case(name)
    return Engine(g, params=p, policy=SEG, device="cpu"), p


@pytest.mark.parametrize("S", WIDTHS)
@pytest.mark.parametrize("name", CASES)
def test_equals_reference_segment_core(reference, name, S):
    e, p = _seg(name)
    batch = _grid(p, S)
    res = e.run(batch)
    assert res.backend == "segment" and res.axes == ("S",)
    g_ref, p_ref = ref_case(name)
    want = reference(ref_compile.compile_plan(g_ref, p_ref), batch.L,
                     batch.gscale)
    _same(res, want)
    np.testing.assert_array_equal(e.run(batch, compute_lam=False).T, res.T)


@pytest.mark.parametrize("name", ["random0", "stencil2c", "ties"])
def test_gscale_grid_equals_reference_and_sparse(reference, name):
    e, p = _seg(name)
    batch = _gscale_grid(p)
    assert (batch.gscale != 1.0).any()
    res = e.run(batch)
    g_ref, p_ref = ref_case(name)
    _same(res, reference(ref_compile.compile_plan(g_ref, p_ref), batch.L,
                         batch.gscale))
    g, _ = port_case(name)
    sp = Engine(g, params=p, policy=F64, device="cpu").run(batch)
    _same(res, (sp.T, sp.lam, sp.rho))


@pytest.mark.parametrize("name", CASES)
def test_equals_core_dag_and_sparse_f64(name):
    e, p = _seg(name)
    batch = _grid(p, 5)
    res = e.run(batch)
    g_ref, p_ref = ref_case(name)
    lp = ref_dag.LevelPlan(g_ref)
    out = [lp.forward(p_ref.replace(L=tuple(batch.L[i])))
           for i in range(batch.S)]
    _same(res, (np.array([s.T for s in out]), np.stack([s.lam for s in out]),
                np.stack([s.rho() for s in out])))
    g, _ = port_case(name)
    sp = Engine(g, params=p, policy=F64, device="cpu").run(batch)
    _same(res, (sp.T, sp.lam, sp.rho))
    assert (res.lam >= 1).any()


def _packed_batches(p):
    return [_grid(p, 5, top) for top in (12.0, 30.0, 4.0)]


def _level_loop(calls: list, split: bool):
    """A stand-in for the engine's level-loop wrapper that records each
    call's level range in ``calls`` and, with ``split``, runs it one level
    a launch."""
    def run(t, ssum, cho, *rest):
        *rest, lv0, lv1, csrc = rest
        calls.append((lv0, lv1))
        for a, b in ([(lv, lv + 1) for lv in range(lv0, lv1)] if split
                     else [(lv0, lv1)]):
            segment_levels_f64(t, ssum, cho, *rest, a, b, csrc)
    return run


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
def test_packed_equals_solo_and_reference(reference, chunked, monkeypatch):
    """G = 3 graphs of different depths, each with its own scenario batch:
    one packed engine equals each graph's solo engine and the reference's
    ``_segment_core_multi`` on its own packed plan, bit for bit, with the
    level loop in one launch (whole) or split one level a launch
    (chunked)."""
    ports = [port_case(n) for n in PACKED]
    p = ports[0][1]
    batches = _packed_batches(p)
    plans = [compile_plan(g, q) for g, q in ports]
    assert len({pl.nlevels for pl in plans}) == len(PACKED)
    calls = []
    monkeypatch.setattr(eng, "segment_levels_f64", _level_loop(calls, chunked))
    e = Engine(plans, names=list(PACKED), policy=SEG, device="cpu")
    runs0 = eng.segment_forward_multi.runs["lam"]
    res = e.run(batches)
    assert eng.segment_forward_multi.runs["lam"] == runs0 + 1
    assert res.axes == ("G", "S") and res.backend == "segment"
    assert isinstance(e.arrays, eng.SegmentArrays)
    assert calls == [(0, max(pl.nlevels for pl in plans))]
    for gi, (name, b) in enumerate(zip(PACKED, batches)):
        solo = Engine(plans[gi], policy=SEG, device="cpu").run(b)
        _same(res[name], (solo.T, solo.lam, solo.rho))
    refs = [ref_case(n) for n in PACKED]
    mp_ref = ref_compile.pack_plans([ref_compile.compile_plan(g, q)
                                     for g, q in refs])
    L = np.stack([b.L for b in batches])
    GS = np.stack([b.gscale for b in batches])
    _same(res, reference(mp_ref, L, GS, multi=True))
    vals = e.run(batches, compute_lam=False)
    np.testing.assert_array_equal(vals.T, res.T)
    # a MultiPlan is taken as it is
    mp = pack_plans(plans)
    again = Engine(mp, policy=SEG, device="cpu").run(batches)
    np.testing.assert_array_equal(again.T, res.T)
    np.testing.assert_array_equal(again.lam, res.lam)


@pytest.mark.parametrize("name", ["random3", "ties", "cg"])
def test_chunked_equals_whole(name, monkeypatch):
    """The level range split one level a launch equals one launch."""
    e, p = _seg(name)
    batch = _grid(p, 5)
    whole = e.run(batch)
    calls = []
    monkeypatch.setattr(eng, "segment_levels_f64", _level_loop(calls, True))
    chunked = e.run(batch)
    assert calls == [(0, e.plan.nlevels)] and e.plan.nlevels > 1
    _same(chunked, (whole.T, whole.lam, whole.rho))


@pytest.mark.parametrize("name", CASES)
def test_lists_equal_reference_vertex_view(name):
    """Each real row's staged in-edges, in list order, are the reference's
    per-vertex view of that row (source slot, const, gap, class, latency
    row) in ordinal order, both in the per-edge view and in the records
    the kernel reads (in_edges' source listed row and gap class, erec,
    rcost); the rows left out have no in-edge and no cost."""
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    ref = ref_compile.compile_plan(g_ref, p_ref)
    plan = compile_plan(g, p)
    a = eng.stage_segment(plan, CPU)
    Vmax, Emax = plan.Vmax, plan.Emax
    assert (ref.vsrc.shape[1], ref.esrc.shape[1]) == (Vmax, Emax)
    lv_ptr, rows, row_ptr = (x.numpy() for x in (a.lv_ptr, a.rows,
                                                a.row_ptr))
    ie, erec, rcost = a.in_edges.numpy(), a.erec.numpy(), a.rcost.numpy()
    assert ie.shape[1] == 4 and erec.shape[1] == 3 + plan.elat.shape[-1]
    listed = set()
    for lv in range(plan.nlv_p):
        for q in range(lv_ptr[lv], lv_ptr[lv + 1]):
            r = int(rows[q])
            assert r // Vmax == lv
            listed.add(r)
            d = r % Vmax
            e = ie[row_ptr[q]:row_ptr[q + 1]]
            n = e.shape[0]
            mask = ref.vmaskd[lv, d]
            assert mask[:n].all() and not mask[n:].any()
            ev = e[:, 0]
            assert (ev // Emax == lv).all()
            np.testing.assert_array_equal(e[:, 1], ref.vsrc[lv, d, :n])
            # the kernel's records of the same edges, in list order
            qs = e[:, 2]
            np.testing.assert_array_equal(
                np.where(qs >= 0, rows[qs], -1),
                np.where(np.isin(e[:, 1], rows), e[:, 1], -1))
            np.testing.assert_array_equal(e[:, 3], ref.vgclass[lv, d, :n])
            rec = erec[row_ptr[q]:row_ptr[q + 1]]
            for col, vfield in ((0, "vconst"), (1, "vgap"), (2, "vlat_sum")):
                np.testing.assert_array_equal(
                    rec[:, col], getattr(ref, vfield)[lv, d, :n],
                    err_msg=vfield)
            np.testing.assert_array_equal(rec[:, 3:], ref.vlat[lv, d, :n])
            assert rcost[q] == ref.vcost_lv[lv, d]
            for field, vfield in (("econst", "vconst"), ("egap", "vgap"),
                                  ("egclass", "vgclass"), ("elat", "vlat"),
                                  ("elat_sum", "vlat_sum")):
                got = getattr(a, field).reshape(
                    (plan.nlv_p * Emax,) + getattr(a, field).shape[2:])
                np.testing.assert_array_equal(
                    got[ev].numpy(), getattr(ref, vfield)[lv, d, :n],
                    err_msg=field)
    for r in set(range(plan.nlv_p * Vmax)) - listed:
        assert not ref.vmaskd[r // Vmax, r % Vmax].any()
        assert ref.vcost_lv[r // Vmax, r % Vmax] == 0.0
    if name == "ties":                  # rows past the two in registers
        assert (np.diff(row_ptr[:lv_ptr[-1] + 1]) == 7).any()


@pytest.mark.parametrize("name", ["ties", "stencil", "random0"])
def test_plain_version_leaves_unlisted_rows_fresh(name):
    """The plain version writes every row of the walked levels, the kernel
    only the listed ones: each row the lists leave out ends in the fresh
    state (t 0, ssum 0, cho −1, csrc −1), so both leave the same state."""
    g, p = port_case(name)
    plan = compile_plan(g, p)
    a = eng.stage_segment(plan, CPU)
    batch = _grid(p, 5)
    t, ssum, cho, csrc = eng._segment_levels(
        a, torch.from_numpy(batch.L), torch.from_numpy(batch.gscale), True,
        plan.nlevels)
    listed = np.zeros(t.shape[0], dtype=bool)
    listed[a.rows.numpy()[:a.lv_ptr.numpy()[-1]]] = True
    off = torch.from_numpy(~listed)
    assert (t[off] == 0).all() and (ssum[off] == 0).all()
    assert (cho[off] == -1).all() and (csrc[off] == -1).all()
    assert (cho[torch.from_numpy(listed)] >= 0).any()


@pytest.mark.parametrize("atol", [0.0, eng.ATOL])
@pytest.mark.parametrize("key_dtype", [torch.float32, torch.float64])
def test_sink_equals_the_whole_array_rule(atol, key_dtype):
    """The sink decided on the pairs within atol of T equals the
    whole-array rule (the latest valid end within atol, then the largest
    slope, then the smallest vertex id), on states full of exact and
    within-ATOL ties, invalid slots ending later than T, and slopes tied
    across slots."""
    rng = np.random.default_rng(3)
    nflat, S = 400, 37
    t = torch.from_numpy(rng.integers(0, 4, (nflat, S)) * 10.0
                         + (rng.random((nflat, S)) < 0.3) * 1e-13)
    valid_flat = torch.from_numpy(rng.random(nflat) < 0.8)
    t[~valid_flat] += 100.0
    ssum = torch.from_numpy(rng.integers(0, 3, (nflat, S)).astype(
        np.float64)).to(key_dtype)
    vert = torch.from_numpy(rng.permutation(nflat).astype(np.int32))
    valid = valid_flat.nonzero()[:, 0]
    T, vsel = eng._dense_sink(t, ssum, valid, valid_flat, vert, atol)
    wantT = t[valid].amax(0)
    sink = valid_flat[:, None] & (t >= wantT - atol)
    mx = torch.where(sink, ssum, -eng.BIG).amax(0)
    top = sink & (ssum >= mx)
    want = torch.where(top, vert[:, None],
                       torch.iinfo(torch.int32).max).argmin(0)
    assert torch.equal(T, wantT) and torch.equal(vsel, want)
    assert (sink.sum(0) > 1).any() and (top.sum(0) > 1).any()


def test_policy_segment_is_float64_only():
    for dtype in ("auto", "float64"):
        ExecPolicy(backend="segment", dtype=dtype).validate()
    with pytest.raises(ValueError, match="computes in float64"):
        ExecPolicy(backend="segment", dtype="float32").validate()
    assert not SEG.float32
    assert ExecPolicy().backend == "segment"


def test_guard_switches_one_graph_and_refuses_a_packed_plan():
    """Past the dense-size guard a segment engine on one graph warns and
    switches to sparse float64 (the reference's route, the same estimate
    and threshold as dense "auto"), with the same T and λ; a compiled or
    packed plan over the guard is refused."""
    g, p = port_case("stencil")
    batch = _grid(p, 5)
    want = Engine(g, params=p, policy=SEG, device="cpu").run(batch)
    small = ExecPolicy(backend="segment", max_dense_bytes=1024)
    with pytest.warns(RuntimeWarning, match="auto-switching"):
        e = Engine(g, params=p, policy=small, device="cpu")
    assert e.policy.backend == "sparse" and not e.policy.float32
    got = e.run(batch)
    assert got.backend == "sparse"
    _same(got, (want.T, want.lam, want.rho))
    dense = ExecPolicy(max_dense_bytes=1024)
    with pytest.warns(RuntimeWarning):
        assert Engine(g, params=p, policy=dense,
                      device="cpu").policy.backend == "sparse"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="packed plan"):
            Engine([(g, p), (g, p)], policy=small, device="cpu")
        with pytest.raises(ValueError, match="segment backend"):
            Engine(compile_plan(g, p), policy=small, device="cpu")
    with pytest.raises(ValueError, match="one graph at a time"):
        Engine([(g, p), (g, p)], policy=F64, device="cpu")


@pytest.mark.parametrize("seed", [0, 7])
def test_consumers_on_segment_equal_core_dag(seed):
    """``critical_latencies`` and ``latency_tolerance`` take ``policy=``
    unchanged: on segment they equal ``core.dag.breakpoints`` and
    ``core.dag.tolerance``."""
    name = f"random{seed}"
    g, p = port_case(name)
    g_ref, p_ref = ref_case(name)
    want = ref_dag.breakpoints(g_ref, p_ref, 0.5, 500.0)
    got = sensitivity.critical_latencies(g, p, 0.5, 500.0, device="cpu",
                                         policy=SEG)
    assert got == want and len(want) > 0
    degr = (0.01, 0.02, 0.05)
    tol = sensitivity.latency_tolerance(g, p, degr, device="cpu", policy=SEG)
    assert tol == {d: ref_dag.tolerance(g_ref, p_ref, d) for d in degr}


ARGS = ("t", "ssum", "cho", "Lmat", "GSmat", "edst", "esrc", "econst",
        "egap", "egclass", "elat", "elat_sum", "vcost", "lv_ptr", "rows",
        "row_ptr", "in_edges", "erec", "rcost", "lv0", "lv1", "csrc")


def _wrapper_args(S=4, lam=True):
    g, p = port_case("ties")
    plan = compile_plan(g, p)
    a = eng.stage_segment(plan, CPU)
    t, ssum, cho, csrc = eng._state(tuple(a.valid_flat.shape), S, lam, CPU,
                                    torch.float64)
    b = _grid(p, S)
    return dict(zip(ARGS, (t, ssum, cho, torch.from_numpy(b.L),
                           torch.from_numpy(b.gscale),
                           *eng.segment_inputs(a), 0, plan.nlevels, csrc)))


def test_wrapper_runs_the_plain_version_on_cpu():
    n0 = segment_levels_f64.launches
    gen = torch.Generator().manual_seed(1)
    for lam in (False, True):
        kw = _wrapper_args(lam=lam)
        want = _wrapper_args(lam=lam)
        kw["Lmat"].uniform_(0.0, 5.0, generator=gen)
        kw["GSmat"].uniform_(1.0, 3.0, generator=gen)
        want["Lmat"], want["GSmat"] = kw["Lmat"], kw["GSmat"]
        segment_levels_f64(**kw)
        segment_levels_f64_ref(*(want[k] for k in ARGS[:13]), want["lv0"],
                               want["lv1"], want["csrc"])
        for k in ("t", "ssum", "cho", "csrc"):
            assert (kw[k] is None and want[k] is None) \
                or torch.equal(kw[k], want[k])
        assert (kw["t"] > 0).any()
    assert segment_levels_f64.launches == n0


BAD = [
    ("ssum-f32", TypeError, lambda k: dict(ssum=k["ssum"].float())),
    ("elat_sum-f32", TypeError,
     lambda k: dict(elat_sum=k["elat_sum"].float())),
    ("edst-i32", TypeError, lambda k: dict(edst=k["edst"].int())),
    ("t-rank", ValueError, lambda k: dict(t=k["t"][:, 0])),
    ("Lmat-width", ValueError, lambda k: dict(Lmat=k["Lmat"][:3])),
    ("GSmat-f32", TypeError, lambda k: dict(GSmat=k["GSmat"].float())),
    ("cho-only", ValueError, lambda k: dict(ssum=None)),
    ("csrc-missing", ValueError, lambda k: dict(csrc=None)),
    ("row_ptr-len", ValueError, lambda k: dict(row_ptr=k["row_ptr"][1:])),
    ("levels", ValueError, lambda k: dict(lv0=3, lv1=3)),
    ("t-rows", ValueError, lambda k: dict(t=k["t"][1:], ssum=k["ssum"][1:],
                                           cho=k["cho"][1:],
                                           csrc=k["csrc"][1:])),
    ("in_edges-pairs", ValueError,
     lambda k: dict(in_edges=k["in_edges"][:, :2].contiguous())),
    ("erec-classes", ValueError,
     lambda k: dict(erec=k["erec"][:, :3].contiguous())),
]


@pytest.mark.parametrize("change", [pytest.param((e, f), id=n)
                                    for n, e, f in BAD])
def test_wrapper_rejects_bad_inputs(change):
    exc, fn = change
    kw = _wrapper_args()
    segment_levels_f64(**kw)
    kw.update(fn(kw))
    with pytest.raises(exc):
        segment_levels_f64(**kw)


@pytest.mark.parametrize("name", ["stencil2c", "multiclass", "packed"])
def test_plain_version_weights_equal_weights(name):
    """The plain version's per-level weights (``segment_level_weights``)
    equal ``_weights`` over the whole per-edge view at once, bit for bit,
    graph by graph from its own scenario rows: the weights the forward
    took from a weight chunk before the level loop formed them."""
    if name == "packed":
        a = eng.stage_segment(pack_plans(
            [compile_plan(*port_case(n)) for n in PACKED]), CPU)
        bs = _packed_batches(port_case(PACKED[0])[1])
    else:
        g, p = port_case(name)
        a = eng.stage_segment(compile_plan(g, p), CPU)
        a = dataclasses.replace(a, **{f: getattr(a, f)[None] for f in (
            "econst", "egap", "egclass", "elat")})
        bs = [_gscale_grid(p)]
    L = torch.from_numpy(np.stack([b.L for b in bs]))
    GS = torch.from_numpy(np.stack([b.gscale for b in bs]))
    assert (GS != 1.0).any() or name == "packed"
    nlv = int(a.nlevels.max())
    for gi in range(L.shape[0]):
        whole = eng._weights(a.egclass[gi, :nlv], a.egap[gi, :nlv],
                             a.econst[gi, :nlv], a.elat[gi, :nlv], L[gi],
                             GS[gi])
        for lv in range(nlv):
            w = segment_level_weights(L, GS, a.econst, a.egap, a.egclass,
                                      a.elat, lv)
            assert torch.equal(w[gi], whole[lv]), (gi, lv)


@pytest.mark.parametrize("S", [1, 5])
def test_multiclass_gscale_equals_reference(reference, S):
    """Three latency classes, edges on all three at once, gap terms on
    each, gap scales ≠ 1 on two classes: T, λ and ρ equal the reference's
    ``_segment_core`` and the sparse float64 forward's, bit for bit."""
    e, p = _seg("multiclass")
    assert p.nclass == 3 and (e.arrays.elat > 0).sum(-1).max() == 3
    lat = np.linspace(0.0, 9.0, S)
    batch = cartesian_grid(p, lat_deltas={0: lat, 2: [0.0, 4.0]},
                           gscales={1: [1.0, 2.5], 2: [0.5, 3.0]})
    assert (batch.gscale != 1.0).any()
    res = e.run(batch)
    g_ref, p_ref = ref_case("multiclass")
    _same(res, reference(ref_compile.compile_plan(g_ref, p_ref), batch.L,
                         batch.gscale))
    g, _ = port_case("multiclass")
    sp = Engine(g, params=p, policy=F64, device="cpu").run(batch)
    _same(res, (sp.T, sp.lam, sp.rho))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card(monkeypatch):
    """The kernel against its plain version on the card, bit for bit on t,
    ssum, cho and csrc (every element), solo on every case and packed on
    three, values and λ, at S = 1, 5, 37 and 256: one launch a forward;
    then with the level range split in three launches (the later ones
    read earlier launches' rows from device memory); then the card's
    engine equal to the CPU's, solo and packed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    cases = {n: port_case(n) for n in CASES + ("multiclass",)}
    plans = {n: compile_plan(g, q) for n, (g, q) in cases.items()}
    staged = [(eng.stage_segment(plans[n], cuda), cases[n][1])
              for n in cases]
    staged.append((eng.stage_segment(pack_plans([plans[n] for n in PACKED]),
                                     cuda), cases[PACKED[0]][1]))
    for a, q in staged:
        G = a.esrc.shape[0] if a.esrc.dim() == 3 else 0
        nlv = int(a.nlevels.max())
        for S in WIDTHS + (256,):
            b = _grid(q, S)
            L, GS = (torch.from_numpy(np.stack([x] * G) if G else x)
                     for x in (b.L, b.gscale))
            L, GS = L.cuda(), GS.cuda()
            for want_lam in (False, True):
                n0 = segment_levels_f64.launches
                got = eng._segment_levels(a, L, GS, want_lam, nlv)
                torch.cuda.synchronize()
                assert segment_levels_f64.launches == n0 + 1
                monkeypatch.setattr(eng, "segment_levels_f64",
                                    _plain_on_card)
                want = eng._segment_levels(a, L, GS, want_lam, nlv)
                monkeypatch.setattr(eng, "segment_levels_f64",
                                    _split_in_three)
                split = eng._segment_levels(a, L, GS, want_lam, nlv)
                monkeypatch.setattr(eng, "segment_levels_f64",
                                    segment_levels_f64)
                for x, y, z in zip(got, want, split):
                    assert (x is None and y is None and z is None) or (
                        torch.equal(x, y) and torch.equal(z, y)), \
                        (G, S, want_lam)
    for g, q in cases.values():
        batch = _grid(q, 5)
        card = Engine(g, params=q, policy=SEG).run(batch)
        host = Engine(g, params=q, policy=SEG, device=CPU).run(batch)
        np.testing.assert_array_equal(card.T, host.T)
        np.testing.assert_array_equal(card.lam, host.lam)
    pk = [plans[n] for n in PACKED]
    batches = _packed_batches(cases[PACKED[0]][1])
    card = Engine(pk, policy=SEG).run(batches)
    host = Engine(pk, policy=SEG, device=CPU).run(batches)
    np.testing.assert_array_equal(card.T, host.T)
    np.testing.assert_array_equal(card.lam, host.lam)


def _plain_on_card(t, ssum, cho, *rest):
    """The plain version on the card's tensors, in the wrapper's call
    shape."""
    *rest, lv0, lv1, csrc = rest
    segment_levels_f64_ref(t, ssum, cho, *rest[:10], lv0, lv1, csrc)


def _split_in_three(t, ssum, cho, *rest):
    """The kernel over the level range in three launches."""
    *rest, lv0, lv1, csrc = rest
    cuts = sorted({lv0, lv0 + (lv1 - lv0) // 3, lv0 + 2 * (lv1 - lv0) // 3,
                   lv1})
    for a, b in zip(cuts, cuts[1:]):
        segment_levels_f64(t, ssum, cho, *rest, a, b, csrc)
