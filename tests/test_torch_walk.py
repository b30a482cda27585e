"""The recorded sources (``csrc``) of the four level loops and the one-load
critical-path walk (``sparse_backtrace``, plain version
``sparse_walk_ref``).

On the CPU (the kernels' plain versions):

* every level loop — sparse float32, sparse float64, dense float32 (solo
  and packed) and segment float64 (solo and packed) — records beside each
  row's chosen edge its source row, ``csrc == esrc[cho]`` wherever ``cho
  >= 0`` and −1 elsewhere, and its λ run's t equals its values run's; on
  a small stencil, a tie-heavy plan (rows of 7 in-edges, 1e-13
  offsets inside the ATOL rules), ``random_dag`` and a wide plan whose
  levels outgrow the float64 kernel's ring slots and whose edges reach
  past its window of recent rows;
* the one-load walk over ``csrc`` equals the two-load walk over ``esrc``
  (``sparse_backtrace_ref``), from the real sinks and from every row;
* the packed walk, all G graphs at once, equals G solo walks;
* T, λ and ρ of every backend still equal the JAX package's: segment
  bit for bit against ``_segment_core`` (64-bit JAX), the sparse float64
  forward bit for bit against the scalar engine, dense and sparse float32
  within 1e-5 of the reference's pallas backend (interpret mode).

On the card (``-m gpu``): the redesigned float64 level loop (ring and
window) and the walk against their plain versions, bit for bit, at S 256,
37 and 1.  JAX is imported inside fixtures only: the card's host has none.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import loggps, synth
from repro_torch.core.graph import GraphBuilder
from repro_torch.kernels.maxplus import (dense_levels_f32_ref,
                                         sparse_backtrace,
                                         sparse_backtrace_ref,
                                         sparse_levels_f32_ref,
                                         sparse_levels_f64,
                                         sparse_levels_f64_ref,
                                         sparse_walk_ref)
from repro_torch.sweep import (Engine, ExecPolicy, compile_plan,
                               compile_sparse, latency_grid, pack_plans)
from repro_torch.sweep import engine as eng

CPU = torch.device("cpu")
CASES = ("stencil", "ties", "random", "wide")
PACKED = ("stencil", "ties", "random")
DELTAS = np.linspace(0.0, 12.0, 5)
# the float64 kernel's ring slot (rows, edges) and its window of recent
# rows on an H100 at its widest (one scenario a block)
SLOT_ROWS, SLOT_EDGES = 128, 160
WINDOW_ROWS = 13386


def _params(L=loggps):
    return L.cluster_params(L_us=3.0, o_us=5.0)


def ties_graph(p, G=None):
    """8 ranks x 3 rounds of integer-cost compute and 1-byte ring and skip
    messages, each round closed on every rank by a join of its own and six
    other ranks' tails (rows of 7 in-edges) through edges of integer cost,
    some carrying a class-0 latency, some 1e-13 off (ties within the ATOL
    rules)."""
    R = 8
    rng = np.random.default_rng(5)
    b = (G or GraphBuilder)(R, p.nclass)
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
    return b.finalize()


def wide_graph(p, G=None, R=320, rounds=22, reach=19, seed=11):
    """R ranks x ``rounds`` of compute and random ring messages (levels of
    up to R rows, wider than a ring slot), and from round ``reach`` on a
    join on every rank of its own tail and a tail ``reach`` rounds back
    (sources up to ~14,700 rows back: past the window at every kb)."""
    rng = np.random.default_rng(seed)
    b = (G or GraphBuilder)(R, p.nclass)
    hist = []
    for i in range(rounds):
        for r in range(R):
            b.add_calc(r, float(rng.integers(1, 50)))
        for r in range(R):
            if rng.random() < 0.5:
                b.add_message(r, (r + 1 + int(rng.integers(0, 5))) % R,
                              float(rng.integers(1, 4096)), p)
        tails = [b.tail(r) for r in range(R)]
        hist.append(tails)
        if i >= reach:
            for r in range(R):
                v = b.add_sync_vertex(r)
                b.add_edge(hist[i - reach][(7 * r) % R], v,
                           const_us=float(rng.integers(0, 4000)),
                           lat=((0, int(rng.integers(1, 3))),))
                b.add_edge(tails[r], v, const_us=0.0)
                b.set_tail(r, v)
    return b.finalize()


def case(name, S=synth, L=loggps, G=None):
    """(graph, params) of a case, built with the port's modules or, given
    them, the reference's."""
    p = _params(L)
    if name == "stencil":
        return S.stencil2d(3, 3, 4, params=p), p
    if name == "random":
        return S.random_dag(np.random.default_rng(3), nranks=8, nops=200,
                            params=p), p
    build = {"ties": ties_graph, "wide": wide_graph}[name]
    return build(p, G), p


def _mats(p, S, dev=CPU):
    b = latency_grid(p, np.linspace(0.0, 12.0, S))
    return (torch.from_numpy(b.L).to(dev), torch.from_numpy(b.gscale).to(dev))


def _expect_src(cho, esrc):
    """esrc[cho] where cho >= 0, −1 elsewhere, int32."""
    ch = cho.long()
    return torch.where(ch >= 0, esrc[ch.clamp(min=0)], -1).int()


# -- csrc == esrc[cho], all four level loops ----------------------------------

def sparse_run(name, dtype, S=5, dev=CPU, levels=None):
    """The sparse forward's level loop over every weight chunk of a case's
    plan, in λ mode and in values mode: ((t, ssum, cho, csrc), the values
    run's t, staged arrays)."""
    g, p = case(name)
    a = eng.stage_sparse(compile_sparse(g, p), dev, dtype)
    f64 = dtype == torch.float64
    levels = levels or (sparse_levels_f64_ref if f64
                        else sparse_levels_f32_ref)
    L, GS = _mats(p, S, dev)
    out = []
    for lam in (True, False):
        state = eng._state((a.vcost.shape[0],), S, lam, dev, dtype)
        for lv0, lv1, base, w in eng._chunk_weights(a, L, GS, a.nlevels):
            levels(*state[:3], w.contiguous(), base, a.esrc, a.row_ptr,
                   a.v_ptr_dev, a.elat_sum, a.vcost, lv0, lv1, state[3])
        out.append(state)
    return out[0], out[1][0], a


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_sparse_level_loops_record_the_chosen_source(name, dtype):
    (t, ssum, cho, csrc), t_values, a = sparse_run(name, dtype)
    assert torch.equal(csrc, _expect_src(cho, a.esrc))
    assert (cho >= 0).any()
    assert torch.equal(t, t_values)


def _dense_state(d, L, GS, packed: bool, lam: bool):
    if packed:
        nlv = int(d.nlevels.max())
        w = eng.multi_weights(d, L, GS, nlv)
    else:
        w = eng.edge_weights(d, L, GS)
    state = eng._state(tuple(d.valid_flat.shape), L.shape[-2], lam, CPU)
    dense_levels_f32_ref(*state[:3], w, d.A, d.esrc, d.elat_sum, d.vcost_lv,
                         state[3])
    return state


def _packed_mats(names, S):
    ps = [case(n)[1] for n in names]
    mats = [_mats(p, S) for p in ps]
    return (torch.stack([m[0] for m in mats]),
            torch.stack([m[1] for m in mats]))


@pytest.mark.parametrize("name", CASES + ("packed",))
def test_dense_level_loop_records_the_chosen_source(name):
    packed = name == "packed"
    if packed:
        d = eng.stage_multi(pack_plans([compile_plan(*case(n))
                                        for n in PACKED]), CPU)
        L, GS = _packed_mats(PACKED, 5)
    else:
        g, p = case(name)
        d = eng.stage(compile_plan(g, p), CPU)
        L, GS = _mats(p, 5)
    t, ssum, cho, csrc = _dense_state(d, L, GS, packed, True)
    esrc = d.esrc.reshape(d.esrc.shape[0], -1) if packed else \
        d.esrc.reshape(-1)
    want = torch.stack([_expect_src(cho[g], esrc[g])
                        for g in range(cho.shape[0])]) if packed else \
        _expect_src(cho, esrc)
    assert torch.equal(csrc, want) and (cho >= 0).any()
    assert torch.equal(t, _dense_state(d, L, GS, packed, False)[0])


@pytest.mark.parametrize("name", CASES + ("packed",))
def test_segment_level_loop_records_the_chosen_source(name):
    if name == "packed":
        plan = pack_plans([compile_plan(*case(n)) for n in PACKED])
        L, GS = _packed_mats(PACKED, 5)
    else:
        g, p = case(name)
        plan = compile_plan(g, p)
        L, GS = _mats(p, 5)
    a = eng.stage_segment(plan, CPU)
    nlv = int(a.nlevels.max())
    t, ssum, cho, csrc = eng._segment_levels(a, L, GS, True, nlv)
    lead = cho.shape[:-2]
    esrc = a.esrc.reshape(lead + (-1,))
    want = torch.stack([_expect_src(cho[g], esrc[g])
                        for g in range(lead[0])]) if lead else \
        _expect_src(cho, esrc)
    assert torch.equal(csrc, want) and (cho >= 0).any()
    assert torch.equal(t, eng._segment_levels(a, L, GS, False, nlv)[0])


def test_wide_case_outgrows_the_ring_and_the_window():
    """The wide plan exercises the float64 kernel's slow paths: levels of
    more rows and edges than a ring slot holds, and sources further back
    (from the end of their edge's level) than the window reaches at its
    widest."""
    g, p = case("wide")
    sp = compile_sparse(g, p)
    nl = sp.nlevels
    vp, lp = sp.v_ptr[:nl + 1].astype(np.int64), \
        sp.level_ptr[:nl + 1].astype(np.int64)
    assert np.diff(vp).max() > SLOT_ROWS and np.diff(lp).max() > SLOT_EDGES
    own = slice(int(lp[0]), int(lp[nl]))
    dst = sp.edst_slot[own].astype(np.int64)
    reach = vp[np.searchsorted(vp, dst, "right")] - sp.esrc_slot[own]
    assert (reach > WINDOW_ROWS).any() and (reach < WINDOW_ROWS // 10).any()


# -- the one-load walk ---------------------------------------------------------

def _sinks(t, ssum, nv, vert_of_slot, atol):
    T = t[:nv].amax(0)
    sink = t[:nv] >= T - atol
    mx = torch.where(sink, ssum[:nv], -1e30).amax(0)
    return torch.where(sink & (ssum[:nv] >= mx), vert_of_slot[:nv, None],
                       2 ** 31 - 1).argmin(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("name", CASES)
def test_one_load_walk_equals_the_two_load_walk(name, dtype):
    (t, ssum, cho, csrc), _, a = sparse_run(name, dtype)
    nv, S = a.nv, cho.shape[1]
    starts = [_sinks(t, ssum, nv, a.vert_of_slot, 1e-12)]
    starts += [torch.arange(S, dtype=torch.int64) * 97 % nv]
    walks = []
    for vsel in starts:
        one = sparse_walk_ref(vsel, cho[:nv], csrc[:nv], a.elat, a.nlevels)
        two = sparse_backtrace_ref(vsel, cho[:nv], a.esrc, a.elat, a.nlevels)
        assert torch.equal(one, two)
        assert torch.equal(sparse_backtrace(vsel, cho[:nv], csrc[:nv],
                                            a.elat, a.nlevels), one)
        walks.append(one)
    assert (walks[0].sum(1) > 0).all()          # the sinks' critical paths


@pytest.mark.parametrize("kind", ["dense", "segment"])
def test_packed_walk_equals_solo_walks(kind):
    """All G graphs' walks at once (the packed plain version, and the
    wrapper on CPU tensors) equal G solo walks, each equal to the two-load
    walk over that graph's flat sources."""
    plan = pack_plans([compile_plan(*case(n)) for n in PACKED])
    L, GS = _packed_mats(PACKED, 6)
    if kind == "dense":
        d = eng.stage_multi(plan, CPU)
        t, ssum, cho, csrc = _dense_state(d, L, GS, True, True)
    else:
        d = eng.stage_segment(plan, CPU)
        t, ssum, cho, csrc = eng._segment_levels(d, L, GS, True,
                                                 int(d.nlevels.max()))
    G, nlv = cho.shape[0], int(d.nlevels.max())
    vsel = torch.stack([eng._dense_sink(t[g], ssum[g], d.valid[g],
                                        d.valid_flat[g], d.vert_of_slot[g])[1]
                        for g in range(G)])
    elat = d.elat.reshape(G, -1, d.elat.shape[-1])
    esrc = d.esrc.reshape(G, -1)
    packed = sparse_walk_ref(vsel, cho, csrc, elat, nlv)
    assert torch.equal(sparse_backtrace(vsel, cho, csrc, elat, nlv), packed)
    for g in range(G):
        solo = sparse_walk_ref(vsel[g], cho[g], csrc[g], elat[g], nlv)
        assert torch.equal(packed[g], solo)
        assert torch.equal(solo, sparse_backtrace_ref(vsel[g], cho[g],
                                                      esrc[g], elat[g], nlv))
    assert (packed.sum(-1) > 0).all()


WALK_SHAPES_BAD = [
    ("vsel-3d", lambda k: dict(vsel=k["vsel"][None])),
    ("packed-cho", lambda k: dict(cho=k["cho"][None])),
    ("csrc-rows", lambda k: dict(csrc=k["csrc"][1:])),
]


@pytest.mark.parametrize("change", [pytest.param(f, id=n)
                                    for n, f in WALK_SHAPES_BAD])
def test_walk_wrapper_rejects_mixed_layouts(change):
    (_, _, cho, csrc), _, a = sparse_run("stencil", torch.float64)
    kw = dict(vsel=torch.zeros(cho.shape[1], dtype=torch.int64), cho=cho,
              csrc=csrc, elat=a.elat, nlv=a.nlevels)
    sparse_backtrace(**kw)
    kw.update(change(kw))
    with pytest.raises(ValueError):
        sparse_backtrace(**kw)


# -- every backend against the JAX package -----------------------------------

@pytest.fixture(scope="module")
def reference():
    """``run(name, backend)`` → (T, λ, ρ) of the JAX package on the case
    (its ``repro.*`` modules imported here: the card's host has no JAX)."""
    jax = pytest.importorskip("jax")
    from repro import sweep as ref_sweep
    from repro.core import graph as ref_graph, loggps as ref_loggps
    from repro.core import synth as ref_synth
    from repro.sweep import engine as ref_engine

    def run(name, backend):
        g, p = case(name, ref_synth, ref_loggps, ref_graph.GraphBuilder)
        batch = ref_sweep.latency_grid(p, DELTAS)
        if backend == "segment":
            plan = ref_sweep.compile_plan(g, p)
            with jax.enable_x64(True):
                arrs = ref_engine._stage_arrays(plan, "segment", 1 << 40)
                T, lam = jax.jit(ref_engine._segment_core(True))(
                    *arrs, batch.L, batch.gscale)
                T, lam = np.asarray(T), np.asarray(lam)
        else:
            r = ref_sweep.Engine(g, params=p, policy=ref_sweep.ExecPolicy(
                backend="pallas", cache=None)).run(batch)
            T, lam = r.T, r.lam
        rho = np.where(T[..., None] > 0,
                       batch.L * lam / np.maximum(T[..., None], 1e-300), 0.0)
        return T, lam, rho

    return run


POLICIES = {"segment": ExecPolicy("segment"),
            "sparse64": ExecPolicy("sparse", dtype="float64"),
            "dense": ExecPolicy("dense"),
            "sparse32": ExecPolicy("sparse", dtype="float32")}


@pytest.mark.parametrize("backend", sorted(POLICIES))
@pytest.mark.parametrize("name", ("stencil", "ties", "random"))
def test_backends_equal_the_jax_package(reference, name, backend):
    """The float64 backends bit for bit against the reference's segment
    forward, the float32 ones within 1e-5 (ρ 1e-4) of its pallas backend."""
    g, p = case(name)
    res = Engine(g, params=p, policy=POLICIES[backend],
                 device="cpu").run(latency_grid(p, DELTAS))
    exact = backend in ("segment", "sparse64")
    want = reference(name, "segment" if exact else "pallas")
    for got, ref, rtol in zip((res.T, res.lam, res.rho), want,
                              (1e-5, 1e-5, 1e-4)):
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)


# -- on the card ---------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_ring_level_loop_and_walk_match_plain_versions_on_card(
        monkeypatch):
    """The float64 level loop (ring and window) bit for bit against its
    plain version on t, ssum, cho and csrc (λ) and on t (values), whole
    and in chunks of a few levels, at S 256, 37 and 1, and whole at S 1056
    and 528 (8 and 4 scenarios a block on an H100); the walk, solo and
    packed, bit for bit against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")
    for chunk in (None, 1 << 14):
        if chunk is not None:
            monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", chunk)
        widths = (256, 37, 1) + ((1056, 528) if chunk is None else ())
        for name in CASES:
            for S in widths:
                n0 = sparse_levels_f64.launches
                got, t_values, a = sparse_run(name, torch.float64, S, cuda,
                                              levels=sparse_levels_f64)
                torch.cuda.synchronize()
                assert sparse_levels_f64.launches > n0
                want, t_want, a_cpu = sparse_run(name, torch.float64, S)
                for x, y in zip(got + (t_values,), want + (t_want,)):
                    assert torch.equal(x.cpu(), y), (name, S, chunk)
                t, ssum, cho, csrc = got
                nv = a.nv
                vsel = torch.arange(S, dtype=torch.int64, device=cuda) \
                    * 97 % nv
                n1 = sparse_backtrace.launches
                lam = sparse_backtrace(vsel, cho[:nv], csrc[:nv], a.elat,
                                       a.nlevels)
                torch.cuda.synchronize()
                assert sparse_backtrace.launches == n1 + 1
                assert torch.equal(lam.cpu(), sparse_walk_ref(
                    vsel.cpu(), cho[:nv].cpu(), csrc[:nv].cpu(), a_cpu.elat,
                    a.nlevels))
    plan = pack_plans([compile_plan(*case(n)) for n in PACKED])
    L, GS = _packed_mats(PACKED, 37)
    d = eng.stage_segment(plan, CPU)
    nlv = int(d.nlevels.max())
    t, ssum, cho, csrc = eng._segment_levels(d, L, GS, True, nlv)
    vsel = torch.arange(37, dtype=torch.int64).repeat(cho.shape[0], 1) * 13 \
        % cho.shape[1]
    elat = d.elat.reshape(cho.shape[0], -1, d.elat.shape[-1])
    n1 = sparse_backtrace.launches
    lam = sparse_backtrace(vsel.cuda(), cho.cuda(), csrc.cuda(), elat.cuda(),
                           nlv)
    torch.cuda.synchronize()
    assert sparse_backtrace.launches == n1 + 1
    assert torch.equal(lam.cpu(), sparse_walk_ref(vsel, cho, csrc, elat, nlv))
