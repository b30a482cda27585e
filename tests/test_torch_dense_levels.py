"""The dense float32 forward's level loop (``dense_levels_f32``, solo and
packed) and the walk over its flat chosen-edge ids.

* The plain version (``dense_levels_f32_ref``: the per-level body on the
  indicator) equals, bit for bit on ``t``, ``ssum`` and ``cho`` of every
  slot, a scalar per-row model of the CUDA kernel's rule, which starts from
  the fresh state and reads only the staged lists: for each listed row
  (a real in-edge or a vertex cost), one pass over its real in-edges in
  increasing slot, keeping the lexicographic best (value, key, slot) and
  the float64 remainder of the float32 maximum.  Values and λ, solo and
  packed, on the conformance cases and on constructed levels with full
  ties, float32 ties that differ in float64, negative maxima and rows with
  no in-edge.
* The level loop picks, level by level, the winners of the JAX package's
  argmax kernel (interpret mode) on the same candidates and tie keys.
* The walk over flat ``cho`` equals the level-ordered backtrace the
  forwards ran before, kept here as the oracle.
* The wrapper refuses bad inputs, runs the plain version on the CPU and
  counts no launch there; the ``gpu`` test holds the kernel against the
  plain version on the card, bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import loggps, synth
from repro_torch.kernels.maxplus import (dense_levels_f32,
                                         dense_levels_f32_ref,
                                         maxplus_matvec,
                                         maxplus_matvec_argmax,
                                         maxplus_matvec_argmax_batched,
                                         maxplus_matvec_batched,
                                         sparse_backtrace,
                                         sparse_backtrace_ref)
from repro_torch.sweep import (CompiledPlan, Engine, ExecPolicy, compile_plan,
                               latency_grid, pack_plans)
from repro_torch.sweep import engine as eng

CPU = torch.device("cpu")
# the dense backend's level loop is what this file tests (the default is
# segment, as the reference's is)
DENSE = ExecPolicy("dense")
NAMES = ("stencil", "cg", "allreduce", "stencil2c", "stencil3c")
PACKED = ("allreduce", "mixed", "built")
ALGOS = ("ring", "bidir_ring", "recursive_doubling", "tree")
S = 5


def build(name):
    """(graph, params) of one conformance case (``tests/test_conformance.py``)."""
    p1 = loggps.cluster_params(L_us=3.0, o_us=5.0)
    p2 = loggps.pod_model(pod_size=2).params()
    p3 = loggps.pod_model(pod_size=4, ranks_per_host=2).params()
    return {
        "stencil": lambda: (synth.stencil2d(3, 3, 4, params=p1), p1),
        "cg": lambda: (synth.cg_like(2, 2, 3, params=p1), p1),
        "allreduce": lambda: (synth.allreduce_chain(8, 3, params=p1), p1),
        "stencil2c": lambda: (synth.stencil2d(2, 2, 3, params=p2), p2),
        "stencil3c": lambda: (synth.stencil2d(4, 2, 3, params=p3), p3),
    }[name]()


def _grid(p, n=S):
    batch = latency_grid(p, np.linspace(0.0, 60.0, n))
    return torch.from_numpy(batch.L), torch.from_numpy(batch.gscale)


# -- a constructed plan: every corner of the rule ---------------------------

def built_plan():
    """Three levels of 4 slots, 8 edge slots, one class; level 3 padded.

    Level 1: row 0 a full tie of three in-edges (equal value and key: the
    last slot wins); row 1 two in-edges equal in float32 but not in
    float64, the smaller float64 one with the larger key (it wins λ, the
    other sets t); row 2 a negative maximum (lost); row 3 no in-edge.
    Level 2 reads level 1 (keys carry ssum) and the lost row."""
    nlv_p, V, E = 4, 4, 8
    edges = [  # (level, slot, flat source, local destination, elat)
        (1, 0, 0, 0, 1.0), (1, 1, 1, 0, 1.0), (1, 2, 2, 0, 1.0),
        (1, 3, 0, 1, 3.0), (1, 4, 1, 1, 1.0), (1, 5, 2, 2, 1.0),
        (2, 0, 4, 0, 1.0), (2, 1, 5, 0, 1.0), (2, 2, 6, 1, 2.0)]
    dummy = nlv_p * V
    esrc = np.full((nlv_p, E), dummy, np.int32)
    edstl = np.full((nlv_p, E), V, np.int32)
    emask = np.zeros((nlv_p, E), bool)
    elat = np.zeros((nlv_p, E, 1))
    for lv, j, src, dst, el in edges:
        esrc[lv, j], edstl[lv, j], emask[lv, j] = src, dst, True
        elat[lv, j, 0] = el
    vcost = np.zeros((nlv_p, V))
    vcost[0, :3] = (1.0, 1.0, 2.0)
    vcost[1] = (1.0, 2.0, 0.25, 0.5)
    vcost[2, :2] = (0.0, 3.0)
    slots = [0, 1, 2, 4, 5, 6, 7, 8, 9]
    valid = np.zeros(dummy + 1, bool)
    valid[slots] = True
    vert = np.full(dummy + 1, len(slots), np.int32)
    vert[slots] = np.arange(len(slots))
    z = np.zeros((nlv_p, E))
    return CompiledPlan(
        esrc=esrc, edstl=edstl, emask=emask, econst=z, egap=z,
        egclass=np.zeros((nlv_p, E), np.int32), elat=elat, vcost_lv=vcost,
        valid_flat=valid, vert_of_slot=vert, nv=len(slots), nclass=1,
        nlevels=3, Dmax=4)


def built_weights(shift: float = 0.0) -> torch.Tensor:
    """[4, 8, 3] float64 weights of :func:`built_plan`, pad slots −1e30;
    scenario k adds k/2 to level 1's slot 0 (breaking the full tie) and
    ``shift`` to level 2's slot 2."""
    w = np.full((4, 8, 3), -1e30)
    for (lv, j), v in {(1, 0): 1.0, (1, 1): 1.0, (1, 2): 0.0,
                       (1, 3): 2.0 ** -29, (1, 4): 2.0 ** -30,
                       (1, 5): -10.0, (2, 0): 0.0, (2, 1): 0.0,
                       (2, 2): 1.0 + shift}.items():
        w[lv, j] = v
    w[1, 0] += np.arange(3) / 2
    return torch.from_numpy(w)


# -- runs --------------------------------------------------------------------

def solo(name):
    """(staged arrays, weights) of a case: a conformance graph at S = 5, or
    the constructed plan."""
    if name == "built":
        return eng.stage(built_plan(), CPU), built_weights()
    g, p = build(name)
    d = eng.stage(compile_plan(g, p), CPU)
    return d, eng.edge_weights(d, *_grid(p))


def packed(case):
    """(staged arrays, weights) of a packed case."""
    if case == "built":
        plan = built_plan()
        d = eng.stage_multi(pack_plans([plan, plan]), CPU)
        return d, torch.stack([built_weights(), built_weights(-3.0)])[:, :3]
    if case == "allreduce":
        p = loggps.cluster_params(L_us=3.0, o_us=5.0)
        items = [(synth.allreduce_chain(8, 2, params=p, algo=a), p)
                 for a in ALGOS]
    else:
        items = [build(n) for n in ("stencil", "cg", "allreduce")]
    d = eng.stage_multi(pack_plans([compile_plan(g, p) for g, p in items]),
                        CPU)
    grids = [_grid(p) for _, p in items]
    L = torch.stack([x for x, _ in grids])
    GS = torch.stack([x for _, x in grids])
    return d, eng.multi_weights(d, L, GS, int(d.nlevels.max()))


def run(levels, d, w, want_lam):
    """The state after ``levels`` (the wrapper or the plain version) over
    all of ``w``'s levels: (t, ssum, cho, csrc)."""
    lead = tuple(d.valid_flat.shape)
    state = eng._state(lead, w.shape[-1], want_lam, w.device)
    if levels is dense_levels_f32_ref:
        levels(*state[:3], w, d.A, d.esrc, d.elat_sum, d.vcost_lv, state[3])
    else:
        levels(*state[:3], w, d.A, d.esrc, d.lv_ptr, d.rows, d.row_ptr,
               d.in_edges, d.elat_sum, d.vcost_lv, state[3])
    return state


def scalar_model(w, lv_ptr, rows, row_ptr, in_edges, elat_sum, vcost, nflat,
                 want_lam):
    """The CUDA kernel's rule for one graph, in numpy: from the fresh state
    (0, 0, −1), level by level each listed row, one pass over its real
    in-edges in list order; no other row is written."""
    nlv, Emax, K = w.shape
    f32, neg = np.float32, np.float32(-1e30)
    wf, es, vc = w.reshape(-1, K), elat_sum.reshape(-1), vcost.reshape(-1)
    t = np.zeros((nflat, K))
    ssum = np.zeros((nflat, K), f32)
    cho = np.full((nflat, K), -1, np.int32)
    for lv in range(nlv):
        for q in range(lv_ptr[lv], lv_ptr[lv + 1]):
            bv, bk, rm = (np.full(K, neg, f32) for _ in range(3))
            bi = np.full(K, -1, np.int32)
            for p in range(row_ptr[q], row_ptr[q + 1]):
                e, src = in_edges[p]
                c64 = t[src] + wf[e]
                hi = c64.astype(f32)
                rem = f32(0.0) + (c64 - hi.astype(np.float64)).astype(f32)
                key = ssum[src] + es[e]
                gt, eq = hi > bv, hi == bv
                rm = np.where(gt, np.maximum(rem, neg),
                              np.where(eq, np.maximum(rm, rem), rm))
                take = gt | (eq & (key >= bk))
                bk, bi = np.where(take, key, bk), np.where(take, e, bi)
                bv = np.where(gt, hi, bv)
            r = rows[q]
            s = bv.astype(np.float64) + rm.astype(np.float64)
            t[r] = np.maximum(s, 0.0) + vc[r]
            has = bv >= 0.0
            ssum[r] = np.where(has, bk, f32(0.0))
            cho[r] = np.where(has, bi, -1)
    return (t, ssum, cho) if want_lam else (t, None, None)


def model_per_graph(d, w, want_lam):
    """:func:`scalar_model` of each graph of a solo (G = 1) or packed
    staging, stacked as the state."""
    if w.dim() == 3:
        d_g = [(d.lv_ptr, d.rows, d.row_ptr, d.in_edges, d.elat_sum,
                d.vcost_lv)]
        ws = [w]
    else:
        d_g = [(d.lv_ptr[g], d.rows[g], d.row_ptr[g], d.in_edges[g],
                d.elat_sum[g], d.vcost_lv[g]) for g in range(w.shape[0])]
        ws = list(w)
    nflat = d.valid_flat.shape[-1]
    per = [scalar_model(wg.numpy(), *(x.numpy() for x in args), nflat,
                        want_lam) for wg, args in zip(ws, d_g)]
    if w.dim() == 3:
        return per[0]
    return tuple(None if per[0][i] is None
                 else np.stack([s[i] for s in per]) for i in range(3))


def _equal(got, want):
    for x, y in zip(got, want):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- (b) the plain version against the kernel's rule -------------------------

@pytest.mark.parametrize("want_lam", [False, True], ids=["values", "lam"])
@pytest.mark.parametrize("name", NAMES + ("built",))
def test_plain_version_equals_the_kernels_rule_solo(name, want_lam):
    d, w = solo(name)
    got = run(dense_levels_f32_ref, d, w, want_lam)
    _equal(got, model_per_graph(d, w, want_lam))
    if want_lam:
        assert (got[2] >= 0).any() and (got[2] < 0).any()


@pytest.mark.parametrize("want_lam", [False, True], ids=["values", "lam"])
@pytest.mark.parametrize("case", PACKED)
def test_plain_version_equals_the_kernels_rule_packed(case, want_lam):
    d, w = packed(case)
    _equal(run(dense_levels_f32_ref, d, w, want_lam),
           model_per_graph(d, w, want_lam))


def test_built_levels_resolve_each_corner():
    """The constructed plan's expected outcomes, spelled out."""
    d, w = solo("built")
    t, ssum, cho, _ = run(dense_levels_f32_ref, d, w, True)
    E = 8
    # level 1, row 0 (slot 4): a full tie at scenario 0 goes to the last
    # slot (2); slot 0's weight leads at scenarios 1 and 2
    assert cho[4].tolist() == [E + 2, E + 0, E + 0]
    assert t[4].tolist() == [3.0, 3.5, 4.0]
    # row 1 (slot 5): 1 + 2^-29 and 1 + 2^-30 are both 1.0f; slot 3 (key
    # 3) wins λ, while t is the float64 maximum
    assert cho[5].tolist() == [E + 3] * 3 and ssum[5].tolist() == [3.0] * 3
    assert t[5].tolist() == [1.0 + 2.0 ** -29 + 2.0] * 3
    # row 2 (slot 6): maximum 2 − 10 < 0 is lost; row 3 (slot 7) has none
    assert cho[6].tolist() == cho[7].tolist() == [-1] * 3
    assert t[6].tolist() == [0.25] * 3 and t[7].tolist() == [0.5] * 3
    assert ssum[6].tolist() == ssum[7].tolist() == [0.0] * 3
    # level 2, row 0 (slot 8): at scenario 0, 3.0f ties, the key 3 + 1
    # from slot 5 beats 1 + 1 from slot 4, and t takes the remainder 2^-29;
    # slot 4's 3.5 and 4.0 win outright at scenarios 1 and 2
    assert cho[8].tolist() == [2 * E + 1, 2 * E, 2 * E]
    assert t[8].tolist() == [3.0 + 2.0 ** -29, 3.5, 4.0]
    assert ssum[8].tolist() == [4.0, 2.0, 2.0]
    # row 1 (slot 9) reads the lost row: 0.25 + 1 >= 0
    assert cho[9].tolist() == [2 * E + 2] * 3
    assert ssum[9].tolist() == [2.0] * 3


# -- the JAX package's argmax kernel, level by level --------------------------

@pytest.fixture(scope="module")
def jax_argmax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.maxplus import ops as ref_ops
    return jnp, ref_ops.maxplus_matvec_argmax


@pytest.mark.parametrize("name", ("stencil", "allreduce", "stencil3c"))
def test_level_winners_equal_the_jax_argmax_kernel(jax_argmax, name):
    """Every level's candidates and tie keys, rebuilt from the final state
    (a level reads only rows that earlier levels wrote for good), go to
    the JAX package's argmax kernel: the level loop recorded its winners
    and keys, and its float64 maximum rounds to the kernel's."""
    jnp, argmax = jax_argmax
    d, w = solo(name)
    t, ssum, cho, _ = run(dense_levels_f32, d, w, True)
    nlv, Vmax = d.vcost_lv.shape
    Emax = d.esrc.shape[1]
    for lv in range(nlv):
        src = d.esrc[lv]
        cand = t[src] + w[lv]
        cs = ssum[src] + d.elat_sum[lv][:, None]
        raw, idx = (np.asarray(x) for x in argmax(
            jnp.asarray(d.A[lv].numpy()), jnp.asarray(cand.float().numpy()),
            jnp.asarray(cs.numpy())))
        has = raw >= 0.0
        rows = slice(lv * Vmax, (lv + 1) * Vmax)
        np.testing.assert_array_equal(cho[rows].numpy(),
                                      np.where(has, idx + lv * Emax, -1))
        key = np.take_along_axis(cs.numpy(), np.where(has, idx, 0), 0)
        np.testing.assert_array_equal(ssum[rows].numpy(),
                                      np.where(has, key, 0.0))
        top = (t[rows] - d.vcost_lv[lv][:, None]).numpy()
        np.testing.assert_allclose(top, np.maximum(raw, 0.0), rtol=1e-6,
                                   atol=1e-9)


# -- (c) the walk against the level-ordered backtrace ------------------------

def level_ordered_backtrace(cho, vsel, esrc, elat, Vmax):
    """λ [S, nc] by the reverse per-level backtrace the forwards ran before
    the walk (reference ``engine.py:625-642``), over each level's chosen
    slots ``cho − lv·Emax``."""
    nlv, Emax = esrc.shape[0], esrc.shape[1]
    K = cho.shape[1]
    sidx = torch.arange(K)
    cur = vsel.clone()
    lam = torch.zeros((K, elat.shape[2]), dtype=torch.float64)
    for lv in range(nlv - 1, -1, -1):
        ch = cho[lv * Vmax:(lv + 1) * Vmax]
        chosen = torch.where(ch >= 0, ch - lv * Emax, -1)
        onlvl = (cur >= lv * Vmax) & (cur < (lv + 1) * Vmax)
        off = torch.where(onlvl, cur - lv * Vmax, 0)
        e = chosen[off, sidx]
        take = onlvl & (e >= 0)
        e_s = torch.where(take, e, 0).long()
        lam += torch.where(take[:, None], elat[lv, e_s], 0.0)
        cur = torch.where(take, esrc[lv, e_s], cur)
    return lam


def _walk_both(t, ssum, cho, d, g=None):
    pick = (lambda x: x) if g is None else (lambda x: x[g])
    valid = pick(d.valid_flat).nonzero()[:, 0]
    _, vsel = eng._dense_sink(t, ssum, valid, pick(d.valid_flat),
                              pick(d.vert_of_slot))
    esrc, elat = pick(d.esrc), pick(d.elat)
    nlv = esrc.shape[0]
    walk = sparse_backtrace_ref(vsel, cho, esrc.reshape(-1),
                                elat.reshape(-1, elat.shape[2]), nlv)
    old = level_ordered_backtrace(cho, vsel, esrc, elat,
                                  pick(d.vcost_lv).shape[1])
    return walk, old


@pytest.mark.parametrize("name", NAMES + ("built",))
def test_walk_over_flat_cho_equals_the_level_ordered_backtrace(name):
    d, w = solo(name)
    t, ssum, cho, _ = run(dense_levels_f32_ref, d, w, True)
    walk, old = _walk_both(t, ssum, cho, d)
    assert torch.equal(walk, old)
    assert (walk.sum(1) > 0).all()


@pytest.mark.parametrize("case", PACKED)
def test_walk_equals_the_level_ordered_backtrace_packed(case):
    d, w = packed(case)
    t, ssum, cho, _ = run(dense_levels_f32_ref, d, w, True)
    for g in range(t.shape[0]):
        walk, old = _walk_both(t[g], ssum[g], cho[g], d, g)
        assert torch.equal(walk, old)


# -- (d), (e) the wrapper ----------------------------------------------------

def _wrapper_kwargs(case="solo"):
    d, w = solo("stencil") if case == "solo" else packed("allreduce")
    t, ssum, cho, csrc = eng._state(tuple(d.valid_flat.shape), S, True, CPU)
    return dict(t=t, ssum=ssum, cho=cho, w=w, A=d.A, esrc=d.esrc,
                lv_ptr=d.lv_ptr, rows=d.rows, row_ptr=d.row_ptr,
                in_edges=d.in_edges, elat_sum=d.elat_sum, vcost=d.vcost_lv,
                csrc=csrc)


BAD = [
    ("t-dtype", TypeError, lambda k: dict(t=k["t"].float())),
    ("t-rank", ValueError, lambda k: dict(t=k["t"][:, 0])),
    ("t-rows", ValueError, lambda k: dict(t=k["t"][1:].contiguous())),
    ("w-width", ValueError, lambda k: dict(w=k["w"][..., :3].contiguous())),
    ("w-levels", ValueError, lambda k: dict(
        w=torch.zeros((k["vcost"].shape[0] + 1,) + k["w"].shape[1:],
                      dtype=torch.float64))),
    ("w-none", ValueError, lambda k: dict(w=k["w"][:0])),
    ("A-dtype", TypeError, lambda k: dict(A=k["A"].double())),
    ("esrc-dtype", TypeError, lambda k: dict(esrc=k["esrc"].int())),
    ("lv_ptr-len", ValueError, lambda k: dict(lv_ptr=k["lv_ptr"][1:])),
    ("row_ptr-len", ValueError, lambda k: dict(row_ptr=k["row_ptr"][1:])),
    ("rows-dtype", TypeError, lambda k: dict(rows=k["rows"].long())),
    ("in_edges-shape", ValueError, lambda k: dict(
        in_edges=k["in_edges"][:, :1].contiguous())),
    ("elat_sum-dtype", TypeError, lambda k: dict(
        elat_sum=k["elat_sum"].double())),
    ("vcost-rank", ValueError, lambda k: dict(vcost=k["vcost"][0])),
    ("ssum-only", ValueError, lambda k: dict(cho=None)),
    ("csrc-missing", ValueError, lambda k: dict(csrc=None)),
    ("cho-contiguous", ValueError,
     lambda k: dict(cho=k["cho"].T.contiguous().T)),
    ("numpy", TypeError, lambda k: dict(w=k["w"].numpy())),
    ("packed-A", ValueError, lambda k: dict(
        A=k["A"][:, None].expand(-1, 2, -1, -1).contiguous())),
]


@pytest.mark.parametrize("change", [pytest.param((e, f), id=n)
                                    for n, e, f in BAD])
def test_wrapper_rejects_bad_inputs(change):
    exc, fn = change
    kw = _wrapper_kwargs()
    dense_levels_f32(**kw)
    kw.update(fn(kw))
    with pytest.raises(exc):
        dense_levels_f32(**kw)


@pytest.mark.parametrize("case", ["solo", "packed"])
def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch(case):
    kw = _wrapper_kwargs(case)
    n = dense_levels_f32.launches
    dense_levels_f32(**kw)
    want = eng._state(tuple(kw["t"].shape[:-1]), S, True, CPU)
    dense_levels_f32_ref(*want[:3], kw["w"], kw["A"], kw["esrc"],
                         kw["elat_sum"], kw["vcost"], want[3])
    _equal((kw["t"], kw["ssum"], kw["cho"], kw["csrc"]), want)
    assert dense_levels_f32.launches == n


def test_cpu_forwards_count_runs_and_no_launch():
    """Solo and packed forwards on the CPU: one more run of each kind, no
    launch of any (max,+) kernel or the walk."""
    g, p = build("stencil")
    batch = latency_grid(p, np.linspace(0.0, 60.0, S))
    kernels = (dense_levels_f32, sparse_backtrace, maxplus_matvec,
               maxplus_matvec_argmax, maxplus_matvec_batched,
               maxplus_matvec_argmax_batched)
    n = [k.launches for k in kernels]
    solo_runs = dict(eng.dense_forward.runs)
    multi_runs = dict(eng.dense_forward_multi.runs)
    eng_solo = Engine(g, params=p, policy=DENSE, device="cpu")
    eng_multi = Engine([(g, p), build("cg")], policy=DENSE, device="cpu")
    for lam in (True, False):
        eng_solo.run(batch, compute_lam=lam)
        eng_multi.run(batch, compute_lam=lam)
    assert [k.launches for k in kernels] == n
    for kind in ("lam", "values"):
        assert eng.dense_forward.runs[kind] == solo_runs.get(kind, 0) + 1
        assert eng.dense_forward_multi.runs[kind] == \
            multi_runs.get(kind, 0) + 1


def test_staged_lists_are_the_plans_real_edges_and_costs():
    """Every level lists, in order, exactly its rows with a real in-edge or
    a nonzero vertex cost, and each listed row's in-edges are the
    indicator's zeros of that row, in increasing slot, with the plan's
    sources."""
    for name in NAMES + ("built",):
        d, _ = solo(name)
        nlv, Vmax, Emax = d.A.shape
        lv_ptr, rows = d.lv_ptr.numpy(), d.rows.numpy()
        row_ptr, ie = d.row_ptr.numpy(), d.in_edges.numpy()
        assert lv_ptr[0] == 0 and (np.diff(lv_ptr) >= 0).all()
        for lv in range(nlv):
            real = (d.A[lv] == 0).numpy()
            keep = real.any(1) | (d.vcost_lv[lv] != 0).numpy()
            want = [lv * Vmax + i for i in np.nonzero(keep)[0]]
            got = rows[lv_ptr[lv]:lv_ptr[lv + 1]].tolist()
            assert got == want
            for q in range(lv_ptr[lv], lv_ptr[lv + 1]):
                j = np.nonzero(real[rows[q] - lv * Vmax])[0]
                e = ie[row_ptr[q]:row_ptr[q + 1]]
                assert e[:, 0].tolist() == (lv * Emax + j).tolist()
                assert e[:, 1].tolist() == d.esrc[lv, j].tolist()


# -- (f) the card ------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_level_loop_matches_plain_version_on_card():
    """The level-loop kernel against its plain version on the card, bit for
    bit on t, ssum and cho: solo and packed cases, values and λ, S = 5 and
    256 (the weights recomputed at 256 points); one launch a call; and the
    forwards' T and λ on the card equal to the CPU's, with one level-loop
    launch a forward, one walk a graph of a λ forward and no (max,+)
    mat-vec launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cuda = torch.device("cuda")

    def to(d, dev):
        return type(d)(**{k: (v.to(dev) if isinstance(v, torch.Tensor)
                              else [x.to(dev) for x in v]
                              if isinstance(v, list) else v)
                          for k, v in vars(d).items()})

    cases = [solo(n) for n in NAMES + ("built",)] + \
        [packed(c) for c in PACKED]
    for d, w in cases:
        for K in (w.shape[-1], 256):
            wk = w if K == w.shape[-1] else torch.cat(
                [w] * (-(-K // w.shape[-1])), -1)[..., :K].contiguous()
            for want_lam in (False, True):
                n = dense_levels_f32.launches
                got = run(dense_levels_f32, to(d, cuda), wk.to(cuda),
                          want_lam)
                torch.cuda.synchronize()
                assert dense_levels_f32.launches == n + 1
                want = run(dense_levels_f32_ref, d, wk, want_lam)
                for x, y in zip(got, want):
                    assert (x is None and y is None) or \
                        torch.equal(x.cpu(), y)
    kernels = (maxplus_matvec, maxplus_matvec_argmax,
               maxplus_matvec_batched, maxplus_matvec_argmax_batched)
    n_mv = [k.launches for k in kernels]
    for name in NAMES:
        g, p = build(name)
        batch = latency_grid(p, np.linspace(0.0, 60.0, S))
        for graphs in ((g,), (g, g)):
            make = (lambda dev: Engine(g, params=p, policy=DENSE,
                                       device=dev)) \
                if len(graphs) == 1 else \
                (lambda dev: Engine([(x, p) for x in graphs], policy=DENSE,
                                    device=dev))
            card, host = make(None), make("cpu")
            n0, n1 = dense_levels_f32.launches, sparse_backtrace.launches
            rc, vc = card.run(batch), card.run(batch, compute_lam=False)
            assert dense_levels_f32.launches == n0 + 2
            assert sparse_backtrace.launches == n1 + 1     # G graphs, one
            rh = host.run(batch)
            np.testing.assert_array_equal(rc.T, rh.T)
            np.testing.assert_array_equal(rc.lam, rh.lam)
            np.testing.assert_array_equal(vc.T, rh.T)
    assert [k.launches for k in kernels] == n_mv
