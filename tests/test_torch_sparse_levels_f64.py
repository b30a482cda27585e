"""The sparse float64 forward's level-loop kernel, ``sparse_levels_f64``.

On the CPU:

* its plain version, ``sparse_levels_f64_ref``, driven weight chunk by
  weight chunk, leaves t, ssum and cho of every real vertex bit-equal to
  the per-level loop the forward ran before the kernel (kept here as the
  oracle: each level's fixed [Emax_lv] window of edges, later levels'
  edges included, reduced by ``scatter_reduce`` into [Vmax_lv + 1] rows);
* the float64 forward's T, λ and ρ are bit-identical to the reference's
  ``repro.core.dag.LevelPlan.forward`` on tie-heavy graphs (integer costs,
  offsets of 1e-13 inside the ATOL = 1e-12 tie rules, rows of up to 7
  in-edges), rows with no in-edge, weight chunks of a few levels, and S =
  1, 5 and 37;
* the float64 staging's level and row pointers give each level its rows
  and each row its own in-edges, as the float32 staging's do;
* the wrapper runs the plain version on CPU tensors without counting a
  launch, and refuses bad inputs.

On the card (``-m gpu``): the kernel against its plain version, bit for
bit, on every case at S = 1, 5, 37 and 256, one launch a weight chunk.
"""

import numpy as np
import pytest
import torch

from repro.core import dag as ref_dag, graph as ref_graph
from repro.core import loggps as ref_loggps, synth as ref_synth

from repro_torch.core import graph, loggps, synth
from repro_torch.kernels.maxplus import sparse_levels_f64, sparse_levels_f64_ref
from repro_torch.sweep import (Engine, ExecPolicy, compile_sparse,
                               latency_grid)
from repro_torch.sweep import engine as eng

F64 = ExecPolicy(backend="sparse", dtype="float64")
CASES = ("ties", "ties2c", "isolated", "stencil", "cg", "random3")
WIDTHS = (1, 5, 37)


def _ties(G, L, nclass_model):
    """A tie-heavy graph: 8 ranks x 4 rounds of integer-cost compute and
    1-byte ring and skip messages, each round closed on every rank by a
    join of its own and up to six other ranks' tails (rows of up to 7
    in-edges) through edges of integer cost, some carrying a class-0
    latency, some 1e-13 off (ties within the ATOL rules); two isolated
    vertices (rows with no in-edge)."""
    p = (L.cluster_params(L_us=3.0, o_us=5.0) if nclass_model == 1
         else L.pod_model(pod_size=4).params())
    R = 8
    rng = np.random.default_rng(11)
    b = G.GraphBuilder(R, p.nclass)
    for _ in range(4):
        for r in range(R):
            b.add_calc(r, 10.0 * float(rng.integers(1, 4)))
        for r in range(R):
            b.add_message(r, (r + 1) % R, 1.0, p)
            b.add_message(r, (r + 3) % R, 1.0, p)
        tails = [b.tail(r) for r in range(R)]
        for r in range(R):
            v = b.add_sync_vertex(r)
            k = int(rng.integers(1, 7))
            others = rng.choice([q for q in range(R) if q != r], k,
                                replace=False)
            for q in [r, *others]:
                off = 1e-13 if rng.random() < 0.25 else 0.0
                b.add_edge(tails[q], v,
                           const_us=float(rng.integers(0, 3)) + off,
                           lat=((0, int(rng.integers(0, 2))),))
            b.set_tail(r, v)
    b.add_sync_vertex(0)
    b.add_sync_vertex(R - 1)
    return b.finalize(), p


def build(name, S, L, G):
    p1 = L.cluster_params(L_us=3.0, o_us=5.0)
    if name.startswith("random"):
        rng = np.random.default_rng(int(name.removeprefix("random")))
        return S.random_dag(rng, nranks=8, nops=200, params=p1), p1
    return {
        "ties": lambda: _ties(G, L, 1),
        "ties2c": lambda: _ties(G, L, 2),
        "isolated": lambda: _isolated(G, L),
        "stencil": lambda: (S.stencil2d(3, 3, 4, params=p1), p1),
        "cg": lambda: (S.cg_like(2, 2, 3, params=p1), p1),
    }[name]()


def _isolated(G, L):
    """Many rows with no in-edge beside a deep chain: sources of ranks 1-3
    at level 0 (rank 3's only vertex, isolated sync vertices)."""
    p = L.cluster_params(L_us=3.0, o_us=5.0)
    b = G.GraphBuilder(4, p.nclass)
    for it in range(5):
        b.add_calc(0, 5.0 + it)
        b.add_message(0, 1, 64.0, p)
        b.add_sync_vertex(2)
    b.add_calc(3, 1.0)
    return b.finalize(), p


def port_case(name):
    return build(name, synth, loggps, graph)


def ref_case(name):
    return build(name, ref_synth, ref_loggps, ref_graph)


def _grid(p, S):
    batch = latency_grid(p, np.linspace(0.0, 12.0, S))
    return batch, torch.from_numpy(batch.L), torch.from_numpy(batch.gscale)


def _state(nv_p, S, want_lam, device="cpu"):
    return eng._state((nv_p,), S, want_lam, torch.device(device),
                      torch.float64)


def _window_oracle(a, L, GS, want_lam):
    """The float64 level loop as the forward ran it before the kernel: each
    level's [Emax_lv] window of edges (the staged ``dloc``, foreign slots
    at the trash row Vmax_lv), a segment max into [Vmax_lv + 1] rows, the
    ATOL tie rules, and writes of the whole [Vmax_lv] row window."""
    E, V = a.Emax_lv, a.Vmax_lv
    S = L.shape[0]
    f64, ninf = torch.float64, float("-inf")
    w_all = eng._weights(a.egclass, a.egap, a.econst, a.elat, L, GS)
    eidx = torch.arange(a.esrc.shape[0], dtype=torch.int64)
    t, ssum, cho, _ = _state(a.vcost.shape[0], S, want_lam)
    for lv in range(a.nlevels):
        e0, v0 = int(a.level_ptr[lv]), int(a.v_ptr[lv])
        w = w_all[e0:e0 + E]
        es = a.esrc[e0:e0 + E]
        d1 = a.dloc[lv, :E]
        d = d1[:, None].expand(E, S)
        cand = t.index_select(0, es).add_(w)
        seg = torch.full((V + 1, S), ninf, dtype=f64)
        ts = seg.scatter_reduce_(0, d, cand, "amax").clamp_min_(0.0)
        rows = slice(v0, v0 + V)
        if want_lam:
            hit = cand >= ts.index_select(0, d1).sub_(eng.ATOL)
            cs = ssum.index_select(0, es).add_(a.elat_sum[e0:e0 + E, None])
            best = torch.full((V + 1, S), ninf, dtype=f64)
            best.scatter_reduce_(0, d, torch.where(hit, cs, -eng.BIG),
                                 "amax")
            sel = hit.logical_and_(
                cs >= best.index_select(0, d1).sub_(eng.ATOL))
            chosen = torch.full((V + 1, S), -1, dtype=torch.int64)
            chosen.scatter_reduce_(
                0, d, torch.where(sel, eidx[e0:e0 + E, None], -1), "amax")
            ch = chosen[:V]
            lost = ch < 0
            torch.gather(cs, 0, (ch - e0).clamp_min_(0), out=ssum[rows])
            ssum[rows].masked_fill_(lost, 0.0)
            cho[rows] = ch
        torch.add(ts[:V], a.vcost[rows, None], out=t[rows])
    return t, ssum, cho


def _level_loop(a, L, GS, want_lam, levels=sparse_levels_f64_ref):
    """The forward's state after ``levels`` over each weight chunk:
    (t, ssum, cho, chunks)."""
    t, ssum, cho, csrc = _state(a.vcost.shape[0], L.shape[0], want_lam,
                                L.device)
    chunks = 0
    for lv0, lv1, base, w in eng._chunk_weights(a, L, GS, a.nlevels):
        levels(t, ssum, cho, w.contiguous(), base, a.esrc, a.row_ptr,
               a.v_ptr_dev, a.elat_sum, a.vcost, lv0, lv1, csrc)
        chunks += 1
    return t, ssum, cho, chunks


@pytest.mark.parametrize("want_lam", [False, True], ids=["values", "lam"])
@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", CASES)
def test_plain_version_equals_the_window_loop(name, chunked, want_lam,
                                              monkeypatch):
    g, p = port_case(name)
    sp = compile_sparse(g, p)
    _, L, GS = _grid(p, 5)
    if chunked:                         # a chunk a level
        monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", 1)
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float64)
    t, ssum, cho, chunks = _level_loop(a, L, GS, want_lam)
    assert chunks == len(eng.weight_chunks(sp.level_ptr, sp.Emax_lv, 5,
                                           sp.nlevels))
    assert (chunks > 1) == chunked
    wt, ws, wc = _window_oracle(a, L, GS, want_lam)
    nv = sp.nv
    assert torch.equal(t[:nv], wt[:nv])
    if want_lam:
        assert torch.equal(ssum[:nv], ws[:nv])
        assert torch.equal(cho[:nv], wc[:nv])
        assert (cho[:nv] >= 0).any()
    # the plain version writes only the levels' own rows: the pad rows
    # keep the fresh state
    assert not t[nv:].any()


def _scalar(g_ref, p_ref, batch):
    plan = ref_dag.LevelPlan(g_ref)
    out = [plan.forward(p_ref.replace(L=tuple(batch.L[i])))
           for i in range(batch.S)]
    return (np.array([s.T for s in out]), np.stack([s.lam for s in out]),
            np.stack([s.rho() for s in out]))


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("name", CASES)
def test_forward_bit_identical_to_reference_dag(name, chunked, monkeypatch):
    """Through the entry point (``Engine``, sparse float64, on the CPU) and
    the forward itself at S = 1, 5 and 37 (the engine pads S to a
    bucket)."""
    g_ref, p_ref = ref_case(name)
    g, p = port_case(name)
    if chunked:
        monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", 5 * 8 * 8)
    e = Engine(g, params=p, policy=F64, device="cpu")
    for S in WIDTHS:
        batch, L, GS = _grid(p, S)
        T, lam, rho = _scalar(g_ref, p_ref, batch)
        res = e.run(batch)
        np.testing.assert_array_equal(res.T, T)
        np.testing.assert_array_equal(res.lam, lam)
        np.testing.assert_array_equal(res.rho, rho)
        T2, lam2 = eng.sparse_forward_f64(e.arrays, L, GS, True)
        np.testing.assert_array_equal(T2.numpy(), T)
        np.testing.assert_array_equal(lam2.numpy(), lam)
        T3, _ = eng.sparse_forward_f64(e.arrays, L, GS, False)
        np.testing.assert_array_equal(T3.numpy(), T)


@pytest.mark.parametrize("name", ["ties", "isolated", "stencil"])
def test_stage_sparse_f64_row_pointers(name):
    """The kernel's pointers, staged for the float64 flavour as for the
    float32 one: row_ptr gives each row exactly its own in-edges (rows
    with none an empty run, pad rows none), v_ptr_dev each level's rows."""
    sp = compile_sparse(*port_case(name))
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float64)
    a32 = eng.stage_sparse(sp, torch.device("cpu"), torch.float32)
    assert a.row_ptr.dtype == a.v_ptr_dev.dtype == torch.int32
    assert a.elat_sum.dtype == torch.float64
    rp = a.row_ptr.numpy()
    assert rp[0] == 0 and rp[sp.nv] == sp.ne and (rp[sp.nv:] == sp.ne).all()
    for v in range(sp.nv):
        assert (sp.edst_slot[rp[v]:rp[v + 1]] == v).all()
    assert (np.diff(rp[:sp.nv + 1]) == 0).any()          # rows with none
    np.testing.assert_array_equal(a.v_ptr_dev.numpy(), sp.v_ptr)
    assert torch.equal(a.row_ptr, a32.row_ptr)
    assert torch.equal(a.v_ptr_dev, a32.v_ptr_dev)


def test_wrapper_runs_the_plain_version_on_cpu():
    g, p = port_case("ties")
    a = eng.stage_sparse(compile_sparse(g, p), torch.device("cpu"),
                         torch.float64)
    _, L, GS = _grid(p, 4)
    n0 = sparse_levels_f64.launches
    for want_lam in (False, True):
        got = _level_loop(a, L, GS, want_lam, levels=sparse_levels_f64)
        want = _level_loop(a, L, GS, want_lam)
        for x, y in zip(got[:3], want[:3]):
            assert (x is None and y is None) or torch.equal(x, y)
    assert sparse_levels_f64.launches == n0


def _wrapper_args():
    sp = compile_sparse(*port_case("stencil"))
    a = eng.stage_sparse(sp, torch.device("cpu"), torch.float64)
    t, ssum, cho, csrc = _state(sp.vcost.shape[0], 4, True)
    w = torch.zeros((sp.esrc_slot.shape[0], 4), dtype=torch.float64)
    return dict(t=t, ssum=ssum, cho=cho, w=w, w_base=0, esrc=a.esrc,
                row_ptr=a.row_ptr, v_ptr=a.v_ptr_dev, elat_sum=a.elat_sum,
                vcost=a.vcost, lv0=0, lv1=sp.nlevels, csrc=csrc)


BAD = [
    ("ssum-f32", TypeError, lambda k: dict(ssum=k["ssum"].float())),
    ("elat_sum-f32", TypeError, lambda k: dict(elat_sum=k["elat_sum"].float())),
    ("t-rank", ValueError, lambda k: dict(t=k["t"][:, 0])),
    ("w-width", ValueError, lambda k: dict(w=k["w"][:, :3].contiguous())),
    ("cho-only", ValueError, lambda k: dict(ssum=None)),
    ("csrc-missing", ValueError, lambda k: dict(csrc=None)),
    ("row_ptr-len", ValueError, lambda k: dict(row_ptr=k["row_ptr"][1:])),
    ("levels", ValueError, lambda k: dict(lv0=3, lv1=3)),
    ("w_base", ValueError, lambda k: dict(w_base=-1)),
]


@pytest.mark.parametrize("change", [pytest.param((e, f), id=n)
                                    for n, e, f in BAD])
def test_wrapper_rejects_bad_inputs(change):
    exc, fn = change
    kw = _wrapper_args()
    sparse_levels_f64(**kw)
    kw.update(fn(kw))
    with pytest.raises(exc):
        sparse_levels_f64(**kw)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_card(monkeypatch):
    """The kernel against its plain version on the card, bit for bit on t,
    ssum and cho (every element), on every case at S = 1, 5, 37 and 256,
    with weight chunks of a few levels: one launch a chunk; then the
    forward's T and λ on the card equal to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(eng, "WEIGHT_CHUNK_ELEMS", 1 << 12)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for name in CASES:
        g, p = port_case(name)
        sp = compile_sparse(g, p)
        a_card = eng.stage_sparse(sp, cuda, torch.float64)
        for S in WIDTHS + (256,):
            _, L, GS = _grid(p, S)
            chunks = len(eng.weight_chunks(sp.level_ptr, sp.Emax_lv, S,
                                           sp.nlevels))
            for want_lam in (False, True):
                n0 = sparse_levels_f64.launches
                got = _level_loop(a_card, L.cuda(), GS.cuda(), want_lam,
                                  levels=sparse_levels_f64)
                torch.cuda.synchronize()
                assert sparse_levels_f64.launches == n0 + chunks
                want = _level_loop(a_card, L.cuda(), GS.cuda(), want_lam)
                for x, y in zip(got[:3], want[:3]):
                    assert (x is None and y is None) or \
                        torch.equal(x, y), (name, S, want_lam)
        batch, _, _ = _grid(p, 5)
        card = Engine(g, params=p, policy=F64).run(batch)
        host = Engine(g, params=p, policy=F64, device=cpu).run(batch)
        np.testing.assert_array_equal(card.T, host.T)
        np.testing.assert_array_equal(card.lam, host.lam)
