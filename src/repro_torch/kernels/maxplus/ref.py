"""Plain PyTorch versions of the (max,+) kernels: the two dense mat-vecs,
their graph-batched twins, the slot-list segment reduction, the dense
float32 forward's level loop (solo and packed), the sparse forward's
level loops (float32 and float64) and backtrace, and the segment forward's
float64 level loop (solo and packed).

All follow the TPU kernels' accumulator rule (``repro/kernels/maxplus/
kernel.py``: ``acc`` starts at −1e30, the argmax state at (−1e30, −1e30,
−1)), so a row whose every candidate lies below −1e30 returns −1e30 and
index −1, and a row whose best candidate rounds to exactly −1e30 still
names it.  The CUDA kernels compute the same, bit for bit: each candidate
is one float32 add, and max and the lexicographic compares are exact.

Tie keys ``c`` are assumed ≥ −1e30 (the engine's are cumulative slope
sums ≥ 0), the domain on which the TPU kernel's blocked reduction and the
sequential lexicographic rule agree.

The level loops record, beside each row's chosen in-edge ``cho``, that
edge's source row ``csrc`` (−1 where ``cho`` is −1, so ``csrc ==
esrc[cho]`` wherever ``cho ≥ 0``), in λ mode, where ssum, cho and csrc
are all given: the walk (:func:`sparse_walk_ref`) then needs one load a
step.

The dense versions process rows in chunks so the [rows, N, K] candidate
tensor stays under :data:`CHUNK_ELEMS` elements, the G graphs' rows of the
batched versions together (a single graph is the batched version at G =
1); the slot-list version is a
segment reduction (``scatter_reduce``) at O(E·K); the sparse level loop
runs it once a level on the level's own edges; the dense level loop runs
the batched mat-vecs once or twice a level on the level's indicator.  The
float64 level loops (sparse and segment) follow ``core.dag`` instead (−inf
seeds, the ATOL tie rules), not the TPU kernels' rule; the segment one
forms its edge weights itself (:func:`_weights`).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30
BIG = -NEG_INF
ATOL = 1e-12          # the scalar engine's tie tolerance (core.dag)
CHUNK_ELEMS = 1 << 24


def _row_chunks(M: int, N: int, K: int):
    step = max(1, CHUNK_ELEMS // max(N * K, 1))
    for r0 in range(0, M, step):
        yield r0, min(M, r0 + step)


def _graph_rows(A: torch.Tensor, *ts):
    """The G·M rows of A [G, M, N] as one [G·M, N] matrix, in the chunks of
    :func:`_row_chunks`, each row with its graph's t (and c): yields (r0,
    r1, A rows, t rows [r1 − r0, N, K], ...); one graph's t is broadcast,
    not copied."""
    G, M, N = A.shape
    K = ts[0].shape[2]
    A2 = A.reshape(G * M, N)
    gof = torch.arange(G * M, device=A.device) // M
    for r0, r1 in _row_chunks(G * M, N, K):
        yield (r0, r1, A2[r0:r1]) + tuple(
            x.index_select(0, gof[r0:r1]) if G > 1
            else x.expand((r1 - r0,) + x.shape[1:]) for x in ts)


def maxplus_matvec_batched_ref(A: torch.Tensor,
                               t: torch.Tensor) -> torch.Tensor:
    """A [G, M, N], t [G, N, K] → [G, M, K]: :func:`maxplus_matvec_ref`
    of each graph, the G graphs' rows taken together (the same
    elementwise adds and exact maxima, so the same values)."""
    G, M, _ = A.shape
    out = torch.empty((G * M, t.shape[2]), dtype=t.dtype, device=t.device)
    for r0, r1, a, tr in _graph_rows(A, t):
        out[r0:r1] = (a[:, :, None] + tr).amax(1).clamp_min(NEG_INF)
    return out.view(G, M, -1)


def maxplus_matvec_argmax_batched_ref(A: torch.Tensor, t: torch.Tensor,
                                      c: torch.Tensor):
    """A [G, M, N], t/c [G, N, K] → (out [G, M, K], idx [G, M, K] int32):
    :func:`maxplus_matvec_argmax_ref` of each graph, the G graphs' rows
    taken together (the same adds and exact compares)."""
    G, M, N = A.shape
    K = t.shape[2]
    out = torch.empty((G * M, K), dtype=t.dtype, device=t.device)
    idx = torch.empty((G * M, K), dtype=torch.int32, device=t.device)
    jidx = torch.arange(N, dtype=torch.int32, device=t.device)[None, :, None]
    for r0, r1, a, tr, cr in _graph_rows(A, t, c):
        cand = a[:, :, None] + tr
        bv = cand.amax(1).clamp_min(NEG_INF)
        tie = cand >= bv[:, None]
        bk = torch.where(tie, cr, NEG_INF).amax(1)
        tie &= cr >= bk[:, None]
        out[r0:r1] = bv
        idx[r0:r1] = torch.where(tie, jidx, -1).amax(1)
    return out.view(G, M, K), idx.view(G, M, K)


def maxplus_matvec_ref(A: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """out[i, k] = max(−1e30, max_j A[i, j] + t[j, k])."""
    return maxplus_matvec_batched_ref(A[None], t[None])[0]


def maxplus_matvec_argmax_ref(A: torch.Tensor, t: torch.Tensor,
                              c: torch.Tensor):
    """(out, idx): out as :func:`maxplus_matvec_ref`; ``idx[i, k]`` is the
    lexicographic argmax over j of ``(A[i,j] + t[j,k], c[j,k], j)`` with
    exact compares, seeded with (−1e30, −1e30, −1)."""
    out, idx = maxplus_matvec_argmax_batched_ref(A[None], t[None], c[None])
    return out[0], idx[0]


def maxplus_slotlist_argmax_ref(dst: torch.Tensor, cand: torch.Tensor,
                                c: torch.Tensor, M: int):
    """(out [M, K], idx [M, K] int32) of the slot-list reduction: for each
    row m, ``out[m, k] = max(−1e30, max over {e : dst[e] = m} of
    cand[e, k])`` and ``idx[m, k]`` the lexicographic argmax over those e of
    ``(cand[e, k], c[e, k], e)`` with exact compares, seeded with (−1e30,
    −1e30, −1).  ``dst`` [E, 1] or [E] int32; slots whose row is outside
    [0, M) never hit.

    Torch's ``scatter_reduce`` raises on an out-of-range index where the
    TPU kernel drops it, so such slots go to a trash row M, dropped at the
    end; the buffers are seeded with the kernel's −1e30 / −1."""
    d = dst.reshape(-1).long()
    E, K = cand.shape
    d = torch.where((d >= 0) & (d < M), d, M)
    dk = d[:, None].expand(E, K)
    out = torch.full((M + 1, K), NEG_INF, dtype=cand.dtype,
                     device=cand.device)
    out.scatter_reduce_(0, dk, cand, "amax")
    tie = cand >= out[d]              # cand == the row's max (≥ −1e30)
    bk = torch.full_like(out, NEG_INF)
    bk.scatter_reduce_(0, dk, torch.where(tie, c, NEG_INF), "amax")
    tie &= c >= bk[d]
    eidx = torch.arange(E, dtype=torch.int32, device=cand.device)[:, None]
    idx = torch.full((M + 1, K), -1, dtype=torch.int32, device=cand.device)
    idx.scatter_reduce_(0, dk, torch.where(tie, eidx, -1), "amax")
    return out[:M], idx[:M]


def sparse_levels_f32_ref(t, ssum, cho, w, w_base: int, esrc, row_ptr, v_ptr,
                          elat_sum, vcost, lv0: int, lv1: int,
                          csrc=None) -> None:
    """Levels ``lv0..lv1-1`` of the sparse float32 forward, in place, one
    level at a time: the per-level body of the reference's
    ``_sparse_pallas_core`` (``repro/sweep/engine.py:903-971``) on the
    level's own edges and rows.

    t [nv_p, S] f64, ssum [nv_p, S] f32, cho and csrc [nv_p, S] int32 (all
    None in values mode); w [*, S] f64 the weights of edges ``w_base`` on; esrc
    [ne_p] int64; row_ptr [nv_p + 1] int32, row r's in-edges being
    ``row_ptr[r]..row_ptr[r+1]-1``; v_ptr [nlv_p + 1] int32, level lv's rows
    being ``v_ptr[lv]..v_ptr[lv+1]-1``; elat_sum [ne_p] f32; vcost [nv_p]
    f64.  Per level: the float64 candidates ``t[src] + w``, cast to float32,
    with the tie keys ``ssum[src] + elat_sum`` (0 in values mode) go to
    :func:`maxplus_slotlist_argmax_ref` with each edge's row in the level;
    a row whose maximum is below 0 (or, in λ mode, has no winner) is lost;
    ``t[row] = (lost ? 0 : the winner's float64 candidate) + vcost``,
    ``ssum[row] = (lost ? 0 : the winner's key)``, ``cho[row] = (lost ? −1 :
    the winner's edge)`` and ``csrc[row] = (lost ? −1 : the winner's source
    row)``."""
    S = t.shape[1]
    lam = ssum is not None
    vp = v_ptr.tolist()
    for lv in range(lv0, lv1):
        r0, r1 = vp[lv], vp[lv + 1]
        n = r1 - r0
        if n == 0:
            continue
        rp = row_ptr[r0:r1 + 1].long()
        e0, e1 = int(rp[0]), int(rp[-1])
        if e1 == e0:                       # no in-edges: every row is lost
            t[r0:r1] = (0.0 + vcost[r0:r1])[:, None]
            if lam:
                ssum[r0:r1] = 0.0
                cho[r0:r1] = -1
                csrc[r0:r1] = -1
            continue
        es = esrc[e0:e1]
        cand = t.index_select(0, es).add_(w[e0 - w_base:e1 - w_base])
        key = (ssum.index_select(0, es).add_(elat_sum[e0:e1, None])
               if lam else torch.zeros((e1 - e0, S), dtype=torch.float32,
                                       device=t.device))
        dst = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=t.device), rp.diff())
        raw, idx = maxplus_slotlist_argmax_ref(dst, cand.float(), key, n)
        lost = raw < 0.0
        if lam:
            lost |= idx < 0
        ce = idx.masked_fill(lost, 0).long()
        torch.add(cand.gather(0, ce).masked_fill_(lost, 0.0),
                  vcost[r0:r1, None], out=t[r0:r1])
        if lam:
            ssum[r0:r1] = key.gather(0, ce).masked_fill_(lost, 0.0)
            cho[r0:r1] = (idx + e0).masked_fill_(lost, -1)
            csrc[r0:r1] = es[ce].masked_fill_(lost, -1)


def sparse_levels_f64_ref(t, ssum, cho, w, w_base: int, esrc, row_ptr, v_ptr,
                          elat_sum, vcost, lv0: int, lv1: int,
                          csrc=None) -> None:
    """Levels ``lv0..lv1-1`` of the sparse float64 forward, in place, one
    level at a time: the per-level body of the float64 slot-list forward
    (the port of the reference's ``_make_sparse_one``, ``repro/sweep/
    engine.py:749-851``), each level's window being its own edges and rows.

    The arguments are :func:`sparse_levels_f32_ref`'s, with ssum [nv_p, S]
    and elat_sum [ne_p] in float64.  Per level: the candidates ``t[src] +
    w``, a segment max into the level's rows (``scatter_reduce`` into
    buffers seeded with −inf, as ``segment_max`` seeds empty segments),
    ``ts = max(seg, 0)`` and ``t[row] = ts + vcost``.  λ keeps the scalar
    engine's ATOL = 1e-12 tie rules in its order (reference ``:812-818``):
    value hits within ATOL of ``ts``, the largest cumulative slope ``ssum[src]
    + elat_sum`` within ATOL of the hits' best, then the largest edge index;
    ``cho[row]`` is that edge (−1: none), ``ssum[row]`` its slope (0:
    none) and ``csrc[row]`` its source row (−1: none).  The same float64
    ops as ``core.dag``, so T, λ and ρ are bit-identical to it."""
    S = t.shape[1]
    lam = ssum is not None
    dev, f64 = t.device, torch.float64
    ninf = float("-inf")
    vp = v_ptr.tolist()
    for lv in range(lv0, lv1):
        r0, r1 = vp[lv], vp[lv + 1]
        V = r1 - r0
        if V == 0:
            continue
        rp = row_ptr[r0:r1 + 1].long()
        e0, e1 = int(rp[0]), int(rp[-1])
        d1 = torch.repeat_interleave(torch.arange(V, device=dev), rp.diff())
        d = d1[:, None].expand(e1 - e0, S)
        es = esrc[e0:e1]
        cand = t.index_select(0, es).add_(w[e0 - w_base:e1 - w_base])
        seg = torch.full((V, S), ninf, dtype=f64, device=dev)
        ts = seg.scatter_reduce_(0, d, cand, "amax").clamp_min_(0.0)
        rows = slice(r0, r1)
        if lam:
            hit = cand >= ts.index_select(0, d1).sub_(ATOL)
            cs = ssum.index_select(0, es).add_(elat_sum[e0:e1, None])
            best = torch.full((V, S), ninf, dtype=f64, device=dev)
            best.scatter_reduce_(0, d, torch.where(hit, cs, -BIG), "amax")
            sel = hit.logical_and_(cs >= best.index_select(0, d1).sub_(ATOL))
            chosen = torch.full((V, S), -1, dtype=torch.int64, device=dev)
            eidx = torch.arange(e0, e1, device=dev)[:, None]
            chosen.scatter_reduce_(0, d, torch.where(sel, eidx, -1), "amax")
            lost = chosen < 0
            # the winner's key is ssum[src] + elat_sum[e], as the
            # reference recomputes it (:823)
            if e1 > e0:
                torch.gather(cs, 0, (chosen - e0).clamp_min_(0),
                             out=ssum[rows])
            ssum[rows].masked_fill_(lost, 0.0)
            cho[rows] = chosen
            csrc[rows] = esrc[chosen.clamp(min=0)].masked_fill_(lost, -1)
        torch.add(ts, vcost[rows, None], out=t[rows])


def sparse_backtrace_ref(vsel, cho, esrc, elat, nlv: int) -> torch.Tensor:
    """λ [S, nc] f64: for each scenario k, from the vertex slot ``vsel[k]``
    follow the chosen in-edges (``cho[v, k]``, −1: none) to their sources
    (``esrc``) for ``nlv`` steps, summing the chosen edges' ``elat`` rows.
    cho [nv, S] int32 (a vertex's chosen edge lies in an earlier level, so
    every chain ends within ``nlv`` steps).  The reference's gather loop
    (``repro/sweep/engine.py:979-993``): a predecessor table, ``nlv`` gathers,
    and one sum over the visited edges; the rows are message counts, so the
    sum is exact in any order."""
    nv, S = cho.shape
    ch = cho.long()
    own = torch.arange(nv, dtype=torch.int64, device=cho.device)[:, None]
    nxt = torch.where(ch >= 0, esrc[ch.clamp(min=0)], own)     # [nv, S]
    visited = torch.empty((nlv, S), dtype=torch.int64, device=cho.device)
    visited[0] = vsel
    for i in range(1, nlv):
        torch.gather(nxt, 0, visited[i - 1:i], out=visited[i:i + 1])
    ev = ch.gather(0, visited)                                   # [nlv, S]
    rows = elat[ev.clamp(min=0)]                                 # [nlv, S, nc]
    return torch.where((ev >= 0)[..., None], rows, 0.0).sum(0)


def _per_lane(L: int, *xs) -> tuple:
    """Each of ``xs`` with one row a lane: a tensor that leads with G
    structures (G dividing L) repeats structure y // (L / G)'s for lane y;
    one that leads with the L lanes' own values is kept."""
    return tuple(x.index_select(0, torch.arange(L, device=x.device)
                                // (L // x.shape[0])) for x in xs)


def sparse_walk_ref(vsel, cho, csrc, elat, nlv: int) -> torch.Tensor:
    """λ by the one-load walk, the plain version of the ``sparse_backtrace``
    kernel: solo (vsel [S] int64, cho and csrc [nv, S] int32, elat [ne, nc]
    f64 → [S, nc]) or L lanes (a leading axis L on vsel, cho and csrc, G on
    elat, lane y walking structure y // (L / G)'s edges → [L, S,
    nc]).  From ``vsel[k]`` a step takes the recorded edge ``cho[v, k]``
    and moves to its recorded source ``csrc[v, k]``, for ``nlv`` steps or
    until ``cho`` is −1, summing the chosen edges' ``elat`` rows.  Equal to
    :func:`sparse_backtrace_ref` over ``esrc`` wherever ``csrc ==
    esrc[cho]``; the rows are message counts, so the sum is exact in any
    order."""
    if vsel.dim() == 2:
        K = vsel.shape[0] // elat.shape[0]
        return torch.stack([sparse_walk_ref(vsel[y], cho[y], csrc[y],
                                            elat[y // K], nlv)
                            for y in range(vsel.shape[0])])
    nv, S = cho.shape
    own = torch.arange(nv, dtype=torch.int64, device=cho.device)[:, None]
    nxt = torch.where(cho >= 0, csrc.long(), own)                # [nv, S]
    visited = torch.empty((nlv, S), dtype=torch.int64, device=cho.device)
    visited[0] = vsel
    for i in range(1, nlv):
        torch.gather(nxt, 0, visited[i - 1:i], out=visited[i:i + 1])
    ev = cho.long().gather(0, visited)                           # [nlv, S]
    rows = elat[ev.clamp(min=0)]                                 # [nlv, S, nc]
    return torch.where((ev >= 0)[..., None], rows, 0.0).sum(0)


def dense_levels_f32_ref(t, ssum, cho, w, A, esrc, elat_sum, vcost,
                         csrc=None) -> None:
    """Levels ``0..nlv-1`` of the dense float32 forward, in place, one level
    at a time: the per-level body of the reference's ``_dense_core`` /
    ``_dense_core_multi`` (``repro/sweep/engine.py:583-613``, ``:679-713``)
    on the level's 0/−1e30 indicator, with end times carried in float64.

    Solo: t [nflat, S] f64, ssum [nflat, S] f32, cho and csrc [nflat, S]
    int32 (all None in values mode), w [nlv, Emax, S] f64 (pad slots −1e30), A
    [nlv_p, Vmax, Emax] f32, esrc [nlv_p, Emax] int64 flat source rows,
    elat_sum [nlv_p, Emax] f32, vcost [nlv_p, Vmax] f64; flat row ``lv·Vmax
    + i`` is slot i of level lv.  Packed: a leading G axis on all but A,
    which is level-major, [nlv_p, G, Vmax, Emax].

    Per level: the float64 candidates ``t[src] + w``, rounded to float32,
    go to the (max,+) mat-vec of the indicator — with the tie keys
    ``ssum[src] + elat_sum`` to the argmax one in λ mode — which gives each
    row's float32 maximum M (seeded −1e30).  Rounding is monotone, so the
    float64 maximum rounds to M: a second values mat-vec takes, among each
    row's real candidates that round to M, the largest remainder ``cand −
    hi`` (rounded to float32), and ``t[row] = max(M + remainder, 0) +
    vcost``.  In λ mode a row whose M is below 0 has no winner: ``ssum[row]
    = M >= 0 ? the winner's key : 0`` and ``cho[row] = M >= 0 ? lv·Emax +
    the winner's slot : −1``, a flat edge id, and ``csrc[row]`` that
    edge's flat source row (−1: none), which the walk
    (:func:`sparse_walk_ref`, or :func:`sparse_backtrace_ref` over ``esrc``
    flattened to [nlv_p·Emax]) follows.

    Lanes: t, ssum, cho, csrc and w lead with L lanes, A (on its second
    axis), esrc and vcost with G structures, G dividing L; lane y is the
    forward of structure y // (L / G) with its own weights.  elat_sum leads
    with G, or with L where the lanes' latency rows differ."""
    if t.dim() == 2:
        t, w, esrc, elat_sum, vcost, A = (t[None], w[None], esrc[None],
                                          elat_sum[None], vcost[None],
                                          A[:, None])
        if ssum is not None:
            ssum, cho, csrc = ssum[None], cho[None], csrc[None]
    G, nflat, S = t.shape
    nlv, Emax = w.shape[1], w.shape[2]
    Vmax = vcost.shape[2]
    lam = ssum is not None
    dev = t.device
    lanes = torch.arange(G, device=dev) // (G // vcost.shape[0])
    esrc, elat_sum, vcost = _per_lane(G, esrc, elat_sum, vcost)
    t_rows = t.view(G * nflat, S)
    s_rows = ssum.view(G * nflat, S) if lam else None
    goff = torch.arange(G, device=dev)[:, None]
    for lv in range(nlv):
        A_lv = A[lv].index_select(0, lanes)       # [G, Vmax, Emax]
        real = A_lv == 0.0
        emask = real.any(1)[..., None]            # [G, Emax, 1]
        dst = real.to(torch.uint8).argmax(1) + goff * Vmax      # pad → row 0
        src = (esrc[:, lv] + goff * nflat).reshape(-1)
        cand = t_rows.index_select(0, src).view(G, Emax, S).add_(w[:, lv])
        hi = cand.float()
        if lam:
            cs = s_rows.index_select(0, src).view(G, Emax, S)
            cs.add_(elat_sum[:, lv, :, None])
            M, eidx = maxplus_matvec_argmax_batched_ref(A_lv, hi, cs)
        else:
            M = maxplus_matvec_batched_ref(A_lv, hi)
        # the float64 maximum: M plus the largest remainder of the row's
        # real candidates that round to M
        at = M.view(G * Vmax, S).index_select(0, dst.reshape(-1))
        tie = (hi == at.view(G, Emax, S)).logical_and_(emask)
        rem = torch.where(tie, torch.sub(cand, hi).float(), NEG_INF)
        ts = M.double().add_(maxplus_matvec_batched_ref(A_lv, rem))
        rows = slice(lv * Vmax, (lv + 1) * Vmax)
        torch.add(ts.clamp_min_(0.0), vcost[:, lv, :, None], out=t[:, rows])
        if lam:
            has = M >= 0.0                # a real in-edge realized the max
            ssum[:, rows] = cs.gather(1, torch.where(has, eidx, 0).long()
                                      ).masked_fill_(~has, 0.0)
            cho[:, rows] = torch.where(has, eidx + lv * Emax, -1)
            src = esrc[:, lv, :, None].expand(G, Emax, S).gather(
                1, torch.where(has, eidx, 0).long())
            csrc[:, rows] = src.masked_fill_(~has, -1)


def _weights(egclass, egap, econst, elat, Lmat, GSmat,
             lscale=None) -> torch.Tensor:
    """``econst + egap·(γ − 1) + Σ_c elat_c·L_c`` per edge and scenario
    ([..., S], in the dtype of the edge tensors), one elementwise op at a
    time with the class sum spelled out in class order: no contraction
    into an FMA and no reordering, so the card and the CPU round alike and
    the float64 result is the reference's (``engine.py:576-578``,
    ``:776-779``) and the scalar oracle's (``dag.py:80``) bit for bit.
    ``segment_levels_f64`` forms each weight in the kernel with these ops
    in this order.  Any of ``econst``, ``egap``, ``egclass`` and ``elat``
    may lead with a lane axis [K, ...] that the others lack: the result
    then leads with it, each lane's weights from its own fields by the same
    ops.  ``lscale`` ([..., S], each edge's link scale a scenario, the
    congestion fixed point's) scales γ first, ``γ·lscale − 1``, the
    reference's order (``engine.py:224-233``)."""
    gse = GSmat.T[egclass]                           # [..., S]
    if lscale is not None:
        gse = gse.mul_(lscale)
    w = _into(gse.sub_(1.0), egap[..., None], "mul")
    w = _into(w, econst[..., None], "add")
    lat = elat[..., 0, None] * Lmat[:, 0]
    for c in range(1, elat.shape[-1]):
        lat.add_(elat[..., c, None] * Lmat[:, c])
    return _into(w, lat, "add")


def _into(x: torch.Tensor, y: torch.Tensor, op: str) -> torch.Tensor:
    """``op(x, y)`` ("add" or "mul"), in x's storage where x already has
    the broadcast shape (a lane axis that only y carries makes a new
    tensor); the same rounding either way."""
    if torch.broadcast_shapes(x.shape, y.shape) == x.shape:
        return getattr(x, op + "_")(y)
    return getattr(torch, op)(x, y)


def segment_level_weights(Lmat, GSmat, econst, egap, egclass, elat,
                          lv: int, ls=None, elink=None) -> torch.Tensor:
    """[G, Emax, S] f64: level ``lv``'s edge weights of every graph, graph
    g's from its own scenario rows (Lmat [G, S, nc], GSmat [G, S, ngc]) by
    :func:`_weights`; the per-edge view's tensors carry a leading G axis.
    With the link factor, graph g's link scales ls [G, nl1, S] at its
    edges' links elink [G, nlv_p, Emax]."""
    return torch.stack([_weights(
        egclass[g, lv], egap[g, lv], econst[g, lv], elat[g, lv], Lmat[g],
        GSmat[g], None if ls is None else ls[g].index_select(0, elink[g, lv]))
        for g in range(Lmat.shape[0])])


def segment_levels_f64_ref(t, ssum, cho, Lmat, GSmat, edst, esrc, econst,
                           egap, egclass, elat, elat_sum, vcost, lv0: int,
                           lv1: int, csrc=None, ls=None,
                           elink=None) -> None:
    """Levels ``lv0..lv1-1`` of the segment forward, in place, one level at
    a time: the per-level body of the reference's ``_make_segment_one``
    (``repro/sweep/engine.py:222-251``: ``relax`` and ``choose``) on the
    level's per-edge view, with :func:`sparse_levels_f64_ref`'s float64
    rules.

    Solo: t [nflat, S] f64, ssum [nflat, S] f64, cho and csrc [nflat, S]
    int32 (all None in values mode), Lmat [S, nc] and GSmat [S, ngc] f64
    (the scenarios' latencies and gap scales), edst [nlv_p, Emax] int64
    level-local destination slot (pad slots Vmax, a trash row), esrc [nlv_p,
    Emax] int64 flat source row, econst, egap [nlv_p, Emax] f64, egclass
    [nlv_p, Emax] int64 gap class, elat [nlv_p, Emax, nc] f64, elat_sum
    [nlv_p, Emax] f64, vcost [nlv_p, Vmax] f64; flat row ``lv·Vmax + i`` is
    slot i of level lv.  Packed: a leading G axis on every tensor.

    Per level: every edge slot's weight for every scenario
    (:func:`segment_level_weights`, :func:`_weights`' ops), the candidates
    ``t[src] + w``, their
    max into each row (``scatter_reduce`` into [Vmax + 1] rows seeded with
    −inf), ``ts = max(seg, 0)`` and ``t[row] = ts + vcost``.  λ: value hits
    within ATOL of ``ts``, the largest slope ``ssum[src] + elat_sum`` within
    ATOL of the hits' best, then the largest slot j (the reference's
    largest in-edge ordinal); ``cho[row]`` is that edge's flat id ``lv·Emax
    + j`` (−1: none), ``ssum[row]`` its slope (0: none) and ``csrc[row]``
    its flat source row (−1: none).  Every row of a
    walked level is written; a row with no in-edge gets ``0 + vcost``, 0
    and −1.

    Lanes: t, ssum, cho, csrc and econst lead with L lanes, every other
    tensor with G structures, G dividing L; lane y is the forward of
    structure y // (L / G) with its own edge constants.  egap, egclass,
    elat and elat_sum lead with G, or with L where the lanes' values
    differ.

    The link factor: ``ls`` [L?, nl1, S] f64 (lane-owned) scales each
    edge's γ by its link's scale, ``elink`` [G?, nlv_p, Emax] int64
    (structure-owned) naming the link (:func:`_weights`)."""
    if t.dim() == 2:
        t, Lmat, GSmat, edst, esrc, econst, egap, egclass, elat, elat_sum, \
            vcost = (x[None] for x in (t, Lmat, GSmat, edst, esrc, econst,
                                       egap, egclass, elat, elat_sum, vcost))
        if ssum is not None:
            ssum, cho, csrc = ssum[None], cho[None], csrc[None]
        if ls is not None:
            ls, elink = ls[None], elink[None]
    Lmat, GSmat, edst, esrc, egap, egclass, elat, elat_sum, vcost = \
        _per_lane(t.shape[0], Lmat, GSmat, edst, esrc, egap, egclass, elat,
                  elat_sum, vcost)
    if ls is not None:
        elink, = _per_lane(t.shape[0], elink)
    G, nflat, S = t.shape
    Emax, Vmax = esrc.shape[2], vcost.shape[2]
    V1 = Vmax + 1
    lam = ssum is not None
    dev, f64 = t.device, torch.float64
    ninf = float("-inf")
    t_rows = t.view(G * nflat, S)
    s_rows = ssum.view(G * nflat, S) if lam else None
    goff = torch.arange(G, device=dev)[:, None]
    slot = torch.arange(Emax, device=dev).repeat(G)[:, None]
    for lv in range(lv0, lv1):
        w = segment_level_weights(Lmat, GSmat, econst, egap, egclass, elat,
                                  lv, ls, elink)
        src = (esrc[:, lv] + goff * nflat).reshape(-1)          # [G·Emax]
        d1 = (edst[:, lv] + goff * V1).reshape(-1)
        d = d1[:, None].expand(G * Emax, S)
        cand = t_rows.index_select(0, src).add_(w.view(G * Emax, S))
        seg = torch.full((G * V1, S), ninf, dtype=f64, device=dev)
        ts = seg.scatter_reduce_(0, d, cand, "amax").clamp_min_(0.0)
        rows = slice(lv * Vmax, (lv + 1) * Vmax)
        if lam:
            hit = cand >= ts.index_select(0, d1).sub_(ATOL)
            cs = s_rows.index_select(0, src).add_(
                elat_sum[:, lv].reshape(-1, 1))
            best = torch.full((G * V1, S), ninf, dtype=f64, device=dev)
            best.scatter_reduce_(0, d, torch.where(hit, cs, -BIG), "amax")
            sel = hit.logical_and_(cs >= best.index_select(0, d1).sub_(ATOL))
            chosen = torch.full((G * V1, S), -1, dtype=torch.int64,
                                device=dev)
            chosen.scatter_reduce_(0, d, torch.where(sel, slot, -1), "amax")
            chosen = chosen.view(G, V1, S)[:, :Vmax]
            lost = chosen < 0
            ssum[:, rows] = cs.view(G, Emax, S).gather(
                1, chosen.clamp_min(0)).masked_fill_(lost, 0.0)
            cho[:, rows] = torch.where(lost, -1, chosen + lv * Emax)
            csrc[:, rows] = esrc[:, lv, :, None].expand(G, Emax, S).gather(
                1, chosen.clamp_min(0)).masked_fill_(lost, -1)
        torch.add(ts.view(G, V1, S)[:, :Vmax], vcost[:, lv, :, None],
                  out=t[:, rows])
