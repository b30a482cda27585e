// The tree preconditioner of the sparse Newton solve, for Hopper (sm_90a),
// plain C interface.
//
//   tree_factor  the pivots of a forest-structured SPD matrix P, children
//                before parents, one launch an IPM iteration;
//   tree_solve   x = P^-1 r for R right-hand sides (lanes), the up sweep
//                then the down sweep, one launch a PCG step;
//   tree_window  the positions the window below holds on the current card;
//   tree_block   the consumer and producer warps of a block for a forest.
//
// Replaces no TPU kernel.  The reference's IPM factors its Newton matrix
// M = A^T D A with scipy's splu on the host (repro/core/ipm.py:89-90); the
// port solves it by preconditioned CG on the card (repro_torch/core/ipm.py,
// SparseNewton), and these are the preconditioner's two sweeps.
//
// The matrix.  Positions 0 .. nv-1 are the vertex columns of M in the
// DAG's topological level order: level L owns [lv_ptr[L], lv_ptr[L+1]),
// and a vertex's parent (the source of its heaviest in-arc) lies on a
// lower level.  P = diag(d) - sum over tree arcs of w_v (e_v e_p^T +
// e_p e_v^T); ch_ptr / ch list each position's children in increasing
// position, and ch is sorted by parent, so level L's child lists are one
// run, ch[ch_ptr[lv_ptr[L]] .. ch_ptr[lv_ptr[L+1]]).
//
//   factor  piv[v] = d[v] - sum_children c (w[c] * w[c]) / piv[c]
//           g[v]   = w[v] / piv[v]
//   up      x[v]   = r[v] + sum_children c g[c] * x[c]
//   down    x[v]   = (x[v] + w[v] * x[parent[v]]) / piv[v]   (roots: x[v] / piv[v])
//
// Every operation rounds once (__dadd_rn, __dsub_rn, __dmul_rn,
// __ddiv_rn: no FMA can form) and a vertex's children are taken in the
// list's order (a gather, not atomics), so piv, g and x are the plain
// versions' (ref.py) bit for bit: any schedule that keeps the levels in
// order and each sum in list order gives the same bits.
//
// The staged layout (stage.py, made once a forest, i.e. once an IPM
// iteration, by PyTorch): lv_tab [nlv + 1] int2, each level boundary's
// (first position, first child); wk = w[ch] for the factor and gk = g[ch]
// for the up sweep, both in child order, so a level's operands are
// contiguous runs: positions [a, b) of r, x, diag, w, parent and piv, and
// children [e0, e1) of ch, wk and gk.
//
// What bounds it on an H100.  The sweeps are a chain over the levels: a
// level's values read values written one or more levels before.  The bytes
// (parent, w, piv, the child lists and the lanes of r and x) are a few MB
// on the largest LPs, far under the chain, and a level holds a few dozen
// positions, so one SM does a lane's work and a level costs the length of
// its dependent instruction chain between two barriers.  The first design
// (one block of 256 threads a lane, every operand from device memory)
// chained 3-4 device-memory trips a level: lv_ptr -> ch_ptr -> ch -> g, x
// on the up sweep, lv_ptr -> parent -> x on the down sweep, 0.58-0.65 us
// a level a sweep on phase 16 (b)'s forest.  Only x[c] (piv[c]) and
// x[parent] depend on earlier levels; the rest of the forest is fixed for
// the whole iteration.  The least a level can cost with its operands on
// chip is one barrier, one dependent shared-memory read and its float64
// arithmetic (the down sweep's division included): the TP_CHAIN_ONLY build
// below measures it.
//
// Design.  (1) Warp roles and the ring: a block is C consumer warps, which
// do the levels' positions, and PRODUCERS producer warps, which copy
// everything a run of levels reads into a slot of a ring of RING_NS slots
// in shared memory, ahead of the consumers, with cp.async.  A slot holds
// a chunk of `chunk` consecutive levels (tree_chunk: as many as fill 4/5
// of its SLOT_R positions at the forest's mean width, at most CHUNK_MAX),
// which are one run of positions and one run of children: the levels'
// bounds (lv_tab entries), and by position the up sweep's r, ch_ptr and
// records, the down sweep's parent, w, piv and r' (the up sweep's x), the
// factor's diag, w, ch_ptr and records; by child the child-order run
// (ch, gk or wk).  A position's record holds its first two children and
// their g (w), so most positions read their children's coefficients
// without a dependent index load.  Each producer lane's
// cp.async.mbarrier.arrive.noinc completes the slot's "full" mbarrier once
// its copies land; a consumer thread arrives on the slot's "empty"
// mbarrier once the consumers are past the chunk.  The consumers' level
// loop holds no copy and no index load from device memory: per chunk a
// wait, per level the positions and the consumers' barrier (__syncwarp for
// one warp, a named barrier for more; the producers are not in it), the
// next level's bounds read before it.  Positions past a slot read from
// device memory in the same kernel.
// (2) The window: the last W values the consumers wrote (x, or piv in the
// factor) stay in shared memory, position p in slot p & (W - 1); W is the
// largest power of two that shared memory holds beside the ring
// (tree_window).  Up sweep (and factor) at level [a, b): a position i is
// written to the window when i < a + W, and a child c is read from it when
// c < a + W (from device memory otherwise): only positions in [a, c) were
// written since c, none in c's slot.  Down sweep: i is written when
// i >= b - W, and the parent p read from the window when p >= b - W.
// Every value goes to device memory as well.  A position reads both first
// children's window slots at once, then takes the rare miss from device
// memory.
// (3) The block: one block a lane (lane on blockIdx.y: the lanes are
// independent chains, so they run side by side on R SMs, each with a whole
// window and ring), of tree_consumers(mean width) consumer warps, the
// fewest whose threads cover a mean level.  The solve's two sweeps share
// the ring's barriers (chunks 0 .. 2 nc - 1) and meet at one
// __syncthreads, so the down sweep's copies of r' start after the up
// sweep's last store.
//
// What it reached (H100 80GB HBM3, 700 W; PERF.md, kernel table row 8, from
// tools/ipm_probe.py): on phase 16 (b)'s last forest (92,161 positions,
// 2,740 levels, 34 a level on average) tree_solve R 2 1.354-1.357 ms
// (0.247 us a level a sweep) against the on-chip chain's 1.067 ms and the
// first design's 3.37-3.57 ms; tree_factor 1.150 ms against 2.51.  On
// phase 6's LP (13,224 levels, 70 a level) tree_solve 7.46 ms against
// 25.6-29.9.  On (b)'s forest one producer kept up (2 gave nothing), 2
// consumer warps beat 1, 4 and 8, 12 levels a slot beat 1, 4, 8 and 16, 2
// slots beat 4, and the window saved 7-11 %; on phase 6's, 4 consumer
// warps beat 2 and 8 (the rule's choices).

// One compile-time knob, for measurement (tools/ipm_probe.py and
// chip_smoke.py build the file with it; the package builds it without):
// TP_CHAIN_ONLY keeps only the chain a level cannot do without (the
// consumers' barrier, one dependent shared-memory read, the level's
// float64 arithmetic with the down sweep's division, the stores; the
// levels' bounds from a copy of lv_tab in shared memory when it fits the
// ring's room, else from device memory; no ring).  Its results are not the
// function's; its time over 2 x levels is the on-chip chain's step.  The
// ring's and the block's constants below were chosen by timing builds that
// varied them (PERF.md, the tree kernels' findings).

#include <cuda_runtime.h>
#include <atomic>
#include <cstdint>

namespace {

constexpr int RING_NS = 2;                // slots, a power of two
constexpr int CHUNK_MAX = 16;             // levels a slot holds at most
constexpr int PRODUCERS = 1;              // producer warps
constexpr int SLOT_R = 512;               // positions a slot holds
constexpr int SLOT_E = 512;               // children a slot holds
static_assert((RING_NS & (RING_NS - 1)) == 0, "RING_NS: a power of two");
// A slot, from its start: the chunk's level boundaries hd [CHUNK_MAX + 1]
// int2 (padded to 16 B); by position v01 [SLOT_R] double2 (the first two
// children's g, or w in the factor), p0, p1, p2 [SLOT_R] f64 (r, r' or
// diag; w; piv), c01 [SLOT_R] int2 (the first two children, -1 where
// absent), ip [SLOT_R + 1] i32 (ch_ptr) or parent; by child e [SLOT_E]
// f64 (gk or wk) and ch [SLOT_E] i32.
constexpr int HD_BYTES = ((CHUNK_MAX + 1) * 8 + 15) / 16 * 16;
constexpr int SLOT_BYTES =
    HD_BYTES + ((SLOT_R * 16 + SLOT_R * 3 * 8 + SLOT_E * 8 + SLOT_R * 8
                 + (SLOT_R + 1) * 4 + SLOT_E * 4) + 15) / 16 * 16;
constexpr int RING_BYTES = RING_NS * SLOT_BYTES;
constexpr int BAR_BYTES = 2 * RING_NS * 8;       // full, then empty

struct Slot {
    int2* hd;
    double2* v01;
    double* p0;
    double* p1;
    double* p2;
    double* e;
    int2* c01;
    int* ip;
    int* ch;
    __device__ __forceinline__ explicit Slot(unsigned char* s)
        : hd(reinterpret_cast<int2*>(s)),
          v01(reinterpret_cast<double2*>(s + HD_BYTES)),
          p0(reinterpret_cast<double*>(v01 + SLOT_R)), p1(p0 + SLOT_R),
          p2(p1 + SLOT_R), e(p2 + SLOT_R),
          c01(reinterpret_cast<int2*>(e + SLOT_E)),
          ip(reinterpret_cast<int*>(c01 + SLOT_R)), ch(ip + SLOT_R + 1) {}
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
                 ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// the phase of ``bar`` with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
    unsigned done = 0;
    while (!done)
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                     : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n .reg .b64 st;\n"
                 " mbarrier.arrive.shared.b64 st, [%0];\n}\n"
                 ::"r"(smem_u32(bar)) : "memory");
}

// arrives on ``bar`` once this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
                 ::"r"(smem_u32(bar)) : "memory");
}

// the consumers' barrier between levels (the producers are not in it)
template <int C>
__device__ __forceinline__ void consumers_bar() {
    if constexpr (C == 1)
        __syncwarp();
    else
        asm volatile("bar.sync 1, %0;\n" ::"n"(32 * C) : "memory");
}

// The window of W values (W a power of two): position p in slot p & (W - 1).
struct Window {
    double* v;
    int W;
    __device__ __forceinline__ double& at(int p) const {
        return v[p & (W - 1)];
    }
};

// A chunk: the levels [lo, lo + n) of a sweep, the c-th of the sweep's
// chunks of ck levels in its order (UP: from the top level down).
struct Chunk {
    int lo, n;
    template <bool UP>
    __device__ __forceinline__ static Chunk of(int c, int ck, int nlv) {
        if (UP) {
            const int hi = nlv - c * ck;
            const int lo = max(0, hi - ck);
            return {lo, hi - lo};
        }
        return {c * ck, min(ck, nlv - c * ck)};
    }
};

// The ring: its slots and their full and empty mbarriers.  Step g (the
// solve's up sweep's chunks g = 0 .. nc - 1, its down sweep's nc .. 2 nc -
// 1) owns slot g mod RING_NS, whose full barrier completes its phase g /
// RING_NS when the step's copies have landed, and whose empty barrier
// completes it when the consumers are past the step.
struct Ring {
    unsigned char* slots;
    uint64_t* full;
    uint64_t* empty;
    __device__ __forceinline__ Slot slot(int g) const {
        return Slot(slots + (g & (RING_NS - 1)) * SLOT_BYTES);
    }
};

// The dynamic shared memory: the mbarriers, the ring, the window.
struct Smem {
    Ring ring;
    double* win;
    __device__ __forceinline__ explicit Smem(unsigned char* s)
        : ring{s + BAR_BYTES, reinterpret_cast<uint64_t*>(s),
               reinterpret_cast<uint64_t*>(s) + RING_NS},
          win(reinterpret_cast<double*>(s + BAR_BYTES + RING_BYTES)) {}
    // one thread: full barriers count a producer warp's 32 lanes, empty
    // ones the consumer thread that releases the slot
    __device__ __forceinline__ void init() const {
        for (int k = 0; k < RING_NS; ++k) {
            mbar_init(ring.full + k, 32);
            mbar_init(ring.empty + k, 1);
        }
    }
};

// A producer warp's part of one sweep from step g0 on: the chunks p, p +
// PRODUCERS, ... of the sweep's nc.
template <bool UP, class Body>
__device__ __forceinline__ void produce(const Body& body, const Ring& ring,
                                        const int2* __restrict__ lv_tab,
                                        int nlv, int chunk, int g0, int p,
                                        int lane) {
#ifndef TP_CHAIN_ONLY
    const int nc = (nlv + chunk - 1) / chunk;
    for (int c = p; c < nc; c += PRODUCERS) {
        const int g = g0 + c, k = g & (RING_NS - 1);
        const Chunk ck = Chunk::of<UP>(c, chunk, nlv);
        const int2 lo = lv_tab[ck.lo], hi = lv_tab[ck.lo + ck.n];
        if (g >= RING_NS) mbar_wait(ring.empty + k, ((g / RING_NS) - 1) & 1);
        const Slot sl = ring.slot(g);
        if (lane <= ck.n) cp_async8(sl.hd + lane, lv_tab + ck.lo + lane);
        body.copy(sl, lo.x, hi.x, lo.y, hi.y, lane);
        cp_async_arrive(ring.full + k);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// The consumers' part of one sweep from step g0 on: every level, in order.
template <int C, bool UP, class Body>
__device__ __forceinline__ void consume(const Body& body, const Window& win,
                                        const Ring& ring,
                                        const int2* __restrict__ lv_tab,
                                        int nlv, int chunk, int g0) {
    const int tid = threadIdx.x;
#ifdef TP_CHAIN_ONLY
    // the bounds from a copy of lv_tab in the ring's room when it fits
    const int2* tab = lv_tab;
    if ((nlv + 1) * 8 <= RING_BYTES) {
        int2* t = reinterpret_cast<int2*>(ring.slots);
        for (int i = tid; i <= nlv; i += 32 * C) t[i] = lv_tab[i];
        consumers_bar<C>();
        tab = t;
    }
    for (int s = 0; s < nlv; ++s) {
        const int L = UP ? nlv - 1 - s : s;
        const int2 lo = tab[L], hi = tab[L + 1];
        body.chain(lo.x, hi.x, win, tid);
        consumers_bar<C>();
    }
    (void)g0, (void)chunk;
#else
    (void)lv_tab;
    const int nc = (nlv + chunk - 1) / chunk;
    for (int c = 0; c < nc; ++c) {
        const int g = g0 + c;
        const Chunk ck = Chunk::of<UP>(c, chunk, nlv);
        mbar_wait(ring.full + (g & (RING_NS - 1)), (g / RING_NS) & 1);
        const Slot sl = ring.slot(g);
        const int2 base = sl.hd[0];          // the chunk's first position, child
        int lv = UP ? ck.n - 1 : 0;
        int a = sl.hd[lv].x, b = sl.hd[lv + 1].x;
        for (int t = 0; t < ck.n; ++t) {
            // the next level's bounds, read before this level's barrier
            const int ln = UP ? lv - 1 : lv + 1;
            int an = a, bn = b;
            if (t + 1 < ck.n) {
                an = sl.hd[ln].x;
                bn = sl.hd[ln + 1].x;
            }
            body.rows(sl, base, a, b, win, tid);
            consumers_bar<C>();
            lv = ln;
            a = an;
            b = bn;
        }
        if (tid == 0) mbar_arrive(ring.empty + (g & (RING_NS - 1)));
    }
#endif
}

// -- the factor ---------------------------------------------------------------

template <int NT>
struct FactorBody {
    const double* __restrict__ diag;
    const double* __restrict__ w;
    const double* __restrict__ wk;
    const int2* __restrict__ c01;
    const double2* __restrict__ w01;
    const int* __restrict__ ch_ptr;
    const int* __restrict__ ch;
    double* piv;
    double* g;

    // positions [a, b) and children [e0, e1) into slot sl
    __device__ __forceinline__ void copy(Slot sl, int a, int b, int e0,
                                          int e1, int lane) const {
        const int nR = min(b - a, SLOT_R), nE = min(e1 - e0, SLOT_E);
        for (int u = lane; u < nR; u += 32) {
            cp_async8(sl.p0 + u, diag + a + u);
            cp_async8(sl.p1 + u, w + a + u);
            cp_async8(sl.c01 + u, c01 + a + u);
            cp_async16(sl.v01 + u, w01 + a + u);
        }
        for (int u = lane; u <= nR; u += 32)
            cp_async4(sl.ip + u, ch_ptr + a + u);
        for (int u = lane; u < nE; u += 32) {
            cp_async4(sl.ch + u, ch + e0 + u);
            cp_async8(sl.e + u, wk + e0 + u);
        }
    }

    // the level [a, b) of the chunk that starts at position base.x, child
    // base.y: its positions in the slot, then those past it
    __device__ __forceinline__ void rows(Slot sl, int2 base, int a, int b,
                                         const Window& win, int tid) const {
        const int lim = min(b, base.x + SLOT_R);
        int i = a + tid;
        for (; i < lim; i += NT) {
            const int j = i - base.x;
            row(sl, base, a, i, sl.p0[j], sl.p1[j], sl.ip[j], sl.ip[j + 1],
                sl.c01[j], sl.v01[j], win);
        }
        for (; i < b; i += NT)
            row(sl, base, a, i, diag[i], w[i], ch_ptr[i], ch_ptr[i + 1],
                c01[i], w01[i], win);
    }

    // position i: acc = d[i] less its children's terms, the first two
    // (c, their w in v) read together, the rest from the child-order run
    __device__ __forceinline__ void row(const Slot& sl, int2 base, int a,
                                        int i, double acc, double wi, int k0,
                                        int k1, int2 c, double2 v,
                                        const Window& win) const {
        double p0 = win.at(c.x), p1 = win.at(c.y);
        if (c.x >= 0 && c.x - a >= win.W) p0 = piv[c.x];
        if (c.y >= 0 && c.y - a >= win.W) p1 = piv[c.y];
        if (c.x >= 0) acc = __dsub_rn(acc, __ddiv_rn(__dmul_rn(v.x, v.x), p0));
        if (c.y >= 0) acc = __dsub_rn(acc, __ddiv_rn(__dmul_rn(v.y, v.y), p1));
        for (int k = k0 + 2; k < k1; ++k) {
            const int u = k - base.y;
            acc = __dsub_rn(acc, u < SLOT_E ? term(sl.e[u], sl.ch[u], a, win)
                                            : term(wk[k], ch[k], a, win));
        }
        piv[i] = acc;
        g[i] = __ddiv_rn(wi, acc);
        if (i - a < win.W) win.at(i) = acc;
    }

    // (w[c] * w[c]) / piv[c] of a child c of level [a, b)
    __device__ __forceinline__ double term(double wc, int c, int a,
                                           const Window& win) const {
        const double pc = c - a < win.W ? win.at(c) : piv[c];
        return __ddiv_rn(__dmul_rn(wc, wc), pc);
    }

    // TP_CHAIN_ONLY: one dependent read of a value the last level wrote
    __device__ __forceinline__ void chain(int a, int b, const Window& win,
                                          int tid) const {
        for (int i = a + tid; i < b; i += NT) {
            const int j = i - a;
            const double pc = win.at(b - a < win.W ? b : i);
            const double wc = 1.0 + j;
            const double acc = __dsub_rn(4.0 * wc, __ddiv_rn(
                __dmul_rn(wc, wc), pc));
            piv[i] = acc;
            g[i] = __ddiv_rn(wc, acc);
            if (j < win.W) win.at(i) = acc;
        }
    }
};

// -- the solve ----------------------------------------------------------------

template <int NT>
struct UpBody {
    const double* __restrict__ r;
    const double* __restrict__ gk;
    const int2* __restrict__ c01;
    const double2* __restrict__ g01;
    const int* __restrict__ ch_ptr;
    const int* __restrict__ ch;
    double* x;
    long long R, lane;

    __device__ __forceinline__ void copy(Slot sl, int a, int b, int e0,
                                          int e1, int ln) const {
        const int nR = min(b - a, SLOT_R), nE = min(e1 - e0, SLOT_E);
        for (int u = ln; u < nR; u += 32) {
            cp_async8(sl.p0 + u, r + (a + u) * R + lane);
            cp_async8(sl.c01 + u, c01 + a + u);
            cp_async16(sl.v01 + u, g01 + a + u);
        }
        for (int u = ln; u <= nR; u += 32)
            cp_async4(sl.ip + u, ch_ptr + a + u);
        for (int u = ln; u < nE; u += 32) {
            cp_async4(sl.ch + u, ch + e0 + u);
            cp_async8(sl.e + u, gk + e0 + u);
        }
    }

    __device__ __forceinline__ void rows(Slot sl, int2 base, int a, int b,
                                         const Window& win, int tid) const {
        const int lim = min(b, base.x + SLOT_R);
        int i = a + tid;
        for (; i < lim; i += NT) {
            const int j = i - base.x;
            row(sl, base, a, i, sl.p0[j], sl.ip[j], sl.ip[j + 1], sl.c01[j],
                sl.v01[j], win);
        }
        for (; i < b; i += NT)
            row(sl, base, a, i, r[i * R + lane], ch_ptr[i], ch_ptr[i + 1],
                c01[i], g01[i], win);
    }

    // position i: acc = r[i] plus its children's terms, the first two (c,
    // their g in v) read together, the rest from the child-order run
    __device__ __forceinline__ void row(const Slot& sl, int2 base, int a,
                                        int i, double acc, int k0, int k1,
                                        int2 c, double2 v,
                                        const Window& win) const {
        double x0 = win.at(c.x), x1 = win.at(c.y);
        if (c.x >= 0 && c.x - a >= win.W)
            x0 = x[c.x * R + lane];
        if (c.y >= 0 && c.y - a >= win.W)
            x1 = x[c.y * R + lane];
        const double t0 = __dmul_rn(v.x, x0), t1 = __dmul_rn(v.y, x1);
        if (c.x >= 0) acc = __dadd_rn(acc, t0);
        if (c.y >= 0) acc = __dadd_rn(acc, t1);
        for (int k = k0 + 2; k < k1; ++k) {
            const int u = k - base.y;
            acc = __dadd_rn(acc, u < SLOT_E ? term(sl.e[u], sl.ch[u], a, win)
                                            : term(gk[k], ch[k], a, win));
        }
        x[i * R + lane] = acc;
        if (i - a < win.W) win.at(i) = acc;
    }

    // g[c] * x[c] of a child c of level [a, b)
    __device__ __forceinline__ double term(double gc, int c, int a,
                                           const Window& win) const {
        const double xc = c - a < win.W ? win.at(c)
                                                      : x[c * R + lane];
        return __dmul_rn(gc, xc);
    }

    __device__ __forceinline__ void chain(int a, int b, const Window& win,
                                          int tid) const {
        for (int i = a + tid; i < b; i += NT) {
            const int j = i - a;
            const double xc = win.at(b - a < win.W ? b : i);
            const double acc = __dadd_rn(1.0 + j, __dmul_rn(0.5, xc));
            x[i * R + lane] = acc;
            if (j < win.W) win.at(i) = acc;
        }
    }
};

template <int NT>
struct DownBody {
    const int* __restrict__ parent;
    const double* __restrict__ w;
    const double* __restrict__ piv;
    double* x;
    long long R, lane;

    __device__ __forceinline__ void copy(Slot sl, int a, int b, int, int,
                                          int ln) const {
        const int nR = min(b - a, SLOT_R);
        for (int u = ln; u < nR; u += 32) {
            cp_async4(sl.ip + u, parent + a + u);
            cp_async8(sl.p1 + u, w + a + u);
            cp_async8(sl.p2 + u, piv + a + u);
            cp_async8(sl.p0 + u, x + (a + u) * R + lane);      // r'
        }
    }

    __device__ __forceinline__ void rows(Slot sl, int2 base, int a, int b,
                                         const Window& win, int tid) const {
        const int lim = min(b, base.x + SLOT_R);
        int i = a + tid;
        for (; i < lim; i += NT) {
            const int j = i - base.x;
            row(b, i, sl.ip[j], sl.p0[j], sl.p1[j], sl.p2[j], win);
        }
        for (; i < b; i += NT)
            row(b, i, parent[i], x[i * R + lane], w[i], piv[i], win);
    }

    // position i of level [a, b): (r'[i] + w[i] x[p]) / piv[i]
    __device__ __forceinline__ void row(int b, int i, int p, double v,
                                        double wi, double pv,
                                        const Window& win) const {
        double xp = win.at(p);
        if (p >= 0 && b - p > win.W) xp = x[p * R + lane];
        if (p >= 0) v = __dadd_rn(v, __dmul_rn(wi, xp));
        v = __ddiv_rn(v, pv);
        x[i * R + lane] = v;
        if (b - i <= win.W) win.at(i) = v;
    }

    __device__ __forceinline__ void chain(int a, int b, const Window& win,
                                          int tid) const {
        for (int i = a + tid; i < b; i += NT) {
            const int j = i - a;
            const double xp = win.at(a > 0 && b - a < win.W ? a - 1 : i);
            const double v = __ddiv_rn(__dadd_rn(1.0 + j, __dmul_rn(0.5, xp)),
                                       3.0 + j);
            x[i * R + lane] = v;
            if (b - i <= win.W) win.at(i) = v;
        }
    }
};

template <int C>
__global__ void __launch_bounds__(32 * (C + PRODUCERS))
tree_factor_kernel(const double* __restrict__ diag,
                   const double* __restrict__ w,
                   const double* __restrict__ wk,
                   const int2* __restrict__ c01,
                   const double2* __restrict__ w01,
                   const int* __restrict__ ch_ptr,
                   const int* __restrict__ ch,
                   const int2* __restrict__ lv_tab, int nlv, int chunk,
                   int W, double* piv, double* g) {
    extern __shared__ __align__(16) unsigned char smem[];
    if (nlv == 0) return;
    const Smem sm(smem);
    if (threadIdx.x == 0) sm.init();
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    FactorBody<32 * C> body{diag, w, wk, c01, w01, ch_ptr, ch, piv, g};
    if (warp >= C)
        produce<true>(body, sm.ring, lv_tab, nlv, chunk, 0, warp - C,
                      threadIdx.x & 31);
    else
        consume<C, true>(body, Window{sm.win, W}, sm.ring, lv_tab, nlv,
                         chunk, 0);
}

template <int C>
__global__ void __launch_bounds__(32 * (C + PRODUCERS))
tree_solve_kernel(const double* __restrict__ r,
                  const int* __restrict__ parent,
                  const double* __restrict__ w,
                  const double* __restrict__ piv,
                  const double* __restrict__ gk,
                  const int2* __restrict__ c01,
                  const double2* __restrict__ g01,
                  const int* __restrict__ ch_ptr,
                  const int* __restrict__ ch,
                  const int2* __restrict__ lv_tab, int nlv, int chunk,
                  int W, int R, double* x) {
    extern __shared__ __align__(16) unsigned char smem[];
    if (nlv == 0) return;
    const Smem sm(smem);
    if (threadIdx.x == 0) sm.init();
    __syncthreads();
    const long long lane = blockIdx.y;
    const int warp = threadIdx.x >> 5;
    const bool producer = warp >= C;
    const Window win{sm.win, W};
    const int nc = (nlv + chunk - 1) / chunk;
    // up: children before parents; x holds r' when the sweep ends
    UpBody<32 * C> up{r, gk, c01, g01, ch_ptr, ch, x, R, lane};
    if (producer)
        produce<true>(up, sm.ring, lv_tab, nlv, chunk, 0, warp - C,
                      threadIdx.x & 31);
    else
        consume<C, true>(up, win, sm.ring, lv_tab, nlv, chunk, 0);
    // every r' stored before the down sweep's copies of it
    __syncthreads();
    // down: parents before children, x overwritten in place; the window's
    // up-sweep values are never read (a parent is read from it only once
    // the down sweep wrote it)
    DownBody<32 * C> down{parent, w, piv, x, R, lane};
    if (producer)
        produce<false>(down, sm.ring, lv_tab, nlv, chunk, nc, warp - C,
                       threadIdx.x & 31);
    else
        consume<C, false>(down, win, sm.ring, lv_tab, nlv, chunk, nc);
}

// The window's positions for a block of smem_max bytes of shared memory:
// the largest power of two that the barriers and the ring leave room for.
int window_positions(int smem_max) {
    const int room = (smem_max - BAR_BYTES - RING_BYTES) / 8;
    int W = 1;
    while (2 * W <= room) W *= 2;
    return W;
}

// The consumer warps for a forest whose levels hold width positions on
// average: the fewest whose threads cover such a level.
int tree_consumers(int width) {
    int c = 1;
    while (c < 8 && 32 * c < width) c <<= 1;
    return c;
}

// The levels a slot holds for a forest whose levels hold width positions
// on average: as many as fill 4/5 of a slot's positions (the rest for
// levels wider than the mean), at most CHUNK_MAX.
int tree_chunk(int width) {
    const int n = 4 * SLOT_R / (5 * (width > 1 ? width : 1));
    return n < 1 ? 1 : n > CHUNK_MAX ? CHUNK_MAX : n;
}

// Once a device: the window's positions and the block's dynamic shared
// memory (0 until asked), and the kernels already allowed that much (bit C
// for tree_factor_kernel<C>, C << 4 for tree_solve_kernel<C>).
constexpr int MAX_DEVICES = 64;
std::atomic<int> setup_W[MAX_DEVICES];
std::atomic<int> setup_smem[MAX_DEVICES];
std::atomic<unsigned> setup_allowed[MAX_DEVICES];

cudaError_t launch_setup(int* dev, int* W, int* smem) {
    cudaError_t err = cudaGetDevice(dev);
    if (err != cudaSuccess) return err;
    const bool kept = *dev < MAX_DEVICES;
    if (kept && (*smem = setup_smem[*dev].load()) != 0) {
        *W = setup_W[*dev].load();
        return cudaSuccess;
    }
    int sm;
    err = cudaDeviceGetAttribute(
        &sm, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    *W = window_positions(sm);
    *smem = BAR_BYTES + RING_BYTES + 8 * *W;
    if (kept) {
        setup_W[*dev].store(*W);          // before smem, which marks it set
        setup_smem[*dev].store(*smem);
    }
    return cudaSuccess;
}

template <class K>
cudaError_t allow(K kernel, int dev, unsigned bit, int smem) {
    const bool kept = dev < MAX_DEVICES;
    if (kept && (setup_allowed[dev].load() & bit)) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess && kept) setup_allowed[dev].fetch_or(bit);
    return err;
}

}  // namespace

extern "C" int tree_block(int width, int* warps) {
    warps[0] = tree_consumers(width);
    warps[1] = PRODUCERS;
    warps[2] = tree_chunk(width);
    return 0;
}

extern "C" int tree_window(int* W) {
    int dev, smem;
    return static_cast<int>(launch_setup(&dev, W, &smem));
}

extern "C" int tree_factor(const double* diag, const double* w,
                           const double* wk, const int* c01,
                           const double* w01, const int* ch_ptr,
                           const int* ch, const int* lv_tab, int nlv,
                           int width, double* piv, double* g, void* stream) {
    int dev, W, sm;
    cudaError_t err = launch_setup(&dev, &W, &sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* tab = reinterpret_cast<const int2*>(lv_tab);
    const auto* c2 = reinterpret_cast<const int2*>(c01);
    const auto* w2 = reinterpret_cast<const double2*>(w01);
    const auto st = static_cast<cudaStream_t>(stream);
#define TP_FACTOR(C)                                                         \
    case C:                                                                  \
        err = allow(tree_factor_kernel<C>, dev, C, sm);                       \
        if (err != cudaSuccess) return static_cast<int>(err);                \
        tree_factor_kernel<C><<<1, 32 * (C + PRODUCERS), sm, st>>>(          \
            diag, w, wk, c2, w2, ch_ptr, ch, tab, nlv, tree_chunk(width), W, \
            piv, g);                                                         \
        break;
    switch (tree_consumers(width)) {
        TP_FACTOR(1) TP_FACTOR(2) TP_FACTOR(4) TP_FACTOR(8)
        default: return static_cast<int>(cudaErrorInvalidConfiguration);
    }
#undef TP_FACTOR
    return static_cast<int>(cudaGetLastError());
}

extern "C" int tree_solve(const double* r, const int* parent, const double* w,
                          const double* piv, const double* gk,
                          const int* c01, const double* g01,
                          const int* ch_ptr, const int* ch, const int* lv_tab,
                          int nlv, int width, int R, double* x,
                          void* stream) {
    int dev, W, sm;
    cudaError_t err = launch_setup(&dev, &W, &sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    const auto* tab = reinterpret_cast<const int2*>(lv_tab);
    const auto* c2 = reinterpret_cast<const int2*>(c01);
    const auto* g2 = reinterpret_cast<const double2*>(g01);
    const auto st = static_cast<cudaStream_t>(stream);
#define TP_SOLVE(C)                                                          \
    case C:                                                                  \
        err = allow(tree_solve_kernel<C>, dev, C << 4, sm);                   \
        if (err != cudaSuccess) return static_cast<int>(err);                \
        tree_solve_kernel<C><<<dim3(1, R), 32 * (C + PRODUCERS), sm, st>>>(  \
            r, parent, w, piv, gk, c2, g2, ch_ptr, ch, tab, nlv,             \
            tree_chunk(width), W, R, x);                                     \
        break;
    switch (tree_consumers(width)) {
        TP_SOLVE(1) TP_SOLVE(2) TP_SOLVE(4) TP_SOLVE(8)
        default: return static_cast<int>(cudaErrorInvalidConfiguration);
    }
#undef TP_SOLVE
    return static_cast<int>(cudaGetLastError());
}
