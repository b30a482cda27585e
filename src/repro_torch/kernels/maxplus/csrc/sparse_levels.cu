// The sparse forward's level loops (float32 and float64 flavours) and
// their critical-path backtrace, for Hopper (sm_90a), plain C interface.
//
//   sparse_levels_f32  every level of one weight chunk, in order, in one
//                      launch: the work of the per-level PyTorch body around
//                      the slot-list kernel (gathers, the float32 boundary,
//                      the lexicographic argmax, the masked writes of t,
//                      ssum and cho).
//   sparse_levels_f64  the same for the float64 flavour: every level of one
//                      weight chunk of the float64 slot-list forward, with
//                      the scalar engine's ATOL = 1e-12 tie rules (see
//                      "The float64 flavour" below).
//   segment_levels_f64 the levels of one weight chunk of the segment
//                      forward (a compiled plan's per-edge view, solo or G
//                      packed plans, graph g on blockIdx.y), each row
//                      through the same float64 row body as
//                      sparse_levels_f64 (f64_row).
//   sparse_backtrace   the walk from each scenario's sink down its chosen
//                      in-edges, summing their elat rows (λ).
//
// Replace, on the main path, the TPU kernel maxplus_slotlist_argmax_kernel
// (repro/kernels/maxplus/kernel.py:262) with the reference's level body
// around it (repro/sweep/engine.py:903-971), the reference's float64
// slot-list level body, which has no kernel (_make_sparse_one,
// repro/sweep/engine.py:749-851), the reference's segment level body,
// which has no kernel either (_make_segment_one's relax and choose,
// engine.py:222-251, a pure-jnp gather and max), and the reference's
// backtrace (engine.py:979-993).
//
// Layout.  Scenarios (S) are the contiguous axis of every [rows, S] array.
// t [nv_p, S] float64 end times, ssum [nv_p, S] float32 tie keys and cho
// [nv_p, S] int32 chosen in-edges are updated in place.  A level lv owns the
// vertex slots [v_ptr[lv], v_ptr[lv+1]); row r's in-edges are the run
// [row_ptr[r], row_ptr[r+1]) of the plan's edges, in increasing edge index
// (the compiler sorts a level's edges by destination, and stage_sparse
// refuses a plan that is not so sorted).  w holds the chunk's float64 edge
// weights from edge w_base on, [*, S].
//
// Per (row, scenario), in the reference's order and rounding:
//   cand64 = t[src] + w          (__dadd_rn)
//   cand32 = (float) cand64      (__double2float_rn: the float32 boundary)
//   key    = ssum[src] + elat_sum[e]   (__fadd_rn; 0 in values mode)
//   the lexicographic argmax of (cand32, key, e) over the row's in-edges,
//   seeded (-1e30, -1e30, -1), exact compares, the largest e winning a
//   full tie;
//   lost   = cand32max < 0  (or no winner, λ mode)
//   t[row] = (lost ? 0 : cand64[winner]) + vcost[row]   (__dadd_rn)
//   ssum[row] = lost ? 0 : key[winner];  cho[row] = lost ? -1 : winner.
// No FMA can form: every add is an explicit round-to-nearest intrinsic.
//
// Why only the level's own edges and rows.  A level's rows can be won only
// by its own edges; the reference's fixed [Emax_lv] window also holds later
// levels' edges, whose writes land in rows that their own level overwrites
// before anything reads them.  Reading them here would race with this
// level's writes (their sources are rows being written), so each level
// reads its own edges and writes its own rows, and the final t, ssum and
// cho of every real vertex equal the reference's bit for bit.
//
// What bounds it on an H100.  Bytes: each input read once and each output
// written once, per scenario: the edges' w (8 B), the t and ssum of source
// rows written before the launch (8 + 4 B), and the rows' t, ssum and cho
// (8 + 4 + 4 B), plus the topology once.  The t[src] and ssum[src] of rows
// that the launch itself wrote are its own intermediates: this design
// reloads them through L2 (8 + 4 B an edge), but the bound does not count
// them.  chip_smoke.py computes both for one weight chunk of its stencil.
// Levels depend on each other: level lv's t[src] loads wait for level
// lv-1's stores, so a launch is also a chain of levels x (a dependent
// round trip through L2 and a barrier); the chain, not the bytes, sets the
// pace.
//
// Design.  A block owns kb scenarios for all rows of every level of the
// chunk; scenario k's rows are never split across blocks, so one
// __syncthreads() between levels orders every read of a level after every
// write of the levels before it (global writes by a block's threads are
// visible to the block after the barrier; t and ssum are read with plain,
// L1-coherent loads, never through the read-only path).  There is no
// grid-wide barrier and no host round trip inside a chunk.  Thread (ry, kx)
// takes rows v_ptr[lv] + ry, + nr, ... of scenario k0 + kx, where nr =
// blockDim / kb: neighbouring lanes read neighbouring scenarios of a row
// (kb x 8 bytes of t).  A row's in-edges are taken EB at a time with all
// their loads issued together (the stencil's rows have at most 2), so a
// row costs one chain of (row_ptr -> esrc -> t) however many in-edges it
// has.  kb trades rows a pass (nr) against blocks on the card
// (ceil(S / kb)); kb = 8 (32 blocks at S = 256) was the fastest of 2, 4,
// 8, 16 and 32 on an H100 (PERF.md, kernel table row 5).  Loading the next
// levels' row pointers and edges into registers one to four levels ahead
// did not shorten a level on the H100, as if each barrier waited for every
// load in flight; an asynchronous copy ring in shared memory (cp.async),
// which a barrier does not wait for, is the way to hide those loads.
//
// The float64 flavour (sparse_levels_f64).  Same layout, design and bound
// as above, with ssum and elat_sum in float64.  Per (row, scenario), in the
// order and rounding of core.dag and of the plain version
// (ref.sparse_levels_f64_ref):
//   cand = t[src] + w            (__dadd_rn) over the row's in-edges
//   m    = the max of the candidates, seeded -inf
//   ts   = max(m, 0);  t[row] = ts + vcost[row]   (__dadd_rn)
// and in λ mode, with ATOL = 1e-12:
//   hit  = cand >= ts - ATOL     (__dsub_rn; ts the clamped value)
//   cs   = ssum[src] + elat_sum[e]                (__dadd_rn)
//   best = the max of cs over the hits, seeded -1e30
//   sel  = hit && cs >= best - ATOL
//   cho[row] = the largest edge of sel (-1: none); ssum[row] = its cs, or 0.
// The ATOL rules need the level max before a hit is known, and the best
// slope before a selection is, so a row takes three passes over its
// in-edges.  A row of at most EC = 2 in-edges (every row of the stencils
// and of the traced steps) keeps its candidates and slopes in registers
// after the first pass; a longer row reloads them (L1 hits) in passes two
// and three.  EC = 4 spilled at the 64 registers that 1,024 threads
// leave a thread (72 B; 2.35 us a level on phase 6's chunk, H100 80GB
// HBM3 at 700 W).  The bytes bound and the chain are the float32
// flavour's, with 8-byte tie keys.  The row body is one function,
// f64_row, which takes a row's in-edges through an accessor: the run of
// a sparse row (RunEdges) or the (edge id, source row) list of a segment
// row (ListEdges), so the ATOL rules exist once.
//
// The segment flavour (segment_levels_f64).  The reference's segment
// forward gathers each vertex's padded in-edge row [Dmax]; the row's real
// in-edges in ordinal order are the listed row's in-edges in increasing
// slot j (the plan sorts a level's edges by destination, then id), so it
// reads the lists of dense_levels.cu (each level's rows with an in-edge
// or a cost, each row's in-edges as (flat edge id, flat source row)) and
// runs f64_row on them: the largest edge id of the selection is the
// reference's largest ordinal.  A level range lv0..lv1 with its own
// weights ([lv1 - lv0, Emax, S] a graph) makes one launch a weight chunk.
// Its bytes bound and chain are the dense loop's with 8-byte tie keys.
//
// The backtrace: one thread per scenario from its sink vsel follows cho ->
// esrc until cho < 0 (at most nlv steps), adding the chosen edges' elat
// rows.  They are message counts (integers), so the float64 sum is exact
// in any order and λ equals the reference's gather-and-sum bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int LV_THREADS = 1024;
constexpr int LV_KB = 8;                  // scenarios a block (see Design)
constexpr int EB = 2;                     // in-edges whose loads go together
constexpr int EC = 2;                     // in-edges a row keeps in registers
constexpr int BT_THREADS = 128;
constexpr float NEG_INF = -1e30f;
constexpr double BIG = 1e30;              // the float64 flavour's -BIG seed
constexpr double ATOL = 1e-12;            // core.dag's tie tolerance

__global__ void __launch_bounds__(LV_THREADS)
sparse_levels_f32_kernel(double* t, float* ssum, int* cho,
                         const double* __restrict__ w, long long w_base,
                         const long long* __restrict__ esrc,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ v_ptr,
                         const float* __restrict__ elat_sum,
                         const double* __restrict__ vcost,
                         int lv0, int lv1, int S, int kb) {
    const int kx = threadIdx.x % kb, ry = threadIdx.x / kb;
    const int nr = blockDim.x / kb;
    const int k = blockIdx.x * kb + kx;
    const bool live = k < S;
    const bool lam = ssum != nullptr;
    int r0 = v_ptr[lv0], r1 = v_ptr[lv0 + 1];
    for (int lv = lv0; lv < lv1; ++lv) {
        // the next level's row range, loaded before this level's chain
        const int r2 = lv + 2 <= lv1 ? v_ptr[lv + 2] : r1;
        for (int r = r0 + ry; live && r < r1; r += nr) {
            const int eb = row_ptr[r], ee = row_ptr[r + 1];
            float bv = NEG_INF, bk = NEG_INF;
            int bi = -1;
            double bc = 0.0;
            for (int e0 = eb; e0 < ee; e0 += EB) {
                long long src[EB];
                double wv[EB], tv[EB];
                float es[EB], sv[EB];
#pragma unroll
                for (int j = 0; j < EB; ++j) {     // past the run: repeat
                    const int e = min(e0 + j, ee - 1);     // its last edge
                    src[j] = esrc[e];
                    wv[j] = w[(long long)(e - w_base) * S + k];
                    es[j] = lam ? elat_sum[e] : 0.0f;
                }
#pragma unroll
                for (int j = 0; j < EB; ++j) {
                    tv[j] = t[src[j] * S + k];
                    sv[j] = lam ? ssum[src[j] * S + k] : 0.0f;
                }
#pragma unroll
                for (int j = 0; j < EB; ++j) {
                    if (e0 + j >= ee) break;
                    const double c64 = __dadd_rn(tv[j], wv[j]);
                    const float c32 = __double2float_rn(c64);
                    const float key = lam ? __fadd_rn(sv[j], es[j]) : 0.0f;
                    // edges come in increasing e, so e beats every
                    // earlier ordinal: a full tie goes to the later edge
                    if (c32 > bv || (c32 == bv && key >= bk)) {
                        bv = c32;
                        bk = key;
                        bi = e0 + j;
                        bc = c64;
                    }
                }
            }
            const bool lost = bv < 0.0f || (lam && bi < 0);
            const long long o = (long long)r * S + k;
            t[o] = __dadd_rn(lost ? 0.0 : bc, vcost[r]);
            if (lam) {
                ssum[o] = lost ? 0.0f : bk;
                cho[o] = lost ? -1 : bi;
            }
        }
        __syncthreads();
        r0 = r1;
        r1 = r2;
    }
}

// One in-edge of a row: its edge id (the index of its weight, its slope
// and the value cho records) and its source row.
struct InEdge {
    int e;
    long long src;
};

// The sparse layout: row r's in-edges are the run [eb, eb + n) of the
// plan's edges, each one's source in esrc.
struct RunEdges {
    const long long* __restrict__ esrc;
    int eb;
    __device__ __forceinline__ InEdge operator()(int j) const {
        return {eb + j, esrc[eb + j]};
    }
};

// The segment layout: listed row q's in-edges are the run in_edges[pb ..
// pb + n) (run = in_edges + pb) as (flat edge id lv·Emax + j, flat source
// row), in increasing slot j.
struct ListEdges {
    const int2* __restrict__ run;
    __device__ __forceinline__ InEdge operator()(int j) const {
        const int2 ie = run[j];
        return {ie.x, ie.y};
    }
};

// The float64 candidate of an in-edge for scenario k.
__device__ __forceinline__ double f64_cand(const double* t,
                                           const double* __restrict__ w,
                                           long long w_base, InEdge ie,
                                           int S, int k) {
    return __dadd_rn(t[ie.src * S + k],
                     w[(long long)(ie.e - w_base) * S + k]);
}

// The float64 row body, the one implementation of core.dag's ATOL rules
// (header, "The float64 flavour"), which both float64 level loops call:
// row o = row·S + k of scenario k, its n in-edges in(0) .. in(n - 1) in
// increasing edge id, its vertex cost *vc.  Writes t[o] and, in λ mode
// (ssum set), ssum[o] and cho[o].
template <class Edges>
__device__ __forceinline__ void f64_row(double* t, double* ssum, int* cho,
                                        const double* __restrict__ w,
                                        long long w_base,
                                        const double* __restrict__ elat_sum,
                                        const double* __restrict__ vc,
                                        long long o, const Edges& in, int n,
                                        int S, int k) {
    const bool lam = ssum != nullptr;
    const double ninf = -__longlong_as_double(0x7ff0000000000000LL);  // -inf
    double m = ninf;
    int ch = -1;
    double cw = 0.0;
    if (n <= EC) {
        // every in-edge in registers: the loads of all of them issued
        // together, then the three passes
        InEdge ie[EC];
        double c[EC], cs[EC];
#pragma unroll
        for (int j = 0; j < EC; ++j)
            if (j < n) ie[j] = in(j);
#pragma unroll
        for (int j = 0; j < EC; ++j)
            if (j < n) {
                c[j] = f64_cand(t, w, w_base, ie[j], S, k);
                if (lam)
                    cs[j] = __dadd_rn(ssum[ie[j].src * S + k],
                                      elat_sum[ie[j].e]);
            }
#pragma unroll
        for (int j = 0; j < EC; ++j)
            if (j < n && c[j] > m) m = c[j];
        const double ts = m < 0.0 ? 0.0 : m;
        t[o] = __dadd_rn(ts, *vc);
        if (lam) {
            const double h = __dsub_rn(ts, ATOL);
            double best = -BIG;
#pragma unroll
            for (int j = 0; j < EC; ++j)
                if (j < n && c[j] >= h && cs[j] > best) best = cs[j];
            const double bb = __dsub_rn(best, ATOL);
#pragma unroll
            for (int j = 0; j < EC; ++j)
                if (j < n && c[j] >= h && cs[j] >= bb) {
                    ch = ie[j].e;
                    cw = cs[j];
                }
        }
    } else {
        for (int j = 0; j < n; ++j) {
            const double c = f64_cand(t, w, w_base, in(j), S, k);
            if (c > m) m = c;
        }
        const double ts = m < 0.0 ? 0.0 : m;
        t[o] = __dadd_rn(ts, *vc);
        if (lam) {
            const double h = __dsub_rn(ts, ATOL);
            double best = -BIG;
            for (int j = 0; j < n; ++j) {
                const InEdge ie = in(j);
                if (f64_cand(t, w, w_base, ie, S, k) < h) continue;
                const double cs = __dadd_rn(ssum[ie.src * S + k],
                                            elat_sum[ie.e]);
                if (cs > best) best = cs;
            }
            const double bb = __dsub_rn(best, ATOL);
            for (int j = 0; j < n; ++j) {
                const InEdge ie = in(j);
                if (f64_cand(t, w, w_base, ie, S, k) < h) continue;
                const double cs = __dadd_rn(ssum[ie.src * S + k],
                                            elat_sum[ie.e]);
                if (cs >= bb) {
                    ch = ie.e;
                    cw = cs;
                }
            }
        }
    }
    if (lam) {
        ssum[o] = ch < 0 ? 0.0 : cw;
        cho[o] = ch;
    }
}

__global__ void __launch_bounds__(LV_THREADS)
sparse_levels_f64_kernel(double* t, double* ssum, int* cho,
                         const double* __restrict__ w, long long w_base,
                         const long long* __restrict__ esrc,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ v_ptr,
                         const double* __restrict__ elat_sum,
                         const double* __restrict__ vcost,
                         int lv0, int lv1, int S, int kb) {
    const int kx = threadIdx.x % kb, ry = threadIdx.x / kb;
    const int nr = blockDim.x / kb;
    const int k = blockIdx.x * kb + kx;
    const bool live = k < S;
    int r0 = v_ptr[lv0], r1 = v_ptr[lv0 + 1];
    for (int lv = lv0; lv < lv1; ++lv) {
        const int r2 = lv + 2 <= lv1 ? v_ptr[lv + 2] : r1;
        for (int r = r0 + ry; live && r < r1; r += nr) {
            const int eb = row_ptr[r];
            f64_row(t, ssum, cho, w, w_base, elat_sum, vcost + r,
                    (long long)r * S + k, RunEdges{esrc, eb},
                    row_ptr[r + 1] - eb, S, k);
        }
        __syncthreads();
        r0 = r1;
        r1 = r2;
    }
}

// The segment forward's level loop: levels lv0..lv1-1 of a plan's
// per-edge view (or of G packed plans, graph g on blockIdx.y, where only
// the pointers move), in dense_levels_f32's indexing: t, ssum and cho
// [nflat, S] per graph, flat row lv·Vmax + i; level lv's listed rows
// rows[lv_ptr[lv] .. lv_ptr[lv+1]), each one's in-edges in_edges[row_ptr[q]
// .. row_ptr[q+1]) as (flat edge id, flat source row); w holds levels
// lv0..lv1-1 ([lv1 - lv0, Emax, S] per graph, flat edge lv0·Emax first),
// elat_sum [nlv_p·Emax] and vcost [nlv_p·Vmax] per graph.  Each listed row
// goes through f64_row; an unlisted row (no in-edge, no cost) keeps the
// fresh state, which is what the row body would write (t 0, ssum 0, cho
// -1).  The bound and the design are the sparse kernels' (header).
__global__ void __launch_bounds__(LV_THREADS)
segment_levels_f64_kernel(double* t, double* ssum, int* cho,
                          const double* __restrict__ w,
                          const int* __restrict__ lv_ptr,
                          const int* __restrict__ rows,
                          const int* __restrict__ row_ptr,
                          const int2* __restrict__ in_edges,
                          const double* __restrict__ elat_sum,
                          const double* __restrict__ vcost, int lv0, int lv1,
                          int nlv_p, int nflat, int Vmax, int Emax, int NR,
                          int NE, int S, int kb) {
    const bool lam = ssum != nullptr;
    {   // graph g = blockIdx.y: only the pointers move
        const long long g = blockIdx.y;
        const long long st = g * nflat * S;
        t += st;
        // branch-free (null + 0 in values mode): with an if, ptxas spilled
        // 12 B at the 64 registers a 1,024-thread block leaves a thread
        ssum += lam ? st : 0;
        cho += lam ? st : 0;
        w += g * (lv1 - lv0) * Emax * S;
        lv_ptr += g * (nlv_p + 1);
        rows += g * NR;
        row_ptr += g * (NR + 1);
        in_edges += g * NE;
        elat_sum += g * nlv_p * Emax;
        vcost += g * nlv_p * Vmax;
    }
    const int kx = threadIdx.x % kb, ry = threadIdx.x / kb;
    const int nr = blockDim.x / kb;
    const int k = blockIdx.x * kb + kx;
    const bool live = k < S;
    const long long w_base = (long long)lv0 * Emax;
    int q0 = lv_ptr[lv0], q1 = lv_ptr[lv0 + 1];
    for (int lv = lv0; lv < lv1; ++lv) {
        const int q2 = lv + 2 <= lv1 ? lv_ptr[lv + 2] : q1;
        if (q0 < q1) {                    // the same for the whole block
            for (int q = q0 + ry; live && q < q1; q += nr) {
                const int r = rows[q];
                const int pb = row_ptr[q];
                f64_row(t, ssum, cho, w, w_base, elat_sum, vcost + r,
                        (long long)r * S + k, ListEdges{in_edges + pb},
                        row_ptr[q + 1] - pb, S, k);
            }
            __syncthreads();
        }
        q0 = q1;
        q1 = q2;
    }
}

__global__ void __launch_bounds__(BT_THREADS)
sparse_backtrace_kernel(const long long* __restrict__ vsel,
                        const int* __restrict__ cho,
                        const long long* __restrict__ esrc,
                        const double* __restrict__ elat,
                        double* __restrict__ lam, int S, int nc, int nlv) {
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= S) return;
    double* out = lam + (long long)k * nc;
    for (int c = 0; c < nc; ++c) out[c] = 0.0;
    long long v = vsel[k];
    for (int i = 0; i < nlv; ++i) {
        const int e = cho[v * S + k];
        if (e < 0) break;
        const double* row = elat + (long long)e * nc;
        for (int c = 0; c < nc; ++c) out[c] = __dadd_rn(out[c], row[c]);
        v = esrc[e];
    }
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; the
// stream is the caller's cudaStream_t.  Each returns cudaGetLastError()
// after its launch.  The caller checks shapes, S >= 1, and that the runs of
// levels lv0..lv1-1 lie inside w (segment: G <= 65535, 0 <= lv0 < lv1 <=
// nlv_p, and the lists' invariants).  ssum and cho are both null (values
// mode) or both set (λ mode).
extern "C" int sparse_levels_f32(double* t, float* ssum, int* cho,
                                 const double* w, long long w_base,
                                 const long long* esrc, const int* row_ptr,
                                 const int* v_ptr, const float* elat_sum,
                                 const double* vcost, int lv0, int lv1,
                                 int S, void* stream) {
    int kb = LV_KB;                   // scenarios a block: LV_KB, or the
    while (kb > S) kb >>= 1;          // largest power of two <= S below it
    const int blocks = (S + kb - 1) / kb;
    sparse_levels_f32_kernel<<<blocks, LV_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        t, ssum, cho, w, w_base, esrc, row_ptr, v_ptr, elat_sum, vcost, lv0,
        lv1, S, kb);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_levels_f64(double* t, double* ssum, int* cho,
                                 const double* w, long long w_base,
                                 const long long* esrc, const int* row_ptr,
                                 const int* v_ptr, const double* elat_sum,
                                 const double* vcost, int lv0, int lv1,
                                 int S, void* stream) {
    int kb = LV_KB;
    while (kb > S) kb >>= 1;
    const int blocks = (S + kb - 1) / kb;
    sparse_levels_f64_kernel<<<blocks, LV_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        t, ssum, cho, w, w_base, esrc, row_ptr, v_ptr, elat_sum, vcost, lv0,
        lv1, S, kb);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_levels_f64(double* t, double* ssum, int* cho,
                                  const double* w, const int* lv_ptr,
                                  const int* rows, const int* row_ptr,
                                  const int* in_edges, const double* elat_sum,
                                  const double* vcost, int G, int lv0,
                                  int lv1, int nlv_p, int nflat, int Vmax,
                                  int Emax, int NR, int NE, int S,
                                  void* stream) {
    int kb = LV_KB;
    while (kb > S) kb >>= 1;
    const dim3 grid((S + kb - 1) / kb, G);
    segment_levels_f64_kernel<<<grid, LV_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        t, ssum, cho, w, lv_ptr, rows, row_ptr,
        reinterpret_cast<const int2*>(in_edges), elat_sum, vcost, lv0, lv1,
        nlv_p, nflat, Vmax, Emax, NR, NE, S, kb);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_backtrace(const long long* vsel, const int* cho,
                                const long long* esrc, const double* elat,
                                double* lam, int S, int nc, int nlv,
                                void* stream) {
    const int blocks = (S + BT_THREADS - 1) / BT_THREADS;
    sparse_backtrace_kernel<<<blocks, BT_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        vsel, cho, esrc, elat, lam, S, nc, nlv);
    return static_cast<int>(cudaGetLastError());
}
