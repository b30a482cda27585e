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
//                      "The float64 flavour" below), its inputs copied
//                      levels ahead into a ring in shared memory and the
//                      block's recent rows kept in a window there ("The
//                      float64 ring and window").
//   segment_levels_f64 every level of a segment forward (a compiled
//                      plan's per-edge view, solo or G packed plans, graph
//                      g on blockIdx.y) in one launch, each edge's weight
//                      formed in the kernel, each row through the same
//                      float64 row body as sparse_levels_f64 (f64_row), on
//                      its ring and window ("The segment flavour").
//   sparse_backtrace   the walk from each scenario's sink down its chosen
//                      in-edges, summing their elat rows (λ), one
//                      dependent load a step; G packed graphs in one launch.
//
// Replace, on the main path, the TPU kernel maxplus_slotlist_argmax_kernel
// (repro/kernels/maxplus/kernel.py:262) with the reference's level body
// around it (repro/sweep/engine.py:903-971), the reference's float64
// slot-list level body, which has no kernel (_make_sparse_one,
// repro/sweep/engine.py:749-851), the reference's segment level body,
// which has no kernel either (_make_segment_one's relax and choose,
// engine.py:222-251, a pure-jnp gather and max), and the reference's
// backtraces (engine.py:979-993, :627-642, :724-744).
//
// Layout.  Scenarios (S) are the contiguous axis of every [rows, S] array.
// t [nv_p, S] float64 end times, ssum [nv_p, S] float32 tie keys, cho
// [nv_p, S] int32 chosen in-edges and csrc [nv_p, S] int32 the chosen
// edges' source rows (-1 where cho is -1, so csrc == esrc[cho]) are
// updated in place.  A level lv owns the vertex slots [v_ptr[lv],
// v_ptr[lv+1]); row r's in-edges are the run [row_ptr[r], row_ptr[r+1]) of
// the plan's edges, in increasing edge index (the compiler sorts a level's
// edges by destination, and stage_sparse refuses a plan that is not so
// sorted), so level lv's edges are the run [row_ptr[v_ptr[lv]],
// row_ptr[v_ptr[lv+1]]).  w holds the chunk's float64 edge weights from
// edge w_base on, [*, S].
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
//   ssum[row] = lost ? 0 : key[winner];  cho[row] = lost ? -1 : winner;
//   csrc[row] = lost ? -1 : esrc[winner].
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
// rows written before the launch (8 + 4 B), and the rows' t, ssum, cho and
// csrc (8 + 4 + 4 + 4 B), plus the topology once.  The t[src] and
// ssum[src] of rows that the launch itself wrote are its own
// intermediates, which the bound does not count.  chip_smoke.py computes
// both for one weight chunk of its stencil.  Levels depend on each other:
// level lv's t[src] loads wait for level lv-1's stores, so a launch is
// also a chain of levels x (a dependent round trip and a barrier); the
// chain, not the bytes, sets the pace.
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
// (kb x 8 bytes of t).  In the float32 loop a row's in-edges are taken EB
// at a time with all their loads issued together (the stencil's rows have
// at most 2), so a row costs one chain of (row_ptr -> esrc -> t) however
// many in-edges it has.  kb trades rows a pass (nr) against blocks on the
// card (ceil(S / kb)); kb = 8 (32 blocks at S = 256) was the fastest of 2,
// 4, 8, 16 and 32 on an H100 (PERF.md, kernel table row 5).  Loading the
// next levels' row pointers and edges into registers one to four levels
// ahead did not shorten a level on the H100, as if each barrier waited for
// every load in flight; the float64 loop's ring below copies them with
// cp.async instead, which a barrier does not wait for.
//
// The float64 flavour (sparse_levels_f64).  Same layout and bound as above,
// with ssum and elat_sum in float64.  Per (row, scenario), in the order and
// rounding of core.dag and of the plain version (ref.sparse_levels_f64_ref):
//   cand = t[src] + w            (__dadd_rn) over the row's in-edges
//   m    = the max of the candidates, seeded -inf
//   ts   = max(m, 0);  t[row] = ts + vcost[row]   (__dadd_rn)
// and in λ mode, with ATOL = 1e-12:
//   hit  = cand >= ts - ATOL     (__dsub_rn; ts the clamped value)
//   cs   = ssum[src] + elat_sum[e]                (__dadd_rn)
//   best = the max of cs over the hits, seeded -1e30
//   sel  = hit && cs >= best - ATOL
//   cho[row] = the largest edge of sel (-1: none); ssum[row] = its cs, or 0;
//   csrc[row] = its source (-1: none).
// The ATOL rules need the level max before a hit is known, and the best
// slope before a selection is, so a row takes three passes over its
// in-edges.  A row of at most EC = 2 in-edges (every row of the stencils
// and of the traced steps) keeps its candidates and slopes in registers
// after the first pass; a longer row reads them again in passes two and
// three.  EC = 4 spilled at the 64 registers that 1,024 threads leave a
// thread.  The row body is one function, f64_row, which takes a row's
// in-edges and their values through an accessor (a sparse run on the ring
// and window below, RingEdges; a segment row's listed edges, whose weights
// it forms, SegEdges), so the ATOL rules exist once.
//
// The float64 ring and window (sparse_levels_f64).  A level of the
// float64 loop used to chain three dependent round trips before its
// barrier: row_ptr[r] -> esrc[e] -> t[src] / ssum[src] (1.9 us a level on
// phase 6's chunk).  Only t[src] and ssum[src] depend on earlier levels;
// the topology, the weights and the slopes are known before the launch.
// So, once the rows of level lv are done (their shared-memory reads then
// queue behind no copy), the block copies with cp.async the inputs of
// level lv + D (D = RING_D): the level's row pointers and vertex costs,
// its edges' sources and slopes and the block's kb scenarios of their
// weights, into slot (lv + D) mod (D + 1) of a ring in shared memory.
// The ranges come from a table of (first row, first edge) per level,
// loaded every TAB_LT levels.  Each level commits one copy group and waits,
// before its barrier, for the group of the next level only (cp.async.
// wait_group D - 1), so D - 1 levels of copies stay in flight across the
// barrier; D = 2 was as fast as 4 on an H100 (tools/levels_probe.py) and
// leaves the window the most room.  A level wider than a slot (SLOT_R
// rows, SLOT_E edges) reads the overflow from device memory inside the
// same kernel.  Beside the ring, a window keeps the t and ssum of the
// last W rows this block wrote (rows are level-ordered slots, row r at r
// mod W, which is kept from the level's first row without a division; W
// is what the block's shared memory holds beside the table and the ring,
// 13,386 rows at kb = 1, 6,572 at 2 and 1,462 at 8 on an H100): a source row
// written by this launch with src >= r1 - W (r1 the end of the current
// level) is read from the window, an older one from device memory.  Rows
// r >= r1 - W are written to the window as well as to device memory, so
// two rows of one level never share a window slot, and a level never
// overwrites a slot that it reads.  A level's chain becomes shared-memory
// reads, the f64_row arithmetic, the stores and one barrier; the
// arithmetic is f64_row's, so t, ssum, cho and csrc stay bit-equal to the
// plain version.  One block of 1,024 threads an SM, which the ring and the
// window fill.  A level is latency-bound, and its time grows with the
// block's work (kb rows' worth a row), so a block takes the fewest
// scenarios (kb = 1, 2, 4, 8) whose ceil(S / kb) blocks fit the card in
// one wave; that also gives the widest window.  On phase 6's stencil 8 %
// of the sources lie about one stencil iteration (~9,100 rows) back,
// within the window at kb = 1 only.  On an H100 (132 SMs) this width beat
// every other at S 128, 133, 192 and 256 (kb = 1 at S 128, kb = 2 above),
// the next best by 4-36 % and kb = 8 by 20-24 % above 132
// (tools/levels_probe.py).
//
// The segment flavour (segment_levels_f64).  The reference's segment
// forward gathers each vertex's padded in-edge row [Dmax]; the row's real
// in-edges in ordinal order are the listed row's in-edges in increasing
// slot j (the plan sorts a level's edges by destination, then id), so it
// reads the lists of dense_levels.cu (each level's rows with an in-edge
// or a cost, each row's in-edges in list order) and runs f64_row on them:
// the largest edge id of the selection is the reference's largest
// ordinal.  It takes no weights.  The listed edges' records are staged in
// list order, so a level's edges are one contiguous run: (flat edge id,
// flat source row, the source's listed row, gap class) as an int4, and
// (econst, egap, elat_sum, the elat row) as 3 + nc doubles; the listed
// rows' vertex costs too.  A block copies its kb scenarios' rows of Lmat
// and GSmat into shared memory once, and forms each weight per scenario
// from them with the plain version's ops in its order (seg_weight), so
// the weights equal _weights' bit for bit; the ring copies a level's
// records, which do not grow with kb, so the window keeps the rest (rows
// slotted by their listed index q).  One launch takes every level of a
// forward.  Bound: per scenario the listed rows' t, ssum, cho and csrc
// and the t and ssum of sources written before the launch; the records,
// the rows and the L and GS rows once (their bytes do not grow with S).
// The chain of levels sets the pace, as above.
//
// The link factor (segment_levels_f64, the congestion fixed point).  With
// a table ls [L lanes, nlinks + 1, S] of float64 link scales (scenarios
// contiguous, so a block's kb scenarios read adjacent words; the dummy bin
// nlinks holds 1.0), an in-edge's gap scale becomes GS[gc] * ls[link]
// before the weight's ops, in the reference's order (engine.py:224-233),
// each op rounded on its own:
//   ((GS[gc] * ls[link] - 1) * egap + econst) + (elat_0 * L_0 + ...)
// The edges' link ids (in_link [NE] int32, list order) ride the ring
// beside their records.  Without a table (ls null) the kernel skips the
// factor and copies no link id: a factor of 1.0 multiplies exactly, so a
// table of ones would give the same bits, but the plain forward should not
// pay its loads.  The kernel is one template, instantiated with and
// without the factor (LINKS), and the instantiation without it is the
// loop as it was before the factor, down to its parameters: the link
// table's pointers and count come in a last parameter (SegLinkTable) that
// is empty without the factor, and the row body's edges (SegEdges) carry
// the link members only with it.  A run-time test of ls in one
// instantiation cost the plain loop 10 % on phase 4's plan (0.930 against
// 0.840-0.846 ms on an H100), and a run-time branch to the link ids in
// the ring's copy loop 5 % (tools/levels_probe.py).
//
// Lanes (segment_levels_f64 and the backtrace).  One launch runs L lanes,
// lane y = blockIdx.y: K candidate-cost lanes of each of L / K structures
// (a plan, a packed plan's graph, a structure variant), lane y belonging
// to structure y / K (K = 1 and L = G is the packed forward).  A structure
// owns the lists, Lmat and GSmat; a lane owns its records erec (so its
// edge constants, gap shares and latency rows: the engine writes each
// lane's into its copy) and its state t, ssum, cho and csrc.  The in-edge
// records, which carry the gap class, are the structure's (Kc = K) or,
// where the lanes' gap classes differ, the lane's own copy (Kc = 1), and
// the walk's elat rows likewise (its K, the lanes a row set serves): lane
// y reads those of y / Kc.  Only the pointers move, so every lane runs
// the code of a solo forward of its structure with its own fields, and
// equals it bit for bit.  The block width rule counts all L x ceil(S /
// kb) blocks.

// The backtrace: one thread per scenario from its sink vsel follows its
// chosen edges until cho < 0 (at most nlv steps), adding their elat rows.
// A step loads cho[v] and csrc[v] together and moves to v = csrc[v], so
// the chain is one dependent load a step; the chosen edge's elat row is
// read beside the next step's loads, off the chain, and summed in
// registers (up to BT_NC classes).  The rows are message counts
// (integers), so the float64 sum is exact in any order and λ equals the
// reference's gather-and-sum bit for bit.  A packed forward's L lanes walk
// in one launch, lane y on blockIdx.y, reading its structure's elat.

#include <cuda_runtime.h>

namespace {

constexpr int LV_THREADS = 1024;
constexpr int LV_KB = 8;                  // scenarios a block (see Design)
constexpr int EB = 2;                     // in-edges whose loads go together
constexpr int EC = 2;                     // in-edges a row keeps in registers
constexpr int BT_THREADS = 128;
constexpr int BT_NC = 8;                  // λ classes a walk sums in registers
constexpr float NEG_INF = -1e30f;
constexpr double BIG = 1e30;              // the float64 flavour's -BIG seed
constexpr double ATOL = 1e-12;            // core.dag's tie tolerance

// the float64 ring and window (header).  Compile-time knobs, for timing
// the design's parts (tools/levels_probe.py builds the file with them):
// SL_RING_D the levels copied ahead; SL_SLOT_E and SL_SLOT_R 0, no ring
// (every input from device memory); SL_NO_WINDOW, every source row from
// device memory; SL_NO_ROW, no row body (wrong results: copies, waits and
// barriers only); SL_KB, a fixed block width; SL_SEG_THREADS, the segment
// loop's threads a block.  The package builds the file without them.
#ifndef SL_RING_D
#define SL_RING_D 2
#endif
#ifndef SL_SLOT_E
#define SL_SLOT_E 160
#endif
#ifndef SL_SLOT_R
#define SL_SLOT_R 128
#endif
#ifndef SL_SEG_THREADS
#define SL_SEG_THREADS 512
#endif
constexpr int SEG_THREADS = SL_SEG_THREADS;   // the segment loop's block
constexpr int RING_D = SL_RING_D;         // levels copied ahead
constexpr int RING_NS = RING_D + 1;       // slots
constexpr int SLOT_E = SL_SLOT_E;         // edges a slot holds
constexpr int SLOT_R = SL_SLOT_R;         // rows a slot holds
constexpr int TAB_LT = 256;               // levels between table loads
constexpr int TAB_N = TAB_LT + RING_D + 1;
constexpr int TAB_BYTES = (TAB_N * 8 + 15) / 16 * 16;

__global__ void __launch_bounds__(LV_THREADS)
sparse_levels_f32_kernel(double* t, float* ssum, int* cho, int* csrc,
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
            int bi = -1, bs = -1;
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
                        bs = (int)src[j];
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
                csrc[o] = lost ? -1 : bs;
            }
        }
        __syncthreads();
        r0 = r1;
        r1 = r2;
    }
}

// One in-edge of a row: its edge id (the value cho records) and its source
// row (the value csrc records).
struct InEdge {
    int e;
    long long src;
};

// Where a row's results go: t and ssum at o = row·S + k, cho and csrc at
// oc (o, or the row's index in the whole packed state when cho and csrc
// stay at their base).
struct GlobalOut {
    double* t;
    double* ssum;
    int* cho;
    int* csrc;
    long long o, oc;
    __device__ __forceinline__ void put_t(double v) const { t[o] = v; }
    __device__ __forceinline__ void put_lam(double s, int ch, int src) const {
        ssum[o] = s;
        cho[oc] = ch;
        csrc[oc] = src;
    }
};

// The float64 row body, the one implementation of core.dag's ATOL rules
// (header, "The float64 flavour"), which both float64 level loops call:
// a row's n in-edges in.edge(0) .. in.edge(n - 1) in increasing edge id,
// the j-th one's candidate in.cand(j, edge) and slope in.slope(j, edge),
// its vertex cost *vc.
// Writes t and, in λ mode, ssum, cho and csrc through out.  The selection
// is kept as the in-edge's position js, and its edge id and source are
// taken after the passes, so csrc costs the λ passes no register.
template <class Edges, class Out>
__device__ __forceinline__ void f64_row(const Edges& in, int n,
                                        const double* vc, bool lam,
                                        const Out& out) {
    const double ninf = -__longlong_as_double(0x7ff0000000000000LL);  // -inf
    double m = ninf;
    int js = -1;
    double cw = 0.0;
    if (n <= EC) {
        // every in-edge in registers: the loads of all of them issued
        // together, then the three passes
        InEdge ie[EC];
        double c[EC], cs[EC];
#pragma unroll
        for (int j = 0; j < EC; ++j)
            if (j < n) ie[j] = in.edge(j);
#pragma unroll
        for (int j = 0; j < EC; ++j)
            if (j < n) {
                c[j] = in.cand(j, ie[j]);
                if (lam) cs[j] = in.slope(j, ie[j]);
            }
#pragma unroll
        for (int j = 0; j < EC; ++j)
            if (j < n && c[j] > m) m = c[j];
        const double ts = m < 0.0 ? 0.0 : m;
        out.put_t(__dadd_rn(ts, *vc));
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
                    js = j;
                    cw = cs[j];
                }
            InEdge sel = ie[0];
#pragma unroll
            for (int j = 1; j < EC; ++j)
                if (js == j) sel = ie[j];
            if (js < 0)
                out.put_lam(0.0, -1, -1);
            else
                out.put_lam(cw, sel.e, (int)sel.src);
        }
    } else {
        for (int j = 0; j < n; ++j) {
            const double c = in.cand(j, in.edge(j));
            if (c > m) m = c;
        }
        const double ts = m < 0.0 ? 0.0 : m;
        out.put_t(__dadd_rn(ts, *vc));
        if (lam) {
            const double h = __dsub_rn(ts, ATOL);
            double best = -BIG;
            for (int j = 0; j < n; ++j) {
                const InEdge ie = in.edge(j);
                if (in.cand(j, ie) < h) continue;
                const double cs = in.slope(j, ie);
                if (cs > best) best = cs;
            }
            const double bb = __dsub_rn(best, ATOL);
            for (int j = 0; j < n; ++j) {
                const InEdge ie = in.edge(j);
                if (in.cand(j, ie) < h) continue;
                const double cs = in.slope(j, ie);
                if (cs >= bb) {
                    js = j;
                    cw = cs;
                }
            }
            if (js < 0) {
                out.put_lam(0.0, -1, -1);
            } else {
                const InEdge sel = in.edge(js);
                out.put_lam(cw, sel.e, (int)sel.src);
            }
        }
    }
}

// -- the float64 ring and window ---------------------------------------------

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

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One ring slot: a level's inputs for the block's kb scenarios.  In bytes
// from the slot's start: w [SLOT_E][kb] f64, esrc [SLOT_E] i64, elat_sum
// [SLOT_E] f64, vcost [SLOT_R] f64, row_ptr [SLOT_R + 1] i32.
__host__ __device__ constexpr int slot_bytes(int kb) {
    return SLOT_E * kb * 8 + SLOT_E * 8 * 2 + SLOT_R * 8
           + ((SLOT_R + 1) * 4 + 15) / 16 * 16;
}

// The window's rows at kb for a block of smem_max bytes of shared memory:
// what the level table and the ring leave, as t and ssum (16 B) of kb
// scenarios a row, an even count of elements (the ring stays 16-B aligned).
int window_rows(int kb, int smem_max) {
    const int elems = (smem_max - TAB_BYTES - RING_NS * slot_bytes(kb)) / 16;
    return elems / kb / 2 * 2;
}

// The dynamic shared memory of sparse_levels_f64: the level table, the
// window's t and ssum, the ring.
int ring_smem_bytes(int kb, int W) {
    return TAB_BYTES + 2 * W * kb * 8 + RING_NS * slot_bytes(kb);
}

struct Slot {
    double* w;
    long long* es;
    double* el;
    double* vc;
    int* rp;
    __device__ __forceinline__ Slot(unsigned char* p, int kb)
        : w(reinterpret_cast<double*>(p)),
          es(reinterpret_cast<long long*>(p + SLOT_E * kb * 8)),
          el(reinterpret_cast<double*>(p + SLOT_E * kb * 8 + SLOT_E * 8)),
          vc(reinterpret_cast<double*>(p + SLOT_E * kb * 8 + SLOT_E * 16)),
          rp(reinterpret_cast<int*>(p + SLOT_E * kb * 8 + SLOT_E * 16
                                    + SLOT_R * 8)) {}
};

// A row's in-edges and their values from the ring slot of its level (edges
// e0 .. e0 + SLOT_E - 1 of the level; later ones from device memory) and
// from the window (source rows >= lo; older ones from device memory).
struct RingEdges {
    const long long* __restrict__ esrc;
    const double* t;
    const double* ssum;
    const double* __restrict__ w;
    const double* __restrict__ elat_sum;
    Slot sl;
    const double* wt;
    const double* ws;
    long long w_base;
    int e0, eb, lo, r0, m0, W, kb, kx, S, k;
    __device__ __forceinline__ InEdge edge(int j) const {
        const int e = eb + j, x = e - e0;
        return {e, x < SLOT_E ? sl.es[x] : esrc[e]};
    }
    // the window element of source row src >= lo: src mod W, from the
    // level's first row r0 (at m0 = r0 mod W) and r0 - src in [1, W]
    __device__ __forceinline__ int win(long long src) const {
        const int m = m0 - (r0 - (int)src);
        return (m < 0 ? m + W : m) * kb + kx;
    }
    __device__ __forceinline__ double cand(int, InEdge ie) const {
        const int x = ie.e - e0;
        const double tv = ie.src >= lo ? wt[win(ie.src)] : t[ie.src * S + k];
        const double wv = x < SLOT_E
            ? sl.w[x * kb + kx] : w[(long long)(ie.e - w_base) * S + k];
        return __dadd_rn(tv, wv);
    }
    __device__ __forceinline__ double slope(int, InEdge ie) const {
        const int x = ie.e - e0;
        const double sv = ie.src >= lo ? ws[win(ie.src)]
                                       : ssum[ie.src * S + k];
        return __dadd_rn(sv, x < SLOT_E ? sl.el[x] : elat_sum[ie.e]);
    }
};

// A row's results to device memory and, for a row that later levels may
// read from the window (win), to the window slot wi too.
struct RingOut {
    GlobalOut g;
    double* wt;
    double* ws;
    int wi;
    bool win;
    __device__ __forceinline__ void put_t(double v) const {
        g.put_t(v);
        if (win) wt[wi] = v;
    }
    __device__ __forceinline__ void put_lam(double s, int ch, int src) const {
        g.put_lam(s, ch, src);
        if (win) ws[wi] = s;
    }
};

// tab[i] = (first row, first edge) of level base + i, for the levels up to
// lv1 (the end of level lv1 - 1) that the table holds.
__device__ __forceinline__ void load_table(int2* tab,
                                           const int* __restrict__ v_ptr,
                                           const int* __restrict__ row_ptr,
                                           int base, int lv1) {
    for (int i = threadIdx.x; i < TAB_N && base + i <= lv1; i += blockDim.x) {
        const int r = v_ptr[base + i];
        tab[i] = make_int2(r, row_ptr[r]);
    }
}

__global__ void __launch_bounds__(LV_THREADS)
sparse_levels_f64_kernel(double* t, double* ssum, int* cho, int* csrc,
                         const double* __restrict__ w, long long w_base,
                         const long long* __restrict__ esrc,
                         const int* __restrict__ row_ptr,
                         const int* __restrict__ v_ptr,
                         const double* __restrict__ elat_sum,
                         const double* __restrict__ vcost,
                         int lv0, int lv1, int S, int kb, int W) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int ks = __ffs(kb) - 1;             // kb is a power of two
    const int kx = threadIdx.x & (kb - 1), ry = threadIdx.x >> ks;
    const int nr = blockDim.x >> ks;
    const int k0 = blockIdx.x * kb, k = k0 + kx;
    const bool live = k < S;
    const bool lam = ssum != nullptr;
    int2* tab = reinterpret_cast<int2*>(smem);
    double* wt = reinterpret_cast<double*>(smem + TAB_BYTES);
    double* ws = wt + W * kb;
    unsigned char* ring = reinterpret_cast<unsigned char*>(ws + W * kb);
    const int sb = slot_bytes(kb);

    int base = lv0;
    load_table(tab, v_ptr, row_ptr, base, lv1);
    __syncthreads();
    const int R0 = tab[0].x;                  // the launch's first row

    // copy level X's inputs into its slot: one copy group
    auto issue = [&](int X) {
        if (X < lv1) {
            const int2 a = tab[X - base], b = tab[X + 1 - base];
            const int r0 = a.x, e0 = a.y;
            const int nR = min(b.x - r0, SLOT_R), nE = min(b.y - e0, SLOT_E);
            const Slot sl(ring + ((X - lv0) % RING_NS) * sb, kb);
            const int nw = nE << ks, nel = lam ? nE : 0;
            const int total = nw + nE + nel + nR + nR + 1;
            for (int q = threadIdx.x; q < total; q += blockDim.x) {
                int u = q;
                if (u < nw) {
                    const int j = u & (kb - 1);
                    if (k0 + j < S)
                        cp_async8(sl.w + u,
                                  w + (long long)(e0 + (u >> ks) - w_base) * S
                                      + k0 + j);
                    continue;
                }
                u -= nw;
                if (u < nE) { cp_async8(sl.es + u, esrc + e0 + u); continue; }
                u -= nE;
                if (u < nel) {
                    cp_async8(sl.el + u, elat_sum + e0 + u);
                    continue;
                }
                u -= nel;
                if (u < nR) { cp_async8(sl.vc + u, vcost + r0 + u); continue; }
                u -= nR;
                cp_async4(sl.rp + u, row_ptr + r0 + u);
            }
        }
        cp_async_commit();
    };

    for (int j = 0; j < RING_D; ++j) issue(lv0 + j);
    cp_async_wait<RING_D - 1>();
    __syncthreads();
    int m0 = R0 % W;                          // r0 mod W, kept level by level
    for (int lv = lv0; lv < lv1; ++lv) {
        if (lv + RING_D + 1 - base >= TAB_N) {    // block-uniform
            base = lv;
            load_table(tab, v_ptr, row_ptr, base, lv1);
            __syncthreads();
        }
        const int2 a = tab[lv - base];
        const int r0 = a.x, r1 = tab[lv + 1 - base].x;
        const Slot sl(ring + ((lv - lv0) % RING_NS) * sb, kb);
#ifdef SL_NO_WINDOW
        const int lo = 0x7fffffff;
#else
        const int lo = max(R0, r1 - W);
#endif
        for (int r = r0 + ry; live && r < r1; r += nr) {
            const int i = r - r0;
            int eb, ee;
            const double* vc;
            if (i < SLOT_R) {
                eb = sl.rp[i];
                ee = sl.rp[i + 1];
                vc = sl.vc + i;
            } else {
                eb = row_ptr[r];
                ee = row_ptr[r + 1];
                vc = vcost + r;
            }
            const RingEdges in{esrc, t, ssum, w, elat_sum, sl, wt, ws, w_base,
                               a.y, eb, lo, r0, m0, W, kb, kx, S, k};
            const long long o = (long long)r * S + k;
            int m = m0 + i;                   // r mod W (a row r >= lo)
            while (m >= W) m -= W;
            const RingOut out{{t, ssum, cho, csrc, o, o}, wt, ws,
                              (m << ks) + kx, r >= lo};
#ifndef SL_NO_ROW
            f64_row(in, ee - eb, vc, lam, out);
#endif
        }
        // the copies of level lv + D go out after the level's rows, so the
        // rows' shared-memory reads do not queue behind them; they land in
        // the slot level lv - 1 left
        issue(lv + RING_D);
        cp_async_wait<RING_D - 1>();           // level lv + 1's copies
        __syncthreads();
        m0 += r1 - r0;
        while (m0 >= W) m0 -= W;
    }
    cp_async_wait<0>();
}

// -- the segment level loop ---------------------------------------------------

// One ring slot of the segment loop: a level's listed rows and in-edge
// records, the same for every scenario (no weight is copied: the kernel
// forms it).  In bytes from the slot's start, for se edges of R = 3 + nc
// doubles a record: rec [se][R] f64 (econst, egap, elat_sum, the elat
// row), vcost [SLOT_R] f64, ie [se] int4 (flat edge id, flat source row,
// the source's listed row or -1, the gap class), rows [SLOT_R] i32,
// row_ptr [SLOT_R + 1] i32 (padded to 16 B), and with the link factor lk
// [se] i32 (each edge's link id; 0 bytes without), which lk() finds at a
// fixed offset from rp: a pointer more in the row body spilled 8 B at the
// 128 registers of 512 threads.  se is even, so each part is 16-B
// aligned.
constexpr int SEG_RP_INTS = ((SLOT_R + 1) * 4 + 15) / 16 * 4;

__host__ __device__ inline int seg_slot_bytes(int se, int R, bool links) {
    return se * R * 8 + SLOT_R * 8 + se * 16 + SLOT_R * 4 + SEG_RP_INTS * 4
           + (links ? (se * 4 + 15) / 16 * 16 : 0);
}

struct SegSlot {
    double* rec;
    double* vc;
    int4* ie;
    int* rw;
    int* rp;
    __device__ __forceinline__ SegSlot(unsigned char* p, int se, int R)
        : rec(reinterpret_cast<double*>(p)),
          vc(reinterpret_cast<double*>(p + se * R * 8)),
          ie(reinterpret_cast<int4*>(p + se * R * 8 + SLOT_R * 8)),
          rw(reinterpret_cast<int*>(p + se * R * 8 + SLOT_R * 8 + se * 16)),
          rp(reinterpret_cast<int*>(p + se * R * 8 + SLOT_R * 12
                                    + se * 16)) {}
    __device__ __forceinline__ int* lk() const { return rp + SEG_RP_INTS; }
};

// The link table of one launch (segment_levels_f64_kernel's last
// parameter): each edge's link in_link [G?, NE] and the lanes' scales ls
// [L, nl1, S]; empty without the factor, so that instantiation's
// parameters are the loop's without it.
template <bool LINKS> struct SegLinkTable {
    const int* __restrict__ in_link;
    const double* __restrict__ ls;
    int nl1;
};
template <> struct SegLinkTable<false> {};

// A row body's view of the link table, scenario k of its lane: the edges'
// links lk (in_link; the ring slot holds its level's) and the scales lsk
// (ls + k, a link's at lsk[link * S]); empty without the factor.
template <bool LINKS> struct SegEdgeLinks {
    const int* __restrict__ lk;
    const double* __restrict__ lsk;
};
template <> struct SegEdgeLinks<false> {};

// An in-edge's weight for one scenario, from its record rec (econst, egap,
// elat_sum, elat [nc]) and gap class gc, and the scenario's rows of Lmat
// (Lk [nc]) and GSmat (Gk [ngc]): the ops of the plain version's _weights
// in its order, each one rounded on its own (no FMA can form),
//   ((gs - 1) * egap + econst) + (elat_0 * L_0 + elat_1 * L_1 + ...)
// with the gap scale gs = Gk[gc], times the link's scale lsf with the
// link factor (LINKS; lsf unused without).
template <bool LINKS>
__device__ __forceinline__ double seg_weight(const double* rec, int gc,
                                             const double* Lk,
                                             const double* Gk, int nc,
                                             double lsf) {
    double gs = Gk[gc];
    if constexpr (LINKS) gs = __dmul_rn(gs, lsf);
    const double w = __dadd_rn(__dmul_rn(__dsub_rn(gs, 1.0), rec[1]),
                               rec[0]);
    double lat = __dmul_rn(rec[3], Lk[0]);
    for (int c = 1; c < nc; ++c)
        lat = __dadd_rn(lat, __dmul_rn(rec[3 + c], Lk[c]));
    return __dadd_rn(w, lat);
}

// A segment row's in-edges, the listed edges eb .. eb + n - 1, with their
// values for scenario k: the records from the ring slot of the row's level
// (its edges e0 .. e0 + se - 1; later ones from device memory), the weight
// formed from them and the block's L and GS tables (Lk, Gk) and, with the
// link factor, the edge's link scale (SegEdgeLinks), t[src] and ssum[src]
// from the window (a source listed at q >= lo) or device memory.
template <bool LINKS>
struct SegEdges : SegEdgeLinks<LINKS> {
    const double* t;
    const double* ssum;
    const int4* __restrict__ ie;
    const double* __restrict__ rec;
    SegSlot sl;
    const double* wt;
    const double* ws;
    const double* Lk;
    const double* Gk;
    int eb, e0, se, R, nc, lo, q0, m0, W, kb, kx, S, k;
    __device__ __forceinline__ int4 rec_ie(int j) const {
        const int x = eb + j - e0;
        return x < se ? sl.ie[x] : ie[eb + j];
    }
    __device__ __forceinline__ InEdge edge(int j) const {
        const int4 v = rec_ie(j);
        return {v.x, v.y};
    }
    __device__ __forceinline__ const double* record(int j) const {
        const int x = eb + j - e0;
        return x < se ? sl.rec + x * R : rec + (long long)(eb + j) * R;
    }
    // the window element of listed row q >= lo (RingEdges::win)
    __device__ __forceinline__ int win(int q) const {
        const int m = m0 - (q0 - q);
        return (m < 0 ? m + W : m) * kb + kx;
    }
    __device__ __forceinline__ double cand(int j, InEdge e) const {
        const int4 v = rec_ie(j);
        const double tv = v.z >= lo ? wt[win(v.z)] : t[e.src * S + k];
        double lsf = 1.0;
        if constexpr (LINKS) {
            const int x = eb + j - e0;
            const int link = x < se ? sl.lk()[x] : this->lk[eb + j];
            lsf = this->lsk[(long long)link * S];
        }
        return __dadd_rn(tv, seg_weight<LINKS>(record(j), v.w, Lk, Gk, nc,
                                               lsf));
    }
    __device__ __forceinline__ double slope(int j, InEdge e) const {
        const int q = rec_ie(j).z;
        const double sv = q >= lo ? ws[win(q)] : ssum[e.src * S + k];
        return __dadd_rn(sv, record(j)[2]);
    }
};

// The segment forward's level loop: levels lv0..lv1-1 of a plan's
// per-edge view (or of G packed plans, graph g on blockIdx.y, where only
// the pointers move), with every in-edge's weight formed in the kernel.
// t, ssum, cho and csrc [nflat, S] per graph, flat row lv·Vmax + i; Lmat
// [S, nc] and GSmat [S, ngc] per graph; level lv's listed rows q in
// lv_ptr[lv] .. lv_ptr[lv+1] - 1, each one's flat row rows[q], vertex
// cost rcost[q] and in-edges row_ptr[q] .. row_ptr[q+1] - 1 in increasing
// slot, each edge p's records in_edges[p] (int4) and erec[p] (R doubles).
// Each listed row goes through f64_row; an unlisted row (no in-edge, no
// cost) keeps the fresh state, which is what the row body would write (t
// 0, ssum 0, cho -1, csrc -1).  With the link factor (header), the link
// table lx (SegLinkTable).  The design is sparse_levels_f64's (header,
// "The float64 ring and window") on listed rows and listed edges: the
// level table holds (first listed row, first edge), the ring copies a
// level's row and edge records D levels ahead, the window keeps the last W
// listed rows' t and ssum (slot q mod W); the block first copies its kb
// scenarios' L and GS rows into shared memory.  512 threads a block: at
// 1,024 (64 registers a thread) the weight arithmetic spilled 104 B, and
// 512 (no spill, 128 registers) took phase 4's plan from 1.51 to 0.89 ms
// on an H100 (tools/levels_probe.py).
template <bool LINKS>
__global__ void __launch_bounds__(SEG_THREADS)
segment_levels_f64_kernel(double* t, double* ssum, int* cho, int* csrc,
                          const double* __restrict__ Lmat,
                          const double* __restrict__ GSmat,
                          const int* __restrict__ lv_ptr,
                          const int* __restrict__ rows,
                          const int* __restrict__ row_ptr,
                          const int4* __restrict__ in_edges,
                          const double* __restrict__ erec,
                          const double* __restrict__ rcost, int lv0,
                          int lv1, int nlv_p, int nflat, int NR, int NE,
                          int S, int nc, int ngc, int K, int Kc, int kb,
                          int W, int se, SegLinkTable<LINKS> lx) {
    extern __shared__ __align__(16) unsigned char smem[];
    const bool lam = ssum != nullptr;
    constexpr bool links = LINKS;
    const int R = 3 + nc;
    {   // lane y = blockIdx.y of structure g = y / K ("Lanes"): only the
        // pointers move, but for cho and csrc, which are only written: a
        // row's index carries their lane offset
        const long long y = blockIdx.y, g = y / K;
        const long long st = y * nflat * S;
        t += st;
        // branch-free (null + 0 in values mode)
        ssum += lam ? st : 0;
        Lmat += g * S * nc;
        GSmat += g * S * ngc;
        lv_ptr += g * (nlv_p + 1);
        rows += g * NR;
        rcost += g * NR;
        row_ptr += g * (NR + 1);
        in_edges += y / Kc * NE;
        erec += y * NE * R;
        if constexpr (LINKS) {
            lx.in_link += g * NE;
            lx.ls += y * lx.nl1 * S;
        }
    }
    const int ks = __ffs(kb) - 1;             // kb is a power of two
    const int kx = threadIdx.x & (kb - 1), ry = threadIdx.x >> ks;
    const int nr = blockDim.x >> ks;
    const int k0 = blockIdx.x * kb, k = k0 + kx;
    const bool live = k < S;
    int2* tab = reinterpret_cast<int2*>(smem);
    double* Lt = reinterpret_cast<double*>(smem + TAB_BYTES);
    double* Gt = Lt + kb * nc;
    double* wt = reinterpret_cast<double*>(
        smem + TAB_BYTES + (kb * (nc + ngc) * 8 + 15) / 16 * 16);
    double* ws = wt + W * kb;
    unsigned char* ring = reinterpret_cast<unsigned char*>(ws + W * kb);
    const int sb = seg_slot_bytes(se, R, links);

    int base = lv0;
    load_table(tab, lv_ptr, row_ptr, base, lv1);
    {   // the block's scenarios' rows of Lmat and GSmat
        const int nk = min(S - k0, kb);
        for (int i = threadIdx.x; i < nk * nc; i += blockDim.x)
            Lt[i] = Lmat[(long long)k0 * nc + i];
        for (int i = threadIdx.x; i < nk * ngc; i += blockDim.x)
            Gt[i] = GSmat[(long long)k0 * ngc + i];
    }
    __syncthreads();
    const int Q0 = tab[0].x;                  // the launch's first listed row
    const int Qend = lv_ptr[lv1];             // and its end

    // copy level X's records into its slot: one copy group
    auto issue = [&](int X) {
        if (X < lv1) {
            const int2 a = tab[X - base], b = tab[X + 1 - base];
            const int q0 = a.x, e0 = a.y;
            const int nR = min(b.x - q0, SLOT_R), nE = min(b.y - e0, se);
            const SegSlot sl(ring + ((X - lv0) % RING_NS) * sb, se, R);
            const int nrec = nE * R;
            const int total = nrec + nE + 3 * nR + 1 + (links ? nE : 0);
            for (int u = threadIdx.x; u < total; u += blockDim.x) {
                int v = u;
                if (v < nrec) {
                    cp_async8(sl.rec + v, erec + (long long)e0 * R + v);
                    continue;
                }
                v -= nrec;
                if (v < nE) { cp_async16(sl.ie + v, in_edges + e0 + v); continue; }
                v -= nE;
                if (v < nR) { cp_async8(sl.vc + v, rcost + q0 + v); continue; }
                v -= nR;
                if (v < nR) { cp_async4(sl.rw + v, rows + q0 + v); continue; }
                v -= nR;
                if (!links || v <= nR) {
                    cp_async4(sl.rp + v, row_ptr + q0 + v);
                    continue;
                }
                if constexpr (LINKS) {
                    v -= nR + 1;
                    cp_async4(sl.lk() + v, lx.in_link + e0 + v);
                }
            }
        }
        cp_async_commit();
    };

    for (int j = 0; j < RING_D; ++j) issue(lv0 + j);
    cp_async_wait<RING_D - 1>();
    __syncthreads();
    int m0 = Q0 % W;                          // q0 mod W, kept level by level
    for (int lv = lv0; lv < lv1; ++lv) {
        if (lv + RING_D + 1 - base >= TAB_N) {    // block-uniform
            base = lv;
            load_table(tab, lv_ptr, row_ptr, base, lv1);
            __syncthreads();
        }
        const int2 a = tab[lv - base];
        const int q0 = a.x, q1 = tab[lv + 1 - base].x;
        if (q0 >= Qend) break;        // block-uniform: no listed row is left
        const SegSlot sl(ring + ((lv - lv0) % RING_NS) * sb, se, R);
#ifdef SL_NO_WINDOW
        const int lo = 0x7fffffff;
#else
        const int lo = max(Q0, q1 - W);
#endif
        for (int q = q0 + ry; live && q < q1; q += nr) {
            const int i = q - q0;
            int r, eb, ee;
            const double* vc;
            if (i < SLOT_R) {
                r = sl.rw[i];
                eb = sl.rp[i];
                ee = sl.rp[i + 1];
                vc = sl.vc + i;
            } else {
                r = rows[q];
                eb = row_ptr[q];
                ee = row_ptr[q + 1];
                vc = rcost + q;
            }
            SegEdgeLinks<LINKS> el{};
            if constexpr (LINKS) el = {lx.in_link, lx.ls + k};
            const SegEdges<LINKS> in{el, t, ssum, in_edges, erec, sl, wt, ws,
                                     Lt + kx * nc, Gt + kx * ngc, eb, a.y, se,
                                     R, nc, lo, q0, m0, W, kb, kx, S, k};
            const long long o = (long long)r * S + k;
            int m = m0 + i;                   // q mod W (a row q >= lo)
            while (m >= W) m -= W;
            const RingOut out{{t, ssum, cho, csrc, o,
                               ((long long)blockIdx.y * nflat + r) * S + k},
                              wt, ws, (m << ks) + kx, q >= lo};
#ifndef SL_NO_ROW
            f64_row(in, ee - eb, vc, lam, out);
#endif
        }
        // level lv + D's copies, after the level's rows (as in
        // sparse_levels_f64), into the slot level lv - 1 left
        issue(lv + RING_D);
        cp_async_wait<RING_D - 1>();           // level lv + 1's copies
        __syncthreads();
        m0 += q1 - q0;
        while (m0 >= W) m0 -= W;
    }
    cp_async_wait<0>();
}

// λ of scenario k of graph blockIdx.y: the walk from vsel[k] (header, "The
// backtrace").  cho and csrc [rows, S], elat [ne, nc], lam [S, nc] per
// graph.
__global__ void __launch_bounds__(BT_THREADS)
sparse_backtrace_kernel(const long long* __restrict__ vsel,
                        const int* __restrict__ cho,
                        const int* __restrict__ csrc,
                        const double* __restrict__ elat,
                        double* __restrict__ lam, int K, int S, int nc,
                        int nlv, long long rows, long long ne) {
    {   // lane y = blockIdx.y of structure y / K: only the pointers move
        const long long y = blockIdx.y;
        vsel += y * S;
        cho += y * rows * S;
        csrc += y * rows * S;
        elat += y / K * ne * nc;
        lam += y * S * nc;
    }
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= S) return;
    double* out = lam + (long long)k * nc;
    const long long v = vsel[k];
    int e = cho[v * S + k], s = csrc[v * S + k];
    if (nc <= BT_NC) {
        double acc[BT_NC];
#pragma unroll
        for (int c = 0; c < BT_NC; ++c) acc[c] = 0.0;
        for (int i = 0; i < nlv && e >= 0; ++i) {
            // the next step's two loads first, then this edge's row: the
            // step's one dependent round trip covers both
            const long long o = (long long)s * S + k;
            const int e2 = cho[o], s2 = csrc[o];
            const double* row = elat + (long long)e * nc;
#pragma unroll
            for (int c = 0; c < BT_NC; ++c)
                if (c < nc) acc[c] = __dadd_rn(acc[c], row[c]);
            e = e2;
            s = s2;
        }
#pragma unroll
        for (int c = 0; c < BT_NC; ++c)
            if (c < nc) out[c] = acc[c];
        return;
    }
    for (int c = 0; c < nc; ++c) out[c] = 0.0;
    for (int i = 0; i < nlv && e >= 0; ++i) {
        const long long o = (long long)s * S + k;
        const int e2 = cho[o], s2 = csrc[o];
        const double* row = elat + (long long)e * nc;
        for (int c = 0; c < nc; ++c) out[c] = __dadd_rn(out[c], row[c]);
        e = e2;
        s = s2;
    }
}

int level_kb(int S) {
    int kb = LV_KB;                   // scenarios a block: LV_KB, or the
    while (kb > S) kb >>= 1;          // largest power of two <= S below it
    return kb;
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; the
// stream is the caller's cudaStream_t.  Each returns the first CUDA error
// of its set-up and launch (cudaGetLastError() after the launch).  The
// caller checks shapes, S >= 1, and that the runs of levels lv0..lv1-1 lie
// inside w (segment: L <= 65535, K and Kc divide L, 0 <= lv0 < lv1 <=
// nlv_p, nc >= 1, in_edges 16-B aligned, and the lists' invariants, gap
// classes below ngc and link ids below nl1 among them; in_link and ls both null
// or both set; a class count whose tables leave the window no
// room returns cudaErrorInvalidValue).  ssum, cho and csrc are all null (values
// mode) or all set (λ mode).
extern "C" int sparse_levels_f32(double* t, float* ssum, int* cho, int* csrc,
                                 const double* w, long long w_base,
                                 const long long* esrc, const int* row_ptr,
                                 const int* v_ptr, const float* elat_sum,
                                 const double* vcost, int lv0, int lv1,
                                 int S, void* stream) {
    const int kb = level_kb(S);
    const int blocks = (S + kb - 1) / kb;
    sparse_levels_f32_kernel<<<blocks, LV_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        t, ssum, cho, csrc, w, w_base, esrc, row_ptr, v_ptr, elat_sum, vcost,
        lv0, lv1, S, kb);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int sparse_levels_f64(double* t, double* ssum, int* cho, int* csrc,
                                 const double* w, long long w_base,
                                 const long long* esrc, const int* row_ptr,
                                 const int* v_ptr, const double* elat_sum,
                                 const double* vcost, int lv0, int lv1,
                                 int S, void* stream) {
    // the narrowest block whose blocks fit the card in one wave (header)
    int dev, nsm, smem_max;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
#ifdef SL_KB
    const int kb = SL_KB;
#else
    int kb = 1;
    while (kb < LV_KB && (S + kb - 1) / kb > nsm) kb <<= 1;
#endif
    const int W = window_rows(kb, smem_max);
    const int smem = ring_smem_bytes(kb, W);
    err = cudaFuncSetAttribute(sparse_levels_f64_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sparse_levels_f64_kernel<<<(S + kb - 1) / kb, LV_THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
        t, ssum, cho, csrc, w, w_base, esrc, row_ptr, v_ptr, elat_sum, vcost,
        lv0, lv1, S, kb, W);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_levels_f64(double* t, double* ssum, int* cho, int* csrc,
                                  const double* Lmat, const double* GSmat,
                                  const int* lv_ptr, const int* rows,
                                  const int* row_ptr, const int* in_edges,
                                  const double* erec, const double* rcost,
                                  const int* in_link, const double* ls,
                                  int nl1, int L, int K, int Kc, int lv0,
                                  int lv1,
                                  int nlv_p, int nflat, int NR, int NE,
                                  int S, int nc, int ngc, void* stream) {
    int dev, nsm, smem_max;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    // the narrowest block whose L x ceil(S / kb) blocks fit the card in one
    // wave (header, "The float64 ring and window")
#ifdef SL_KB
    const int kb = SL_KB;
#else
    int kb = 1;
    while (kb < LV_KB && (long long)L * ((S + kb - 1) / kb) > nsm) kb <<= 1;
#endif
    // the ring holds SLOT_E edges a slot, fewer where wide records would
    // take more than half the shared memory; the window the rest
    const int R = 3 + nc;
    const int tables = (kb * (nc + ngc) * 8 + 15) / 16 * 16;
    const bool links = ls != nullptr;
    int se = SLOT_E / 2 * 2;
    while (se > 0 && RING_NS * seg_slot_bytes(se, R, links) > smem_max / 2)
        se -= 2;
    const int W = (smem_max - TAB_BYTES - tables
                   - RING_NS * seg_slot_bytes(se, R, links)) / 16 / kb / 2
                  * 2;
    if (W < 2) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = TAB_BYTES + tables + 2 * W * kb * 8
                     + RING_NS * seg_slot_bytes(se, R, links);
    const dim3 grid((S + kb - 1) / kb, L);
    // one instantiation a launch: with the link factor, or without it
    const auto launch = [&](auto kernel, auto lx) -> int {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
        kernel<<<grid, SEG_THREADS, smem,
                 static_cast<cudaStream_t>(stream)>>>(
            t, ssum, cho, csrc, Lmat, GSmat, lv_ptr, rows, row_ptr,
            reinterpret_cast<const int4*>(in_edges), erec, rcost, lv0, lv1,
            nlv_p, nflat, NR, NE, S, nc, ngc, K, Kc, kb, W, se, lx);
        return static_cast<int>(cudaGetLastError());
    };
    return links ? launch(segment_levels_f64_kernel<true>,
                          SegLinkTable<true>{in_link, ls, nl1})
                 : launch(segment_levels_f64_kernel<false>,
                          SegLinkTable<false>{});
}

// L walks (L = 1 solo), K lanes a structure: vsel [L, S], cho and csrc [L,
// rows, S], elat [L / K, ne, nc], lam [L, S, nc].  The caller checks L <=
// 65535 and that K divides L.
extern "C" int sparse_backtrace(const long long* vsel, const int* cho,
                                const int* csrc, const double* elat,
                                double* lam, int L, int K, int S, int nc,
                                int nlv, long long rows, long long ne,
                                void* stream) {
    const dim3 grid((S + BT_THREADS - 1) / BT_THREADS, L);
    sparse_backtrace_kernel<<<grid, BT_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        vsel, cho, csrc, elat, lam, K, S, nc, nlv, rows, ne);
    return static_cast<int>(cudaGetLastError());
}
