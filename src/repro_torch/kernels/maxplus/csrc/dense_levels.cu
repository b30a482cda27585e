// The dense float32 forward's level loop, solo and packed, for Hopper
// (sm_90a), plain C interface.
//
//   dense_levels_f32  every level of a dense plan (or of G packed plans, one
//                     per blockIdx.y), in order, in one launch: the work of
//                     the per-level PyTorch body around the (max,+) mat-vecs
//                     (the candidate gathers, the float32 boundary, the
//                     lexicographic argmax, the float64 remainder pass and
//                     the writes of t, ssum and cho).
//
// Replaces, on the main path, the TPU kernels maxplus_matvec_argmax_kernel
// (repro/kernels/maxplus/kernel.py:108) and its graph-batched twin
// maxplus_matvec_argmax_batched_kernel (kernel.py:184) with the reference's
// level bodies around them (repro/sweep/engine.py:583-613, :679-713); in
// values mode also maxplus_matvec_kernel (kernel.py:45) and
// maxplus_matvec_batched_kernel (kernel.py:331).  The λ backtrace is the
// walk kernel of sparse_levels.cu, over cho's flat edge ids (the
// reference's backtrace, :627-642, :724-744).
//
// Layout.  Scenarios (S) are the contiguous axis of every [rows, S] array.
// Graph g's state: t [nflat, S] float64 end times, ssum [nflat, S] float32
// tie keys, cho [nflat, S] int32 chosen flat edge ids and csrc [nflat,
// S] int32 their flat source rows, for the walk, updated in place
// from a fresh state (0, 0, -1, -1); flat row r = lv·Vmax + i is vertex slot i
// of level lv.  w [nlv, Emax, S] float64 edge weights (flat edge e =
// lv·Emax + j), elat_sum [nlv_p, Emax] float32, vcost [nlv_p, Vmax]
// float64.  The lists name the rows the level loop writes, those with a
// real in-edge or a vertex cost: level lv's are rows[lv_ptr[lv] ..
// lv_ptr[lv+1]), row q's real in-edges in_edges[row_ptr[q] ..
// row_ptr[q+1]) as (flat edge id, flat source row), in increasing edge
// slot j.  Packed, each array has a leading graph axis and only the
// pointers move.
//
// Lanes.  One launch runs L lanes, lane y = blockIdx.y: K candidate-cost
// lanes of each of L / K structures (a plan, a packed plan's graph, a
// structure variant), lane y belonging to structure y / K; K = 1 and L = G
// is the packed forward.  A lane owns its weights w (formed from its own
// edge constants) and its state t, ssum, cho and csrc; its structure owns
// the lists and vcost.  The tie keys elat_sum are the structure's (Ks = K)
// or, where the lanes' latency rows differ, the lane's own (Ks = 1): lane
// y reads those of y / Ks.  Every lane runs the code of a solo forward of
// its structure with its weights and tie keys.
//
// Per listed row of level lv and scenario k, in the reference's order and
// rounding (every add an explicit round-to-nearest intrinsic: no FMA):
//   cand64 = t[src] + w[e]                        (__dadd_rn)
//   hi     = (float) cand64                       (__double2float_rn)
//   key    = ssum[src] + elat_sum[e]              (__fadd_rn; λ only)
//   the lexicographic argmax of (hi, key, e), seeded (-1e30, -1e30, -1),
//   exact compares, a later edge winning a full tie (maxplus.cu's rule);
//   M      = the row's float32 maximum, seeded -1e30;
//   R      = max(-1e30, max over the edges with hi == M of
//            0.0f + (float)(cand64 - (double)hi))   (the remainder pass of
//            the per-level body: a second values mat-vec of the indicator)
//   t[row] = max((double)M + (double)R, 0) + vcost[row]
//   ssum[row] = M >= 0 ? key[winner] : 0;  cho[row] = M >= 0 ? winner : -1;
//   csrc[row] = M >= 0 ? the winner's source row : -1.
// A row with no real in-edge gets t = 0 + vcost, ssum 0, cho -1, what the
// indicator's -1e30 seed gives it; an unlisted row (no in-edge, no cost)
// keeps the fresh state, which is that.  The candidates of the
// indicator's absent edges are -1e30 + x, which rounds to -1e30 for every
// |x| below 3.8e22, so reading only real edges changes no bit.
//
// What bounds it on an H100.  Bytes: per scenario, the real edges' w (8
// B) and the listed rows' t, ssum and cho written once (8 + 4 + 4 B), plus
// the lists once; the t[src] and ssum[src] the launch reads are rows it
// wrote itself (its intermediates).  Levels depend on each other: level
// lv's t[src] loads wait for the stores of earlier levels, so a launch is
// also a chain of levels x (a dependent round trip through L2 and a
// barrier); the chain, not the bytes, sets the pace.  chip_smoke.py
// computes both.
//
// Design.  As sparse_levels_f32_kernel (sparse_levels.cu, whose header
// gives the reasons): a block owns kb scenarios of one graph for all rows
// of every level, so one __syncthreads() between levels orders every read
// of a level after every write of the levels before it, with no grid-wide
// barrier and no host round trip; t and ssum are read with plain,
// L1-coherent loads, never through the read-only path.  The level loop
// visits the listed rows only: ~32 of a dense level's 256 slots on the
// stencil, so the indicator's (max,+) work on -1e30 entries is gone, and
// the padded rows, ~90 % of the state, are never touched (the caller's
// zero fill is their write).  Thread (ry, kx) takes listed rows
// lv_ptr[lv] + ry, + nr, ... of scenario k0 + kx (nr = blockDim / kb); a
// row's in-edges are taken EB = 2 at a time with all their loads issued
// together (most rows have one or two; a batch past the run repeats its
// last edge's loads, so a wider batch costs the short rows loads), and
// each in-edge entry carries its source row, so a row costs one chain of
// (row_ptr -> in_edges -> t, w) per batch.  The weights are the one operand of that chain that comes from
// device memory, not L2: the threads without a row in a level prefetch
// into L2 those of the level two on.  A level with no listed row takes no
// barrier.  kb = 8 as in the sparse kernel (32 blocks a graph at S = 256;
// not swept for this kernel).

#include <cuda_runtime.h>

namespace {

constexpr int LV_THREADS = 1024;
constexpr int LV_KB = 8;                  // scenarios a block (see Design)
constexpr int EB = 2;                     // in-edges whose loads go together
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__global__ void __launch_bounds__(LV_THREADS)
dense_levels_f32_kernel(double* t, float* ssum, int* cho, int* csrc,
                        const double* __restrict__ w,
                        const int* __restrict__ lv_ptr,
                        const int* __restrict__ rows,
                        const int* __restrict__ row_ptr,
                        const int2* __restrict__ in_edges,
                        const float* __restrict__ elat_sum,
                        const double* __restrict__ vcost, int nlv, int nlv_p,
                        int nflat, int Vmax, int Emax, int NR, int NE, int S,
                        int K, int Ks, int kb) {
    const bool lam = ssum != nullptr;
    {   // lane y = blockIdx.y of structure g = y / K ("Lanes" above): only
        // the pointers move
        const long long y = blockIdx.y, g = y / K;
        const long long st = y * nflat * S;
        t += st;
        if (lam) {
            ssum += st;
            cho += st;
            csrc += st;
        }
        w += y * nlv * Emax * S;
        lv_ptr += g * (nlv_p + 1);
        rows += g * NR;
        row_ptr += g * (NR + 1);
        in_edges += g * NE;
        elat_sum += y / Ks * nlv_p * Emax;
        vcost += g * nlv_p * Vmax;
    }
    const int kx = threadIdx.x % kb, ry = threadIdx.x / kb;
    const int nr = blockDim.x / kb;
    const int k = blockIdx.x * kb + kx;
    const bool live = k < S;

    int q0 = lv_ptr[0], q1 = lv_ptr[1];
    for (int lv = 0; lv < nlv; ++lv) {
        // the next level's real rows, loaded before this level's chain
        const int q2 = lv + 2 <= nlv ? lv_ptr[lv + 2] : q1;
        // the threads without a row in this level prefetch into L2 the
        // weights of level lv + 2's in-edges (lv_ptr[lv + 2] = q2), one
        // edge a thread, the block's kb scenarios (one or two sectors)
        const int spare = ry - (q1 - q0);
        if (kx == 0 && spare >= 0 && lv + 2 < nlv) {
            const int pa = row_ptr[q2] + spare;
            if (pa < row_ptr[lv_ptr[lv + 3]]) {
                const double* wa = w + (long long)in_edges[pa].x * S + k;
                prefetch_l2(wa);
                if (k + 4 < S) prefetch_l2(wa + 4);
            }
        }
        if (q0 < q1) {                    // the same for the whole block
            for (int q = q0 + ry; live && q < q1; q += nr) {
                const int r = rows[q];
                const int pb = row_ptr[q], pe = row_ptr[q + 1];
                float bv = NEG_INF, bk = NEG_INF, rm = NEG_INF;
                int bi = -1, bs = -1;
                for (int p0 = pb; p0 < pe; p0 += EB) {
                    int2 ie[EB];
                    double wv[EB], tv[EB];
                    float es[EB], sv[EB];
#pragma unroll
                    for (int j = 0; j < EB; ++j)   // past the run: repeat
                        ie[j] = in_edges[min(p0 + j, pe - 1)];  // its last
#pragma unroll
                    for (int j = 0; j < EB; ++j) {
                        wv[j] = w[(long long)ie[j].x * S + k];
                        tv[j] = t[(long long)ie[j].y * S + k];
                        es[j] = lam ? elat_sum[ie[j].x] : 0.0f;
                        sv[j] = lam ? ssum[(long long)ie[j].y * S + k] : 0.0f;
                    }
#pragma unroll
                    for (int j = 0; j < EB; ++j) {
                        if (p0 + j >= pe) break;
                        const double c64 = __dadd_rn(tv[j], wv[j]);
                        const float hi = __double2float_rn(c64);
                        const float rem = __fadd_rn(0.0f, __double2float_rn(
                            __dsub_rn(c64, (double)hi)));
                        const float key = lam ? __fadd_rn(sv[j], es[j]) : 0.0f;
                        // in-edges come in increasing slot, so a later edge
                        // beats every earlier one on a full tie
                        if (hi > bv) {
                            bv = hi;
                            rm = rem > NEG_INF ? rem : NEG_INF;
                            bk = key;
                            bi = ie[j].x;
                            bs = ie[j].y;
                        } else if (hi == bv) {
                            rm = rem > rm ? rem : rm;
                            if (key >= bk) {
                                bk = key;
                                bi = ie[j].x;
                                bs = ie[j].y;
                            }
                        }
                    }
                }
                const double s = __dadd_rn((double)bv, (double)rm);
                const long long o = (long long)r * S + k;
                t[o] = __dadd_rn(s > 0.0 ? s : 0.0, vcost[r]);
                if (lam) {
                    const bool has = bv >= 0.0f;
                    ssum[o] = has ? bk : 0.0f;
                    cho[o] = has ? bi : -1;
                    csrc[o] = has ? bs : -1;
                }
            }
            __syncthreads();
        }
        q0 = q1;
        q1 = q2;
    }
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; the
// stream is the caller's cudaStream_t.  Returns cudaGetLastError() after
// the launch.  The caller checks shapes, S >= 1, 1 <= nlv <= nlv_p, L <=
// 65535, that K and Ks divide L, and the plan's invariants (each level's
// in-edges are its own and read only earlier levels' rows).  ssum, cho and
// csrc are all null (values mode) or all set (λ mode).
extern "C" int dense_levels_f32(double* t, float* ssum, int* cho, int* csrc,
                                const double* w, const int* lv_ptr,
                                const int* rows, const int* row_ptr,
                                const int* in_edges, const float* elat_sum,
                                const double* vcost, int L, int K,
                                int Ks, int nlv, int nlv_p, int nflat, int Vmax,
                                int Emax, int NR, int NE, int S,
                                void* stream) {
    int kb = LV_KB;                   // scenarios a block: LV_KB, or the
    while (kb > S) kb >>= 1;          // largest power of two <= S below it
    const dim3 grid((S + kb - 1) / kb, L);
    dense_levels_f32_kernel<<<grid, LV_THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        t, ssum, cho, csrc, w, lv_ptr, rows, row_ptr,
        reinterpret_cast<const int2*>(in_edges), elat_sum, vcost, nlv, nlv_p,
        nflat, Vmax, Emax, NR, NE, S, K, Ks, kb);
    return static_cast<int>(cudaGetLastError());
}
