// (max,+) kernels for Hopper (sm_90a), plain C interface: the dense
// mat-vecs below (solo, and batched over a leading graph axis), and the
// slot-list segment reduction further down.
//
// Replaces the TPU kernels of the JAX package:
//   maxplus_matvec_kernel                repro/kernels/maxplus/kernel.py:45
//   maxplus_matvec_argmax_kernel         repro/kernels/maxplus/kernel.py:108
//   maxplus_matvec_argmax_batched_kernel repro/kernels/maxplus/kernel.py:184
//   maxplus_slotlist_argmax_kernel       repro/kernels/maxplus/kernel.py:262
//   maxplus_matvec_batched_kernel        repro/kernels/maxplus/kernel.py:331
//
//   out[i,k] = max(-1e30, max_j A[i,j] + t[j,k])
//   idx[i,k] = lexicographic argmax over j of (A[i,j] + t[j,k], c[j,k], j),
//              seeded with (-1e30, -1e30, -1)   (argmax kernel only)
//
// A [M,N] is a level's 0/-1e30 incidence, t [N,K] the per-edge candidate
// values, c [N,K] the per-edge tie keys; K (scenarios) is the contiguous
// axis.  All arrays are row-major float32, idx is int32.  The batched
// entry points take G such problems stacked on a leading axis (A [G,M,N],
// t/c [G,N,K], out/idx [G,M,K]: one level of G packed graphs) and solve
// all of them in one launch, graph g on blockIdx.z; the solo entry points
// are the same kernels at G = 1.
//
// What bounds it on an H100.  At the main path's shape (M = Vmax = 256,
// N = Emax = 128, K = 256) the work is 2·M·N·K ≈ 16.8 M float32 ops
// outside the tensor cores (an add and a max per candidate; a (max,+)
// product has no MMA), 0.25 µs at 67 TFLOP/s, against 0.5 MB of traffic
// (A + t read once, out written once; 0.9 MB with c and idx), 0.16 µs at
// 3.35 TB/s.  So the bound is the float32 pipe, and both are far below
// the few µs a launch costs: one level is one launch, and at this size the
// launch, not the kernel, sets the pace.  The batched study shape (G = 4
// graphs, M = 64, N = 128, K = 256) is the same work in the same number of
// blocks.
//
// Design.  A block owns a tile of BM rows × BK scenarios (BK = one warp,
// so neighbouring threads read neighbouring k).  It walks N in stages of
// TN columns, staging the A tile [BM, TN] and the t (and c) tile [TN, BK]
// in shared memory; each thread keeps RM rows' accumulators in registers,
// reads t[j][k] once per column and A[row][j] as a warp-wide broadcast.
// The TPU kernel's sequential N grid axis, which carried the accumulator
// in VMEM, becomes this loop inside the block.  Columns are visited in
// increasing j, so the lexicographic rule needs no cross-block merge.
// Each candidate is one __fadd_rn (no contraction), and max and the
// compares are exact, so the result equals the plain PyTorch version bit
// for bit.  Ragged edges are masked: out-of-range rows are not written,
// out-of-range k are not written, and columns past N are never visited.
// A graph's block only moves its pointers by the graph's strides (M·N,
// N·K, M·K), so batching changes no arithmetic: graph g of a batched
// launch equals a solo launch on that graph's slices, bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 32;            // scenarios per block (one warp)
constexpr int BM = 16;            // rows per block
constexpr int RM = 4;             // rows per thread
constexpr int TN = 32;            // columns per shared-memory stage
constexpr int NTHREADS = BK * (BM / RM);
constexpr float NEG_INF = -1e30f;

// Stage A[row0:row0+BM, n0:n0+TN] and x[n0:n0+TN, k0:k0+BK] (out-of-range
// entries are never read by the compute loop; they are zero-filled so that
// shared memory holds defined values).
__device__ __forceinline__ void stage_tile(
        float (&As)[BM][TN + 1], float (&xs)[TN][BK],
        const float* __restrict__ A, const float* __restrict__ x,
        int M, int N, int K, int row0, int n0, int k0, int tid) {
    for (int e = tid; e < BM * TN; e += NTHREADS) {
        const int r = e / TN, j = e % TN;
        const int gi = row0 + r, gj = n0 + j;
        As[r][j] = (gi < M && gj < N) ? A[(long long)gi * N + gj] : 0.0f;
    }
    for (int e = tid; e < TN * BK; e += NTHREADS) {
        const int j = e / BK, kk = e % BK;
        const int gj = n0 + j, gk = k0 + kk;
        xs[j][kk] = (gj < N && gk < K) ? x[(long long)gj * K + gk] : 0.0f;
    }
}

__global__ void __launch_bounds__(NTHREADS)
maxplus_matvec_kernel(const float* __restrict__ A,
                      const float* __restrict__ t,
                      float* __restrict__ out, int M, int N, int K) {
    __shared__ float As[BM][TN + 1];
    __shared__ float ts[TN][BK];
    const long long g = blockIdx.z;
    A += g * M * N;
    t += g * N * K;
    out += g * M * K;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * BK + tx;
    const int k0 = blockIdx.x * BK, row0 = blockIdx.y * BM;
    float acc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) acc[r] = NEG_INF;

    for (int n0 = 0; n0 < N; n0 += TN) {
        stage_tile(As, ts, A, t, M, N, K, row0, n0, k0, tid);
        __syncthreads();
        const int jn = min(TN, N - n0);
        for (int j = 0; j < jn; ++j) {
            const float tv = ts[j][tx];
#pragma unroll
            for (int r = 0; r < RM; ++r) {
                const float v = __fadd_rn(As[ty * RM + r][j], tv);
                acc[r] = v > acc[r] ? v : acc[r];
            }
        }
        __syncthreads();
    }

    const int k = k0 + tx;
    if (k >= K) return;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        const int i = row0 + ty * RM + r;
        if (i < M) out[(long long)i * K + k] = acc[r];
    }
}

__global__ void __launch_bounds__(NTHREADS)
maxplus_matvec_argmax_kernel(const float* __restrict__ A,
                             const float* __restrict__ t,
                             const float* __restrict__ c,
                             float* __restrict__ out, int* __restrict__ idx,
                             int M, int N, int K) {
    __shared__ float As[BM][TN + 1];
    __shared__ float ts[TN][BK];
    __shared__ float cs[TN][BK];
    const long long g = blockIdx.z;
    A += g * M * N;
    t += g * N * K;
    c += g * N * K;
    out += g * M * K;
    idx += g * M * K;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * BK + tx;
    const int k0 = blockIdx.x * BK, row0 = blockIdx.y * BM;
    float bv[RM], bk[RM];
    int bi[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        bv[r] = NEG_INF;
        bk[r] = NEG_INF;
        bi[r] = -1;
    }

    for (int n0 = 0; n0 < N; n0 += TN) {
        stage_tile(As, ts, A, t, M, N, K, row0, n0, k0, tid);
        for (int e = tid; e < TN * BK; e += NTHREADS) {
            const int j = e / BK, kk = e % BK;
            const int gj = n0 + j, gk = k0 + kk;
            cs[j][kk] = (gj < N && gk < K) ? c[(long long)gj * K + gk] : 0.0f;
        }
        __syncthreads();
        const int jn = min(TN, N - n0);
        for (int j = 0; j < jn; ++j) {
            const float tv = ts[j][tx];
            const float cv = cs[j][tx];
            const int gj = n0 + j;
#pragma unroll
            for (int r = 0; r < RM; ++r) {
                const float v = __fadd_rn(As[ty * RM + r][j], tv);
                const bool better =
                    (v > bv[r]) ||
                    (v == bv[r] && (cv > bk[r] || (cv == bk[r] && gj > bi[r])));
                if (better) {
                    bv[r] = v;
                    bk[r] = cv;
                    bi[r] = gj;
                }
            }
        }
        __syncthreads();
    }

    const int k = k0 + tx;
    if (k >= K) return;
#pragma unroll
    for (int r = 0; r < RM; ++r) {
        const int i = row0 + ty * RM + r;
        if (i < M) {
            out[(long long)i * K + k] = bv[r];
            idx[(long long)i * K + k] = bi[r];
        }
    }
}

dim3 grid_for(int G, int M, int K) {
    return dim3((K + BK - 1) / BK, (M + BM - 1) / BM, G);
}

// ---------------------------------------------------------------------------
// Slot-list (max,+) segment reduction with argmax.
//
//   out[m,k] = max(-1e30, max over {e : dst[e] = m} of cand[e,k])
//   idx[m,k] = lexicographic argmax over those e of (cand[e,k], c[e,k], e),
//              seeded with (-1e30, -1e30, -1)
//
// dst [E] int32 is arbitrary: unsorted, repeated, rows with no slot, and
// slots pointing outside [0, M) (pad slots), which never hit.  cand/c [E,K]
// float32, out [M,K] float32, idx [M,K] int32, K contiguous.  The sparse
// forward no longer calls it (sparse_levels.cu runs its whole level loop);
// it is the TPU kernel's exact function, held against its plain version.
//
// What bounds it on an H100.  Each slot feeds exactly one row, so the work
// is a segment reduction: E·K candidates, three compares each.  At a
// sparse level's shape (M = Vmax_lv = 1024, E = Emax_lv = 256, K = 256)
// that is 0.2 M operations against 2.6 MB of traffic (dst, cand and c read
// once, out and idx written once), 0.8 us at 3.35 TB/s: the bound is
// bytes, most of them the M x K outputs.
//
// Design.  A block owns SL_BM rows x BK scenarios; warp w owns the SL_RM
// rows row0 + w*SL_RM + i of them, lane x scenario k0 + x.  The warp reads
// dst 32 slots at a time, in increasing e, one slot a lane (the next tile's
// load already in flight), and compacts it with one ballot per owned row:
// bit j of hit[i] says slot e0 + j lands in row i.  Each lane then walks
// only its own rows' hits, lowest bit first (increasing e), reading
// cand/c of that slot for its scenario — 128 coalesced bytes a warp — and
// updating the row's (value, key, ordinal) in registers.  A slot that lands
// elsewhere costs a bit test, not a shared-memory read and a branch per
// warp as in a walk over every staged slot, so at E/M ~ 1/4 a warp touches
// about one slot of every 32 it scans.  Each (row, k) has one owner and
// sees its slots in increasing e, so no merge is needed, and with exact
// compares the result equals the plain PyTorch version (and the TPU
// kernel) bit for bit: among full ties the largest ordinal wins.  No
// shared memory and no __syncthreads: warps are independent.  Ragged K and
// E are masked; rows >= M are not written.

constexpr int SL_NW = 8;                  // warps per block
constexpr int SL_RM = 4;                  // rows per warp
constexpr int SL_BM = SL_NW * SL_RM;      // rows per block
constexpr int SL_NTHREADS = BK * SL_NW;
constexpr unsigned FULL = 0xffffffffu;

// The owned row of dst value d for a warp whose rows start at wrow0, or -1.
__device__ __forceinline__ int owned_row(int d, int wrow0) {
    const long long r = (long long)d - wrow0;
    return (r >= 0 && r < SL_RM) ? (int)r : -1;
}

__global__ void __launch_bounds__(SL_NTHREADS)
maxplus_slotlist_argmax_kernel(const int* __restrict__ dst,
                               const float* __restrict__ cand,
                               const float* __restrict__ c,
                               float* __restrict__ out,
                               int* __restrict__ idx, int M, int E, int K) {
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int k = blockIdx.x * BK + tx;
    const int wrow0 = blockIdx.y * SL_BM + ty * SL_RM;
    const bool kin = k < K;
    float bv[SL_RM], bk[SL_RM];
    int bi[SL_RM];
#pragma unroll
    for (int i = 0; i < SL_RM; ++i) {
        bv[i] = NEG_INF;
        bk[i] = NEG_INF;
        bi[i] = -1;
    }

    int r = tx < E ? owned_row(dst[tx], wrow0) : -1;
    for (int e0 = 0; e0 < E; e0 += BK) {
        const int en = e0 + BK + tx;
        const int d_next = en < E ? dst[en] : 0;
#pragma unroll
        for (int i = 0; i < SL_RM; ++i) {
            unsigned hit = __ballot_sync(FULL, r == i);
            while (hit) {                          // warp-uniform
                const int e = e0 + __ffs(hit) - 1;
                hit &= hit - 1;
                if (!kin) continue;
                const long long o = (long long)e * K + k;
                const float v = cand[o], cv = c[o];
                if (v > bv[i] || (v == bv[i] && cv >= bk[i])) {
                    bv[i] = v;               // e beats every earlier
                    bk[i] = cv;              // ordinal: a full tie goes
                    bi[i] = e;               // to the later slot
                }
            }
        }
        r = en < E ? owned_row(d_next, wrow0) : -1;
    }

    if (!kin) return;
#pragma unroll
    for (int i = 0; i < SL_RM; ++i) {
        const int m = wrow0 + i;
        if (m < M) {
            out[(long long)m * K + k] = bv[i];
            idx[(long long)m * K + k] = bi[i];
        }
    }
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; the
// stream is the caller's cudaStream_t.  Returns cudaGetLastError() after
// the launch, so a refused launch (for instance more than 65535 row blocks
// or graphs) is reported to the caller.  The caller checks G, M, N (or E),
// K >= 1.
extern "C" int maxplus_matvec_batched(const float* A, const float* t,
                                      float* out, int G, int M, int N, int K,
                                      void* stream) {
    maxplus_matvec_kernel<<<grid_for(G, M, K), dim3(BK, BM / RM), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        A, t, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int maxplus_matvec_argmax_batched(const float* A, const float* t,
                                             const float* c, float* out,
                                             int* idx, int G, int M, int N,
                                             int K, void* stream) {
    maxplus_matvec_argmax_kernel<<<grid_for(G, M, K), dim3(BK, BM / RM), 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        A, t, c, out, idx, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int maxplus_matvec(const float* A, const float* t, float* out,
                              int M, int N, int K, void* stream) {
    return maxplus_matvec_batched(A, t, out, 1, M, N, K, stream);
}

extern "C" int maxplus_matvec_argmax(const float* A, const float* t,
                                     const float* c, float* out, int* idx,
                                     int M, int N, int K, void* stream) {
    return maxplus_matvec_argmax_batched(A, t, c, out, idx, 1, M, N, K,
                                         stream);
}

extern "C" int maxplus_slotlist_argmax(const int* dst, const float* cand,
                                       const float* c, float* out, int* idx,
                                       int M, int E, int K, void* stream) {
    const dim3 grid((K + BK - 1) / BK, (M + SL_BM - 1) / SL_BM);
    maxplus_slotlist_argmax_kernel<<<grid, dim3(BK, SL_NW), 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        dst, cand, c, out, idx, M, E, K);
    return static_cast<int>(cudaGetLastError());
}
