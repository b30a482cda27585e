// Dense (max,+) mat-vec kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of the JAX package:
//   maxplus_matvec_kernel        repro/kernels/maxplus/kernel.py:45
//   maxplus_matvec_argmax_kernel repro/kernels/maxplus/kernel.py:108
//
//   out[i,k] = max(-1e30, max_j A[i,j] + t[j,k])
//   idx[i,k] = lexicographic argmax over j of (A[i,j] + t[j,k], c[j,k], j),
//              seeded with (-1e30, -1e30, -1)   (argmax kernel only)
//
// A [M,N] is a level's 0/-1e30 incidence, t [N,K] the per-edge candidate
// values, c [N,K] the per-edge tie keys; K (scenarios) is the contiguous
// axis.  All arrays are row-major float32, idx is int32.
//
// What bounds it on an H100.  At the main path's shape (M = Vmax = 256,
// N = Emax = 128, K = 256) the work is 2·M·N·K ≈ 16.8 M float32 ops
// outside the tensor cores (an add and a max per candidate; a (max,+)
// product has no MMA), 0.25 µs at 67 TFLOP/s, against 0.5 MB of traffic
// (A + t read once, out written once; 0.9 MB with c and idx), 0.16 µs at
// 3.35 TB/s.  So the bound is the float32 pipe, and both are far below
// the few µs a launch costs: one level is one launch, and at this size the
// launch, not the kernel, sets the pace.
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

dim3 grid_for(int M, int K) {
    return dim3((K + BK - 1) / BK, (M + BM - 1) / BM);
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; the
// stream is the caller's cudaStream_t.  Returns cudaGetLastError() after
// the launch, so a refused launch (for instance more than 65535 row blocks)
// is reported to the caller.  The caller checks M, N, K >= 1.
extern "C" int maxplus_matvec(const float* A, const float* t, float* out,
                              int M, int N, int K, void* stream) {
    maxplus_matvec_kernel<<<grid_for(M, K), dim3(BK, BM / RM), 0,
                            static_cast<cudaStream_t>(stream)>>>(
        A, t, out, M, N, K);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int maxplus_matvec_argmax(const float* A, const float* t,
                                     const float* c, float* out, int* idx,
                                     int M, int N, int K, void* stream) {
    maxplus_matvec_argmax_kernel<<<grid_for(M, K), dim3(BK, BM / RM), 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        A, t, c, out, idx, M, N, K);
    return static_cast<int>(cudaGetLastError());
}
