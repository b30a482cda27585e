// The tree preconditioner of the sparse Newton solve, for Hopper (sm_90a),
// plain C interface.
//
//   tree_factor  the pivots of a forest-structured SPD matrix P, children
//                before parents, one launch an IPM iteration;
//   tree_solve   x = P^-1 r for R right-hand sides (lanes), the up sweep
//                then the down sweep, one launch a PCG step.
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
// position.
//
//   factor  piv[v] = d[v] - sum_children c (w[c] * w[c]) / piv[c]
//           g[v]   = w[v] / piv[v]
//   up      x[v]   = r[v] + sum_children c g[c] * x[c]
//   down    x[v]   = (x[v] + w[v] * x[parent[v]]) / piv[v]   (roots: x[v] / piv[v])
//
// Every operation rounds once (__dadd_rn, __dsub_rn, __dmul_rn,
// __ddiv_rn: no FMA can form) and a vertex's children are taken in the
// list's order (a gather, not atomics), so piv, g and x are the plain
// versions' (ref.py) bit for bit.
//
// What bounds it on an H100.  The sweeps are a chain over the levels: a
// level's rows read rows written one or more levels before, so each level
// costs at least one dependent load from the cache (~0.26 us, the walk's
// measured step), two sweeps a solve.  The bytes (parent, w, piv and the
// lanes of r and x a vertex) are a few MB on the largest LPs, far under
// the chain.  So it is latency: 2 x levels x ~0.26 us a solve at best.
//
// Design.  The simplest correct one: one block owns a lane for every level
// (lane on blockIdx.y), its threads stride over the level's positions, and
// __syncthreads orders the levels; rows written by the block are read back
// by the same block, so no grid-wide barrier is needed.  Levels a block
// sweeps in order within one launch; nothing is staged in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;

__global__ void __launch_bounds__(NTHREADS)
tree_factor_kernel(const double* __restrict__ diag,
                   const double* __restrict__ w,
                   const int* __restrict__ ch_ptr,
                   const int* __restrict__ ch,
                   const int* __restrict__ lv_ptr, int nlv, double* piv,
                   double* g) {
    for (int L = nlv - 1; L >= 0; --L) {
        const int a = lv_ptr[L], b = lv_ptr[L + 1];
        for (int i = a + threadIdx.x; i < b; i += NTHREADS) {
            double acc = diag[i];
            const int k1 = ch_ptr[i + 1];
            for (int k = ch_ptr[i]; k < k1; ++k) {
                const int c = ch[k];
                const double wc = w[c];
                acc = __dsub_rn(acc, __ddiv_rn(__dmul_rn(wc, wc), piv[c]));
            }
            piv[i] = acc;
            g[i] = __ddiv_rn(w[i], acc);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(NTHREADS)
tree_solve_kernel(const double* __restrict__ r, const int* __restrict__ parent,
                  const double* __restrict__ w,
                  const double* __restrict__ piv,
                  const double* __restrict__ g,
                  const int* __restrict__ ch_ptr,
                  const int* __restrict__ ch,
                  const int* __restrict__ lv_ptr, int nlv, int R, double* x) {
    const long long lane = blockIdx.y;
    // up: children before parents; x holds r' when the sweep ends
    for (int L = nlv - 1; L >= 0; --L) {
        const int a = lv_ptr[L], b = lv_ptr[L + 1];
        for (int i = a + threadIdx.x; i < b; i += NTHREADS) {
            double acc = r[i * (long long)R + lane];
            const int k1 = ch_ptr[i + 1];
            for (int k = ch_ptr[i]; k < k1; ++k) {
                const int c = ch[k];
                acc = __dadd_rn(acc,
                                __dmul_rn(g[c], x[c * (long long)R + lane]));
            }
            x[i * (long long)R + lane] = acc;
        }
        __syncthreads();
    }
    // down: parents before children, x overwritten in place
    for (int L = 0; L < nlv; ++L) {
        const int a = lv_ptr[L], b = lv_ptr[L + 1];
        for (int i = a + threadIdx.x; i < b; i += NTHREADS) {
            const int p = parent[i];
            double v = x[i * (long long)R + lane];
            if (p >= 0)
                v = __dadd_rn(v, __dmul_rn(w[i], x[p * (long long)R + lane]));
            x[i * (long long)R + lane] = __ddiv_rn(v, piv[i]);
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int tree_factor(const double* diag, const double* w,
                           const int* ch_ptr, const int* ch,
                           const int* lv_ptr, int nlv, double* piv,
                           double* g, void* stream) {
    tree_factor_kernel<<<1, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        diag, w, ch_ptr, ch, lv_ptr, nlv, piv, g);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int tree_solve(const double* r, const int* parent, const double* w,
                          const double* piv, const double* g,
                          const int* ch_ptr, const int* ch, const int* lv_ptr,
                          int nlv, int R, double* x, void* stream) {
    tree_solve_kernel<<<dim3(1, R), NTHREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        r, parent, w, piv, g, ch_ptr, ch, lv_ptr, nlv, R, x);
    return static_cast<int>(cudaGetLastError());
}
