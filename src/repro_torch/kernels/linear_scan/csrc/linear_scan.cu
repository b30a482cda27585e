// Linear scan (the Mamba recurrence) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel of the JAX package:
//   linear_scan_kernel (body _scan_kernel)
//       repro/kernels/linear_scan/kernel.py:53 (:30)
//
//   per batch b, channel d, state s, time t = 0 .. T-1:
//     h[d,s]  = a[b,t,d,s] * h[d,s] + b[b,t,d,s]      (h starts at h0[b,d,s])
//     y[b,t,d] = sum_s h[d,s] * c[b,t,s]
//   a, b, c float32 or bfloat16 (one type for the three), float32
//   arithmetic; y in that type (round to nearest), the final h in float32.
//   The product a*h and the sum with b round separately (__fmul_rn,
//   __fadd_rn), as the plain version's two tensor operations do, so h is
//   the plain version's bit for bit; y's sum over s runs in another order.
//
// What bounds it on an H100.  Every element of a and b is read once and
// takes 3 operations (a multiply and an add for h, a multiply for y), so
// it is bytes: at the Mamba prefill shape of jamba-1.5-large (B = 1,
// T = 4096, D = 16384, S = 16, float32) a and b are 8.59 GB of the 8.86 GB
// moved, 2.64 ms at 3.35 TB/s, against 3.2 GFLOP (0.05 ms at 67 TFLOP/s on
// the CUDA cores).  At decode (B = 4, T = 1) it moves 17 MB, 5.1 us, where
// the launch itself costs about as much.
//
// Design.  The TPU kernel walks time inside a VMEM chunk and carries h
// across the sequential time axis of its grid in scratch; blocks on the
// H100 run in no order, so here one block owns its channels for all of T
// and h never leaves a register.  One thread a (b, d, s): the states of a
// channel sit on SP neighbouring lanes (SP = S rounded up to a power of
// two, at most 32), so a warp covers 32 / SP channels and each time step's
// a and b rows of those channels are one coalesced 128-byte load (S = 16,
// float32).  y is a butterfly of __shfl_xor_sync over the SP lanes; lanes
// at s >= S and channels at d >= D are masked and still take part in the
// shuffles.  c[b,t,:] is shared by every channel, so the block stages CT
// time steps of it in shared memory at a time.  The loads of a and b do
// not depend on h: each thread starts the loads of U steps before it
// consumes any, so U loads are in flight while the dependent chain runs.
// Ragged T and D are masked; T = 1 (every decode step) is one short chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int CT = 64;            // time steps of c staged at a time
constexpr int U = 8;              // time steps whose a, b loads start together
constexpr int MAX_S = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

template <typename T, int SP>
__global__ void __launch_bounds__(NTHREADS)
linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   const T* __restrict__ c, const float* __restrict__ h0,
                   T* __restrict__ y, float* __restrict__ hout, int Tn,
                   int D, int S) {
    __shared__ float cs[CT * MAX_S];
    constexpr int CH = NTHREADS / SP;           // channels a block
    const int s = threadIdx.x % SP;
    const int d = blockIdx.x * CH + threadIdx.x / SP;
    const long long bb = blockIdx.y;
    const bool live = d < D && s < S;
    const long long DS = (long long)D * S;
    // a and b at (bb, t, d, s): base + t * DS;  y at (bb, t, d): ybase + t * D
    const long long base = bb * Tn * DS + (long long)d * S + s;
    const long long ybase = bb * Tn * (long long)D + d;
    const T* cb = c + bb * Tn * (long long)S;

    float h = live ? h0[bb * DS + (long long)d * S + s] : 0.f;
    for (int t0 = 0; t0 < Tn; t0 += CT) {
        const int n = min(CT, Tn - t0);
        __syncthreads();                 // the previous chunk's readers are done
        for (int i = threadIdx.x; i < n * S; i += NTHREADS)
            cs[i] = to_f32(cb[(long long)t0 * S + i]);
        __syncthreads();
        for (int i = 0; i < n; i += U) {
            float av[U], bv[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                av[u] = 0.f;
                bv[u] = 0.f;
                if (live && i + u < n) {
                    const long long off = base + (long long)(t0 + i + u) * DS;
                    av[u] = to_f32(a[off]);
                    bv[u] = to_f32(b[off]);
                }
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (i + u < n) {               // the same for the whole block
                    h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
                    float p = s < S ? __fmul_rn(h, cs[(i + u) * S + s]) : 0.f;
#pragma unroll
                    for (int o = SP / 2; o > 0; o >>= 1)
                        p += __shfl_xor_sync(FULL, p, o);
                    if (s == 0 && d < D)
                        store(y + ybase + (long long)(t0 + i + u) * D, p);
                }
            }
        }
    }
    if (live) hout[bb * DS + (long long)d * S + s] = h;
}

template <typename T, int SP>
int run(const void* a, const void* b, const void* c, const float* h0,
        void* y, float* h, int B, int Tn, int D, int S, cudaStream_t st) {
    constexpr int CH = NTHREADS / SP;
    dim3 grid((D + CH - 1) / CH, B);
    linear_scan_kernel<T, SP><<<grid, NTHREADS, 0, st>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const T*>(c), h0, static_cast<T*>(y), h, Tn, D, S);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* a, const void* b, const void* c, const float* h0,
             void* y, float* h, int B, int Tn, int D, int S,
             cudaStream_t st) {
    if (S <= 1) return run<T, 1>(a, b, c, h0, y, h, B, Tn, D, S, st);
    if (S <= 2) return run<T, 2>(a, b, c, h0, y, h, B, Tn, D, S, st);
    if (S <= 4) return run<T, 4>(a, b, c, h0, y, h, B, Tn, D, S, st);
    if (S <= 8) return run<T, 8>(a, b, c, h0, y, h, B, Tn, D, S, st);
    if (S <= 16) return run<T, 16>(a, b, c, h0, y, h, B, Tn, D, S, st);
    return run<T, 32>(a, b, c, h0, y, h, B, Tn, D, S, st);
}

}  // namespace

// a, b [B, T, D, S], c [B, T, S] (dtype 0: float32, 1: bfloat16), h0 and
// h [B, D, S] float32, y [B, T, D] in a's type; all contiguous.  Returns
// the cudaError_t of the launch (0 when it was accepted).
extern "C" int linear_scan(const void* a, const void* b, const void* c,
                           const void* h0, void* y, void* h, int dtype, int B,
                           int T, int D, int S, void* stream) {
    if (B < 1 || T < 1 || D < 1 || S < 1 || S > MAX_S || B > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* hi = static_cast<const float*>(h0);
    float* ho = static_cast<float*>(h);
    return dtype == 1
               ? dispatch<__nv_bfloat16>(a, b, c, hi, y, ho, B, T, D, S, st)
               : dispatch<float>(a, b, c, hi, y, ho, B, T, D, S, st);
}
