// RWKV-6's time-mix recurrence (wkv6) for Hopper (sm_90a), plain C
// interface.
//
// Replaces no TPU kernel: the JAX package runs the recurrence as a
// lax.scan over rwkv6_apply's step (repro/models/ssm.py:233-246, through
// checkpointed_scan, :27-51), which XLA compiles to a loop.  Written as
// plain PyTorch it is a loop of about five launches a token (4096 tokens
// x 32 layers of rwkv6-7b: some 650,000 launches a prefill), so the port
// runs a layer's whole sequence in one launch.
//
// Per (batch b, head h), with S [hd, hd] over key index i and value index
// j, for t = 0 .. T - 1 (r, k, v, w [B, T, H, hd], u [H, hd], all
// float32):
//   kv      = k_t[i] * v_t[j]                              (__fmul_rn)
//   y_t[j]  = sum_i r_t[i] * (S[i][j] + u[i] * kv)
//   S[i][j] = w_t[i] * S[i][j] + kv              (__fmul_rn, __fadd_rn)
// Every op of the state update is one explicitly rounded float32 op, no
// FMA, as the plain version (ref.py, wkv6_ref) does it in PyTorch, so S
// equals it bit for bit.  y's sum over i runs in four interleaved partial
// sums (i mod 4), added at the end: another order than the plain
// version's and XLA's einsum, so y is held to a tolerance.
//
// What bounds it on an H100.  At rwkv6-7b's prefill (B 1, T 4096, H 64,
// hd 64) the work is 7 float32 ops a (step, i, j): 7.5 GFLOP, 0.11 ms at
// the CUDA cores' 67 TFLOP/s, against 5 x 67 MB of r, k, v, w and y
// (0.10 ms at 3.35 TB/s).  Both are far below what the recurrence allows:
// each step depends on the last, so T steps run one after another in
// every head, and only B x H = 64 heads run side by side.
//
// Design (the simple one).  One block of hd threads a (b, h); thread j
// holds column j of S in registers (hd floats) for the whole sequence.
// The block stages CH steps of r, k, w and v at a time in shared memory
// (each thread loads its own element of each row, so a row is one
// coalesced 4-hd-byte read), synchronises once, and runs the CH steps
// from shared memory: the r, k, w and u values of step t are broadcast
// reads, v_t[j] its own.  y_t[j] is written as it is formed.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 32;           // steps staged a chunk

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
    __shared__ __align__(16) float rs[CH][HD];
    __shared__ __align__(16) float ks[CH][HD];
    __shared__ __align__(16) float ws[CH][HD];
    __shared__ __align__(16) float vs[CH][HD];
    __shared__ __align__(16) float us[HD];
    const int bh = blockIdx.x;
    const int b = bh / H, h = bh % H, j = threadIdx.x;
    const long long step = (long long)H * HD;      // elements a time step
    const long long base = (long long)b * T * step + (long long)h * HD + j;
    const long long sb = (long long)bh * HD * HD + j;
    us[j] = u[h * HD + j];
    float S[HD];
#pragma unroll
    for (int i = 0; i < HD; ++i) S[i] = s0 != nullptr ? s0[sb + i * HD] : 0.0f;
    for (int t0 = 0; t0 < T; t0 += CH) {
        const int n = min(CH, T - t0);
        __syncthreads();                 // the last chunk's reads are done
        for (int c = 0; c < n; ++c) {
            const long long off = base + (t0 + c) * step;
            rs[c][j] = r[off];
            ks[c][j] = k[off];
            ws[c][j] = w[off];
            vs[c][j] = v[off];
        }
        __syncthreads();
        for (int c = 0; c < n; ++c) {
            const float vj = vs[c][j];
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int i = 0; i < HD; ++i) {
                const float kv = __fmul_rn(ks[c][i], vj);
                acc[i & 3] = __fadd_rn(
                    acc[i & 3],
                    __fmul_rn(rs[c][i], __fadd_rn(S[i], __fmul_rn(us[i], kv))));
                S[i] = __fadd_rn(__fmul_rn(ws[c][i], S[i]), kv);
            }
            y[base + (t0 + c) * step] =
                __fadd_rn(__fadd_rn(acc[0], acc[1]), __fadd_rn(acc[2], acc[3]));
        }
    }
#pragma unroll
    for (int i = 0; i < HD; ++i) s_out[sb + i * HD] = S[i];
}

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int T, int H, cudaStream_t stream) {
    wkv6_kernel<HD><<<B * H, HD, 0, stream>>>(r, k, v, w, u, s0, y, s_out,
                                             T, H);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers; s0 may
// be null (a zero state); the stream is the caller's cudaStream_t.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for
// a head dim other than 32 or 64.  The caller checks shapes, contiguity
// and B·T·H·hd < 2**31.
extern "C" int wkv6(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* s0,
                    float* y, float* s_out, int B, int T, int H, int hd,
                    void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (hd == 64) return launch<64>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    if (hd == 32) return launch<32>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
