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
// equals it bit for bit.  y is summed in another order than the plain
// version's and XLA's einsum (and with FMAs), so it is held to a
// tolerance.
//
// What bounds it on an H100.  At rwkv6-7b's prefill (B 1, T 4096, H 64,
// hd 64) the work is 7 float32 ops a (step, i, j): 7.5 GFLOP, 0.112 ms at
// the CUDA cores' 67 TFLOP/s, against 5 x 67 MB of r, k, v, w and y
// (0.10 ms at 3.35 TB/s); that is the bound chip_smoke.wkv6_bound prints.
// The exact form has an instruction floor above it: S's multiply, multiply
// and add cannot fuse (S must round as the plain version does), y's
// multiply-adds can, so about 6 instructions a (t, i, j) with the loads:
// 6.4 x 10^9 instructions over 132 SMs x 128 lanes x 1.98 GHz, about
// 0.19 ms.  The serial dependence over T is not the limit: a step's chain
// is a multiply and an add, about 0.017 ms over 4,096 steps.
//
// Design.  S's update is elementwise over (i, j) and only y sums over i,
// so the state is spread over the card.  The grid is (b, h, j-slice): a
// block owns JB columns of one head's S, all hd rows, and 4 or more blocks
// share a head at hd 64 (ops.py wkv6_plan picks JB from B·H and the SM
// count).  Thread (g, x) of a block (x fastest) owns rows 4g .. 4g + 3 of
// columns j0 + 2x, j0 + 2x + 1 in registers for the whole sequence, so
// neighbouring threads touch neighbouring j when S0 is read and S
// written.  u lives in registers.  A step: r, k and w of the thread's four
// rows are one 16-byte shared load each, its two v_j one 8-byte load (a
// row's loads serve two columns, half the shared-memory traffic an
// element of one column a thread; a 4 x 4 tile leaves one warp a
// scheduler and took 0.470 against 0.440 ms at prefill on an H100); kv, then
// S = w·S + kv with __fmul_rn / __fadd_rn, and the thread's partials of
// its two y_j (four rows each, by FMA) go to shared memory at (step, g,
// 2x), so no barrier is needed a step.  Once a chunk of CH steps the
// block sums each (step, j)'s partials over g in a fixed order and
// writes y: y is deterministic.  The
// next chunk's r, k, w (the block's rows: all hd) and v (its JB columns)
// are copied with cp.async into a two-slot ring while the current chunk
// computes, as the level loops and tree_solve stage theirs.  Every block
// of a head reads that head's r, k and w (hd / JB times in all, from L2
// after the first).
//
// Not taken: the chunked tensor-core form (a chunk's decays as running
// products, the state carried between chunks by matrix products).  It
// rounds S differently, so S would no longer equal wkv6_ref bit for bit,
// and the decays' products over a chunk underflow unless it works in log
// space with sub-chunks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;           // steps a chunk (one ring slot)
constexpr int TI = 4;            // rows of S a thread
constexpr int TJ = 2;            // columns of S a thread

// TJ consecutive floats (8 bytes, aligned) to and from registers
__device__ __forceinline__ void load2(float (&d)[TJ], const float* p) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x;
    d[1] = t.y;
}

__device__ __forceinline__ void store2(float* p, const float (&s)[TJ]) {
    *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest committed group have landed (this thread's copies)
__device__ __forceinline__ void cp_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// HD: head dim; JB: columns of S a block.  HD/TI x JB/TJ threads.
template <int HD, int JB>
__global__ void __launch_bounds__(HD / TI * (JB / TJ))
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ y, float* __restrict__ s_out, int T, int H) {
    constexpr int NG = HD / TI;                  // row groups
    constexpr int NX = JB / TJ;                  // column tiles
    constexpr int NT = NG * NX;                  // threads
    constexpr int NS = HD / JB;                  // blocks a head
    constexpr int RQ = HD / 4;                   // 16-byte pieces of a row
    constexpr int VQ = JB / 4;                   // of a j-slice of v
    __shared__ __align__(16) float rs[2][CH][HD];
    __shared__ __align__(16) float ks[2][CH][HD];
    __shared__ __align__(16) float ws[2][CH][HD];
    __shared__ __align__(16) float vs[2][CH][JB];
    __shared__ __align__(16) float part[CH][NG][JB];

    const int tid = threadIdx.x, g = tid / NX, x = tid % NX;
    const int bh = blockIdx.x / NS, j0 = (blockIdx.x % NS) * JB;
    const int b = bh / H, h = bh % H;
    const long long step = (long long)H * HD;    // elements a time step
    const long long base = (long long)b * T * step + (long long)h * HD;
    const long long sb = (long long)bh * HD * HD + (long long)TI * g * HD
                         + j0 + TJ * x;

    // chunk n's r, k, w rows and v columns into ring slot n % 2 (steps past
    // T are not copied)
    auto stage = [&](int n) {
        const int t0 = n * CH, slot = n & 1;
#pragma unroll
        for (int p0 = 0; p0 < CH * RQ; p0 += NT) {
            const int p = p0 + tid, c = p / RQ, col = (p % RQ) * 4;
            if ((CH * RQ % NT == 0 || p < CH * RQ) && t0 + c < T) {
                const long long off = base + (t0 + c) * step + col;
                cp16(&rs[slot][c][col], r + off);
                cp16(&ks[slot][c][col], k + off);
                cp16(&ws[slot][c][col], w + off);
            }
        }
#pragma unroll
        for (int p0 = 0; p0 < CH * VQ; p0 += NT) {
            const int p = p0 + tid, c = p / VQ, col = (p % VQ) * 4;
            if ((CH * VQ % NT == 0 || p < CH * VQ) && t0 + c < T)
                cp16(&vs[slot][c][col], v + base + (t0 + c) * step + j0 + col);
        }
    };

    float S[TI][TJ], uu[TI];
#pragma unroll
    for (int q = 0; q < TI; ++q) {
        if (s0 != nullptr) {
            load2(S[q], s0 + sb + q * HD);
        } else {
#pragma unroll
            for (int e = 0; e < TJ; ++e) S[q][e] = 0.0f;
        }
        uu[q] = u[h * HD + TI * g + q];
    }
    const int nchunks = (T + CH - 1) / CH;
    stage(0);
    cp_commit();
    for (int n = 0; n < nchunks; ++n) {
        if (n + 1 < nchunks) stage(n + 1);
        cp_commit();                     // (empty on the last chunk)
        cp_wait_one();                   // chunk n has landed ...
        __syncthreads();                 // ... for every thread; and the
                                         // last chunk's partials are read
        const int t0 = n * CH, cn = min(CH, T - t0), slot = n & 1;
#pragma unroll 4
        for (int c = 0; c < cn; ++c) {
            const float4 r4 = *reinterpret_cast<const float4*>(
                &rs[slot][c][TI * g]);
            const float4 k4 = *reinterpret_cast<const float4*>(
                &ks[slot][c][TI * g]);
            const float4 w4 = *reinterpret_cast<const float4*>(
                &ws[slot][c][TI * g]);
            float vj[TJ], acc[TJ];
            load2(vj, &vs[slot][c][TJ * x]);
            const float rr[TI] = {r4.x, r4.y, r4.z, r4.w};
            const float kk[TI] = {k4.x, k4.y, k4.z, k4.w};
            const float wd[TI] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < TJ; ++e) acc[e] = 0.0f;
#pragma unroll
            for (int q = 0; q < TI; ++q)
#pragma unroll
                for (int e = 0; e < TJ; ++e) {
                    const float kv = __fmul_rn(kk[q], vj[e]);
                    acc[e] = fmaf(rr[q], fmaf(uu[q], kv, S[q][e]), acc[e]);
                    S[q][e] = __fadd_rn(__fmul_rn(wd[q], S[q][e]), kv);
                }
            store2(&part[c][g][TJ * x], acc);
        }
        __syncthreads();                 // the chunk's partials are in;
                                         // slot n % 2 is free again
        for (int p = tid; p < cn * JB; p += NT) {
            const int c = p / JB, jj = p % JB;
            float sum = part[c][0][jj];
#pragma unroll
            for (int q = 1; q < NG; ++q) sum += part[c][q][jj];
            y[base + (t0 + c) * step + j0 + jj] = sum;
        }
    }
#pragma unroll
    for (int q = 0; q < TI; ++q) store2(s_out + sb + q * HD, S[q]);
}

template <int HD, int JB>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* s0, float* y, float* s_out, int B,
           int T, int H, cudaStream_t stream) {
    wkv6_kernel<HD, JB><<<B * H * (HD / JB), HD / TI * (JB / TJ), 0,
                          stream>>>(r, k, v, w, u, s0, y, s_out, T, H);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface (loaded with ctypes).  Pointers are device pointers, each
// 16-byte aligned (s0 and s_out 8-byte); s0 may be null (a zero state);
// jb: the columns of S a block (ops.py wkv6_plan: 16, 8 or 4 at hd 64; 8
// or 4 at hd 32); the
// stream is the caller's cudaStream_t.  Returns cudaGetLastError() after
// the launch, cudaErrorInvalidValue for another (hd, jb).  The caller
// checks shapes, contiguity and B·T·H·hd < 2**31.
extern "C" int wkv6(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* s0,
                    float* y, float* s_out, int B, int T, int H, int hd,
                    int jb, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (hd == 64 && jb == 16)
        return launch<64, 16>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    if (hd == 64 && jb == 8)
        return launch<64, 8>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    if (hd == 64 && jb == 4)
        return launch<64, 4>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    if (hd == 32 && jb == 8)
        return launch<32, 8>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    if (hd == 32 && jb == 4)
        return launch<32, 4>(r, k, v, w, u, s0, y, s_out, B, T, H, st);
    return static_cast<int>(cudaErrorInvalidValue);
}
