// Mamba selective scan for Hopper (sm_90a), plain C interface: a Mamba
// layer's decay, input, recurrence, output and skip in one launch.
//
// Replaces, on the serving path, the TPU kernel of the JAX package
//   linear_scan_kernel (body _scan_kernel)
//       repro/kernels/linear_scan/kernel.py:53 (:30)
// together with the reference lines that build its inputs and finish its
// output (repro/models/ssm.py:155-166: dt·A, exp, (dt·x)·B, the scan, the
// skip y + x·D, the cast).  Per batch b, channel d, state s, time t:
//
//   a        = expf(dt[b,t,d] * A[d,s])             dt*A rounded first
//   bx       = (dt[b,t,d] * x[b,t,d]) * B[b,t,s]    two roundings, in order
//   h[d,s]   = a * h[d,s] + bx                      __fmul_rn, __fadd_rn
//   y[b,t,d] = sum_s h[d,s] * C[b,t,s] + x[b,t,d] * Dskip[d]
//
// with h starting at h0[b,d,s].  dt, A, Dskip, h0 and h are float32; x, B,
// C and y are float32 or bfloat16 (one type; widened exactly), y rounded
// once to it.  These are the plain version's operations and roundings
// (mamba_scan_ref), so h is its h bit for bit wherever expf agrees with
// torch.exp (neither is built with fast math); y's sum over s runs in
// another order.  decay() below is the one place a is formed, and the
// helper kernel mamba_decay exposes it so a check can hold it against
// torch.exp alone.
//
// What bounds it on an H100.  Nothing of size [T, Di, S] exists: a and bx
// live in registers.  At jamba's prefill (B 1, T 4096, Di 16384, S 16,
// bf16 x) it reads dt (268 MB), x (134 MB), B, C, A, Dskip and h0 and
// writes y (134 MB) and h: 0.54 GB, 0.16 ms at 3.35 TB/s, against 8.86 GB
// for the linear scan with a and b·x in memory.  It takes 1.07e9 expf,
// each one MUFU.EX2 of the special-function unit (16 a clock an SM:
// 4.18e12 a second at 1.98 GHz), 0.26 ms; its 6.4 GFLOP take 0.10 ms at
// 67 TFLOP/s.  So the prefill is bound by expf; expf's range reduction
// (~7 FP32 instructions around each MUFU.EX2) keeps the FP32 pipe close
// behind.  At decode (B 4, T 1) it moves ~10 MB (h0 and h 4.2 MB each):
// bytes, ~3 us, where a launch costs about as much.
//
// Prefill schedule (T above the wrapper's DECODE_MAX_T).  A block owns
// CH = 32 channels of one sequence for all of T, so h never leaves a
// register: a thread carries NS = 4 states of one channel (TPC = 1, 2, 4
// or 8 threads a channel for S up to 4, 8, 16, 32).  Time goes in chunks
// of TC = 32 steps: a double-buffered cp.async ring in shared memory
// carries the next chunk's rows of dt and x (128 / 64 coalesced bytes a
// row) and of B and C while the current chunk computes; each thread
// widens the bfloat16 pieces it copied to float32 once, so a step reads
// dt, x, and 16 bytes each of B and C with no conversion.  Steps go in
// groups of G = 8: their expf depend on dt alone, not on h, so they
// overlap the dependent multiply-add chain, and the group's sums over s
// are one reduce-scatter over the TPC lanes (log2(TPC) shuffles for TPC
// steps), after which each lane adds the skip and stages y for its own
// step.  y is written as whole rows of the chunk.  Two __syncthreads a
// chunk.  In the SASS the step loop issues about 18 instructions an
// element, one of them a MUFU.EX2 and eight more of them expf's
// (chip_smoke.py phase 3 counts them), so the instruction issue slots, not
// the special-function unit, set the pace.
//
// Decode schedule (T up to DECODE_MAX_T: 1, measured).  No shared memory and no __syncthreads.  A
// block of 256 threads owns 256 / TPC channels and all B sequences, so A
// and Dskip are read once, not B times; a thread takes BU = 4 sequences at
// once, so their 16-byte h0 loads are in flight together, and reads dt, x,
// B and C straight through L1 (B and C are one broadcast row a warp).
// jamba's decode (Di 16384, S 16) is 256 blocks: under two waves over 132
// SMs.
//
// Ragged T, Di and S (1 <= S <= 32) are masked.  Rows that are not whole
// 16-byte pieces at 16-byte addresses (S or Di off the vector width, odd
// row strides) take the VEC = false instances: scalar loads, and the ring
// filled by plain loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 4;              // states a thread carries
constexpr int CH = 32;             // channels a prefill block
constexpr int TC = 32;             // time steps a chunk of the ring
constexpr int DEC_THREADS = 256;   // threads a decode block
constexpr int BU = 4;              // sequences a decode thread takes at once
constexpr int MAX_S = 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

// The decay a = exp(dt·A): the product rounded, then expf (no fast math).
__device__ __forceinline__ float decay(float dt, float A) {
    return expf(__fmul_rn(dt, A));
}

// Four consecutive values at p (aligned to four elements), widened.
__device__ __forceinline__ void load4(const float* p, float (&v)[NS]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[NS]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
}

// A thread's NS values at p, of which the first n are real (0 elsewhere,
// and everywhere when !ok).  VEC: n is a multiple of 4 and p aligned.
template <bool VEC, typename T>
__device__ __forceinline__ void load_row(const T* p, bool ok, int n,
                                         float (&v)[NS]) {
    if (VEC && ok && n > 0) {
        load4(p, v);
        return;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) v[j] = ok && j < n ? to_f32(p[j]) : 0.f;
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* p, int n,
                                          const float (&v)[NS]) {
    if (VEC) {
        if (n > 0) *reinterpret_cast<float4*>(p) =
                       make_float4(v[0], v[1], v[2], v[3]);
        return;
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
        if (j < n) p[j] = v[j];
}

// One time step of a thread's NS states; returns its part of y's sum.
__device__ __forceinline__ float step(float (&h)[NS], const float (&A)[NS],
                                      float dt, float dx,
                                      const float (&Bv)[NS],
                                      const float (&Cv)[NS]) {
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
        const float a = decay(dt, A[j]);
        h[j] = __fadd_rn(__fmul_rn(a, h[j]), __fmul_rn(dx, Bv[j]));
        p = fmaf(h[j], Cv[j], p);
    }
    return p;
}

// The sum over the TPC neighbouring lanes that carry one channel.
template <int TPC>
__device__ __forceinline__ float lane_sum(float p) {
#pragma unroll
    for (int o = TPC / 2; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
    return p;
}

__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The prefill block's shared memory: two stages of the ring, in float32,
// and y's chunk.  A bfloat16 chunk lands in the raw arrays (cp.async moves
// bytes) and each thread widens the pieces it copied itself.
template <typename T, int TPC>
struct Ring {
    static constexpr int SP = NS * TPC;      // S padded to the lanes
    static constexpr int RAW = sizeof(T) == 4 ? 1 : TC;
    float dt[2][TC][CH];
    float x[2][TC][CH];
    float b[2][TC][SP];
    float c[2][TC][SP];
    T xraw[2][RAW][CH];
    T braw[2][RAW][SP];
    T craw[2][RAW][SP];
    T y[TC][CH];
};

// Eight bfloat16 at src (16-byte aligned) as eight float32 at dst.
__device__ __forceinline__ void widen8(float* dst, const __nv_bfloat16* src) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
        dst[2 * i] = __low2float(v);
        dst[2 * i + 1] = __high2float(v);
    }
}

// Lane q of the TPC neighbouring lanes that carry one channel gets the sum
// over those lanes of p[q]: a reduce-scatter, log2(TPC) shuffles for TPC
// steps' sums where a butterfly per step takes TPC·log2(TPC).
template <int TPC>
__device__ __forceinline__ float reduce_scatter(float* p, int q) {
#pragma unroll
    for (int o = TPC / 2; o > 0; o >>= 1) {
        const bool hi = q & o;
#pragma unroll
        for (int i = 0; i < o; ++i) {
            const float keep = hi ? p[i + o] : p[i];
            const float send = hi ? p[i] : p[i + o];
            p[i] = keep + __shfl_xor_sync(FULL, send, o);
        }
    }
    return p[0];
}

template <typename T, int TPC, bool VEC>
__global__ void __launch_bounds__(CH * TPC)
mamba_scan_prefill(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const T* __restrict__ Bm,
                   const T* __restrict__ Cm, const float* __restrict__ Dsk,
                   const float* __restrict__ h0, T* __restrict__ y,
                   float* __restrict__ hout, int Tn, int Di, int S,
                   long long sBb, long long sBt, long long sCb,
                   long long sCt) {
    constexpr int NT = CH * TPC;
    constexpr int SP = NS * TPC;
    constexpr bool WIDE = sizeof(T) == 4;
    // steps a group: a multiple of TPC for the reduce-scatter, 8 at least
    // (8 measured 2 % faster than 4 at jamba's prefill on an H100)
    constexpr int G = TPC < 8 ? 8 : TPC;
    static_assert(TC % G == 0, "a chunk is whole groups");
    __shared__ __align__(16) Ring<T, TPC> sm;
    const int tid = threadIdx.x;
    const int q = tid % TPC;
    const int c = tid / TPC;
    const int s0 = q * NS;
    const int d0 = blockIdx.x * CH;
    const int d = d0 + c;
    const bool live = d < Di;
    const long long bb = blockIdx.y;
    const T* Bb = Bm + bb * sBb;
    const T* Cb = Cm + bb * sCb;

    // states [S, SP) of B and C stay 0 in both stages: nothing writes them
    for (int i = tid; i < 2 * TC * SP; i += NT) {
        if (i % SP >= S) {
            (&sm.b[0][0][0])[i] = 0.f;
            (&sm.c[0][0][0])[i] = 0.f;
        }
    }
    float Av[NS], h[NS];
    const long long hrow = (bb * Di + d) * S + s0;
    load_row<VEC>(A + (long long)d * S + s0, live, S - s0, Av);
    load_row<VEC>(h0 + hrow, live, S - s0, h);
    const float Dv = live ? Dsk[d] : 0.f;

    // 16-byte pieces: of a dt row, of an x row and of a B or C row
    constexpr int DP = CH * 4 / 16;
    constexpr int XE = 16 / sizeof(T);
    constexpr int XP = CH / XE;
    const int BP = S / XE;

    // fill stage `buf` with time steps t0 .. t0 + TC - 1 (as many as exist)
    auto stage = [&](int buf, int t0) {
        const int n = min(TC, Tn - t0);
        const long long row0 = bb * Tn + t0;
        if constexpr (VEC) {
            for (int i = tid; i < n * DP; i += NT) {
                const int r = i / DP, k = (i % DP) * 4;
                if (d0 + k < Di)
                    cp16(&sm.dt[buf][r][k], dt + (row0 + r) * Di + d0 + k);
            }
            for (int i = tid; i < n * XP; i += NT) {
                const int r = i / XP, k = (i % XP) * XE;
                if (d0 + k < Di)
                    cp16(WIDE ? static_cast<void*>(&sm.x[buf][r][k])
                              : static_cast<void*>(&sm.xraw[buf][r][k]),
                         x + (row0 + r) * Di + d0 + k);
            }
            for (int i = tid; i < n * BP; i += NT) {
                const int r = i / BP, k = (i % BP) * XE;
                cp16(WIDE ? static_cast<void*>(&sm.b[buf][r][k])
                          : static_cast<void*>(&sm.braw[buf][r][k]),
                     Bb + (t0 + r) * sBt + k);
                cp16(WIDE ? static_cast<void*>(&sm.c[buf][r][k])
                          : static_cast<void*>(&sm.craw[buf][r][k]),
                     Cb + (t0 + r) * sCt + k);
            }
        } else {
            for (int i = tid; i < n * CH; i += NT) {
                const int r = i / CH, k = i % CH;
                if (d0 + k < Di) {
                    sm.dt[buf][r][k] = dt[(row0 + r) * Di + d0 + k];
                    sm.x[buf][r][k] = to_f32(x[(row0 + r) * Di + d0 + k]);
                }
            }
            for (int i = tid; i < n * S; i += NT) {
                const int r = i / S, k = i % S;
                sm.b[buf][r][k] = to_f32(Bb[(t0 + r) * sBt + k]);
                sm.c[buf][r][k] = to_f32(Cb[(t0 + r) * sCt + k]);
            }
        }
    };
    // after the wait: widen the bfloat16 pieces this thread copied itself
    // (its own cp.async copies are visible to it; the barrier that follows
    // publishes the widened values)
    auto widen = [&](int buf, int t0) {
        if constexpr (VEC && !WIDE) {
            const int n = min(TC, Tn - t0);
            for (int i = tid; i < n * XP; i += NT) {
                const int r = i / XP, k = (i % XP) * XE;
                if (d0 + k < Di) widen8(&sm.x[buf][r][k], &sm.xraw[buf][r][k]);
            }
            for (int i = tid; i < n * BP; i += NT) {
                const int r = i / BP, k = (i % BP) * XE;
                widen8(&sm.b[buf][r][k], &sm.braw[buf][r][k]);
                widen8(&sm.c[buf][r][k], &sm.craw[buf][r][k]);
            }
        }
    };

    const int nchunk = (Tn + TC - 1) / TC;
    stage(0, 0);
    cp_commit();
    for (int k = 0; k < nchunk; ++k) {
        const int buf = k & 1;
        const int t0 = k * TC;
        const int n = min(TC, Tn - t0);
        if (k + 1 < nchunk) {
            stage(buf ^ 1, t0 + TC);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        widen(buf, t0);
        __syncthreads();         // stage `buf` landed; y's chunk was written
        // G steps a group.  Rows r >= n of the last chunk hold stale
        // values: h skips them and their sums are not stored.
        for (int r0 = 0; r0 < n; r0 += G) {
            float p[G];
#pragma unroll
            for (int u = 0; u < G; ++u) {
                const int r = r0 + u;
                const float dtv = sm.dt[buf][r][c];
                const float dx = __fmul_rn(dtv, sm.x[buf][r][c]);
                float Bv[NS], Cv[NS];
                load4(&sm.b[buf][r][s0], Bv);
                load4(&sm.c[buf][r][s0], Cv);
                if (r < n) {                     // the same for the block
#pragma unroll
                    for (int j = 0; j < NS; ++j)
                        h[j] = __fadd_rn(__fmul_rn(decay(dtv, Av[j]), h[j]),
                                         __fmul_rn(dx, Bv[j]));
                }
                p[u] = 0.f;
#pragma unroll
                for (int j = 0; j < NS; ++j) p[u] = fmaf(h[j], Cv[j], p[u]);
            }
#pragma unroll
            for (int g = 0; g < G; g += TPC) {
                const float v = reduce_scatter<TPC>(p + g, q);
                const int r = r0 + g + q;        // this lane's step
                if (r < n)
                    put(&sm.y[r][c],
                        __fadd_rn(v, __fmul_rn(sm.x[buf][r][c], Dv)));
            }
        }
        __syncthreads();         // y's chunk is complete; stage `buf` read
        for (int i = tid; i < n * CH; i += NT) {
            const int r = i / CH, kk = i % CH;
            if (d0 + kk < Di)
                y[(bb * Tn + t0 + r) * Di + d0 + kk] = sm.y[r][kk];
        }
    }
    if (live) store_row<VEC>(hout + hrow, S - s0, h);
}

template <typename T, int TPC, bool VEC>
__global__ void __launch_bounds__(DEC_THREADS)
mamba_scan_decode(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const T* __restrict__ Bm,
                  const T* __restrict__ Cm, const float* __restrict__ Dsk,
                  const float* __restrict__ h0, T* __restrict__ y,
                  float* __restrict__ hout, int B, int Tn, int Di, int S,
                  long long sBb, long long sBt, long long sCb,
                  long long sCt) {
    constexpr int CHD = DEC_THREADS / TPC;
    const int q = threadIdx.x % TPC;
    const int s0 = q * NS;
    const int d = blockIdx.x * CHD + threadIdx.x / TPC;
    const bool live = d < Di;
    const long long DS = (long long)Di * S;
    float Av[NS];
    load_row<VEC>(A + (long long)d * S + s0, live, S - s0, Av);
    const float Dv = live ? Dsk[d] : 0.f;
    for (int b0 = 0; b0 < B; b0 += BU) {
        float h[BU][NS];
#pragma unroll
        for (int u = 0; u < BU; ++u)
            load_row<VEC>(h0 + (b0 + u) * DS + (long long)d * S + s0,
                          live && b0 + u < B, S - s0, h[u]);
        for (int t = 0; t < Tn; ++t) {
#pragma unroll
            for (int u = 0; u < BU; ++u) {
                const bool seq = b0 + u < B;
                const bool ok = live && seq;
                const long long row = (long long)(b0 + u) * Tn + t;
                const float dtv = ok ? dt[row * Di + d] : 0.f;
                const float xv = ok ? to_f32(x[row * Di + d]) : 0.f;
                float Bv[NS], Cv[NS];
                load_row<VEC>(Bm + (b0 + u) * sBb + t * sBt + s0, seq,
                              S - s0, Bv);
                load_row<VEC>(Cm + (b0 + u) * sCb + t * sCt + s0, seq,
                              S - s0, Cv);
                const float p = lane_sum<TPC>(
                    step(h[u], Av, dtv, __fmul_rn(dtv, xv), Bv, Cv));
                if (q == 0 && ok)
                    put(y + row * Di + d, __fadd_rn(p, __fmul_rn(xv, Dv)));
            }
        }
#pragma unroll
        for (int u = 0; u < BU; ++u)
            if (live && b0 + u < B)
                store_row<VEC>(hout + (b0 + u) * DS + (long long)d * S + s0,
                               S - s0, h[u]);
    }
}

__global__ void mamba_decay_kernel(const float* __restrict__ dt,
                                   const float* __restrict__ A,
                                   float* __restrict__ a, long long N, int Di,
                                   int S) {
    const long long total = N * Di * S;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
         i < total; i += (long long)gridDim.x * blockDim.x) {
        const long long nd = i / S;
        const int s = static_cast<int>(i % S);
        const int dd = static_cast<int>(nd % Di);
        a[i] = decay(dt[nd], A[(long long)dd * S + s]);
    }
}

struct Args {
    const void *x, *dt, *A, *Bm, *Cm, *Dsk, *h0;
    void *y, *h;
    int B, T, Di, S;
    long long sBb, sBt, sCb, sCt;
};

template <typename T, int TPC, bool VEC>
int run(const Args& g, int schedule, cudaStream_t st) {
    const T* x = static_cast<const T*>(g.x);
    const T* Bm = static_cast<const T*>(g.Bm);
    const T* Cm = static_cast<const T*>(g.Cm);
    const float* dt = static_cast<const float*>(g.dt);
    const float* A = static_cast<const float*>(g.A);
    const float* Dsk = static_cast<const float*>(g.Dsk);
    const float* h0 = static_cast<const float*>(g.h0);
    T* y = static_cast<T*>(g.y);
    float* h = static_cast<float*>(g.h);
    if (schedule == 0) {
        constexpr int CHD = DEC_THREADS / TPC;
        mamba_scan_decode<T, TPC, VEC><<<(g.Di + CHD - 1) / CHD, DEC_THREADS,
                                         0, st>>>(
            x, dt, A, Bm, Cm, Dsk, h0, y, h, g.B, g.T, g.Di, g.S, g.sBb,
            g.sBt, g.sCb, g.sCt);
    } else {
        dim3 grid((g.Di + CH - 1) / CH, g.B);
        mamba_scan_prefill<T, TPC, VEC><<<grid, CH * TPC, 0, st>>>(
            x, dt, A, Bm, Cm, Dsk, h0, y, h, g.T, g.Di, g.S, g.sBb, g.sBt,
            g.sCb, g.sCt);
    }
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int by_state(const Args& g, int schedule, cudaStream_t st) {
    if (g.S <= 4) return run<T, 1, VEC>(g, schedule, st);
    if (g.S <= 8) return run<T, 2, VEC>(g, schedule, st);
    if (g.S <= 16) return run<T, 4, VEC>(g, schedule, st);
    return run<T, 8, VEC>(g, schedule, st);
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Every row the kernels move as 16-byte pieces is whole pieces at 16-byte
// addresses: dt, x and y rows (Di), B and C rows (S, their strides), and
// the 4-state groups of A, h0 and h.
template <typename T>
int dispatch(const Args& g, int schedule, cudaStream_t st) {
    const long long e = sizeof(T);
    const bool vec = g.S % 4 == 0 && (g.S * e) % 16 == 0 && g.Di % 4 == 0 &&
                     (g.Di * e) % 16 == 0 && (g.sBb * e) % 16 == 0 &&
                     (g.sBt * e) % 16 == 0 && (g.sCb * e) % 16 == 0 &&
                     (g.sCt * e) % 16 == 0 && aligned16(g.x) &&
                     aligned16(g.dt) && aligned16(g.A) && aligned16(g.Bm) &&
                     aligned16(g.Cm) && aligned16(g.h0) && aligned16(g.y) &&
                     aligned16(g.h);
    return vec ? by_state<T, true>(g, schedule, st)
               : by_state<T, false>(g, schedule, st);
}

}  // namespace

// x, y [B, T, Di] and B, C [B, T, S] (rows of S contiguous, strides sBb,
// sBt, sCb, sCt in elements) in one type (dtype 0: float32, 1: bfloat16);
// dt [B, T, Di], A [Di, S], Dskip [Di], h0 and h [B, Di, S] float32; all
// but B and C contiguous.  schedule 0: decode, 1: prefill.  Returns the
// cudaError_t of the launch (0 when it was accepted).
extern "C" int mamba_scan(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, const void* Dsk,
                          const void* h0, void* y, void* h, int dtype, int B,
                          int T, int Di, int S, long long sBb, long long sBt,
                          long long sCb, long long sCt, int schedule,
                          void* stream) {
    if (B < 1 || T < 1 || Di < 1 || S < 1 || S > MAX_S || B > 65535 ||
        (schedule != 0 && schedule != 1))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args g{x, dt, A, Bm, Cm, Dsk, h0, y, h, B, T, Di, S,
                 sBb, sBt, sCb, sCt};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 1 ? dispatch<__nv_bfloat16>(g, schedule, st)
                      : dispatch<float>(g, schedule, st);
}

// a [N, Di, S] = expf(dt·A) for dt [N, Di] and A [Di, S], float32 and
// contiguous: the scan's decay alone, for holding it against torch.exp.
extern "C" int mamba_decay(const void* dt, const void* A, void* a,
                           long long N, int Di, int S, void* stream) {
    if (N < 1 || Di < 1 || S < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long total = N * Di * S;
    const long long want = (total + 255) / 256;
    const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
    mamba_decay_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(dt), static_cast<const float*>(A),
        static_cast<float*>(a), N, Di, S);
    return static_cast<int>(cudaGetLastError());
}
