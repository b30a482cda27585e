// Flash attention, prefill route, for Hopper (sm_90a): bf16 on the tensor
// cores through wgmma, tiles brought in by TMA.  Plain C interface.
//
// Replaces, with csrc/flash_decode.cu and csrc/flash_attention.cu, the TPU
// kernel of the JAX package:
//   flash_attention_kernel (body _attn_kernel)
//       repro/kernels/flash_attention/kernel.py:69 (:28)
// and computes what csrc/flash_attention.cu's header states: scores in
// float32 scaled by 1/sqrt(d), -1e30 for a masked key, -inf (p exactly 0)
// for a key past Tk in a ragged tile, the running maximum seeded at -1e30,
// out = acc / max(l, 1e-30) in bf16; at kv_len = 0 every score is -1e30 and
// the row averages all Tk values.  GQA: query head h reads key/value head
// h / (H / Hkv).  This route takes bf16 with (d, dv) of (64, 64), (128,
// 128), (192, 128) (MLA: q and k carry the rope part, v does not) or (80,
// 80) (hubert), pointers and strides 16-byte aligned (ops.py
// select_route).
//
// What bounds it on an H100.  At the causal prefill shape (B·H = 24 heads
// over 8, T = 4096, d = 128) the work is 4·d operations per live (query,
// key) pair: 103 GFLOP, 0.104 ms at the tensor cores' 989 TFLOP/s, against
// 0.10 GB of q, k, v and out (0.03 ms at 3.35 TB/s): operations.  So the
// products must run on the tensor cores, and the loads and the softmax
// must not hold them up.  At MLA's causal prefill (H 16, T 4096, d 192,
// dv 128) the work is 2·(d + dv) operations a live pair, 86 GFLOP, 0.087
// ms; at hubert's non-causal one (H 16, T 4096, d 80) 4·d, the same
// 0.087 ms.
//
// Design.  A block owns 128 query rows of one head and holds them in
// shared memory; two consumer warpgroups own 64 rows each, and one
// producer warp issues every copy (288 threads).  The producer loads the
// q tile once, then walks the key tiles (128 keys) through a ring of two
// stages of K and V in shared memory, each filled by TMA
// (cp.async.bulk.tensor, 4-D tensor maps over (d, T, head, batch) built
// from the call's element strides, so the model layout [B, T, H, d] and
// the kernel layout [BH, T, d] load alike) and completed on an mbarrier;
// the consumers release a stage on a second mbarrier.  Rows past Tq and
// keys past Tk come in as zeros (the tensor map's bounds).  Per tile a
// consumer warpgroup computes S = Q·Kᵀ with wgmma.m64n128k16 (f32
// accumulators, both operands read from shared memory, K-major, in the
// 128-byte swizzle that TMA wrote), scales S in float32, masks only the
// tiles that cross kv_len, Tk or the causal diagonal, runs the online
// softmax in registers (a row's scores sit on the four threads of a quad;
// scores in log2 units, p = ex2(s - m)), rounds P to bf16 in registers
// (the accumulator's layout is the A operand's) and adds P·V with one
// wgmma.m64n64k16 per 64 output columns, V read from shared memory
// MN-major.  l is summed in float32 from the unrounded p.  The two
// warpgroups take turns at the tensor cores (named barriers): one issues
// its S product only after the other has issued its own, so one's softmax
// runs while the other's products do.  Causal blocks stop at their
// diagonal tile, and the grid walks the q-tiles longest first, so the
// short ones fill the tail.  The two layouts run the same tiles in the
// same order: bit-equal results.
//
// Head dims.  The kernel is a template over DQK (q and k: DQK/64 column
// atoms), DV (v and out: DV/64 atoms) and DO (the output columns written,
// DO <= DV).  A stage holds K's bytes and V's bytes, which differ when
// DQK != DV.  Instances: (64, 64, 64) and (128, 128, 128) for d = dv
// (DO = DV compiles the column test away); (192, 128, 128) for
// MLA, whose shared memory is 1,024 (alignment) + 48 KB of q + 2 stages x
// (48 + 32) KB of K and V = 214,016 B, under the 232,448 B a block may
// have, so the two-stage ring and BQ = BK = 128 stay; and (128, 128, 80)
// for d = dv = 80: q, k and v load through tensor maps whose inner extent
// is 80, in two 64-column atoms, and TMA fills columns 80-127 with zeros
// as it fills rows past Tq and Tk; the products run at depth 128 and width
// 128 and the epilogue writes the first 80 columns.  That spends 1.6x the
// exact operations (128 / 80); the bound stays that of the exact work,
// 4·80 operations a live pair.  A route of k 80 / n 80 products with a
// 32-byte-swizzle tail atom would not spend them.

#include <cuda.h>            // CUtensorMap and its enums; no -lcuda: the
                             // encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                 // query rows a block
constexpr int BK = 128;                 // keys a tile
constexpr int STAGES = 2;               // K/V ring
constexpr int NCONSUMER = 256;          // two warpgroups
constexpr int NTHREADS = NCONSUMER + 32;
constexpr int ATOM = 64;                // bf16 columns in one 128-byte row
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
    CUtensorMap qmap, kmap, vmap;       // (d, T, head, batch), box 64 x 128
    __nv_bfloat16* out;
    long long so[3];                    // out's element strides of b, h, t
    int H, Hkv, Tq, Tk, causal, kv_len;
    float scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(bar) : "memory");
}

// wait until the barrier's phase differs from `parity`; a wait that never
// ends (a copy that never lands) traps, so the launch fails, not hangs
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (polls == (1u << 28)) asm volatile("trap;");
    }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
           "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (1ull << 62);
}

// K-major operand (Q, K): rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
    return sw128_desc(addr, 16, 1024);
}

// MN-major operand (V) of one 64-column atom: 8-key groups 1024 bytes
// apart.  With N = 64 there is one atom along N, so the stride between
// atoms is unused; both offsets carry 1024.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
    return sw128_desc(addr, 1024, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// S[64 x 128] (+)= A[64 x 16] · B[128 x 16]ᵀ, both from shared memory
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                    uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x 64] += P[64 x 16] (registers) · V[16 x 64] (shared, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// named barrier `id` over both consumer warpgroups (256 threads)
__device__ __forceinline__ void named_sync(int id) {
    asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
    asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// DQK: q's and k's columns in the products, DV: v's and out's, DO: the
// output columns written (header).  Shared memory, from a 1024-byte
// aligned base: q as DQK/64 column atoms of [BQ][64], then per stage K as
// DQK/64 atoms of [BK][64] and V as DV/64; every atom 128-byte swizzled by
// TMA.
template <int DQK, int DV, int DO>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_prefill_kernel(const __grid_constant__ Params p) {
    constexpr int NQ = DQK / ATOM;                   // q and k column atoms
    constexpr int NV = DV / ATOM;                    // v and out column atoms
    constexpr int NMAX = NQ > NV ? NQ : NV;
    constexpr uint32_t Q_ATOM = BQ * 128;            // bytes
    constexpr uint32_t KV_ATOM = BK * 128;
    constexpr uint32_t Q_BYTES = NQ * Q_ATOM;
    constexpr uint32_t K_BYTES = NQ * KV_ATOM;       // K of one tile
    constexpr uint32_t STAGE_BYTES = K_BYTES + NV * KV_ATOM;   // K and V
    extern __shared__ uint8_t smem_raw[];
    __shared__ __align__(8) uint64_t bars[2 * STAGES + 1];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t full0 = smem_u32(&bars[0]);       // full[s] = full0 + 8s
    const uint32_t empty0 = smem_u32(&bars[STAGES]);
    const uint32_t qbar = smem_u32(&bars[2 * STAGES]);

    const int bh = blockIdx.x;
    const int b = bh / p.H, h = bh % p.H;
    const int hk = h / (p.H / p.Hkv);
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest first
    // keys to visit: up to the last live one, or all Tk when none is live
    int kend = p.Tk;
    if (p.kv_len > 0) {
        kend = min(kend, p.kv_len);
        if (p.causal) kend = min(kend, q0 + BQ);
    }
    const int ntiles = (kend + BK - 1) / BK;
    const int live_end = min(p.Tk, p.kv_len);        // keys past it masked

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, NCONSUMER);
        }
        mbar_init(qbar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (threadIdx.x >= NCONSUMER) {                  // the producer warp
        if (threadIdx.x == NCONSUMER) {
            mbar_expect_tx(qbar, Q_BYTES);
            for (int a = 0; a < NQ; ++a)
                tma_load(base + a * Q_ATOM, &p.qmap, a * ATOM, q0, h, b, qbar);
            for (int i = 0; i < ntiles; ++i) {
                const int s = i % STAGES;
                mbar_wait(empty0 + 8 * s, ((i / STAGES) & 1) ^ 1);
                const uint32_t kdst = base + Q_BYTES + s * STAGE_BYTES;
                mbar_expect_tx(full0 + 8 * s, STAGE_BYTES);
                for (int a = 0; a < NMAX; ++a) {
                    if (a < NQ)
                        tma_load(kdst + a * KV_ATOM, &p.kmap, a * ATOM, i * BK,
                                 hk, b, full0 + 8 * s);
                    if (a < NV)
                        tma_load(kdst + K_BYTES + a * KV_ATOM, &p.vmap,
                                 a * ATOM, i * BK, hk, b, full0 + 8 * s);
                }
            }
        }
        return;
    }

    // consumers: warpgroup wg owns rows q0 + 64·wg ... + 63
    const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row_first = q0 + wg * 64;
    const int qrow = row_first + warp * 16 + lane / 4;  // and qrow + 8
    const uint32_t qa = base + wg * 64 * 128;

    float o[NV][32];
#pragma unroll
    for (int a = 0; a < NV; ++a)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[a][e] = 0.0f;
    // m in log2 units: scores are scaled by scale·log2(e), so p = 2^(s - m)
    // (a masked score stays -1e30: exp of it is 0 beside any live score)
    float m0 = MASKED, m1 = MASKED, l0 = 0.0f, l1 = 0.0f;
    const float scale2 = p.scale * LOG2E;

    // tensor-core turns: a warpgroup issues its S product only after the
    // other one has issued its own (named barriers 1 and 2), so one
    // warpgroup's softmax runs while the other's products do
    const int my_turn = 1 + wg, other_turn = 2 - wg;
    if (wg == 1) named_arrive(1);                    // warpgroup 0 first
    mbar_wait(qbar, 0);
    for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(full0 + 8 * s, (i / STAGES) & 1);
        const uint32_t kb = base + Q_BYTES + s * STAGE_BYTES;
        const uint32_t vb = kb + K_BYTES;

        float sc[64];
#pragma unroll
        for (int e = 0; e < 64; ++e) sc[e] = 0.0f;
        named_sync(my_turn);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
            const uint32_t off = (kk % 4) * 32;      // 16 columns = 32 bytes
            wgmma_m64n128k16_ss(sc,
                                kmajor_desc(qa + (kk / 4) * Q_ATOM + off),
                                kmajor_desc(kb + (kk / 4) * KV_ATOM + off), 1);
        }
        wgmma_commit();
        named_arrive(other_turn);
        wgmma_wait_all();

        // element e: key 8·(e/4) + 2·(lane%4) + e%2, row qrow + 8·((e/2)%2)
        const int k0 = i * BK;
        const bool edge = k0 + BK > live_end
                          || (p.causal && k0 + BK - 1 > row_first);
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            float x = sc[e] * scale2;
            if (edge) {
                const int key = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
                const int qp = qrow + 8 * ((e / 2) % 2);
                if (key >= p.Tk) x = -INFINITY;
                else if (key >= p.kv_len || (p.causal && key > qp)) x = MASKED;
            }
            sc[e] = x;
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            if ((e / 2) % 2 == 0) mx0 = fmaxf(mx0, sc[e]);
            else mx1 = fmaxf(mx1, sc[e]);
        }
        mx0 = quad_max(mx0);
        mx1 = quad_max(mx1);
        const float c0 = ex2(m0 - mx0);
        const float c1 = ex2(m1 - mx1);
        m0 = mx0;
        m1 = mx1;
        float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
            if ((e / 2) % 2 == 0) {
                sc[e] = ex2(sc[e] - mx0);
                ps0 += sc[e];
            } else {
                sc[e] = ex2(sc[e] - mx1);
                ps1 += sc[e];
            }
        }
        l0 = l0 * c0 + ps0;
        l1 = l1 * c1 + ps1;
#pragma unroll
        for (int a = 0; a < NV; ++a)
#pragma unroll
            for (int e = 0; e < 32; ++e)
                o[a][e] *= ((e / 2) % 2 == 0) ? c0 : c1;

        // P in bf16 as the A operand: keys 16·kk ... 16·kk + 15
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
            pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
            pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
            pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
            for (int a = 0; a < NV; ++a)
                wgmma_m64n64k16_rs(
                    o[a], pa[kk], mnmajor_desc(vb + a * KV_ATOM + kk * 2048));
        wgmma_commit();
        wgmma_wait_all();
        mbar_arrive(empty0 + 8 * s);
    }
    if (wg == 0) named_sync(1);          // warpgroup 1's last turn signal

    const float den0 = fmaxf(quad_sum(l0), 1e-30f);
    const float den1 = fmaxf(quad_sum(l1), 1e-30f);
    __nv_bfloat16* out = p.out + b * p.so[0] + h * p.so[1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int t = qrow + 8 * half;
        if (t >= p.Tq) continue;
        const float den = half ? den1 : den0;
        __nv_bfloat16* row = out + t * p.so[2];
#pragma unroll
        for (int a = 0; a < NV; ++a)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int c = a * ATOM + 8 * j + 2 * (lane % 4);
                if (DO < DV && c >= DO) continue;    // zero-filled columns
                *reinterpret_cast<__nv_bfloat162*>(row + c) =
                    __floats2bfloat162_rn(o[a][4 * j + 2 * half] / den,
                                          o[a][4 * j + 2 * half + 1] / den);
            }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* ptr = nullptr;
        cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(ptr);
    }
    return fn;
}

// 4-D map over (d, T, head, batch) with element strides st, sh, sb; boxes
// of 64 columns x `rows` rows of one head, 128-byte swizzle, zeros past
// the bounds.  Returns the driver's CUresult.
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int d, int T,
             int heads, int B, long long sb, long long sh, long long st,
             int rows) {
    if (sb == 0) sb = sh * heads;           // the kernel layout: one batch
    const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)T,
                                (cuuint64_t)heads, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)st * 2, (cuuint64_t)sh * 2,
                                   (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {ATOM, (cuuint32_t)rows, 1, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    return (int)enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                    const_cast<void*>(ptr), dims, strides, box, elem,
                    CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int DQK, int DV, int DO>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
    constexpr int NQ = DQK / ATOM, NV = DV / ATOM;
    const size_t smem = 1024 + (size_t)NQ * BQ * 128
                        + (size_t)STAGES * (NQ + NV) * BK * 128;
    auto kernel = flash_prefill_kernel<DQK, DV, DO>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(B * p.H, (p.Tq + BQ - 1) / BQ);
    kernel<<<grid, NTHREADS, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// q, k, v, out: bf16.  (d, dv): (64, 64), (128, 128), (192, 128) or (80,
// 80); any other pair returns cudaErrorInvalidValue.  strides: 12 element strides,
// (b, h, t) of q, k, v and out in that order (b's 0 for the kernel layout).
// kv_len <= 0 means no live key; pass Tk for no kv_len mask.  The caller
// checks shapes and the 16-byte alignment of pointers and strides.
// Returns 0, a cudaError_t, -1 when the driver's tensor-map encoder is not
// found, or -(1000 + CUresult) when it refuses a map.
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* out, int B, int H, int Hkv, int Tq, int Tk,
                             int d, int dv, const long long* strides,
                             int causal, int kv_len, float scale,
                             void* stream) {
    const bool pair_ok = (d == 64 && dv == 64) || (d == 128 && dv == 128)
                         || (d == 192 && dv == 128) || (d == 80 && dv == 80);
    if (!pair_ok) return (int)cudaErrorInvalidValue;
    const EncodeTiled enc = encoder();
    if (enc == nullptr) return -1;
    Params p;
    int rc = make_map(enc, &p.qmap, q, d, Tq, H, B, strides[0], strides[1],
                      strides[2], BQ);
    if (rc == 0)
        rc = make_map(enc, &p.kmap, k, d, Tk, Hkv, B, strides[3], strides[4],
                      strides[5], BK);
    if (rc == 0)
        rc = make_map(enc, &p.vmap, v, dv, Tk, Hkv, B, strides[6], strides[7],
                      strides[8], BK);
    if (rc != 0) return -(1000 + rc);
    p.out = static_cast<__nv_bfloat16*>(out);
    for (int i = 0; i < 3; ++i) p.so[i] = strides[9 + i];
    p.H = H;
    p.Hkv = Hkv;
    p.Tq = Tq;
    p.Tk = Tk;
    p.causal = causal;
    p.kv_len = kv_len;
    p.scale = scale;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (d == 64) return launch<64, 64, 64>(p, B, st);
    if (d == 192) return launch<192, 128, 128>(p, B, st);
    if (d == 80) return launch<128, 128, 80>(p, B, st);
    return launch<128, 128, 128>(p, B, st);
}
