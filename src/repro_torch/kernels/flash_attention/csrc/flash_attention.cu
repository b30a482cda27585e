// Flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel of the JAX package:
//   flash_attention_kernel (body _attn_kernel)
//       repro/kernels/flash_attention/kernel.py:69 (:28)
//
//   s[i,j]  = (q[i] * scale) . k[j]           scale = 1/sqrt(d), float32
//   s[i,j]  = -1e30 where j >= kv_len, or j > i when causal (positions
//             counted from 0 in q and k)
//   out[i]  = sum_j p[i,j] v[j] / max(l[i], 1e-30),  p = exp(s - m), the
//             running maximum m seeded at -1e30 and l = sum_j p[i,j],
//             cast to q's type (round to nearest)
//
// GQA: query head h of batch b reads key/value head h / (H / Hkv) of batch
// b.  Each of q, k, v and out is indexed as [b, h, t, i] through element
// strides (the last axis contiguous), so one entry point serves the model
// layout [B, T, H, d] (the KV cache [B, max_seq, Hkv, d] as it is, no
// transpose) and the kernel layout [BH, T, d] (B = 1).  Types: float32 or
// bfloat16 in and out (one instantiation each), float32 arithmetic.
//
// A row with no live key (kv_len = 0) sees every score at -1e30, so
// p = exp(0) = 1 for each of the Tk keys and the row averages all values:
// the TPU kernel's result, kept here by visiting all Tk keys in that case.
// Keys past Tk (the ragged tail of the last tile) are not keys: their
// score is -inf and their p exactly 0.  The TPU kernel asserts
// Tq % bq == 0 and Tk % bk == 0; this one masks the tails instead, since
// decode runs Tq = 1 against Tk = max_seq.
//
// What bounds it on an H100.  At the causal prefill shape (B·H = 24 heads,
// T = 4096, d = dv = 128) the work is 4·d per live (query, key) pair,
// 24·4096·4097/2 pairs: 103 GFLOP, 0.10 ms at the tensor cores' 989
// TFLOP/s in bf16, against 0.10 GB of q, k, v and out (0.03 ms at 3.35
// TB/s): operations.  At the decode shape (96 query heads of one token
// against 32 KV heads of 192 keys) it is 3.2 MB of cache read for 19 MFLOP:
// bytes, about 1 us.  This kernel is the simple one: float32 arithmetic on
// the CUDA cores (67 TFLOP/s, so at best ~1.5 ms at the prefill shape),
// no tensor cores, no TMA, no split over the keys for decode.
//
// Design.  A block of 4 warps owns BQ = 4·RQ query rows of one head (RQ = 4
// rows a warp when Tq >= 64, else 1, so decode's single row does not leave
// 63 rows of a tile idle) and walks the keys in tiles of 32, one key per
// lane.  The query tile (scaled), the key tile and the value tile are
// staged in shared memory as float32; a lane computes its key's score for
// each of its warp's rows (float4 reads; the key rows are padded to stride
// ceil4(d) + 4 floats, so a quarter-warp's reads fall in distinct banks),
// the warp reduces the tile's maximum with shuffles, and each lane keeps a
// partial l.  For the PV product lane c owns output columns c, c + 32, ...
// and takes p[j] from lane j by shuffle.  The TPU kernel's sequential KV
// grid axis, which carried m, l and acc in VMEM, becomes this loop; tiles
// past the last live key are skipped (their p is exactly 0 for every row
// that has a live key), so a causal block stops at its diagonal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BK = 32;                // keys per tile: one per lane
constexpr float MASKED = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    int H, Hkv, Tq, Tk, d, dv, causal, kv_len;
    float scale;
    long long sq[3], sk[3], sv[3], so[3];   // element strides of b, h, t
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
    return x;
}

// RQ: query rows per warp; NT: output columns per lane (dv <= 32·NT).
template <typename T, int RQ, int NT>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const Args a) {
    extern __shared__ float4 smem4[];
    constexpr int BQ = NWARPS * RQ;
    const int dq = (a.d + 3) & ~3;        // d rounded up to whole float4s
    const int ldk = dq + 4;
    float* Qs = reinterpret_cast<float*>(smem4);   // [BQ][dq]
    float* Ks = Qs + BQ * dq;                      // [BK][ldk]
    float* Vs = Ks + BK * ldk;                     // [BK][dv]

    const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
    const int hk = h / (a.H / a.Hkv);
    const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
    const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
    const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
    T* out = static_cast<T*>(a.out) + b * a.so[0] + h * a.so[1];
    const int q0 = blockIdx.x * BQ;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    for (int r = warp; r < BQ; r += NWARPS) {
        const int t = q0 + r;
        for (int i = lane; i < dq; i += 32)
            Qs[r * dq + i] = (t < a.Tq && i < a.d)
                ? to_f32(q[t * a.sq[2] + i]) * a.scale : 0.0f;
    }

    // keys to visit: up to the last live one, or all Tk when none is live
    int kend = a.Tk;
    if (a.kv_len > 0) {
        kend = min(kend, a.kv_len);
        if (a.causal) kend = min(kend, q0 + BQ);
    }

    float m[RQ], l[RQ], acc[RQ][NT];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        m[r] = MASKED;
        l[r] = 0.0f;
#pragma unroll
        for (int t = 0; t < NT; ++t) acc[r][t] = 0.0f;
    }

    for (int k0 = 0; k0 < kend; k0 += BK) {
        __syncthreads();                  // the previous tile is consumed
        for (int j = warp; j < BK; j += NWARPS) {
            const int kp = k0 + j;
            for (int i = lane; i < dq; i += 32)
                Ks[j * ldk + i] = (kp < a.Tk && i < a.d)
                    ? to_f32(k[kp * a.sk[2] + i]) : 0.0f;
            for (int c = lane; c < a.dv; c += 32)
                Vs[j * a.dv + c] = kp < a.Tk ? to_f32(v[kp * a.sv[2] + c]) : 0.0f;
        }
        __syncthreads();

        float s[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) s[r] = 0.0f;
        const float4* kr = reinterpret_cast<const float4*>(Ks + lane * ldk);
        const float4* qr = reinterpret_cast<const float4*>(Qs + warp * RQ * dq);
        for (int i4 = 0; i4 < dq / 4; ++i4) {
            const float4 kk = kr[i4];
#pragma unroll
            for (int r = 0; r < RQ; ++r) {
                const float4 qq = qr[r * (dq / 4) + i4];
                s[r] = fmaf(qq.x, kk.x, s[r]);
                s[r] = fmaf(qq.y, kk.y, s[r]);
                s[r] = fmaf(qq.z, kk.z, s[r]);
                s[r] = fmaf(qq.w, kk.w, s[r]);
            }
        }

        const int kp = k0 + lane;
        float p[RQ];
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
            const int qp = q0 + warp * RQ + r;
            const bool key = kp < a.Tk;
            const bool live = key && kp < a.kv_len && (!a.causal || kp <= qp);
            const float sc = live ? s[r] : (key ? MASKED : -INFINITY);
            const float m_new = fmaxf(m[r], warp_max(sc));
            const float corr = expf(m[r] - m_new);
            p[r] = expf(sc - m_new);
            l[r] = l[r] * corr + p[r];
            m[r] = m_new;
#pragma unroll
            for (int t = 0; t < NT; ++t) acc[r][t] *= corr;
        }

        const int jn = min(BK, kend - k0);
        for (int j = 0; j < jn; ++j) {
            float pj[RQ];
#pragma unroll
            for (int r = 0; r < RQ; ++r) pj[r] = __shfl_sync(FULL, p[r], j);
#pragma unroll
            for (int t = 0; t < NT; ++t) {
                const int c = lane + 32 * t;
                if (c < a.dv) {
                    const float vv = Vs[j * a.dv + c];
#pragma unroll
                    for (int r = 0; r < RQ; ++r)
                        acc[r][t] = fmaf(pj[r], vv, acc[r][t]);
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < RQ; ++r) {
        const float den = fmaxf(warp_sum(l[r]), 1e-30f);
        const int qp = q0 + warp * RQ + r;
        if (qp >= a.Tq) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
            const int c = lane + 32 * t;
            if (c < a.dv) store(out + qp * a.so[2] + c, acc[r][t] / den);
        }
    }
}

template <typename T, int RQ, int NT>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
    constexpr int BQ = NWARPS * RQ;
    const int dq = (a.d + 3) & ~3;
    const size_t smem = sizeof(float) * ((size_t)BQ * dq
                                         + (size_t)BK * (dq + 4)
                                         + (size_t)BK * a.dv);
    auto kernel = flash_attention_kernel<T, RQ, NT>;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((a.Tq + BQ - 1) / BQ, B * a.H);
    kernel<<<grid, NTHREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t stream) {
    if (a.Tq >= 64)
        return a.dv <= 128 ? launch<T, 4, 4>(a, B, stream)
                           : launch<T, 4, 8>(a, B, stream);
    return a.dv <= 128 ? launch<T, 1, 4>(a, B, stream)
                       : launch<T, 1, 8>(a, B, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, t) of
// q, k, v and out in that order.  kv_len <= 0 means no live key; pass Tk
// for no kv_len mask.  The caller checks shapes (d, dv <= 256, H % Hkv ==
// 0, B·H <= 65535).  Returns the launch's cudaError_t.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int dtype, int B, int H, int Hkv,
                               int Tq, int Tk, int d, int dv,
                               const long long* strides, int causal,
                               int kv_len, float scale, void* stream) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.out = out;
    a.H = H;
    a.Hkv = Hkv;
    a.Tq = Tq;
    a.Tk = Tk;
    a.d = d;
    a.dv = dv;
    a.causal = causal;
    a.kv_len = kv_len;
    a.scale = scale;
    for (int i = 0; i < 3; ++i) {
        a.sq[i] = strides[i];
        a.sk[i] = strides[3 + i];
        a.sv[i] = strides[6 + i];
        a.so[i] = strides[9 + i];
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dtype == 1 ? dispatch<__nv_bfloat16>(a, B, st)
                      : dispatch<float>(a, B, st);
}
