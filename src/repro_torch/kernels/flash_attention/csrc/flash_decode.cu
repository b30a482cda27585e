// Flash attention, decode route, for Hopper (sm_90a): a few query rows
// against a KV cache, split over the keys, on the CUDA cores.  Plain C
// interface.
//
// Replaces, with csrc/flash_prefill.cu and csrc/flash_attention.cu, the TPU
// kernel of the JAX package:
//   flash_attention_kernel (body _attn_kernel)
//       repro/kernels/flash_attention/kernel.py:69 (:28)
// and computes what csrc/flash_attention.cu's header states: scores in
// float32 scaled by 1/sqrt(d), -1e30 for a masked key, the running maximum
// seeded at -1e30, out = acc / max(l, 1e-30) in q's type; at kv_len = 0
// every score is -1e30 and the row averages all Tk values.  GQA: query head
// h reads key/value head h / (H / Hkv).  This route takes Tq <= 16 in
// float32 or bf16 with d = dv and a row of 64, 128, 256 or 512 bytes, or
// bf16 with d 192 and dv 128 (MLA), pointers and strides 16-byte aligned
// (ops.py select_route).
//
// What bounds it on an H100.  At the decode shape (B 4, 24 query heads over
// 8, one token against a 192-key cache, d = 128, bf16) the call reads 3.2
// MB of cache for 19 MFLOP: bytes, about 1 us at 3.35 TB/s, and below that
// the launch itself.  So the only gain is to move fewer bytes, to spread
// them over the SMs, and to keep the chain of dependent steps short.  At
// MLA's decode (B 4, 16 heads over 16, one token against 192 keys, d 192,
// dv 128) it reads 7.9 MB: 2.4 us.
//
// Design.  One block of 8 warps owns one (batch, KV head) group: all n_rep
// x Tq query rows that read that KV head (in chunks of RC = 4 or 8 rows),
// so each K/V byte is read from memory once a call, not n_rep times.
// The group's live keys are cut into `splits` contiguous ranges of `kps`
// keys, one block each (ops.py decode_splits picks the count from the live
// keys, so that groups x splits covers the SMs where the keys allow it).
// A row of K is read by LK lanes, CK chunks of 16 bytes each, and a row
// of V by the same LK lanes, CV chunks each (chunk c of lane x at 16-byte
// column c·LK + x, so a warp's loads stay contiguous), straight into
// registers, a batch of up to 32 keys a row group in flight at once; a
// warp's 4 q rows sit in registers too.  LK is a power of two for the
// shuffles: d = dv rows take CK = CV = 1 and LK = the row's 16-byte
// chunks; MLA's bf16 rows (384 and 256 bytes) LK 8, CK 3, CV 2.  The
// wide rows' registers (q 4 x 24 floats, acc 4 x 16) allow one block an
// SM, and a batch of one step.  Each group of LK lanes reduces its
// scores by shuffle and keeps its own online softmax (m, l, acc; one max
// and one rescale a batch, exponentials as ex2 in log2 units) over the keys
// it reads; the groups of a warp merge by shuffle, the warps of a row group
// through shared memory, in a fixed order.  A block writes its (m, l, acc)
// to scratch, and the last block of a group to finish (a per-device
// counter, reset to 0 by that block) merges the splits in split order,
// weighting each by 2^(m_s - M): one launch a call, no float atomics, the
// same sums whatever the strides.  With one split the block writes out
// directly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_SPLITS = 16;
constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* out;
    float* part_acc;     // [blocks][splits][RC][dv]
    float* part_ml;      // [blocks][splits][RC][2]
    int* counters;       // one a block column (group x row chunk), zeroed
    int H, Hkv, Tq, dv, causal, kv_len;
    int kend, splits, kps, nchunks;
    float scale;
    long long sq[3], sk[3], sv[3], so[3];   // element strides of b, h, t
};

// 16 bytes of q, k or v, read-only
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// 16 loaded bytes → float32
__device__ __forceinline__ void unpack(uint4 v, float (&x)[4]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
}
__device__ __forceinline__ void unpack(uint4 v, float (&x)[8]) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
}

// (m, l, acc) ← the merge of (m, l, acc) and (mo, lo, acco); m in log2
// units
template <int N>
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[N],
                                      float mo, float lo,
                                      const float (&acco)[N]) {
    const float mn = fmaxf(m, mo);
    const float wa = ex2(m - mn), wb = ex2(mo - mn);
    l = l * wa + lo * wb;
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = acc[e] * wa + acco[e] * wb;
    m = mn;
}

// LK: lanes a row (4, 8, 16 or 32); CK, CV: 16-byte chunks of a K row and
// of a V row a lane (header); RC: rows a block (4 or 8).  A warp holds RW
// = 4 rows: with RC = 8 the warps form two row groups, each reading all
// the split's keys (the second read of a K/V row comes from cache), so
// every lane's registers stay at 4 rows.
template <typename T, int LK, int CK, int CV, int RC>
__global__ void __launch_bounds__(NTHREADS, CK + CV > 2 ? 1 : 2)
flash_decode_kernel(const Args a) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int QW = CK * VEC, VW = CV * VEC;   // a lane's q/k, v columns
    constexpr int RW = 4;                   // rows a warp
    constexpr int KWN = NWARPS * RW / RC;   // warps of a row group
    constexpr int KW = 32 / LK;             // keys a warp step
    constexpr int KB = KWN * KW;            // keys a row group's step
    // steps a batch: 32 keys a row group where 4 steps reach that far; one
    // for the wide rows
    constexpr int U = CK + CV > 2 ? 1
                      : LK / KWN > 4 ? 4 : LK / KWN > 1 ? LK / KWN : 1;
    __shared__ __align__(16) float sm_acc[NWARPS][RW][256];
    __shared__ float sm_m[NWARPS][RW], sm_l[NWARPS][RW];
    __shared__ float sm_w[MAX_SPLITS * RC], sm_ls[MAX_SPLITS * RC];
    __shared__ float sm_den[RC];
    __shared__ int last;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int rg = warp / KWN, kw = warp % KWN;       // row group, its warp
    const int ks = lane / LK, c = (lane % LK) * VEC;  // key slot, columns
    // (chunk j of the lane: columns c + j·LK·VEC ... + VEC - 1)
    const int col = blockIdx.x;                        // group x row chunk
    const int grp = col / a.nchunks, chunk = col % a.nchunks;
    const int b = grp / a.Hkv, hk = grp % a.Hkv;
    const int n_rep = a.H / a.Hkv;
    const int row0 = chunk * RC;
    const int nrows = min(RC, n_rep * a.Tq - row0);
    const int split = blockIdx.y;
    const int kb = split * a.kps, ke = min(a.kend, kb + a.kps);
    const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1] + c;
    const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1] + c;
    const float scale2 = a.scale * LOG2E;

    // row r of the chunk: query head hk·n_rep + (row0 + r) / Tq at position
    // (row0 + r) % Tq; rows past nrows are zeros.  This warp's rows are
    // rg·RW + 0 ... 3.
    uint4 qraw[RW][CK];
    int qpos[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int rr = rg * RW + r, row = row0 + rr;
        qpos[r] = row % a.Tq;
#pragma unroll
        for (int j = 0; j < CK; ++j)
            qraw[r][j] = rr < nrows
                ? load16(static_cast<const T*>(a.q) + b * a.sq[0]
                         + (hk * n_rep + row / a.Tq) * a.sq[1]
                         + qpos[r] * a.sq[2] + c + j * LK * VEC)
                : make_uint4(0, 0, 0, 0);
    }

    float m[RW], l[RW], acc[RW][VW], qv[RW][QW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        m[r] = MASKED;
        l[r] = 0.0f;
#pragma unroll
        for (int e = 0; e < VW; ++e) acc[r][e] = 0.0f;
    }

    // key kp = k0 + u·KB + kw·KW + ks; the loop bounds are the block's
    for (int k0 = kb; k0 < ke; k0 += U * KB) {
        uint4 kraw[U][CK], vraw[U][CV];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int kp = k0 + u * KB + kw * KW + ks;
#pragma unroll
            for (int j = 0; j < CK; ++j) kraw[u][j] = make_uint4(0, 0, 0, 0);
#pragma unroll
            for (int j = 0; j < CV; ++j) vraw[u][j] = make_uint4(0, 0, 0, 0);
            if (kp < ke) {
#pragma unroll
                for (int j = 0; j < CK; ++j)
                    kraw[u][j] = load16(k + kp * a.sk[2] + j * LK * VEC);
#pragma unroll
                for (int j = 0; j < CV; ++j)
                    vraw[u][j] = load16(v + kp * a.sv[2] + j * LK * VEC);
            }
        }
        if (k0 == kb) {                 // q lands with the first keys
#pragma unroll
            for (int r = 0; r < RW; ++r)
#pragma unroll
                for (int j = 0; j < CK; ++j) {
                    float x[VEC];
                    unpack(qraw[r][j], x);
#pragma unroll
                    for (int e = 0; e < VEC; ++e) qv[r][j * VEC + e] = x[e];
                }
        }
        // scores of the batch's U keys (reduced over the LK lanes of a
        // row), then one online-softmax step a row over all U of them;
        // scores in log2 units (scale·log2 e), a masked one -1e30, none
        // past ke (-inf: p = 0)
        float sc[U][RW];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int kp = k0 + u * KB + kw * KW + ks;
            // a chunk of k at a time, against every row (the wide rows
            // keep one chunk unpacked, not three)
            float s0[RW], s1[RW];
#pragma unroll
            for (int r = 0; r < RW; ++r) s0[r] = s1[r] = 0.0f;
#pragma unroll
            for (int j = 0; j < CK; ++j) {
                float kf[VEC];
                unpack(kraw[u][j], kf);
#pragma unroll
                for (int r = 0; r < RW; ++r)
#pragma unroll
                    for (int e = 0; e < VEC; e += 2) {
                        s0[r] = fmaf(qv[r][j * VEC + e], kf[e], s0[r]);
                        s1[r] = fmaf(qv[r][j * VEC + e + 1], kf[e + 1], s1[r]);
                    }
            }
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                float s = s0[r] + s1[r];
#pragma unroll
                for (int o = LK / 2; o > 0; o >>= 1)
                    s += __shfl_xor_sync(FULL, s, o);
                const bool live = kp < a.kv_len && (!a.causal || kp <= qpos[r]);
                sc[u][r] = kp >= ke ? -INFINITY : live ? s * scale2 : MASKED;
            }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            float mn = m[r];
#pragma unroll
            for (int u = 0; u < U; ++u) mn = fmaxf(mn, sc[u][r]);
            const float corr = ex2(m[r] - mn);
            float ps = 0.0f;
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[r][e] *= corr;
#pragma unroll
            for (int u = 0; u < U; ++u) {
                const float p = ex2(sc[u][r] - mn);
                ps += p;
#pragma unroll
                for (int j = 0; j < CV; ++j) {
                    float vf[VEC];
                    unpack(vraw[u][j], vf);
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                        acc[r][j * VEC + e] =
                            fmaf(p, vf[e], acc[r][j * VEC + e]);
                }
            }
            l[r] = l[r] * corr + ps;
            m[r] = mn;
        }
    }

    // the warp's key slots, then the row group's warps, merged in a fixed
    // order
#pragma unroll
    for (int r = 0; r < RW; ++r) {
#pragma unroll
        for (int o = LK; o < 32; o <<= 1) {
            float acco[VW];
#pragma unroll
            for (int e = 0; e < VW; ++e)
                acco[e] = __shfl_xor_sync(FULL, acc[r][e], o);
            const float mo = __shfl_xor_sync(FULL, m[r], o);
            const float lo = __shfl_xor_sync(FULL, l[r], o);
            merge<VW>(m[r], l[r], acc[r], mo, lo, acco);
        }
        if (ks == 0) {
#pragma unroll
            for (int j = 0; j < CV; ++j)
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                    sm_acc[warp][r][c + j * LK * VEC + e] = acc[r][j * VEC + e];
            if (lane == 0) {
                sm_m[warp][r] = m[r];
                sm_l[warp][r] = l[r];
            }
        }
    }
    __syncthreads();

    // thread → (row, 4 columns): the block's (m, l, acc) of that row
    T* out = static_cast<T*>(a.out);
    const int c4 = a.dv / 4;
    const long long first = (long long)col * a.splits * RC;
    for (int idx = tid; idx < RC * c4; idx += NTHREADS) {
        const int rr = idx / c4, cc = (idx % c4) * 4;
        const int w0 = (rr / RW) * KWN, r = rr % RW;
        float mr = sm_m[w0][r], lr = sm_l[w0][r];
        float o4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) o4[e] = sm_acc[w0][r][cc + e];
#pragma unroll
        for (int w = 1; w < KWN; ++w) {
            float acco[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) acco[e] = sm_acc[w0 + w][r][cc + e];
            merge<4>(mr, lr, o4, sm_m[w0 + w][r], sm_l[w0 + w][r], acco);
        }
        if (a.splits == 1) {
            if (rr < nrows) {
                const int row = row0 + rr;
                T* dst = out + b * a.so[0] + (hk * n_rep + row / a.Tq) * a.so[1]
                         + (row % a.Tq) * a.so[2] + cc;
                const float den = fmaxf(lr, 1e-30f);
#pragma unroll
                for (int e = 0; e < 4; ++e) store(dst + e, o4[e] / den);
            }
        } else {
            const long long slot = first + (long long)split * RC + rr;
            *reinterpret_cast<float4*>(a.part_acc + slot * a.dv + cc) =
                make_float4(o4[0], o4[1], o4[2], o4[3]);
            if (cc == 0)
                *reinterpret_cast<float2*>(a.part_ml + slot * 2) =
                    make_float2(mr, lr);
        }
    }
    if (a.splits == 1) return;

    // the group's last block to finish merges the splits
    __syncthreads();
    if (tid == 0) {
        // release the block's partials (ordered before by the barrier) and
        // acquire the other blocks': one acq_rel add at gpu scope
        int done;
        asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                     : "=r"(done) : "l"(a.counters + col) : "memory");
        last = done == a.splits - 1;
        if (last) a.counters[col] = 0;  // ready for the next launch
    }
    __syncthreads();
    if (!last) return;

    // every split's partials at once: (m, l) to shared memory, and for 4
    // output columns of one row a thread, the splits' acc to registers;
    // then the weights 2^(m_s - M) and the merged l of each row, and the
    // sums in split order
    const int idx0 = tid, r0 = idx0 / c4, cc0 = (idx0 % c4) * 4;
    float4 x[MAX_SPLITS];
    if (idx0 < nrows * c4) {
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            if (s < a.splits)
                x[s] = __ldcg(reinterpret_cast<const float4*>(
                    a.part_acc + (first + s * RC + r0) * a.dv + cc0));
    }
    for (int idx = tid; idx < a.splits * RC; idx += NTHREADS) {
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(
            a.part_ml + (first + idx) * 2));
        sm_w[idx] = ml.x;
        sm_ls[idx] = ml.y;
    }
    __syncthreads();
    if (tid < nrows) {
        float M = MASKED;
        for (int s = 0; s < a.splits; ++s) M = fmaxf(M, sm_w[s * RC + tid]);
        float L = 0.0f;
        for (int s = 0; s < a.splits; ++s) {
            const float w = ex2(sm_w[s * RC + tid] - M);
            sm_w[s * RC + tid] = w;
            L += w * sm_ls[s * RC + tid];
        }
        sm_den[tid] = fmaxf(L, 1e-30f);
    }
    __syncthreads();
    for (int idx = idx0; idx < nrows * c4; idx += NTHREADS) {
        const int r = idx / c4, cc = (idx % c4) * 4;
        if (idx != idx0) {              // more than 128 (row, 4 columns)
#pragma unroll
            for (int s = 0; s < MAX_SPLITS; ++s)
                if (s < a.splits)
                    x[s] = __ldcg(reinterpret_cast<const float4*>(
                        a.part_acc + (first + s * RC + r) * a.dv + cc));
        }
        float o4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int s = 0; s < MAX_SPLITS; ++s)
            if (s < a.splits) {
                const float w = sm_w[s * RC + r];
                o4[0] = fmaf(w, x[s].x, o4[0]);
                o4[1] = fmaf(w, x[s].y, o4[1]);
                o4[2] = fmaf(w, x[s].z, o4[2]);
                o4[3] = fmaf(w, x[s].w, o4[3]);
            }
        const int row = row0 + r;
        T* dst = out + b * a.so[0] + (hk * n_rep + row / a.Tq) * a.so[1]
                 + (row % a.Tq) * a.so[2] + cc;
#pragma unroll
        for (int e = 0; e < 4; ++e) store(dst + e, o4[e] / sm_den[r]);
    }
}

template <typename T, int LK, int CK, int CV, int RC>
cudaError_t launch(const Args& a, int blocks, cudaStream_t stream) {
    flash_decode_kernel<T, LK, CK, CV, RC>
        <<<dim3(blocks, a.splits), NTHREADS, 0, stream>>>(a);
    return cudaGetLastError();
}

// d = dv rows: one chunk a lane of K and of V
template <typename T, int RC>
cudaError_t dispatch_lanes(const Args& a, int d, int blocks,
                           cudaStream_t stream) {
    switch (d * (int)sizeof(T) / 16) {
        case 4: return launch<T, 4, 1, 1, RC>(a, blocks, stream);
        case 8: return launch<T, 8, 1, 1, RC>(a, blocks, stream);
        case 16: return launch<T, 16, 1, 1, RC>(a, blocks, stream);
        default: return launch<T, 32, 1, 1, RC>(a, blocks, stream);
    }
}

template <typename T>
cudaError_t dispatch(const Args& a, int d, int rc, int blocks,
                     cudaStream_t stream) {
    return rc == 4 ? dispatch_lanes<T, 4>(a, d, blocks, stream)
                   : dispatch_lanes<T, 8>(a, d, blocks, stream);
}

// MLA's bf16 rows, d 192 and dv 128: 8 lanes a row, 3 chunks of K and 2
// of V a lane
cudaError_t dispatch_mla(const Args& a, int rc, int blocks,
                         cudaStream_t stream) {
    return rc == 4 ? launch<__nv_bfloat16, 8, 3, 2, 4>(a, blocks, stream)
                   : launch<__nv_bfloat16, 8, 3, 2, 8>(a, blocks, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  strides: 12 element strides, (b, h, t) of
// q, k, v and out in that order.  d = dv, d · sizeof(dtype) of 64, 128, 256
// or 512 bytes, or bf16 d 192 and dv 128; any other (dtype, d, dv) returns
// cudaErrorInvalidValue.  kv_len <= 0 means no live key; pass Tk for no kv_len mask.
// kend: the keys visited (ref.py live_keys); rc: rows a block (4 or 8) and
// nchunks = ceil(n_rep·Tq / rc); splits x kps covers kend (ops.py
// decode_splits, splits <= 16).  part_acc, part_ml: float32 scratch of
// B·Hkv·nchunks·splits·rc·dv and ·2 floats; counters: B·Hkv·nchunks ints,
// zero between launches (the kernel leaves them so).  The caller checks
// shapes (Tq <= 16) and the 16-byte alignment of pointers and strides.
// Returns the launch's cudaError_t.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            void* out, float* part_acc, float* part_ml,
                            int* counters, int dtype, int B, int H, int Hkv,
                            int Tq, int d, int dv, const long long* strides,
                            int causal, int kv_len, int kend, int splits,
                            int kps, int rc, int nchunks, float scale,
                            void* stream) {
    Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.out = out;
    a.part_acc = part_acc;
    a.part_ml = part_ml;
    a.counters = counters;
    a.H = H;
    a.Hkv = Hkv;
    a.Tq = Tq;
    a.dv = dv;
    a.causal = causal;
    a.kv_len = kv_len;
    a.kend = kend;
    a.splits = splits;
    a.kps = kps;
    a.nchunks = nchunks;
    a.scale = scale;
    for (int i = 0; i < 3; ++i) {
        a.sq[i] = strides[i];
        a.sk[i] = strides[3 + i];
        a.sv[i] = strides[6 + i];
        a.so[i] = strides[9 + i];
    }
    const int blocks = B * Hkv * nchunks;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 1 && d == 192 && dv == 128)
        return dispatch_mla(a, rc, blocks, st);
    const int row = d * (dtype == 1 ? 2 : 4);
    if (d != dv || (row != 64 && row != 128 && row != 256 && row != 512))
        return (int)cudaErrorInvalidValue;
    return dtype == 1 ? dispatch<__nv_bfloat16>(a, d, rc, blocks, st)
                      : dispatch<float>(a, d, rc, blocks, st);
}
