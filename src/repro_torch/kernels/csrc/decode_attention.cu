// Split-KV grouped-query decode attention for NVIDIA Hopper (sm_90a),
// float32 or bfloat16 cache.
//
// Replaces the Pallas TPU kernel decode_attention_kernel (_kernel) of
// src/repro/kernels/decode_attention/kernel.py.  Its combine (kernel.py
// lines 118-123, plain JAX there) stays plain PyTorch in the port
// (repro_torch/kernels/decode_attention/kernel.py::combine_splits).
//
// What it computes: one query token per (batch, head) against a
// fixed-capacity cache k/v (B, S, KV, hd).  The rep = H / KV query heads that
// share a kv head form one group; the cache is cut into `splits` segments of
// ceil(S / splits) positions, and each (batch, kv head, segment) emits the
// unnormalised online-softmax partial
//     m = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j,
//     s_j = (q * hd^-0.5) . k_j  over positions j < length in the segment,
// in float32.  A segment that starts at or beyond `length` reads nothing and
// writes m = -1e30, l = 0, acc = 0, so its combine weight exp(m - m_tot) is
// exactly 0, as the reference's fully masked partial weighs 0.
//
// What bounds it on the H100: bytes.  Decode reads every cached k and v
// row up to `length` once and does 4 * rep * hd flops per row: at the serving
// shape (B 8, KV 2, rep 8, hd 128, length 2176, bf16) one call reads 17.8 MB,
// 5.3 us at 3.35 TB/s, against 0.3 GFLOP.  What the design does about that:
//   * each k/v row is read once for all rep heads of its group (the grouped
//     layout is the point: a head-repeated cache would read it rep times);
//   * a warp takes one cache position at a time, each lane a contiguous
//     hd/32 slice of the row, so a row is one coalesced 256-byte load;
//   * `length` is a kernel argument, so one build serves every fill level, and
//     a segment stops at `length` instead of masking a full cache;
//   * the segments give B * KV * splits blocks, so the card is filled even
//     at B * KV = 16 (the reference's default of one split would leave 116 of
//     132 SMs idle); `splits`, the tile length and the block size are tuned.
// Per tile of `block_s` positions: scores into shared memory (warp
// reductions), one online-softmax update per head, then the rescaled
// accumulators (registers, per warp) take the tile's p @ v; the warps'
// accumulators are summed in shared memory at the end.
//
// Plain C interface: decode_attention_{f32,bf16} launch on the given stream,
// do not synchronise, allocate nothing, and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_REP = 16;
constexpr int MAX_THREADS = 512;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Load N consecutive elements (N * sizeof(T) in {2, 4, 8, 16} bytes, aligned)
// as one vector load and widen them to float32.
template <int BYTES> struct RawVec;
template <> struct RawVec<2> { using type = unsigned short; };
template <> struct RawVec<4> { using type = unsigned int; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<16> { using type = uint4; };

// A lane's slice of hd 96 or 192 (3 or 6 elements) is no power-of-two
// width: it is loaded element by element (a warp still reads the row's
// contiguous bytes).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float out[N]) {
    constexpr int BYTES = (int)(N * sizeof(T));
    if constexpr (BYTES == 2 || BYTES == 4 || BYTES == 8 || BYTES == 16) {
        using V = typename RawVec<BYTES>::type;
        const V raw = *reinterpret_cast<const V*>(p);
        const T* elem = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < N; ++e) out[e] = to_f32(elem[e]);
    } else {
#pragma unroll
        for (int e = 0; e < N; ++e) out[e] = to_f32(p[e]);
    }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// Shared memory, in floats (must match the Python-side check).
__host__ __device__ inline int64_t smem_floats(int rep, int hd, int block_s,
                                               int threads) {
    return (int64_t)rep * hd              // qs: scaled queries
         + (int64_t)rep * block_s         // sc: scores, then probabilities
         + 3LL * rep                      // m, l, alpha
         + (int64_t)(threads / 32) * rep * hd;   // per-warp accumulators
}

template <typename T, int HD>
__global__ void __launch_bounds__(MAX_THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, float* __restrict__ acc_out,
              float* __restrict__ m_out, float* __restrict__ l_out, int s_len,
              int kv, int rep, int length, int seg, int splits, int block_s,
              float scale) {
    constexpr int V = HD / 32;            // elements of a row per lane
    extern __shared__ float smem[];
    const int nwarps = blockDim.x / 32;
    float* qs = smem;
    float* sc = qs + rep * HD;
    float* m_s = sc + rep * block_s;
    float* l_s = m_s + rep;
    float* a_s = l_s + rep;
    float* red = a_s + rep;

    const int sp = blockIdx.x % splits;
    const int bg = blockIdx.x / splits;   // b * kv + g
    const int b = bg / kv, g = bg % kv;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // partial outputs: (B, splits, KV, rep, hd) and (B, splits, KV, rep)
    const int64_t part = ((int64_t)b * splits + sp) * kv + g;
    float* acc_g = acc_out + part * rep * HD;
    const int end = min(length, s_len);
    const int lo = sp * seg;
    const int hi = min(lo + seg, end);
    if (lo >= hi) {                       // segment wholly at/after `length`
        for (int e = tid; e < rep * HD; e += blockDim.x) acc_g[e] = 0.f;
        for (int r = tid; r < rep; r += blockDim.x) {
            m_out[part * rep + r] = NEG_INF;
            l_out[part * rep + r] = 0.f;
        }
        return;
    }

    const T* qg = q + (int64_t)bg * rep * HD;
    for (int e = tid; e < rep * HD; e += blockDim.x) qs[e] = to_f32(qg[e]) * scale;
    for (int r = tid; r < rep; r += blockDim.x) {
        m_s[r] = NEG_INF;
        l_s[r] = 0.f;
    }
    float acc[MAX_REP][V];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r][e] = 0.f;
    __syncthreads();

    const int64_t row_stride = (int64_t)kv * HD;     // one cache position
    const T* kg = k + ((int64_t)b * s_len * kv + g) * HD + lane * V;
    const T* vg = v + ((int64_t)b * s_len * kv + g) * HD + lane * V;

    for (int t0 = lo; t0 < hi; t0 += block_s) {
        const int n = min(block_s, hi - t0);
        // scores of this tile: one warp per position, lanes over hd
        for (int j = warp; j < n; j += nwarps) {
            float kr[V];
            load_row<T, V>(kg + (int64_t)(t0 + j) * row_stride, kr);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
                if (r < rep) {
                    const float* qr = qs + r * HD + lane * V;
                    float part_dot = 0.f;
#pragma unroll
                    for (int e = 0; e < V; ++e) part_dot = fmaf(qr[e], kr[e], part_dot);
                    part_dot = warp_sum(part_dot);
                    if (lane == 0) sc[r * block_s + j] = part_dot;
                }
            }
        }
        __syncthreads();
        // online-softmax update: one warp per head
        for (int r = warp; r < rep; r += nwarps) {
            float* row = sc + r * block_s;
            float mx = NEG_INF;
            for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
            mx = warp_max(mx);
            const float m_old = m_s[r];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
            for (int j = lane; j < n; j += 32) {
                const float p = expf(row[j] - m_new);
                row[j] = p;
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();
        // acc = acc * alpha + p @ v, each warp over its positions
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
            if (r < rep) {
                const float alpha = a_s[r];
#pragma unroll
                for (int e = 0; e < V; ++e) acc[r][e] *= alpha;
            }
        }
        for (int j = warp; j < n; j += nwarps) {
            float vr[V];
            load_row<T, V>(vg + (int64_t)(t0 + j) * row_stride, vr);
#pragma unroll
            for (int r = 0; r < MAX_REP; ++r) {
                if (r < rep) {
                    const float p = sc[r * block_s + j];
#pragma unroll
                    for (int e = 0; e < V; ++e) acc[r][e] = fmaf(p, vr[e], acc[r][e]);
                }
            }
        }
        __syncthreads();                  // sc / a_s are rewritten next tile
    }

    // sum the warps' accumulators
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
        if (r < rep) {
#pragma unroll
            for (int e = 0; e < V; ++e)
                red[((int64_t)warp * rep + r) * HD + lane * V + e] = acc[r][e];
        }
    }
    __syncthreads();
    for (int e = tid; e < rep * HD; e += blockDim.x) {
        float s = 0.f;
        for (int w = 0; w < nwarps; ++w) s += red[(int64_t)w * rep * HD + e];
        acc_g[e] = s;
    }
    for (int r = tid; r < rep; r += blockDim.x) {
        m_out[part * rep + r] = m_s[r];
        l_out[part * rep + r] = l_s[r];
    }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* acc, void* m,
              void* l, int batch, int s_len, int kv, int rep, int length,
              int splits, int block_s, int threads, float scale, void* stream) {
    const size_t smem = (size_t)smem_floats(rep, HD, block_s, threads) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int seg = (s_len + splits - 1) / splits;
    const int64_t blocks = (int64_t)batch * kv * splits;
    decode_kernel<T, HD><<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (float*)acc, (float*)m, (float*)l,
        s_len, kv, rep, length, seg, splits, block_s, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* acc, void* m,
           void* l, int batch, int s_len, int kv, int rep, int hd, int length,
           int splits, int block_s, int threads, float scale, void* stream) {
    if (batch <= 0 || kv <= 0 || rep <= 0) return 0;
    if (rep > MAX_REP) return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 32: return launch_hd<T, 32>(q, k, v, acc, m, l, batch, s_len, kv, rep,
                                         length, splits, block_s, threads, scale, stream);
        case 64: return launch_hd<T, 64>(q, k, v, acc, m, l, batch, s_len, kv, rep,
                                         length, splits, block_s, threads, scale, stream);
        case 128: return launch_hd<T, 128>(q, k, v, acc, m, l, batch, s_len, kv, rep,
                                           length, splits, block_s, threads, scale, stream);
        case 96: return launch_hd<T, 96>(q, k, v, acc, m, l, batch, s_len, kv, rep,
                                         length, splits, block_s, threads, scale, stream);
        case 192: return launch_hd<T, 192>(q, k, v, acc, m, l, batch, s_len, kv, rep,
                                           length, splits, block_s, threads, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q: (B, KV, rep, hd); k, v: (B, S, KV, hd), all contiguous and 16-byte
// aligned; acc: (B, splits, KV, rep, hd) float32; m, l: (B, splits, KV, rep)
// float32.  hd in {32, 64, 96, 128, 192}; rep <= 16; threads a multiple of 32 in
// [32, 512].
int decode_attention_f32(const void* q, const void* k, const void* v,
                         void* acc, void* m, void* l, int batch, int s_len,
                         int kv, int rep, int hd, int length, int splits,
                         int block_s, int threads, float scale, void* stream) {
    return launch<float>(q, k, v, acc, m, l, batch, s_len, kv, rep, hd, length,
                         splits, block_s, threads, scale, stream);
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          void* acc, void* m, void* l, int batch, int s_len,
                          int kv, int rep, int hd, int length, int splits,
                          int block_s, int threads, float scale, void* stream) {
    return launch<__nv_bfloat16>(q, k, v, acc, m, l, batch, s_len, kv, rep, hd,
                                 length, splits, block_s, threads, scale, stream);
}

long long decode_attention_smem_bytes(int rep, int hd, int block_s,
                                      int threads) {
    return (long long)smem_floats(rep, hd, block_s, threads) * (long long)sizeof(float);
}

const char* decode_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
