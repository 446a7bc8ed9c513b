// RWKV-6 wkv recurrence (backward) for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel wkv6_bwd of
// src/repro/kernels/rwkv6_wkv/kernel.py (its two grid programs: the spans
// pre-pass _spans_kernel and the reverse sweep _wkv_bwd_kernel, which takes
// each span's adjoint from jax.vjp of _local_wkv).
//
// The forward, per (batch, head) with a (hd x hd) state S (key i x value j):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// The reverse recurrence, derived by hand: with G the carried dL/dS_t,
// starting from ds_T, for t = T-1 .. 0
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     du  += r_t * k_t (v_t . dy_t)
//     dk_t = u * r_t (v_t . dy_t) + G v_t
//     dv_t = G^T k_t + (sum_i u_i r_ti k_ti) dy_t
//     dw_t = rowsum(G * S_{t-1})
//     G    = diag(w_t) G + r_t dy_t^T
// and ds0 = G at the end.  Decays are only ever multiplied: S_{t-1} is never
// recovered by dividing by w_t (w = exp(-exp(decay)) can be tiny).  The
// pre-pass (program "spans") stores the state entering every span of
// `span_chunks * chunk` tokens; the sweep (program "sweep") walks the spans
// last to first and, within a span, its chunks last to first: each chunk's
// entry state is recomputed from the span's (a forward over the span's
// earlier chunks), then the chunk's forward keeps every token's S_{t-1} in
// shared memory and the reverse steps walk back through it.
//
// What bounds it on the H100: operations.  At the RWKV-6 training shape
// (B 8, T 2048, H 32, hd 64) each of the 2.15e9 (t, h, i, j) cells takes
// about eight float32 instructions (the state recompute, the S dy, G v and
// G * S row sums, G^T k, the G update): ~0.51 ms at 33.5e12/s, against
// 9 x 134 MB of reads and writes (0.36 ms).  This design adds the pre-pass
// and the recompute (about three more instructions a cell, and
// (span_chunks - 1) / 2 more forward steps a token) and the span states
// (B x n_spans x H x hd x hd floats: 1.07 GB at span 8).  What it does:
//   * one block per (b, block_h heads); thread (head, row i, part) holds
//     columns j = jj * split + part of row i of S and of G in registers, so
//     dr, dk, dw and du are sums along its own row (plus `split`-lane
//     shuffles), and only dv, a sum over rows, crosses threads;
//   * dv: a butterfly reduce-scatter over the warp's rows, per-warp
//     partials in shared memory, one pass over the warps a chunk;
//   * r, k, v, w, dy of a chunk are staged in shared memory by coalesced
//     loads, with v . dy and sum_i u r k once per (token, head);
//   * each thread's S_{t-1} stack is its own column of shared memory
//     (chunk x hd / split floats), which bounds the chunk: at hd 64 a head's
//     state is 16 KB, so chunk 8 at block_h 1 is 128 KB.
// No atomics: du goes into per-(b, head) partials the caller sums over b,
// and every output element is written by exactly one thread.
//
// Plain C interface: rwkv6_wkv_bwd_spans / rwkv6_wkv_bwd_sweep launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of the sweep, in floats (must match the Python-side checks).
__host__ __device__ inline int64_t sweep_smem_floats(int chunk, int block_h,
                                                     int hd, int split) {
    const int64_t threads = (int64_t)block_h * hd * split;
    return (int64_t)chunk * block_h * hd * hd    // S_{t-1} of every token
         + 5LL * chunk * block_h * hd            // r, k, v, w, dy
         + 2LL * chunk * block_h                 // v . dy, sum u r k
         + (int64_t)block_h * hd                 // u
         + threads / 32 * chunk * hd;            // per-warp dv partials
}

__host__ __device__ inline int64_t spans_smem_floats(int chunk, int block_h,
                                                     int hd) {
    return 3LL * chunk * block_h * hd;           // k, v, w
}

// Butterfly reduce-scatter (see mamba_scan_bwd.cu): N values over the lanes
// differing in bits O .. STOP; returns the index of v[0] among the N.
template <int N, int O, int STOP>
__device__ __forceinline__ int reduce_scatter(float* v, int lane) {
    if constexpr (O < STOP) {
        return 0;
    } else if constexpr (N > 1 && N % 2 == 0) {
        constexpr int H = N / 2;
        const bool up = lane & O;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float send = up ? v[i] : v[i + H];
            const float keep = up ? v[i + H] : v[i];
            v[i] = keep + __shfl_xor_sync(FULL, send, O);
        }
        return (up ? H : 0) + reduce_scatter<H, O / 2, STOP>(v, lane);
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(FULL, v[i], O);
        return reduce_scatter<N, O / 2, STOP>(v, lane);
    }
}

template <int N, int O, int STOP>
__host__ __device__ constexpr int rs_left() {
    if constexpr (O < STOP) return N;
    else if constexpr (N > 1 && N % 2 == 0) return rs_left<N / 2, O / 2, STOP>();
    else return rs_left<N, O / 2, STOP>();
}

template <int N, int O, int STOP>
__host__ __device__ constexpr int rs_dup() {
    if constexpr (O < STOP) return 0;
    else if constexpr (N > 1 && N % 2 == 0) return rs_dup<N / 2, O / 2, STOP>();
    else return O | rs_dup<N, O / 2, STOP>();
}

struct Layout {
    int b, h0, hl, h, i, part, tid, nth;
};

__device__ __forceinline__ Layout layout(int H, int hd, int block_h,
                                         int split) {
    Layout L;
    const int groups = H / block_h;
    L.b = blockIdx.x / groups;
    L.h0 = (blockIdx.x % groups) * block_h;
    L.tid = threadIdx.x;
    L.nth = blockDim.x;
    L.hl = L.tid / (hd * split);
    const int rem = L.tid % (hd * split);
    L.i = rem / split;
    L.part = rem % split;
    L.h = L.h0 + L.hl;
    return L;
}

// Stage `n` tokens of one operand from t0 for the block's heads: dst[tk *
// width + c], width = block_h * hd (a token's block_h heads are contiguous).
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      float* dst, int b, int t0, int n,
                                      int T, int H, int hd, int h0,
                                      int width) {
    const int64_t row = (int64_t)H * hd;
    for (int e = threadIdx.x; e < n * width; e += blockDim.x) {
        const int tk = e / width, c = e % width;
        dst[e] = src[((int64_t)b * T + t0 + tk) * row + (int64_t)h0 * hd + c];
    }
}

// Pre-pass: the state entering every span, ss (B, n_spans, H, hd, hd).
template <int COLS, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
wkv_bwd_spans_kernel(const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ w, const float* __restrict__ s0,
                     float* __restrict__ ss, int T, int H, int hd, int chunk,
                     int span, int block_h) {
    extern __shared__ float smem[];
    constexpr int split = SPLIT;
    const Layout L = layout(H, hd, block_h, split);
    const int width = block_h * hd;
    float* ks = smem;
    float* vs = ks + chunk * width;
    float* ws = vs + chunk * width;
    const int n_spans = (T + span - 1) / span;

    float S[COLS];
    const int64_t hh = (int64_t)hd * hd;
    const int64_t rowoff = (int64_t)L.i * hd + L.part;
    const float* src0 = s0 + ((int64_t)L.b * H + L.h) * hh + rowoff;
#pragma unroll
    for (int c = 0; c < COLS; ++c) S[c] = src0[c * split];
    for (int t0 = 0; t0 < T; t0 += chunk) {
        if (t0 % span == 0) {
            float* out = ss + (((int64_t)L.b * n_spans + t0 / span) * H + L.h) * hh
                       + rowoff;
#pragma unroll
            for (int c = 0; c < COLS; ++c) out[c * split] = S[c];
        }
        const int n = min(chunk, T - t0);
        __syncthreads();
        stage(k, ks, L.b, t0, n, T, H, hd, L.h0, width);
        stage(v, vs, L.b, t0, n, T, H, hd, L.h0, width);
        stage(w, ws, L.b, t0, n, T, H, hd, L.h0, width);
        __syncthreads();
        for (int tk = 0; tk < n; ++tk) {
            const int o = tk * width + L.hl * hd;
            const float wt = ws[o + L.i], kt = ks[o + L.i];
#pragma unroll
            for (int c = 0; c < COLS; ++c)
                S[c] = fmaf(wt, S[c], kt * vs[o + c * split + L.part]);
        }
    }
}

// The reverse sweep.  Outputs: dr, dk, dv, dw (B, T, H, hd); du partials
// (B, H, hd); ds0 (B, H, hd, hd).
template <int COLS, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
wkv_bwd_sweep_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ u, const float* __restrict__ ss,
                     const float* __restrict__ dy,
                     const float* __restrict__ dsT, float* __restrict__ dr,
                     float* __restrict__ dk, float* __restrict__ dv,
                     float* __restrict__ dw, float* __restrict__ du_part,
                     float* __restrict__ ds0, int T, int H, int hd, int chunk,
                     int span_chunks, int block_h) {
    extern __shared__ float smem[];
    constexpr int split = SPLIT;
    const Layout L = layout(H, hd, block_h, split);
    const int width = block_h * hd;
    const int nth = L.nth, tid = L.tid, lane = tid & 31, warp = tid >> 5;
    const int warps_per_head = hd * split / 32;
    float* stk = smem;                                  // (chunk, COLS, nth)
    float* rs = stk + (int64_t)chunk * COLS * nth;
    float* ks = rs + chunk * width;
    float* vs = ks + chunk * width;
    float* ws = vs + chunk * width;
    float* dys = ws + chunk * width;
    float* vdy = dys + chunk * width;                   // (chunk, block_h)
    float* ruk = vdy + chunk * block_h;                 // (chunk, block_h)
    float* us = ruk + chunk * block_h;                  // (block_h, hd)
    float* wpart = us + width;                          // (nwarps, chunk, hd)

    const int span = chunk * span_chunks;
    const int n_spans = (T + span - 1) / span;
    const int64_t hh = (int64_t)hd * hd;
    const int64_t rowoff = (int64_t)L.i * hd + L.part;
    const int64_t sbase = ((int64_t)L.b * H + L.h) * hh + rowoff;
    const int64_t row = (int64_t)H * hd;

    float G[COLS], S[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) G[c] = dsT[sbase + c * split];
    for (int e = tid; e < width; e += nth) us[e] = u[(int64_t)L.h0 * hd + e];
    const float ui = u[(int64_t)L.h * hd + L.i];
    float du = 0.f;

    for (int j = n_spans - 1; j >= 0; --j) {
        const int ts = j * span;
        const float* entry = ss + (((int64_t)L.b * n_spans + j) * H + L.h) * hh
                           + rowoff;
        for (int cc = span_chunks - 1; cc >= 0; --cc) {
            const int tc = ts + cc * chunk;
            if (tc >= T) continue;                      // past the ragged end
            const int n = min(chunk, T - tc);
            // this chunk's entry state: the span's, stepped over its earlier
            // chunks
#pragma unroll
            for (int c = 0; c < COLS; ++c) S[c] = entry[c * split];
            for (int t0 = ts; t0 < tc; t0 += chunk) {
                __syncthreads();
                stage(k, ks, L.b, t0, chunk, T, H, hd, L.h0, width);
                stage(v, vs, L.b, t0, chunk, T, H, hd, L.h0, width);
                stage(w, ws, L.b, t0, chunk, T, H, hd, L.h0, width);
                __syncthreads();
                for (int tk = 0; tk < chunk; ++tk) {
                    const int o = tk * width + L.hl * hd;
                    const float wt = ws[o + L.i], kt = ks[o + L.i];
#pragma unroll
                    for (int c = 0; c < COLS; ++c)
                        S[c] = fmaf(wt, S[c], kt * vs[o + c * split + L.part]);
                }
            }
            __syncthreads();
            stage(r, rs, L.b, tc, n, T, H, hd, L.h0, width);
            stage(k, ks, L.b, tc, n, T, H, hd, L.h0, width);
            stage(v, vs, L.b, tc, n, T, H, hd, L.h0, width);
            stage(w, ws, L.b, tc, n, T, H, hd, L.h0, width);
            stage(dy, dys, L.b, tc, n, T, H, hd, L.h0, width);
            __syncthreads();
            // v . dy and sum_i u r k, once per (token, head)
            for (int e = tid; e < n * block_h; e += nth) {
                const int tk = e / block_h, hl = e % block_h;
                const int o = tk * width + hl * hd;
                float a1 = 0.f, a2 = 0.f;
                int c = e % hd;                         // a rotated start
                for (int q = 0; q < hd; ++q) {
                    a1 = fmaf(vs[o + c], dys[o + c], a1);
                    a2 = fmaf(us[hl * hd + c] * rs[o + c], ks[o + c], a2);
                    if (++c == hd) c = 0;
                }
                vdy[e] = a1;
                ruk[e] = a2;
            }
            // the chunk's forward, keeping S_{t-1}
            for (int tk = 0; tk < n; ++tk) {
                const int o = tk * width + L.hl * hd;
                const float wt = ws[o + L.i], kt = ks[o + L.i];
#pragma unroll
                for (int c = 0; c < COLS; ++c) {
                    stk[((int64_t)tk * COLS + c) * nth + tid] = S[c];
                    S[c] = fmaf(wt, S[c], kt * vs[o + c * split + L.part]);
                }
            }
            __syncthreads();                            // vdy, ruk are ready
            // back through the chunk
            for (int tk = n - 1; tk >= 0; --tk) {
                const int o = tk * width + L.hl * hd;
                const float rt = rs[o + L.i], kt = ks[o + L.i],
                            wt = ws[o + L.i];
                float sdr = 0.f, sdk = 0.f, sdw = 0.f;
                float dvv[COLS];
#pragma unroll
                for (int c = 0; c < COLS; ++c) {
                    const int jj = o + c * split + L.part;
                    const float sp = stk[((int64_t)tk * COLS + c) * nth + tid];
                    const float dyj = dys[jj];
                    sdr = fmaf(sp, dyj, sdr);
                    sdk = fmaf(G[c], vs[jj], sdk);
                    sdw = fmaf(G[c], sp, sdw);
                    dvv[c] = G[c] * kt;
                    G[c] = fmaf(wt, G[c], rt * dyj);
                }
                for (int q = 1; q < split; q <<= 1) {
                    sdr += __shfl_xor_sync(FULL, sdr, q);
                    sdk += __shfl_xor_sync(FULL, sdk, q);
                    sdw += __shfl_xor_sync(FULL, sdw, q);
                }
                if (L.part == 0) {
                    const float vd = vdy[tk * block_h + L.hl];
                    const int64_t g = ((int64_t)L.b * T + tc + tk) * row
                                    + (int64_t)L.h * hd + L.i;
                    dr[g] = fmaf(ui * kt, vd, sdr);
                    dk[g] = fmaf(ui * rt, vd, sdk);
                    dw[g] = sdw;
                    du = fmaf(rt * kt, vd, du);
                }
                // dv: sums over the warp's rows (lane bits SPLIT .. 16)
                constexpr int NL = rs_left<COLS, 16, SPLIT>();
                constexpr int DUP = rs_dup<COLS, 16, SPLIT>();
                const int base = reduce_scatter<COLS, 16, SPLIT>(dvv, lane);
                if ((lane & DUP) == 0) {
                    float* wp = wpart + ((int64_t)warp * chunk + tk) * hd;
#pragma unroll
                    for (int q = 0; q < NL; ++q)
                        wp[(base + q) * split + L.part] = dvv[q];
                }
            }
            __syncthreads();
            // dv of the chunk: the warps of each head summed, plus the bonus
            for (int e = tid; e < n * width; e += nth) {
                const int tk = e / width, c = e % width;
                const int hl = c / hd, jcol = c % hd;
                float acc = ruk[tk * block_h + hl] * dys[tk * width + c];
                for (int q = 0; q < warps_per_head; ++q)
                    acc += wpart[((int64_t)(hl * warps_per_head + q) * chunk + tk)
                                 * hd + jcol];
                dv[((int64_t)L.b * T + tc + tk) * row + (int64_t)L.h0 * hd + c] = acc;
            }
        }
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c) ds0[sbase + c * split] = G[c];
    if (L.part == 0)
        du_part[((int64_t)L.b * H + L.h) * hd + L.i] = du;
}

template <int COLS, int SPLIT>
int launch_cols(bool sweep, const float* r, const float* k, const float* v,
                const float* w, const float* u, const float* s0,
                const float* ss_in, float* ss_out, const float* dy,
                const float* dsT, float* dr, float* dk, float* dv, float* dw,
                float* du, float* ds0, int B, int T, int H, int hd, int chunk,
                int span_chunks, int block_h, cudaStream_t stream) {
    const int threads = block_h * hd * SPLIT;
    const int64_t blocks = (int64_t)B * (H / block_h);
    cudaError_t err;
    if (!sweep) {
        const size_t smem = (size_t)spans_smem_floats(chunk, block_h, hd)
                          * sizeof(float);
        err = cudaFuncSetAttribute(wkv_bwd_spans_kernel<COLS, SPLIT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        wkv_bwd_spans_kernel<COLS, SPLIT><<<(unsigned)blocks, threads, smem, stream>>>(
            k, v, w, s0, ss_out, T, H, hd, chunk, chunk * span_chunks, block_h);
    } else {
        const size_t smem = (size_t)sweep_smem_floats(chunk, block_h, hd, SPLIT)
                          * sizeof(float);
        err = cudaFuncSetAttribute(wkv_bwd_sweep_kernel<COLS, SPLIT>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        wkv_bwd_sweep_kernel<COLS, SPLIT><<<(unsigned)blocks, threads, smem, stream>>>(
            r, k, v, w, u, ss_in, dy, dsT, dr, dk, dv, dw, du, ds0, T, H, hd,
            chunk, span_chunks, block_h);
    }
    return (int)cudaGetLastError();
}

int dispatch(bool sweep, const float* r, const float* k, const float* v,
             const float* w, const float* u, const float* s0,
             const float* ss_in, float* ss_out, const float* dy,
             const float* dsT, float* dr, float* dk, float* dv, float* dw,
             float* du, float* ds0, int B, int T, int H, int hd, int chunk,
             int span_chunks, int block_h, int split, cudaStream_t stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    if (hd <= 0 || chunk <= 0 || span_chunks <= 0 || block_h <= 0
        || H % block_h || split <= 0 || split > 32 || (split & (split - 1))
        || hd % split || (hd * split) % 32 || block_h * hd * split > MAX_THREADS)
        return (int)cudaErrorInvalidValue;
#define WKV_BWD_CASE(HD, SP)                                                \
    case HD * 100 + SP:                                                     \
        return launch_cols<HD / SP, SP>(sweep, r, k, v, w, u, s0, ss_in,    \
                                        ss_out, dy, dsT, dr, dk, dv, dw, du,\
                                        ds0, B, T, H, hd, chunk,            \
                                        span_chunks, block_h, stream);
    // the head sizes the port's models use, each split a warp divides
    switch (hd * 100 + split) {
        WKV_BWD_CASE(16, 2) WKV_BWD_CASE(16, 4) WKV_BWD_CASE(16, 8)
        WKV_BWD_CASE(16, 16)
        WKV_BWD_CASE(32, 1) WKV_BWD_CASE(32, 2) WKV_BWD_CASE(32, 4)
        WKV_BWD_CASE(32, 8) WKV_BWD_CASE(32, 16) WKV_BWD_CASE(32, 32)
        WKV_BWD_CASE(64, 1) WKV_BWD_CASE(64, 2) WKV_BWD_CASE(64, 4)
        WKV_BWD_CASE(64, 8) WKV_BWD_CASE(64, 16) WKV_BWD_CASE(64, 32)
        default: return (int)cudaErrorInvalidValue;
    }
#undef WKV_BWD_CASE
}

}  // namespace

extern "C" {

// k, v, w: (B, T, H, hd); s0: (B, H, hd, hd); ss: (B, ceil(T / span), H, hd,
// hd) with span = chunk * span_chunks; all float32 and contiguous.
int rwkv6_wkv_bwd_spans(const void* k, const void* v, const void* w,
                        const void* s0, void* ss, int B, int T, int H, int hd,
                        int chunk, int span_chunks, int block_h, int split,
                        void* stream) {
    return dispatch(false, nullptr, (const float*)k, (const float*)v,
                    (const float*)w, nullptr, (const float*)s0, nullptr,
                    (float*)ss, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, B, T, H, hd, chunk,
                    span_chunks, block_h, split, (cudaStream_t)stream);
}

// As the forward's operands plus ss (from rwkv6_wkv_bwd_spans with the same
// chunk and span_chunks), dy (B, T, H, hd) and dsT (B, H, hd, hd).  Writes
// dr, dk, dv, dw (B, T, H, hd), du partials (B, H, hd) and ds0.
int rwkv6_wkv_bwd_sweep(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* ss,
                        const void* dy, const void* dsT, void* dr, void* dk,
                        void* dv, void* dw, void* du, void* ds0, int B, int T,
                        int H, int hd, int chunk, int span_chunks, int block_h,
                        int split, void* stream) {
    return dispatch(true, (const float*)r, (const float*)k, (const float*)v,
                    (const float*)w, (const float*)u, nullptr,
                    (const float*)ss, nullptr, (const float*)dy,
                    (const float*)dsT, (float*)dr, (float*)dk, (float*)dv,
                    (float*)dw, (float*)du, (float*)ds0, B, T, H, hd, chunk,
                    span_chunks, block_h, split, (cudaStream_t)stream);
}

long long rwkv6_wkv_bwd_smem_bytes(int chunk, int block_h, int hd, int split) {
    return (long long)sweep_smem_floats(chunk, block_h, hd, split)
         * (long long)sizeof(float);
}

const char* rwkv6_wkv_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
