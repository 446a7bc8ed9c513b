// RWKV-6 wkv recurrence (forward) for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel wkv6_kernel of
// src/repro/kernels/rwkv6_wkv/kernel.py (its two grid programs,
// _serial_kernel and _chunked_kernel).
//
// What it computes, per (batch, head) with a (hd x hd) state S (key dim i x
// value dim j):
//     y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//     S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// over r, k, v, w (B, T, H, hd), u (H, hd), s0 (B, H, hd, hd), giving
// y (B, T, H, hd) and the final state s_T (B, H, hd, hd), all float32.
//
// What bounds it on the H100: bytes.  The RWKV-6 1.6B prefill shape (B 8,
// T 2048, H 32, hd 64) reads r, k, v, w and writes y, 0.68 GB (0.20 ms at
// 3.35 TB/s).  The token loop is a dependent chain over only B * H (256)
// independent recurrences, so the hard part is parallelism.  Two routes,
// picked by the caller from T and hd:
//   * "serial" (decode, T = 1, and any T shorter than a chunk or a head
//     size not built below): one block per (b, block_h heads); thread
//     (head, column tile, part) holds rows i = ii * split + part of JC
//     adjacent columns of its head's state in registers (hd / split x JC
//     floats), the partial r.S sums meeting by warp shuffles; the r, k,
//     v, w of `chunk` tokens staged in shared memory by 16-byte loads
//     (each r_i, k_i, w_i a thread reads serves its JC columns:
//     shared-memory reads, not FMAs, bound a column a thread), the bonus
//     sum_i r u k a thread's chain per (token, head), started at another
//     channel each token;
//   * "chunked" (prefill, training; hd 16, 32, 48, 64), two programs,
//     deterministic and free of atomics:
//       - "states": the state entering every chunk of C tokens,
//         (B, H, N, hd, hd), and s_T: one block per (b, head), a thread
//         `cols` value columns of one row, each chunk one product
//             S <- diag(W) S + sum_t diag(prod_{s>t} w_s) k_t v_t^T
//         from double-buffered shared tiles (wkv_chunk_scan.cuh, the
//         program the backward's "scans" runs in both directions);
//       - "chunks": the serial program over B * (H / block_h) * N blocks,
//         each walking one chunk's C tokens from that chunk's entry state.
//     Only products of w's appear: nothing is inverted and no log or exp
//     is taken (the reference's matrix form divides by exp(cumsum log w),
//     which overflows float32 once a chunk's decays multiply below e^-88),
//     so w = 1e-30 or 0 gives finite results.  Inside a chunk the state is
//     stepped token by token, as the serial route steps it, rather than
//     summed as in-chunk pairs (sum_{s<t} (sum_i r_ti c(s,t)_i k_si) v_s
//     with c(s,t) = prod_{s<σ<t} w_σ): the pair form's float32 gradients
//     of RWKV-6 1.6B lay further from float64 than the serial recurrence's
//     (PERF.md), the stepped form's as close.  The chunked route moves
//     more than the bound's bytes: the states are written once and read
//     once (B x H x N x hd^2 floats, 0.27 GB at chunk 32).
// T need not divide into chunks: the states program reads tokens past T as
// r = k = v = 0, w = 1, which leave the state as it is; nothing past T is
// written.
//
// Plain C interface: rwkv6_wkv_fwd_serial, rwkv6_wkv_fwd_states and
// rwkv6_wkv_fwd_chunks launch on the given stream, do not synchronise,
// allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv_chunk_scan.cuh"

namespace {

using namespace wkv_chunk;

constexpr int SERIAL_MAX_THREADS = 512;
// tokens the chunk program stages in shared memory at a time
constexpr int CHUNKS_STAGE = 32;

// Shared memory, in floats (must match the Python-side checks).
__host__ __device__ inline int64_t serial_smem_floats(int chunk, int block_h,
                                                      int hd) {
    return 4LL * chunk * block_h * hd      // r, k, v, w of `chunk` tokens
         + (int64_t)chunk * block_h        // bonus sum_i r u k per token, head
         + (int64_t)block_h * hd;          // u
}

// ---------------------------------------------------------------------------
// route "serial"

// A block walks the tokens [n * span, (n + 1) * span) of block_h heads of
// one batch row from its entry state, entry[(b, h, n)] (B, H, nspan, hd,
// hd): the serial route is one span of T tokens from s0 (nspan = 1), the
// chunked route's chunk program one span a chunk from the states program's
// chunk-entry states.  Thread (head, column tile, part) holds rows
// i = ii * split + part of JC adjacent columns of its head's state in
// registers (ROWS = hd / split rows): each r_i, k_i, w_i it reads from
// shared memory serves JC columns.  s_out (when given) takes the state
// after the span.
template <int ROWS, int JC>
__global__ void __launch_bounds__(SERIAL_MAX_THREADS)
wkv_serial_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ entry,
                  float* __restrict__ y, float* __restrict__ s_out, int T,
                  int H, int hd, int chunk, int block_h, int span, int nspan) {
    extern __shared__ __align__(16) float smem[];
    const int width = block_h * hd;       // a token's floats in this block
    float* rs = smem;
    float* ks = rs + chunk * width;
    float* vs = ks + chunk * width;
    float* ws = vs + chunk * width;
    float* bon = ws + chunk * width;      // (chunk, block_h)
    float* us = bon + chunk * block_h;    // (block_h, hd)

    const int split = hd / ROWS;
    const int per_head = (hd / JC) * split;
    const int groups = H / block_h;
    const int n = blockIdx.x % nspan, rest = blockIdx.x / nspan;
    const int b = rest / groups;
    const int h0 = (rest % groups) * block_h;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hl = tid / per_head;
    const int rem = tid % per_head;
    const int j0 = (rem / split) * JC, part = rem % split;
    const int h = h0 + hl;
    const int64_t row = (int64_t)H * hd;  // floats of one token
    const int t_lo = n * span, t_hi = min(T, t_lo + span);

    float S[ROWS][JC];
    const int64_t hh = (int64_t)hd * hd;
    const int64_t ebase = (((int64_t)b * H + h) * nspan + n) * hh;
#pragma unroll
    for (int ii = 0; ii < ROWS; ++ii)
#pragma unroll
        for (int c = 0; c < JC; ++c)
            S[ii][c] = entry[ebase + (int64_t)(ii * split + part) * hd + j0 + c];
    for (int e = tid; e < width; e += nth) us[e] = u[(int64_t)h0 * hd + e];

    for (int t0 = t_lo; t0 < t_hi; t0 += chunk) {
        const int nt = min(chunk, t_hi - t0);
        __syncthreads();                  // the previous chunk is consumed
        for (int e = tid; e < nt * width / 4; e += nth) {   // 16-byte loads
            const int tk = e / (width / 4), c = (e - tk * (width / 4)) * 4;
            const int64_t g = ((int64_t)b * T + t0 + tk) * row
                            + (int64_t)h0 * hd + c;
            const int o = tk * width + c;
            *reinterpret_cast<float4*>(rs + o) = *reinterpret_cast<const float4*>(r + g);
            *reinterpret_cast<float4*>(ks + o) = *reinterpret_cast<const float4*>(k + g);
            *reinterpret_cast<float4*>(vs + o) = *reinterpret_cast<const float4*>(v + g);
            *reinterpret_cast<float4*>(ws + o) = *reinterpret_cast<const float4*>(w + g);
        }
        __syncthreads();
        // the bonus sums, a thread a (token, head), each token's sum started
        // at another channel: a fixed order (a warp's tree, or a chain from
        // channel 0) makes the rounding of every token alike, and RWKV-6's
        // float32 gradients then lie measurably further from float64
        // (PERF.md)
        for (int e = tid; e < nt * block_h; e += nth) {
            const int tk = e / block_h, hb = e % block_h;
            const float* rr = rs + tk * width + hb * hd;
            const float* kk = ks + tk * width + hb * hd;
            const float* uu = us + hb * hd;
            float acc = 0.f;
            int i = e % hd;               // a rotated start spreads the banks
            for (int c = 0; c < hd; ++c) {
                acc = fmaf(rr[i] * uu[i], kk[i], acc);
                if (++i == hd) i = 0;
            }
            bon[e] = acc;
        }
        __syncthreads();
        for (int tk = 0; tk < nt; ++tk) {
            const float* rt = rs + tk * width + hl * hd;
            const float* kt = ks + tk * width + hl * hd;
            const float* wt = ws + tk * width + hl * hd;
            float vj[JC], acc[JC];
#pragma unroll
            for (int c = 0; c < JC; ++c) {
                vj[c] = vs[tk * width + hl * hd + j0 + c];
                acc[c] = 0.f;
            }
#pragma unroll
            for (int ii = 0; ii < ROWS; ++ii) {
                const int i = ii * split + part;
                const float ri = rt[i], ki = kt[i], wi = wt[i];
#pragma unroll
                for (int c = 0; c < JC; ++c) {
                    acc[c] = fmaf(ri, S[ii][c], acc[c]);
                    S[ii][c] = fmaf(wi, S[ii][c], ki * vj[c]);
                }
            }
            for (int o = split >> 1; o > 0; o >>= 1)
#pragma unroll
                for (int c = 0; c < JC; ++c)
                    acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
            if (part == 0) {
                const float bt = bon[tk * block_h + hl];
                float* yt = y + ((int64_t)b * T + t0 + tk) * row
                          + (int64_t)h * hd + j0;
#pragma unroll
                for (int c = 0; c < JC; ++c) yt[c] = fmaf(vj[c], bt, acc[c]);
            }
        }
    }
    if (s_out) {
        const int64_t sbase = ((int64_t)b * H + h) * hh;
#pragma unroll
        for (int ii = 0; ii < ROWS; ++ii)
#pragma unroll
            for (int c = 0; c < JC; ++c)
                s_out[sbase + (int64_t)(ii * split + part) * hd + j0 + c] = S[ii][c];
    }
}

template <int ROWS, int JC>
int launch_serial(const float* r, const float* k, const float* v,
                  const float* w, const float* u, const float* entry, float* y,
                  float* s_out, int B, int T, int H, int hd, int chunk,
                  int block_h, int threads, int span, cudaStream_t stream) {
    const size_t smem = (size_t)serial_smem_floats(chunk, block_h, hd) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_serial_kernel<ROWS, JC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int nspan = (T + span - 1) / span;
    const int64_t blocks = (int64_t)B * (H / block_h) * nspan;
    wkv_serial_kernel<ROWS, JC><<<(unsigned)blocks, threads, smem, stream>>>(
        r, k, v, w, u, entry, y, s_out, T, H, hd, chunk, block_h, span, nspan);
    return (int)cudaGetLastError();
}

// The column tile of a serial-program thread (must match the Python-side
// rule): the widest of 4, 2, 1 that keeps ROWS x JC <= 64 registers of
// state and gives a block a whole number of warps, up to 512 threads; 0
// when none does.
__host__ __device__ inline int serial_tile(int hd, int split, int block_h) {
    if (split <= 0 || hd % split) return 0;
    const int rows = hd / split;
    for (int jc = 4; jc >= 1; jc /= 2) {
        if (rows * jc > 64 || hd % jc) continue;
        const int threads = block_h * (hd / jc) * split;
        if (threads % 32 == 0 && threads <= SERIAL_MAX_THREADS) return jc;
    }
    return 0;
}

int dispatch_serial(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* entry,
                    float* y, float* s_out, int B, int T, int H, int hd,
                    int chunk, int block_h, int split, int span,
                    cudaStream_t st) {
    if (hd <= 0 || chunk <= 0 || block_h <= 0 || H % block_h || span <= 0
            || split > 32 || (split & (split - 1)))
        return (int)cudaErrorInvalidValue;
    const int jc = serial_tile(hd, split, block_h);
    if (!jc) return (int)cudaErrorInvalidValue;
    const int threads = block_h * (hd / jc) * split;
#define WKV_SERIAL(ROWS_, JC_)                                                \
    if (hd / split == ROWS_ && jc == JC_)                                     \
        return launch_serial<ROWS_, JC_>(r, k, v, w, u, entry, y, s_out, B,   \
                                         T, H, hd, chunk, block_h, threads,   \
                                         span, st);
    WKV_SERIAL(4, 4) WKV_SERIAL(4, 2) WKV_SERIAL(4, 1)
    WKV_SERIAL(8, 4) WKV_SERIAL(8, 2) WKV_SERIAL(8, 1)
    WKV_SERIAL(12, 4) WKV_SERIAL(12, 2) WKV_SERIAL(12, 1)
    WKV_SERIAL(16, 4) WKV_SERIAL(16, 2) WKV_SERIAL(16, 1)
    WKV_SERIAL(24, 2) WKV_SERIAL(24, 1)
    WKV_SERIAL(32, 2) WKV_SERIAL(32, 1)
    WKV_SERIAL(48, 1) WKV_SERIAL(64, 1)
#undef WKV_SERIAL
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Route "serial".  r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd,
// hd); y: (B, T, H, hd); s_out: (B, H, hd, hd); all float32 and contiguous.
// block_h divides H; split (threads a state column's rows, a power of two)
// with hd / split in {4, 8, 12, 16, 24, 32, 48, 64} and serial_tile(hd,
// split, block_h) not 0; `chunk` tokens are staged in shared memory at a
// time.
int rwkv6_wkv_fwd_serial(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* s0, void* y,
                         void* s_out, int B, int T, int H, int hd, int chunk,
                         int block_h, int split, void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    const auto f = [](const void* p) { return (const float*)p; };
    return dispatch_serial(f(r), f(k), f(v), f(w), f(u), f(s0), (float*)y,
                           (float*)s_out, B, T, H, hd, chunk, block_h,
                           split, T, (cudaStream_t)stream);
}

// Route "chunked", program "states": k, v, w (B, T, H, hd), s0 (B, H, hd,
// hd) -> states (B, H, ceil(T / chunk), hd, hd), the state entering every
// chunk, and s_out (B, H, hd, hd); 16-byte aligned.  hd in {16, 32, 48,
// 64}; cols in {4, 8, 16, 32} dividing hd.
int rwkv6_wkv_fwd_states(const void* k, const void* v, const void* w,
                         const void* s0, void* states, void* s_out, int B,
                         int T, int H, int hd, int chunk, int cols,
                         void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    if (chunk <= 0 || cols <= 0 || cols % 4) return (int)cudaErrorInvalidValue;
    const auto f = [](const void* p) { return (const float*)p; };
    return chunk_scan(hd, cols, nullptr, f(k), f(v), f(w), nullptr, f(s0),
                      nullptr, (float*)states, nullptr, nullptr,
                      (float*)s_out, B, T, H, chunk, 1, (cudaStream_t)stream);
}

// Route "chunked", program "chunks": r, k, v, w, u and the states of
// rwkv6_wkv_fwd_states at the same chunk -> y (B, T, H, hd): a block a
// (b, block_h heads, chunk) in the serial program's layout (block_h and
// split as for the serial route), min(chunk, 32) tokens staged at a time.
int rwkv6_wkv_fwd_chunks(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* states,
                         void* y, int B, int T, int H, int hd, int chunk,
                         int block_h, int split, void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    const auto f = [](const void* p) { return (const float*)p; };
    return dispatch_serial(f(r), f(k), f(v), f(w), f(u), f(states), (float*)y,
                           nullptr, B, T, H, hd, chunk < CHUNKS_STAGE
                           ? chunk : CHUNKS_STAGE, block_h, split, chunk,
                           (cudaStream_t)stream);
}

const char* rwkv6_wkv_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
