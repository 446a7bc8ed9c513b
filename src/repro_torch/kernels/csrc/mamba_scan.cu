// Mamba-1 selective scan (forward) for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel selective_scan_kernel of
// src/repro/kernels/mamba_scan/kernel.py (its two grid programs,
// _serial_kernel and _chunked_kernel).
//
// What it computes, per (batch, channel d) with an S-entry state h:
//     h_t[s] = exp(delta_t[d] * A[d][s]) * h_{t-1}[s] + delta_t[d] x_t[d] B_t[s]
//     y_t[d] = sum_s C_t[s] h_t[s] + D[d] x_t[d]
// over x, delta (B, T, dI), A (dI, S), B, C (B, T, S), D (dI,), h0 (B, dI, S),
// giving y (B, T, dI) and h_T (B, dI, S), all float32.  The discretised
// (B, T, dI, S) tensors are never stored: each token's exp(delta A) lives in
// registers only.
//
// What bounds it on the H100: operations, on the special-function units.
// Every (b, t, d, s) cell takes one exp (16 a clock per SM, ~4.2e12/s on 132
// SMs at 1.98 GHz) and about four float32 FMA-class instructions; at the
// Jamba prefill shape (B 8, T 2048, dI 8192, S 16) that is 2.15e9 cells,
// ~0.51 ms of exps against 1.6 GB of reads and writes (0.48 ms at 3.35 TB/s).
// What the design does:
//   * `split` adjacent lanes of a warp share one (b, d), each carrying S /
//     split state entries and the same entries of A (scaled by log2 e once)
//     in registers: B * dI * split threads.  Each split lane adds the
//     per-token loads and the fold below, so the fewest lanes that still
//     give the card enough warps win (the H100 sweep: 1 at prefill, B 8; 2
//     at the training shape, B 2).  One exp a cell, ex2 of delta (A log2 e);
//   * a block is block_d channels of one row b; a ring of two chunks of
//     `chunk` tokens is staged in shared memory by cp.async (x and delta as
//     whole rows of the block's channels in 16-byte copies, B_t and C_t),
//     the next chunk's copies in flight while this chunk's exps run: the
//     token loop reads only shared memory and registers;
//   * a thread takes `token_group(split)` tokens at once (4 below split 4,
//     else max(8, split)), so the next tokens' exps overlap a token's sums;
//   * y_t's sum over s: each lane sums its own entries in order, then a
//     butterfly reduce-scatter over the split lanes, once for every `split`
//     tokens, leaves lane `part` with token `part`'s sum (one shuffle a token
//     and lane, whatever split): the parts are folded by halves, a fixed
//     order, no atomics.  The lane adds D x_t and writes y_t in place of x_t
//     in the staged tile (rows padded so those writes miss each other's
//     banks); the chunk's y leaves as whole rows.
// T need not divide into chunks: tokens past T are staged as x = delta = 0,
// which leave the state as it is, and are not written.
//
// Plain C interface: mamba_scan_fwd launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_tiles.cuh"

namespace {

using namespace mscan;

constexpr int MAX_THREADS = 512;
// the ring's depth in chunks: this chunk's and the next's (the H100 sweep
// found no gain in deeper rings at either Jamba shape)
constexpr int STAGES = 2;

// The x (then y) tile's row pitch past block_d: lanes holding split
// consecutive tokens of 32 / split consecutive channels write to distinct
// banks; a multiple of 4 keeps 16-byte rows.
__host__ __device__ constexpr int y_pad(int split) {
    return split == 1 ? 4 : (32 / split > 4 ? 32 / split : 4);
}

// One stage of the ring, in floats (must match the Python-side checks):
// the x / y tile (chunk x (block_d + pad)), the delta tile (chunk x
// block_d), B_t and C_t (chunk x S each).
__host__ __device__ inline int64_t stage_floats(int S, int block_d, int chunk,
                                                int split) {
    return (int64_t)chunk * (block_d + y_pad(split)) + (int64_t)chunk * block_d
         + 2LL * chunk * S;
}

// The rows and columns of a chunk's x / delta tile one thread copies (and
// writes y back from): column col (4 floats with vec, else 1) of rows
// row0, row0 + step, ...
struct TileSlice {
    int col, row0, step;
};

__device__ __forceinline__ TileSlice tile_slice(int block_d, bool vec) {
    const int per_row = vec ? block_d / 4 : block_d;
    return {(int)(threadIdx.x % per_row) * (vec ? 4 : 1),
            (int)(threadIdx.x / per_row), (int)blockDim.x / per_row};
}

// Stage chunk c's x, delta (channels d0 .. d0 + block_d of row b; channels
// past dI and tokens past T read as 0) and B, C in one stage of the ring.
// vec: 16-byte copies (dI a multiple of 4 and every pointer 16-byte
// aligned), else 4-byte copies.
__device__ __forceinline__ void stage_chunk(
        const float* __restrict__ x, const float* __restrict__ delta,
        const float* __restrict__ Bm, const float* __restrict__ Cm,
        float* st, int b, int c, int d0, int T, int dI, int S, int chunk,
        int block_d, int P, bool vec, TileSlice sl) {
    float* xs = st;
    float* ds = xs + chunk * P;
    float* bs = ds + chunk * block_d;
    float* cs = bs + chunk * S;
    const int t0 = c * chunk, nv = min(chunk, T - t0);
    const int64_t sb = ((int64_t)b * T + t0) * S;
    const bool col_in = d0 + sl.col < dI;
    const int64_t g0 = ((int64_t)b * T + t0) * dI + d0 + sl.col;
    if (vec) {
        for (int t = sl.row0; t < chunk; t += sl.step) {
            const bool in = t < nv && col_in;
            const int64_t g = in ? g0 + (int64_t)t * dI : 0;
            cp_async16(xs + t * P + sl.col, x + g, in);
            cp_async16(ds + t * block_d + sl.col, delta + g, in);
        }
        for (int e = 4 * threadIdx.x; e < chunk * S; e += 4 * blockDim.x) {
            const bool in = e < nv * S;
            cp_async16(bs + e, Bm + (in ? sb + e : 0), in);
            cp_async16(cs + e, Cm + (in ? sb + e : 0), in);
        }
    } else {
        for (int t = sl.row0; t < chunk; t += sl.step) {
            const bool in = t < nv && col_in;
            const int64_t g = in ? g0 + (int64_t)t * dI : 0;
            cp_async4(xs + t * P + sl.col, x + g, in);
            cp_async4(ds + t * block_d + sl.col, delta + g, in);
        }
        for (int e = threadIdx.x; e < chunk * S; e += blockDim.x) {
            const bool in = e < nv * S;
            cp_async4(bs + e, Bm + (in ? sb + e : 0), in);
            cp_async4(cs + e, Cm + (in ? sb + e : 0), in);
        }
    }
}

// R consecutive floats of shared memory, in 16- or 8-byte loads where R
// allows (the rows are aligned to them).
template <int R>
__device__ __forceinline__ void load_row(const float* p, float (&v)[R]) {
    if constexpr (R % 4 == 0) {
#pragma unroll
        for (int i = 0; i < R / 4; ++i) {
            const float4 q = reinterpret_cast<const float4*>(p)[i];
            v[4 * i] = q.x;
            v[4 * i + 1] = q.y;
            v[4 * i + 2] = q.z;
            v[4 * i + 3] = q.w;
        }
    } else if constexpr (R == 2) {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[0] = q.x;
        v[1] = q.y;
    } else {
        v[0] = p[0];
    }
}

// Tokens a thread takes at once: the reduce-scatter's SPLIT or more, so
// that the next tokens' exps overlap a token's sums (the H100 sweep's
// best: 4 below split 4, 8 at split 4; must match the Python side).
__host__ __device__ constexpr int token_group(int split) {
    return split >= 4 ? (split > 8 ? split : 8) : 4;
}

// Thread (channel dl, part) of a block carries state entries
// [part * R, (part + 1) * R) of channel d0 + dl, G tokens at a time.
template <int S, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
scan_fwd_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ D,
                const float* __restrict__ h0, float* __restrict__ y,
                float* __restrict__ h_out, int T, int dI, int block_d,
                int chunk, int vec) {
    constexpr int R = S / SPLIT;
    constexpr int G = token_group(SPLIT);
    extern __shared__ __align__(16) float smem[];
    const int P = block_d + y_pad(SPLIT);
    const int per = (int)stage_floats(S, block_d, chunk, SPLIT);
    const int nblk = (dI + block_d - 1) / block_d;
    const int b = blockIdx.x / nblk, d0 = (blockIdx.x % nblk) * block_d;
    const int tid = threadIdx.x, lane = tid & 31;
    const int dl = tid / SPLIT, part = tid % SPLIT;
    const int d = d0 + dl;
    const bool live = d < dI;
    const int nc = (T + chunk - 1) / chunk;
    const TileSlice sl = tile_slice(block_d, vec);

    stage_chunk(x, delta, Bm, Cm, smem, b, 0, d0, T, dI, S, chunk, block_d,
                P, vec, sl);                   // the ring's first chunk
    cp_async_commit();
    float a2[R], h[R];
    const int64_t hb = ((int64_t)b * dI + d) * S + part * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        a2[r] = live ? A[(int64_t)d * S + part * R + r] * LOG2E : 0.f;
        h[r] = live ? h0[hb + r] : 0.f;
    }
    const float dd = live ? D[d] : 0.f;

    for (int c = 0; c < nc; ++c) {
        cp_async_wait<0>();                    // chunk c has landed ...
        __syncthreads();                       // ... for every thread, and
        if (c + 1 < nc) {                      // chunk c - 1's y has left
            stage_chunk(x, delta, Bm, Cm, smem + ((c + 1) % STAGES) * per, b,
                        c + 1, d0, T, dI, S, chunk, block_d, P, vec, sl);
            cp_async_commit();
        }
        float* xs = smem + (c % STAGES) * per;
        const float* dq = xs + chunk * P + dl;           // delta_t of d
        float* xq = xs + dl;                             // x_t (then y_t) of d
        const float* bq = xs + chunk * P + chunk * block_d + part * R;
        const float* cq = bq + chunk * S;
#pragma unroll 1
        for (int g = 0; g < chunk; g += G) {
            float v[G];                        // this lane's part of each y_t
            const float* xk = xq;
#pragma unroll
            for (int k = 0; k < G; ++k) {
                const float dt = *dq;
                const float dtx = dt * *xk;
                dq += block_d;
                xk += P;
                float bv[R], cv[R];
                load_row<R>(bq + k * S, bv);
                load_row<R>(cq + k * S, cv);
                float acc = 0.f;
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    h[r] = fmaf(ex2(dt * a2[r]), h[r], dtx * bv[r]);
                    acc = r == 0 ? cv[0] * h[0] : fmaf(cv[r], h[r], acc);
                }
                v[k] = acc;
            }
            // per SPLIT tokens, lane `part` now holds the sum of token
            // `part`, which every lane of the channel has read
#pragma unroll
            for (int j = 0; j < G; j += SPLIT) {
                reduce_scatter<SPLIT, SPLIT / 2, 1>(v + j, lane);
                float* out = xq + (j + part) * P;
                *out = fmaf(dd, *out, v[j]);
            }
            xq += G * P;
            bq += G * S;
            cq += G * S;
        }
        __syncthreads();                       // the chunk's y is whole
        const int t0 = c * chunk, nv = min(chunk, T - t0);
        if (d0 + sl.col < dI) {
            float* yg = y + ((int64_t)b * T + t0) * dI + d0 + sl.col;
            if (vec) {
                for (int t = sl.row0; t < nv; t += sl.step)
                    *reinterpret_cast<float4*>(yg + (int64_t)t * dI) =
                        *reinterpret_cast<const float4*>(xs + t * P + sl.col);
            } else {
                for (int t = sl.row0; t < nv; t += sl.step)
                    yg[(int64_t)t * dI] = xs[t * P + sl.col];
            }
        }
    }
    if (live) {
#pragma unroll
        for (int r = 0; r < R; ++r) h_out[hb + r] = h[r];
    }
}

template <int S, int SPLIT>
int launch(const float* x, const float* delta, const float* A,
           const float* Bm, const float* Cm, const float* D, const float* h0,
           float* y, float* h_out, int B, int T, int dI, int block_d,
           int chunk, int vec, cudaStream_t stream) {
    const size_t smem = (size_t)STAGES * stage_floats(S, block_d, chunk, SPLIT)
                      * sizeof(float);
    const int64_t blocks = (int64_t)B * ((dI + block_d - 1) / block_d);
    cudaError_t err = cudaFuncSetAttribute(
        scan_fwd_kernel<S, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    scan_fwd_kernel<S, SPLIT><<<(unsigned)blocks, block_d * SPLIT, smem, stream>>>(
        x, delta, A, Bm, Cm, D, h0, y, h_out, T, dI, block_d, chunk, vec);
    return (int)cudaGetLastError();
}

template <int S>
int launch_split(const float* x, const float* delta, const float* A,
                 const float* Bm, const float* Cm, const float* D,
                 const float* h0, float* y, float* h_out, int B, int T,
                 int dI, int block_d, int chunk, int split, int vec,
                 cudaStream_t stream) {
#define MS_SPLIT(N)                                                          \
    case N:                                                                  \
        if constexpr (N <= S)                                                \
            return launch<S, N>(x, delta, A, Bm, Cm, D, h0, y, h_out, B, T,  \
                                dI, block_d, chunk, vec, stream);            \
        break;
    switch (split) {
        MS_SPLIT(1)
        MS_SPLIT(2)
        MS_SPLIT(4)
        MS_SPLIT(8)
        MS_SPLIT(16)
        default: break;
    }
#undef MS_SPLIT
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, delta: (B, T, dI); A: (dI, S); Bm, Cm: (B, T, S); D: (dI,);
// h0: (B, dI, S); y: (B, T, dI); h_out: (B, dI, S); all float32 and
// contiguous.  S in {4, 8, 16}; split a power of two <= S; block_d a
// multiple of 4 with block_d * split threads a multiple of 32 up to 512;
// chunk a multiple of token_group(split); vec (16-byte copies) only when
// dI is a multiple of 4 and every pointer is 16-byte aligned.
int mamba_scan_fwd(const void* x, const void* delta, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* h_out, int B, int T, int dI,
                   int S, int block_d, int chunk, int split, int vec,
                   void* stream) {
    if (B <= 0 || T <= 0 || dI <= 0) return 0;
    const int threads = block_d * split;
    if (block_d <= 0 || block_d % 4 || split <= 0 || threads % 32
        || threads > MAX_THREADS || chunk <= 0 || chunk % token_group(split)
        || (vec && dI % 4))
        return (int)cudaErrorInvalidValue;
    const float *fx = (const float*)x, *fdt = (const float*)delta,
                *fa = (const float*)A, *fb = (const float*)Bm,
                *fc = (const float*)Cm, *fd = (const float*)D,
                *fh0 = (const float*)h0;
    float *fy = (float*)y, *fh = (float*)h_out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (S) {
        case 4: return launch_split<4>(fx, fdt, fa, fb, fc, fd, fh0, fy, fh, B,
                                       T, dI, block_d, chunk, split, vec,
                                       st);
        case 8: return launch_split<8>(fx, fdt, fa, fb, fc, fd, fh0, fy, fh, B,
                                       T, dI, block_d, chunk, split, vec,
                                       st);
        case 16: return launch_split<16>(fx, fdt, fa, fb, fc, fd, fh0, fy, fh,
                                         B, T, dI, block_d, chunk, split, vec,
                                         st);
        default: return (int)cudaErrorInvalidValue;
    }
}

long long mamba_scan_smem_bytes(int S, int block_d, int chunk, int split) {
    return (long long)STAGES * stage_floats(S, block_d, chunk, split)
         * (long long)sizeof(float);
}

const char* mamba_scan_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
