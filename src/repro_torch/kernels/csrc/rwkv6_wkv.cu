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
// What bounds it on the H100: operations.  Every (b, t, h, i, j) cell costs
// about four float32 instructions (the r.S product, the decay and the k v
// outer product), so the RWKV-6 1.6B prefill shape (B 8, T 2048, H 32, hd 64)
// is 2.15e9 cells, ~8.6e9 instructions, ~0.26 ms at 33.5e12 instructions/s,
// against 0.68 GB of reads and writes (0.20 ms at 3.35 TB/s).  The token
// loop is a dependent chain, so the hard part is parallelism: only B * H
// (256 at that shape) independent recurrences exist.  What the design does:
//   * serial program (lanes < 2): one block per (b, block_h heads); thread
//     (head, j, part) holds rows i = ii * split + part of column j of its
//     head's state in registers (hd / split floats), so `split` > 1 spreads
//     one head over more threads (hd * split per head) and the partial r.S
//     sums meet by warp shuffles.  The r, k, v, w of `chunk` tokens are
//     staged in shared memory by coalesced loads (a token's block_h * hd
//     values are contiguous), and the bonus sum_i r u k of each (token, head)
//     is one dot per token, not one per thread;
//   * matrix form (lanes >= 2, chunk <= 64): what _chunked_kernel computes,
//     in float32 tiles in shared memory.  Per chunk, with g the in-chunk
//     inclusive cumsum of log w: A = r * exp(g_excl), Bm = k * exp(-g), the
//     strictly lower (chunk x chunk) scores A Bm^T, y = scores V + bonus, the
//     chunk's local state (k exp(g_last - g))^T V, taken as exp(g_last)
//     (Bm^T V) so that Bm serves twice, then a `lanes`-step combine
//     threads the carried state through the span's chunks, and each chunk
//     adds A S_entry to its y.  The span's end state carries to the next
//     span inside the block.  A is recomputed for the last step instead of
//     kept, so shared memory holds one chunk's tiles plus the block's
//     per-chunk local states.
// T need not divide into chunks or spans: tokens at or past T load as
// r = k = v = 0, w = 1 (log w = 0), which leave the state as it is, and are
// not written.  T = 1 is a decode step.
//
// Plain C interface: rwkv6_wkv_fwd launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SERIAL_MAX_THREADS = 512;
constexpr int MATRIX_MAX_THREADS = 1024;

// Shared memory, in floats (must match the Python-side checks).
__host__ __device__ inline int64_t serial_smem_floats(int chunk, int block_h,
                                                      int hd) {
    return 4LL * chunk * block_h * hd      // r, k, v, w of `chunk` tokens
         + (int64_t)chunk * block_h        // bonus sum_i r u k per token, head
         + (int64_t)block_h * hd;          // u
}

__host__ __device__ inline int64_t matrix_smem_floats(int chunk, int lanes,
                                                      int block_h, int hd) {
    return 4LL * chunk * hd                      // r/A, k/Bm, v, log w/g
         + (int64_t)chunk * chunk                // scores
         + chunk                                 // bonus
         + (int64_t)block_h * lanes * hd * hd    // local, then entry states
         + (int64_t)block_h * lanes * hd         // total decay per chunk
         + (int64_t)block_h * hd * hd            // carried state
         + (int64_t)block_h * hd;                // u
}

template <int ROWS>
__global__ void __launch_bounds__(SERIAL_MAX_THREADS)
wkv_serial_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int T,
                  int H, int hd, int chunk, int block_h) {
    extern __shared__ float smem[];
    const int width = block_h * hd;       // a token's floats in this block
    float* rs = smem;
    float* ks = rs + chunk * width;
    float* vs = ks + chunk * width;
    float* ws = vs + chunk * width;
    float* bon = ws + chunk * width;      // (chunk, block_h)
    float* us = bon + chunk * block_h;    // (block_h, hd)

    const int split = hd / ROWS;
    const int groups = H / block_h;
    const int b = blockIdx.x / groups;
    const int h0 = (blockIdx.x % groups) * block_h;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hl = tid / (hd * split);
    const int rem = tid % (hd * split);
    const int j = rem / split, part = rem % split;
    const int h = h0 + hl;
    const int64_t row = (int64_t)H * hd;  // floats of one token

    float S[ROWS];
    const int64_t sbase = ((int64_t)b * H + h) * hd * hd;
#pragma unroll
    for (int ii = 0; ii < ROWS; ++ii)
        S[ii] = s0[sbase + (int64_t)(ii * split + part) * hd + j];
    for (int e = tid; e < width; e += nth) us[e] = u[(int64_t)h0 * hd + e];

    for (int t0 = 0; t0 < T; t0 += chunk) {
        const int n = min(chunk, T - t0);
        __syncthreads();                  // the previous chunk is consumed
        for (int e = tid; e < n * width; e += nth) {
            const int tk = e / width, c = e % width;
            const int64_t g = ((int64_t)b * T + t0 + tk) * row
                            + (int64_t)h0 * hd + c;
            rs[e] = r[g];
            ks[e] = k[g];
            vs[e] = v[g];
            ws[e] = w[g];
        }
        __syncthreads();
        for (int e = tid; e < n * block_h; e += nth) {
            const int tk = e / block_h, hh = e % block_h;
            const float* rr = rs + tk * width + hh * hd;
            const float* kk = ks + tk * width + hh * hd;
            const float* uu = us + hh * hd;
            float acc = 0.f;
            int i = e % hd;               // a rotated start spreads the banks
            for (int c = 0; c < hd; ++c) {
                acc = fmaf(rr[i] * uu[i], kk[i], acc);
                if (++i == hd) i = 0;
            }
            bon[e] = acc;
        }
        __syncthreads();
        for (int tk = 0; tk < n; ++tk) {
            const float* rt = rs + tk * width + hl * hd;
            const float* kt = ks + tk * width + hl * hd;
            const float* wt = ws + tk * width + hl * hd;
            const float vj = vs[tk * width + hl * hd + j];
            float acc = 0.f;
#pragma unroll
            for (int ii = 0; ii < ROWS; ++ii) {
                const int i = ii * split + part;
                acc = fmaf(rt[i], S[ii], acc);
                S[ii] = fmaf(wt[i], S[ii], kt[i] * vj);
            }
            for (int o = split >> 1; o > 0; o >>= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, o);
            if (part == 0)
                y[((int64_t)b * T + t0 + tk) * row + (int64_t)h * hd + j] =
                    fmaf(vj, bon[tk * block_h + hl], acc);
        }
    }
#pragma unroll
    for (int ii = 0; ii < ROWS; ++ii)
        s_out[sbase + (int64_t)(ii * split + part) * hd + j] = S[ii];
}

// Load one chunk of one head into shared memory; tokens at or past T read
// as r = k = v = 0 and log w = 0.  `kv` false loads r and log w only.
__device__ __forceinline__ void load_chunk(
        const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w, float* ra,
        float* kb, float* vs, float* gs, int b, int h, int t0, int T, int H,
        int hd, int chunk, bool kv) {
    for (int e = threadIdx.x; e < chunk * hd; e += blockDim.x) {
        const int tk = e / hd, i = e % hd;
        const int t = t0 + tk;
        if (t < T) {
            const int64_t g = (((int64_t)b * T + t) * H + h) * hd + i;
            ra[e] = r[g];
            gs[e] = logf(w[g]);
            if (kv) {
                kb[e] = k[g];
                vs[e] = v[g];
            }
        } else {
            ra[e] = 0.f;
            gs[e] = 0.f;
            if (kv) {
                kb[e] = 0.f;
                vs[e] = 0.f;
            }
        }
    }
}

// In-chunk inclusive cumsum of log w per channel (one thread per channel);
// writes exp(g_last) to dtot when it is given.
__device__ __forceinline__ void cumsum_chunk(float* gs, float* dtot, int hd,
                                             int chunk) {
    for (int i = threadIdx.x; i < hd; i += blockDim.x) {
        float run = 0.f;
        for (int tk = 0; tk < chunk; ++tk) {
            run += gs[tk * hd + i];
            gs[tk * hd + i] = run;
        }
        if (dtot) dtot[i] = expf(run);
    }
}

__global__ void __launch_bounds__(MATRIX_MAX_THREADS)
wkv_matrix_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_out, int T,
                  int H, int hd, int chunk, int lanes, int block_h) {
    extern __shared__ float smem[];
    const int hh2 = hd * hd;
    float* ra = smem;                     // (chunk, hd): r, then A
    float* kb = ra + chunk * hd;          // k, then Bm
    float* vs = kb + chunk * hd;          // v
    float* gs = vs + chunk * hd;          // log w, then g
    float* sc = gs + chunk * hd;          // (chunk, chunk) scores
    float* bon = sc + chunk * chunk;      // (chunk,)
    float* sloc = bon + chunk;            // (block_h, lanes, hd, hd)
    float* dtot = sloc + (int64_t)block_h * lanes * hh2;   // (block_h, lanes, hd)
    float* st = dtot + block_h * lanes * hd;               // (block_h, hd, hd)
    float* us = st + (int64_t)block_h * hh2;               // (block_h, hd)

    const int groups = H / block_h;
    const int b = blockIdx.x / groups;
    const int h0 = (blockIdx.x % groups) * block_h;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int lane = tid & 31;
    const int64_t sbase = ((int64_t)b * H + h0) * hh2;
    for (int e = tid; e < block_h * hh2; e += nth) st[e] = s0[sbase + e];
    for (int e = tid; e < block_h * hd; e += nth) us[e] = u[(int64_t)h0 * hd + e];

    const int span = chunk * lanes;
    for (int ts = 0; ts < T; ts += span) {
        // 1. every chunk of the span from a zero entry state
        for (int unit = 0; unit < block_h * lanes; ++unit) {
            const int hl = unit / lanes, l = unit % lanes;
            const int h = h0 + hl, t0 = ts + l * chunk;
            float* slo = sloc + (int64_t)unit * hh2;
            float* dto = dtot + unit * hd;
            __syncthreads();
            load_chunk(r, k, v, w, ra, kb, vs, gs, b, h, t0, T, H, hd, chunk,
                       true);
            __syncthreads();
            for (int e = tid; e < chunk; e += nth) {
                const float* rr = ra + e * hd;
                const float* kk = kb + e * hd;
                const float* uu = us + hl * hd;
                float acc = 0.f;
                int i = e % hd;
                for (int c = 0; c < hd; ++c) {
                    acc = fmaf(rr[i] * uu[i], kk[i], acc);
                    if (++i == hd) i = 0;
                }
                bon[e] = acc;
            }
            cumsum_chunk(gs, dto, hd, chunk);
            __syncthreads();
            for (int e = tid; e < chunk * hd; e += nth) {
                const int tk = e / hd;
                ra[e] *= expf(tk ? gs[e - hd] : 0.f);
                kb[e] *= expf(-gs[e]);
            }
            __syncthreads();
            for (int e = tid; e < chunk * chunk; e += nth) {
                const int t = e / chunk, s = e % chunk;
                float acc = 0.f;
                if (s < t) {
                    const float* at = ra + t * hd;
                    const float* bs = kb + s * hd;
                    int i = lane % hd;
                    for (int c = 0; c < hd; ++c) {
                        acc = fmaf(at[i], bs[i], acc);
                        if (++i == hd) i = 0;
                    }
                }
                sc[e] = acc;
            }
            __syncthreads();
            for (int e = tid; e < chunk * hd; e += nth) {
                const int t = e / hd, j = e % hd;
                if (t0 + t >= T) continue;
                float acc = bon[t] * vs[t * hd + j];
                for (int s = 0; s < t; ++s)
                    acc = fmaf(sc[t * chunk + s], vs[s * hd + j], acc);
                y[(((int64_t)b * T + t0 + t) * H + h) * hd + j] = acc;
            }
            for (int e = tid; e < hh2; e += nth) {
                const int i = e / hd, j = e % hd;
                float acc = 0.f;
                for (int s = 0; s < chunk; ++s)
                    acc = fmaf(kb[s * hd + i], vs[s * hd + j], acc);
                slo[e] = acc * dto[i];
            }
        }
        __syncthreads();
        // 2. the lanes-step combine: each chunk's entry state replaces its
        // local state, and the carried state steps through the span
        for (int e = tid; e < block_h * hh2; e += nth) {
            const int hl = e / hh2, ij = e % hh2, i = ij / hd;
            float s = st[e];
            for (int l = 0; l < lanes; ++l) {
                const int unit = hl * lanes + l;
                float* slot = sloc + (int64_t)unit * hh2 + ij;
                const float loc = *slot;
                *slot = s;
                s = fmaf(dtot[unit * hd + i], s, loc);
            }
            st[e] = s;
        }
        // 3. each chunk adds A S_entry to its y
        for (int unit = 0; unit < block_h * lanes; ++unit) {
            const int hl = unit / lanes, l = unit % lanes;
            const int h = h0 + hl, t0 = ts + l * chunk;
            const float* ent = sloc + (int64_t)unit * hh2;
            if (t0 >= T) continue;        // this chunk is padding
            __syncthreads();
            load_chunk(r, k, v, w, ra, kb, vs, gs, b, h, t0, T, H, hd, chunk,
                       false);
            __syncthreads();
            cumsum_chunk(gs, nullptr, hd, chunk);
            __syncthreads();
            for (int e = tid; e < chunk * hd; e += nth) {
                const int tk = e / hd;
                ra[e] *= expf(tk ? gs[e - hd] : 0.f);
            }
            __syncthreads();
            for (int e = tid; e < chunk * hd; e += nth) {
                const int t = e / hd, j = e % hd;
                if (t0 + t >= T) continue;
                const float* at = ra + t * hd;
                float acc = 0.f;
                for (int i = 0; i < hd; ++i)
                    acc = fmaf(at[i], ent[i * hd + j], acc);
                y[(((int64_t)b * T + t0 + t) * H + h) * hd + j] += acc;
            }
        }
        __syncthreads();
    }
    for (int e = tid; e < block_h * hh2; e += nth) s_out[sbase + e] = st[e];
}

template <int ROWS>
int launch_serial(const float* r, const float* k, const float* v,
                  const float* w, const float* u, const float* s0, float* y,
                  float* s_out, int B, int T, int H, int hd, int chunk,
                  int block_h, int threads, cudaStream_t stream) {
    const size_t smem = (size_t)serial_smem_floats(chunk, block_h, hd) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_serial_kernel<ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)B * (H / block_h);
    wkv_serial_kernel<ROWS><<<(unsigned)blocks, threads, smem, stream>>>(
        r, k, v, w, u, s0, y, s_out, T, H, hd, chunk, block_h);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w: (B, T, H, hd); u: (H, hd); s0: (B, H, hd, hd); y: (B, T, H, hd);
// s_out: (B, H, hd, hd); all float32 and contiguous.  block_h divides H.
// lanes < 2: the serial program, threads = block_h * hd * split with
// hd / split in {4, 8, 16, 32, 64} and threads <= 512.  lanes >= 2: the
// matrix form with `threads` threads (a multiple of 32, <= 1024).
int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                  const void* u, const void* s0, void* y, void* s_out, int B,
                  int T, int H, int hd, int chunk, int lanes, int block_h,
                  int threads, void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    if (hd <= 0 || chunk <= 0 || block_h <= 0 || H % block_h || threads <= 0)
        return (int)cudaErrorInvalidValue;
    const float *fr = (const float*)r, *fk = (const float*)k,
                *fv = (const float*)v, *fw = (const float*)w,
                *fu = (const float*)u, *fs0 = (const float*)s0;
    float *fy = (float*)y, *fs = (float*)s_out;
    cudaStream_t st = (cudaStream_t)stream;
    if (lanes >= 2) {
        const size_t smem = (size_t)matrix_smem_floats(chunk, lanes, block_h, hd)
                          * sizeof(float);
        cudaError_t err = cudaFuncSetAttribute(
            wkv_matrix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (err != cudaSuccess) return (int)err;
        const int64_t blocks = (int64_t)B * (H / block_h);
        wkv_matrix_kernel<<<(unsigned)blocks, threads, smem, st>>>(
            fr, fk, fv, fw, fu, fs0, fy, fs, T, H, hd, chunk, lanes, block_h);
        return (int)cudaGetLastError();
    }
    const int per_split = block_h * hd;
    if (threads % per_split) return (int)cudaErrorInvalidValue;
    const int split = threads / per_split;
    if (split > 32 || (split & (split - 1)) || hd % split)
        return (int)cudaErrorInvalidValue;
    switch (hd / split) {
        case 4: return launch_serial<4>(fr, fk, fv, fw, fu, fs0, fy, fs, B, T, H, hd,
                                        chunk, block_h, threads, st);
        case 8: return launch_serial<8>(fr, fk, fv, fw, fu, fs0, fy, fs, B, T, H, hd,
                                        chunk, block_h, threads, st);
        case 16: return launch_serial<16>(fr, fk, fv, fw, fu, fs0, fy, fs, B, T, H,
                                          hd, chunk, block_h, threads, st);
        case 32: return launch_serial<32>(fr, fk, fv, fw, fu, fs0, fy, fs, B, T, H,
                                          hd, chunk, block_h, threads, st);
        case 64: return launch_serial<64>(fr, fk, fv, fw, fu, fs0, fy, fs, B, T, H,
                                          hd, chunk, block_h, threads, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

long long rwkv6_wkv_smem_bytes(int chunk, int lanes, int block_h, int hd) {
    const int64_t floats = lanes >= 2 ? matrix_smem_floats(chunk, lanes, block_h, hd)
                                      : serial_smem_floats(chunk, block_h, hd);
    return (long long)floats * (long long)sizeof(float);
}

const char* rwkv6_wkv_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
