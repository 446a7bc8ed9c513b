// Mamba-1 selective scan (backward) for NVIDIA Hopper (sm_90a), float32.
//
// Replaces the Pallas TPU kernel selective_scan_bwd of
// src/repro/kernels/mamba_scan/kernel.py (its two grid programs: the spans
// pre-pass _spans_kernel and the reverse sweep _scan_bwd_kernel, which takes
// each span's adjoint from jax.vjp of _local_scan).
//
// The forward, per (batch b, channel d) with an S-entry state h:
//     a_t[s] = exp(delta_t[d] A[d][s])
//     h_t[s] = a_t[s] h_{t-1}[s] + delta_t[d] x_t[d] B_t[s]
//     y_t[d] = sum_s C_t[s] h_t[s] + D[d] x_t[d]
// The reverse recurrence, derived by hand: with g the carried dL/dh_t,
// starting from dh_T, for t = T-1 .. 0
//     g     += dy_t C_t
//     dC_t  += dy_t h_t                 (summed over channels)
//     dB_t  += g delta_t x_t            (summed over channels)
//     dD    += dy_t x_t
//     dx_t   = D dy_t + delta_t sum_s g B_t
//     ddt_t  = sum_s g (A a_t h_{t-1} + x_t B_t)
//     dA    += g delta_t a_t h_{t-1}
//     g      = a_t g
// and dh0 = g at the end.  h_{t-1} is never recovered by dividing by a_t
// (exp(delta A) underflows): the pre-pass (program "spans") stores the
// state entering every span of `chunk` tokens, and the sweep (program
// "sweep") walks the spans last to first, recomputes the span's forward from
// its entry state keeping every token's h_{t-1} in shared memory, then steps
// back through the span.
//
// What bounds it on the H100: bytes and the exps.  At the Jamba training
// shape (B 2, T 2048, dI 8192, S 16) the function reads x, delta, dy and
// writes dx, ddelta (5 x 134 MB, ~0.20 ms at 3.35 TB/s) and takes one exp
// per (t, d, s) cell (537e6 / 4.18e12 exps/s on the SFUs, 0.13 ms).  This
// design takes three exps a cell (pre-pass, span recompute, reverse step)
// and stores each span's entry state (B x n_spans x dI x S floats).  What
// the design does about the bound:
//   * one thread per (b, channel, part): `split` threads share a channel,
//     each holding S / split state entries, g entries and dA partials in
//     registers (more threads for the dependent token chain: B x dI is
//     only 16,384 channels at that shape);
//   * B_t and C_t of a span, shared by every channel of row b, are staged
//     in shared memory; x, delta, dy are read and dx, ddelta written
//     coalesced across channels;
//   * the per-token states of a span live in shared memory, each thread's
//     own column (chunk x S/split floats a thread), so the span length is
//     bounded by shared memory, not by the state's underflow;
//   * dB and dC are sums over channels: a butterfly reduce-scatter over
//     the warp's channels (each lane ends with whole-warp sums of a few of
//     the 2S values), per-warp partials in shared memory, and one pass
//     over the warps a span, written as per-block partials
//     (n_db, B, T, S) that the caller sums, as the reference does;
//   * dA and dD are per-(b, channel) partials the caller sums over b.
// No atomics: every output element is written by exactly one thread, so
// the same inputs give the same bits.
//
// Plain C interface: mamba_scan_bwd_spans / mamba_scan_bwd_sweep launch on
// the given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of the sweep, in floats (must match the Python-side checks).
__host__ __device__ inline int64_t sweep_smem_floats(int S, int block_d,
                                                     int chunk, int split) {
    const int64_t warps = (int64_t)block_d * split / 32;
    return (int64_t)chunk * S * block_d     // h_{t-1} of every token of a span
         + 2LL * chunk * S                  // B_t, C_t
         + warps * chunk * 2 * S;           // per-warp dC, dB partials
}

__host__ __device__ inline int64_t spans_smem_floats(int S, int chunk) {
    return (int64_t)chunk * S;              // B_t
}

// Butterfly reduce-scatter of N values over the lanes that differ in the
// bits O, O/2, ..., STOP: each halving step sends half of the values to the
// partner lane and keeps the other half summed with the partner's; once N
// is odd the values are summed whole.  Returns the index of v[0] among the
// N values; the lane then holds rs_left() consecutive sums.
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

// The lane bits over which whole sums were taken: lanes differing only
// there hold the same values, and the one with those bits 0 writes them.
template <int N, int O, int STOP>
__host__ __device__ constexpr int rs_dup() {
    if constexpr (O < STOP) return 0;
    else if constexpr (N > 1 && N % 2 == 0) return rs_dup<N / 2, O / 2, STOP>();
    else return O | rs_dup<N, O / 2, STOP>();
}

// Pre-pass: the state entering every span of `chunk` tokens,
// hs (B, n_spans, dI, S).  Thread (channel, part) carries S / SPLIT entries.
template <int S, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
scan_bwd_spans_kernel(const float* __restrict__ x,
                      const float* __restrict__ delta,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ h0, float* __restrict__ hs,
                      int T, int dI, int chunk, int block_d) {
    constexpr int R = S / SPLIT;
    extern __shared__ float smem[];
    float* bs = smem;                                   // (chunk, S)
    const int nblk = (dI + block_d - 1) / block_d;
    const int b = blockIdx.x / nblk;
    const int tid = threadIdx.x;
    const int dl = tid / SPLIT, part = tid % SPLIT;
    const int d = (blockIdx.x % nblk) * block_d + dl;
    const bool live = d < dI;
    const int n_spans = (T + chunk - 1) / chunk;

    float a[R], h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int s = part * R + r;
        a[r] = live ? A[(int64_t)d * S + s] : 0.f;
        h[r] = live ? h0[((int64_t)b * dI + d) * S + s] : 0.f;
    }
    for (int j = 0; j < n_spans; ++j) {
        const int t0 = j * chunk;
        const int n = min(chunk, T - t0);
        if (live) {
            float* out = hs + (((int64_t)b * n_spans + j) * dI + d) * S + part * R;
#pragma unroll
            for (int r = 0; r < R; ++r) out[r] = h[r];
        }
        __syncthreads();                                // bs is consumed
        const int64_t sb = ((int64_t)b * T + t0) * S;
        for (int e = tid; e < n * S; e += blockDim.x) bs[e] = Bm[sb + e];
        __syncthreads();
        if (!live) continue;
        for (int tk = 0; tk < n; ++tk) {
            const int64_t idx = ((int64_t)b * T + t0 + tk) * dI + d;
            const float dt = delta[idx];
            const float dx = dt * x[idx];
#pragma unroll
            for (int r = 0; r < R; ++r)
                h[r] = fmaf(__expf(dt * a[r]), h[r], dx * bs[tk * S + part * R + r]);
        }
    }
}

// The reverse sweep over spans.  Outputs: dx, ddelta (B, T, dI); dA partials
// (B, dI, S); dB, dC partials (n_db, B, T, S); dD partials (B, dI);
// dh0 (B, dI, S).
template <int S, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
scan_bwd_sweep_kernel(const float* __restrict__ x,
                      const float* __restrict__ delta,
                      const float* __restrict__ A,
                      const float* __restrict__ Bm,
                      const float* __restrict__ Cm,
                      const float* __restrict__ D,
                      const float* __restrict__ hs,
                      const float* __restrict__ dy,
                      const float* __restrict__ dhT,
                      float* __restrict__ dx_out, float* __restrict__ ddt_out,
                      float* __restrict__ da_part, float* __restrict__ db_part,
                      float* __restrict__ dc_part, float* __restrict__ dd_part,
                      float* __restrict__ dh0, int Bsz, int T, int dI,
                      int chunk, int block_d) {
    constexpr int R = S / SPLIT;
    constexpr int NV = 2 * R;                           // dC then dB values
    constexpr int NL = rs_left<NV, 16, SPLIT>();
    constexpr int DUP = rs_dup<NV, 16, SPLIT>();
    extern __shared__ float smem[];
    const int nth = blockDim.x;
    const int nwarps = nth / 32;
    float* hstk = smem;                                 // (chunk, R, nth)
    float* bs = hstk + (int64_t)chunk * R * nth;        // (chunk, S)
    float* cs = bs + chunk * S;                         // (chunk, S)
    float* wpart = cs + chunk * S;                      // (nwarps, chunk, 2S)

    const int nblk = (dI + block_d - 1) / block_d;
    const int b = blockIdx.x / nblk;
    const int dblk = blockIdx.x % nblk;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int dl = tid / SPLIT, part = tid % SPLIT;
    const int d = dblk * block_d + dl;
    const bool live = d < dI;
    const int n_spans = (T + chunk - 1) / chunk;

    float a[R], g[R], h[R], dA[R];
    float dd = 0.f, dD = 0.f;
    const int64_t cbase = ((int64_t)b * dI + d) * S + part * R;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        a[r] = live ? A[(int64_t)d * S + part * R + r] : 0.f;
        g[r] = live ? dhT[cbase + r] : 0.f;
        dA[r] = 0.f;
    }
    if (live) dd = D[d];

    for (int j = n_spans - 1; j >= 0; --j) {
        const int t0 = j * chunk;
        const int n = min(chunk, T - t0);
        __syncthreads();                                // the last span is done
        const int64_t sb = ((int64_t)b * T + t0) * S;
        for (int e = tid; e < n * S; e += nth) {
            bs[e] = Bm[sb + e];
            cs[e] = Cm[sb + e];
        }
        const float* entry = hs + (((int64_t)b * n_spans + j) * dI + d) * S + part * R;
#pragma unroll
        for (int r = 0; r < R; ++r) h[r] = live ? entry[r] : 0.f;
        __syncthreads();
        // the span's forward from its entry state, keeping h_{t-1}
        for (int tk = 0; tk < n; ++tk) {
            const int64_t idx = ((int64_t)b * T + t0 + tk) * dI + d;
            const float dt = live ? delta[idx] : 0.f;
            const float dx = live ? dt * x[idx] : 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                hstk[((int64_t)tk * R + r) * nth + tid] = h[r];
                h[r] = fmaf(__expf(dt * a[r]), h[r], dx * bs[tk * S + part * R + r]);
            }
        }
        // back through the span
        for (int tk = n - 1; tk >= 0; --tk) {
            const int64_t idx = ((int64_t)b * T + t0 + tk) * dI + d;
            const float dt = live ? delta[idx] : 0.f;
            const float xv = live ? x[idx] : 0.f;
            const float dyv = live ? dy[idx] : 0.f;
            const float dtx = dt * xv;
            float v[NV];
            float sx = 0.f, sdt = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int s = part * R + r;
                const float bt = bs[tk * S + s];
                const float hp = hstk[((int64_t)tk * R + r) * nth + tid];
                const float ea = __expf(dt * a[r]);
                const float ht = fmaf(ea, hp, dtx * bt);
                const float gr = fmaf(dyv, cs[tk * S + s], g[r]);
                v[r] = dyv * ht;                        // dC_t[s]
                v[R + r] = gr * dtx;                    // dB_t[s]
                sx = fmaf(gr, bt, sx);
                const float q = gr * ea * hp;           // g a_t h_{t-1}
                sdt = fmaf(q, a[r], fmaf(gr * xv, bt, sdt));
                dA[r] = fmaf(q, dt, dA[r]);
                g[r] = gr * ea;
            }
#pragma unroll
            for (int o = 1; o < SPLIT; o <<= 1) {
                sx += __shfl_xor_sync(FULL, sx, o);
                sdt += __shfl_xor_sync(FULL, sdt, o);
            }
            if (live && part == 0) {
                dx_out[idx] = fmaf(dd, dyv, dt * sx);
                ddt_out[idx] = sdt;
                dD = fmaf(dyv, xv, dD);
            }
            // dC, dB: sums over the warp's channels
            const int base = reduce_scatter<NV, 16, SPLIT>(v, lane);
            if ((lane & DUP) == 0) {
#pragma unroll
                for (int i = 0; i < NL; ++i) {
                    const int k = base + i;
                    const int q = k < R ? part * R + k : S + part * R + (k - R);
                    wpart[((int64_t)warp * chunk + tk) * 2 * S + q] = v[i];
                }
            }
        }
        __syncthreads();
        // the block's dC, dB partials of this span: sums over the warps
        for (int e = tid; e < n * 2 * S; e += nth) {
            const int tk = e / (2 * S), q = e % (2 * S);
            float acc = 0.f;
            for (int w = 0; w < nwarps; ++w)
                acc += wpart[((int64_t)w * chunk + tk) * 2 * S + q];
            const int64_t o = (((int64_t)dblk * Bsz + b) * T + t0 + tk) * S;
            if (q < S) dc_part[o + q] = acc;
            else db_part[o + q - S] = acc;
        }
    }
    if (live) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            dh0[cbase + r] = g[r];
            da_part[cbase + r] = dA[r];
        }
        if (part == 0) dd_part[(int64_t)b * dI + d] = dD;
    }
}

template <int S, int SPLIT>
int launch_spans(const float* x, const float* delta, const float* A,
                 const float* Bm, const float* h0, float* hs, int B, int T,
                 int dI, int block_d, int chunk, cudaStream_t stream) {
    const size_t smem = (size_t)spans_smem_floats(S, chunk) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_spans_kernel<S, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)B * ((dI + block_d - 1) / block_d);
    scan_bwd_spans_kernel<S, SPLIT><<<(unsigned)blocks, block_d * SPLIT, smem,
                                      stream>>>(x, delta, A, Bm, h0, hs, T, dI,
                                                chunk, block_d);
    return (int)cudaGetLastError();
}

template <int S, int SPLIT>
int launch_sweep(const float* x, const float* delta, const float* A,
                 const float* Bm, const float* Cm, const float* D,
                 const float* hs, const float* dy, const float* dhT, float* dx,
                 float* ddt, float* da, float* db, float* dc, float* ddp,
                 float* dh0, int B, int T, int dI, int block_d, int chunk,
                 cudaStream_t stream) {
    const size_t smem = (size_t)sweep_smem_floats(S, block_d, chunk, SPLIT)
                      * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_sweep_kernel<S, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (int64_t)B * ((dI + block_d - 1) / block_d);
    scan_bwd_sweep_kernel<S, SPLIT><<<(unsigned)blocks, block_d * SPLIT, smem,
                                      stream>>>(
        x, delta, A, Bm, Cm, D, hs, dy, dhT, dx, ddt, da, db, dc, ddp, dh0, B,
        T, dI, chunk, block_d);
    return (int)cudaGetLastError();
}

// Dispatch on (S, split): split divides S and is a power of two up to S.
#define SCAN_BWD_DISPATCH(FN, ...)                                           \
    switch (S * 100 + split) {                                               \
        case 401: return FN<4, 1>(__VA_ARGS__);                              \
        case 402: return FN<4, 2>(__VA_ARGS__);                              \
        case 404: return FN<4, 4>(__VA_ARGS__);                              \
        case 801: return FN<8, 1>(__VA_ARGS__);                              \
        case 802: return FN<8, 2>(__VA_ARGS__);                              \
        case 804: return FN<8, 4>(__VA_ARGS__);                              \
        case 808: return FN<8, 8>(__VA_ARGS__);                              \
        case 1601: return FN<16, 1>(__VA_ARGS__);                            \
        case 1602: return FN<16, 2>(__VA_ARGS__);                            \
        case 1604: return FN<16, 4>(__VA_ARGS__);                            \
        case 1608: return FN<16, 8>(__VA_ARGS__);                            \
        case 1616: return FN<16, 16>(__VA_ARGS__);                           \
        default: return (int)cudaErrorInvalidValue;                          \
    }

bool bad_launch(int block_d, int chunk, int split) {
    return block_d <= 0 || block_d % 32 || chunk <= 0 || split <= 0
        || block_d * split > MAX_THREADS;
}

}  // namespace

extern "C" {

// x, delta: (B, T, dI); A: (dI, S); Bm: (B, T, S); h0: (B, dI, S);
// hs: (B, ceil(T / chunk), dI, S); all float32 and contiguous.
int mamba_scan_bwd_spans(const void* x, const void* delta, const void* A,
                         const void* Bm, const void* h0, void* hs, int B,
                         int T, int dI, int S, int block_d, int chunk,
                         int split, void* stream) {
    if (B <= 0 || T <= 0 || dI <= 0) return 0;
    if (bad_launch(block_d, chunk, split)) return (int)cudaErrorInvalidValue;
    SCAN_BWD_DISPATCH(launch_spans, (const float*)x, (const float*)delta,
                      (const float*)A, (const float*)Bm, (const float*)h0,
                      (float*)hs, B, T, dI, block_d, chunk,
                      (cudaStream_t)stream)
}

// As the forward's operands plus hs (from mamba_scan_bwd_spans with the same
// chunk), dy (B, T, dI) and dhT (B, dI, S).  Writes dx, ddt (B, T, dI);
// da (B, dI, S), db, dc (ceil(dI / block_d), B, T, S) and dd (B, dI)
// partials; dh0 (B, dI, S).
int mamba_scan_bwd_sweep(const void* x, const void* delta, const void* A,
                         const void* Bm, const void* Cm, const void* D,
                         const void* hs, const void* dy, const void* dhT,
                         void* dx, void* ddt, void* da, void* db, void* dc,
                         void* dd, void* dh0, int B, int T, int dI, int S,
                         int block_d, int chunk, int split, void* stream) {
    if (B <= 0 || T <= 0 || dI <= 0) return 0;
    if (bad_launch(block_d, chunk, split)) return (int)cudaErrorInvalidValue;
    SCAN_BWD_DISPATCH(launch_sweep, (const float*)x, (const float*)delta,
                      (const float*)A, (const float*)Bm, (const float*)Cm,
                      (const float*)D, (const float*)hs, (const float*)dy,
                      (const float*)dhT, (float*)dx, (float*)ddt, (float*)da,
                      (float*)db, (float*)dc, (float*)dd, (float*)dh0, B, T,
                      dI, block_d, chunk, (cudaStream_t)stream)
}

long long mamba_scan_bwd_smem_bytes(int S, int block_d, int chunk,
                                    int split) {
    return (long long)sweep_smem_floats(S, block_d, chunk, split)
         * (long long)sizeof(float);
}

const char* mamba_scan_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
