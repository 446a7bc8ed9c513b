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
//   * serial program (lanes < 2): one thread per (b, d), block_d channels a
//     block; the S state entries and the S entries of A stay in registers
//     for the whole sequence; B_t and C_t, shared by every channel of row b,
//     are staged in shared memory `chunk` tokens at a time; x and delta are
//     read coalesced across d.  B * dI threads (65,536 at that shape) keep
//     every SM busy; the exp is __expf (ex2.approx on the SFU);
//   * chunked form (lanes >= 2): the function _chunked_kernel gives, shaped
//     for Hopper.  A span of lanes * chunk tokens is cut into `lanes`
//     chunks, one thread per (lane, channel): (1) each lane scans its chunk
//     from a zero state keeping only the chunk's decay product P_end and
//     local state Hl_end (registers; the reference's per-token P and Hl do
//     not fit 227 KB of shared memory at useful sizes); (2) the `lanes`-step
//     combine threads the carried state through the span's summaries in
//     shared memory; (3) each lane re-scans its chunk from its true entry
//     state, writing y.  The span's end state carries to the next span
//     inside the block.  It does twice the exps of the serial program with
//     `lanes` times the threads.
// T need not divide into chunks or spans: the loops stop at T.
//
// Plain C interface: mamba_scan_fwd launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 512;

// Shared memory, in floats (must match the Python-side checks).
__host__ __device__ inline int64_t scan_smem_floats(int S, int block_d,
                                                    int chunk, int lanes) {
    const int64_t span = (int64_t)chunk * (lanes >= 2 ? lanes : 1);
    return 2 * span * S                                   // B_t, C_t
         + (lanes >= 2 ? 2LL * lanes * S * block_d : 0);  // P_end, Hl_end
}

template <int S>
__global__ void __launch_bounds__(MAX_THREADS)
scan_serial_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm, const float* __restrict__ D,
                   const float* __restrict__ h0, float* __restrict__ y,
                   float* __restrict__ h_out, int T, int dI, int chunk) {
    extern __shared__ float smem[];
    float* bs = smem;                     // (chunk, S)
    float* cs = bs + chunk * S;
    const int nblk = (dI + blockDim.x - 1) / blockDim.x;
    const int b = blockIdx.x / nblk;
    const int d = (blockIdx.x % nblk) * blockDim.x + threadIdx.x;
    const bool live = d < dI;

    float a[S], h[S];
    float dd = 0.f;
    const int64_t hbase = ((int64_t)b * dI + d) * S;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        a[s] = live ? A[(int64_t)d * S + s] : 0.f;
        h[s] = live ? h0[hbase + s] : 0.f;
    }
    if (live) dd = D[d];

    for (int t0 = 0; t0 < T; t0 += chunk) {
        const int n = min(chunk, T - t0);
        __syncthreads();                  // the previous chunk is consumed
        const int64_t sb = ((int64_t)b * T + t0) * S;
        for (int e = threadIdx.x; e < n * S; e += blockDim.x) {
            bs[e] = Bm[sb + e];
            cs[e] = Cm[sb + e];
        }
        __syncthreads();
        if (!live) continue;
        for (int tk = 0; tk < n; ++tk) {
            const int64_t idx = ((int64_t)b * T + t0 + tk) * dI + d;
            const float dt = delta[idx], xv = x[idx];
            const float dx = dt * xv;
            float acc = dd * xv;
#pragma unroll
            for (int s = 0; s < S; ++s) {
                h[s] = fmaf(__expf(dt * a[s]), h[s], dx * bs[tk * S + s]);
                acc = fmaf(cs[tk * S + s], h[s], acc);
            }
            y[idx] = acc;
        }
    }
    if (live) {
#pragma unroll
        for (int s = 0; s < S; ++s) h_out[hbase + s] = h[s];
    }
}

template <int S>
__global__ void __launch_bounds__(MAX_THREADS)
scan_chunked_kernel(const float* __restrict__ x, const float* __restrict__ delta,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, const float* __restrict__ D,
                    const float* __restrict__ h0, float* __restrict__ y,
                    float* __restrict__ h_out, int T, int dI, int chunk,
                    int lanes, int block_d) {
    extern __shared__ float smem[];
    const int span = chunk * lanes;
    float* bs = smem;                     // (span, S)
    float* cs = bs + span * S;
    float* ps = cs + span * S;            // (lanes, S, block_d): P_end
    float* hs = ps + lanes * S * block_d; // (lanes, S, block_d): Hl_end, then entry
    const int nblk = (dI + block_d - 1) / block_d;
    const int b = blockIdx.x / nblk;
    const int dl = threadIdx.x % block_d, l = threadIdx.x / block_d;
    const int d = (blockIdx.x % nblk) * block_d + dl;
    const bool live = d < dI;

    float a[S], hc[S];                    // hc: the carried state (lane 0)
    float dd = 0.f;
    const int64_t hbase = ((int64_t)b * dI + d) * S;
#pragma unroll
    for (int s = 0; s < S; ++s) {
        a[s] = live ? A[(int64_t)d * S + s] : 0.f;
        hc[s] = live && l == 0 ? h0[hbase + s] : 0.f;
    }
    if (live) dd = D[d];

    for (int ts = 0; ts < T; ts += span) {
        const int n = min(span, T - ts);
        __syncthreads();                  // the previous span is consumed
        const int64_t sb = ((int64_t)b * T + ts) * S;
        for (int e = threadIdx.x; e < n * S; e += blockDim.x) {
            bs[e] = Bm[sb + e];
            cs[e] = Cm[sb + e];
        }
        __syncthreads();
        const int c0 = l * chunk;                       // in the span
        const int cn = max(0, min(chunk, n - c0));      // tokens of this lane
        // (1) this lane's chunk from a zero state
        float p[S], hl[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
            p[s] = 1.f;
            hl[s] = 0.f;
        }
        if (live) {
            for (int tk = 0; tk < cn; ++tk) {
                const int64_t idx = ((int64_t)b * T + ts + c0 + tk) * dI + d;
                const float dt = delta[idx];
                const float dx = dt * x[idx];
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    const float da = __expf(dt * a[s]);
                    hl[s] = fmaf(da, hl[s], dx * bs[(c0 + tk) * S + s]);
                    p[s] *= da;
                }
            }
        }
#pragma unroll
        for (int s = 0; s < S; ++s) {
            ps[(l * S + s) * block_d + dl] = p[s];
            hs[(l * S + s) * block_d + dl] = hl[s];
        }
        __syncthreads();
        // (2) the lanes-step combine: each lane's entry state replaces its
        // local state, and the carried state steps through the span
        if (l == 0) {
            for (int ll = 0; ll < lanes; ++ll) {
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    const int at = (ll * S + s) * block_d + dl;
                    const float loc = hs[at];
                    hs[at] = hc[s];
                    hc[s] = fmaf(ps[at], hc[s], loc);
                }
            }
        }
        __syncthreads();
        // (3) re-scan from the true entry state, writing y
        if (live) {
#pragma unroll
            for (int s = 0; s < S; ++s) hl[s] = hs[(l * S + s) * block_d + dl];
            for (int tk = 0; tk < cn; ++tk) {
                const int64_t idx = ((int64_t)b * T + ts + c0 + tk) * dI + d;
                const float dt = delta[idx], xv = x[idx];
                const float dx = dt * xv;
                float acc = dd * xv;
#pragma unroll
                for (int s = 0; s < S; ++s) {
                    hl[s] = fmaf(__expf(dt * a[s]), hl[s],
                                 dx * bs[(c0 + tk) * S + s]);
                    acc = fmaf(cs[(c0 + tk) * S + s], hl[s], acc);
                }
                y[idx] = acc;
            }
        }
    }
    if (live && l == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) h_out[hbase + s] = hc[s];
    }
}

template <int S>
int launch_s(const float* x, const float* delta, const float* A,
             const float* Bm, const float* Cm, const float* D, const float* h0,
             float* y, float* h_out, int B, int T, int dI, int block_d,
             int chunk, int lanes, cudaStream_t stream) {
    const size_t smem = (size_t)scan_smem_floats(S, block_d, chunk, lanes)
                      * sizeof(float);
    const int64_t blocks = (int64_t)B * ((dI + block_d - 1) / block_d);
    cudaError_t err;
    if (lanes >= 2) {
        err = cudaFuncSetAttribute(scan_chunked_kernel<S>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        scan_chunked_kernel<S><<<(unsigned)blocks, block_d * lanes, smem, stream>>>(
            x, delta, A, Bm, Cm, D, h0, y, h_out, T, dI, chunk, lanes, block_d);
    } else {
        err = cudaFuncSetAttribute(scan_serial_kernel<S>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        scan_serial_kernel<S><<<(unsigned)blocks, block_d, smem, stream>>>(
            x, delta, A, Bm, Cm, D, h0, y, h_out, T, dI, chunk);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, delta: (B, T, dI); A: (dI, S); Bm, Cm: (B, T, S); D: (dI,);
// h0: (B, dI, S); y: (B, T, dI); h_out: (B, dI, S); all float32 and
// contiguous.  S in {4, 8, 16}.  lanes < 2: the serial program, block_d
// threads; lanes >= 2: the chunked form, block_d * lanes threads (<= 512).
int mamba_scan_fwd(const void* x, const void* delta, const void* A,
                   const void* Bm, const void* Cm, const void* D,
                   const void* h0, void* y, void* h_out, int B, int T, int dI,
                   int S, int block_d, int chunk, int lanes, void* stream) {
    if (B <= 0 || T <= 0 || dI <= 0) return 0;
    if (block_d <= 0 || chunk <= 0) return (int)cudaErrorInvalidValue;
    const float *fx = (const float*)x, *fdt = (const float*)delta,
                *fa = (const float*)A, *fb = (const float*)Bm,
                *fc = (const float*)Cm, *fd = (const float*)D,
                *fh0 = (const float*)h0;
    float *fy = (float*)y, *fh = (float*)h_out;
    cudaStream_t st = (cudaStream_t)stream;
    switch (S) {
        case 4: return launch_s<4>(fx, fdt, fa, fb, fc, fd, fh0, fy, fh, B, T, dI,
                                   block_d, chunk, lanes, st);
        case 8: return launch_s<8>(fx, fdt, fa, fb, fc, fd, fh0, fy, fh, B, T, dI,
                                   block_d, chunk, lanes, st);
        case 16: return launch_s<16>(fx, fdt, fa, fb, fc, fd, fh0, fy, fh, B, T,
                                     dI, block_d, chunk, lanes, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

long long mamba_scan_smem_bytes(int S, int block_d, int chunk, int lanes) {
    return (long long)scan_smem_floats(S, block_d, chunk, lanes)
         * (long long)sizeof(float);
}

const char* mamba_scan_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
