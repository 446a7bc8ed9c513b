// The RWKV-6 wkv recurrence over chunks of tokens, float32, for NVIDIA Hopper
// (sm_90a): what the forward (rwkv6_wkv.cu, program "states") and the
// backward (rwkv6_wkv_bwd.cu, program "scans") share.
//
// Per (batch, head), with a (hd x hd) state S (key i x value j) and its
// adjoint G = dL/dS:
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T
// A chunk of C tokens is one product (an FMA a cell and token):
//     S <- diag(W) S + sum_t diag(prod_{s>t} w_s) k_t v_t^T
//     G <- diag(W) G + sum_t diag(prod_{s<t} w_s) r_t dy_t^T
// with W the product of the chunk's w; every factor a product of w's
// (nothing inverted, no log or exp), so w = 1e-30 or 0 stays finite.
//
// Also here: the 16-byte cp.async helpers the scan uses.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv_chunk {

// the pitch of a shared tile row of hd floats (16-byte rows, banks skewed)
__host__ __device__ constexpr int pitch(int hd) { return hd + 4; }

// Shared memory of the scan program, in floats: two buffers of a, w, b
// tiles; the state on its way out.
__host__ __device__ inline int64_t scan_smem_floats(int chunk, int hd) {
    return 2LL * 3 * chunk * hd + (int64_t)hd * pitch(hd);
}

// 16-byte asynchronous copy device -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// the scan over chunks

// A block per (b, head) and direction: the state S (forward: a = k,
// b = v) or the adjoint G (backward: a = r, b = dy).  Thread (g, i)
// carries columns [g * COLS, (g + 1) * COLS) of row i; a chunk's a, w and
// b tiles are read once by the block into a double buffer by cp.async
// while the chunk before is stepped.  Writes the value entering every
// chunk (S) or leaving it (G), (B, H, N, hd, hd), then S's value after the
// last chunk to s_T (when given) or G's before the first to ds0.
template <int HD, int COLS>
__device__ __forceinline__ void scan_body(
        const float* __restrict__ r, const float* __restrict__ k,
        const float* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ dy, const float* __restrict__ s0,
        const float* __restrict__ dsT, float* __restrict__ states,
        float* __restrict__ adj, float* __restrict__ ds0,
        float* __restrict__ sT, int T, int H, int chunk, int N, bool back) {
    extern __shared__ __align__(16) float smem[];
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int tid = threadIdx.x, i = tid % HD, j0 = (tid / HD) * COLS;
    const float* av = back ? r : k;
    const float* bv = back ? dy : v;
    float* store = back ? adj : states;
    const int64_t hh = (int64_t)HD * HD;
    const int64_t row = (int64_t)H * HD;
    const int tile = chunk * HD;
    float* out_tile = smem + 6 * tile;

    auto load = [&](int n, int buf) {
        const int t0 = n * chunk, nv = min(chunk, T - t0);
        float* as = smem + buf * 3 * tile;
        const int64_t base = ((int64_t)b * T + t0) * row + (int64_t)h * HD;
        for (int e = tid; e < tile / 4; e += blockDim.x) {
            const int tk = e / (HD / 4), c = (e - tk * (HD / 4)) * 4;
            const bool in = tk < nv;
            const int64_t g = base + (in ? tk : 0) * row + c;
            cp_async16(as + tk * HD + c, av + g, in);
            cp_async16(as + tile + tk * HD + c, w + g, in);
            cp_async16(as + 2 * tile + tk * HD + c, bv + g, in);
        }
    };

    float S[COLS];
    {
        const float4* src = reinterpret_cast<const float4*>(
            (back ? dsT : s0) + bh * hh + (int64_t)i * HD + j0);
#pragma unroll
        for (int c = 0; c < COLS / 4; ++c) {
            const float4 x = src[c];
            S[4 * c] = x.x; S[4 * c + 1] = x.y; S[4 * c + 2] = x.z; S[4 * c + 3] = x.w;
        }
    }
    load(back ? N - 1 : 0, 0);
    cp_async_commit();
    for (int step = 0; step < N; ++step) {
        const int n = back ? N - 1 - step : step;
        const int nv = min(chunk, T - n * chunk);
        {                                 // the state, through shared memory
            float4* st = reinterpret_cast<float4*>(out_tile + i * pitch(HD) + j0);
#pragma unroll
            for (int c = 0; c < COLS / 4; ++c)
                st[c] = make_float4(S[4 * c], S[4 * c + 1], S[4 * c + 2], S[4 * c + 3]);
        }
        if (step + 1 < N) {               // the next chunk, while this one runs
            load(back ? n - 1 : n + 1, (step + 1) & 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* as = smem + (step & 1) * 3 * tile;
        const float* ws = as + tile;
        const float* bs = ws + tile;
        {                                 // ... and out in whole rows
            float4* dst = reinterpret_cast<float4*>(store + (bh * N + n) * hh);
            for (int e = tid; e < HD * HD / 4; e += blockDim.x) {
                const int row_ = e / (HD / 4), c = e - row_ * (HD / 4);
                dst[e] = *reinterpret_cast<const float4*>(out_tile + row_ * pitch(HD) + 4 * c);
            }
        }
        // from the chunk's far edge: p is the decay product between token
        // t and the edge the state leaves by, then the whole chunk's
        float acc[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] = 0.f;
        float p = 1.f;
        for (int q = 0; q < nv; ++q) {
            const int tk = back ? q : nv - 1 - q;
            const float at = as[tk * HD + i] * p;
            p *= ws[tk * HD + i];
            const float4* bt = reinterpret_cast<const float4*>(bs + tk * HD + j0);
#pragma unroll
            for (int c = 0; c < COLS / 4; ++c) {
                const float4 x = bt[c];
                acc[4 * c] = fmaf(at, x.x, acc[4 * c]);
                acc[4 * c + 1] = fmaf(at, x.y, acc[4 * c + 1]);
                acc[4 * c + 2] = fmaf(at, x.z, acc[4 * c + 2]);
                acc[4 * c + 3] = fmaf(at, x.w, acc[4 * c + 3]);
            }
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) S[c] = fmaf(p, S[c], acc[c]);
        __syncthreads();                  // the buffer is refilled next step
    }
    float* last = back ? ds0 : sT;
    if (last) {
        float4* dst = reinterpret_cast<float4*>(last + bh * hh + (int64_t)i * HD + j0);
#pragma unroll
        for (int c = 0; c < COLS / 4; ++c)
            dst[c] = make_float4(S[4 * c], S[4 * c + 1], S[4 * c + 2], S[4 * c + 3]);
    }
}

// The forward's states (B8's program "states"): the state direction alone.
template <int HD, int COLS>
__global__ void __launch_bounds__(HD * HD / COLS)
wkv_fwd_states_kernel(const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ w, const float* __restrict__ s0,
                      float* __restrict__ states, float* __restrict__ sT,
                      int T, int H, int chunk, int N) {
    scan_body<HD, COLS>(nullptr, k, v, w, nullptr, s0, nullptr, states,
                        nullptr, nullptr, sT, T, H, chunk, N, false);
}

// The backward's scans (B9's program "scans"): blockIdx.y 0 the state, 1
// the adjoint, in one launch.
template <int HD, int COLS>
__global__ void __launch_bounds__(HD * HD / COLS)
wkv_bwd_scans_kernel(const float* __restrict__ r, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ w,
                     const float* __restrict__ dy, const float* __restrict__ s0,
                     const float* __restrict__ dsT, float* __restrict__ states,
                     float* __restrict__ adj, float* __restrict__ ds0, int T,
                     int H, int chunk, int N) {
    scan_body<HD, COLS>(r, k, v, w, dy, s0, dsT, states, adj, ds0, nullptr, T,
                        H, chunk, N, blockIdx.y == 1);
}

template <int HD, int COLS>
int launch_chunk_scan(const float* r, const float* k, const float* v,
                      const float* w, const float* dy, const float* s0,
                      const float* dsT, float* states, float* adj, float* ds0,
                      float* sT, int B, int T, int H, int chunk, int dirs,
                      cudaStream_t stream) {
    const size_t smem = (size_t)scan_smem_floats(chunk, HD) * sizeof(float);
    const int N = (T + chunk - 1) / chunk;
    cudaError_t err;
    if (dirs == 1) {
        err = cudaFuncSetAttribute(wkv_fwd_states_kernel<HD, COLS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        wkv_fwd_states_kernel<HD, COLS><<<(unsigned)(B * H), HD * HD / COLS,
                                          smem, stream>>>(
            k, v, w, s0, states, sT, T, H, chunk, N);
    } else {
        err = cudaFuncSetAttribute(wkv_bwd_scans_kernel<HD, COLS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        const dim3 grid((unsigned)(B * H), 2);
        wkv_bwd_scans_kernel<HD, COLS><<<grid, HD * HD / COLS, smem, stream>>>(
            r, k, v, w, dy, s0, dsT, states, adj, ds0, T, H, chunk, N);
    }
    return (int)cudaGetLastError();
}

template <int HD>
int dispatch_chunk_scan(int cols, const float* r, const float* k,
                        const float* v, const float* w, const float* dy,
                        const float* s0, const float* dsT, float* states,
                        float* adj, float* ds0, float* sT, int B, int T, int H,
                        int chunk, int dirs, cudaStream_t stream) {
    if (HD % cols) return (int)cudaErrorInvalidValue;
    switch (cols) {
        case 4: return launch_chunk_scan<HD, 4>(r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        case 8: return launch_chunk_scan<HD, 8>(r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        case 16: return launch_chunk_scan<HD, 16>(r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        case 32:
            if constexpr (HD % 32 == 0)
                return launch_chunk_scan<HD, 32>(r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
            return (int)cudaErrorInvalidValue;
        default: return (int)cudaErrorInvalidValue;
    }
}

// The scan at head size hd in {16, 32, 48, 64}: dirs 1 runs S alone (the
// forward's states, wkv_fwd_states_kernel), 2 runs S and G in one launch
// (the backward's scans, wkv_bwd_scans_kernel).
inline int chunk_scan(int hd, int cols, const float* r, const float* k,
                      const float* v, const float* w, const float* dy,
                      const float* s0, const float* dsT, float* states,
                      float* adj, float* ds0, float* sT, int B, int T, int H,
                      int chunk, int dirs, cudaStream_t stream) {
    switch (hd) {
        case 16: return dispatch_chunk_scan<16>(cols, r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        case 32: return dispatch_chunk_scan<32>(cols, r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        case 48: return dispatch_chunk_scan<48>(cols, r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        case 64: return dispatch_chunk_scan<64>(cols, r, k, v, w, dy, s0, dsT, states, adj, ds0, sT, B, T, H, chunk, dirs, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace wkv_chunk
