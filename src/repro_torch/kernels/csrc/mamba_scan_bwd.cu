// Mamba-1 selective scan (backward) for NVIDIA Hopper (sm_90a), float32, as
// a chunk-parallel form.
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
// and dh0 = g at the end.
//
// The state is diagonal: each (b, d, s) is an independent affine recurrence
// in both directions, so the chain across a stretch of tokens shrinks to a
// few floats: its decay product P = prod a_t, its local state from zero
// h_loc and its local adjoint from zero g_loc = sum_t (prod_{σ <= t} a_σ)
// dy_t C_t (the reverse recurrence's g at its entry, taken forward with a
// running product).  Tokens go in chunks of C, chunks in spans of K.
// Three programs, deterministic and free of atomics:
//   * "summaries": one block per (b, channel block, span), one pass over
//     the span's tokens (one exp a cell), writing each chunk's P and h_loc
//     (B, N, dI, S) and the span's P, h_loc and g_loc (B, N / K, dI, S),
//     the block's results leaving through shared memory as whole rows;
//   * "carry": per (b, d, s) and direction, over the spans: the state
//     entering and the adjoint leaving every span, written in place of the
//     span's h_loc and g_loc, and dh0 (N / K x S floats a channel: a pass
//     of its own, no decoupled look-back needed);
//   * "chunks": one block per (b, channel block, span).  It takes its
//     chunks' entry states from the span's and the chunks' P and h_loc
//     (staged once), then walks the chunks last to first, the adjoint
//     carried in registers from chunk to chunk, staging the next chunk (x,
//     delta, dy, B, C) by cp.async while it works on the current: the
//     chunk forward again from its entry state, keeping every token's
//     a_t h_{t-1} and a_t in registers (the second and last exp a cell),
//     then the walk back.  dx and ddelta need sum_s g B and sum_s q A
//     (q = g a_t h_{t-1}) a token, sums over a channel's part lanes; dB
//     and dC need sums over channels.  Both are taken once a chunk, after
//     the walk: each thread's (token, entry) dC, dB contributions take
//     the places of its kept values, and one butterfly reduce-scatter over
//     the warp's channel lanes and one sum over the warps reduce the
//     (chunk x 2S) tile, written as per-block partials (n_db, B, T, S)
//     that the caller sums; one reduce-scatter over the part lanes gives
//     the per-token sums, and dx, ddelta leave as whole rows.  dA and dD
//     are per-(b, span) partials.
// Only products of a_t <= 1 appear: an a_t that underflows to 0 gives
// finite, exact gradients.  `split` threads share a channel (S / split
// entries each); a chunk-program thread keeps chunk x S / split floats of
// each of a_t h_{t-1} and a_t and two per-token sums in registers:
// chunk x (S / split + 1) <= 80.  The exps are ex2 on the SFU of
// delta (A log2 e).
//
// What bounds it on the H100: bytes.  At the Jamba training shape (B 2,
// T 2048, dI 8192, S 16) the function reads x, delta, dy and writes dx,
// ddelta (5 x 134 MB, 0.20 ms at 3.35 TB/s); its one exp a cell on the
// SFUs is 0.13 ms.  This design reads x, delta and dy twice, writes and
// reads each chunk's P and h_loc once (2 x B x N x dI x S floats), and
// takes two exps a cell.
//
// Plain C interface: mamba_scan_bwd_summaries / _carry / _chunks launch on
// the given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_scan_tiles.cuh"

namespace {

using namespace mscan;

constexpr int MAX_THREADS = 256;
// a chunk-program thread keeps chunk x (S / split + 1) floats of each kind
// in registers: at most this many
constexpr int MAX_KEPT = 80;
constexpr int CARRY_THREADS = 256;

// Shared memory, in floats (must match the Python-side checks).
__host__ __device__ inline int64_t chunk_tiles_floats(int S, int block_d,
                                                      int chunk) {
    return 3LL * chunk * block_d + 2LL * chunk * S;   // x, delta, dy; B, C
}

__host__ __device__ inline int64_t summaries_smem_floats(int S, int block_d,
                                                         int chunk) {
    return 2 * chunk_tiles_floats(S, block_d, chunk)  // two buffers
         + 3LL * block_d * S;                         // results on their way out
}

__host__ __device__ inline int64_t chunks_smem_floats(int S, int block_d,
                                                      int chunk, int split,
                                                      int span) {
    const int64_t warps = (int64_t)block_d * split / 32;
    return 2 * chunk_tiles_floats(S, block_d, chunk)  // two buffers
         + 2LL * span * block_d * S                   // the chunks' P, h_loc
         + 2LL * chunk * block_d                      // sum_s g B, sum_s q A
         + warps * chunk * 2 * S;                     // per-warp dC, dB partials
}

// Stage a chunk's x, delta, dy (chunk x block_d; channels past dI and
// tokens past T read as 0, which leave the state and the adjoint as they
// are) and B, C (chunk x S) in shared memory, by cp.async.
__device__ __forceinline__ void stage_chunk(
        const float* __restrict__ x, const float* __restrict__ delta,
        const float* __restrict__ dy, const float* __restrict__ Bm,
        const float* __restrict__ Cm, float* tiles, int b, int n, int d0,
        int T, int dI, int S, int chunk, int block_d) {
    float* xs = tiles;
    float* ds = xs + chunk * block_d;
    float* ys = ds + chunk * block_d;
    float* bs = ys + chunk * block_d;
    float* cs = bs + chunk * S;
    const int t0 = n * chunk, nv = min(chunk, T - t0);
    for (int e = threadIdx.x; e < chunk * block_d; e += blockDim.x) {
        const int t = e / block_d, d = d0 + e - t * block_d;
        const bool in = t < nv && d < dI;
        const int64_t g = in ? ((int64_t)b * T + t0 + t) * dI + d : 0;
        cp_async4(xs + e, x + g, in);
        cp_async4(ds + e, delta + g, in);
        cp_async4(ys + e, dy + g, in);
    }
    const int64_t sb = ((int64_t)b * T + t0) * S;
    for (int e = threadIdx.x; e < chunk * S; e += blockDim.x) {
        const bool in = e < nv * S;
        cp_async4(bs + e, Bm + (in ? sb + e : 0), in);
        cp_async4(cs + e, Cm + (in ? sb + e : 0), in);
    }
}

// program "summaries": each chunk's P and h_loc (B, N, dI, S), and each
// span's P, h_loc, g_loc (B, NS, dI, S).  Thread (channel, part) carries
// S / SPLIT entries.
template <int S, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
scan_bwd_summaries_kernel(const float* __restrict__ x,
                          const float* __restrict__ delta,
                          const float* __restrict__ A,
                          const float* __restrict__ Bm,
                          const float* __restrict__ Cm,
                          const float* __restrict__ dy,
                          float* __restrict__ prod_c, float* __restrict__ hloc_c,
                          float* __restrict__ prod_s, float* __restrict__ hloc_s,
                          float* __restrict__ gloc_s, int T, int dI,
                          int chunk, int block_d, int N, int span) {
    constexpr int R = S / SPLIT;
    extern __shared__ __align__(16) float smem[];
    const int tiles = (int)chunk_tiles_floats(S, block_d, chunk);
    float* out = smem + 2 * tiles;                      // (3, block_d, S)
    const int NS = (N + span - 1) / span;
    const int nblk = (dI + block_d - 1) / block_d;
    const int c = blockIdx.x % NS, rest = blockIdx.x / NS;
    const int dblk = rest % nblk, b = rest / nblk;
    const int tid = threadIdx.x;
    const int dl = tid / SPLIT, part = tid % SPLIT;
    const int d0 = dblk * block_d, d = d0 + dl;
    const bool live = d < dI;
    const int n0 = c * span, n1 = min(N, n0 + span);
    const int cells = min(block_d, dI - d0) * S;

    stage_chunk(x, delta, dy, Bm, Cm, smem, b, n0, d0, T, dI, S, chunk,
                block_d);
    cp_async_commit();
    float a2[R], hs[R], ps[R], gs[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        a2[r] = live ? A[(int64_t)d * S + part * R + r] * LOG2E : 0.f;
        hs[r] = 0.f;
        ps[r] = 1.f;
        gs[r] = 0.f;
    }
    for (int n = n0; n < n1; ++n) {
        const int which = (n - n0) & 1;
        if (n + 1 < n1) {                 // the next chunk, while this one runs
            stage_chunk(x, delta, dy, Bm, Cm, smem + (which ^ 1) * tiles, b,
                        n + 1, d0, T, dI, S, chunk, block_d);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* xs = smem + which * tiles;
        const float* ds = xs + chunk * block_d;
        const float* ys = ds + chunk * block_d;
        const float* bs = ys + chunk * block_d;
        const float* cs = bs + chunk * S;
        float h[R], p[R];
#pragma unroll
        for (int r = 0; r < R; ++r) { h[r] = 0.f; p[r] = 1.f; }
        for (int t = 0; t < chunk; ++t) {
            const float dt = ds[t * block_d + dl];
            const float dtx = dt * xs[t * block_d + dl];
            const float dyv = ys[t * block_d + dl];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int s = part * R + r;
                const float at = ex2(dt * a2[r]);
                h[r] = fmaf(at, h[r], dtx * bs[t * S + s]);
                p[r] *= at;
                ps[r] *= at;
                gs[r] = fmaf(ps[r], dyv * cs[t * S + s], gs[r]);
            }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int e = dl * S + part * R + r;
            out[e] = p[r];
            out[block_d * S + e] = h[r];
            hs[r] = fmaf(p[r], hs[r], h[r]);
        }
        __syncthreads();
        const int64_t o = (((int64_t)b * N + n) * dI + d0) * S;
        for (int e = tid; e < cells; e += blockDim.x) {
            prod_c[o + e] = out[e];
            hloc_c[o + e] = out[block_d * S + e];
        }
        __syncthreads();                  // out and the buffer are reused
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = dl * S + part * R + r;
        out[e] = ps[r];
        out[block_d * S + e] = hs[r];
        out[2 * block_d * S + e] = gs[r];
    }
    __syncthreads();
    const int64_t o = (((int64_t)b * NS + c) * dI + d0) * S;
    for (int e = tid; e < cells; e += blockDim.x) {
        prod_s[o + e] = out[e];
        hloc_s[o + e] = out[block_d * S + e];
        gloc_s[o + e] = out[2 * block_d * S + e];
    }
}

// program "carry": a thread per (b, d, s) and direction (blockIdx.y: 0 the
// state, 1 the adjoint), over the spans; the span's h_loc becomes the
// state entering it and its g_loc the adjoint leaving it.  The loads of
// CARRY_BATCH spans are in flight at once.
constexpr int CARRY_BATCH = 8;

__global__ void __launch_bounds__(CARRY_THREADS)
scan_bwd_carry_kernel(const float* __restrict__ h0,
                      const float* __restrict__ dhT,
                      const float* __restrict__ prod, float* __restrict__ hloc,
                      float* __restrict__ gloc, float* __restrict__ dh0,
                      int Bsz, int dI, int S, int N) {
    const int64_t per = (int64_t)dI * S;
    const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= Bsz * per) return;
    const int64_t b = e / per, ds = e - b * per;
    const bool back = blockIdx.y == 1;
    float* loc = back ? gloc : hloc;
    float c = back ? dhT[e] : h0[e];
    for (int m = 0; m < N; m += CARRY_BATCH) {
        float pv[CARRY_BATCH], lv[CARRY_BATCH];
#pragma unroll
        for (int j = 0; j < CARRY_BATCH; ++j) {
            const int n = back ? N - 1 - (m + j) : m + j;
            const bool in = m + j < N;
            const int64_t i = (b * N + (in ? n : 0)) * per + ds;
            pv[j] = in ? prod[i] : 1.f;
            lv[j] = in ? loc[i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < CARRY_BATCH; ++j) {
            const int n = back ? N - 1 - (m + j) : m + j;
            if (m + j < N) {
                loc[(b * N + n) * per + ds] = c;
                c = fmaf(pv[j], c, lv[j]);
            }
        }
    }
    if (back) dh0[e] = c;
}

// program "chunks".  Outputs: dx, ddelta (B, T, dI); dA partials (B, NS,
// dI, S); dB, dC partials (n_db, B, T, S); dD partials (B, NS, dI).
template <int C, int S, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
scan_bwd_chunks_kernel(const float* __restrict__ x,
                       const float* __restrict__ delta,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       const float* __restrict__ D,
                       const float* __restrict__ dy,
                       const float* __restrict__ prod_c,
                       const float* __restrict__ hloc_c,
                       const float* __restrict__ entry_s,
                       const float* __restrict__ exit_s,
                       float* __restrict__ dx_out, float* __restrict__ ddt_out,
                       float* __restrict__ da_part, float* __restrict__ db_part,
                       float* __restrict__ dc_part, float* __restrict__ dd_part,
                       int Bsz, int T, int dI, int block_d, int N, int span) {
    constexpr int R = S / SPLIT;
    constexpr int NV = 2 * C * R;         // per token: R of dC, then R of dB
    constexpr int NL = rs_left<NV, 16, SPLIT>();
    constexpr int DUP = rs_dup<NV, 16, SPLIT>();
    constexpr int NU = 2 * C;             // sum_s g B, then sum_s q A, a token
    constexpr int NL2 = rs_left<NU, SPLIT / 2, 1>();
    constexpr int DUP2 = rs_dup<NU, SPLIT / 2, 1>();
    extern __shared__ __align__(16) float smem[];
    const int tiles = (int)chunk_tiles_floats(S, block_d, C);
    float* pcs = smem + 2 * tiles;        // (span, block_d, S): P, then
    float* hcs = pcs + span * block_d * S;  // h_loc, then entry states
    float* sxs = hcs + span * block_d * S;  // (C, block_d)
    float* sqs = sxs + C * block_d;
    float* wpart = sqs + C * block_d;     // (warps, C, 2S)
    const int nth = blockDim.x, nwarps = nth / 32;
    const int NS = (N + span - 1) / span;
    const int nblk = (dI + block_d - 1) / block_d;
    const int c = blockIdx.x % NS, rest = blockIdx.x / NS;
    const int dblk = rest % nblk, b = rest / nblk;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int dl = tid / SPLIT, part = tid % SPLIT;
    const int d0 = dblk * block_d, d = d0 + dl;
    const bool live = d < dI;
    const int n0 = c * span, kk = min(N, n0 + span) - n0;
    const int cells = min(block_d, dI - d0) * S;

    // stage the chunks' P and h_loc, and the last chunk
    for (int k = 0; k < kk; ++k) {
        const int64_t o = (((int64_t)b * N + n0 + k) * dI + d0) * S;
        for (int e = tid; e < block_d * S; e += nth) {
            const bool in = e < cells;
            cp_async4(pcs + k * block_d * S + e, prod_c + (in ? o + e : 0), in);
            cp_async4(hcs + k * block_d * S + e, hloc_c + (in ? o + e : 0), in);
        }
    }
    stage_chunk(x, delta, dy, Bm, Cm, smem, b, n0 + kk - 1, d0, T, dI, S, C,
                block_d);
    cp_async_commit();
    const int64_t cell = (((int64_t)b * NS + c) * dI + d) * S + part * R;
    float a2[R], ar[R], g[R], dA[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        ar[r] = live ? A[(int64_t)d * S + part * R + r] : 0.f;
        a2[r] = ar[r] * LOG2E;
        g[r] = live ? exit_s[cell + r] : 0.f;
        dA[r] = 0.f;
    }
    float dD = 0.f;
    {                                     // each chunk's entry state, in place
        float h[R];                       // of its h_loc (a thread its cells)
#pragma unroll
        for (int r = 0; r < R; ++r) h[r] = live ? entry_s[cell + r] : 0.f;
        cp_async_wait<0>();
        __syncthreads();                  // staged by every thread
        for (int k = 0; k < kk; ++k) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int e = k * block_d * S + dl * S + part * R + r;
                const float loc = hcs[e];
                hcs[e] = h[r];
                h[r] = fmaf(pcs[e], h[r], loc);
            }
        }
    }

    for (int step = 0; step < kk; ++step) {
        const int k = kk - 1 - step, n = n0 + k;
        const int which = step & 1;
        if (step + 1 < kk) {              // the chunk before, while this one runs
            stage_chunk(x, delta, dy, Bm, Cm, smem + (which ^ 1) * tiles, b,
                        n - 1, d0, T, dI, S, C, block_d);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const float* xs = smem + which * tiles;
        const float* ds = xs + C * block_d;
        const float* ys = ds + C * block_d;
        const float* bs = ys + C * block_d;
        const float* cs = bs + C * S;
        const int t0 = n * C, nv = min(C, T - t0);

        // the chunk forward from its entry state: v[(2t) R + r] = a_t
        // h_{t-1}, v[(2t + 1) R + r] = a_t
        float v[NV];
        {
            float h[R];
#pragma unroll
            for (int r = 0; r < R; ++r) h[r] = hcs[k * block_d * S + dl * S + part * R + r];
#pragma unroll
            for (int t = 0; t < C; ++t) {
                const float dt = ds[t * block_d + dl];
                const float dtx = dt * xs[t * block_d + dl];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float at = ex2(dt * a2[r]);
                    const float ahp = at * h[r];
                    v[2 * t * R + r] = ahp;
                    v[(2 * t + 1) * R + r] = at;
                    h[r] = fmaf(dtx, bs[t * S + part * R + r], ahp);
                }
            }
        }
        // back through the chunk from its exit adjoint; each token's dC,
        // dB contributions take the places of its a_t h_{t-1}, a_t
        float u[NU];
#pragma unroll
        for (int t = C - 1; t >= 0; --t) {
            const float dt = ds[t * block_d + dl];
            const float xv = xs[t * block_d + dl];
            const float dyv = ys[t * block_d + dl];
            const float dtx = dt * xv;
            float sx = 0.f, sq = 0.f;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int s = part * R + r;
                const float bt = bs[t * S + s];
                const float ahp = v[2 * t * R + r];
                const float at = v[(2 * t + 1) * R + r];
                const float gr = fmaf(dyv, cs[t * S + s], g[r]);
                v[2 * t * R + r] = dyv * fmaf(dtx, bt, ahp);    // dC_t[s]
                v[(2 * t + 1) * R + r] = gr * dtx;              // dB_t[s]
                sx = fmaf(gr, bt, sx);
                const float q = gr * ahp;                       // g a_t h_{t-1}
                sq = fmaf(q, ar[r], sq);
                dA[r] = fmaf(q, dt, dA[r]);
                g[r] = gr * at;
            }
            u[t] = sx;
            u[C + t] = sq;
            dD = fmaf(dyv, xv, dD);
        }
        // dC, dB: over the warp's channel lanes; sum_s g B and sum_s q A:
        // over a channel's part lanes
        const int first = reduce_scatter<NV, 16, SPLIT>(v, lane);
        if ((lane & DUP) == 0) {
#pragma unroll
            for (int i = 0; i < NL; ++i) {
                const int q = first + i;
                const int t = q / (2 * R), kind = (q / R) & 1, r = q % R;
                wpart[(warp * C + t) * 2 * S + kind * S + part * R + r] = v[i];
            }
        }
        const int first2 = reduce_scatter<NU, SPLIT / 2, 1>(u, lane);
        if ((lane & DUP2) == 0) {
#pragma unroll
            for (int i = 0; i < NL2; ++i) {
                const int q = first2 + i;
                (q < C ? sxs : sqs)[(q % C) * block_d + dl] = u[i];
            }
        }
        __syncthreads();
        for (int e = tid; e < nv * 2 * S; e += nth) {
            const int t = e / (2 * S), q = e - t * 2 * S;
            float acc = 0.f;
            for (int w = 0; w < nwarps; ++w) acc += wpart[(w * C + t) * 2 * S + q];
            const int64_t o = (((int64_t)dblk * Bsz + b) * T + t0 + t) * S;
            if (q < S) dc_part[o + q] = acc;
            else db_part[o + q - S] = acc;
        }
        // dx = D dy + delta sum_s g B, ddelta = sum_s q A + x sum_s g B
        for (int e = tid; e < nv * block_d; e += nth) {
            const int t = e / block_d, dc = d0 + e - t * block_d;
            if (dc < dI) {
                const float sx = sxs[e];
                const int64_t o = ((int64_t)b * T + t0 + t) * dI + dc;
                dx_out[o] = fmaf(D[dc], ys[e], ds[e] * sx);
                ddt_out[o] = fmaf(xs[e], sx, sqs[e]);
            }
        }
        __syncthreads();                  // the buffer is refilled next
    }
    if (live) {
#pragma unroll
        for (int r = 0; r < R; ++r) da_part[cell + r] = dA[r];
        if (part == 0) dd_part[((int64_t)b * NS + c) * dI + d] = dD;
    }
}

bool kept_fits(int chunk, int S, int split) {
    return chunk * (S / split + 1) <= MAX_KEPT;
}

template <int S, int SPLIT>
int launch_summaries(const float* x, const float* delta, const float* A,
                     const float* Bm, const float* Cm, const float* dy,
                     float* prod_c, float* hloc_c, float* prod_s,
                     float* hloc_s, float* gloc_s, int B, int T, int dI,
                     int block_d, int chunk, int span, cudaStream_t stream) {
    const size_t smem = (size_t)summaries_smem_floats(S, block_d, chunk)
                      * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_summaries_kernel<S, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int N = (T + chunk - 1) / chunk, NS = (N + span - 1) / span;
    const int64_t blocks = (int64_t)B * ((dI + block_d - 1) / block_d) * NS;
    scan_bwd_summaries_kernel<S, SPLIT><<<(unsigned)blocks, block_d * SPLIT,
                                          smem, stream>>>(
        x, delta, A, Bm, Cm, dy, prod_c, hloc_c, prod_s, hloc_s, gloc_s, T,
        dI, chunk, block_d, N, span);
    return (int)cudaGetLastError();
}

template <int C, int S, int SPLIT>
int launch_chunks(const float* x, const float* delta, const float* A,
                  const float* Bm, const float* Cm, const float* D,
                  const float* dy, const float* prod_c, const float* hloc_c,
                  const float* entry_s, const float* exit_s, float* dx,
                  float* ddt, float* da, float* db, float* dc, float* ddp,
                  int B, int T, int dI, int block_d, int span,
                  cudaStream_t stream) {
    const size_t smem = (size_t)chunks_smem_floats(S, block_d, C, SPLIT, span)
                      * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_chunks_kernel<C, S, SPLIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int N = (T + C - 1) / C, NS = (N + span - 1) / span;
    const int64_t blocks = (int64_t)B * ((dI + block_d - 1) / block_d) * NS;
    scan_bwd_chunks_kernel<C, S, SPLIT><<<(unsigned)blocks, block_d * SPLIT,
                                          smem, stream>>>(
        x, delta, A, Bm, Cm, D, dy, prod_c, hloc_c, entry_s, exit_s, dx, ddt,
        da, db, dc, ddp, B, T, dI, block_d, N, span);
    return (int)cudaGetLastError();
}

// chunk x (S / split + 1) kept floats a thread: at most MAX_KEPT
template <int S, int SPLIT>
int launch_chunks_at(int chunk, const float* x, const float* delta,
                     const float* A, const float* Bm, const float* Cm,
                     const float* D, const float* dy, const float* prod_c,
                     const float* hloc_c, const float* entry_s,
                     const float* exit_s, float* dx, float* ddt, float* da,
                     float* db, float* dc, float* ddp, int B, int T, int dI,
                     int block_d, int span, cudaStream_t stream) {
    constexpr int R = S / SPLIT;
#define SCAN_BWD_CHUNK(CH)                                                    \
    if (chunk == CH) {                                                        \
        if constexpr (CH * (R + 1) <= MAX_KEPT)                               \
            return launch_chunks<CH, S, SPLIT>(x, delta, A, Bm, Cm, D, dy,    \
                                               prod_c, hloc_c, entry_s,       \
                                               exit_s, dx, ddt, da, db, dc,   \
                                               ddp, B, T, dI, block_d, span,  \
                                               stream);                       \
        return (int)cudaErrorInvalidValue;                                    \
    }
    SCAN_BWD_CHUNK(8)
    SCAN_BWD_CHUNK(16)
    SCAN_BWD_CHUNK(32)
    SCAN_BWD_CHUNK(64)
#undef SCAN_BWD_CHUNK
    return (int)cudaErrorInvalidValue;
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

bool bad_launch(int block_d, int chunk, int split, int span) {
    const int threads = block_d * split;
    return block_d <= 0 || chunk <= 0 || split <= 0 || span <= 0
        || threads % 32 || threads > MAX_THREADS;
}

}  // namespace

extern "C" {

// x, delta, dy: (B, T, dI); A: (dI, S); Bm, Cm: (B, T, S); prod_c, hloc_c:
// (B, N, dI, S) with N = ceil(T / chunk); prod_s, hloc_s, gloc_s: (B, NS,
// dI, S) with NS = ceil(N / span); all float32 and contiguous.
int mamba_scan_bwd_summaries(const void* x, const void* delta, const void* A,
                             const void* Bm, const void* Cm, const void* dy,
                             void* prod_c, void* hloc_c, void* prod_s,
                             void* hloc_s, void* gloc_s, int B, int T, int dI,
                             int S, int block_d, int chunk, int split,
                             int span, void* stream) {
    if (B <= 0 || T <= 0 || dI <= 0) return 0;
    if (bad_launch(block_d, chunk, split, span)) return (int)cudaErrorInvalidValue;
    SCAN_BWD_DISPATCH(launch_summaries, (const float*)x, (const float*)delta,
                      (const float*)A, (const float*)Bm, (const float*)Cm,
                      (const float*)dy, (float*)prod_c, (float*)hloc_c,
                      (float*)prod_s, (float*)hloc_s, (float*)gloc_s, B, T,
                      dI, block_d, chunk, span, (cudaStream_t)stream)
}

// h0, dhT, dh0: (B, dI, S); prod, hloc, gloc: (B, NS, dI, S), the spans'
// (hloc and gloc rewritten in place: the state entering, the adjoint
// leaving each span).
int mamba_scan_bwd_carry(const void* h0, const void* dhT, const void* prod,
                         void* hloc, void* gloc, void* dh0, int B, int dI,
                         int S, int NS, void* stream) {
    if (B <= 0 || dI <= 0 || NS <= 0) return 0;
    if (S <= 0) return (int)cudaErrorInvalidValue;
    const int64_t cells = (int64_t)B * dI * S;
    const dim3 grid((unsigned)((cells + CARRY_THREADS - 1) / CARRY_THREADS), 2);
    scan_bwd_carry_kernel<<<grid, CARRY_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)h0, (const float*)dhT, (const float*)prod, (float*)hloc,
        (float*)gloc, (float*)dh0, B, dI, S, NS);
    return (int)cudaGetLastError();
}

// As the forward's operands plus dy (B, T, dI), the chunks' P and h_loc
// and the spans' entry states and exit adjoints (from the carry).  Writes
// dx, ddt (B, T, dI); da (B, NS, dI, S), db, dc (ceil(dI / block_d), B, T,
// S) and dd (B, NS, dI) partials.  chunk in {8, 16, 32, 64} with chunk x
// (S / split + 1) <= 80; block_d x split a multiple of 32 up to 256.
int mamba_scan_bwd_chunks(const void* x, const void* delta, const void* A,
                          const void* Bm, const void* Cm, const void* D,
                          const void* dy, const void* prod_c,
                          const void* hloc_c, const void* entry_s,
                          const void* exit_s, void* dx, void* ddt, void* da,
                          void* db, void* dc, void* dd, int B, int T, int dI,
                          int S, int block_d, int chunk, int split, int span,
                          void* stream) {
    if (B <= 0 || T <= 0 || dI <= 0) return 0;
    if (bad_launch(block_d, chunk, split, span) || S % split
            || !kept_fits(chunk, S, split))
        return (int)cudaErrorInvalidValue;
    SCAN_BWD_DISPATCH(launch_chunks_at, chunk, (const float*)x,
                      (const float*)delta, (const float*)A, (const float*)Bm,
                      (const float*)Cm, (const float*)D, (const float*)dy,
                      (const float*)prod_c, (const float*)hloc_c,
                      (const float*)entry_s, (const float*)exit_s, (float*)dx,
                      (float*)ddt, (float*)da, (float*)db, (float*)dc,
                      (float*)dd, B, T, dI, block_d, span,
                      (cudaStream_t)stream)
}

const char* mamba_scan_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
