// RWKV-6 wkv recurrence (backward) for NVIDIA Hopper (sm_90a), float32, as
// a chunked form that is stable for every decay in [0, 1].
//
// Replaces the Pallas TPU kernel wkv6_bwd of
// src/repro/kernels/rwkv6_wkv/kernel.py (its two grid programs: the spans
// pre-pass _spans_kernel and the reverse sweep _wkv_bwd_kernel, which takes
// each span's adjoint from jax.vjp of _local_wkv).
//
// The forward, per (batch, head) with a (hd x hd) state S (key i x value j):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T
// and its adjoint G_t = dL/dS_t, from G_{T-1} = ds_T:
//     G_{t-1} = diag(w_t) G_t + r_t dy_t^T,       ds0 = G_{-1}
//     dr_t = S_{t-1} dy_t + u * k_t (v_t . dy_t)
//     dk_t = G_t v_t + u * r_t (v_t . dy_t)
//     dv_t = G_t^T k_t + (sum_i u_i r_ti k_ti) dy_t
//     dw_t = rowsum(G_t * S_{t-1}),               du = sum_t r_t * k_t (v_t . dy_t)
//
// Two programs, each deterministic and free of atomics:
//
//   * "scans": the state entering every chunk of `chunk` tokens and the
//     adjoint leaving it, (B, H, N, hd, hd) each, and ds0.  A block owns one
//     (b, head) in one direction (both run in one launch), a thread `cols`
//     value columns of one row of S or G in registers (the columns evolve
//     independently); each chunk is one product (an FMA a cell and token)
//     from tiles the block double-buffers in shared memory.
//   * "chunks": one block per (b, head, chunk), B * H * N of them, each
//     computing the chunk's dr, dk, dv, dw and its du partial from its
//     entry state S0 and exit adjoint G, all in float32 from shared tiles
//     (a chunk's r, k, v, w, dy; S0, G):
//       with A_t = prod_{s<t} w_s, B_t = prod_{s>t} w_s (in the chunk) and
//       c(s, t) = prod_{s<σ<t} w_σ, M[t][s] = dy_t . v_s,
//       dr_t = A_t (S0 dy_t) + sum_{s<t} c(s,t) k_s M[t][s] + bonus
//       dk_t = B_t (G v_t)   + sum_{s>t} c(t,s) r_s M[s][t] + bonus
//       dv_t = G^T (B_t k_t) + sum_{s>t} Q[t][s] dy_s     + bonus,
//              Q[t][s] = sum_i c(t,s)_i r_si k_ti
//       dw_t = A_t B_t rowsum(G * S0) + B_t P_t + A_t R_t + X_t, with the
//              decayed prefix scan P of k * (G v), the suffix scan R of
//              r * (S0 dy), and the in-chunk x in-chunk term
//              X_t = sum_{s>t} c(t,s) r_s Y_t[s],
//              Y_{t+1}[s] = w_t Y_t[s] + k_t M[s][t].
//     Every decay factor is a product of w's (<= 1): nothing is inverted
//     (no exp(-cumsum(log w)), no division by w), so w = 1e-30 or 0 gives
//     finite, exact-as-float32 gradients.  The products over hd are
//     register-tiled float32 FMAs fed by 16-byte shared loads (S0 dy,
//     G v, dy v^T; G^T (B k) with Q dy in one pass writing dv, by lanes
//     over columns); the pair sums keep their running coefficients in
//     registers, a warp per token t with the lanes over channels; Q's sums
//     over channels by a butterfly reduce-scatter; X by `parts` warps per
//     32 channels, each over every parts-th s (the same s in every lane),
//     their partials summed in shared memory.  du comes back as per-(b,
//     head, chunk) partials that the caller sums.
//
// What bounds it on the H100: bytes read and written once (r, k, v, w,
// dy, s0, ds_T in; dr, dk, dv, dw, du, ds0 out: 1.2 GB, 0.36 ms at the
// RWKV-6 training shape B 8, T 2048, H 32, hd 64) against the operations
// the chunked form does: per token and head ~3 hd^2 (the products with S0
// and G) + ~6 chunk * hd (the pairs) FMAs, plus 2 hd^2 of each scan, and
// the chunk states (2 x B x H x T/chunk x hd^2 floats) written and read
// once.  Numbers: PERF.md.
//
// The scan program lives in wkv_chunk_scan.cuh, shared with the forward
// (rwkv6_wkv.cu, whose chunked route runs its forward direction).
//
// Plain C interface: rwkv6_wkv_bwd_scans / rwkv6_wkv_bwd_chunks launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv_chunk_scan.cuh"

namespace {

using namespace wkv_chunk;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 512;

// Shared memory of the chunk program, in floats (must match the
// Python-side check): r, k, w, dy, B, B k, v, A, S0 dy, G v tiles (chunk x
// pitch; the last four hold dw's partials at the end), S0 and G (hd x
// pitch; dw's two scanned terms take S0's place once S0 is read, or two
// tiles of their own when 2 chunk > hd), M and Q (chunk x (chunk + 4)), u,
// rowsum(G * S0) and the per-token bonus sums.
__host__ __device__ inline int64_t chunks_smem_floats(int chunk, int hd) {
    return 10LL * chunk * pitch(hd) + 2LL * hd * pitch(hd)
         + (2 * chunk > hd ? 2LL * chunk * pitch(hd) : 0)
         + 2LL * chunk * (chunk + 4) + 2LL * hd + chunk;
}

// ---------------------------------------------------------------------------
// program "chunks": shared-memory products

// The warp tasks of one product go to warps first, first + 1, ... (mod
// the block's warps), so consecutive products share the warps out evenly.
__device__ __forceinline__ int first_task(int first, int warp, int nwarps) {
    return ((warp - first) % nwarps + nwarps) % nwarps;
}

// out[a][b] = sum_x P[a][x] Q[b][x] for a < na, b < nb (x < nx, a multiple
// of 4): a warp task is TM rows a (P's rows broadcast) by 32 * TN columns b
// (a lane's: b = lane + 32 q), both read as float4.  Returns its task count.
template <int TM, int TN>
__device__ __forceinline__ int rowdot(float* out, int po, const float* P, int pp,
                                      const float* Q, int pq, int na, int nb,
                                      int nx, int first, int warp, int nwarps,
                                      int lane) {
    const int nab = (na + TM - 1) / TM, nbb = (nb + 32 * TN - 1) / (32 * TN);
    for (int task = first_task(first, warp, nwarps); task < nab * nbb;
         task += nwarps) {
        const int a0 = (task / nbb) * TM, b0 = (task % nbb) * 32 * TN;
        float acc[TM][TN];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;
        const float* pr[TM];
        const float* qr[TN];
#pragma unroll
        for (int m = 0; m < TM; ++m) pr[m] = P + min(a0 + m, na - 1) * pp;
#pragma unroll
        for (int q = 0; q < TN; ++q) qr[q] = Q + min(b0 + lane + 32 * q, nb - 1) * pq;
        for (int x = 0; x < nx; x += 4) {
            float4 pv[TM], qv[TN];
#pragma unroll
            for (int m = 0; m < TM; ++m) pv[m] = *reinterpret_cast<const float4*>(pr[m] + x);
#pragma unroll
            for (int q = 0; q < TN; ++q) qv[q] = *reinterpret_cast<const float4*>(qr[q] + x);
#pragma unroll
            for (int m = 0; m < TM; ++m)
#pragma unroll
                for (int q = 0; q < TN; ++q) {
                    acc[m][q] = fmaf(pv[m].x, qv[q].x, acc[m][q]);
                    acc[m][q] = fmaf(pv[m].y, qv[q].y, acc[m][q]);
                    acc[m][q] = fmaf(pv[m].z, qv[q].z, acc[m][q]);
                    acc[m][q] = fmaf(pv[m].w, qv[q].w, acc[m][q]);
                }
        }
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < TN; ++q) {
                const int a = a0 + m, bb = b0 + lane + 32 * q;
                if (a < na && bb < nb) out[a * po + bb] = acc[m][q];
            }
    }
    return nab * nbb;
}

// dv_t = G^T (B_t k_t) + sum_s Q[t][s] dy_s + bonus_t dy_t for t < nv, in
// one pass: out[t][j] = sum_i (P1[t][i] P2[t][i]) G[i][j] + sum_s Q[t][s]
// D[s][j] (P2 null: P1 alone; Q[t][s] = 0 for s <= t), a warp task TM rows
// t (broadcast as float4) by 32 * TN columns j (a lane's: j = lane + 32 q,
// rows of G and D by lanes), written to device memory.
template <int TM, int TN>
__device__ __forceinline__ void dv_pass(float* __restrict__ out, int64_t base,
                                         int64_t row, int nv, const float* P1,
                                         const float* P2, const float* Gs,
                                         const float* Qm, const float* Ds,
                                         const float* bonus, int C, int HD,
                                         int P, int CP, int warp, int nwarps,
                                         int lane) {
    const int nab = (C + TM - 1) / TM, nbb = (HD + 32 * TN - 1) / (32 * TN);
    for (int task = warp; task < nab * nbb; task += nwarps) {
        const int a0 = (task / nbb) * TM, b0 = (task % nbb) * 32 * TN;
        float acc[TM][TN];
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < TN; ++q) acc[m][q] = 0.f;
        int col[TN];
#pragma unroll
        for (int q = 0; q < TN; ++q) col[q] = min(b0 + lane + 32 * q, HD - 1);
        auto segment = [&](const float* A1, const float* A2, int pp,
                           const float* Qr, int nx) {
            for (int x = 0; x < nx; x += 4) {
                float4 pv[TM];
#pragma unroll
                for (int m = 0; m < TM; ++m) {
                    const int a = min(a0 + m, C - 1);
                    const float4 p1 = *reinterpret_cast<const float4*>(A1 + a * pp + x);
                    if (A2) {
                        const float4 p2 = *reinterpret_cast<const float4*>(A2 + a * pp + x);
                        pv[m] = make_float4(p1.x * p2.x, p1.y * p2.y, p1.z * p2.z,
                                            p1.w * p2.w);
                    } else {
                        pv[m] = p1;
                    }
                }
#pragma unroll
                for (int xx = 0; xx < 4; ++xx) {
#pragma unroll
                    for (int q = 0; q < TN; ++q) {
                        const float qv = Qr[(x + xx) * P + col[q]];
#pragma unroll
                        for (int m = 0; m < TM; ++m) {
                            const float pe = xx == 0 ? pv[m].x : xx == 1 ? pv[m].y
                                           : xx == 2 ? pv[m].z : pv[m].w;
                            acc[m][q] = fmaf(pe, qv, acc[m][q]);
                        }
                    }
                }
            }
        };
        segment(P1, P2, P, Gs, HD);
        segment(Qm, nullptr, CP, Ds, C);
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
            for (int q = 0; q < TN; ++q) {
                const int t = a0 + m, j = b0 + lane + 32 * q;
                if (t < nv && j < HD)
                    out[base + t * row + j] = fmaf(bonus[t], Ds[t * P + j], acc[m][q]);
            }
    }
}

// Butterfly reduce-scatter: N values over the lanes differing in bits
// O .. STOP; returns the index of v[0] among the N (rs_left of them stay,
// lanes with a bit of rs_dup set hold duplicates).
template <int N, int O, int STOP>
__device__ __forceinline__ int reduce_scatter(float* v, int lane) {
    if constexpr (O < STOP) {
        return 0;
    } else if constexpr (N > 1 && N % 2 == 0) {
        constexpr int HALF = N / 2;
        const bool up = lane & O;
#pragma unroll
        for (int i = 0; i < HALF; ++i) {
            const float send = up ? v[i] : v[i + HALF];
            const float keep = up ? v[i + HALF] : v[i];
            v[i] = keep + __shfl_xor_sync(FULL, send, O);
        }
        return (up ? HALF : 0) + reduce_scatter<HALF, O / 2, STOP>(v, lane);
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

// Two blocks an SM at up to 16 warps each (64 registers a thread) for the
// chunks whose shared memory lets two in; one otherwise.
template <int C, int HD>
__global__ void __launch_bounds__(MAX_THREADS, C <= 16 ? 2 : 1)
wkv_bwd_chunks_kernel(const float* __restrict__ r, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ w,
                      const float* __restrict__ u, const float* __restrict__ dy,
                      const float* __restrict__ states,
                      const float* __restrict__ adj, float* __restrict__ dr,
                      float* __restrict__ dk, float* __restrict__ dv,
                      float* __restrict__ dw, float* __restrict__ du_part,
                      int T, int H, int N, int parts) {
    constexpr int P = pitch(HD);
    constexpr int NQ = (HD + 31) / 32;    // channels a lane holds
    constexpr int CP = C + 4;             // pitch of M and Q
    extern __shared__ __align__(16) float smem[];
    float* Rs = smem;
    float* Ks = Rs + C * P;
    float* Ws = Ks + C * P;
    float* Ds = Ws + C * P;               // dy
    float* Bs = Ds + C * P;               // prod_{s>t} w_s
    float* BK = Bs + C * P;               // B_t * k_t
    float* Vs = BK + C * P;               // v, then with As, X1, X2 the
    float* As = Vs + C * P;               // prod_{s<t} w_s    partials of
    float* X1 = As + C * P;               // S0 dy_t           dw's term X
    float* X2 = X1 + C * P;               // G v_t             (phase 4)
    float* XP = Vs;                       // (parts, C, HD), parts <= 4
    float* S0 = X2 + C * P;               // (HD, P)
    float* Gs = S0 + HD * P;              // (HD, P)
    float* Ms = Gs + HD * P;              // M[t][s] = dy_t . v_s
    float* Qm = Ms + C * CP;              // Q[t][s]
    float* us = Qm + C * CP;
    float* zs = us + HD;                  // rowsum(G * S0)
    float* ruk = zs + HD;                 // sum_i u_i r_ti k_ti
    // dw's terms from S0 and G: A B rowsum(G * S0) + B P + A R (phase 3)
    float* DW = 2 * C <= HD ? S0 : ruk + C;  // its prefix and suffix parts
    float* DWS = DW + C * P;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const int n = blockIdx.x % N;
    const int bh = blockIdx.x / N, b = bh / H, h = bh % H;
    const int t0 = n * C;
    const int nv = min(C, T - t0);
    const int64_t row = (int64_t)H * HD;
    const int64_t base = ((int64_t)b * T + t0) * row + (int64_t)h * HD;
    const int64_t hh = (int64_t)HD * HD;

    // -- stage: the chunk's operands (tokens past T: r = k = v = dy = 0,
    // w = 1, which change nothing), S0, G, u; every copy in flight at once
    for (int e = tid; e < C * HD / 4; e += blockDim.x) {
        const int tk = e / (HD / 4), c = (e - tk * (HD / 4)) * 4;
        const bool in = tk < nv;
        const int64_t g = base + (in ? tk : 0) * row + c;
        cp_async16(Rs + tk * P + c, r + g, in);
        cp_async16(Ks + tk * P + c, k + g, in);
        cp_async16(Vs + tk * P + c, v + g, in);
        cp_async16(Ds + tk * P + c, dy + g, in);
        cp_async16(Ws + tk * P + c, w + g, in);
    }
    const float* s0g = states + ((int64_t)bh * N + n) * hh;
    const float* gg = adj + ((int64_t)bh * N + n) * hh;
    for (int e = tid; e < HD * HD / 4; e += blockDim.x) {
        const int i = e / (HD / 4), c = (e - i * (HD / 4)) * 4;
        cp_async16(S0 + i * P + c, s0g + (int64_t)i * HD + c, true);
        cp_async16(Gs + i * P + c, gg + (int64_t)i * HD + c, true);
    }
    cp_async_commit();
    for (int e = tid; e < HD; e += blockDim.x) us[e] = u[(int64_t)h * HD + e];
    cp_async_wait<0>();
    __syncthreads();
    if (nv < C) {                         // the ragged end's decays: 1
        for (int e = nv * HD + tid; e < C * HD; e += blockDim.x)
            Ws[(e / HD) * P + e % HD] = 1.f;
        __syncthreads();
    }

    // -- the decay products, M, S0 dy, G v, rowsum(G * S0), the bonus sums
    // per-channel items, from the block's last threads down: the decay
    // products A (prefix) and B, B k (suffix), and rowsum(G * S0)
    for (int e = blockDim.x - 1 - tid; e < 3 * HD; e += blockDim.x) {
        const int i = e % HD;
        float p = 1.f;
        if (e < HD) {
            for (int t = 0; t < C; ++t) { As[t * P + i] = p; p *= Ws[t * P + i]; }
        } else if (e < 2 * HD) {
            for (int t = C - 1; t >= 0; --t) {
                Bs[t * P + i] = p;
                BK[t * P + i] = p * Ks[t * P + i];
                p *= Ws[t * P + i];
            }
        } else {
            p = 0.f;
            for (int j = 0; j < HD; j += 4) {
                const float4 g = *reinterpret_cast<const float4*>(Gs + i * P + j);
                const float4 s0 = *reinterpret_cast<const float4*>(S0 + i * P + j);
                p = fmaf(g.x, s0.x, p); p = fmaf(g.y, s0.y, p);
                p = fmaf(g.z, s0.z, p); p = fmaf(g.w, s0.w, p);
            }
            zs[i] = p;
        }
    }
    int first = rowdot<2, (C + 31) / 32>(Ms, CP, Ds, P, Vs, P, C, C, HD, 0, warp,
                                         nwarps, lane);
    first += rowdot<2, NQ>(X1, P, Ds, P, S0, P, C, HD, HD, first, warp, nwarps, lane);
    rowdot<2, NQ>(X2, P, Vs, P, Gs, P, C, HD, HD, first, warp, nwarps, lane);
    for (int t = warp; t < C; t += nwarps) {
        float a = 0.f;
        for (int i = lane; i < HD; i += 32) a = fmaf(us[i] * Rs[t * P + i], Ks[t * P + i], a);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
        if (lane == 0) ruk[t] = a;
    }
    __syncthreads();

    // -- dr; dk and Q; dw's scanned terms; du
    int ch[NQ];
    bool live[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
        live[q] = lane + 32 * q < HD;
        ch[q] = min(lane + 32 * q, HD - 1);
    }
    // a warp's tokens t: rounds of the block's warps, every other round
    // reversed, so the pair sums' lengths (t or C - 1 - t) even out
    auto token = [&](int j) {
        const int round = j / nwarps, w_ = j - round * nwarps;
        return (round & 1) ? round * nwarps + (nwarps - 1 - w_) : j;
    };
    for (int j = warp; j < C; j += nwarps) {         // dr_t
        const int t = token(j);
        float coef[NQ], acc[NQ];
#pragma unroll
        for (int q = 0; q < NQ; ++q) { coef[q] = 1.f; acc[q] = 0.f; }
        for (int s = t - 1; s >= 0; --s) {
            const float m = Ms[t * CP + s];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                acc[q] = fmaf(coef[q] * Ks[s * P + ch[q]], m, acc[q]);
                coef[q] *= Ws[s * P + ch[q]];
            }
        }
        if (t < nv) {
            const float vd = Ms[t * CP + t];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int i = ch[q];
                if (live[q])
                    dr[base + t * row + i] = fmaf(As[t * P + i], X1[t * P + i],
                                                  fmaf(us[i] * Ks[t * P + i], vd, acc[q]));
            }
        }
    }
    for (int j = warp; j < C; j += nwarps) {         // dk_t and Q[t][.]
        const int t = token(j);
        float coef[NQ], acc[NQ], kt[NQ], qv[C];
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            coef[q] = 1.f;
            acc[q] = 0.f;
            kt[q] = live[q] ? Ks[t * P + ch[q]] : 0.f;
        }
#pragma unroll
        for (int s = 0; s < C; ++s) {
            qv[s] = 0.f;
            if (s > t) {
                const float m = Ms[s * CP + t];
#pragma unroll
                for (int q = 0; q < NQ; ++q) {
                    const float a = coef[q] * Rs[s * P + ch[q]];
                    acc[q] = fmaf(a, m, acc[q]);
                    qv[s] = fmaf(a, kt[q], qv[s]);
                    coef[q] *= Ws[s * P + ch[q]];
                }
            }
        }
        constexpr int NL = rs_left<C, 16, 1>();
        constexpr int DUP = rs_dup<C, 16, 1>();
        const int first = reduce_scatter<C, 16, 1>(qv, lane);
        if ((lane & DUP) == 0) {
#pragma unroll
            for (int q = 0; q < NL; ++q) Qm[t * CP + first + q] = qv[q];
        }
        if (t < nv) {
            const float vd = Ms[t * CP + t];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                const int i = ch[q];
                if (live[q])
                    dk[base + t * row + i] = fmaf(Bs[t * P + i], X2[t * P + i],
                                                  fmaf(us[i] * Rs[t * P + i], vd, acc[q]));
            }
        }
    }
    // per-channel items, from the block's last threads down: dw's scanned
    // terms, A B rowsum(G * S0) + B P (prefix) and A R (suffix), and du
    for (int e = blockDim.x - 1 - tid; e < 3 * HD; e += blockDim.x) {
        const int i = e % HD;
        float p = 0.f;
        if (e < HD) {
            const float z = zs[i];
            for (int t = 0; t < C; ++t) {
                const float bt = Bs[t * P + i];
                DW[t * P + i] = fmaf(As[t * P + i] * bt, z, bt * p);
                p = fmaf(Ws[t * P + i], p, Ks[t * P + i] * X2[t * P + i]);
            }
        } else if (e < 2 * HD) {
            for (int t = C - 1; t >= 0; --t) {
                DWS[t * P + i] = As[t * P + i] * p;
                p = fmaf(Ws[t * P + i], p, Rs[t * P + i] * X1[t * P + i]);
            }
        } else {
            for (int t = 0; t < C; ++t)
                p = fmaf(Rs[t * P + i] * Ks[t * P + i], Ms[t * CP + t], p);
            du_part[((int64_t)bh * N + n) * HD + i] = p;
        }
    }
    __syncthreads();

    // -- dv_t = G^T (B_t k_t) + sum_{s>t} Q[t][s] dy_s + bonus
    dv_pass<2, NQ>(dv, base, row, nv, BK, nullptr, Gs, Qm, Ds, ruk, C, HD, P, CP,
                   warp, nwarps, lane);
    // dw's in-chunk x in-chunk term X, a warp task (32 channels, part): the
    // lanes over channels, s = 1 + part, 1 + part + parts, ... the same in
    // every lane; the parts' partials go to tiles that are free by now
    {
        const int groups = (HD + 31) / 32;
        for (int task = warp; task < groups * parts; task += nwarps) {
            const int part = task / groups;
            const int iw = (task - part * groups) * 32 + lane;
            const int i = min(iw, HD - 1);
            float x[C];
#pragma unroll
            for (int t = 0; t < C; ++t) x[t] = 0.f;
            for (int s_ = 1 + part; s_ < C; s_ += parts) {
                float ys[C];
                float y = 0.f;
#pragma unroll
                for (int t = 0; t < C; ++t) {
                    if (t < s_) {
                        ys[t] = y;
                        y = fmaf(Ws[t * P + i], y, Ks[t * P + i] * Ms[s_ * CP + t]);
                    }
                }
                float c = Rs[s_ * P + i];
#pragma unroll
                for (int t = C - 1; t >= 0; --t) {
                    if (t < s_) {
                        x[t] = fmaf(c, ys[t], x[t]);
                        c *= Ws[t * P + i];
                    }
                }
            }
            if (iw < HD) {
                float* xp = XP + part * C * HD;
#pragma unroll
                for (int t = 0; t < C; ++t) xp[t * HD + iw] = x[t];
            }
        }
    }
    __syncthreads();
    for (int e = tid; e < nv * HD; e += blockDim.x) {
        const int t = e / HD, i = e - t * HD;
        float a = DW[t * P + i] + DWS[t * P + i];
        for (int q = 0; q < parts; ++q) a += XP[(q * C + t) * HD + i];
        dw[base + t * row + i] = a;
    }
}

// ---------------------------------------------------------------------------
// launches

template <int C, int HD>
int launch_chunks(const float* r, const float* k, const float* v,
                  const float* w, const float* u, const float* dy,
                  const float* states, const float* adj, float* dr, float* dk,
                  float* dv, float* dw, float* du, int B, int T, int H,
                  int threads, int parts, cudaStream_t stream) {
    const size_t smem = (size_t)chunks_smem_floats(C, HD) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        wkv_bwd_chunks_kernel<C, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int N = (T + C - 1) / C;
    const int64_t blocks = (int64_t)B * H * N;
    wkv_bwd_chunks_kernel<C, HD><<<(unsigned)blocks, threads, smem, stream>>>(
        r, k, v, w, u, dy, states, adj, dr, dk, dv, dw, du, T, H, N, parts);
    return (int)cudaGetLastError();
}

template <int HD>
int dispatch_chunks(int chunk, const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* dy,
                    const float* states, const float* adj, float* dr,
                    float* dk, float* dv, float* dw, float* du, int B, int T,
                    int H, int threads, int parts, cudaStream_t stream) {
    switch (chunk) {
        case 8: return launch_chunks<8, HD>(r, k, v, w, u, dy, states, adj, dr, dk, dv, dw, du, B, T, H, threads, parts, stream);
        case 16: return launch_chunks<16, HD>(r, k, v, w, u, dy, states, adj, dr, dk, dv, dw, du, B, T, H, threads, parts, stream);
        case 32: return launch_chunks<32, HD>(r, k, v, w, u, dy, states, adj, dr, dk, dv, dw, du, B, T, H, threads, parts, stream);
        case 64: return launch_chunks<64, HD>(r, k, v, w, u, dy, states, adj, dr, dk, dv, dw, du, B, T, H, threads, parts, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

bool bad_args(int hd, int chunk, int threads, int cols, int parts) {
    return chunk <= 0 || threads < 32 || threads > MAX_THREADS || threads % 32
        || cols <= 0 || hd % cols || cols % 4 || parts < 1 || parts > 4;
}

}  // namespace

extern "C" {

// r, k, v, w, dy: (B, T, H, hd); s0, ds_T, ds0: (B, H, hd, hd); states and
// adj: (B, H, ceil(T / chunk), hd, hd); all float32, contiguous, 16-byte
// aligned.  hd in {16, 32, 48, 64}; cols in {4, 8, 16, 32} dividing hd.
int rwkv6_wkv_bwd_scans(const void* r, const void* k, const void* v,
                        const void* w, const void* dy, const void* s0,
                        const void* dsT, void* states, void* adj, void* ds0,
                        int B, int T, int H, int hd, int chunk, int threads,
                        int cols, int parts, void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    if (bad_args(hd, chunk, threads, cols, parts)) return (int)cudaErrorInvalidValue;
    const auto f = [](const void* p) { return (const float*)p; };
    cudaStream_t s = (cudaStream_t)stream;
    // both directions (S and G) in one launch
    return chunk_scan(hd, cols, f(r), f(k), f(v), f(w), f(dy), f(s0), f(dsT),
                      (float*)states, (float*)adj, (float*)ds0, nullptr, B, T,
                      H, chunk, 2, s);
}

// As the scans' operands plus u (H, hd); writes dr, dk, dv, dw (B, T, H, hd)
// and du partials (B, H, ceil(T / chunk), hd).  chunk in {8, 16, 32, 64};
// threads a multiple of 32 up to 512; parts in [1, 4].
int rwkv6_wkv_bwd_chunks(const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* dy,
                         const void* states, const void* adj, void* dr,
                         void* dk, void* dv, void* dw, void* du, int B, int T,
                         int H, int hd, int chunk, int threads, int cols,
                         int parts, void* stream) {
    if (B <= 0 || T <= 0 || H <= 0) return 0;
    if (bad_args(hd, chunk, threads, cols, parts)) return (int)cudaErrorInvalidValue;
    const auto f = [](const void* p) { return (const float*)p; };
    const auto o = [](void* p) { return (float*)p; };
    cudaStream_t s = (cudaStream_t)stream;
    switch (hd) {
        case 16: return dispatch_chunks<16>(chunk, f(r), f(k), f(v), f(w), f(u), f(dy), f(states), f(adj), o(dr), o(dk), o(dv), o(dw), o(du), B, T, H, threads, parts, s);
        case 32: return dispatch_chunks<32>(chunk, f(r), f(k), f(v), f(w), f(u), f(dy), f(states), f(adj), o(dr), o(dk), o(dv), o(dw), o(du), B, T, H, threads, parts, s);
        case 48: return dispatch_chunks<48>(chunk, f(r), f(k), f(v), f(w), f(u), f(dy), f(states), f(adj), o(dr), o(dk), o(dv), o(dw), o(du), B, T, H, threads, parts, s);
        case 64: return dispatch_chunks<64>(chunk, f(r), f(k), f(v), f(w), f(u), f(dy), f(states), f(adj), o(dr), o(dk), o(dv), o(dw), o(du), B, T, H, threads, parts, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

long long rwkv6_wkv_bwd_smem_bytes(int chunk, int hd) {
    return (long long)chunks_smem_floats(chunk, hd) * (long long)sizeof(float);
}

const char* rwkv6_wkv_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
