// Split-KV grouped-query decode attention for NVIDIA Hopper (sm_90a),
// float32 or bfloat16 cache, the split combine fused in: one launch a call.
//
// Replaces the Pallas TPU kernel decode_attention_kernel (_kernel) of
// src/repro/kernels/decode_attention/kernel.py and the combine after its
// pallas_call (kernel.py lines 118-123, plain JAX there).
//
// What it computes: one query token per (batch, head) against a
// fixed-capacity cache k/v (B, S, KV, hd).  The rep = H / KV query heads that
// share a kv head form one group; the cache is cut into `splits` segments of
// ceil(S / splits) positions, and each (batch, kv head, segment) forms the
// unnormalised online-softmax partial
//     m = max_j s_j,  l = sum_j exp(s_j - m),  acc = sum_j exp(s_j - m) v_j,
//     s_j = (q * hd^-0.5) . k_j  over positions j < length in the segment.
// A segment that starts at or beyond `length` reads nothing and holds
// m = -1e30, l = 0, acc = 0, so its combine weight exp(m - m_tot) is exactly
// 0.  The partials are merged by one logsumexp rescale into the normalised
// float32 output (B, KV, rep, hd), and, when asked for, the logsumexp of the
// scores itself (B, KV, rep), which a caller holding the cache in stripes
// (the sequence-sharded decode) combines across stripes.
//
// The combine runs inside the launch: the `splits` blocks of one (batch, kv
// head) form a thread block cluster (cluster dims = splits; 16 takes the
// non-portable cluster size).  Each block leaves its partial in its own
// shared memory; after a cluster barrier block c reads every block's
// (m, l, acc) through distributed shared memory, in split order 0, 1, ...,
// and writes its 1/splits share of the output elements; a second barrier
// keeps every block's shared memory alive until the others have read it.
// No workspace, no counter, no atomics: two runs give the same bits.
//
// What bounds it on the H100: bytes.  Decode reads every cached k and v
// row up to `length` once and does 4 * rep * hd flops per row: at the serving
// shape (B 8, KV 2, rep 8, hd 128, length 2176, bf16) one call reads 17.8 MB,
// 5.3 us at 3.35 TB/s, against 0.3 GFLOP.  Two builds:
//
//   * bfloat16 (the serving path): each warp streams its own key tiles
//     (tiles w, w + W, ... of its block's segment, `block_s` keys each)
//     through its own ring of `stages` shared slots filled by 16-byte
//     cp.async copies, so a warp never waits on another and a block has
//     W * stages tiles of k and v in flight.  s = q k^T runs on mma.sync
//     m16n8k16 (the group's rep query rows, padded to 16, are the A
//     fragments, loaded once; k's B fragments by ldmatrix): bf16 x bf16
//     products are exact in the float32 accumulator.  The online softmax
//     stays in registers (quad shuffles, log2 units; the mask only in the
//     tile that holds the segment's end).  acc += p v runs on mma.sync too,
//     with p split into hi = bf16(p) and lo = bf16(p - hi), two products into
//     one float32 accumulator, so p carries ~2^-16 of relative error instead
//     of bf16's 2^-9 (the float32 output's gate is 2e-4); v's B fragments by
//     ldmatrix.trans from the row-major tile.  At the end the warps' partials
//     are merged in shared memory (the ring's space), then across the
//     cluster.
//   * float32 (the parity path): CUDA-core arithmetic, one block-wide tile
//     of `block_s` positions at a time: scores by warp reductions into
//     shared memory, one online-softmax update per head, the accumulators in
//     registers (per warp) summed in shared memory at the end; the same
//     cluster combine.
//
// Plain C interface: decode_attention_{f32,bf16} launch on the given stream,
// do not synchronise, allocate nothing, and return cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_REP = 16;
constexpr int MAX_SPLITS = 16;
constexpr int F32_MAX_THREADS = 512;
constexpr int BF16_MAX_THREADS = 256;
constexpr int MAX_STAGES = 4;

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

// The cluster's combine.  Every block of the cluster holds its partial at
// the same shared-memory offsets: pm[rep] (in base-2 units when LOG2, else
// natural), pl[rep] and pacc[rep * HD].  Block c of the cluster writes
// output elements [c * per, (c + 1) * per) of the group's (rep, HD) float32
// output, reading the splits' partials in split order.  With `lse` (else
// null) the cluster's leader, block 0, also writes the group's rep
// natural-log normalisers ln(sum_j exp(s_j)) = m_tot + ln(l_tot), merged in
// the same split order (log2 units: (m_tot + log2(l_tot)) * ln 2).
template <int HD, bool LOG2>
__device__ __forceinline__ void cluster_combine(const float* pm, const float* pl,
                                                const float* pacc,
                                                float* __restrict__ out,
                                                float* __restrict__ lse,
                                                int rep, int splits) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();                      // every block's partial is in place
    const int rank = (int)cluster.block_rank();
    if (lse != nullptr && rank == 0) {
        for (int r = (int)threadIdx.x; r < rep; r += blockDim.x) {
            float mt = NEG_INF;
            for (int c = 0; c < splits; ++c)
                mt = fmaxf(mt, cluster.map_shared_rank(pm, c)[r]);
            float lt = 0.f;
            for (int c = 0; c < splits; ++c) {
                const float mc = cluster.map_shared_rank(pm, c)[r];
                const float wgt = LOG2 ? exp2f(mc - mt) : expf(mc - mt);
                lt = fmaf(cluster.map_shared_rank(pl, c)[r], wgt, lt);
            }
            lse[r] = LOG2 ? (mt + log2f(lt)) * 0.69314718055994531f
                          : mt + logf(lt);
        }
    }
    const int n = rep * HD;
    const int per = (n + splits - 1) / splits;
    const int e1 = min(n, (rank + 1) * per);
    for (int e = rank * per + (int)threadIdx.x; e < e1; e += blockDim.x) {
        const int r = e / HD;
        float mt = NEG_INF;
        for (int c = 0; c < splits; ++c)
            mt = fmaxf(mt, cluster.map_shared_rank(pm, c)[r]);
        float lt = 0.f, at = 0.f;
        for (int c = 0; c < splits; ++c) {
            const float mc = cluster.map_shared_rank(pm, c)[r];
            const float wgt = LOG2 ? exp2f(mc - mt) : expf(mc - mt);
            lt = fmaf(cluster.map_shared_rank(pl, c)[r], wgt, lt);
            at = fmaf(cluster.map_shared_rank(pacc, c)[e], wgt, at);
        }
        out[e] = at / fmaxf(lt, 1e-30f);
    }
    cluster.sync();                      // no block leaves while read
}

// ---------------------------------------------------------------------------
// float32 build (the parity path)

// Shared memory, in floats (must match the Python-side check).
__host__ __device__ inline int64_t f32_smem_floats(int rep, int hd, int block_s,
                                                   int threads) {
    return (int64_t)rep * hd              // qs: scaled queries
         + (int64_t)rep * block_s         // sc: scores, then probabilities
         + 3LL * rep                      // m, l, alpha
         + (int64_t)(threads / 32) * rep * hd;   // per-warp accumulators
}

template <int HD>
__global__ void __launch_bounds__(F32_MAX_THREADS)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  float* __restrict__ lse,
                  int s_len, int kv, int rep, int length, int seg, int splits,
                  int block_s, float scale) {
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
    const int end = min(length, s_len);
    const int lo = sp * seg;
    const int hi = min(lo + seg, end);

    const float* qg = q + (int64_t)bg * rep * HD;
    for (int e = tid; e < rep * HD; e += blockDim.x) qs[e] = qg[e] * scale;
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
    const float* kg = k + ((int64_t)b * s_len * kv + g) * HD + lane * V;
    const float* vg = v + ((int64_t)b * s_len * kv + g) * HD + lane * V;

    // a segment wholly at/after `length` runs no tile: m = -1e30, l = 0,
    // acc = 0 (it still joins the cluster's combine)
    for (int t0 = lo; t0 < hi; t0 += block_s) {
        const int n = min(block_s, hi - t0);
        // scores of this tile: one warp per position, lanes over hd
        for (int j = warp; j < n; j += nwarps) {
            float kr[V];
            const float* kp = kg + (int64_t)(t0 + j) * row_stride;
#pragma unroll
            for (int e = 0; e < V; ++e) kr[e] = kp[e];
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
            const float* vp = vg + (int64_t)(t0 + j) * row_stride;
#pragma unroll
            for (int e = 0; e < V; ++e) vr[e] = vp[e];
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

    // the warps' accumulators, summed in place into warp 0's slot: the
    // block's partial (m_s, l_s, red[0, rep * HD))
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
        red[e] = s;
    }
    cluster_combine<HD, false>(m_s, l_s, red, out + (int64_t)bg * rep * HD,
                               lse ? lse + (int64_t)bg * rep : nullptr, rep,
                               splits);
}

// ---------------------------------------------------------------------------
// bfloat16 build (the serving path)

// Shared memory, in bytes (must match the Python-side check): the warps'
// rings, reused after the main loop for the warps' partials; then the
// block's m and l.
__host__ __device__ inline int64_t bf16_ring_bytes(int hd, int block_s,
                                                   int warps, int stages) {
    return (int64_t)warps * stages * 2 * block_s * (hd + 8) * 2;
}

__host__ __device__ inline int64_t bf16_part_bytes(int hd, int warps) {
    return (int64_t)warps * (16 * hd + 32) * 4;
}

__host__ __device__ inline int64_t bf16_smem_bytes(int hd, int block_s,
                                                   int warps, int stages) {
    const int64_t ring = bf16_ring_bytes(hd, block_s, warps, stages);
    const int64_t part = bf16_part_bytes(hd, warps);
    return (ring > part ? ring : part) + 2 * 16 * 4;
}

// Copy rows [t0, t0 + rows) of a (S, HD) slice into a shared tile of pitch
// HD + 8 with 16-byte cp.async copies by one warp; rows at or past `end`
// are zero.
template <int HD>
__device__ __forceinline__ void warp_stage_rows(flash::bf16* dst,
                                                const flash::bf16* src,
                                                int64_t stride, int t0,
                                                int rows, int end, int lane) {
    constexpr int CH = HD / 8;            // 16-byte chunks a row
    for (int c = lane; c < rows * CH; c += 32) {
        const int j = c / CH, d = (c - j * CH) * 8;
        const int t = t0 + j;
        const bool in = t < end;
        flash::cp_async16(dst + j * (HD + 8) + d,
                          src + (int64_t)(in ? t : 0) * stride + d, in);
    }
}

template <int HD, int TK>
__global__ void __launch_bounds__(BF16_MAX_THREADS)
decode_bf16_kernel(const flash::bf16* __restrict__ q,
                   const flash::bf16* __restrict__ k,
                   const flash::bf16* __restrict__ v, float* __restrict__ out,
                   float* __restrict__ lse, int s_len, int kv, int rep, int length, int seg, int splits,
                   int stages, float scale) {
    using namespace flash;
    constexpr int KT = HD / 16;           // k16 steps over hd
    constexpr int DT = HD / 8;            // n8 tiles over hd
    constexpr int LD = HD + 8;            // pitch of a shared row
    constexpr int NS = TK / 8;            // n8 tiles of scores a tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int nwarps = blockDim.x / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;

    const int sp = blockIdx.x % splits;
    const int bg = blockIdx.x / splits;   // b * kv + g
    const int b = bg / kv, grp = bg % kv;
    const int end = min(length, s_len);
    const int lo = sp * seg;
    const int hi = max(lo, min(lo + seg, end));
    const int n_tiles = (hi - lo + TK - 1) / TK;
    // this warp's tiles: w, w + W, w + 2W, ...
    const int mine = n_tiles > warp ? (n_tiles - warp + nwarps - 1) / nwarps : 0;

    const int64_t stride = (int64_t)kv * HD;         // one cache position
    const bf16* kg = k + ((int64_t)b * s_len * kv + grp) * HD;
    const bf16* vg = v + ((int64_t)b * s_len * kv + grp) * HD;
    const int tile = TK * LD;
    bf16* ring = reinterpret_cast<bf16*>(smem_raw) + (size_t)warp * stages * 2 * tile;
    auto load = [&](int j, int slot) {
        const int t0 = lo + (warp + j * nwarps) * TK;
        bf16* ks = ring + (size_t)slot * 2 * tile;
        warp_stage_rows<HD>(ks, kg, stride, t0, TK, hi, lane);
        warp_stage_rows<HD>(ks + tile, vg, stride, t0, TK, hi, lane);
    };
    for (int s = 0; s + 1 < stages; ++s) {
        if (s < mine) load(s, s);
        cp_async_commit();
    }

    // the group's query rows (rows >= rep are zero) as A fragments, once
    uint32_t qa[KT][4];
    load_a_rows<HD>(qa, q + (int64_t)bg * rep * HD, HD, 0, rep, lane);

    float acc[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // running max (log2 units) and this thread's share of the row sums, for
    // rows g and g + 8
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    const float sl2 = scale * LOG2E;
    const int b_off = nt_offset(lane, LD), t_off = kn_offset(lane, LD);

    for (int j = 0; j < mine; ++j) {
        if (stages == 1) {
            __syncwarp();                 // the slot's readers are done
            load(j, 0);
            cp_async_commit();
            cp_async_wait<0>();
        } else {
            cp_async_wait_upto(stages - 2);   // tile j has landed here
        }
        __syncwarp();                     // ... and for every lane
        if (stages > 1) {                 // refill the slot read last
            const int next = j + stages - 1;
            if (next < mine) load(next, next % stages);
            cp_async_commit();
        }
        const bf16* ks = ring + (size_t)(stages > 1 ? j % stages : 0) * 2 * tile;
        const bf16* vs = ks + tile;
        const int kbase = lo + (warp + j * nwarps) * TK;

        // s = q k^T for TK keys
        float s[NS][4];
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
            for (int np = 0; np < NS / 2; ++np) {
                uint32_t bb[4];
                ldsm_x4(bb, ks + (16 * np) * LD + kk * 16 + b_off);
                mma(s[2 * np], qa[kk], bb[0], bb[1]);
                mma(s[2 * np + 1], qa[kk], bb[2], bb[3]);
            }
        }
        // the mask only in the tile that holds the segment's end; a masked
        // score is -inf, so it weighs 0 even while a row's max is -1e30
        if (kbase + TK > hi) {
#pragma unroll
            for (int n = 0; n < NS; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (kbase + 8 * n + 2 * t4 + (e & 1) >= hi) s[n][e] = -INFINITY;
        }
        float r0 = -INFINITY, r1 = -INFINITY;       // the raw row max
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            r0 = fmaxf(r0, fmaxf(s[n][0], s[n][1]));
            r1 = fmaxf(r1, fmaxf(s[n][2], s[n][3]));
        }
        r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
        r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
        r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
        r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
        const float mx0 = fmaxf(m0, r0 * sl2), mx1 = fmaxf(m1, r1 * sl2);
        if (__any_sync(0xffffffffu, mx0 != m0 || mx1 != m1)) {
            const float a0 = ex2(m0 - mx0), a1 = ex2(m1 - mx1);
            m0 = mx0;
            m1 = mx1;
            l0 *= a0;
            l1 *= a1;
#pragma unroll
            for (int n = 0; n < DT; ++n) {
                acc[n][0] *= a0;
                acc[n][1] *= a0;
                acc[n][2] *= a1;
                acc[n][3] *= a1;
            }
        }
#pragma unroll
        for (int n = 0; n < NS; ++n) {
            s[n][0] = ex2(fmaf(s[n][0], sl2, -mx0));
            s[n][1] = ex2(fmaf(s[n][1], sl2, -mx0));
            s[n][2] = ex2(fmaf(s[n][2], sl2, -mx1));
            s[n][3] = ex2(fmaf(s[n][3], sl2, -mx1));
            l0 += s[n][0] + s[n][1];
            l1 += s[n][2] + s[n][3];
        }
        // acc += p v with p = hi + lo, both bf16: two products a k16 step
#pragma unroll
        for (int jj = 0; jj < NS / 2; ++jj) {
            uint32_t ahi[4], alo[4];
            float rest0[4], rest1[4];
            c_to_a(ahi, s[2 * jj], s[2 * jj + 1]);
            {
                const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(ahi);
                // ahi[0]: s[2jj][0..1], ahi[1]: s[2jj][2..3],
                // ahi[2]: s[2jj+1][0..1], ahi[3]: s[2jj+1][2..3]
                rest0[0] = s[2 * jj][0] - __low2float(hp[0]);
                rest0[1] = s[2 * jj][1] - __high2float(hp[0]);
                rest0[2] = s[2 * jj][2] - __low2float(hp[1]);
                rest0[3] = s[2 * jj][3] - __high2float(hp[1]);
                rest1[0] = s[2 * jj + 1][0] - __low2float(hp[2]);
                rest1[1] = s[2 * jj + 1][1] - __high2float(hp[2]);
                rest1[2] = s[2 * jj + 1][2] - __low2float(hp[3]);
                rest1[3] = s[2 * jj + 1][3] - __high2float(hp[3]);
            }
            c_to_a(alo, rest0, rest1);
            const bf16* vrow = vs + (16 * jj) * LD + t_off;
#pragma unroll
            for (int dp = 0; dp < DT / 2; ++dp) {
                uint32_t bb[4];
                ldsm_x4_t(bb, vrow + 16 * dp);
                mma(acc[2 * dp], ahi, bb[0], bb[1]);
                mma(acc[2 * dp], alo, bb[0], bb[1]);
                mma(acc[2 * dp + 1], ahi, bb[2], bb[3]);
                mma(acc[2 * dp + 1], alo, bb[2], bb[3]);
            }
        }
    }
    cp_async_wait<0>();                   // no copy outlives the ring
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    __syncthreads();                      // every warp is done with its ring

    // the warps' partials into the ring's space: wacc (W, 16, HD), wm, wl
    // (W, 16); then the block's (pm, pl) and pacc = wacc[0] merged in place
    float* wacc = reinterpret_cast<float*>(smem_raw);
    float* wm = wacc + (size_t)nwarps * 16 * HD;
    float* wl = wm + nwarps * 16;
    const int64_t ring_b = bf16_ring_bytes(HD, TK, nwarps, stages);
    const int64_t part_b = bf16_part_bytes(HD, nwarps);
    float* pm = reinterpret_cast<float*>(smem_raw + (ring_b > part_b ? ring_b : part_b));
    float* pl = pm + 16;
    {
        float* wa = wacc + (size_t)warp * 16 * HD;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            const int d = 8 * n + 2 * t4;
            wa[g * HD + d] = acc[n][0];
            wa[g * HD + d + 1] = acc[n][1];
            wa[(g + 8) * HD + d] = acc[n][2];
            wa[(g + 8) * HD + d + 1] = acc[n][3];
        }
        if (t4 == 0) {
            wm[warp * 16 + g] = m0;
            wm[warp * 16 + g + 8] = m1;
            wl[warp * 16 + g] = l0;
            wl[warp * 16 + g + 8] = l1;
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rep * HD; e += blockDim.x) {
        const int r = e / HD;
        float mb = NEG_INF;
        for (int w = 0; w < nwarps; ++w) mb = fmaxf(mb, wm[w * 16 + r]);
        float a = 0.f;
        for (int w = 0; w < nwarps; ++w)
            a = fmaf(wacc[(size_t)w * 16 * HD + e], exp2f(wm[w * 16 + r] - mb), a);
        wacc[e] = a;
    }
    for (int r = threadIdx.x; r < rep; r += blockDim.x) {
        float mb = NEG_INF;
        for (int w = 0; w < nwarps; ++w) mb = fmaxf(mb, wm[w * 16 + r]);
        float lb = 0.f;
        for (int w = 0; w < nwarps; ++w)
            lb = fmaf(wl[w * 16 + r], exp2f(wm[w * 16 + r] - mb), lb);
        pm[r] = mb;
        pl[r] = lb;
    }
    cluster_combine<HD, true>(pm, pl, wacc, out + (int64_t)bg * rep * HD,
                              lse ? lse + (int64_t)bg * rep : nullptr, rep,
                              splits);
}

// ---------------------------------------------------------------------------
// launches

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int64_t blocks, int threads, size_t smem,
                   int splits, void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (splits > 8) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return (int)err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3((unsigned)threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

bool bad_common(int s_len, int rep, int splits) {
    return rep > MAX_REP || splits < 1 || splits > MAX_SPLITS
        || (splits & (splits - 1)) || splits > s_len;
}

template <int HD>
int launch_f32_hd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int batch, int s_len, int kv, int rep, int length, int splits,
                  int block_s, int threads, float scale, void* stream) {
    const size_t smem = (size_t)f32_smem_floats(rep, HD, block_s, threads) * sizeof(float);
    const int seg = (s_len + splits - 1) / splits;
    return launch_cluster(decode_f32_kernel<HD>, (int64_t)batch * kv * splits,
                          threads, smem, splits, stream, (const float*)q,
                          (const float*)k, (const float*)v, (float*)out, (float*)lse, s_len,
                          kv, rep, length, seg, splits, block_s, scale);
}

template <int HD, int TK>
int launch_bf16_tk(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int s_len, int kv, int rep, int length,
                   int splits, int threads, int stages, float scale,
                   void* stream) {
    const size_t smem = (size_t)bf16_smem_bytes(HD, TK, threads / 32, stages);
    const int seg = (s_len + splits - 1) / splits;
    return launch_cluster(decode_bf16_kernel<HD, TK>,
                          (int64_t)batch * kv * splits, threads, smem, splits,
                          stream, (const flash::bf16*)q, (const flash::bf16*)k,
                          (const flash::bf16*)v, (float*)out, (float*)lse, s_len, kv,
                          rep,
                          length, seg, splits, stages, scale);
}

template <int HD>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* out,
                   void* lse, int batch, int s_len, int kv, int rep, int length,
                   int splits, int block_s, int threads, int stages,
                   float scale, void* stream) {
    switch (block_s) {
        case 16: return launch_bf16_tk<HD, 16>(q, k, v, out, lse, batch, s_len, kv, rep,
                                               length, splits, threads, stages,
                                               scale, stream);
        case 32: return launch_bf16_tk<HD, 32>(q, k, v, out, lse, batch, s_len, kv, rep,
                                               length, splits, threads, stages,
                                               scale, stream);
        case 64: return launch_bf16_tk<HD, 64>(q, k, v, out, lse, batch, s_len, kv, rep,
                                               length, splits, threads, stages,
                                               scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// q: (B, KV, rep, hd); k, v: (B, S, KV, hd), all contiguous and 16-byte
// aligned; out: (B, KV, rep, hd) float32; lse: (B, KV, rep) float32 or null
// (then not written).  hd in {32, 64, 96, 128, 192};
// rep <= 16; splits a power of two <= 16 (one cluster a group); threads a
// multiple of 32 in [32, 512]; `stages` is the bfloat16 build's.
int decode_attention_f32(const void* q, const void* k, const void* v,
                         void* out, void* lse, int batch, int s_len, int kv, int rep,
                         int hd, int length, int splits, int block_s,
                         int threads, int stages, float scale, void* stream) {
    (void)stages;
    if (batch <= 0 || kv <= 0 || rep <= 0) return 0;
    if (bad_common(s_len, rep, splits) || block_s < 1
        || threads < 32 || threads > F32_MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 32: return launch_f32_hd<32>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                          splits, block_s, threads, scale, stream);
        case 64: return launch_f32_hd<64>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                          splits, block_s, threads, scale, stream);
        case 96: return launch_f32_hd<96>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                          splits, block_s, threads, scale, stream);
        case 128: return launch_f32_hd<128>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                            splits, block_s, threads, scale, stream);
        case 192: return launch_f32_hd<192>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                            splits, block_s, threads, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

int decode_attention_bf16(const void* q, const void* k, const void* v,
                          void* out, void* lse, int batch, int s_len, int kv, int rep,
                          int hd, int length, int splits, int block_s,
                          int threads, int stages, float scale, void* stream) {
    if (batch <= 0 || kv <= 0 || rep <= 0) return 0;
    if (bad_common(s_len, rep, splits) || threads < 32
        || threads > BF16_MAX_THREADS || threads % 32 || stages < 1
        || stages > MAX_STAGES)
        return (int)cudaErrorInvalidValue;
    switch (hd) {
        case 32: return launch_bf16_hd<32>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                           splits, block_s, threads, stages, scale, stream);
        case 64: return launch_bf16_hd<64>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                           splits, block_s, threads, stages, scale, stream);
        case 96: return launch_bf16_hd<96>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                           splits, block_s, threads, stages, scale, stream);
        case 128: return launch_bf16_hd<128>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                             splits, block_s, threads, stages, scale, stream);
        case 192: return launch_bf16_hd<192>(q, k, v, out, lse, batch, s_len, kv, rep, length,
                                             splits, block_s, threads, stages, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

long long decode_attention_smem_bytes(int bf16, int rep, int hd, int block_s,
                                      int threads, int stages) {
    return bf16 ? (long long)bf16_smem_bytes(hd, block_s, threads / 32, stages)
                : (long long)f32_smem_floats(rep, hd, block_s, threads)
                      * (long long)sizeof(float);
}

const char* decode_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
