// FlashAttention-2 forward for NVIDIA Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the Pallas TPU kernel flash_attention_fwd (_fwd_kernel) of
// src/repro/kernels/flash_attention/kernel.py.
//
// What it computes, per (batch, head) and query row i:
//     s_j = scale * (q_i . k_j)            in float32, scale = hd^-0.5
//     causal: s_j = -1e30 where q_offset + i < j
//     o_i = sum_j exp(s_j - m) v_j / max(l, 1e-30),  l = sum_j exp(s_j - m)
//     lse_i = m + log(max(l, 1e-30))        (kept for the backward pass)
// with the running (acc, m, l) of the online softmax, exactly as the TPU
// kernel carries them across its sequential k grid axis.  -1e30 and not
// -inf, so a row whose first key block is fully masked gives no NaN.
//
// What bounds it on the H100: operations.  At the serving shape (B*H = 128,
// T = 2048, hd = 128, causal) it does 2 * 2 * 128 * 2048^2 / 2 * 128 =
// 137 GFLOP and moves 201 MB, so the card's bf16 tensor-core rate would
// allow 0.14 ms.  Two builds, one per input type:
//
//   * bfloat16 (the serving and training path): FA-2's register-resident
//     forward, both products on the tensor cores (mma.sync m16n8k16, bf16
//     operands, float32 accumulators; flash_tiles.cuh).  A block owns bq
//     query rows, a warp 16 * rt of them (rt = 2 * bq / block_threads, 1 or
//     2): every k and v fragment a warp reads from shared memory feeds rt
//     mma.  q is staged once in shared memory; k and v arrive through a
//     ring of `stages` shared slots filled by 16-byte cp.async copies
//     (rows past tk zero-filled), one barrier a key block.  Per 64 / rt keys
//     a warp computes s = q k^T into registers (q's A and k's B fragments by
//     ldmatrix), masks it only in a block that holds the causal diagonal or
//     the ragged end, takes the row max over the quad of threads that share
//     a row (two xor shuffles), rescales its output accumulator (registers)
//     and row sums only when a row's max moved (a warp vote), and turns p's
//     C fragments into bf16 A fragments in registers for acc += p v (v's B
//     fragments by ldmatrix.trans: no transposed copy).  A warp stops at
//     the first key past its last row.  At the end o = acc / max(l, 1e-30),
//     lse = m + log(max(l, 1e-30)).  Templates for hd 32, 64, 96, 128 (rt 1
//     and 2) and 192 (rt 1: rt 2's two accumulators would spill).  What
//     holds it back (PERF.md): warps an SM can hold (registers), and the
//     issue slots the softmax takes beside the mma.
//   * float32 (the parity path): the float32 parity gate is 2e-4, which
//     rules out TF32, so the arithmetic stays on the CUDA cores in float32:
//     4 x 4 register micro-tiles of scores and of the output fed from
//     transposed shared-memory tiles (8 loads per 16 FMAs; one padding word
//     per row keeps the strided rows and columns free of bank conflicts);
//     the carry (m, l, alpha per row, the output accumulator) in shared
//     memory.
//
// Both: the TPU grid's sequential k axis is a loop inside one block;
// causal key blocks that lie wholly above the diagonal are skipped (the
// Pallas grid visits them; skipping them changes no number) and the
// heaviest query blocks are launched first; heads are folded into the grid
// by index arithmetic through the (batch, seq, head) strides of q, k, v and
// o, so nothing is copied to fold (B, T, H, hd) into (B*H, T, hd).  Ragged
// edges are masked, not clamped: T need not be a multiple of a block.
//
// Plain C interface: flash_attention_fwd_{f32,bf16} launch on the given
// stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_THREADS = 1024;

struct Strides {            // element strides of a (B, T, H, hd) view
    int64_t b, t, h;
};

struct Block {              // which (batch, head, query block) a CUDA block owns
    int bh, b, h, q0;
};

__device__ __forceinline__ Block block_of(int tq, int bq, int n_heads) {
    const int n_qb = (tq + bq - 1) / bq;
    const int64_t block = blockIdx.x;
    const int bh = (int)(block / n_qb);
    const int qb = n_qb - 1 - (int)(block % n_qb);   // heaviest first
    return {bh, bh / n_heads, bh % n_heads, qb * bq};
}

// key blocks to visit: causal ones wholly above the diagonal are skipped
__device__ __forceinline__ int key_blocks(int tq, int tk, int q0, int bq,
                                          int bk, int causal, int q_offset) {
    int n_kb = (tk + bk - 1) / bk;
    if (causal) {
        const int last_q = q_offset + min(q0 + bq, tq) - 1;
        n_kb = min(n_kb, last_q / bk + 1);
    }
    return n_kb;
}

// ---------------------------------------------------------------------------
// float32: CUDA-core arithmetic

// Shared memory, in floats, for one block (must match the Python-side
// kernel.smem_bytes).
__host__ __device__ inline int64_t smem_floats_f32(int bq, int bk, int hd) {
    return (int64_t)hd * (bq + 1)        // qt: q tile, transposed, scaled
         + (int64_t)hd * (bk + 1)        // kt: k tile, transposed
         + (int64_t)bk * hd              // vs: v tile
         + (int64_t)bq * (bk + 1)        // sc: scores, then probabilities
         + (int64_t)bq * (hd + 1)        // oa: output accumulator
         + 3LL * bq;                     // m, l, alpha
}

__global__ void __launch_bounds__(MAX_THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int n_heads, int tq, int tk,
                     int hd, int bq, int bk, int causal, int q_offset,
                     float scale) {
    extern __shared__ float smem[];
    float* qt = smem;
    float* kt = qt + (size_t)hd * (bq + 1);
    float* vs = kt + (size_t)hd * (bk + 1);
    float* sc = vs + (size_t)bk * hd;
    float* oa = sc + (size_t)bq * (bk + 1);
    float* m_s = oa + (size_t)bq * (hd + 1);
    float* l_s = m_s + bq;
    float* a_s = l_s + bq;

    const Block blk = block_of(tq, bq, n_heads);
    const int q0 = blk.q0;
    const int tid = threadIdx.x, nt = blockDim.x;
    const float* qg = q + blk.b * sq.b + blk.h * sq.h;
    const float* kg = k + blk.b * sk.b + blk.h * sk.h;
    const float* vg = v + blk.b * sv.b + blk.h * sv.h;

    // stage q (scaled, transposed) and clear the carry
    for (int e = tid; e < bq * hd; e += nt) {
        const int i = e / hd, d = e - i * hd;
        const int t = q0 + i;
        qt[d * (bq + 1) + i] = t < tq ? qg[(int64_t)t * sq.t + d] * scale : 0.f;
    }
    for (int e = tid; e < bq * (hd + 1); e += nt) oa[e] = 0.f;
    for (int i = tid; i < bq; i += nt) {
        m_s[i] = NEG_INF;
        l_s[i] = 0.f;
    }

    const int n_kb = key_blocks(tq, tk, q0, bq, bk, causal, q_offset);
    const int tiles_i = bq / 4, tiles_j = bk / 4, tiles_d = hd / 4;

    for (int kb = 0; kb < n_kb; ++kb) {
        const int k0 = kb * bk;
        __syncthreads();            // previous block's readers are done
        for (int e = tid; e < bk * hd; e += nt) {
            const int j = e / hd, d = e - j * hd;
            const int t = k0 + j;
            const bool in = t < tk;
            kt[d * (bk + 1) + j] = in ? kg[(int64_t)t * sk.t + d] : 0.f;
            vs[j * hd + d] = in ? vg[(int64_t)t * sv.t + d] : 0.f;
        }
        __syncthreads();

        // scores: 4 x 4 micro-tiles, rows ti + r * tiles_i, cols tj + c * tiles_j
        for (int tile = tid; tile < tiles_i * tiles_j; tile += nt) {
            const int ti = tile / tiles_j, tj = tile - ti * tiles_j;
            float s[4][4] = {};
            for (int d = 0; d < hd; ++d) {
                const float* qrow = qt + d * (bq + 1) + ti;
                const float* krow = kt + d * (bk + 1) + tj;
                float qv[4], kv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) qv[r] = qrow[r * tiles_i];
#pragma unroll
                for (int c = 0; c < 4; ++c) kv[c] = krow[c * tiles_j];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti + r * tiles_i;
                const int qpos = q_offset + q0 + i;
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int j = tj + c * tiles_j;
                    const int kpos = k0 + j;
                    const bool ok = kpos < tk && (!causal || qpos >= kpos);
                    sc[i * (bk + 1) + j] = ok ? s[r][c] : NEG_INF;
                }
            }
        }
        __syncthreads();

        // online softmax, one thread per row
        for (int i = tid; i < bq; i += nt) {
            float* row = sc + i * (bk + 1);
            const float m_old = m_s[i];
            float mx = NEG_INF;
            for (int j = 0; j < bk; ++j) mx = fmaxf(mx, row[j]);
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
            for (int j = 0; j < bk; ++j) {
                const float p = expf(row[j] - m_new);
                row[j] = p;
                sum += p;
            }
            const float alpha = expf(m_old - m_new);
            a_s[i] = alpha;
            l_s[i] = l_s[i] * alpha + sum;
            m_s[i] = m_new;
        }
        __syncthreads();

        // o = o * alpha + p @ v, 4 x 4 micro-tiles over (row, d)
        for (int tile = tid; tile < tiles_i * tiles_d; tile += nt) {
            const int ti = tile / tiles_d, td = tile - ti * tiles_d;
            float acc[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti + r * tiles_i;
                const float alpha = a_s[i];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[r][c] = oa[i * (hd + 1) + td + c * tiles_d] * alpha;
            }
            for (int j = 0; j < bk; ++j) {
                float pv[4], vv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) pv[r] = sc[(ti + r * tiles_i) * (bk + 1) + j];
#pragma unroll
                for (int c = 0; c < 4; ++c) vv[c] = vs[j * hd + td + c * tiles_d];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = ti + r * tiles_i;
#pragma unroll
                for (int c = 0; c < 4; ++c) oa[i * (hd + 1) + td + c * tiles_d] = acc[r][c];
            }
        }
    }
    __syncthreads();

    // o = acc / max(l, 1e-30); lse = m + log(max(l, 1e-30))
    float* og = o + blk.b * so.b + blk.h * so.h;
    for (int e = tid; e < bq * hd; e += nt) {
        const int i = e / hd, d = e - i * hd;
        const int t = q0 + i;
        if (t < tq)
            og[(int64_t)t * so.t + d] = oa[i * (hd + 1) + d] / fmaxf(l_s[i], 1e-30f);
    }
    for (int i = tid; i < bq; i += nt) {
        const int t = q0 + i;
        if (t < tq)
            lse[(int64_t)blk.bh * tq + t] = m_s[i] + logf(fmaxf(l_s[i], 1e-30f));
    }
}

// ---------------------------------------------------------------------------
// bfloat16: FA-2's register-resident forward on the tensor cores

using flash::bf16;

// The largest block the bf16 kernel is built for (its registers: up to 255
// a thread, so 8 warps fill the register file).
constexpr int MMA_MAX_THREADS = 256;

// Shared memory, in bytes, for one block (must match kernel.smem_bytes):
// the q tile, then a ring of `stages` slots, each a k and a v tile of bk
// rows; rows at a pitch of hd + 8.
__host__ __device__ inline int64_t smem_bytes_bf16(int bq, int bk, int hd,
                                                   int stages) {
    return ((int64_t)bq + (int64_t)stages * 2 * bk) * (hd + 8)
           * (int64_t)sizeof(bf16);
}

// A warp owns RT tiles of 16 query rows (block_threads = 2 * bq / RT):
// every k and v fragment it reads from shared memory feeds RT mma.  q is
// staged once in shared memory and its A fragments are read by ldmatrix
// for each key block: held in registers they would cost 2 * RT * hd / 16
// registers a thread, and with them a third of the warps an SM can hold.
template <int HD, int RT>
__global__ void __launch_bounds__(MMA_MAX_THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int n_heads, int tq, int tk,
                      int bq, int bk, int stages, int causal, int q_offset,
                      float scale) {
    using namespace flash;
    constexpr int KT = HD / 16;           // k16 steps over hd
    constexpr int DT = HD / 8;            // n8 tiles over hd
    constexpr int LD = HD + 8;            // pitch of a shared row
    constexpr int KS = 64 / RT;           // keys whose scores a warp holds
    constexpr int NS = KS / 8;            // n8 tiles of scores a row tile
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* ring = qs + (size_t)bq * LD;
    const int tile = bk * LD;

    const Block blk = block_of(tq, bq, n_heads);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int wr = 16 * RT * warp;                // the warp's first row in the block
    const int r0 = blk.q0 + wr;
    const bool live = r0 < tq;
    const bf16* qg = q + blk.b * sq.b + blk.h * sq.h;
    const bf16* kg = k + blk.b * sk.b + blk.h * sk.h;
    const bf16* vg = v + blk.b * sv.b + blk.h * sv.h;

    // the block's q rows, staged once (they land with the first k/v block)
    stage_rows_async<HD>(qs, qg, sq.t, blk.q0, bq, tq);

    float acc[RT][DT][4];
    // running max (log2 units) and this thread's share of the row sums,
    // for rows g and g + 8 of each of the warp's row tiles
    float m[RT][2], l[RT][2];
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
#pragma unroll
        for (int n = 0; n < DT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[rt][n][e] = 0.f;
        m[rt][0] = m[rt][1] = NEG_INF;
        l[rt][0] = l[rt][1] = 0.f;
    }
    const float sl2 = scale * LOG2E;
    const int warp_first = q_offset + r0, warp_last = warp_first + 16 * RT - 1;
    const int b_off = nt_offset(lane, LD), t_off = kn_offset(lane, LD);

    const int n_kb = key_blocks(tq, tk, blk.q0, bq, bk, causal, q_offset);
    auto load = [&](int kb, int slot) {
        bf16* ks = ring + (size_t)slot * 2 * tile;
        stage_rows_async<HD>(ks, kg, sk.t, kb * bk, bk, tk);
        stage_rows_async<HD>(ks + tile, vg, sv.t, kb * bk, bk, tk);
    };

    for (int s = 0; s + 1 < stages; ++s) {
        if (s < n_kb) load(s, s);
        cp_async_commit();
    }
    for (int kb = 0; kb < n_kb; ++kb) {
        if (stages == 1) {
            __syncthreads();                      // the slot's readers are done
            load(kb, 0);
            cp_async_commit();
            cp_async_wait<0>();
        } else {
            cp_async_wait_upto(stages - 2);       // block kb has landed here
        }
        __syncthreads();                          // ... and for every thread
        if (stages > 1) {                         // refill the slot read last
            const int next = kb + stages - 1;
            if (next < n_kb) load(next, next % stages);
            cp_async_commit();
        }
        if (!live) continue;
        const bf16* ks = ring + (size_t)(stages > 1 ? kb % stages : 0) * 2 * tile;
        const bf16* vs = ks + tile;
        const int k0 = kb * bk;

        for (int c0 = 0; c0 < bk; c0 += KS) {
            const int kbase = k0 + c0;
            if (kbase >= tk || (causal && kbase > warp_last)) break;
            // the sub-tile's n8 tiles (even: bk % 16 == 0) as a constant,
            // so the unrolled products carry no run-time guard
            for_even<NS>(min(KS, bk - c0) / 8, [&](auto tiles) {
            constexpr int NN = decltype(tiles)::value;

            // s = q k^T for 8 * NN keys
            float s[RT][NN][4];
#pragma unroll
            for (int rt = 0; rt < RT; ++rt)
#pragma unroll
                for (int n = 0; n < NN; ++n)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[rt][n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                uint32_t qa[RT][4];
#pragma unroll
                for (int rt = 0; rt < RT; ++rt)
                    ldsm_x4(qa[rt], qs + (wr + 16 * rt) * LD + kk * 16 + t_off);
#pragma unroll
                for (int np = 0; np < NN / 2; ++np) {
                    uint32_t b[4];
                    ldsm_x4(b, ks + (c0 + 16 * np) * LD + kk * 16 + b_off);
#pragma unroll
                    for (int rt = 0; rt < RT; ++rt) {
                        mma(s[rt][2 * np], qa[rt], b[0], b[1]);
                        mma(s[rt][2 * np + 1], qa[rt], b[2], b[3]);
                    }
                }
            }
            // online softmax in log2 units; the mask only where the tile
            // can hold a masked key (the ragged end, the causal diagonal)
            const bool edge = kbase + 8 * NN > tk
                           || (causal && kbase + 8 * NN - 1 > warp_first);
#pragma unroll
            for (int rt = 0; rt < RT; ++rt) {
                if (edge) {
                    const int qpos0 = warp_first + 16 * rt + g, qpos1 = qpos0 + 8;
#pragma unroll
                    for (int n = 0; n < NN; ++n)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int key = kbase + 8 * n + 2 * t4 + (e & 1);
                            if (key >= tk || (causal && key > (e < 2 ? qpos0 : qpos1)))
                                s[rt][n][e] = NEG_INF;
                        }
                }
                float r0 = NEG_INF, r1 = NEG_INF;          // the raw row max
#pragma unroll
                for (int n = 0; n < NN; ++n) {
                    r0 = fmaxf(r0, fmaxf(s[rt][n][0], s[rt][n][1]));
                    r1 = fmaxf(r1, fmaxf(s[rt][n][2], s[rt][n][3]));
                }
                // the row max across the quad that shares a row
                r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 1));
                r0 = fmaxf(r0, __shfl_xor_sync(0xffffffffu, r0, 2));
                r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 1));
                r1 = fmaxf(r1, __shfl_xor_sync(0xffffffffu, r1, 2));
                const float mx0 = fmaxf(m[rt][0], r0 * sl2);
                const float mx1 = fmaxf(m[rt][1], r1 * sl2);
                // rescale only when a row's max moved (less and less often
                // as keys accumulate); the quad agrees, a warp votes
                if (__any_sync(0xffffffffu, mx0 != m[rt][0] || mx1 != m[rt][1])) {
                    const float a0 = ex2(m[rt][0] - mx0), a1 = ex2(m[rt][1] - mx1);
                    m[rt][0] = mx0;
                    m[rt][1] = mx1;
                    l[rt][0] *= a0;
                    l[rt][1] *= a1;
#pragma unroll
                    for (int n = 0; n < DT; ++n) {
                        acc[rt][n][0] *= a0;
                        acc[rt][n][1] *= a0;
                        acc[rt][n][2] *= a1;
                        acc[rt][n][3] *= a1;
                    }
                }
#pragma unroll
                for (int n = 0; n < NN; ++n) {
                    s[rt][n][0] = ex2(fmaf(s[rt][n][0], sl2, -mx0));
                    s[rt][n][1] = ex2(fmaf(s[rt][n][1], sl2, -mx0));
                    s[rt][n][2] = ex2(fmaf(s[rt][n][2], sl2, -mx1));
                    s[rt][n][3] = ex2(fmaf(s[rt][n][3], sl2, -mx1));
                    l[rt][0] += s[rt][n][0] + s[rt][n][1];
                    l[rt][1] += s[rt][n][2] + s[rt][n][3];
                }
            }
            // acc += p v: p's C fragments are the A fragments, v through
            // ldmatrix.trans
#pragma unroll
            for (int j = 0; j < NN / 2; ++j) {
                uint32_t a[RT][4];
#pragma unroll
                for (int rt = 0; rt < RT; ++rt)
                    c_to_a(a[rt], s[rt][2 * j], s[rt][2 * j + 1]);
                const bf16* vrow = vs + (c0 + 16 * j) * LD + t_off;
#pragma unroll
                for (int dp = 0; dp < DT / 2; ++dp) {
                    uint32_t b[4];
                    ldsm_x4_t(b, vrow + 16 * dp);
#pragma unroll
                    for (int rt = 0; rt < RT; ++rt) {
                        mma(acc[rt][2 * dp], a[rt], b[0], b[1]);
                        mma(acc[rt][2 * dp + 1], a[rt], b[2], b[3]);
                    }
                }
            }
            });
        }
    }
    cp_async_wait<0>();                           // no copy outlives the block

    // o = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30))
    bf16* og = o + blk.b * so.b + blk.h * so.h;
#pragma unroll
    for (int rt = 0; rt < RT; ++rt) {
        float l0 = l[rt][0], l1 = l[rt][1];
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
        const int row0 = r0 + 16 * rt + g, row1 = row0 + 8;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            const int d = 8 * n + 2 * t4;
            if (row0 < tq)
                *reinterpret_cast<uint32_t*>(og + (int64_t)row0 * so.t + d) =
                    pack_bf16(acc[rt][n][0] * inv0, acc[rt][n][1] * inv0);
            if (row1 < tq)
                *reinterpret_cast<uint32_t*>(og + (int64_t)row1 * so.t + d) =
                    pack_bf16(acc[rt][n][2] * inv1, acc[rt][n][3] * inv1);
        }
        if (t4 == 0) {
            if (row0 < tq)
                lse[(int64_t)blk.bh * tq + row0] =
                    m[rt][0] * LN2 + logf(fmaxf(l0, 1e-30f));
            if (row1 < tq)
                lse[(int64_t)blk.bh * tq + row1] =
                    m[rt][1] * LN2 + logf(fmaxf(l1, 1e-30f));
        }
    }
}

template <int HD, int RT>
int launch_bf16_hd(const void* q, const void* k, const void* v, void* o,
                   void* lse, const int64_t* strides, int batch, int n_heads,
                   int tq, int tk, int bq, int bk, int stages, int causal,
                   int q_offset, float scale, void* stream) {
    const size_t smem = (size_t)smem_bytes_bf16(bq, bk, HD, stages);
    auto kernel = flash_fwd_bf16_kernel<HD, RT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Strides sq{strides[0], strides[1], strides[2]};
    const Strides sk{strides[3], strides[4], strides[5]};
    const Strides sv{strides[6], strides[7], strides[8]};
    const Strides so{strides[9], strides[10], strides[11]};
    const int64_t blocks = (int64_t)batch * n_heads * ((tq + bq - 1) / bq);
    kernel<<<(unsigned)blocks, 2 * bq / RT, smem, (cudaStream_t)stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
        sq, sk, sv, so, n_heads, tq, tk, bq, bk, stages, causal, q_offset,
        scale);
    return (int)cudaGetLastError();
}

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* q, const void* k,
           const void* v, void* o, void* lse, const int64_t* strides,
           int batch, int n_heads, int tq, int tk, int hd, int bq, int bk,
           int threads, int causal, int q_offset, float scale, void* stream) {
    if (batch <= 0 || n_heads <= 0 || tq <= 0) return 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Strides sq{strides[0], strides[1], strides[2]};
    const Strides sk{strides[3], strides[4], strides[5]};
    const Strides sv{strides[6], strides[7], strides[8]};
    const Strides so{strides[9], strides[10], strides[11]};
    const int64_t blocks = (int64_t)batch * n_heads * ((tq + bq - 1) / bq);
    kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, sq, sk, sv,
        so, n_heads, tq, tk, hd, bq, bk, causal, q_offset, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (B, T, H, hd) views with unit stride along hd; `strides`
// holds 12 int64: (batch, seq, head) element strides of q, k, v, o.
// lse: (B, H, Tq) float32, contiguous.  float32: threads a multiple of 32
// in [32, 1024]; bq, bk and hd multiples of 4.
int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                            void* o, void* lse, const int64_t* strides,
                            int batch, int n_heads, int tq, int tk, int hd,
                            int bq, int bk, int threads, int causal,
                            int q_offset, float scale, void* stream) {
    const size_t smem = (size_t)smem_floats_f32(bq, bk, hd) * sizeof(float);
    return launch<float>(flash_fwd_f32_kernel, smem, q, k, v, o, lse, strides,
                         batch, n_heads, tq, tk, hd, bq, bk, threads, causal,
                         q_offset, scale, stream);
}

// bfloat16: a block of 2 * bq / rt threads (a warp per rt tiles of 16 query
// rows, rt in {1, 2}; at most 256 threads; rt = 2 up to hd 128), bq and bk
// multiples of 16, stages in [1, 4], hd in {32, 64, 96, 128, 192}; every
// stride a multiple of 8 and every pointer 16-byte aligned (q, k and v move
// in 16-byte copies).
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, const int64_t* strides,
                             int batch, int n_heads, int tq, int tk, int hd,
                             int bq, int bk, int threads, int stages,
                             int causal, int q_offset, float scale,
                             void* stream) {
    if (batch <= 0 || n_heads <= 0 || tq <= 0) return 0;
    const int rt = threads > 0 && (2 * bq) % threads == 0 ? 2 * bq / threads : 0;
    if (bq % 16 || bk % 16 || bq < 16 || bk < 16 || threads > MMA_MAX_THREADS
        || (rt != 1 && rt != 2) || (rt == 2 && hd > 128) || stages < 1
        || stages > 4)
        return (int)cudaErrorInvalidValue;
#define FWD_BF16(HD, RT)                                                      \
    return launch_bf16_hd<HD, RT>(q, k, v, o, lse, strides, batch, n_heads,  \
                                  tq, tk, bq, bk, stages, causal, q_offset,   \
                                  scale, stream);
    switch (hd * 2 + rt - 1) {       // (hd, rt) as one key
        case 32 * 2: FWD_BF16(32, 1)
        case 32 * 2 + 1: FWD_BF16(32, 2)
        case 64 * 2: FWD_BF16(64, 1)
        case 64 * 2 + 1: FWD_BF16(64, 2)
        case 96 * 2: FWD_BF16(96, 1)
        case 96 * 2 + 1: FWD_BF16(96, 2)
        case 128 * 2: FWD_BF16(128, 1)
        case 128 * 2 + 1: FWD_BF16(128, 2)
        case 192 * 2: FWD_BF16(192, 1)
        default: return (int)cudaErrorInvalidValue;
    }
#undef FWD_BF16
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
