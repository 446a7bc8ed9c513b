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
//   * bfloat16 (the serving path): both products on the tensor cores,
//     mma.sync m16n8k16 with bf16 operands and float32 accumulation; the
//     probabilities are rounded to bf16 for p @ v, the softmax statistics
//     (m, l, lse) and the output accumulator stay float32.  Per key block:
//     stage k (row-major) and v (transposed) as bf16 in shared memory; each
//     warp takes 16 x 32 tiles of the scores (q from shared memory, staged
//     once), scales and masks them into a float32 score tile; a warp per row
//     does the online-softmax update; each warp takes 16 x 32 tiles of the
//     output accumulator (float32, shared memory), rescales them and adds
//     p @ v.  Rows of a tile are padded so that the 32-bit fragment loads of
//     a warp hit 32 distinct banks.  Blocks of 8 rows or keys are padded to
//     the mma's 16 with zeros.
//   * float32 (the parity path): the float32 parity gate is 2e-4, which
//     rules out TF32, so the arithmetic stays on the CUDA cores in float32:
//     4 x 4 register micro-tiles of scores and of the output fed from
//     transposed shared-memory tiles (8 loads per 16 FMAs; one padding word
//     per row keeps the strided rows and columns free of bank conflicts).
//
// Both: the TPU grid's sequential k axis is a loop inside one block, with
// the carry (m, l, alpha per row, the output accumulator) in shared memory;
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
// bfloat16: tensor cores (mma.sync m16n8k16, float32 accumulation)

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int pad16(int x) { return (x + 15) / 16 * 16; }

// Row pitches, in elements, of the shared tiles.  A bf16 pitch of
// (multiple of 16) + 8 makes the 32-bit fragment loads of a warp (8 rows x
// 4 words) fall on 32 distinct banks.
struct MmaLayout {
    int BQ, BK;                 // bq, bk padded to the mma's 16
    int ldq, ldk, ldv, ldp;     // bf16 pitches: q, k, v^T, p
    int lds, ldo;               // float32 pitches: scores, output accumulator
    __host__ __device__ MmaLayout(int bq, int bk, int hd)
        : BQ(pad16(bq)), BK(pad16(bk)), ldq(hd + 8), ldk(hd + 8),
          ldv(pad16(bk) + 8), ldp(pad16(bk) + 8), lds(bk + 4), ldo(hd + 4) {}
    __host__ __device__ int64_t bf16_elems(int bk, int hd) const {
        return (int64_t)BQ * ldq + (int64_t)bk * ldk + (int64_t)hd * ldv
             + (int64_t)BQ * ldp;
    }
    __host__ __device__ int64_t f32_elems() const {
        return (int64_t)BQ * lds + (int64_t)BQ * ldo + 3LL * BQ;
    }
};

// Shared memory, in bytes, for one block (must match kernel.smem_bytes).
__host__ __device__ inline int64_t smem_bytes_bf16(int bq, int bk, int hd) {
    const MmaLayout L(bq, bk, hd);
    return 2 * L.bf16_elems(bk, hd) + 4 * L.f32_elems();
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 x 16, row-major) at rows r0.., columns k0.. of `base`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* base,
                                       int ld, int r0, int k0, int lane) {
    const bf16* p = base + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    a[0] = ld32(p);
    a[1] = ld32(p + 8 * ld);
    a[2] = ld32(p + 8);
    a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (16 x 8, "col"): element (k, n) at base[(n0 + n) * ld + k0 + k].
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const bf16* base,
                                       int ld, int n0, int k0, int lane) {
    const bf16* p = base + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
    b[0] = ld32(p);
    b[1] = ld32(p + 8);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    return x;
}

__global__ void __launch_bounds__(MAX_THREADS)
flash_fwd_mma_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, Strides sq, Strides sk,
                          Strides sv, Strides so, int n_heads, int tq, int tk,
                          int hd, int bq, int bk, int causal, int q_offset,
                          float scale) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const MmaLayout L(bq, bk, hd);
    bf16* qs = reinterpret_cast<bf16*>(smem_raw);     // BQ x ldq
    bf16* ks = qs + (size_t)L.BQ * L.ldq;             // bk x ldk
    bf16* vt = ks + (size_t)bk * L.ldk;               // hd x ldv (v transposed)
    bf16* ps = vt + (size_t)hd * L.ldv;               // BQ x ldp
    float* sc = reinterpret_cast<float*>(ps + (size_t)L.BQ * L.ldp);  // BQ x lds
    float* oa = sc + (size_t)L.BQ * L.lds;            // BQ x ldo
    float* m_s = oa + (size_t)L.BQ * L.ldo;
    float* l_s = m_s + L.BQ;
    float* a_s = l_s + L.BQ;

    const Block blk = block_of(tq, bq, n_heads);
    const int q0 = blk.q0;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const bf16* qg = q + blk.b * sq.b + blk.h * sq.h;
    const bf16* kg = k + blk.b * sk.b + blk.h * sk.h;
    const bf16* vg = v + blk.b * sv.b + blk.h * sv.h;
    const int hd2 = hd / 2;
    const uint32_t zero2 = 0u;

    // stage q (rows past bq or tq are zero) and clear the carry
    for (int e = tid; e < L.BQ * hd2; e += nt) {
        const int i = e / hd2, d = 2 * (e - i * hd2);
        const int t = q0 + i;
        *reinterpret_cast<uint32_t*>(qs + i * L.ldq + d) =
            (i < bq && t < tq) ? ld32(qg + (int64_t)t * sq.t + d) : zero2;
    }
    for (int e = tid; e < L.BQ * L.ldo; e += nt) oa[e] = 0.f;
    for (int i = tid; i < L.BQ; i += nt) {
        m_s[i] = NEG_INF;
        l_s[i] = 0.f;
    }

    const int n_kb = key_blocks(tq, tk, q0, bq, bk, causal, q_offset);
    const int m_tiles = L.BQ / 16;
    const int s_chunks = (bk + 31) / 32, o_chunks = (hd + 31) / 32;

    for (int kb = 0; kb < n_kb; ++kb) {
        const int k0 = kb * bk;
        __syncthreads();            // previous block's readers are done
        // k row-major, v transposed; keys past bk (padding) or tk are zero
        for (int e = tid; e < L.BK * hd2; e += nt) {
            const int j = e / hd2, d = 2 * (e - j * hd2);
            const int t = k0 + j;
            const bool in = j < bk && t < tk;
            if (j < bk)
                *reinterpret_cast<uint32_t*>(ks + j * L.ldk + d) =
                    in ? ld32(kg + (int64_t)t * sk.t + d) : zero2;
            const __nv_bfloat162 vv = in
                ? *reinterpret_cast<const __nv_bfloat162*>(vg + (int64_t)t * sv.t + d)
                : __floats2bfloat162_rn(0.f, 0.f);
            vt[d * L.ldv + j] = vv.x;
            vt[(d + 1) * L.ldv + j] = vv.y;
        }
        __syncthreads();

        // scores: each warp a 16 x 32 tile, q @ k^T on the tensor cores,
        // then scaled and masked into the float32 score tile
        for (int task = warp; task < m_tiles * s_chunks; task += n_warps) {
            const int r0 = (task / s_chunks) * 16, c0 = (task % s_chunks) * 32;
            const int nn = min(4, (bk - c0) / 8);
            float acc[4][4] = {};
            for (int kk = 0; kk < hd; kk += 16) {
                uint32_t a[4];
                load_a(a, qs, L.ldq, r0, kk, lane);
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    if (n < nn) {
                        uint32_t b[2];
                        load_b(b, ks, L.ldk, c0 + 8 * n, kk, lane);
                        mma_bf16(acc[n], a, b);
                    }
                }
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                if (n >= nn) continue;
                const int j = c0 + 8 * n + 2 * t4;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int i = r0 + g + 8 * half;
                    const int qpos = q_offset + q0 + i;
                    float2 s;
                    const int kp0 = k0 + j, kp1 = kp0 + 1;
                    s.x = (kp0 < tk && (!causal || qpos >= kp0))
                        ? acc[n][2 * half] * scale : NEG_INF;
                    s.y = (kp1 < tk && (!causal || qpos >= kp1))
                        ? acc[n][2 * half + 1] * scale : NEG_INF;
                    *reinterpret_cast<float2*>(sc + i * L.lds + j) = s;
                }
            }
        }
        __syncthreads();

        // online softmax, a warp per row; p in bf16 (zero past bk)
        for (int i = warp; i < L.BQ; i += n_warps) {
            const float* row = sc + i * L.lds;
            float mx = NEG_INF;
            for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, row[j]);
            mx = warp_max(mx);
            const float m_old = m_s[i];
            const float m_new = fmaxf(m_old, mx);
            float sum = 0.f;
            for (int j = lane; j < L.BK; j += 32) {
                const float p = j < bk ? expf(row[j] - m_new) : 0.f;
                ps[i * L.ldp + j] = __float2bfloat16(p);
                sum += p;
            }
            sum = warp_sum(sum);
            if (lane == 0) {
                const float alpha = expf(m_old - m_new);
                a_s[i] = alpha;
                l_s[i] = l_s[i] * alpha + sum;
                m_s[i] = m_new;
            }
        }
        __syncthreads();

        // o = o * alpha + p @ v: each warp a 16 x 32 tile of the accumulator
        for (int task = warp; task < m_tiles * o_chunks; task += n_warps) {
            const int r0 = (task / o_chunks) * 16, c0 = (task % o_chunks) * 32;
            const int nn = min(4, (hd - c0) / 8);
            const float alpha0 = a_s[r0 + g], alpha1 = a_s[r0 + g + 8];
            float acc[4][4];
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                if (n >= nn) continue;
                const int j = c0 + 8 * n + 2 * t4;
                const float2 lo = *reinterpret_cast<const float2*>(oa + (r0 + g) * L.ldo + j);
                const float2 hi = *reinterpret_cast<const float2*>(oa + (r0 + g + 8) * L.ldo + j);
                acc[n][0] = lo.x * alpha0;
                acc[n][1] = lo.y * alpha0;
                acc[n][2] = hi.x * alpha1;
                acc[n][3] = hi.y * alpha1;
            }
            for (int kk = 0; kk < L.BK; kk += 16) {
                uint32_t a[4];
                load_a(a, ps, L.ldp, r0, kk, lane);
#pragma unroll
                for (int n = 0; n < 4; ++n) {
                    if (n < nn) {
                        uint32_t b[2];
                        load_b(b, vt, L.ldv, c0 + 8 * n, kk, lane);
                        mma_bf16(acc[n], a, b);
                    }
                }
            }
#pragma unroll
            for (int n = 0; n < 4; ++n) {
                if (n >= nn) continue;
                const int j = c0 + 8 * n + 2 * t4;
                *reinterpret_cast<float2*>(oa + (r0 + g) * L.ldo + j) =
                    make_float2(acc[n][0], acc[n][1]);
                *reinterpret_cast<float2*>(oa + (r0 + g + 8) * L.ldo + j) =
                    make_float2(acc[n][2], acc[n][3]);
            }
        }
    }
    __syncthreads();

    // o = acc / max(l, 1e-30) in bf16; lse = m + log(max(l, 1e-30))
    bf16* og = o + blk.b * so.b + blk.h * so.h;
    for (int e = tid; e < bq * hd2; e += nt) {
        const int i = e / hd2, d = 2 * (e - i * hd2);
        const int t = q0 + i;
        if (t < tq) {
            const float inv = 1.f / fmaxf(l_s[i], 1e-30f);
            *reinterpret_cast<__nv_bfloat162*>(og + (int64_t)t * so.t + d) =
                __floats2bfloat162_rn(oa[i * L.ldo + d] * inv,
                                      oa[i * L.ldo + d + 1] * inv);
        }
    }
    for (int i = tid; i < bq; i += nt) {
        const int t = q0 + i;
        if (t < tq)
            lse[(int64_t)blk.bh * tq + t] = m_s[i] + logf(fmaxf(l_s[i], 1e-30f));
    }
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
// lse: (B, H, Tq) float32, contiguous.  threads a multiple of 32 in
// [32, 1024].  float32: bq, bk and hd multiples of 4.  bfloat16: bq, bk
// multiples of 8, hd a multiple of 16, every stride even and every
// pointer 4-byte aligned (the kernel moves bf16 in pairs).
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

int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                             void* o, void* lse, const int64_t* strides,
                             int batch, int n_heads, int tq, int tk, int hd,
                             int bq, int bk, int threads, int causal,
                             int q_offset, float scale, void* stream) {
    const size_t smem = (size_t)smem_bytes_bf16(bq, bk, hd);
    return launch<bf16>(flash_fwd_mma_bf16_kernel, smem, q, k, v, o, lse,
                        strides, batch, n_heads, tq, tk, hd, bq, bk, threads,
                        causal, q_offset, scale, stream);
}

const char* flash_attention_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
