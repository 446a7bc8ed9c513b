// FlashAttention-2 backward for NVIDIA Hopper (sm_90a), float32 or bfloat16.
//
// Replaces the Pallas TPU kernel flash_attention_bwd (_dq_kernel and
// _dkv_kernel) of src/repro/kernels/flash_attention/kernel.py.
//
// What it computes, per (batch, head), with scale = hd^-0.5, the forward's
// lse = m + log l and delta_i = sum_d do_id * o_id (computed by the caller,
// as the reference computes it outside its Pallas calls):
//     s_ij  = (scale * q_i) . k_j,  causal: masked where q_offset + i < j
//     p_ij  = exp(s_ij - lse_i)     (0 where masked)
//     dp_ij = do_i . v_j
//     ds_ij = p_ij * (dp_ij - delta_i)
//     dq_i  = scale * sum_j ds_ij k_j
//     dk_j  = sum_i ds_ij (scale * q_i)
//     dv_j  = sum_i p_ij do_i
// as two programs, the reference's two grids:
//
//   * dq:  one block per (batch * head, query block).  It loops over the key
//     blocks up to the causal diagonal (blocks wholly above it are skipped,
//     as B3 skips them), recomputes p and ds for the tile, and adds ds @ k
//     into its float32 accumulator.
//   * dkv: one block per (batch * head, key block).  It loops over the query
//     blocks from the first one that reaches the diagonal, recomputes p and
//     ds, and adds p^T @ do and ds^T @ (scale * q) into its accumulators.
//     A key block that no query reaches writes zeros.
//
// Every output tile is owned by one block and written once, with no atomics,
// so the result does not depend on the order in which blocks run: two runs
// on the same inputs give the same bits (training restarts rely on it).
//
// What bounds it on the H100: operations.  At the training shape (B*H = 32,
// T = 2048, hd = 128, causal) the five products a backward needs come to
// 5 * 2 * 32 * 2048^2 / 2 * 128 = 86 GFLOP (0.087 ms at the bf16 tensor-core
// rate); the two programs do seven (s and dp are recomputed by both:
// 0.122 ms).  Two builds, one per input type:
//
//   * bfloat16 (the training path): all seven products on the tensor cores,
//     mma.sync m16n8k16 with bf16 operands and float32 accumulators in
//     registers (flash_tiles.cuh); a block of 2 * block threads owns
//     `block` rows, a warp 16 of them (block_q == block_k).
//       dq: the warp's q and do rows are A fragments in registers, loaded
//       once, with their lse and delta; k and v arrive through a two-slot
//       ring of shared tiles filled by 16-byte cp.async copies, one barrier
//       a key block.  Per 32 keys: s = q k^T and dp = do v^T into registers
//       (k's and v's B fragments by ldmatrix), p = exp(s - lse) (masked only
//       in a block that holds the diagonal or the ragged end), ds = p (dp -
//       delta), ds's C fragments repacked as bf16 A fragments for dq += ds k
//       (k's B fragments by ldmatrix.trans).
//       dk/dv: the warp's k rows are A fragments in registers; its v rows
//       stay in a shared tile read by ldmatrix (holding them too would
//       take the registers past 255 at hd 128); q, do and their rows' lse
//       and delta arrive through the ring.  Per 16 queries: s^T = k q^T and
//       dp^T = v do^T, p^T and ds^T in registers, repacked as A fragments
//       for dv += p^T do and dk += ds^T q (do's and q's B fragments by
//       ldmatrix.trans): no transposed copy of anything.
//     Templates for hd 32, 64, 96, 128 and 192.  At hd 192 the fragments
//     and accumulators above pass 255 registers, so that build changes two
//     things (WIDE_HD): dq keeps its do rows in a shared tile staged once
//     (A fragments by ldmatrix) and only q's in registers; and the dk/dv
//     program is split in two halves of one grid, dv blocks and dk blocks,
//     each recomputing p (the dk half also dp and ds) and keeping one
//     accumulator of 96 floats a thread.
//   * float32 (the parity path): the float32 parity gate (2e-4) rules out
//     TF32, so it stays on the CUDA cores in float32.  Each product runs as
//     4 x 4 register micro-tiles fed from transposed shared-memory tiles: the
//     score pass computes s and dp of one micro-tile together (16 loads per
//     32 FMAs) and turns them into p and ds in registers; the accumulation
//     pass walks the tile's rows (dq) or keys (dk, dv) with 16 loads per 32
//     FMAs.  One padding word per transposed row keeps the strided reads of
//     a warp on 32 banks.  Shared memory is its constraint: at hd 128 the
//     dkv program holds k, v, q and do transposed, p and ds, and both
//     accumulators, all float32 (see smem_floats_dkv); 64 x 64 blocks would
//     need 232,448 bytes, all the card gives a block, so its launch point
//     takes 32 query rows.
//
// Heads fold into the grid through the (batch, seq, head) strides of every
// tensor, as in B3.  Ragged edges are masked: T need not be a multiple of a
// block.
//
// Plain C interface: flash_attention_bwd_{dq,dkv}_{f32,bf16} launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr int MAX_THREADS = 512;

using flash::bf16;

struct Strides {            // element strides of a (B, T, H, hd) view
    int64_t b, t, h;
};

struct AllStrides {         // q, k, v, do, dq, dk, dv
    Strides q, k, v, d, dq, dk, dv;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
    return __float2bfloat16(x);
}

// Shared memory, in floats, of the two programs (must match the
// Python-side kernel.smem_bytes_bwd).
__host__ __device__ inline int64_t smem_floats_dq(int bq, int bk, int hd) {
    return 2LL * hd * (bq + 1)          // qt (scaled q), dt (do): transposed
         + 2LL * hd * (bk + 1)          // kt, vt: transposed
         + (int64_t)bq * (bk + 1)       // ds
         + (int64_t)bq * hd             // dq accumulator
         + 2LL * bq;                    // lse, delta
}

__host__ __device__ inline int64_t smem_floats_dkv(int bq, int bk, int hd) {
    return 2LL * hd * (bk + 1)          // kt, vt: transposed
         + 2LL * hd * (bq + 1)          // qt (scaled q), dt (do): transposed
         + 2LL * bq * (bk + 1)          // p, ds
         + 2LL * bk * hd                // dk, dv accumulators
         + 2LL * bq;                    // lse, delta
}

// Stage rows [t0, t0 + rows) of a (T, hd) slice, transposed, into
// dst[d * ld + i], times `mul`; rows past `t_end` are zero.
template <typename T>
__device__ __forceinline__ void stage_t(float* dst, int ld, const T* src,
                                        int64_t stride_t, int t0, int rows,
                                        int t_end, int hd, float mul) {
    for (int e = threadIdx.x; e < rows * hd; e += blockDim.x) {
        const int i = e / hd, d = e - i * hd;
        const int t = t0 + i;
        dst[d * ld + i] = t < t_end ? to_f32(src[(int64_t)t * stride_t + d]) * mul
                                    : 0.f;
    }
}

// The score pass shared by both programs: for each 4 x 4 micro-tile of the
// (bq, bk) block, s = qt^T kt and dp = dt^T vt over hd, then
// p = exp(s - lse) (0 where masked) and ds = p * (dp - delta).  Writes ds,
// and p too when `ps` is not null.
__device__ __forceinline__ void score_pass(const float* qt, const float* dt,
                                           const float* kt, const float* vt,
                                           const float* lse_s, const float* dl_s,
                                           float* ps, float* ds, int bq, int bk,
                                           int hd, int q0, int k0, int tq, int tk,
                                           int causal, int q_offset) {
    const int ldq = bq + 1, ldk = bk + 1;
    const int tiles_i = bq / 4, tiles_j = bk / 4;
    for (int tile = threadIdx.x; tile < tiles_i * tiles_j; tile += blockDim.x) {
        const int ti = tile / tiles_j, tj = tile - ti * tiles_j;
        float s[4][4] = {}, dp[4][4] = {};
        for (int d = 0; d < hd; ++d) {
            const float* qrow = qt + d * ldq + ti;
            const float* drow = dt + d * ldq + ti;
            const float* krow = kt + d * ldk + tj;
            const float* vrow = vt + d * ldk + tj;
            float qv[4], dv[4], kv[4], vv[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                qv[r] = qrow[r * tiles_i];
                dv[r] = drow[r * tiles_i];
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                kv[c] = krow[c * tiles_j];
                vv[c] = vrow[c * tiles_j];
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
                    dp[r][c] = fmaf(dv[r], vv[c], dp[r][c]);
                }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int i = ti + r * tiles_i;
            const int qpos = q_offset + q0 + i;
            const float lse_i = lse_s[i], delta_i = dl_s[i];
            const bool row_in = q0 + i < tq;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = tj + c * tiles_j;
                const int kpos = k0 + j;
                const bool ok = row_in && kpos < tk && (!causal || qpos >= kpos);
                const float p = ok ? expf(s[r][c] - lse_i) : 0.f;
                if (ps != nullptr) ps[i * ldk + j] = p;
                ds[i * ldk + j] = p * (dp[r][c] - delta_i);
            }
        }
    }
}

// Load lse and delta of query rows [q0, q0 + bq) of head `bh` (0 past tq).
__device__ __forceinline__ void stage_rows(float* lse_s, float* dl_s,
                                           const float* lse, const float* delta,
                                           int bh, int q0, int bq, int tq) {
    for (int i = threadIdx.x; i < bq; i += blockDim.x) {
        const int t = q0 + i;
        const bool in = t < tq;
        lse_s[i] = in ? lse[(int64_t)bh * tq + t] : 0.f;
        dl_s[i] = in ? delta[(int64_t)bh * tq + t] : 0.f;
    }
}

// ---------------------------------------------------------------------------
// dq program

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, AllStrides st, int n_bh, int n_heads,
                    int tq, int tk, int hd, int bq, int bk, int causal,
                    int q_offset, float scale) {
    extern __shared__ float smem[];
    const int ldq = bq + 1, ldk = bk + 1;
    float* qt = smem;
    float* dt = qt + (size_t)hd * ldq;
    float* kt = dt + (size_t)hd * ldq;
    float* vt = kt + (size_t)hd * ldk;
    float* ds = vt + (size_t)hd * ldk;
    float* acc = ds + (size_t)bq * ldk;
    float* lse_s = acc + (size_t)bq * hd;
    float* dl_s = lse_s + bq;

    // heaviest query blocks (the most key blocks under the diagonal) first
    const int n_qb = (tq + bq - 1) / bq;
    const int bh = (int)(blockIdx.x % n_bh);
    const int qb = n_qb - 1 - (int)(blockIdx.x / n_bh);
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int q0 = qb * bq;
    const int tid = threadIdx.x, nt = blockDim.x;

    stage_t(qt, ldq, q + b * st.q.b + h * st.q.h, st.q.t, q0, bq, tq, hd, scale);
    stage_t(dt, ldq, dout + b * st.d.b + h * st.d.h, st.d.t, q0, bq, tq, hd, 1.f);
    stage_rows(lse_s, dl_s, lse, delta, bh, q0, bq, tq);
    for (int e = tid; e < bq * hd; e += nt) acc[e] = 0.f;

    int n_kb = (tk + bk - 1) / bk;
    if (causal) {
        const int last_q = q_offset + min(q0 + bq, tq) - 1;
        n_kb = min(n_kb, last_q / bk + 1);
    }
    const T* kg = k + b * st.k.b + h * st.k.h;
    const T* vg = v + b * st.v.b + h * st.v.h;
    const int tiles_i = bq / 4, tiles_d = hd / 4;

    for (int kb = 0; kb < n_kb; ++kb) {
        const int k0 = kb * bk;
        __syncthreads();            // the previous block's readers are done
        stage_t(kt, ldk, kg, st.k.t, k0, bk, tk, hd, 1.f);
        stage_t(vt, ldk, vg, st.v.t, k0, bk, tk, hd, 1.f);
        __syncthreads();
        score_pass(qt, dt, kt, vt, lse_s, dl_s, nullptr, ds, bq, bk, hd, q0, k0,
                   tq, tk, causal, q_offset);
        __syncthreads();

        // acc += ds @ k: 4 x 4 micro-tiles over (row, d)
        for (int tile = tid; tile < tiles_i * tiles_d; tile += nt) {
            const int ti = tile / tiles_d, td = tile - ti * tiles_d;
            float a[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    a[r][c] = acc[(ti + r * tiles_i) * hd + td + c * tiles_d];
            for (int j = 0; j < bk; ++j) {
                float dsv[4], kv[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) dsv[r] = ds[(ti + r * tiles_i) * ldk + j];
#pragma unroll
                for (int c = 0; c < 4; ++c) kv[c] = kt[(td + c * tiles_d) * ldk + j];
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) a[r][c] = fmaf(dsv[r], kv[c], a[r][c]);
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    acc[(ti + r * tiles_i) * hd + td + c * tiles_d] = a[r][c];
        }
    }
    __syncthreads();

    T* dqg = dq + b * st.dq.b + h * st.dq.h;
    for (int e = tid; e < bq * hd; e += nt) {
        const int i = e / hd, d = e - i * hd;
        const int t = q0 + i;
        if (t < tq) dqg[(int64_t)t * st.dq.t + d] = from_f32<T>(acc[e] * scale);
    }
}

// ---------------------------------------------------------------------------
// dk/dv program

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, AllStrides st,
                     int n_bh, int n_heads, int tq, int tk, int hd, int bq,
                     int bk, int causal, int q_offset, float scale) {
    extern __shared__ float smem[];
    const int ldq = bq + 1, ldk = bk + 1;
    float* kt = smem;
    float* vt = kt + (size_t)hd * ldk;
    float* qt = vt + (size_t)hd * ldk;
    float* dt = qt + (size_t)hd * ldq;
    float* ps = dt + (size_t)hd * ldq;
    float* ds = ps + (size_t)bq * ldk;
    float* dka = ds + (size_t)bq * ldk;
    float* dva = dka + (size_t)bk * hd;
    float* lse_s = dva + (size_t)bk * hd;
    float* dl_s = lse_s + bq;

    // heaviest key blocks (the most query blocks under the diagonal) first
    const int bh = (int)(blockIdx.x % n_bh);
    const int kb = (int)(blockIdx.x / n_bh);
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int k0 = kb * bk;
    const int tid = threadIdx.x, nt = blockDim.x;

    stage_t(kt, ldk, k + b * st.k.b + h * st.k.h, st.k.t, k0, bk, tk, hd, 1.f);
    stage_t(vt, ldk, v + b * st.v.b + h * st.v.h, st.v.t, k0, bk, tk, hd, 1.f);
    for (int e = tid; e < bk * hd; e += nt) {
        dka[e] = 0.f;
        dva[e] = 0.f;
    }

    // the first query block with a row at or past the diagonal of key k0
    const int n_qb = (tq + bq - 1) / bq;
    int qb0 = 0;
    if (causal && k0 - q_offset > 0) qb0 = (k0 - q_offset) / bq;
    const T* qg = q + b * st.q.b + h * st.q.h;
    const T* dg = dout + b * st.d.b + h * st.d.h;
    const int tiles_j = bk / 4, tiles_d = hd / 4;

    for (int qb = qb0; qb < n_qb; ++qb) {
        const int q0 = qb * bq;
        __syncthreads();            // the previous block's readers are done
        stage_t(qt, ldq, qg, st.q.t, q0, bq, tq, hd, scale);
        stage_t(dt, ldq, dg, st.d.t, q0, bq, tq, hd, 1.f);
        stage_rows(lse_s, dl_s, lse, delta, bh, q0, bq, tq);
        __syncthreads();
        score_pass(qt, dt, kt, vt, lse_s, dl_s, ps, ds, bq, bk, hd, q0, k0,
                   tq, tk, causal, q_offset);
        __syncthreads();

        // dv += p^T @ do, dk += ds^T @ (scale * q): micro-tiles over (key, d)
        for (int tile = tid; tile < tiles_j * tiles_d; tile += nt) {
            const int tj = tile / tiles_d, td = tile - tj * tiles_d;
            float ak[4][4], av[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int at = (tj + r * tiles_j) * hd + td + c * tiles_d;
                    ak[r][c] = dka[at];
                    av[r][c] = dva[at];
                }
            for (int i = 0; i < bq; ++i) {
                float pv[4], dsv[4], qv[4], dov[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    pv[r] = ps[i * ldk + tj + r * tiles_j];
                    dsv[r] = ds[i * ldk + tj + r * tiles_j];
                }
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    qv[c] = qt[(td + c * tiles_d) * ldq + i];
                    dov[c] = dt[(td + c * tiles_d) * ldq + i];
                }
#pragma unroll
                for (int r = 0; r < 4; ++r)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        av[r][c] = fmaf(pv[r], dov[c], av[r][c]);
                        ak[r][c] = fmaf(dsv[r], qv[c], ak[r][c]);
                    }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int at = (tj + r * tiles_j) * hd + td + c * tiles_d;
                    dka[at] = ak[r][c];
                    dva[at] = av[r][c];
                }
        }
    }
    __syncthreads();

    T* dkg = dk + b * st.dk.b + h * st.dk.h;
    T* dvg = dv + b * st.dv.b + h * st.dv.h;
    for (int e = tid; e < bk * hd; e += nt) {
        const int j = e / hd, d = e - j * hd;
        const int t = k0 + j;
        if (t < tk) {
            dkg[(int64_t)t * st.dk.t + d] = from_f32<T>(dka[e]);
            dvg[(int64_t)t * st.dv.t + d] = from_f32<T>(dva[e]);
        }
    }
}

AllStrides unpack(const int64_t* s) {
    AllStrides st;
    Strides* dst[7] = {&st.q, &st.k, &st.v, &st.d, &st.dq, &st.dk, &st.dv};
    for (int i = 0; i < 7; ++i) *dst[i] = Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
    return st;
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const int64_t* strides, int batch, int n_heads, int tq, int tk,
              int hd, int bq, int bk, int threads, int causal, int q_offset,
              float scale, void* stream) {
    if (batch <= 0 || n_heads <= 0 || tq <= 0) return 0;
    const size_t smem = (size_t)smem_floats_dq(bq, bk, hd) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_bh = batch * n_heads;
    const int64_t blocks = (int64_t)n_bh * ((tq + bq - 1) / bq);
    flash_bwd_dq_kernel<T><<<(unsigned)blocks, threads, smem,
                             (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dq, unpack(strides), n_bh,
        n_heads, tq, tk, hd, bq, bk, causal, q_offset, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const int64_t* strides, int batch, int n_heads, int tq, int tk,
               int hd, int bq, int bk, int threads, int causal, int q_offset,
               float scale, void* stream) {
    if (batch <= 0 || n_heads <= 0 || tk <= 0) return 0;
    const size_t smem = (size_t)smem_floats_dkv(bq, bk, hd) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int n_bh = batch * n_heads;
    const int64_t blocks = (int64_t)n_bh * ((tk + bk - 1) / bk);
    flash_bwd_dkv_kernel<T><<<(unsigned)blocks, threads, smem,
                              (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
        (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
        unpack(strides), n_bh, n_heads, tq, tk, hd, bq, bk, causal, q_offset,
        scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16: both programs on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 accumulators in registers; flash_tiles.cuh)

// A warp owns 16 rows (dq: query rows; dk/dv: keys), so a block of
// 2 * block threads owns `block` rows; 8 warps fill the register file.
constexpr int MMA_MAX_THREADS = 256;
constexpr int DQ_KSUB = 32;       // keys whose s and dp a dq warp holds at once
// above this head_dim dq stages do and dk/dv is split in two (see the top)
constexpr int WIDE_HD = 128;

__host__ __device__ inline int64_t pitch(int hd) { return hd + 8; }

// Shared memory, in bytes, of the two bf16 programs (must match the
// Python-side kernel.smem_bytes_bwd): dq, a two-slot ring of k and v
// tiles (above WIDE_HD also the block's do rows); dk/dv, the block's v
// tile (read as A fragments) and a two-slot ring of q and do tiles with
// their rows' lse and delta.
__host__ __device__ inline int64_t smem_bytes_dq_bf16(int bq, int bk, int hd) {
    return 2LL * 2 * bk * pitch(hd) * (int64_t)sizeof(bf16)
         + (hd > WIDE_HD ? (int64_t)bq * pitch(hd) * sizeof(bf16) : 0);
}

__host__ __device__ inline int64_t smem_bytes_dkv_bf16(int bq, int bk, int hd) {
    return (int64_t)bk * pitch(hd) * sizeof(bf16)
         + 2LL * (2LL * bq * pitch(hd) * sizeof(bf16) + 2LL * bq * sizeof(float));
}

template <int HD>
__global__ void __launch_bounds__(MMA_MAX_THREADS)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dq,
                         AllStrides st, int n_bh, int n_heads, int tq, int tk,
                         int bq, int bk, int causal, int q_offset, float scale) {
    using namespace flash;
    constexpr int KT = HD / 16, DT = HD / 8, LD = HD + 8, NS = DQ_KSUB / 8;
    constexpr bool DO_SMEM = HD > WIDE_HD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // 2 x (k, v) tiles
    const int tile = bk * LD;
    bf16* dos = ring + 4 * tile;                      // DO_SMEM: bq x LD

    // heaviest query blocks (the most key blocks under the diagonal) first
    const int n_qb = (tq + bq - 1) / bq;
    const int bh = (int)(blockIdx.x % n_bh);
    const int qb = n_qb - 1 - (int)(blockIdx.x / n_bh);
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int q0 = qb * bq;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = q0 + 16 * warp;
    const bool live = r0 < tq;
    const int row0 = r0 + g, row1 = row0 + 8;

    uint32_t qf[KT][4], df[DO_SMEM ? 1 : KT][4];
    load_a_rows<HD>(qf, q + b * st.q.b + h * st.q.h, st.q.t, r0, tq, lane);
    if constexpr (DO_SMEM)
        stage_rows_async<HD>(dos, dout + b * st.d.b + h * st.d.h, st.d.t, q0,
                             bq, tq);   // lands with the ring's first group
    else
        load_a_rows<HD>(df, dout + b * st.d.b + h * st.d.h, st.d.t, r0, tq, lane);
    const float* lse_h = lse + (int64_t)bh * tq;
    const float* dl_h = delta + (int64_t)bh * tq;
    const float lse0 = row0 < tq ? lse_h[row0] * LOG2E : 0.f;
    const float lse1 = row1 < tq ? lse_h[row1] * LOG2E : 0.f;
    const float dl0 = row0 < tq ? dl_h[row0] : 0.f;
    const float dl1 = row1 < tq ? dl_h[row1] : 0.f;
    float acc[DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    const float sl2 = scale * LOG2E;
    const int qpos0 = q_offset + row0, qpos1 = qpos0 + 8;
    const int warp_first = q_offset + r0, warp_last = warp_first + 15;
    const int b_off = nt_offset(lane, LD), t_off = kn_offset(lane, LD);

    int n_kb = (tk + bk - 1) / bk;
    if (causal) {
        const int last_q = q_offset + min(q0 + bq, tq) - 1;
        n_kb = min(n_kb, last_q / bk + 1);
    }
    const bf16* kg = k + b * st.k.b + h * st.k.h;
    const bf16* vg = v + b * st.v.b + h * st.v.h;
    auto load = [&](int kb, int slot) {
        bf16* ks = ring + (size_t)slot * 2 * tile;
        stage_rows_async<HD>(ks, kg, st.k.t, kb * bk, bk, tk);
        stage_rows_async<HD>(ks + tile, vg, st.v.t, kb * bk, bk, tk);
    };

    if (n_kb > 0) load(0, 0);
    cp_async_commit();
    for (int kb = 0; kb < n_kb; ++kb) {
        cp_async_wait<0>();
        __syncthreads();            // block kb landed; slot kb - 1 is free
        if (kb + 1 < n_kb) load(kb + 1, (kb + 1) & 1);
        cp_async_commit();
        if (!live) continue;
        const bf16* ks = ring + (size_t)(kb & 1) * 2 * tile;
        const bf16* vs = ks + tile;
        const int k0 = kb * bk;

        for (int c0 = 0; c0 < bk; c0 += DQ_KSUB) {
            const int kbase = k0 + c0;
            if (kbase >= tk || (causal && kbase > warp_last)) break;
            // the sub-tile's n8 tiles as a constant: no guard in the products
            for_even<NS>(min(DQ_KSUB, bk - c0) / 8, [&](auto tiles) {
            constexpr int NN = decltype(tiles)::value;
            float s[NN][4], dp[NN][4];
#pragma unroll
            for (int n = 0; n < NN; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
            // s = q k^T, dp = do v^T
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                uint32_t da[4];
                if constexpr (DO_SMEM) {
                    ldsm_x4(da, dos + 16 * warp * LD + kk * 16 + t_off);
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) da[e] = df[kk][e];
                }
#pragma unroll
                for (int np = 0; np < NN / 2; ++np) {
                    uint32_t bb[4];
                    ldsm_x4(bb, ks + (c0 + 16 * np) * LD + kk * 16 + b_off);
                    mma(s[2 * np], qf[kk], bb[0], bb[1]);
                    mma(s[2 * np + 1], qf[kk], bb[2], bb[3]);
                    ldsm_x4(bb, vs + (c0 + 16 * np) * LD + kk * 16 + b_off);
                    mma(dp[2 * np], da, bb[0], bb[1]);
                    mma(dp[2 * np + 1], da, bb[2], bb[3]);
                }
            }
            // p = exp(s - lse) (0 where masked), ds = p (dp - delta), in place
            const bool edge = kbase + 8 * NN > tk
                           || (causal && kbase + 8 * NN - 1 > warp_first);
#pragma unroll
            for (int n = 0; n < NN; ++n) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool hi = e >= 2;
                    float p = ex2(fmaf(s[n][e], sl2, -(hi ? lse1 : lse0)));
                    if (edge) {
                        const int key = kbase + 8 * n + 2 * t4 + (e & 1);
                        if (key >= tk || (causal && key > (hi ? qpos1 : qpos0)))
                            p = 0.f;
                    }
                    s[n][e] = p * (dp[n][e] - (hi ? dl1 : dl0));
                }
            }
            // acc += ds k: ds's C fragments are the A fragments, k through
            // ldmatrix.trans
#pragma unroll
            for (int j = 0; j < NN / 2; ++j) {
                uint32_t a[4];
                c_to_a(a, s[2 * j], s[2 * j + 1]);
                const bf16* krow = ks + (c0 + 16 * j) * LD + t_off;
#pragma unroll
                for (int d2 = 0; d2 < DT / 2; ++d2) {
                    uint32_t bb[4];
                    ldsm_x4_t(bb, krow + 16 * d2);
                    mma(acc[2 * d2], a, bb[0], bb[1]);
                    mma(acc[2 * d2 + 1], a, bb[2], bb[3]);
                }
            }
            });
        }
    }
    cp_async_wait<0>();

    bf16* dqg = dq + b * st.dq.b + h * st.dq.h;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
        const int d = 8 * n + 2 * t4;
        if (row0 < tq)
            *reinterpret_cast<uint32_t*>(dqg + (int64_t)row0 * st.dq.t + d) =
                pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
        if (row1 < tq)
            *reinterpret_cast<uint32_t*>(dqg + (int64_t)row1 * st.dq.t + d) =
                pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
    }
}

template <int HD>
__global__ void __launch_bounds__(MMA_MAX_THREADS)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, AllStrides st, int n_bh,
                          int n_heads, int tq, int tk, int bq, int bk,
                          int causal, int q_offset, float scale) {
    using namespace flash;
    constexpr int KT = HD / 16, DT = HD / 8, LD = HD + 8;
    // above WIDE_HD the grid's blocks alternate: dv (part 0), dk (part 1),
    // each with one accumulator (dka); below, a block computes both
    constexpr bool SPLIT = HD > WIDE_HD;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* vs = reinterpret_cast<bf16*>(smem_raw);          // bk x LD
    unsigned char* ring = smem_raw + (size_t)bk * LD * sizeof(bf16);
    const size_t slot_bytes = 2 * (size_t)bq * LD * sizeof(bf16)
                            + 2 * (size_t)bq * sizeof(float);

    // heaviest key blocks (the most query blocks under the diagonal) first
    const int part = SPLIT ? (int)(blockIdx.x & 1) : 1;
    const int block = SPLIT ? (int)(blockIdx.x >> 1) : (int)blockIdx.x;
    const bool want_dp = !SPLIT || part == 1;    // dk needs dp and ds
    const int bh = block % n_bh;
    const int kb = block / n_bh;
    const int b = bh / n_heads, h = bh - b * n_heads;
    const int k0 = kb * bk;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t4 = lane & 3;
    const int kr0 = k0 + 16 * warp;              // the warp's first key
    const bool live = kr0 < tk;
    const int key0 = kr0 + g, key1 = key0 + 8;

    // the block's v rows for dp^T = v do^T (A fragments by ldmatrix), the
    // warp's k rows as A fragments in registers
    if (want_dp)
        stage_rows_async<HD>(vs, v + b * st.v.b + h * st.v.h, st.v.t, k0, bk, tk);
    uint32_t kf[KT][4];
    load_a_rows<HD>(kf, k + b * st.k.b + h * st.k.h, st.k.t, kr0, tk, lane);
    float dka[DT][4], dva[SPLIT ? 1 : DT][4];
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < (SPLIT ? 1 : DT); ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[n][e] = 0.f;
    const float sl2 = scale * LOG2E;
    const int b_off = nt_offset(lane, LD), t_off = kn_offset(lane, LD);

    // the first query block with a row at or past the diagonal of key k0
    const int n_qb = (tq + bq - 1) / bq;
    int qb0 = 0;
    if (causal && k0 - q_offset > 0) qb0 = min((k0 - q_offset) / bq, n_qb);
    const bf16* qg = q + b * st.q.b + h * st.q.h;
    const bf16* dg = dout + b * st.d.b + h * st.d.h;
    const float* lse_h = lse + (int64_t)bh * tq;
    const float* dl_h = delta + (int64_t)bh * tq;
    auto slot_of = [&](int i) { return ring + (size_t)i * slot_bytes; };
    auto load = [&](int qb, int slot) {
        unsigned char* base = slot_of(slot);
        bf16* qs = reinterpret_cast<bf16*>(base);
        bf16* dos = qs + (size_t)bq * LD;
        float* ls = reinterpret_cast<float*>(dos + (size_t)bq * LD);
        const int t0 = qb * bq;
        stage_rows_async<HD>(qs, qg, st.q.t, t0, bq, tq);
        stage_rows_async<HD>(dos, dg, st.d.t, t0, bq, tq);
        for (int i = threadIdx.x; i < bq; i += blockDim.x) {
            const bool in = t0 + i < tq;
            const int t = in ? t0 + i : 0;
            cp_async4(ls + i, lse_h + t, in);
            cp_async4(ls + bq + i, dl_h + t, in);
        }
    };

    if (qb0 < n_qb) load(qb0, 0);
    cp_async_commit();
    for (int qb = qb0; qb < n_qb; ++qb) {
        const int it = qb - qb0;
        cp_async_wait<0>();
        __syncthreads();            // block qb (and v) landed; the other slot is free
        if (qb + 1 < n_qb) load(qb + 1, (it + 1) & 1);
        cp_async_commit();
        if (!live) continue;
        const unsigned char* base = slot_of(it & 1);
        const bf16* qs = reinterpret_cast<const bf16*>(base);
        const bf16* dos = qs + (size_t)bq * LD;
        const float* ls = reinterpret_cast<const float*>(dos + (size_t)bq * LD);
        const float* dls = ls + bq;
        const int q0 = qb * bq;

        for (int c0 = 0; c0 < bq; c0 += 16) {
            const int qbase = q0 + c0;
            if (qbase >= tq) break;
            if (causal && q_offset + qbase + 15 < kr0) continue;
            // s^T = k q^T, dp^T = v do^T: 16 keys x 16 queries
            float s[2][4], dp[2][4];
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
                uint32_t bb[4], va[4];
                ldsm_x4(bb, qs + c0 * LD + kk * 16 + b_off);
                mma(s[0], kf[kk], bb[0], bb[1]);
                mma(s[1], kf[kk], bb[2], bb[3]);
                if (want_dp) {
                    ldsm_x4(va, vs + 16 * warp * LD + kk * 16 + t_off);
                    ldsm_x4(bb, dos + c0 * LD + kk * 16 + b_off);
                    mma(dp[0], va, bb[0], bb[1]);
                    mma(dp[1], va, bb[2], bb[3]);
                }
            }
            // p^T = exp(s^T - lse) (0 where masked), ds^T = p^T (dp^T - delta)
            const bool edge = qbase + 16 > tq || kr0 + 16 > tk
                           || (causal && q_offset + qbase < kr0 + 15);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
                const int qi = c0 + 8 * n + 2 * t4;       // within the tile
                const float2 lv = *reinterpret_cast<const float2*>(ls + qi);
                const float2 dl = *reinterpret_cast<const float2*>(dls + qi);
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool odd = e & 1;
                    float p = ex2(fmaf(s[n][e], sl2, -(odd ? lv.y : lv.x) * LOG2E));
                    if (edge) {
                        const int query = q0 + qi + odd;
                        const int key = e < 2 ? key0 : key1;
                        if (query >= tq || key >= tk
                            || (causal && q_offset + query < key))
                            p = 0.f;
                    }
                    dp[n][e] = p * (dp[n][e] - (odd ? dl.y : dl.x));
                    s[n][e] = p;
                }
            }
            // dv += p^T do, dk += ds^T q: do and q through ldmatrix.trans
            const bf16* drow = dos + c0 * LD + t_off;
            const bf16* qrow = qs + c0 * LD + t_off;
            if constexpr (SPLIT) {
                // the block's one product: p^T do (dv) or ds^T q (dk)
                uint32_t a[4];
                if (part) c_to_a(a, dp[0], dp[1]);
                else c_to_a(a, s[0], s[1]);
                const bf16* brow = part ? qrow : drow;
#pragma unroll
                for (int d2 = 0; d2 < DT / 2; ++d2) {
                    uint32_t bb[4];
                    ldsm_x4_t(bb, brow + 16 * d2);
                    mma(dka[2 * d2], a, bb[0], bb[1]);
                    mma(dka[2 * d2 + 1], a, bb[2], bb[3]);
                }
            } else {
                uint32_t pa[4], sa[4];
                c_to_a(pa, s[0], s[1]);
                c_to_a(sa, dp[0], dp[1]);
#pragma unroll
                for (int d2 = 0; d2 < DT / 2; ++d2) {
                    uint32_t bb[4];
                    ldsm_x4_t(bb, drow + 16 * d2);
                    mma(dva[2 * d2], pa, bb[0], bb[1]);
                    mma(dva[2 * d2 + 1], pa, bb[2], bb[3]);
                    ldsm_x4_t(bb, qrow + 16 * d2);
                    mma(dka[2 * d2], sa, bb[0], bb[1]);
                    mma(dka[2 * d2 + 1], sa, bb[2], bb[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

    bf16* dkg = dk + b * st.dk.b + h * st.dk.h;
    bf16* dvg = dv + b * st.dv.b + h * st.dv.h;
    if constexpr (SPLIT) {
        // part 1 holds dk (scaled), part 0 dv
        bf16* og = part ? dkg : dvg;
        const int64_t ot = part ? st.dk.t : st.dv.t;
        const float sc = part ? scale : 1.f;
#pragma unroll
        for (int n = 0; n < DT; ++n) {
            const int d = 8 * n + 2 * t4;
            if (key0 < tk)
                *reinterpret_cast<uint32_t*>(og + (int64_t)key0 * ot + d) =
                    pack_bf16(dka[n][0] * sc, dka[n][1] * sc);
            if (key1 < tk)
                *reinterpret_cast<uint32_t*>(og + (int64_t)key1 * ot + d) =
                    pack_bf16(dka[n][2] * sc, dka[n][3] * sc);
        }
        return;
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
        const int d = 8 * n + 2 * t4;
        if (key0 < tk) {
            *reinterpret_cast<uint32_t*>(dkg + (int64_t)key0 * st.dk.t + d) =
                pack_bf16(dka[n][0] * scale, dka[n][1] * scale);
            *reinterpret_cast<uint32_t*>(dvg + (int64_t)key0 * st.dv.t + d) =
                pack_bf16(dva[n][0], dva[n][1]);
        }
        if (key1 < tk) {
            *reinterpret_cast<uint32_t*>(dkg + (int64_t)key1 * st.dk.t + d) =
                pack_bf16(dka[n][2] * scale, dka[n][3] * scale);
            *reinterpret_cast<uint32_t*>(dvg + (int64_t)key1 * st.dv.t + d) =
                pack_bf16(dva[n][2], dva[n][3]);
        }
    }
}


template <int HD>
int launch_bf16_hd(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, const int64_t* strides,
                   int batch, int n_heads, int tq, int tk, int bq, int bk,
                   int causal, int q_offset, float scale, void* stream) {
    const int n_bh = batch * n_heads;
    const AllStrides st = unpack(strides);
    if (dq != nullptr) {
        const size_t smem = (size_t)smem_bytes_dq_bf16(bq, bk, HD);
        cudaError_t err = cudaFuncSetAttribute(
            flash_bwd_dq_bf16_kernel<HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        const int64_t blocks = (int64_t)n_bh * ((tq + bq - 1) / bq);
        flash_bwd_dq_bf16_kernel<HD><<<(unsigned)blocks, 2 * bq, smem,
                                       (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
            (const float*)lse, (const float*)delta, (bf16*)dq, st, n_bh,
            n_heads, tq, tk, bq, bk, causal, q_offset, scale);
    } else {
        const size_t smem = (size_t)smem_bytes_dkv_bf16(bq, bk, HD);
        cudaError_t err = cudaFuncSetAttribute(
            flash_bwd_dkv_bf16_kernel<HD>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        const int64_t blocks = (int64_t)n_bh * ((tk + bk - 1) / bk)
                             * (HD > WIDE_HD ? 2 : 1);
        flash_bwd_dkv_bf16_kernel<HD><<<(unsigned)blocks, 2 * bk, smem,
                                        (cudaStream_t)stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
            (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, st,
            n_bh, n_heads, tq, tk, bq, bk, causal, q_offset, scale);
    }
    return (int)cudaGetLastError();
}

// One bf16 program: dq when `dq` is given, else dk/dv.
int launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dq, void* dk,
                void* dv, const int64_t* strides, int batch, int n_heads,
                int tq, int tk, int hd, int bq, int bk, int threads,
                int causal, int q_offset, float scale, void* stream) {
    if (batch <= 0 || n_heads <= 0 || tq <= 0 || tk <= 0) return 0;
    if (bq % 16 || bq < 16 || threads != 2 * bq || threads != 2 * bk
        || threads > MMA_MAX_THREADS)
        return (int)cudaErrorInvalidValue;
#define BWD_BF16(HD)                                                          \
    case HD:                                                                  \
        return launch_bf16_hd<HD>(q, k, v, dout, lse, delta, dq, dk, dv,      \
                                  strides, batch, n_heads, tq, tk, bq, bk,    \
                                  causal, q_offset, scale, stream);
    switch (hd) {
        BWD_BF16(32)
        BWD_BF16(64)
        BWD_BF16(96)
        BWD_BF16(128)
        BWD_BF16(192)
        default: return (int)cudaErrorInvalidValue;
    }
#undef BWD_BF16
}

}  // namespace

extern "C" {

// q, do: (B, Tq, H, hd); k, v: (B, Tk, H, hd); dq, dk, dv likewise; all
// views with unit stride along hd.  `strides` holds 21 int64: the (batch,
// seq, head) element strides of q, k, v, do, dq, dk, dv in that order.
// lse and delta: (B, H, Tq) float32, contiguous.  float32: bq, bk and hd
// multiples of 4; threads a multiple of 32 in [32, 512].  bfloat16: bq ==
// bk == threads / 2, a multiple of 16, threads <= 256; hd in {32, 64, 96,
// 128, 192}; every stride a multiple of 8 and every pointer 16-byte aligned.

int flash_attention_bwd_dq_f32(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq,
                               const int64_t* strides, int batch, int n_heads,
                               int tq, int tk, int hd, int bq, int bk,
                               int threads, int causal, int q_offset,
                               float scale, void* stream) {
    return launch_dq<float>(q, k, v, dout, lse, delta, dq, strides, batch,
                            n_heads, tq, tk, hd, bq, bk, threads, causal,
                            q_offset, scale, stream);
}

int flash_attention_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                const int64_t* strides, int batch, int n_heads,
                                int tq, int tk, int hd, int bq, int bk,
                                int threads, int causal, int q_offset,
                                float scale, void* stream) {
    return launch_bf16(q, k, v, dout, lse, delta, dq, nullptr, nullptr,
                       strides, batch, n_heads, tq, tk, hd, bq, bk, threads,
                       causal, q_offset, scale, stream);
}

int flash_attention_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                const int64_t* strides, int batch, int n_heads,
                                int tq, int tk, int hd, int bq, int bk,
                                int threads, int causal, int q_offset,
                                float scale, void* stream) {
    return launch_dkv<float>(q, k, v, dout, lse, delta, dk, dv, strides, batch,
                             n_heads, tq, tk, hd, bq, bk, threads, causal,
                             q_offset, scale, stream);
}

int flash_attention_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 const int64_t* strides, int batch,
                                 int n_heads, int tq, int tk, int hd, int bq,
                                 int bk, int threads, int causal, int q_offset,
                                 float scale, void* stream) {
    return launch_bf16(q, k, v, dout, lse, delta, nullptr, dk, dv, strides,
                       batch, n_heads, tq, tk, hd, bq, bk, threads, causal,
                       q_offset, scale, stream);
}

const char* flash_attention_bwd_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
