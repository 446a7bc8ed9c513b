// Tile machinery shared by the bfloat16 flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu) on NVIDIA Hopper (sm_90a):
// mma.sync m16n8k16 with bf16 operands and float32 accumulators, ldmatrix
// (plain and transposed) fragment loads from shared memory, and 16-byte
// cp.async copies from device memory into a ring of shared tiles.
//
// Fragment layouts (PTX ISA, "mma.m16n8k16", bf16): with g = lane / 4 and
// t = lane % 4, a thread holds
//   A (16 x 16, row-major):  a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
//                            a3 (g+8, 2t+8..)
//   B (16 x 8, k x n):       b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g)
//   C (16 x 8, float32):     c0, c1 (g, 2t..2t+1), c2, c3 (g+8, 2t..2t+1)
// so the C fragments of two neighbouring n8 tiles, rounded to bf16 in
// pairs, are the A fragment of one k16 step: a product's scores feed the
// next product from registers.
//
// Shared tiles are row-major with a pitch of (width + 8) elements: the
// eight 16-byte rows one ldmatrix matrix reads then fall on 32 distinct
// banks for every width used here (32, 64, 96, 128, 192).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte (or 4-byte) asynchronous copy device -> shared; when `valid` is
// false nothing is read and the destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most n (0..3) of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(int n) {
    switch (n) {
        case 0: cp_async_wait<0>(); break;
        case 1: cp_async_wait<1>(); break;
        case 2: cp_async_wait<2>(); break;
        default: cp_async_wait<3>(); break;
    }
}

// four 8 x 8 bf16 matrices; lane i gives the row address of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)) : "memory");
}

// Lane offsets (in elements, for a tile of pitch ld) of the two ldmatrix
// patterns used:
//  * nt_offset: from a tile T[n][k] (rows = the B operand's n), the B
//    fragments of the n8 tiles n0 and n0 + 8 over k0..k0+15:
//    r = {b0, b1} of n0, then {b0, b1} of n0 + 8 (plain ldmatrix);
//  * kn_offset: from a tile T[k][n] (rows = the B operand's k), the same
//    B fragments through ldmatrix.trans; and, read without .trans from a
//    tile A[m][k], the A fragment of rows m0..m0+15 over k0..k0+15.
__device__ __forceinline__ int nt_offset(int lane, int ld) {
    return ((lane & 7) + ((lane >> 4) << 3)) * ld + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ int kn_offset(int lane, int ld) {
    return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (flushes denormal results to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// two floats as one bf16 pair (lo in the low half, as a fragment holds them)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one k16 step from the C fragments of two n8 tiles.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
    a[0] = pack_bf16(c0[0], c0[1]);
    a[1] = pack_bf16(c0[2], c0[3]);
    a[2] = pack_bf16(c1[0], c1[1]);
    a[3] = pack_bf16(c1[2], c1[3]);
}

// f(std::integral_constant<int, n>) for an even n in [2, N]: a tile's count
// of n8 tiles as a constant, so the unrolled products that walk it carry no
// run-time guard (a guard per mma costs a quarter of the forward's time)
template <int N, typename F>
__device__ __forceinline__ void for_even(int n, F&& f) {
    if constexpr (N >= 2) {
        if (n == N) {
            f(std::integral_constant<int, N>{});
            return;
        }
        for_even<N - 2>(n, f);
    }
}

// A fragments of 16 rows [r0, r0 + 16) of a (T, HD) row-major slice read
// straight from device memory (rows at or past `end` are zero), once per
// block: 4-byte loads, each row's 16 bytes of a k16 step contiguous.
template <int HD>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[HD / 16][4],
                                            const bf16* base, int64_t stride,
                                            int r0, int end, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const int row0 = r0 + g, row1 = r0 + g + 8;
    const bool in0 = row0 < end, in1 = row1 < end;
    const uint32_t* p0 = reinterpret_cast<const uint32_t*>(
        base + (int64_t)(in0 ? row0 : 0) * stride + 2 * t);
    const uint32_t* p1 = reinterpret_cast<const uint32_t*>(
        base + (int64_t)(in1 ? row1 : 0) * stride + 2 * t);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
        a[kk][0] = in0 ? __ldg(p0 + 8 * kk) : 0u;
        a[kk][1] = in1 ? __ldg(p1 + 8 * kk) : 0u;
        a[kk][2] = in0 ? __ldg(p0 + 8 * kk + 4) : 0u;
        a[kk][3] = in1 ? __ldg(p1 + 8 * kk + 4) : 0u;
    }
}

// Stage rows [t0, t0 + rows) of a (T, HD) slice into a shared tile of pitch
// HD + 8 with 16-byte cp.async copies; rows at or past `end` are zero.
template <int HD>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src,
                                                 int64_t stride, int t0,
                                                 int rows, int end) {
    constexpr int CH = HD / 8;            // 16-byte chunks a row
    for (int c = threadIdx.x; c < rows * CH; c += blockDim.x) {
        const int j = c / CH, d = (c - j * CH) * 8;
        const int t = t0 + j;
        const bool in = t < end;
        cp_async16(dst + j * (HD + 8) + d, src + (int64_t)(in ? t : 0) * stride + d,
                   in);
    }
}

}  // namespace flash
