// What the Mamba-1 selective scan's forward (mamba_scan.cu) and backward
// (mamba_scan_bwd.cu) share, for NVIDIA Hopper (sm_90a): the exp as ex2 on
// the SFU, the cp.async copies that stage their operands in shared memory,
// and the butterfly reduce-scatter over the lanes that share a channel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mscan {

constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (flushes what would be subnormal to 0)
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 4- and 16-byte asynchronous copies device -> shared; when `valid` is
// false nothing is read and the destination is filled with zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                    "l"(src), "r"(valid ? 4 : 0));
}

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

}  // namespace mscan
