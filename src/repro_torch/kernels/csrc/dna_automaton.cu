// Chunk-parallel DFA motif matching over DNA text, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/dna_automaton/kernel.py:
//   state_map_kernel  (_state_map_kernel) -> dna_state_map
//   count_hits_kernel (_count_kernel)     -> dna_count_hits
//
// Both walk the text once, one dependent table lookup per symbol:
//     state = table[state * 4 + sym]
// What bounds them on this card is bytes: the text (T bytes, one byte per
// symbol -- it is never widened on the device) is read once per pass, and
// the table, maps, starts and counts are negligible beside it.  The design
// keeps every lookup out of device memory: the table (S*4 int32, S = motif
// length + 1) is copied to shared memory once per block, and a thread reads
// its chunk 16 bytes at a time, so the only device-memory traffic is the
// text itself.  The TPU grid's sequential walk along a chunk is a loop
// inside the thread; nothing is carried between blocks.
//
//   dna_state_map : one thread per (chunk, start state).  The S threads of a
//                   chunk sit side by side in a warp and read the same text
//                   address (one broadcast load).
//   dna_count_hits: one thread per chunk, from that chunk's true start state.
//                   The accept flag of the state a transition leads to is
//                   packed into bit 16 of the shared-memory entry, so one
//                   lookup per symbol yields the next state and the hit.
//
// All text offsets are 64-bit: a full-size text (3 * 2^30 symbols) is longer
// than 2^31.  Grid-stride loops, so any number of chunks launches.
//
// Contract (checked by the Python wrappers): text uint8 with symbols in
// [0, 4), table int32 (S, 4), accept/starts int32, everything contiguous,
// T a multiple of chunk, S <= 3072.  Table entries and start states outside
// [0, S) are clamped into range when read (the reference's gather clamps
// too), so a bad table cannot read outside shared memory.
//
// Plain C interface: each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SYM = 4;
constexpr int ACCEPT_SHIFT = 16;
constexpr int32_t STATE_MASK = (1 << ACCEPT_SHIFT) - 1;
constexpr int64_t MAX_BLOCKS = 2147483647LL;

__device__ __forceinline__ int32_t clamp_state(int32_t v, int s) {
    return v < 0 ? 0 : (v >= s ? s - 1 : v);
}

__device__ __forceinline__ bool can_vectorise(const uint8_t* text, int64_t chunk) {
    return (chunk % 16 == 0) && (reinterpret_cast<uintptr_t>(text) % 16 == 0);
}

// ---- state map: end state of a chunk for every start state -----------------

__device__ __forceinline__ int32_t walk4(int32_t state, uint32_t word,
                                         const int32_t* tbl) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t sym = (word >> (8 * k)) & 3u;
        state = tbl[state * N_SYM + sym];
    }
    return state;
}

__global__ void state_map_kernel(const uint8_t* __restrict__ text,
                                 const int32_t* __restrict__ table,
                                 int32_t* __restrict__ maps,
                                 int64_t n_chunks, int64_t chunk, int s) {
    extern __shared__ int32_t tbl[];
    for (int i = threadIdx.x; i < s * N_SYM; i += blockDim.x)
        tbl[i] = clamp_state(table[i], s);
    __syncthreads();

    const int64_t total = n_chunks * s;
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const bool vec = can_vectorise(text, chunk);
    for (int64_t item = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         item < total; item += stride) {
        const int64_t c = item / s;
        int32_t state = (int32_t)(item - c * s);
        const uint8_t* p = text + (size_t)c * (size_t)chunk;
        if (vec) {
            const uint4* p16 = reinterpret_cast<const uint4*>(p);
            const int64_t n16 = chunk / 16;
            for (int64_t i = 0; i < n16; ++i) {
                const uint4 v = __ldg(p16 + i);
                state = walk4(state, v.x, tbl);
                state = walk4(state, v.y, tbl);
                state = walk4(state, v.z, tbl);
                state = walk4(state, v.w, tbl);
            }
        } else {
            for (int64_t i = 0; i < chunk; ++i)
                state = tbl[state * N_SYM + (p[i] & 3u)];
        }
        maps[item] = state;
    }
}

// ---- count hits: accepting-state visits of a chunk from its start state ----

__device__ __forceinline__ void count4(int32_t& state, int32_t& hits,
                                       uint32_t word, const int32_t* tbl) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint32_t sym = (word >> (8 * k)) & 3u;
        const int32_t e = tbl[state * N_SYM + sym];
        state = e & STATE_MASK;
        hits += e >> ACCEPT_SHIFT;
    }
}

__global__ void count_hits_kernel(const uint8_t* __restrict__ text,
                                  const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ accept,
                                  const int32_t* __restrict__ starts,
                                  int32_t* __restrict__ counts,
                                  int32_t* __restrict__ ends,
                                  int64_t n_chunks, int64_t chunk, int s) {
    extern __shared__ int32_t tbl[];
    for (int i = threadIdx.x; i < s * N_SYM; i += blockDim.x) {
        const int32_t nxt = clamp_state(table[i], s);
        tbl[i] = nxt | ((accept[nxt] != 0 ? 1 : 0) << ACCEPT_SHIFT);
    }
    __syncthreads();

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const bool vec = can_vectorise(text, chunk);
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         c < n_chunks; c += stride) {
        int32_t state = clamp_state(starts[c], s);
        int32_t hits = 0;
        const uint8_t* p = text + (size_t)c * (size_t)chunk;
        if (vec) {
            const uint4* p16 = reinterpret_cast<const uint4*>(p);
            const int64_t n16 = chunk / 16;
            for (int64_t i = 0; i < n16; ++i) {
                const uint4 v = __ldg(p16 + i);
                count4(state, hits, v.x, tbl);
                count4(state, hits, v.y, tbl);
                count4(state, hits, v.z, tbl);
                count4(state, hits, v.w, tbl);
            }
        } else {
            for (int64_t i = 0; i < chunk; ++i) {
                const int32_t e = tbl[state * N_SYM + (p[i] & 3u)];
                state = e & STATE_MASK;
                hits += e >> ACCEPT_SHIFT;
            }
        }
        counts[c] = hits;
        ends[c] = state;
    }
}

unsigned grid_for(int64_t items, int block_threads) {
    int64_t blocks = (items + block_threads - 1) / block_threads;
    if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
    return (unsigned)blocks;
}

}  // namespace

extern "C" {

int dna_state_map(const void* text, const void* table, void* maps,
                  int64_t n_chunks, int64_t chunk, int s, int block_threads,
                  void* stream) {
    if (n_chunks <= 0) return 0;
    const size_t smem = (size_t)s * N_SYM * sizeof(int32_t);
    state_map_kernel<<<grid_for(n_chunks * s, block_threads), block_threads,
                       smem, (cudaStream_t)stream>>>(
        (const uint8_t*)text, (const int32_t*)table, (int32_t*)maps,
        n_chunks, chunk, s);
    return (int)cudaGetLastError();
}

int dna_count_hits(const void* text, const void* table, const void* accept,
                   const void* starts, void* counts, void* ends,
                   int64_t n_chunks, int64_t chunk, int s, int block_threads,
                   void* stream) {
    if (n_chunks <= 0) return 0;
    const size_t smem = (size_t)s * N_SYM * sizeof(int32_t);
    count_hits_kernel<<<grid_for(n_chunks, block_threads), block_threads,
                        smem, (cudaStream_t)stream>>>(
        (const uint8_t*)text, (const int32_t*)table, (const int32_t*)accept,
        (const int32_t*)starts, (int32_t*)counts, (int32_t*)ends,
        n_chunks, chunk, s);
    return (int)cudaGetLastError();
}

const char* dna_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
