// Chunk-parallel DFA motif matching over DNA text, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// src/repro/kernels/dna_automaton/kernel.py:
//   state_map_kernel  (_state_map_kernel) -> dna_state_map_vec (S <= 16)
//                                            dna_state_map_gather (S > 16)
//   count_hits_kernel (_count_kernel)     -> dna_count_hits
//
// What bounds them on this card is bytes: the text (T bytes, one byte per
// symbol, never widened on the device) is read once per pass, 0.96 ms at
// T = 3 * 2^30 and 3.35 TB/s.  The design keeps the two other costs, the
// shared-memory accesses and the integer instructions, under that:
//
// * Text staging.  Each warp owns a ring of STAGES slots in shared memory.
//   A slot holds, for each of the warp's 32 walkers, the next ROW = 128
//   bytes of its text (a row padded to PITCH = 144 bytes, nine 16-byte
//   units, so the 16-byte reads of eight neighbouring lanes fall on
//   distinct banks).  The warp fills a slot with 16-byte cp.async copies
//   in which eight neighbouring lanes cover one walker's 128 contiguous
//   bytes, so every line fetched is used whole (64-byte rows left the
//   count kernel 30 % slower: the DRAM serves many walkers' scattered
//   short runs worse than fewer long ones); the next two slots are in flight
//   while a walker walks the current one, and no walker issues a blocking
//   load from device memory.  A walker's text starts at its range's 16-byte
//   aligned origin: a range that starts or ends inside a 16-byte unit (an
//   unaligned text such as text[1:], a chunk that is no multiple of 16)
//   walks that unit one symbol at a time (the head/tail path); every unit
//   wholly inside the range takes the k-gram path below.
// * k-gram tables.  The prologue builds, in shared memory, the table over
//   k = 1, 2 or 4 symbols at once (`gram`, a template parameter) from the
//   (S, 4) table: one lookup then advances k symbols.  The k-gram index g =
//   b0 | b1 << 2 | ... (b0 the first symbol) comes from a 32-bit word of
//   four one-byte symbols with a mask, a multiply and a shift (k = 4).
//
// dna_state_map_vec (S <= 16): a block per map chunk (grid-stride over the
//   chunks: a persistent grid of the blocks the card holds at once).  Each
//   thread walks one contiguous slice of the chunk, 16 * ceil(chunk / (16 *
//   threads)) bytes (the last ones shorter or empty), for all S start
//   states at once: the state vector lives in registers as nibbles, and a
//   step applies the k-gram's column (16 bytes: the next state of every
//   state, one LDS.128) with byte permutes (prmt picks 4 of 8 bytes by the
//   nibbles' low three bits; a nibble with bit 3 set selects through the
//   sign mode, which gives 0 for a state below 128, so states 8-15 take a
//   second permute and an OR), then packs the 4-byte results back into
//   nibbles (shift, or, permute).  Once all S lanes hold one state (a KMP
//   motif automaton forgets its start after len(motif) symbols: range
//   convergence; tested after each 16-byte unit), the walk goes on with
//   that single state, one LDS.U8 per k-gram.  The slices' maps are then composed in shared memory in slice
//   order (m_ab = m_b[m_a], a tree of log2(threads) levels) and the block
//   writes one map per chunk.
// dna_state_map_gather (16 < S <= 3072): a warp per (chunk, 32 start
//   states), a lane per start state, walking the whole chunk through a
//   k-gram table of uint16 entries (the largest k whose table fits
//   GRAM_TABLE_BYTES); the warp stages its chunk 512 contiguous bytes a
//   slot (a 16-byte copy a lane) and every lane reads the same bytes.
// dna_count_hits: a walker (thread) per count chunk, 32 consecutive chunks a
//   warp, from the chunk's true start state.  The packed k-gram entry holds
//   the next state times 4^k in its low 24 bits and the accepting visits
//   within the k steps in its top bits, so one lookup a k-gram yields both
//   and the next index is one AND-OR away.
//
// All text offsets are 64-bit: a full-size text (3 * 2^30 symbols) is longer
// than 2^31.  Contract (checked by the Python wrappers): text uint8 with
// symbols in [0, 4) (each symbol is read as its low two bits), table int32
// (S, 4), accept/starts int32, everything contiguous, T a multiple of
// chunk, S <= 3072, 32 <= threads <= 256 a multiple of 32.  Table entries
// and start states outside [0, S) are clamped into range when read (the
// reference's gather clamps too).  The text pointer need not be aligned:
// the copies read whole aligned 16-byte units, and a unit that holds a byte
// of the text lies inside its allocation.
//
// Plain C interface: each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError() (or the
// error of the attribute or occupancy query that precedes the launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_SYM = 4;
constexpr int MAX_THREADS = 256;
constexpr int ROW = 128;                 // bytes of a walker's text a slot row holds
constexpr int PITCH = ROW + 16;          // nine 16-byte units (odd)
constexpr int STAGES = 3;
constexpr int WARP_SLOT = 32 * PITCH;    // one slot of a warp's ring
constexpr int WIDE = 512;                // gather route: a warp's slot
constexpr int VEC_MAX_STATES = 16;
constexpr int HIT_SHIFT = 24;
constexpr uint32_t IDX_MASK = (1u << HIT_SHIFT) - 1u;
constexpr uint32_t SYM_MASK = 0x03030303u;
constexpr uint32_t GRAM4_MUL = 0x01041040u;   // (m * GRAM4_MUL) >> 24 = b0|b1<<2|b2<<4|b3<<6
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_state(int32_t v, int s) {
    return v < 0 ? 0 : (v >= s ? s - 1 : v);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy device -> shared; when `valid` is false nothing
// is read and the destination is filled with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// prmt.b32 in its default mode: result byte i is byte (sel_i & 7) of the
// eight bytes {b, a}, or that byte's sign replicated when sel_i & 8
// (sel_i = nibble i of the selector's low 16 bits).
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
    uint32_t d;
    asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
    return d;
}

// `pos` moved down to the 16-byte boundary of the address space below it
__device__ __forceinline__ int64_t aligned_origin(const uint8_t* text, int64_t pos) {
    return pos - (int64_t)(reinterpret_cast<uintptr_t>(text + pos) & 15u);
}

// f(g) for the word's 4 / K grams in text order
template <int K, typename F>
__device__ __forceinline__ void for_grams(uint32_t w, F&& f) {
    const uint32_t m = w & SYM_MASK;
    if constexpr (K == 4) {
        f((m * GRAM4_MUL) >> 24);
    } else if constexpr (K == 2) {
        const uint32_t y = m | (m >> 6);     // byte 0: b0|b1<<2, byte 2: b2|b3<<2
        f(y & 15u);
        f((y >> 16) & 15u);
    } else {
        f(m & 3u);
        f((m >> 8) & 3u);
        f((m >> 16) & 3u);
        f(m >> 24);
    }
}

// A warp's ring: `copy(slot, j)` fills a slot with stage j, `walk(slot, j)`
// reads it.  `nseg` is the same for every lane.  Two stages are in flight
// while one is walked; __syncwarp orders each lane's landed copies before
// the other lanes' reads, and the reads of a slot before its refill.
template <int SLOT, typename Copy, typename Walk>
__device__ __forceinline__ void run_ring(unsigned char* ring, unsigned nseg,
                                         Copy&& copy, Walk&& walk) {
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
        if ((unsigned)j < nseg) copy(ring + j * SLOT, (unsigned)j);
        cp_async_commit();
    }
    for (unsigned j = 0; j < nseg; ++j) {
        cp_async_wait<STAGES - 2>();
        __syncwarp();
        const unsigned jn = j + STAGES - 1;
        if (jn < nseg) copy(ring + (jn % STAGES) * SLOT, jn);
        cp_async_commit();
        walk(ring + (j % STAGES) * SLOT, j);
    }
    cp_async_wait<0>();
    __syncwarp();
}

// The copies of one stage of a warp of walkers: the ROW / 16 = 8 lanes of
// an octet cover one row, so lane copies 16-byte part lane % 8 of rows
// copy_row(lane, c) = lane / 8 + 4c, c < 8, whose aligned origins (plus
// the part) and ends it holds.
constexpr int COPIES = ROW / 16;

struct RowCopies {
    int64_t org[COPIES], end[COPIES];
};

__device__ __forceinline__ int copy_row(int lane, int c) {
    return lane / COPIES + c * (32 / COPIES);
}

__device__ __forceinline__ void copy_rows(unsigned char* slot, const uint8_t* text,
                                          const uint8_t* safe, const RowCopies& rc,
                                          unsigned j, int lane) {
    const int part = (lane % COPIES) * 16;
#pragma unroll
    for (int c = 0; c < COPIES; ++c) {
        const int64_t off = rc.org[c] + (int64_t)j * ROW;
        const bool valid = off < rc.end[c];
        cp_async16(slot + copy_row(lane, c) * PITCH + part,
                   valid ? text + off : safe, valid);
    }
}

// Walk one slot row of ROW bytes whose first byte is text offset seg0 over
// the range [lo, hi): `unit(q)` for each 16-byte unit wholly inside, `one(b)`
// for each symbol of a unit the range cuts.
template <typename Unit, typename One>
__device__ __forceinline__ void walk_row(const unsigned char* row, int64_t seg0,
                                         int64_t lo, int64_t hi, Unit&& unit,
                                         One&& one) {
#pragma unroll
    for (int u = 0; u < ROW / 16; ++u) {
        const int64_t u0 = seg0 + 16 * u;
        if (u0 >= lo && u0 + 16 <= hi) {
            unit(*reinterpret_cast<const uint4*>(row + 16 * u));
        } else if (u0 + 16 > lo && u0 < hi) {
            for (int i = 0; i < 16; ++i) {
                const int64_t pos = u0 + i;
                if (pos >= lo && pos < hi) one((uint32_t)row[16 * u + i] & 3u);
            }
        }
    }
}

// ---- state map, S <= 16: the state vector in nibbles, stepped by prmt -----
//
// n0 holds start states 0-7 (nibble j = the current state of start state j),
// n1 states 8-15; G = ceil(S / 4) groups of four are live.  A column is the
// next state of states 0-15 as 16 bytes.

template <int G>
__device__ __forceinline__ uint32_t look4(uint4 c, uint32_t sel) {
    if constexpr (G <= 2) {
        return prmt(c.x, c.y, sel);
    } else {
        return prmt(c.x, c.y, sel) | prmt(c.z, c.w, sel ^ 0x8888u);
    }
}

// bytes v0..v3 of xa and xb (each < 16) as the nibbles of one word
__device__ __forceinline__ uint32_t compact(uint32_t xa, uint32_t xb) {
    return prmt(xa | (xa >> 4), xb | (xb >> 4), 0x6420u);
}

// the low four nibbles of n as four bytes
__device__ __forceinline__ uint32_t expand(uint32_t n) {
    return prmt(n & 0x0F0Fu, (n >> 4) & 0x0F0Fu, 0x5140u);
}

template <int G>
__device__ __forceinline__ void vstep(uint32_t& n0, uint32_t& n1, uint4 c) {
    const uint32_t xa = look4<G>(c, n0);
    const uint32_t xb = G >= 2 ? look4<G>(c, n0 >> 16) : xa;
    if constexpr (G >= 3) {
        const uint32_t xc = look4<G>(c, n1);
        const uint32_t xd = G == 4 ? look4<G>(c, n1 >> 16) : xc;
        n1 = compact(xc, xd);
    }
    n0 = compact(xa, xb);
}

// Every live nibble equal: all start states have met (the padding lanes
// copy a live lane, so this never says yes too early).
template <int G>
__device__ __forceinline__ bool all_equal(uint32_t n0, uint32_t n1) {
    const uint32_t rep = (n0 & 15u) * 0x11111111u;
    if constexpr (G <= 2) {
        return n0 == rep;
    } else {
        return n0 == rep && n1 == rep;
    }
}

template <int G, int K>
__global__ void __launch_bounds__(MAX_THREADS)
state_map_vec_kernel(const uint8_t* __restrict__ text,
                     const int32_t* __restrict__ table,
                     int32_t* __restrict__ maps, int64_t n_chunks,
                     int64_t chunk, int s) {
    constexpr int NG = 1 << (2 * K);
    extern __shared__ __align__(16) unsigned char smem[];
    uint4* colk = reinterpret_cast<uint4*>(smem);           // NG k-gram columns
    uint4* col1 = colk + NG;                                // 4 one-symbol columns
    uint4* slice_maps = col1 + N_SYM;                       // a map per thread
    unsigned char* ring = reinterpret_cast<unsigned char*>(slice_maps + blockDim.x);
    uint8_t* colkb = reinterpret_cast<uint8_t*>(colk);
    uint8_t* col1b = reinterpret_cast<uint8_t*>(col1);
    uint8_t* mapb = reinterpret_cast<uint8_t*>(slice_maps);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;

    for (int i = tid; i < N_SYM * 16; i += nt) {
        const int b = i >> 4, st = i & 15;
        col1b[i] = st < s ? (uint8_t)clamp_state(table[st * N_SYM + b], s) : 0;
    }
    __syncthreads();
    for (int i = tid; i < NG * 16; i += nt) {
        const int g = i >> 4, st = i & 15;
        uint32_t v = 0;
        if (st < s) {
            v = st;
            for (int k = 0; k < K; ++k) v = col1b[((g >> (2 * k)) & 3) * 16 + v];
        }
        colkb[i] = (uint8_t)v;
    }
    __syncthreads();

    // start state j in lane j; lanes past S copy start state S - 1
    uint32_t id0 = 0, id1 = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const uint32_t v = j < s ? j : s - 1;
        if (j < 8) id0 |= v << (4 * j);
        else id1 |= v << (4 * (j - 8));
    }
    unsigned char* wring = ring + (size_t)warp * STAGES * WARP_SLOT;
    const uint8_t* safe = text + aligned_origin(text, 0);
    const int64_t lq = 16 * ((chunk + 16LL * nt - 1) / (16LL * nt));

    for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const int64_t c0 = c * chunk;
        auto lo = [&](int t) { return c0 + min64(chunk, (int64_t)t * lq); };
        const int64_t s_me = lo(tid), e_me = lo(tid + 1);
        const int64_t org_me = aligned_origin(text, s_me);
        RowCopies rc;
#pragma unroll
        for (int k = 0; k < COPIES; ++k) {
            const int t = warp * 32 + copy_row(lane, k);
            rc.org[k] = aligned_origin(text, lo(t)) + (lane % COPIES) * 16;
            rc.end[k] = lo(t + 1);
        }
        const unsigned mine = s_me < e_me
            ? (unsigned)((e_me - org_me + ROW - 1) / ROW) : 0u;
        const unsigned nseg = __reduce_max_sync(FULL, mine);

        uint32_t n0 = id0, n1 = id1, v = 0;
        bool conv = false;
        run_ring<WARP_SLOT>(
            wring, nseg,
            [&](unsigned char* slot, unsigned j) {
                copy_rows(slot, text, safe, rc, j, lane);
            },
            [&](const unsigned char* slot, unsigned j) {
                if (j >= mine) return;
                walk_row(
                    slot + lane * PITCH, org_me + (int64_t)j * ROW, s_me, e_me,
                    [&](uint4 q) {
                        if (conv) {
                            for_grams<K>(q.x, [&](uint32_t g) { v = colkb[g * 16 + v]; });
                            for_grams<K>(q.y, [&](uint32_t g) { v = colkb[g * 16 + v]; });
                            for_grams<K>(q.z, [&](uint32_t g) { v = colkb[g * 16 + v]; });
                            for_grams<K>(q.w, [&](uint32_t g) { v = colkb[g * 16 + v]; });
                        } else {
                            for_grams<K>(q.x, [&](uint32_t g) { vstep<G>(n0, n1, colk[g]); });
                            for_grams<K>(q.y, [&](uint32_t g) { vstep<G>(n0, n1, colk[g]); });
                            for_grams<K>(q.z, [&](uint32_t g) { vstep<G>(n0, n1, colk[g]); });
                            for_grams<K>(q.w, [&](uint32_t g) { vstep<G>(n0, n1, colk[g]); });
                            if (all_equal<G>(n0, n1)) {
                                conv = true;
                                v = n0 & 15u;
                            }
                        }
                    },
                    [&](uint32_t b) {
                        if (conv) v = col1b[b * 16 + v];
                        else vstep<G>(n0, n1, col1[b]);
                    });
                if (!conv && all_equal<G>(n0, n1)) {   // after a cut unit
                    conv = true;
                    v = n0 & 15u;
                }
            });
        if (conv) n0 = n1 = v * 0x11111111u;
        slice_maps[tid] = make_uint4(expand(n0), expand(n0 >> 16), expand(n1),
                                     expand(n1 >> 16));
        __syncthreads();
        // compose the slices' maps in slice order: m_t <- m_{t+d}[m_t]
        for (int d = 1; d < nt; d *= 2) {
            const int pairs = (nt + 2 * d - 1) / (2 * d);
            for (int i = tid; i < pairs * s; i += nt) {
                const int p = i / s, st = i - p * s, t = 2 * d * p;
                if (t + d < nt) mapb[t * 16 + st] = mapb[(t + d) * 16 + mapb[t * 16 + st]];
            }
            __syncthreads();
        }
        if (tid < s) maps[c * s + tid] = mapb[tid];
        __syncthreads();
    }
}

// ---- state map, S > 16: a lane per start state, uint16 k-gram entries -----

template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
state_map_gather_kernel(const uint8_t* __restrict__ text,
                        const int32_t* __restrict__ table,
                        int32_t* __restrict__ maps, int64_t n_chunks,
                        int64_t chunk, int s) {
    constexpr int NG = 1 << (2 * K);
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* t1 = reinterpret_cast<uint16_t*>(smem);       // next state, S x 4
    uint16_t* tk = t1 + ((s * N_SYM + 7) & ~7);             // next << 2K, S x NG
    unsigned char* ring = reinterpret_cast<unsigned char*>(tk + ((s * NG + 7) & ~7));
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

    for (int i = tid; i < s * N_SYM; i += nt) t1[i] = (uint16_t)clamp_state(table[i], s);
    __syncthreads();
    for (int i = tid; i < s * NG; i += nt) {
        const int g = i & (NG - 1);
        uint32_t v = i >> (2 * K);
        for (int k = 0; k < K; ++k) v = t1[v * N_SYM + ((g >> (2 * k)) & 3)];
        tk[i] = (uint16_t)(v << (2 * K));
    }
    __syncthreads();

    unsigned char* wring = ring + (size_t)warp * STAGES * WIDE;
    const uint8_t* safe = text + aligned_origin(text, 0);
    const int sb = (s + 31) >> 5;
    const int64_t n_tasks = n_chunks * sb;
    for (int64_t task = (int64_t)blockIdx.x * nwarps + warp; task < n_tasks;
         task += (int64_t)gridDim.x * nwarps) {
        const int64_t c = task / sb;
        const int st = (int)(task - c * sb) * 32 + lane;
        const int64_t c0 = c * chunk, c1 = c0 + chunk;
        const int64_t org = aligned_origin(text, c0);
        const unsigned nseg = (unsigned)((c1 - org + WIDE - 1) / WIDE);
        uint32_t e = (uint32_t)(st < s ? st : 0) << (2 * K);
        run_ring<WIDE>(
            wring, nseg,
            [&](unsigned char* slot, unsigned j) {
                const int64_t off = org + (int64_t)j * WIDE + 16 * lane;
                const bool valid = off < c1;
                cp_async16(slot + 16 * lane, valid ? text + off : safe, valid);
            },
            [&](const unsigned char* slot, unsigned j) {
                const int64_t seg0 = org + (int64_t)j * WIDE;
#pragma unroll 1
                for (int r = 0; r < WIDE / ROW; ++r) {
                    walk_row(
                        slot + r * ROW, seg0 + r * ROW, c0, c1,
                        [&](uint4 q) {
                            for_grams<K>(q.x, [&](uint32_t g) { e = tk[e | g]; });
                            for_grams<K>(q.y, [&](uint32_t g) { e = tk[e | g]; });
                            for_grams<K>(q.z, [&](uint32_t g) { e = tk[e | g]; });
                            for_grams<K>(q.w, [&](uint32_t g) { e = tk[e | g]; });
                        },
                        [&](uint32_t b) {
                            e = (uint32_t)t1[(e >> (2 * K)) * N_SYM + b] << (2 * K);
                        });
                }
            });
        if (st < s) maps[c * s + st] = (int32_t)(e >> (2 * K));
    }
}

// ---- count hits: accepting-state visits of a chunk from its start state ----

template <int K>
__global__ void __launch_bounds__(MAX_THREADS)
count_hits_kernel(const uint8_t* __restrict__ text,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ accept,
                  const int32_t* __restrict__ starts,
                  int32_t* __restrict__ counts, int32_t* __restrict__ ends,
                  int64_t n_chunks, int64_t chunk, int s) {
    constexpr int NG = 1 << (2 * K);
    extern __shared__ __align__(16) unsigned char smem[];
    // packed entries: (next << 2K) | (accepting visits << HIT_SHIFT)
    uint32_t* t1 = reinterpret_cast<uint32_t*>(smem);       // one symbol, S x 4
    uint32_t* tk = K == 1 ? t1 : t1 + ((s * N_SYM + 3) & ~3);   // K symbols, S x NG
    unsigned char* ring = reinterpret_cast<unsigned char*>(
        K == 1 ? t1 + ((s * N_SYM + 3) & ~3) : tk + ((s * NG + 3) & ~3));
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;

    for (int i = tid; i < s * N_SYM; i += nt) {
        const int nxt = clamp_state(table[i], s);
        t1[i] = ((uint32_t)nxt << (2 * K))
              | ((uint32_t)(accept[nxt] != 0 ? 1 : 0) << HIT_SHIFT);
    }
    __syncthreads();
    if constexpr (K > 1) {
        for (int i = tid; i < s * NG; i += nt) {
            const int g = i & (NG - 1);
            uint32_t v = i >> (2 * K), hits = 0;
            for (int k = 0; k < K; ++k) {
                const uint32_t x = t1[v * N_SYM + ((g >> (2 * k)) & 3)];
                v = (x & IDX_MASK) >> (2 * K);
                hits += x >> HIT_SHIFT;
            }
            tk[i] = (v << (2 * K)) | (hits << HIT_SHIFT);
        }
        __syncthreads();
    }

    unsigned char* wring = ring + (size_t)warp * STAGES * WARP_SLOT;
    const uint8_t* safe = text + aligned_origin(text, 0);
    const int64_t n_tasks = (n_chunks + 31) / 32;
    for (int64_t task = (int64_t)blockIdx.x * nwarps + warp; task < n_tasks;
         task += (int64_t)gridDim.x * nwarps) {
        const int64_t ci = task * 32 + lane;
        const bool live = ci < n_chunks;
        const int64_t s_me = (live ? ci : n_chunks) * chunk;
        const int64_t e_me = live ? s_me + chunk : s_me;
        const int64_t org_me = aligned_origin(text, s_me);
        RowCopies rc;
#pragma unroll
        for (int k = 0; k < COPIES; ++k) {
            const int64_t cr = task * 32 + copy_row(lane, k);
            const int64_t sr = (cr < n_chunks ? cr : n_chunks) * chunk;
            rc.org[k] = aligned_origin(text, sr) + (lane % COPIES) * 16;
            rc.end[k] = cr < n_chunks ? sr + chunk : sr;
        }
        const unsigned mine = live
            ? (unsigned)((e_me - org_me + ROW - 1) / ROW) : 0u;
        const unsigned nseg = __reduce_max_sync(FULL, mine);

        uint32_t e = (uint32_t)(live ? clamp_state(starts[ci], s) : 0) << (2 * K);
        int32_t hits = 0;
        run_ring<WARP_SLOT>(
            wring, nseg,
            [&](unsigned char* slot, unsigned j) {
                copy_rows(slot, text, safe, rc, j, lane);
            },
            [&](const unsigned char* slot, unsigned j) {
                if (j >= mine) return;
                walk_row(
                    slot + lane * PITCH, org_me + (int64_t)j * ROW, s_me, e_me,
                    [&](uint4 q) {
                        auto step = [&](uint32_t g) {
                            e = tk[(e & IDX_MASK) | g];
                            hits += (int32_t)(e >> HIT_SHIFT);
                        };
                        for_grams<K>(q.x, step);
                        for_grams<K>(q.y, step);
                        for_grams<K>(q.z, step);
                        for_grams<K>(q.w, step);
                    },
                    [&](uint32_t b) {
                        e = t1[((e & IDX_MASK) >> (2 * K)) * N_SYM + b];
                        hits += (int32_t)(e >> HIT_SHIFT);
                    });
            });
        if (live) {
            counts[ci] = hits;
            ends[ci] = (int32_t)((e & IDX_MASK) >> (2 * K));
        }
    }
}

// ---- launch ------------------------------------------------------------------

// Shared memory of a block, in bytes (must match kernel.py's smem_bytes).
size_t smem_vec(int threads, int k) {
    return (size_t)16 * ((1 << (2 * k)) + N_SYM + threads)
         + (size_t)(threads / 32) * STAGES * WARP_SLOT;
}

size_t smem_gather(int s, int threads, int k) {
    return (size_t)2 * (((s * N_SYM + 7) & ~7) + ((s * (1 << (2 * k)) + 7) & ~7))
         + (size_t)(threads / 32) * STAGES * WIDE;
}

size_t smem_count(int s, int threads, int k) {
    const size_t tables = (size_t)4 * ((s * N_SYM + 3) & ~3)
        + (k == 1 ? 0 : (size_t)4 * ((s * (1 << (2 * k)) + 3) & ~3));
    return tables + (size_t)(threads / 32) * STAGES * WARP_SLOT;
}

// A persistent grid: as many blocks as the card holds at once, at most
// `work`; the shared-memory opt-in first (above 48 KB).
int persistent_grid(const void* fn, int threads, size_t smem, int64_t work,
                    unsigned* grid) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int64_t blocks = (int64_t)sms * per_sm;
    if (work < blocks) blocks = work;
    *grid = (unsigned)(blocks < 1 ? 1 : blocks);
    return 0;
}

bool threads_ok(int threads) {
    return threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

template <int G, int K>
int launch_vec(const void* text, const void* table, void* maps,
               int64_t n_chunks, int64_t chunk, int s, int threads,
               cudaStream_t stream) {
    const size_t smem = smem_vec(threads, K);
    unsigned grid = 0;
    const int rc = persistent_grid((const void*)state_map_vec_kernel<G, K>,
                                   threads, smem, n_chunks, &grid);
    if (rc != 0) return rc;
    state_map_vec_kernel<G, K><<<grid, threads, smem, stream>>>(
        (const uint8_t*)text, (const int32_t*)table, (int32_t*)maps,
        n_chunks, chunk, s);
    return (int)cudaGetLastError();
}

template <int K>
int launch_gather(const void* text, const void* table, void* maps,
                  int64_t n_chunks, int64_t chunk, int s, int threads,
                  cudaStream_t stream) {
    const size_t smem = smem_gather(s, threads, K);
    const int64_t tasks = n_chunks * ((s + 31) / 32);
    const int warps = threads / 32;
    unsigned grid = 0;
    const int rc = persistent_grid((const void*)state_map_gather_kernel<K>,
                                   threads, smem, (tasks + warps - 1) / warps,
                                   &grid);
    if (rc != 0) return rc;
    state_map_gather_kernel<K><<<grid, threads, smem, stream>>>(
        (const uint8_t*)text, (const int32_t*)table, (int32_t*)maps,
        n_chunks, chunk, s);
    return (int)cudaGetLastError();
}

template <int K>
int launch_count(const void* text, const void* table, const void* accept,
                 const void* starts, void* counts, void* ends,
                 int64_t n_chunks, int64_t chunk, int s, int threads,
                 cudaStream_t stream) {
    const size_t smem = smem_count(s, threads, K);
    const int64_t tasks = (n_chunks + 31) / 32;
    const int warps = threads / 32;
    unsigned grid = 0;
    const int rc = persistent_grid((const void*)count_hits_kernel<K>, threads,
                                   smem, (tasks + warps - 1) / warps, &grid);
    if (rc != 0) return rc;
    count_hits_kernel<K><<<grid, threads, smem, stream>>>(
        (const uint8_t*)text, (const int32_t*)table, (const int32_t*)accept,
        (const int32_t*)starts, (int32_t*)counts, (int32_t*)ends, n_chunks,
        chunk, s);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S <= 16; gram in {1, 2, 4}.
int dna_state_map_vec(const void* text, const void* table, void* maps,
                      int64_t n_chunks, int64_t chunk, int s, int threads,
                      int gram, void* stream) {
    if (n_chunks <= 0) return 0;
    if (s < 1 || s > VEC_MAX_STATES || !threads_ok(threads) || chunk < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int g = (s + 3) / 4;
#define VEC(G, K)                                                             \
    if (g == G && gram == K)                                                  \
        return launch_vec<G, K>(text, table, maps, n_chunks, chunk, s,        \
                                threads, st);
    VEC(1, 1) VEC(1, 2) VEC(1, 4)
    VEC(2, 1) VEC(2, 2) VEC(2, 4)
    VEC(3, 1) VEC(3, 2) VEC(3, 4)
    VEC(4, 1) VEC(4, 2) VEC(4, 4)
#undef VEC
    return (int)cudaErrorInvalidValue;
}

// 1 <= S <= 3072 (any S; the wrapper sends S > 16); gram in {1, 2, 4}, and
// S * 4^gram <= 65536 so the entries fit uint16.
int dna_state_map_gather(const void* text, const void* table, void* maps,
                         int64_t n_chunks, int64_t chunk, int s, int threads,
                         int gram, void* stream) {
    if (n_chunks <= 0) return 0;
    if (s < 1 || !threads_ok(threads) || chunk < 1
        || (int64_t)s << (2 * gram) > 65536)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (gram) {
        case 1: return launch_gather<1>(text, table, maps, n_chunks, chunk, s, threads, st);
        case 2: return launch_gather<2>(text, table, maps, n_chunks, chunk, s, threads, st);
        case 4: return launch_gather<4>(text, table, maps, n_chunks, chunk, s, threads, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

int dna_count_hits(const void* text, const void* table, const void* accept,
                   const void* starts, void* counts, void* ends,
                   int64_t n_chunks, int64_t chunk, int s, int threads,
                   int gram, void* stream) {
    if (n_chunks <= 0) return 0;
    if (s < 1 || !threads_ok(threads) || chunk < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (gram) {
        case 1: return launch_count<1>(text, table, accept, starts, counts, ends,
                                       n_chunks, chunk, s, threads, st);
        case 2: return launch_count<2>(text, table, accept, starts, counts, ends,
                                       n_chunks, chunk, s, threads, st);
        case 4: return launch_count<4>(text, table, accept, starts, counts, ends,
                                       n_chunks, chunk, s, threads, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

const char* dna_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
