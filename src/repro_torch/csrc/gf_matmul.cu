// Exact batched matrix product over GF(q) for NVIDIA Hopper (sm_90a).
//
//   C[z] = (A[z] @ B[z]) mod q,   z < batch
//
// A: (batch, M, K) uint32, B: (batch, K, N) uint32, C: (batch, M, N) uint32,
// dense and row-major, every entry canonical (< q), q an odd modulus below
// 2^31. batch = 1 is the plain product.
//
// Replaces the TPU kernel `gf_matmul_pallas` (body `_gf_matmul_kernel`, with
// `_barrett`, `_shoup`, `_fold_constants`) of
// src/repro/kernels/gf_matmul/kernel.py, and the `vmap` of it that the
// reference's `gf_matmul_batched` takes. It computes the same function and is
// not a translation of it. The TPU kernel splits every operand into four
// 8-bit limbs, forms 16 limb products on an int8 matrix unit and folds seven
// weight classes with 16-bit-limb Barrett and Shoup steps, because that
// machine multiplies neither 32x32 -> 64 bits nor outside its matrix unit; it
// carries the sum over K from one grid step to the next in its output block.
// Here a 32x32 -> 64-bit multiply-add is one instruction, and the whole K loop
// runs inside one block with the sums in registers.
//
// Exactness. Entries are at most q - 1 <= 2^31 - 2, so one product is at most
// (2^31 - 2)^2 = 2^62 - 2^33 + 4, and four of them at most 2^64 - 2^35 + 16.
// A 64-bit accumulator that starts below 2^33 and takes four products
// therefore stays below 2^64 - 2^35 + 2^33 + 16 < 2^64: no wrap. After every
// fourth product the accumulator x = hi * 2^32 + lo is folded back below 2^33
// without leaving its residue class: with the constant r = 2^32 mod q and its
// Shoup dual r' = floor(r * 2^32 / q), t = umulhi(hi, r') is floor(hi * r / q)
// or one less, so hi * r - t * q (taken mod 2^32) lies in [0, 2q) and is
// congruent to hi * 2^32; adding lo gives a value below 2q + 2^32 <= 2^33
// congruent to x. That fold is three 32-bit multiplies and a 64-bit add
// where a full reduction costs a 64x64-bit high product. Only the last step
// is a full one: a 64-bit Barrett reduction with mu = floor(2^64 / q), where
// t = umul64hi(x, mu) is floor(x / q) or one less, so x - t*q lies in
// [0, 2q) and one conditional subtraction finishes. It takes any 64-bit x, so
// no fold is needed after the last product (at K <= 4 there is none at all).
//
// What bounds it on this card. Every shape of the encode path has few rows
// (M <= 16, K <= 8) and a wide N (2^20 to 2^24 columns): it is M*K
// multiply-adds for every K + M words moved, so the least time is the bytes,
// batch * (K*N + M*N) * 4, over the memory rate (3.35 TB/s). The integer
// work is not small beside it (at 8 x 8: 64 wide multiply-adds, 8 folds and
// 8 Barrett steps a column, of the order of 0.8 ms of issue over the whole
// card against a 1.28 ms byte bound), so it has to run while the copies are
// in flight, not after them. The tensor cores buy nothing at these shapes;
// the int8 limb form on `wgmma` stays the design for square, operation-bound
// shapes, which the encode path never produces.
//
// What the design does about it. Every shape with M <= 16 goes to one row
// kernel, `gf_matmul_rows<MT, kRagged>`, in one launch, whatever N % 4 is and
// wherever B and C start (the operands are int32, so 4-byte aligned):
//  * One tile holds every row of C: MT in {1, 2, 4, 8, 16} is the smallest
//    power of two >= M, chosen by the caller, so B is read exactly once. A
//    thread owns V columns of every row, V = 16, 16, 8, 4, 4 for MT = 1 .. 16,
//    as V/4 groups of four neighbouring columns 1024 apart (a warp's 16-byte
//    accesses cover 512 contiguous bytes), so it keeps MT * V <= 64 sums in
//    registers. The MT - M dead rows of a tile that M does not fill (none on
//    the encode path) are multiplied by zero and never stored: a branch on M
//    in the inner loop costs the vector loads of A, and more than the rows.
//  * A persistent grid: as many blocks as fit on the SMs, dealt the (batch
//    entry, column tile) pairs in turn, so that the whole grid sweeps the
//    operands together, the batch has no grid cap, there is no tail of short
//    blocks, and one tile's folds and stores overlap the next tile's copies.
//    Tiles do not cross batch entries. The grid's size, and the raised
//    shared-memory limit, are worked out at an instantiation's first launch
//    on a device and kept.
//  * B streams through a ring of kStages stages of RS rows by the tile's
//    columns (32 KB), filled by 1-D bulk copies (`cp.async.bulk`, no tensor
//    map), one a row of B, issued by one elected thread of a producer warp;
//    completion goes to a `full` mbarrier per stage, and the 8 computing
//    warps release a stage through its `empty` mbarrier. A's slice for a
//    stage (MT x RS words, transposed) sits in shared memory beside it and is
//    read as a broadcast, so no thread holds A in registers; the producer
//    warp reads it before it waits for the stage, so that read hides in the
//    wait. Depth: Little's law over 3.35 TB/s and a loaded HBM latency of the
//    order of 1-3 us wants 3-10 MB in flight on the card, 25-75 KB an SM; a
//    ring of 6 x 32 KB keeps up to 160 KB an SM in flight while one stage is
//    read. One block an SM (about 200 KB of shared memory).
//  * C is written 16 bytes a thread with a streaming hint (`st.global.cs`):
//    nothing reads it back here.
// Ragged rows (kRagged). Where N % 4 == 0 and B and C are 16-byte aligned,
// every row starts on a 16-byte boundary and the launch takes the form above
// (kRagged = false). Otherwise row k of entry z of B starts at word
// (z*K + k)*N past B, and its 16-byte phase (that position mod 4, plus B's
// own) differs from row to row; so do C's rows. Each row is handled at its
// own phase, in the same launch:
//  * B: a ring row keeps the global row's phase, in a slot one chunk wider.
//    The bulk copy takes the 16-byte-aligned interior of the row's window;
//    the <= 3 words before it and the <= 3 after it are read by scalar loads
//    of the producer warp (before its wait, as A's slice is) and published
//    with A's slice. No address outside the row's window is read. A computing
//    thread reads each group as two aligned 16-byte shared loads and takes
//    the four words at the row's phase by nine selects.
//  * C: row m's stores start at its own 16-byte boundary, s = (4 - phase) % 4
//    columns into the tile. A thread reduces all its groups of the row first,
//    then each chunk that starts s columns into a thread's four columns takes
//    s words from the next lane (`shfl.down`) and is written with one 16-byte
//    `st.global.cs`; the words a warp's seams leave (lane 0's first s, lane
//    31's last 4 - s: the row's head in its first tile, and the words shared
//    with a neighbouring warp or tile) and the row's tail of at most 3 words
//    in its last tile are written one word at a time with plain stores, so
//    that L2 keeps a sector that two warps or two blocks complete.
// tools/gf_matmul_variants.py times the choices above against their
// alternatives on the card (streaming hints on the seam words, code
// specialised to the phase by a switch a row on either side, the edge words
// as asynchronous 4-byte copies). Measured on the H100, the ragged form runs
// as fast as the aligned one at the same size from about 200 MB of operands
// up; below that it costs a fixed 1-3 us a launch, from both operands' sides.
// Reading B straight from global memory at the row's phase
// (`butterfly_mac`'s way) was not needed.
// Shapes with M > 16 go to the general kernel, `gf_matmul_tiled`: an 8-row by
// 1024-column tile of C a block, 8 x 4 sums a thread, the K loop staged 32 at
// a time, the batch walked in strides of the grid's z axis; with scalar,
// block-strided column accesses where N % 4 != 0 or a buffer is not 16-byte
// aligned. Every kernel does the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// --------------------------------------------------------------------------
// the arithmetic (see "Exactness")
// --------------------------------------------------------------------------

// x -> a value below 2^33 in the residue class of x.
__device__ __forceinline__ uint64_t fold64(uint64_t x, uint32_t q, uint32_t r32, uint32_t r32_pre) {
    const uint32_t hi = (uint32_t)(x >> 32);
    const uint32_t t = __umulhi(hi, r32_pre);
    const uint32_t r = hi * r32 - t * q;  // in [0, 2q), congruent to hi * 2^32
    return (uint64_t)r + (uint32_t)x;
}

// x -> x mod q, for any 64-bit x.
__device__ __forceinline__ uint32_t reduce64(uint64_t x, uint32_t q, uint64_t mu) {
    const uint64_t t = __umul64hi(x, mu);
    const uint32_t r = (uint32_t)x - (uint32_t)t * q;  // true value in [0, 2q) < 2^32
    return r >= q ? r - q : r;
}

struct Field {
    uint32_t q;
    uint64_t mu;
    uint32_t r32, r32_pre;
};

// --------------------------------------------------------------------------
// the row kernel: every row of C in one tile, persistent grid, B through a ring
// --------------------------------------------------------------------------

constexpr int kConsumers = 256;         // threads that multiply (8 warps)
constexpr int kProducers = 32;          // the warp whose lane 0 issues the copies
constexpr int kStages = 6;              // depth of the ring
constexpr int kStageBytes = 32 * 1024;  // one stage: RS rows x TileN columns of B
constexpr int kGroupStride = 4 * kConsumers;  // columns between a thread's groups

template <int MT, bool kRagged>
struct RowTile {
    static constexpr int V = MT <= 2 ? 16 : (MT == 4 ? 8 : 4);  // columns a thread owns
    static constexpr int G = V / 4;                             // its groups of 4 columns
    static constexpr int TileN = kConsumers * V;                // columns of a tile
    static constexpr int RS = kStageBytes / (TileN * 4);        // rows of B a stage holds
    static_assert(RS * TileN * 4 == kStageBytes && RS >= 1, "a stage is RS whole rows");
    // words of a ring row: a ragged row keeps its global 16-byte phase, one chunk more
    static constexpr int RowWords = TileN + (kRagged ? 4 : 0);
    static constexpr int StageWords = RS * RowWords;
    // the scalar words at a ragged stage's row edges, <= 3 + 3 a row in 8 slots, spread over the producer warp
    static constexpr int EdgeRegs = kRagged ? (RS * 8 + 31) / 32 : 0;
};

constexpr int kRowsThreads = kConsumers + kProducers;

// A's slice for one stage, A[z][0:M, k0:k0+RS] transposed (RS x MT): at most 16 x 8 words
constexpr int kASlotWords = 128;

// [kStages x StageWords][kStages A slots][full, empty: kStages mbarriers each]
template <int MT, bool kRagged>
constexpr size_t rows_smem_bytes() {
    return (size_t)kStages * (RowTile<MT, kRagged>::StageWords * 4 + kASlotWords * 4 + 2 * 8);
}

// Word idx of A's slice for the stage at k0: a_st[r * MT + m] = A[z][m, k0 + r],
// zero for the dead rows m >= M (they are multiplied, never stored).
template <int MT>
__device__ __forceinline__ uint32_t a_word(const uint32_t* az, int M, int K, int k0, int idx) {
    const int r = idx / MT, m = idx % MT;
    return m < M ? az[(long long)m * K + k0 + r] : 0u;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// The 16-byte phase of a word's address: its index in its 16-byte chunk.
__device__ __forceinline__ int phase_of(const void* p) { return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3); }

// Words ph .. ph+3 of the eight words (lo, hi), for a phase ph the same for
// the whole block: nine selects.
__device__ __forceinline__ uint4 funnel(uint4 lo, uint4 hi, int ph) {
    const bool two = ph & 2, one = ph & 1;
    const uint32_t t0 = two ? lo.z : lo.x, t1 = two ? lo.w : lo.y, t2 = two ? hi.x : lo.z,
                   t3 = two ? hi.y : lo.w, t4 = two ? hi.z : hi.x;
    return one ? make_uint4(t1, t2, t3, t4) : make_uint4(t0, t1, t2, t3);
}

// Four words to row `row` at columns c .. c+3, those below `cols`: one
// 16-byte streaming store where all four are (row + c is then 16-byte
// aligned), else one plain store a word (a row's tail).
__device__ __forceinline__ void store_chunk(uint32_t* row, long long c, uint4 y, long long cols) {
    if (c + 3 < cols) {
        __stcs(reinterpret_cast<uint4*>(row + c), y);
        return;
    }
    const uint32_t w[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
        if (c + j < cols) row[c + j] = w[j];
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
    uint32_t done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    return done != 0;
}

// Waits until the phase of parity `parity` of the barrier has completed. A
// wait of more than 2^34 clocks (seconds: every stage of a launch completes in
// microseconds) can only be a fault of the kernel, and traps, so that the
// launch fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_u32(bar);
    if (mbar_try_wait(addr, parity)) return;
    const long long start = clock64();
    while (!mbar_try_wait(addr, parity))
        if (clock64() - start > (1ll << 34)) __trap();
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
                 : "memory");
}

// 1-D bulk copy global -> shared; `bytes` and both addresses multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
}

// One block an SM (the ring's shared memory).
template <int MT, bool kRagged>
__global__ void __launch_bounds__(kRowsThreads, 1)
gf_matmul_rows(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B, uint32_t* __restrict__ C,
               long long batch, int M, int K, long long N, Field f) {
    using T = RowTile<MT, kRagged>;
    extern __shared__ __align__(128) unsigned char smem[];
    static_assert(MT * T::RS <= kASlotWords, "A's slice fits its slot");
    uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
    uint32_t* a_slots = ring + (size_t)kStages * T::StageWords;
    uint64_t* full = reinterpret_cast<uint64_t*>(a_slots + kStages * kASlotWords);
    uint64_t* empty = full + kStages;

    // (batch entry, column tile) pairs, dealt to the blocks in turn: at any
    // moment the grid works on neighbouring tiles
    const long long tiles_per_entry = (N + T::TileN - 1) / T::TileN;
    const long long tiles = batch * tiles_per_entry;
    const int tid = threadIdx.x;

    if (tid == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(&full[s], 1);                       // the producer's arrive + the bytes
            mbar_init(&empty[s], kConsumers / 32);        // one arrive a computing warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid >= kConsumers) {  // the producer warp walks the same tiles and fills the ring
        const int lane = tid - kConsumers;
        int stage = 0;
        uint32_t phase = 0;
        for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
            const long long z = i / tiles_per_entry, n0 = (i % tiles_per_entry) * T::TileN;
            const uint32_t cols = (uint32_t)min((long long)T::TileN, N - n0);
            const uint32_t* src = B + z * K * N + n0;
            for (int k0 = 0; k0 < K; k0 += T::RS) {
                const int rows = min(T::RS, K - k0);
                // A's slice by the whole warp, read before the wait so that its
                // latency hides there, published by lane 0's arrive (a release)
                uint32_t a_reg[kASlotWords / 32];
#pragma unroll
                for (int j = 0; j < kASlotWords / 32; ++j) {
                    const int idx = lane + 32 * j;
                    a_reg[j] = idx < rows * MT ? a_word<MT>(A + z * M * K, M, K, k0, idx) : 0u;
                }
                // a ragged row's edge words, the same way: slot e < 4 of row r is
                // its head word e, slot 4 + e its tail word e
                uint32_t e_reg[T::EdgeRegs > 0 ? T::EdgeRegs : 1];
                int e_at[T::EdgeRegs > 0 ? T::EdgeRegs : 1];  // ring word of the slot, or -1
#pragma unroll
                for (int j = 0; j < T::EdgeRegs; ++j) {
                    const int idx = lane + 32 * j, r = idx >> 3, e = idx & 7;
                    e_at[j] = -1;
                    if (r < rows) {
                        const uint32_t* row = src + (long long)(k0 + r) * N;
                        const int ph = phase_of(row);
                        const uint32_t head = min((uint32_t)((4 - ph) & 3), cols);
                        const uint32_t tail = (cols - head) & 3u;
                        const uint32_t col = e < 4 ? (uint32_t)e : cols - tail + (uint32_t)(e - 4);
                        if (e < 4 ? (uint32_t)e < head : (uint32_t)(e - 4) < tail) {
                            e_reg[j] = row[col];
                            e_at[j] = r * T::RowWords + ph + (int)col;
                        }
                    }
                }
                if (lane == 0) mbar_wait(&empty[stage], phase ^ 1u);  // the computing warps are done with it
                __syncwarp();
                uint32_t* dst = ring + (size_t)stage * T::StageWords;
#pragma unroll
                for (int j = 0; j < kASlotWords / 32; ++j) {
                    const int idx = lane + 32 * j;
                    if (idx < rows * MT) a_slots[stage * kASlotWords + idx] = a_reg[j];
                }
#pragma unroll
                for (int j = 0; j < T::EdgeRegs; ++j)
                    if (e_at[j] >= 0) dst[e_at[j]] = e_reg[j];
                __threadfence_block();
                __syncwarp();
                if (lane == 0) {  // the one elected thread: the bytes to expect, then the copies
                    if (!kRagged) {
                        mbar_arrive_expect_tx(&full[stage], (uint32_t)rows * cols * 4u);
                        for (int r = 0; r < rows; ++r)
                            bulk_load(dst + r * T::TileN, src + (long long)(k0 + r) * N, cols * 4u, &full[stage]);
                    } else {  // each row's 16-byte-aligned interior, at the row's own phase
                        uint32_t bytes = 0;
                        for (int r = 0; r < rows; ++r) {
                            const uint32_t head = min((uint32_t)((4 - phase_of(src + (long long)(k0 + r) * N)) & 3), cols);
                            bytes += ((cols - head) >> 2) * 16u;
                        }
                        // the warp's edge words of earlier tiles lie where these copies write
                        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                        if (bytes == 0) {
                            mbar_arrive(&full[stage]);
                        } else {
                            mbar_arrive_expect_tx(&full[stage], bytes);
                            for (int r = 0; r < rows; ++r) {
                                const uint32_t* row = src + (long long)(k0 + r) * N;
                                const int ph = phase_of(row);
                                const uint32_t head = min((uint32_t)((4 - ph) & 3), cols);
                                const uint32_t chunks = (cols - head) >> 2;
                                if (chunks > 0)
                                    bulk_load(dst + r * T::RowWords + ph + head, row + head, chunks * 16u, &full[stage]);
                            }
                        }
                    }
                }
                if (++stage == kStages) { stage = 0; phase ^= 1u; }
            }
        }
        return;
    }

    const int lane = tid & 31;
    int stage = 0;
    uint32_t phase = 0;
    for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
        const long long z = i / tiles_per_entry, n0 = (i % tiles_per_entry) * T::TileN;
        const long long cols = min((long long)T::TileN, N - n0);

        uint64_t acc[MT][T::V];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int v = 0; v < T::V; ++v) acc[m][v] = 0;

        for (int k0 = 0; k0 < K; k0 += T::RS) {
            const int rows = min(T::RS, K - k0);
            const uint32_t* st = ring + (size_t)stage * T::StageWords;
            const uint32_t* a_st = a_slots + stage * kASlotWords;
            mbar_wait(&full[stage], phase);
#pragma unroll
            for (int r = 0; r < T::RS; ++r) {
                if (r >= rows) break;
                const int k = k0 + r;
                uint32_t b[T::V];
                const uint32_t* at = st + r * T::RowWords + tid * 4;
                if (!kRagged) {
#pragma unroll
                    for (int g = 0; g < T::G; ++g) {
                        const uint4 t = *reinterpret_cast<const uint4*>(at + g * kGroupStride);
                        b[4 * g] = t.x; b[4 * g + 1] = t.y; b[4 * g + 2] = t.z; b[4 * g + 3] = t.w;
                    }
                } else {  // the tile's column 0 of this row lies at ring word ph, the same for the whole block
                    const int ph = phase_of(B + (z * K + k) * N + n0);
#pragma unroll
                    for (int g = 0; g < T::G; ++g) {
                        const uint4* c = reinterpret_cast<const uint4*>(at + g * kGroupStride);
                        const uint4 t = funnel(c[0], c[1], ph);
                        b[4 * g] = t.x; b[4 * g + 1] = t.y; b[4 * g + 2] = t.z; b[4 * g + 3] = t.w;
                    }
                }
#pragma unroll
                for (int m = 0; m < MT; ++m) {  // (a branch on M here would cost the vector loads of A)
                    const uint64_t a = a_st[r * MT + m];  // the same word for every thread: a broadcast
#pragma unroll
                    for (int v = 0; v < T::V; ++v) acc[m][v] += a * b[v];
                }
                if ((k & 3) == 3 && k + 1 < K) {  // four products since the last fold, and more to come
#pragma unroll
                    for (int m = 0; m < MT; ++m)
#pragma unroll
                        for (int v = 0; v < T::V; ++v) acc[m][v] = fold64(acc[m][v], f.q, f.r32, f.r32_pre);
                }
            }
            // release the stage to the producer, one arrive a warp
            __syncwarp();
            if ((tid & 31) == 0) mbar_arrive(&empty[stage]);
            if (++stage == kStages) { stage = 0; phase ^= 1u; }
        }

        uint32_t* cz = C + z * M * N + n0;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
            if (m >= M) break;
            uint32_t* crow = cz + (long long)m * N;
            if (!kRagged) {
#pragma unroll
                for (int g = 0; g < T::G; ++g) {
                    const long long col = g * kGroupStride + tid * 4;
                    if (col < cols)
                        __stcs(reinterpret_cast<uint4*>(crow + col),
                               make_uint4(reduce64(acc[m][4 * g], f.q, f.mu), reduce64(acc[m][4 * g + 1], f.q, f.mu),
                                          reduce64(acc[m][4 * g + 2], f.q, f.mu),
                                          reduce64(acc[m][4 * g + 3], f.q, f.mu)));
                }
                continue;
            }
            uint4 o[T::G];
#pragma unroll
            for (int g = 0; g < T::G; ++g)
                o[g] = make_uint4(reduce64(acc[m][4 * g], f.q, f.mu), reduce64(acc[m][4 * g + 1], f.q, f.mu),
                                  reduce64(acc[m][4 * g + 2], f.q, f.mu), reduce64(acc[m][4 * g + 3], f.q, f.mu));
            // row m's next 16-byte boundary lies s columns into the tile, the same for the whole block
            const int s = (4 - phase_of(crow)) & 3;
#pragma unroll
            for (int g = 0; g < T::G; ++g) {
                const long long col = g * kGroupStride + tid * 4;
                uint4 next;  // the next lane's first three words: every lane shuffles
                next.x = __shfl_down_sync(0xffffffffu, o[g].x, 1);
                next.y = __shfl_down_sync(0xffffffffu, o[g].y, 1);
                next.z = __shfl_down_sync(0xffffffffu, o[g].z, 1);
                next.w = 0u;
                if (s == 0 || lane < 31) store_chunk(crow, col + s, funnel(o[g], next, s), cols);
                if (s != 0 && (lane == 0 || lane == 31)) {  // the words at the warp's seams
                    const uint32_t w[4] = {o[g].x, o[g].y, o[g].z, o[g].w};
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if ((lane == 0) == (j < s) && col + j < cols) crow[col + j] = w[j];
                }
            }
        }
    }
}

// --------------------------------------------------------------------------
// the general kernel: any M, K, N and alignment
// --------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileM = 8;    // rows of C a block owns
constexpr int kTileN = 4;    // columns of C a thread owns
constexpr int kTileK = 32;   // K step staged in shared memory (multiple of 4)
constexpr int kBlockN = kThreads * kTileN;

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_matmul_tiled(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B, uint32_t* __restrict__ C,
                long long batch, int M, int K, long long N, Field f) {
    __shared__ uint32_t a_tile[kTileM][kTileK];

    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * kTileM;

    // Column of C (and of B) that accumulator v of this thread belongs to.
    const long long block_n0 = (long long)blockIdx.x * kBlockN;
    long long col[kTileN];
#pragma unroll
    for (int v = 0; v < kTileN; ++v)
        col[v] = kVec ? block_n0 + (long long)tid * kTileN + v : block_n0 + (long long)v * kThreads + tid;

    // the grid's z axis walks the batch in strides, so the batch has no cap
    for (long long z = blockIdx.z; z < batch; z += gridDim.z) {
        const uint32_t* Az = A + z * (long long)M * K;
        const uint32_t* Bz = B + z * (long long)K * N;
        uint32_t* Cz = C + z * (long long)M * N;

        uint64_t acc[kTileM][kTileN];
#pragma unroll
        for (int m = 0; m < kTileM; ++m)
#pragma unroll
            for (int v = 0; v < kTileN; ++v) acc[m][v] = 0;

        for (int k0 = 0; k0 < K; k0 += kTileK) {
            // Stage A[m0 : m0+8, k0 : k0+32], zero beyond the edges: 256 words, one a thread.
            {
                const int m = tid / kTileK, kk = tid % kTileK;
                const int gm = m0 + m, gk = k0 + kk;
                a_tile[m][kk] = (gm < M && gk < K) ? Az[(long long)gm * K + gk] : 0u;
            }
            __syncthreads();

            const int k_end = min(kTileK, K - k0);
            for (int kk = 0; kk < k_end; kk += 4) {
                // Four products at most between two folds (see the bound above).
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int gk = k0 + kk + j;
                    uint32_t b[kTileN];
                    if (gk < K) {
                        const uint32_t* row = Bz + (long long)gk * N;
                        if (kVec) {
                            if (col[0] < N) {  // N % 4 == 0: the four columns are in or out together
                                const uint4 t = *reinterpret_cast<const uint4*>(row + col[0]);
                                b[0] = t.x; b[1] = t.y; b[2] = t.z; b[3] = t.w;
                            } else {
                                b[0] = b[1] = b[2] = b[3] = 0u;
                            }
                        } else {
#pragma unroll
                            for (int v = 0; v < kTileN; ++v) b[v] = col[v] < N ? row[col[v]] : 0u;
                        }
                    } else {
#pragma unroll
                        for (int v = 0; v < kTileN; ++v) b[v] = 0u;
                    }
#pragma unroll
                    for (int m = 0; m < kTileM; ++m) {
                        const uint64_t a = a_tile[m][kk + j];
#pragma unroll
                        for (int v = 0; v < kTileN; ++v) acc[m][v] += a * b[v];
                    }
                }
#pragma unroll
                for (int m = 0; m < kTileM; ++m)
#pragma unroll
                    for (int v = 0; v < kTileN; ++v) acc[m][v] = fold64(acc[m][v], f.q, f.r32, f.r32_pre);
            }
            __syncthreads();
        }

#pragma unroll
        for (int m = 0; m < kTileM; ++m) {
            const int gm = m0 + m;
            if (gm >= M) break;
            uint32_t* row = Cz + (long long)gm * N;
            if (kVec) {
                if (col[0] < N)
                    __stcs(reinterpret_cast<uint4*>(row + col[0]),
                           make_uint4(reduce64(acc[m][0], f.q, f.mu), reduce64(acc[m][1], f.q, f.mu),
                                      reduce64(acc[m][2], f.q, f.mu), reduce64(acc[m][3], f.q, f.mu)));
            } else {
#pragma unroll
                for (int v = 0; v < kTileN; ++v)
                    if (col[v] < N) row[col[v]] = reduce64(acc[m][v], f.q, f.mu);
            }
        }
    }
}

// --------------------------------------------------------------------------
// launchers
// --------------------------------------------------------------------------

constexpr int kMaxDevices = 64;

// Blocks of gf_matmul_rows<MT, kRagged> that the card `dev` (the current
// device) holds at once: worked out at the instantiation's first launch there,
// which also raises the kernel's dynamic shared-memory limit on that device,
// and kept, since both depend on the instantiation and the device alone. Two
// threads that race here make the same calls and store the same number.
// Returns 0, with the error in *err, where a call fails.
template <int MT, bool kRagged>
int rows_slots(int dev, cudaError_t* err) {
    static std::atomic<int> slots[kMaxDevices];  // zero: not yet worked out
    const int known = slots[dev].load(std::memory_order_relaxed);
    if (known > 0) return known;
    auto kernel = gf_matmul_rows<MT, kRagged>;
    constexpr size_t bytes = rows_smem_bytes<MT, kRagged>();
    int sms = 0, per_sm = 0;
    if ((*err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes)) !=
            cudaSuccess ||
        (*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kRowsThreads, bytes)) !=
            cudaSuccess)
        return 0;
    if (per_sm < 1) {
        *err = cudaErrorInvalidConfiguration;
        return 0;
    }
    slots[dev].store(sms * per_sm, std::memory_order_relaxed);
    return sms * per_sm;
}

template <int MT, bool kRagged>
int launch_rows(const uint32_t* a, const uint32_t* b, uint32_t* c, long long batch, int M, int K, long long N,
                Field f, int dev, cudaStream_t s) {
    cudaError_t e = cudaSuccess;
    const int slots = rows_slots<MT, kRagged>(dev, &e);
    if (slots == 0) return (int)e;
    const long long tiles = batch * ((N + RowTile<MT, kRagged>::TileN - 1) / RowTile<MT, kRagged>::TileN);
    const long long grid = tiles < slots ? tiles : slots;
    gf_matmul_rows<MT, kRagged><<<(unsigned int)grid, kRowsThreads, rows_smem_bytes<MT, kRagged>(), s>>>(
        a, b, c, batch, M, K, N, f);
    return (int)cudaGetLastError();
}

template <int MT>
int launch_row_tile(bool aligned, const uint32_t* a, const uint32_t* b, uint32_t* c, long long batch, int M,
                    int K, long long N, Field f, int dev, cudaStream_t s) {
    return aligned ? launch_rows<MT, false>(a, b, c, batch, M, K, N, f, dev, s)
                   : launch_rows<MT, true>(a, b, c, batch, M, K, N, f, dev, s);
}

}  // namespace

// m_tile: the row kernel's MT (1, 2, 4, 8 or 16, >= M), or 0 for the general
// kernel; the caller chooses it (repro_torch.kernels.gf_matmul.kernel.
// launch_plan), and a row tile below M is refused here. The row kernel takes
// its aligned form where N % 4 == 0 and B and C are 16-byte aligned, its
// ragged form otherwise; A, B and C must be 4-byte aligned.
// device: the index of the current device, on which the operands lie.
// Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() (0 on success), the error of the attribute and
// occupancy calls of an instantiation's first launch on a device, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int gf_matmul_launch(const void* A, const void* B, void* C, long long batch, int M, int K,
                                long long N, unsigned int q, int m_tile, int device, void* stream) {
    if (batch < 1 || M < 1 || K < 1 || N < 1 || q < 3 || q >= 0x80000000u || (q & 1u) == 0)
        return (int)cudaErrorInvalidValue;
    if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) % 4 != 0)
        return (int)cudaErrorInvalidValue;
    Field f;
    f.q = q;
    f.mu = 0xFFFFFFFFFFFFFFFFull / q;  // = floor(2^64 / q): an odd q > 1 does not divide 2^64
    const uint64_t r32_wide = (1ull << 32) % q;  // < 2^31, so the shift below stays in 64 bits
    f.r32 = (uint32_t)r32_wide;
    f.r32_pre = (uint32_t)((r32_wide << 32) / q);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* a = static_cast<const uint32_t*>(A);
    const uint32_t* b = static_cast<const uint32_t*>(B);
    uint32_t* c = static_cast<uint32_t*>(C);
    const bool aligned = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(C) % 16 == 0);
    if (m_tile != 0) {
        if (M > m_tile) return (int)cudaErrorInvalidValue;
        switch (m_tile) {
            case 1: return launch_row_tile<1>(aligned, a, b, c, batch, M, K, N, f, device, s);
            case 2: return launch_row_tile<2>(aligned, a, b, c, batch, M, K, N, f, device, s);
            case 4: return launch_row_tile<4>(aligned, a, b, c, batch, M, K, N, f, device, s);
            case 8: return launch_row_tile<8>(aligned, a, b, c, batch, M, K, N, f, device, s);
            case 16: return launch_row_tile<16>(aligned, a, b, c, batch, M, K, N, f, device, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    const long long gx = (N + kBlockN - 1) / kBlockN;
    const long long gy = ((long long)M + kTileM - 1) / kTileM;
    if (gx > 0x7FFFFFFFLL || gy > 65535) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned int)gx, (unsigned int)gy, (unsigned int)(batch < 65535 ? batch : 65535));
    if (aligned)
        gf_matmul_tiled<true><<<grid, kThreads, 0, s>>>(a, b, c, batch, M, K, N, f);
    else
        gf_matmul_tiled<false><<<grid, kThreads, 0, s>>>(a, b, c, batch, M, K, N, f);
    return (int)cudaGetLastError();
}
