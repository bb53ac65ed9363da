// Butterfly-round multiply-accumulate over GF(q), over gathered rows, for
// NVIDIA Hopper (sm_90a).
//
//   out[b, n] = sum_{r < radix} tw[b, r] * X_r[idx[r, b], n]   (mod q)
//
// Each X_r is a (rows_r, P) matrix of uint32 residues whose rows are
// `stride_r` elements apart (columns contiguous); either every r has its own
// X_r (n_sources = radix) or all share X_0 (n_sources = 1, a DFT round over
// one vector). idx is an optional (radix, B) int32 table of row indices on
// the device; without it the row is b. tw and tw_sh are (B, radix) with
// tw_sh[b, r] = floor(tw[b, r] * 2^32 / q) (the Shoup dual); out is a
// (B, P) whose rows are `out_stride` elements apart (columns contiguous: a
// block of columns of a wider output is written where it lies). Residues are
// canonical (< q < 2^31). Offsets are 64-bit: b * out_stride and idx * stride
// pass 2^31 at the coded widths.
//
// Replaces the TPU kernel `butterfly_mac_pallas` (body `_butterfly_kernel`) of
// src/repro/kernels/butterfly/kernel.py, which takes the dense (radix, B, P)
// stack of parts that its callers gather first. It computes the same function
// and is not a translation of it: the TPU body builds the high half of a
// 32x32-bit product from 16-bit limbs because that machine has no wide
// multiplier; here the Shoup quotient is one `__umulhi`, then a conditional
// subtract and an add mod q. Reading the parts through `idx` here removes the
// gather (a full read and write of radix * B * P words) that the dense form
// costs every caller before every round.
//
// What bounds it on this card: bytes. Each output element costs `radix` reads
// and one write of 4 bytes and about 5 integer instructions a part, far below
// the card's ratio of instruction rate to memory rate, and the tensor cores
// have no use at radix <= 8. The least time is (radix + 1) * B * P * 4 bytes
// over the memory rate.
//
// What the design does about it.
//  * A persistent grid: as many blocks as the SMs hold at once walk a
//    flattened space of (column tile, row) pairs, so one row of 2^20 words
//    (batch 1, the rank executor's shape) fills the card as 64 rows do, with
//    no tail of short blocks and no cap on B. Column tile major: the rows a
//    butterfly round reads twice (row b serves b and its neighbour in the
//    table) are read at nearly the same time, so the second read hits the
//    L2; row major put them a row of tiles apart, which at the LCC's 19.6 MB
//    rows is past the 50 MB L2.
//  * Ragged widths in one launch: a row is a scalar head up to the output's
//    16-byte boundary, a body of 16-byte chunks and a scalar tail of at most
//    3; the head and tail go to a few threads of the row's first tile.
//  * A source row whose 16-byte phase differs from its output row's (P % 4
//    != 0, a gathered neighbour row, a view) is read without breaking
//    coalescing: two 8-byte loads a chunk where the phases differ by 2 words,
//    four 4-byte loads where they differ by an odd number (a warp still
//    covers 512 contiguous bytes; L1 merges the four).
//  * Bytes in flight: each thread owns kGroups chunks of the tile, 256 chunks
//    apart, and issues the kGroups loads of a part before it folds them, so
//    kGroups * 16 bytes a part are in flight a thread, at 4 blocks of 256
//    threads an SM (at most 64 registers); the row's pointers, twiddles and
//    duals are staged in shared memory once a tile. (Streaming the parts
//    through a shared-memory ring with bulk copies and mbarriers measured
//    slower at every main-path shape on the H100.)
//  * The output is written 16 bytes a thread with a streaming hint.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxSources = 64;  // base pointers passed by value (the wrapper's cap)
constexpr int kThreads = 256;    // threads that compute
constexpr int kMaxDevices = 64;

struct Sources {
    const uint32_t* base[kMaxSources];
    long long stride[kMaxSources];  // elements between two rows
    long long rows[kMaxSources];    // rows it holds: idx is checked against it
};

__device__ __forceinline__ uint32_t shoup_mul(uint32_t a, uint32_t c, uint32_t c_pre, uint32_t q) {
    // t is floor(a*c/q) or one less, so a*c - t*q lies in [0, 2q) and is exact mod 2^32.
    uint32_t t = __umulhi(a, c_pre);
    uint32_t r = a * c - t * q;
    return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
    uint32_t s = a + b;  // both < q < 2^31: no wrap
    return s >= q ? s - q : s;
}

__device__ __forceinline__ int phase_of(const void* p) { return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3); }

// The row of X_r that output row b reads; a row outside X_r is a fault of the
// caller and traps, so that the launch fails instead of reading elsewhere.
__device__ __forceinline__ const uint32_t* source_row(const Sources& src, int n_sources, const int* idx, int r,
                                                      long long b, long long B) {
    const int s = n_sources == 1 ? 0 : r;
    long long row = b;
    if (idx != nullptr) {
        row = idx[(long long)r * B + b];
        if (row < 0 || row >= src.rows[s]) __trap();
    }
    return src.base[s] + row * src.stride[s];
}

// One row's split: `head` scalar columns up to the output's 16-byte boundary,
// `chunks` 16-byte chunks, then `tail` (< 4) scalar columns.
struct RowSplit {
    int head, tail;
    long long chunks;
};

__device__ __forceinline__ RowSplit split_row(const uint32_t* orow, long long P) {
    RowSplit s;
    s.head = (int)min((long long)((4 - phase_of(orow)) & 3), P);
    s.chunks = (P - s.head) / 4;
    s.tail = (int)(P - s.head - 4 * s.chunks);
    return s;
}

// The column of the head or tail that thread `tid` of a row's first tile
// owns, or -1.
__device__ __forceinline__ long long edge_column(const RowSplit& s, int tid, long long P) {
    if (tid < s.head) return tid;
    if (tid < s.head + s.tail) return P - s.tail + (tid - s.head);
    return -1;
}

// Four neighbouring words from global memory at a pointer whose 16-byte phase
// is `phase` (the same for every thread of the block).
__device__ __forceinline__ uint4 load_chunk(const uint32_t* p, int phase) {
    if (phase == 0) return __ldg(reinterpret_cast<const uint4*>(p));
    if (phase == 2) {
        const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
        const uint2 b = __ldg(reinterpret_cast<const uint2*>(p + 2));
        return make_uint4(a.x, a.y, b.x, b.y);
    }
    return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ void mac4(uint32_t acc[4], uint4 v, uint32_t c, uint32_t cp, uint32_t q) {
    acc[0] = add_mod(acc[0], shoup_mul(v.x, c, cp, q), q);
    acc[1] = add_mod(acc[1], shoup_mul(v.y, c, cp, q), q);
    acc[2] = add_mod(acc[2], shoup_mul(v.z, c, cp, q), q);
    acc[3] = add_mod(acc[3], shoup_mul(v.w, c, cp, q), q);
}

constexpr int kGroups = 4;                          // chunks a thread owns in a tile
constexpr int kTileChunks = kThreads * kGroups;  // 16 KB of a part a tile

__global__ void __launch_bounds__(kThreads, 4)
butterfly_mac_rows_kernel(Sources src, int n_sources, const int* __restrict__ idx, const uint32_t* __restrict__ tw,
                          const uint32_t* __restrict__ tw_sh, uint32_t* __restrict__ out, long long out_stride,
                          int radix, long long B, long long P, uint32_t q, long long tiles_per_row) {
    __shared__ const uint32_t* s_row[kMaxSources];  // X_r's row for this tile's output row
    __shared__ uint32_t s_c[kMaxSources], s_cp[kMaxSources];
    const int tid = threadIdx.x;
    const long long tiles = B * tiles_per_row;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long b = t % B, j = t / B;  // column-tile-major
        uint32_t* orow = out + b * out_stride;
        const RowSplit split = split_row(orow, P);
        __syncthreads();  // the last tile's readers are done with the staged row
        if (tid < radix) {
            s_row[tid] = source_row(src, n_sources, idx, tid, b, B);
            s_c[tid] = tw[b * radix + tid];
            s_cp[tid] = tw_sh[b * radix + tid];
        }
        __syncthreads();

        // the tile's chunks, from c0: thread tid owns chunks g * kThreads + tid < left
        const long long c0 = j * kTileChunks;
        const int left = (int)max(0ll, min((long long)kTileChunks, split.chunks - c0));
        const long long ecol = j == 0 ? edge_column(split, tid, P) : -1;
        uint32_t acc[kGroups][4] = {};
        uint32_t eacc = 0;
        for (int r = 0; r < radix; ++r) {
            const uint32_t* body = s_row[r] + split.head + 4 * c0;
            const uint32_t c = s_c[r], cp = s_cp[r];
            const int phase = phase_of(body);
            uint4 v[kGroups];
#pragma unroll
            for (int g = 0; g < kGroups; ++g) {  // every load of the part first: kGroups in flight
                const int k = g * kThreads + tid;
                v[g] = k < left ? load_chunk(body + 4 * k, phase) : make_uint4(0, 0, 0, 0);
            }
#pragma unroll
            for (int g = 0; g < kGroups; ++g) mac4(acc[g], v[g], c, cp, q);
            if (ecol >= 0) eacc = add_mod(eacc, shoup_mul(__ldg(s_row[r] + ecol), c, cp, q), q);
        }
        uint32_t* obody = orow + split.head + 4 * c0;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
            const int k = g * kThreads + tid;
            if (k < left)
                __stcs(reinterpret_cast<uint4*>(obody + 4 * k), make_uint4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]));
        }
        if (ecol >= 0) orow[ecol] = eacc;
    }
}

// Blocks of the kernel that the card `dev` holds at once, worked out at its
// first launch there and kept. Two threads that race here make the same calls
// and store the same number. Returns 0, with the error in *err, where a call
// fails.
int slots_of(int dev, cudaError_t* err) {
    static std::atomic<int> slots[kMaxDevices];  // zero: not yet worked out
    const int known = slots[dev].load(std::memory_order_relaxed);
    if (known > 0) return known;
    int sms = 0, per_sm = 0;
    if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, reinterpret_cast<const void*>(butterfly_mac_rows_kernel), kThreads, 0)) != cudaSuccess)
        return 0;
    if (per_sm < 1) {
        *err = cudaErrorInvalidConfiguration;
        return 0;
    }
    slots[dev].store(sms * per_sm, std::memory_order_relaxed);
    return sms * per_sm;
}

}  // namespace

// sources: n_sources base pointers (1, or radix), with each one's row stride
// (elements) and row count, host arrays read before this returns. idx: the
// device's (radix, B) int32 row table, or null. out_stride: elements between
// two output rows (at least P; any value when B is 1). device: the index of the
// current device, on which every operand lies. Launches on `stream`, does not
// synchronise, allocates nothing. Returns cudaGetLastError() (0 on success),
// the error of the occupancy calls of the first launch on a device, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int butterfly_mac_rows_launch(const void* const* bases, const long long* strides, const long long* rows,
                                         int n_sources, const void* idx, const void* tw, const void* tw_sh,
                                         void* out, long long out_stride, int radix, long long B, long long P,
                                         unsigned int q, int device, void* stream) {
    if (radix < 1 || radix > kMaxSources || B < 1 || P < 1 || q < 3 || q >= 0x80000000u)
        return (int)cudaErrorInvalidValue;
    if (n_sources != 1 && n_sources != radix) return (int)cudaErrorInvalidValue;
    if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (reinterpret_cast<uintptr_t>(out) % 4 != 0) return (int)cudaErrorInvalidValue;
    if (B == 1) out_stride = P;  // one row: its stride is never read
    if (out_stride < P) return (int)cudaErrorInvalidValue;
    Sources src = {};
    for (int i = 0; i < n_sources; ++i) {
        if (bases[i] == nullptr || strides[i] < P || rows[i] < 1 || reinterpret_cast<uintptr_t>(bases[i]) % 4 != 0)
            return (int)cudaErrorInvalidValue;
        if (idx == nullptr && rows[i] < B) return (int)cudaErrorInvalidValue;
        src.base[i] = static_cast<const uint32_t*>(bases[i]);
        src.stride[i] = strides[i];
        src.rows[i] = rows[i];
    }
    cudaError_t e = cudaSuccess;
    const int slots = slots_of(device, &e);
    if (slots == 0) return (int)e;
    const long long chunks = P / 4;  // every chunk of the body; a row has one tile at least
    const long long per_row = chunks > kTileChunks ? (chunks + kTileChunks - 1) / kTileChunks : 1;
    const long long tiles = B * per_row;
    butterfly_mac_rows_kernel<<<(unsigned int)(tiles < slots ? tiles : slots), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        src, n_sources, static_cast<const int*>(idx), static_cast<const uint32_t*>(tw),
        static_cast<const uint32_t*>(tw_sh), static_cast<uint32_t*>(out), out_stride, radix, B, P, q, per_row);
    return (int)cudaGetLastError();
}
