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
// Here a 32x32 -> 64-bit multiply-add is one instruction, thread blocks run in
// no order, and so the whole K loop runs inside the block with the sums in
// registers.
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
// [0, 2q) and one conditional subtraction finishes.
//
// What bounds it on this card. At the encode path's shape (batch 64, an 8x8
// coefficient block against an 8 x 2^20 slot buffer) the operand B and the
// result are each read or written once and A is negligible, so the least
// time is batch * (K*N + M*N) * 4 bytes over the memory rate; the arithmetic
// is M*K multiply-adds for every K + M words moved, and with a full
// reduction after every fourth product (the first version of this kernel,
// about 5 integer instructions a multiply-add) the integer pipes, not the
// memory, set the time. The cheap fold above is what brings the arithmetic
// back towards the memory time. For square shapes the product is bound by
// operations, and the int8 tensor-core limb form is the faster design; this
// kernel is the simple exact one.
//
// What the design does about it. A block owns an 8-row by 1024-column tile
// of C. Each of its 256 threads keeps 8 x 4 accumulators in registers and
// reads every needed element of B exactly once, as 16-byte loads of 4
// neighbouring columns (a warp reads 512 contiguous bytes a row of B). The
// 8 x 32 slice of A that a K step needs is staged in shared memory and read
// by all threads at the same address (a broadcast). Nothing is padded or
// copied: the ragged edges in M, K and N are masked in the kernel. When N is
// not a multiple of 4 or a buffer is not 16-byte aligned, a variant with
// scalar, block-strided (coalesced) column accesses does the same arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 8;    // rows of C a block owns
constexpr int kTileN = 4;    // columns of C a thread owns
constexpr int kTileK = 32;   // K step staged in shared memory (multiple of 4)
constexpr int kBlockN = kThreads * kTileN;

// x -> a value below 2^33 in the residue class of x (see "Exactness").
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

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint32_t* __restrict__ A, const uint32_t* __restrict__ B,
                 uint32_t* __restrict__ C, int M, int K, long long N, uint32_t q, uint64_t mu,
                 uint32_t r32, uint32_t r32_pre) {
    __shared__ uint32_t a_tile[kTileM][kTileK];

    const int tid = threadIdx.x;
    const int m0 = blockIdx.y * kTileM;
    const long long z = blockIdx.z;
    A += z * (long long)M * K;
    B += z * (long long)K * N;
    C += z * (long long)M * N;

    // Column of C (and of B) that accumulator v of this thread belongs to.
    const long long block_n0 = (long long)blockIdx.x * kBlockN;
    long long col[kTileN];
#pragma unroll
    for (int v = 0; v < kTileN; ++v)
        col[v] = kVec ? block_n0 + (long long)tid * kTileN + v : block_n0 + (long long)v * kThreads + tid;

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
            a_tile[m][kk] = (gm < M && gk < K) ? A[(long long)gm * K + gk] : 0u;
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
                    const uint32_t* row = B + (long long)gk * N;
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
                for (int v = 0; v < kTileN; ++v) acc[m][v] = fold64(acc[m][v], q, r32, r32_pre);
        }
        __syncthreads();
    }

    // Every accumulator is below 2^33 here (K >= 1 ends with a fold): one full reduction.
#pragma unroll
    for (int m = 0; m < kTileM; ++m) {
        const int gm = m0 + m;
        if (gm >= M) break;
        uint32_t* row = C + (long long)gm * N;
        if (kVec) {
            if (col[0] < N)
                *reinterpret_cast<uint4*>(row + col[0]) =
                    make_uint4(reduce64(acc[m][0], q, mu), reduce64(acc[m][1], q, mu),
                               reduce64(acc[m][2], q, mu), reduce64(acc[m][3], q, mu));
        } else {
#pragma unroll
            for (int v = 0; v < kTileN; ++v)
                if (col[v] < N) row[col[v]] = reduce64(acc[m][v], q, mu);
        }
    }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int gf_matmul_launch(const void* A, const void* B, void* C, int batch, int M, int K,
                                long long N, unsigned int q, void* stream) {
    if (batch < 1 || M < 1 || K < 1 || N < 1 || q < 3 || q >= 0x80000000u || (q & 1u) == 0)
        return (int)cudaErrorInvalidValue;
    const long long gx = (N + kBlockN - 1) / kBlockN;
    const long long gy = ((long long)M + kTileM - 1) / kTileM;
    if (gx > 0x7FFFFFFFLL || gy > 65535 || batch > 65535) return (int)cudaErrorInvalidValue;
    const uint64_t mu = 0xFFFFFFFFFFFFFFFFull / q;  // = floor(2^64 / q): an odd q > 1 does not divide 2^64
    const uint64_t r32_wide = (1ull << 32) % q;  // < 2^31, so the shift below stays in 64 bits
    const uint32_t r32 = (uint32_t)r32_wide;
    const uint32_t r32_pre = (uint32_t)((r32_wide << 32) / q);
    const dim3 grid((unsigned int)gx, (unsigned int)gy, (unsigned int)batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* a = static_cast<const uint32_t*>(A);
    const uint32_t* b = static_cast<const uint32_t*>(B);
    uint32_t* c = static_cast<uint32_t*>(C);
    const bool aligned = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(C) % 16 == 0);
    if (aligned)
        gf_matmul_kernel<true><<<grid, kThreads, 0, s>>>(a, b, c, M, K, N, q, mu, r32, r32_pre);
    else
        gf_matmul_kernel<false><<<grid, kThreads, 0, s>>>(a, b, c, M, K, N, q, mu, r32, r32_pre);
    return (int)cudaGetLastError();
}
