// Fused butterfly-round multiply-accumulate over GF(q) for NVIDIA Hopper (sm_90a).
//
//   out[b, n] = sum_{r < radix} tw[b, r] * parts[r, b, n]   (mod q)
//
// parts: (radix, B, P) uint32, tw and tw_sh: (B, radix) uint32 with
// tw_sh[b, r] = floor(tw[b, r] * 2^32 / q) (the Shoup dual), out: (B, P) uint32.
// All tensors are dense and row-major; residues are canonical (< q < 2^31).
//
// Replaces the TPU kernel `butterfly_mac_pallas` (body `_butterfly_kernel`) of
// src/repro/kernels/butterfly/kernel.py. It computes the same function and is
// not a translation of it: the TPU body builds the high half of a 32x32-bit
// product from 16-bit limbs because that machine has no wide multiplier;
// here the Shoup quotient is one `__umulhi`.
//
// What bounds it on this card: bytes. Each output element costs `radix` reads
// and one write of 4 bytes and about 5 integer instructions per part, far
// below the card's ratio of instruction rate to memory rate. The least time
// is (radix + 1) * B * P * 4 bytes over the memory rate.
//
// What the design does about it: every part is read exactly once and the
// (B, P) intermediates of the radix products stay in registers; one thread
// owns 4 neighbouring payload columns so that loads and stores are 16 bytes
// wide and a warp touches 512 contiguous bytes per part; the twiddles of a
// row are 2 * radix words that every thread of the block reads from the same
// address (one broadcast transaction, served by L1 afterwards). A scalar
// variant with the same arithmetic serves payload widths that are not a
// multiple of 4 or buffers that are not 16-byte aligned.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// One thread: 4 neighbouring columns of one row. grid.x walks the payload,
// grid.y walks the rows (with a stride loop, so any B fits the grid limit).
__global__ void __launch_bounds__(kThreads)
butterfly_mac_vec4(const uint32_t* __restrict__ parts, const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ tw_sh, uint32_t* __restrict__ out,
                   int radix, long long B, long long P, uint32_t q) {
    const long long n = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
    if (n >= P) return;
    for (long long b = blockIdx.y; b < B; b += gridDim.y) {
        uint32_t acc0 = 0, acc1 = 0, acc2 = 0, acc3 = 0;
        for (int r = 0; r < radix; ++r) {
            const uint32_t c = tw[b * radix + r];
            const uint32_t c_pre = tw_sh[b * radix + r];
            const uint4 v = *reinterpret_cast<const uint4*>(parts + ((long long)r * B + b) * P + n);
            acc0 = add_mod(acc0, shoup_mul(v.x, c, c_pre, q), q);
            acc1 = add_mod(acc1, shoup_mul(v.y, c, c_pre, q), q);
            acc2 = add_mod(acc2, shoup_mul(v.z, c, c_pre, q), q);
            acc3 = add_mod(acc3, shoup_mul(v.w, c, c_pre, q), q);
        }
        *reinterpret_cast<uint4*>(out + b * P + n) = make_uint4(acc0, acc1, acc2, acc3);
    }
}

// Same arithmetic, one column a thread: any P, any alignment.
__global__ void __launch_bounds__(kThreads)
butterfly_mac_scalar(const uint32_t* __restrict__ parts, const uint32_t* __restrict__ tw,
                     const uint32_t* __restrict__ tw_sh, uint32_t* __restrict__ out,
                     int radix, long long B, long long P, uint32_t q) {
    const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (n >= P) return;
    for (long long b = blockIdx.y; b < B; b += gridDim.y) {
        uint32_t acc = 0;
        for (int r = 0; r < radix; ++r) {
            const uint32_t a = parts[((long long)r * B + b) * P + n];
            acc = add_mod(acc, shoup_mul(a, tw[b * radix + r], tw_sh[b * radix + r], q), q);
        }
        out[b * P + n] = acc;
    }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int butterfly_mac_launch(const void* parts, const void* tw, const void* tw_sh, void* out,
                                    int radix, long long B, long long P, unsigned int q,
                                    void* stream) {
    if (radix < 1 || B < 1 || P < 1 || q < 3 || q >= 0x80000000u) return (int)cudaErrorInvalidValue;
    const uint32_t* parts_u = static_cast<const uint32_t*>(parts);
    const uint32_t* tw_u = static_cast<const uint32_t*>(tw);
    const uint32_t* tw_sh_u = static_cast<const uint32_t*>(tw_sh);
    uint32_t* out_u = static_cast<uint32_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned int gy = (unsigned int)(B < 65535 ? B : 65535);
    const bool aligned = (P % 4 == 0) && (reinterpret_cast<uintptr_t>(parts) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    if (aligned) {
        const long long gx = (P / 4 + kThreads - 1) / kThreads;
        if (gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        butterfly_mac_vec4<<<dim3((unsigned int)gx, gy), kThreads, 0, s>>>(
            parts_u, tw_u, tw_sh_u, out_u, radix, B, P, q);
    } else {
        const long long gx = (P + kThreads - 1) / kThreads;
        if (gx > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        butterfly_mac_scalar<<<dim3((unsigned int)gx, gy), kThreads, 0, s>>>(
            parts_u, tw_u, tw_sh_u, out_u, radix, B, P, q);
    }
    return (int)cudaGetLastError();
}
