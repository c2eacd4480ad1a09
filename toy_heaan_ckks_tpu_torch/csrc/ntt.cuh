// Shared device routines of the CKKS kernels (K1 NTT, K2 key switch,
// K3 mod-down): modular arithmetic on uint32 residues of primes q < 2^31,
// and the tree-order negacyclic NTT of one N-point plane held in shared
// memory.
//
// Conventions (those of toy_heaan_ckks_tpu/ops/ntt.py and ntt_pallas.py):
// stage s = 0 .. log2(N)-1 runs distance-d butterflies, d = N >> (s+1);
// butterfly b pairs positions u = 2d*g + i and v = u + d (g = b / d,
// i = b % d), and group g uses twiddle tw[2^s + g] of the compact per-stage
// table (entry 0 unused). Forward (Cooley-Tukey): x_u + w*x_v, x_u - w*x_v.
// Inverse (Gentleman-Sande, stages in reverse): x_u + x_v, (x_u - x_v)*w.
// Every multiply by a table constant is a Harvey/Shoup multiply with the
// companion w' = floor(w * 2^32 / q); every output is canonical in [0, q),
// so the results are bit-identical to the reference's.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ckks {

constexpr int kThreads = 512;  // threads per block of every kernel

// x * w mod q for any x < 2^32, w < q < 2^31 (Harvey: [0, 2q) then one
// conditional subtract).
__device__ __forceinline__ uint32_t harvey(uint32_t x, uint32_t w,
                                           uint32_t wp, uint32_t q) {
  uint32_t h = __umulhi(x, wp);
  uint32_t r = x * w - h * q;
  return r >= q ? r - q : r;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  uint32_t s = a + b;  // a, b < q < 2^31: no wrap
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

// Montgomery product a*b*2^-32 mod q, a, b < q < 2^31; qinv = -q^-1 mod 2^32.
// t + m*q < 2^62 + 2^63 fits in 64 bits.
__device__ __forceinline__ uint32_t mont_redc(uint32_t a, uint32_t b,
                                              uint32_t q, uint32_t qinv) {
  uint64_t t = static_cast<uint64_t>(a) * b;
  uint32_t m = static_cast<uint32_t>(t) * qinv;
  uint32_t r = static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
  return r >= q ? r - q : r;
}

// All forward stages on the plane s[0, 2^log_n) in shared memory. The
// caller has synchronised after writing s; returns synchronised.
__device__ __forceinline__ void ntt_forward_smem(uint32_t* s, int log_n,
                                                 const uint32_t* __restrict__ tw,
                                                 const uint32_t* __restrict__ twp,
                                                 uint32_t q) {
  const int half = 1 << (log_n - 1);
  for (int st = 0; st < log_n; ++st) {
    const int log_d = log_n - 1 - st;
    const int d = 1 << log_d;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> log_d;
      const int u = (g << (log_d + 1)) | (b & (d - 1));
      const int k = (1 << st) + g;
      const uint32_t xu = s[u];
      const uint32_t xv = harvey(s[u + d], __ldg(tw + k), __ldg(twp + k), q);
      s[u] = add_mod(xu, xv, q);
      s[u + d] = sub_mod(xu, xv, q);
    }
    __syncthreads();
  }
}

// All inverse stages (without the final N^-1 factor), same contract.
__device__ __forceinline__ void ntt_inverse_smem(uint32_t* s, int log_n,
                                                 const uint32_t* __restrict__ tw,
                                                 const uint32_t* __restrict__ twp,
                                                 uint32_t q) {
  const int half = 1 << (log_n - 1);
  for (int st = log_n - 1; st >= 0; --st) {
    const int log_d = log_n - 1 - st;
    const int d = 1 << log_d;
    for (int b = threadIdx.x; b < half; b += blockDim.x) {
      const int g = b >> log_d;
      const int u = (g << (log_d + 1)) | (b & (d - 1));
      const int k = (1 << st) + g;
      const uint32_t xu = s[u];
      const uint32_t xv = s[u + d];
      s[u] = add_mod(xu, xv, q);
      s[u + d] = harvey(sub_mod(xu, xv, q), __ldg(tw + k), __ldg(twp + k), q);
    }
    __syncthreads();
  }
}

// Dynamic shared memory of one plane; above 48 KiB the kernel must opt in.
inline cudaError_t reserve_smem(const void* kernel, int log_n) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(uint32_t)) << log_n);
}

}  // namespace ckks
