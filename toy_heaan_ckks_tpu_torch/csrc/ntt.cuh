// Shared device routines of the CKKS kernels (K1/K5 NTT, K2/K6 key
// switch, K3/K8 mod-down): modular arithmetic on one-word residues and the
// tree-order negacyclic NTT of one N-point plane held in shared memory,
// templated on the word type:
//
//   uint32_t  small chains, every q < 2^31, Shoup/Montgomery radix 2^32;
//   uint64_t  wide chains, every q < 2^63, Shoup/Montgomery radix 2^64.
//
// Conventions (those of toy_heaan_ckks_tpu/ops/ntt.py and ntt_pallas.py):
// stage s = 0 .. log2(N)-1 runs distance-d butterflies, d = N >> (s+1);
// butterfly b pairs positions u = 2d*g + i and v = u + d (g = b / d,
// i = b % d), and group g uses twiddle tw[2^s + g] of the compact per-stage
// table (entry 0 unused). Forward (Cooley-Tukey): x_u + w*x_v, x_u - w*x_v.
// Inverse (Gentleman-Sande, stages in reverse): x_u + x_v, (x_u - x_v)*w.
// Every multiply by a table constant is a Harvey/Shoup multiply with the
// companion w' = floor(w * 2^bits / q); every output is canonical in
// [0, q), so the results are bit-identical to the reference's. The wide
// butterflies are non-lazy: the reference's [0, 4q) lazy form would
// overflow 64 bits for the 63-bit special primes of a 62-bit chain.
//
// A plane is held on chip for the whole transform. The templates here
// hold it in one block, up to 128 KiB, one barrier a stage; they run the
// uint64 one-block forms of K5 / K7 and K8 (N <= 2^14) and of K6 (N <=
// 2^12), uint32 planes below 2^10, and K10 on slabs below 2^10. The other
// planes run register passes (ntt_reg.cuh: uint32 one-block planes of
// 2^10 .. 2^15, K10's slabs of 2^10 words and up), and a plane above 128
// KiB, or K6's uint64 plane of 2^13 / 2^14, ntt_cluster.cuh's plan over a
// thread-block cluster of register passes. This replaces the reference's
// factored row x lane twiddles (ntt_pallas.py _ntt_kernel_fac, K4;
// ntt_pallas_wide.py _ntt_kernel_fac_wide, K5'), which exist because the
// TPU expands each stage's twiddles to a full plane: the compact tables
// here already fit, so what a large ring needs is more than one SM.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace ckks {

constexpr int kThreads = 512;  // threads per block of every kernel

__device__ __forceinline__ uint32_t mulhi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}

__device__ __forceinline__ uint64_t mulhi(uint64_t a, uint64_t b) {
  return __umul64hi(a, b);
}

// Read-only-cache loads of table words.
__device__ __forceinline__ uint32_t ldg(const uint32_t* p) { return __ldg(p); }

__device__ __forceinline__ uint64_t ldg(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

// x * w mod q for any word x, w < q < 2^(bits-1) (Harvey: r = x*w - h*q
// lies in [0, 2q), then one conditional subtract).
template <typename T>
__device__ __forceinline__ T harvey(T x, T w, T wp, T q) {
  const T h = mulhi(x, wp);
  const T r = x * w - h * q;
  return r >= q ? r - q : r;
}

template <typename T>
__device__ __forceinline__ T add_mod(T a, T b, T q) {
  const T s = a + b;  // a, b < q < 2^(bits-1): no wrap
  return s >= q ? s - q : s;
}

template <typename T>
__device__ __forceinline__ T sub_mod(T a, T b, T q) {
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

// Montgomery product a*b*2^-64 mod q, a, b < q < 2^63; qinv = -q^-1 mod
// 2^64 (toy_heaan_ckks_tpu/ops/keyswitch_pallas_wide.py _redc64). The
// 128-bit t = a*b and m*q are (lo, hi) word pairs; t + m*q < 2^126 + 2^127
// does not wrap, its low word is 0 mod 2^64 and carries out exactly when
// t_lo != 0, and its high word is below 2q.
__device__ __forceinline__ uint64_t mont_redc(uint64_t a, uint64_t b,
                                              uint64_t q, uint64_t qinv) {
  const uint64_t t_lo = a * b;
  const uint64_t t_hi = __umul64hi(a, b);
  const uint64_t m = t_lo * qinv;
  const uint64_t mq_hi = __umul64hi(m, q);
  const uint64_t r = t_hi + mq_hi + (t_lo != 0 ? 1u : 0u);
  return r >= q ? r - q : r;
}

// The slice of one block: dynamic shared memory seen as words of type T.
template <typename T>
__device__ __forceinline__ T* smem_plane() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// Where one block's slice lies in its (item, channel) plane of
// N = 2^log_n words: the block holds the whole plane (rank 0 of P = 1, the
// slice at offset 0), the plane blockIdx.x. The kernels that take it keep
// kCluster in their names; it is false in every one of them.
template <bool kCluster>
struct PlanePart {
  static_assert(!kCluster, "a plane above one block runs ntt_cluster.cuh's plan");
  int rank;       // block rank in the cluster
  int log_parts;  // log2 P
  int log_m;      // log2 M
  long long off;  // r * M: the plane position of the slice's first word
  unsigned int plane;

  __device__ __forceinline__ explicit PlanePart(int log_n) {
    rank = 0;
    log_parts = 0;
    log_m = log_n - log_parts;
    off = static_cast<long long>(rank) << log_m;
    plane = blockIdx.x >> log_parts;
  }

  __device__ __forceinline__ int size() const { return 1 << log_m; }
};

// Forward stages [first, log_n) on one block's slice s of M = 2^log_m
// words, rank r of the plane (every butterfly of these stages, d < M, lies
// in one slice). Global butterfly b = r*M/2 + j keeps the twiddle index of
// the whole plane. The caller has synchronised after writing s; returns
// synchronised.
template <typename T>
__device__ __forceinline__ void forward_local(T* s, int log_n, int log_m,
                                              int rank, int first,
                                              const T* __restrict__ tw,
                                              const T* __restrict__ twp, T q) {
  const int hm = 1 << (log_m - 1);
  const int b0 = rank << (log_m - 1);
  const int u0 = rank << log_m;
  for (int st = first; st < log_n; ++st) {
    const int log_d = log_n - 1 - st;
    const int d = 1 << log_d;
    for (int j = threadIdx.x; j < hm; j += blockDim.x) {
      const int b = b0 + j;
      const int g = b >> log_d;
      const int u = ((g << (log_d + 1)) | (b & (d - 1))) - u0;
      const int k = (1 << st) + g;
      const T xu = s[u];
      const T xv = harvey(s[u + d], ldg(tw + k), ldg(twp + k), q);
      s[u] = add_mod(xu, xv, q);
      s[u + d] = sub_mod(xu, xv, q);
    }
    __syncthreads();
  }
}

// Inverse stages log_n-1 down to `last` on one block's slice, same
// contract as forward_local.
template <typename T>
__device__ __forceinline__ void inverse_local(T* s, int log_n, int log_m,
                                              int rank, int last,
                                              const T* __restrict__ tw,
                                              const T* __restrict__ twp, T q) {
  const int hm = 1 << (log_m - 1);
  const int b0 = rank << (log_m - 1);
  const int u0 = rank << log_m;
  for (int st = log_n - 1; st >= last; --st) {
    const int log_d = log_n - 1 - st;
    const int d = 1 << log_d;
    for (int j = threadIdx.x; j < hm; j += blockDim.x) {
      const int b = b0 + j;
      const int g = b >> log_d;
      const int u = ((g << (log_d + 1)) | (b & (d - 1))) - u0;
      const int k = (1 << st) + g;
      const T xu = s[u];
      const T xv = s[u + d];
      s[u] = add_mod(xu, xv, q);
      s[u + d] = harvey(sub_mod(xu, xv, q), ldg(tw + k), ldg(twp + k), q);
    }
    __syncthreads();
  }
}

// All forward stages of the plane. The caller has written its slice and
// synchronised its block; returns with the block synchronised.
template <typename T, bool kCluster>
__device__ __forceinline__ void ntt_forward(T* s, const PlanePart<kCluster>& pp,
                                            int log_n,
                                            const T* __restrict__ tw,
                                            const T* __restrict__ twp, T q) {
  forward_local(s, log_n, pp.log_m, pp.rank, pp.log_parts, tw, twp, q);
}

// All inverse stages (without the final N^-1 factor), same contract.
template <typename T, bool kCluster>
__device__ __forceinline__ void ntt_inverse(T* s, const PlanePart<kCluster>& pp,
                                            int log_n,
                                            const T* __restrict__ tw,
                                            const T* __restrict__ twp, T q) {
  inverse_local(s, log_n, pp.log_m, pp.rank, pp.log_parts, tw, twp, q);
}

// Dynamic shared memory of one plane of T; above 48 KiB the kernel must
// opt in (a uint64 plane is 64 KiB at 2^13 and 128 KiB at 2^14).
template <typename T>
inline size_t plane_bytes(int log_n) {
  return sizeof(T) << log_n;
}

inline cudaError_t reserve_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Returned when no cluster of the requested size, with its shared memory,
// can be resident on the device (cudaOccupancyMaxActiveClusters == 0).
constexpr int kErrClusterDoesNotFit = 100001;

}  // namespace ckks
