// K1 / K4 / K5+K7 / K5': the fused negacyclic NTT of whole planes, forward
// or inverse.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/ntt_pallas.py
// _ntt_kernel (K1) and _ntt_kernel_fac (K4, N = 2^16) for small chains
// (uint32 words: ckks_ntt), and, for wide chains (uint64 words:
// ckks_ntt64), ops/ntt_pallas_wide.py _ntt_kernel_wide (K5) and
// _ntt_kernel_fac_wide (K5', N >= 2^15) and ops/keyswitch_pallas_wide.py
// _inv_yhat_kernel_wide (K7, the inverse with a folded final constant).
// One block, or one cluster of 2 or 4 blocks for a plane above 128 KiB
// (ntt.cuh PlanePart), owns one (item, channel) plane of N residues: it
// loads the plane once, runs all log2(N) butterfly stages in shared
// memory, applies the per-channel final constant (inverse only: N^-1, or
// the folded constants of the mod-down yhat emission / the decomposition
// fold) and writes the plane once. Device memory traffic is one read and
// one write of the plane plus the compact twiddle tables. What bounds it on
// an H100: the serial chain of log2(N) shared-memory stages, each closed by
// __syncthreads (a cluster barrier for the cross-block stages); for uint64
// words also the integer pipe, since each butterfly's Harvey multiply is
// several 32-bit multiply instructions.
//
// uint32 planes that one block holds (N = 2^10 .. 2^15) run another body,
// ntt_kernel_reg<log2 N, inverse>; the uint64 form and the cluster form
// (N = 2^16) run ntt_kernel above. Its design is K2's NTT
// (csrc/ntt_reg.cuh): N / 32 threads of 32 words, 5+5+4 stages at 2^14 in
// registers with one shared-memory exchange between passes, each
// twiddle loaded once per pass and thread:
//
// - The forward runs the passes in order from pass 0's coalesced loads,
//   and its last pass's runs of 2^r adjacent words go back to pass 0's
//   layout through shared memory for a coalesced store (storing the runs
//   as 16-byte vectors, one exchange fewer, was 18-25% slower).
// - The inverse loads the runs of its first pass (the forward's last) as
//   16-byte vectors (0-4% faster than coalesced words and one more
//   exchange), runs the passes in reverse, each with its Gentleman-Sande
//   stages from the last down, and applies the final constant (N^-1, the
//   decomposition fold's or yhat's constants) in pass 0's layout before a
//   coalesced store.
// - Block barriers: the forward 3 at 2^11 .. 2^15, 2 at 2^10, the inverse
//   one fewer (15 in ntt_kernel at 2^14).
// - Two blocks of 512 threads an SM at 2^14 (64 registers, no spill;
//   2 x 66 KiB of shared memory): the main path's 256 (forward, inverse
//   with the fold) and 160 (yhat) blocks are all resident at once.
// - Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py,
//   device time, (32, 8, 2^14)): forward 0.028 ms against 0.065 for
//   ntt_kernel, inverse with the fold 0.030 (0.076), yhat at (32, 5)
//   0.028 (0.064); at one block an SM 0.030 / 0.032 / 0.030.
#include "ntt.cuh"
#include "ntt_reg.cuh"

namespace {

template <typename T, bool kCluster>
__global__ void __launch_bounds__(ckks::kThreads)
ntt_kernel(const T* __restrict__ x, long long x_stride, T* __restrict__ out,
           const T* __restrict__ tw, const T* __restrict__ twp,
           const T* __restrict__ q, const T* __restrict__ fin,
           const T* __restrict__ finp, int channels, int log_n,
           int inverse) {
  T* s = ckks::smem_plane<T>();
  const ckks::PlanePart<kCluster> pp(log_n);
  const int n = 1 << log_n;
  const int m = pp.size();
  const int ch = pp.plane % channels;
  const long long item = pp.plane / channels;
  const T qc = q[ch];
  const T* src = x + item * x_stride + static_cast<long long>(ch) * n + pp.off;
  T* dst = out + (item * channels + ch) * static_cast<long long>(n) + pp.off;
  const T* w = tw + static_cast<long long>(ch) * n;
  const T* wp = twp + static_cast<long long>(ch) * n;

  for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  if (inverse) {
    ckks::ntt_inverse(s, pp, log_n, w, wp, qc);
  } else {
    ckks::ntt_forward(s, pp, log_n, w, wp, qc);
  }
  if (fin != nullptr) {
    const T f = fin[ch], fp = finp[ch];
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      dst[i] = ckks::harvey(s[i], f, fp, qc);
  } else {
    for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = s[i];
  }
}

template <typename T>
int launch_ntt(const T* x, long long x_stride, T* out, const T* tw,
               const T* twp, const T* q, const T* fin, const T* finp,
               int outer, int channels, int log_n, int parts, int inverse,
               cudaStream_t stream) {
  return ckks::launch_planes<T>(ntt_kernel<T, false>, ntt_kernel<T, true>,
                                outer * channels, log_n, parts, stream, x,
                                x_stride, out, tw, twp, q, fin, finp,
                                channels, log_n, inverse);
}

using ckks::kLogRegWords;
using ckks::kRegWords;
using ckks::RegPlan;

// dst[m * N/32 + tid] = a[m] * fin (Harvey), or a[m] without fin.
template <int kLogN>
__device__ __forceinline__ void store_words(uint32_t* __restrict__ dst,
                                            const uint32_t (&a)[kRegWords], int tid,
                                            const uint32_t* __restrict__ f,
                                            const uint32_t* __restrict__ fp,
                                            uint32_t q) {
  constexpr int kT = RegPlan<kLogN>::kThreads;
  if (f != nullptr) {
    const uint32_t fv = *f, fpv = *fp;
#pragma unroll
    for (int m = 0; m < kRegWords; ++m) dst[m * kT + tid] = ckks::harvey(a[m], fv, fpv, q);
  } else {
#pragma unroll
    for (int m = 0; m < kRegWords; ++m) dst[m * kT + tid] = a[m];
  }
}

// K1 on uint32 planes that one block holds (see the header): one block of
// N / 32 threads per (item, channel) plane.
template <int kLogN, bool kInverse>
__global__ void __launch_bounds__(RegPlan<kLogN>::kThreads,
                                  RegPlan<kLogN>::kMinBlocksTwo)
ntt_kernel_reg(const uint32_t* __restrict__ x, long long x_stride,
               uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ twp, const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ fin, const uint32_t* __restrict__ finp,
               int channels) {
  using Last = ckks::RegLast<kLogN>;
  using P0 = ckks::RegPass<kLogN, 0, kLogRegWords>;
  constexpr long long n = 1LL << kLogN;
  constexpr int kT = RegPlan<kLogN>::kThreads;
  uint32_t* s = ckks::smem_plane<uint32_t>();
  const int tid = threadIdx.x;
  const int ch = blockIdx.x % channels;
  const long long item = blockIdx.x / channels;
  const uint32_t qc = q[ch];
  const uint32_t* src = x + item * x_stride + ch * n;
  uint32_t* dst = out + (item * channels + ch) * n;
  const uint32_t* w = tw + ch * n;
  const uint32_t* wp = twp + ch * n;
  const uint32_t* f = fin == nullptr ? nullptr : fin + ch;
  const uint32_t* fp = fin == nullptr ? nullptr : finp + ch;

  uint32_t a[kRegWords];
  if constexpr (!kInverse) {
#pragma unroll
    for (int m = 0; m < kRegWords; ++m) a[m] = ckks::ldg(src + m * kT + tid);
    ckks::reg_forward<kLogN>(s, a, tid, w, wp, qc);
    Last::store(s, a, tid);
    __syncthreads();
    P0::load(s, a, tid);
  } else {
    ckks::load_runs<Last>(src, a, tid);
    ckks::reg_inverse<kLogN>(s, a, tid, w, wp, qc);
  }
  store_words<kLogN>(dst, a, tid, f, fp, qc);
}

template <int kLogN, bool kInverse>
const void* reg_kernel() {
  return reinterpret_cast<const void*>(ntt_kernel_reg<kLogN, kInverse>);
}

template <int kLogN, bool kInverse>
int launch_reg(const uint32_t* x, long long x_stride, uint32_t* out,
               const uint32_t* tw, const uint32_t* twp, const uint32_t* q,
               const uint32_t* fin, const uint32_t* finp, int outer,
               int channels, cudaStream_t stream) {
  using Plan = RegPlan<kLogN>;
  const cudaError_t err =
      ckks::reserve_smem(reg_kernel<kLogN, kInverse>(), Plan::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_kernel_reg<kLogN, kInverse><<<outer * channels, Plan::kThreads,
                                    Plan::kSmemBytes, stream>>>(
      x, x_stride, out, tw, twp, q, fin, finp, channels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (outer, channels, N) with item stride x_stride (elements); out:
// contiguous (outer, channels, N); tw/twp: (channels, N) compact twiddles of
// the direction; q/fin/finp: (channels,); fin == nullptr skips the final
// multiply; parts: blocks per plane (1, or a cluster of 2 or 4). The
// inverse with parts == 1 and N in [2^10, 2^15] reads x as 16-byte
// vectors: x 16-byte aligned, x_stride a multiple of 4. Returns the
// launch's error code (0 on success).
extern "C" int ckks_ntt(const uint32_t* x, long long x_stride, uint32_t* out,
                        const uint32_t* tw, const uint32_t* twp,
                        const uint32_t* q, const uint32_t* fin,
                        const uint32_t* finp, int outer, int channels,
                        int log_n, int parts, int inverse,
                        cudaStream_t stream) {
  if (parts == 1 && ckks::reg_shape(log_n)) {
    return ckks::reg_dispatch(log_n, [&](auto log_n_c) {
      constexpr int kLogN = decltype(log_n_c)::value;
      return inverse ? launch_reg<kLogN, true>(x, x_stride, out, tw, twp, q, fin,
                                               finp, outer, channels, stream)
                     : launch_reg<kLogN, false>(x, x_stride, out, tw, twp, q, fin,
                                                finp, outer, channels, stream);
    });
  }
  return launch_ntt(x, x_stride, out, tw, twp, q, fin, finp, outer, channels,
                    log_n, parts, inverse, stream);
}

// The same on uint64 words (wide chains, radix-2^64 Shoup companions).
extern "C" int ckks_ntt64(const uint64_t* x, long long x_stride,
                          uint64_t* out, const uint64_t* tw,
                          const uint64_t* twp, const uint64_t* q,
                          const uint64_t* fin, const uint64_t* finp,
                          int outer, int channels, int log_n, int parts,
                          int inverse, cudaStream_t stream) {
  return launch_ntt(x, x_stride, out, tw, twp, q, fin, finp, outer, channels,
                    log_n, parts, inverse, stream);
}

const void* ckks::ntt_reg_kernel(int log_n, bool inverse) {
  if (!reg_shape(log_n)) return nullptr;
  return reg_dispatch(log_n, [inverse](auto log_n_c) {
    constexpr int kLogN = decltype(log_n_c)::value;
    return inverse ? reg_kernel<kLogN, true>() : reg_kernel<kLogN, false>();
  });
}

extern "C" const char* ckks_error_string(int code) {
  if (code == ckks::kErrClusterDoesNotFit)
    return "no thread-block cluster of this size and shared memory fits the "
           "device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
