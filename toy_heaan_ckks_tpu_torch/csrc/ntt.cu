// K1 / K4 / K5+K7 / K5': the fused negacyclic NTT of whole planes, forward
// or inverse.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/ntt_pallas.py
// _ntt_kernel (K1) and _ntt_kernel_fac (K4, N = 2^16) for small chains
// (uint32 words: ckks_ntt), and, for wide chains (uint64 words:
// ckks_ntt64), ops/ntt_pallas_wide.py _ntt_kernel_wide (K5) and
// _ntt_kernel_fac_wide (K5', N >= 2^15) and ops/keyswitch_pallas_wide.py
// _inv_yhat_kernel_wide (K7, the inverse with a folded final constant).
// One block, or one cluster of 16 blocks for a plane above 128 KiB
// (ntt_cluster.cuh), owns one (item, channel) plane of N residues: it
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
// ntt_kernel_reg<log2 N, inverse>, and uint32 planes of 2^16 a third,
// ntt_kernel_cluster<inverse> (below); uint64 planes up to 2^12 run
// ntt_kernel above, and those of 2^13 .. 2^16 ntt_kernel_cluster64 (the
// cluster plan on uint64 words, below). The one-block design is K2's NTT
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
//
// K4 on uint32 planes of 2^16 (ntt_kernel_cluster, csrc/ntt_cluster.cuh)
// spreads a plane over a cluster of 16 blocks of 128 threads: the first
// four forward stages (the inverse's last four) as one register pass over
// groups of 16 words at stride N/16, one distributed-shared-memory
// exchange between that pass and the slices, and the slice's 12 stages
// as 5+4+3 register passes. ntt_kernel on clusters of 2 gave 16 to 32
// blocks of 512 threads for the main path's 12 to 16 planes, 15
// one-stage barriers each; this gives 192 to 256 blocks, 2 cluster and
// 3 block barriers (the inverse 2). Measured on an NVIDIA H100 80GB HBM3
// at 700 W (tools/kernel_ab.py, device time, (4, 4, 2^16)): forward
// 0.014-0.016 ms against 0.102 for ntt_kernel, inverse with the fold
// 0.014 (0.114), yhat at (4, 3) 0.011 (0.114); on clusters of 8 blocks
// 0.017 / 0.019-0.020 / 0.013, of 4 0.018-0.019 / 0.018 / 0.018.
//
// K5' / K7 on uint64 planes of 2^15 and 2^16 (ntt_kernel_cluster64<log2
// N, inverse>) run the same plan and body on 64-bit words
// (ntt_cluster.cuh WidePlan): 16 blocks of 16 words a thread (128 threads
// at 2^15, 256 at 2^16), the slice's 11 / 12 stages as 4+4+3 / 4+4+4
// register passes, one 8-byte distributed-shared-memory store a word, a
// pad of one 8-byte word after 16. 96-126 registers a thread, no spill.
// K5 / K7 on uint64 planes of 2^13 and 2^14 run the same kernel on
// clusters of kWideNttLogCluster13 / 14 = 8 / 16 blocks of 64 threads
// (slices of 2^10 as 4+3+3 register passes; one block holds the plane,
// but three passes of 16 words do not hold its 13 / 14 stages, and
// ntt_kernel ran one barrier a stage on one block of 512 threads a plane,
// 32 blocks at the wide path's (8, 4, 2^13)). 96 registers (126 for the
// forward at 2^14), no spill. Measured on an NVIDIA H100 80GB HBM3 at
// 700 W (tools/kernel_ab.py, device time): (8, 4, 2^13) forward 0.0102 ms
// against 0.0358-0.0360 for ntt_kernel, inverse with the fold 0.0106
// (0.0339-0.0341), yhat at (8, 2) 0.0090 (0.0330-0.0341); on clusters of
// 4 0.0109-0.0110 / 0.0112 / 0.0091; (2, 3, 2^14) forward 0.0086
// (0.0713-0.0717), on clusters of 8 0.0090.
// ntt_kernel on clusters of 2 / 4 gave the big-wide path's 12 planes 24
// blocks of 512 threads, 15 one-stage barriers each. Measured on an NVIDIA
// H100 80GB HBM3 at 700 W (tools/kernel_ab.py, device time, (4, 3, 2^15)):
// forward 0.0127-0.0128 ms against 0.0768-0.0773 for ntt_kernel, inverse
// with the fold 0.0125-0.0126 (0.0732-0.0736), yhat at (4, 2)
// 0.0125-0.0127 (0.0730-0.0734); at (1, 2, 2^16) 0.014-0.015 (0.082-0.085).
// On clusters of 8 at 2^15 0.014-0.015; with 32 words a thread (166-198
// registers) 0.027-0.028.
#include "ntt.cuh"
#include "ntt_cluster.cuh"
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

// One block a plane: ntt_kernel's one-block form (uint32 planes below
// 2^10, uint64 planes up to 2^12; the larger planes run the register-pass
// and cluster forms below).
template <typename T>
int launch_one_block(const T* x, long long x_stride, T* out, const T* tw, const T* twp,
                     const T* q, const T* fin, const T* finp, int outer, int channels,
                     int log_n, int inverse, cudaStream_t stream) {
  const size_t smem = ckks::plane_bytes<T>(log_n);
  const cudaError_t err =
      ckks::reserve_smem(reinterpret_cast<const void*>(ntt_kernel<T, false>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ntt_kernel<T, false><<<outer * channels, ckks::kThreads, smem, stream>>>(
      x, x_stride, out, tw, twp, q, fin, finp, channels, log_n, inverse);
  return static_cast<int>(cudaGetLastError());
}

using ckks::RegPlan;

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
  constexpr long long n = 1LL << kLogN;
  const int ch = blockIdx.x % channels;
  const long long item = blockIdx.x / channels;
  ckks::reg_ntt<kLogN, kInverse>(ckks::smem_plane<uint32_t>(), x + item * x_stride + ch * n,
                                 out + (item * channels + ch) * n, threadIdx.x, tw + ch * n,
                                 twp + ch * n, q[ch], fin == nullptr ? nullptr : fin + ch,
                                 fin == nullptr ? nullptr : finp + ch);
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

using ckks::BigPlan;
using ckks::WidePlan;
// K5 / K5' / K7's uint64 plan in each direction
template <int kLogN, bool kInverse>
using NttWidePlan = WidePlan<kLogN, kInverse ? ckks::kWideInverse : ckks::kWideForward>;

// The cluster form of Plan (see the header): one cluster of Plan::kC
// blocks of N/C/W threads per (item, channel) plane.
template <typename Plan, bool kInverse, typename T = typename Plan::Word>
__device__ __forceinline__ void ntt_cluster_body(const T* __restrict__ x, long long x_stride,
                                                 T* __restrict__ out, const T* __restrict__ tw,
                                                 const T* __restrict__ twp,
                                                 const T* __restrict__ q,
                                                 const T* __restrict__ fin,
                                                 const T* __restrict__ finp, int channels) {
  constexpr long long n = 1LL << Plan::kLogN;
  ckks::cluster_arrive_relaxed();  // this block has started
  const int r = static_cast<int>(blockIdx.x) & (Plan::kC - 1);  // rank in the cluster
  const int plane = static_cast<int>(blockIdx.x) >> Plan::kLogC;
  const int ch = plane % channels;
  const long long item = plane / channels;
  ckks::cluster_ntt<Plan, kInverse>(ckks::smem_plane<T>(), x + item * x_stride + ch * n,
                                    out + (item * channels + ch) * n, r, threadIdx.x,
                                    tw + ch * n, twp + ch * n, q[ch], fin, finp, ch);
}

// K4 on uint32 planes of 2^16 words (see the header).
template <bool kInverse>
__global__ void __launch_bounds__(BigPlan::kThreads, BigPlan::kMinBlocks)
ntt_kernel_cluster(const uint32_t* __restrict__ x, long long x_stride,
                   uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ twp, const uint32_t* __restrict__ q,
                   const uint32_t* __restrict__ fin,
                   const uint32_t* __restrict__ finp, int channels) {
  ntt_cluster_body<BigPlan, kInverse>(x, x_stride, out, tw, twp, q, fin, finp, channels);
}

// K5 / K5' / K7 on uint64 planes of 2^kLogN words, 2^13 .. 2^16 (see the
// header).
template <int kLogN, bool kInverse>
__global__ void __launch_bounds__(NttWidePlan<kLogN, kInverse>::kThreads,
                                  ckks::kWideThreadsPerSm /
                                      NttWidePlan<kLogN, kInverse>::kThreads)
ntt_kernel_cluster64(const uint64_t* __restrict__ x, long long x_stride,
                     uint64_t* __restrict__ out, const uint64_t* __restrict__ tw,
                     const uint64_t* __restrict__ twp, const uint64_t* __restrict__ q,
                     const uint64_t* __restrict__ fin,
                     const uint64_t* __restrict__ finp, int channels) {
  ntt_cluster_body<NttWidePlan<kLogN, kInverse>, kInverse>(x, x_stride, out, tw, twp, q, fin,
                                                           finp, channels);
}

template <bool kInverse>
int launch_cluster(const uint32_t* x, long long x_stride, uint32_t* out,
                   const uint32_t* tw, const uint32_t* twp, const uint32_t* q,
                   const uint32_t* fin, const uint32_t* finp, int outer,
                   int channels, cudaStream_t stream) {
  return ckks::launch_cluster<BigPlan, &ntt_kernel_cluster<kInverse>>(
      outer * channels, kInverse ? BigPlan::kInverseBytes : BigPlan::kForwardBytes,
      stream, x, x_stride, out, tw, twp, q, fin, finp, channels);
}

template <int kLogN, bool kInverse>
int launch_cluster64(const uint64_t* x, long long x_stride, uint64_t* out,
                     const uint64_t* tw, const uint64_t* twp, const uint64_t* q,
                     const uint64_t* fin, const uint64_t* finp, int outer, int channels,
                     cudaStream_t stream) {
  using Plan = NttWidePlan<kLogN, kInverse>;
  return ckks::launch_cluster<Plan, &ntt_kernel_cluster64<kLogN, kInverse>>(
      outer * channels, kInverse ? Plan::kInverseBytes : Plan::kForwardBytes, stream, x,
      x_stride, out, tw, twp, q, fin, finp, channels);
}

}  // namespace

// x: (outer, channels, N) with item stride x_stride (elements); out:
// contiguous (outer, channels, N); tw/twp: (channels, N) compact twiddles of
// the direction; q/fin/finp: (channels,); fin == nullptr skips the final
// multiply; parts: 1 (one block a plane) or, at N = 2^16 only, above 1 (a
// cluster: ntt_kernel_cluster on ckks::BigPlan::kC blocks; the form is
// ckks::plane_blocks's). The inverse with parts == 1 and N in [2^10,
// 2^15] reads x as 16-byte vectors: x 16-byte aligned, x_stride a
// multiple of 4; so does the cluster form. Returns the launch's error
// code (0 on success).
extern "C" int ckks_ntt(const uint32_t* x, long long x_stride, uint32_t* out,
                        const uint32_t* tw, const uint32_t* twp,
                        const uint32_t* q, const uint32_t* fin,
                        const uint32_t* finp, int outer, int channels,
                        int log_n, int parts, int inverse,
                        cudaStream_t stream) {
  const int blocks = ckks::plane_blocks(inverse ? ckks::kWideInverse : ckks::kWideForward,
                                        false, log_n, parts);
  if (blocks > 1) {
    return inverse ? launch_cluster<true>(x, x_stride, out, tw, twp, q, fin, finp,
                                          outer, channels, stream)
                   : launch_cluster<false>(x, x_stride, out, tw, twp, q, fin, finp,
                                           outer, channels, stream);
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ckks::reg_shape(log_n)) {
    return ckks::reg_dispatch(log_n, [&](auto log_n_c) {
      constexpr int kLogN = decltype(log_n_c)::value;
      return inverse ? launch_reg<kLogN, true>(x, x_stride, out, tw, twp, q, fin,
                                               finp, outer, channels, stream)
                     : launch_reg<kLogN, false>(x, x_stride, out, tw, twp, q, fin,
                                                finp, outer, channels, stream);
    });
  }
  return launch_one_block(x, x_stride, out, tw, twp, q, fin, finp, outer, channels,
                          log_n, inverse, stream);
}

// The same on uint64 words (wide chains, radix-2^64 Shoup companions): at
// N = 2^13 .. 2^16 a cluster (ntt_kernel_cluster64 on the C blocks of the
// direction's ckks::WidePlan) whatever parts says, whose inverse reads x
// as 16-byte vectors (x 16-byte aligned, x_stride even); below, parts 1
// (ntt_kernel's one-block form).
extern "C" int ckks_ntt64(const uint64_t* x, long long x_stride,
                          uint64_t* out, const uint64_t* tw,
                          const uint64_t* twp, const uint64_t* q,
                          const uint64_t* fin, const uint64_t* finp,
                          int outer, int channels, int log_n, int parts,
                          int inverse, cudaStream_t stream) {
  const int blocks = ckks::plane_blocks(inverse ? ckks::kWideInverse : ckks::kWideForward,
                                        true, log_n, parts);
  if (blocks > 1) {
    return ckks::wide_dispatch(log_n, [&](auto log_n_c) {
      constexpr int kLogN = decltype(log_n_c)::value;
      return inverse ? launch_cluster64<kLogN, true>(x, x_stride, out, tw, twp, q, fin,
                                                     finp, outer, channels, stream)
                     : launch_cluster64<kLogN, false>(x, x_stride, out, tw, twp, q, fin,
                                                      finp, outer, channels, stream);
    });
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_one_block(x, x_stride, out, tw, twp, q, fin, finp, outer, channels,
                          log_n, inverse, stream);
}

const void* ckks::ntt_reg_kernel(int log_n, bool inverse) {
  if (!reg_shape(log_n)) return nullptr;
  return reg_dispatch(log_n, [inverse](auto log_n_c) {
    constexpr int kLogN = decltype(log_n_c)::value;
    return inverse ? reg_kernel<kLogN, true>() : reg_kernel<kLogN, false>();
  });
}

const void* ckks::ntt_cluster_kernel(bool inverse) {
  return inverse ? reinterpret_cast<const void*>(ntt_kernel_cluster<true>)
                 : reinterpret_cast<const void*>(ntt_kernel_cluster<false>);
}

const void* ckks::ntt_cluster64_kernel(int log_n, bool inverse) {
  if (!wide_cluster_shape(log_n)) return nullptr;
  return wide_dispatch(log_n, [inverse](auto log_n_c) {
    constexpr int kLogN = decltype(log_n_c)::value;
    return inverse ? reinterpret_cast<const void*>(ntt_kernel_cluster64<kLogN, true>)
                   : reinterpret_cast<const void*>(ntt_kernel_cluster64<kLogN, false>);
  });
}

// ckks::plane_blocks for the wrappers' launch counts and alignment: the
// blocks a plane of the form that the entry of `form` (ckks::WideForm:
// 0 NTT forward, 1 NTT inverse, 2 key switch, 3 mod-down) on uint64
// (wide 1) or uint32 (wide 0) words launches with these arguments (above
// 1: a cluster), 0 where it refuses them.
extern "C" int ckks_plane_blocks(int form, int wide, int log_n, int parts) {
  return ckks::plane_blocks(form, wide != 0, log_n, parts);
}

// The cluster kernel `kernel` (ckks::ClusterKernel: 0 K3, 1 K4 forward, 2 K4
// inverse, 3 K2; the uint64 forms 4 .. 19 by the rule kClusterWide +
// kWideForms * (log2 N - 13) + ckks::WideForm) as built and as it fits the
// current device (ckks::cluster_info: registers, spill bytes, threads,
// shared bytes, blocks a cluster, resident clusters). Returns
// cudaErrorInvalidValue for another id.
extern "C" int ckks_cluster_info(int kernel, int* info) {
  using ckks::BigPlan;
  switch (kernel) {
    case ckks::kClusterModDown:
      return ckks::cluster_info<BigPlan>(ckks::moddown_cluster_kernel(),
                                         BigPlan::kForwardBytes, info);
    case ckks::kClusterNttForward:
      return ckks::cluster_info<BigPlan>(ckks::ntt_cluster_kernel(false),
                                         BigPlan::kForwardBytes, info);
    case ckks::kClusterNttInverse:
      return ckks::cluster_info<BigPlan>(ckks::ntt_cluster_kernel(true),
                                         BigPlan::kInverseBytes, info);
    case ckks::kClusterKeySwitch:
      return ckks::cluster_info<BigPlan>(ckks::keyswitch_cluster_kernel(),
                                         BigPlan::kForwardBytes, info);
    default:
      break;
  }
  const int wide = kernel - ckks::kClusterWide;
  if (wide < 0 || wide >= 4 * ckks::kWideForms) return static_cast<int>(cudaErrorInvalidValue);
  const int form = wide % ckks::kWideForms;
  return ckks::wide_dispatch(13 + wide / ckks::kWideForms, [&](auto log_n_c) {
    constexpr int kLogN = decltype(log_n_c)::value;
    switch (form) {
      case ckks::kWideForward:
        return ckks::cluster_info<WidePlan<kLogN, ckks::kWideForward>>(
            ckks::ntt_cluster64_kernel(kLogN, false),
            WidePlan<kLogN, ckks::kWideForward>::kForwardBytes, info);
      case ckks::kWideInverse:
        return ckks::cluster_info<WidePlan<kLogN, ckks::kWideInverse>>(
            ckks::ntt_cluster64_kernel(kLogN, true),
            WidePlan<kLogN, ckks::kWideInverse>::kInverseBytes, info);
      case ckks::kWideKeySwitch:
        return ckks::cluster_info<WidePlan<kLogN, ckks::kWideKeySwitch>>(
            ckks::keyswitch_cluster64_kernel(kLogN),
            WidePlan<kLogN, ckks::kWideKeySwitch>::kForwardBytes, info);
      default:
        return ckks::cluster_info<WidePlan<kLogN, ckks::kWideModDown>>(
            ckks::moddown_cluster64_kernel(kLogN),
            WidePlan<kLogN, ckks::kWideModDown>::kForwardBytes, info);
    }
  });
}

extern "C" const char* ckks_error_string(int code) {
  if (code == ckks::kErrClusterDoesNotFit)
    return "no thread-block cluster of this size and shared memory fits the "
           "device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
