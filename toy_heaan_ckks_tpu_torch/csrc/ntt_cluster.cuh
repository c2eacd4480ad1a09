// The register-pass NTT of one uint32 plane of N = 2^16 words spread over
// a thread-block cluster of C blocks, shared by the cluster forms of K4
// (csrc/ntt.cu, ntt_kernel_cluster), K3 / K3' (csrc/moddown.cu,
// moddown_kernel_cluster) and K2 (csrc/keyswitch.cu,
// keyswitch_kernel_cluster, one forward a digit). The stage, group and twiddle conventions are
// those of ntt.cuh (tree order, the compact table of the whole plane), so
// the words equal the twins' and the one-block forms'.
//
// Rank r of the cluster holds the slice [r*M, (r+1)*M), M = N/C, in its
// shared memory; its N/C/32 threads hold 32 words each (C = 16: 128
// threads, slices of 2^12). The plan (ClusterPlan):
//
// - Cross pass (stages 0 .. log2 C - 1, those with d >= M). Thread t of
//   rank r holds 32/C groups; group h is the C words j + k*M, k < C, at
//   a[h*C + k], j = r*M/C + h*T + t (T threads a block), so its loads are
//   coalesced over t and the groups are spread evenly over the ranks. The
//   stage-l butterflies take the table entries 2^l + g, the same C - 1
//   words for every thread (CrossPass).
// - Forward: after the cross pass, word k of group j goes to rank k's
//   shared memory at pad(j) through distributed shared memory, one 4-byte
//   store each (the pad word after every 32 breaks 16-byte alignment),
//   then one cluster barrier. From there each block runs the one-block
//   register passes of a 2^(16 - log2 C)-word plane (ntt_reg.cuh RegPlan:
//   5+4+3 at C = 16) on its slice alone, the twiddle of local stage s' and
//   slice group g' at (C + r) * 2^s' + g' (SlicePass: global stage
//   log2 C + s', global group r * 2^s' + g'), and goes back to pass 0's
//   layout for a coalesced store.
// - Inverse: the local Gentleman-Sande passes on the slice, from its runs
//   of adjacent words (16-byte loads, as ntt_kernel_reg), then each word of
//   pass 0 goes to its cross-pass owner through distributed shared memory
//   (a second buffer of M words, at k * M/C + j mod M/C: peers may write
//   it while this block still exchanges words of its own passes), one
//   cluster barrier, and the cross pass from stage log2 C - 1 down.
// - Cluster barriers: every thread arrives (relaxed) when its block
//   starts and waits just before the scatter, so no block writes to a
//   peer that has not started; the barrier after the scatter is the last
//   distributed access, so no block exits while a peer may still write to
//   it. A kernel that runs the forward again on the same slice (K2, once a
//   digit) arrives between the two, after its last read of the slice. Block barriers: 3 in the forward's local passes, 2 in the
//   inverse's (15 one-stage barriers and 2 cluster barriers of the
//   ntt.cuh template's forward on clusters of 2).
#pragma once

#include <utility>

#include "ntt_reg.cuh"

namespace ckks {

constexpr int kClusterLogN = 16;  // the ring of the cluster forms
// C = 16 blocks a plane, a non-portable cluster size: of 4, 8 and 16 the
// fastest at the big path's shapes (more blocks of fewer threads won,
// though 15/16 of the words then cross SMs in the scatter)
constexpr int kLogCluster = 4;

template <int kLogN, int kLogBlocks>
struct ClusterPlan {
  static constexpr int kLogC = kLogBlocks;
  static constexpr int kC = 1 << kLogC;
  static constexpr int kLogM = kLogN - kLogC;  // a rank's slice
  static constexpr int kM = 1 << kLogM;
  static constexpr int kThreads = RegPlan<kLogM>::kThreads;
  static constexpr int kGroups = kRegWords >> kLogC;  // cross-pass groups a thread
  static constexpr int kPerRank = kM >> kLogC;        // cross-pass groups a rank
  // 1024 threads an SM: 64 registers a thread
  static constexpr int kMinBlocks = RegPlan<kLogM>::kMinBlocksTwo;
  // the padded slice; the inverse adds the M-word buffer of the scatter
  static constexpr size_t kForwardBytes = sizeof(uint32_t) * pad(kM);
  static constexpr size_t kInverseBytes = kForwardBytes + sizeof(uint32_t) * kM;
  static_assert(kLogC >= 1 && kGroups >= 1 && kLogM >= 10, "a plan of 2..32 ranks");
};

using BigPlan = ClusterPlan<kClusterLogN, kLogCluster>;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of this block's shared word p in rank `rank`.
__device__ __forceinline__ uint32_t cluster_addr(const uint32_t* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// The cluster barriers order these stores; no local access aliases them.
__device__ __forceinline__ void cluster_store(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// Stage kL of a pass of 2^kR-word groups on group kH of a[] (RegPass::stage
// / RegPassInv::stage): group g's twiddle is table entry k0 + g.
template <int kR, int kH, int kL, bool kInverse>
__device__ __forceinline__ void pass_stage(uint32_t (&a)[kRegWords], int k0,
                                           const uint32_t* __restrict__ tw,
                                           const uint32_t* __restrict__ twp,
                                           uint32_t q) {
  constexpr int kHalf = 1 << (kR - 1 - kL);
#pragma unroll
  for (int g = 0; g < (1 << kL); ++g) {
    const uint32_t w = ldg(tw + k0 + g);
    const uint32_t wp = ldg(twp + k0 + g);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int u = (kH << kR) + 2 * kHalf * g + i;
      const uint32_t xu = a[u];
      if constexpr (kInverse) {
        const uint32_t xv = a[u + kHalf];
        a[u] = add_mod(xu, xv, q);
        a[u + kHalf] = harvey(sub_mod(xu, xv, q), w, wp, q);
      } else {
        const uint32_t xv = harvey(a[u + kHalf], w, wp, q);
        a[u] = add_mod(xu, xv, q);
        a[u + kHalf] = sub_mod(xu, xv, q);
      }
    }
  }
}

// The stage of a pass's step kI: forward kL = kI, inverse kL = kR - 1 - kI.
template <bool kInverse, int kR, int kI>
constexpr int kStageOf = kInverse ? kR - 1 - kI : kI;

// Local pass (kS, kR) of a rank's slice of 2^kLogM words: RegPass's words
// and butterflies, the twiddle of local stage kS + kL at (lead << (kS +
// kL)) + (blk << kL) + g, lead = C + rank (1: RegPass's own rule).
template <int kLogM, int kS, int kR, bool kInverse>
struct SlicePass : RegPass<kLogM, kS, kR> {
  using Base = RegPass<kLogM, kS, kR>;

  template <int kH, int... kI>
  __device__ __forceinline__ static void group(
      uint32_t (&a)[kRegWords], int t, int lead, std::integer_sequence<int, kI...>,
      const uint32_t* __restrict__ tw, const uint32_t* __restrict__ twp,
      uint32_t q) {
    const int blk = Base::gid(t, kH) >> Base::kLogOff;
    (pass_stage<kR, kH, kStageOf<kInverse, kR, kI>, kInverse>(
         a, (lead << (kS + kStageOf<kInverse, kR, kI>)) +
                (blk << kStageOf<kInverse, kR, kI>),
         tw, twp, q),
     ...);
  }

  template <int... kH>
  __device__ __forceinline__ static void groups(
      uint32_t (&a)[kRegWords], int t, int lead, std::integer_sequence<int, kH...>,
      const uint32_t* __restrict__ tw, const uint32_t* __restrict__ twp,
      uint32_t q) {
    (group<kH>(a, t, lead, std::make_integer_sequence<int, kR>{}, tw, twp, q), ...);
  }

  __device__ __forceinline__ static void run(uint32_t (&a)[kRegWords], int t,
                                             int lead,
                                             const uint32_t* __restrict__ tw,
                                             const uint32_t* __restrict__ twp,
                                             uint32_t q) {
    groups(a, t, lead, std::make_integer_sequence<int, Base::kGroups>{}, tw, twp, q);
  }
};

// The cross pass of a plan: 32/C groups of C words a thread, stages
// 0 .. log2 C - 1 (the inverse from log2 C - 1 down), table entries
// 2^l + g.
template <typename Plan, bool kInverse>
struct CrossPass {
  static constexpr int kLogC = Plan::kLogC;

  // plane position of group h's word 0 for thread t of rank r
  __device__ __forceinline__ static int first(int r, int h, int t) {
    return r * Plan::kPerRank + h * Plan::kThreads + t;
  }

  template <int kH, int... kI>
  __device__ __forceinline__ static void group(
      uint32_t (&a)[kRegWords], std::integer_sequence<int, kI...>,
      const uint32_t* __restrict__ tw, const uint32_t* __restrict__ twp,
      uint32_t q) {
    (pass_stage<kLogC, kH, kStageOf<kInverse, kLogC, kI>, kInverse>(
         a, 1 << kStageOf<kInverse, kLogC, kI>, tw, twp, q),
     ...);
  }

  template <int... kH>
  __device__ __forceinline__ static void groups(
      uint32_t (&a)[kRegWords], std::integer_sequence<int, kH...>,
      const uint32_t* __restrict__ tw, const uint32_t* __restrict__ twp,
      uint32_t q) {
    (group<kH>(a, std::make_integer_sequence<int, kLogC>{}, tw, twp, q), ...);
  }

  __device__ __forceinline__ static void run(uint32_t (&a)[kRegWords],
                                             const uint32_t* __restrict__ tw,
                                             const uint32_t* __restrict__ twp,
                                             uint32_t q) {
    groups(a, std::make_integer_sequence<int, Plan::kGroups>{}, tw, twp, q);
  }
};

// Forward, after the cross pass on a[] (CrossPass's layout) of rank r:
// the scatter into the ranks' slices s (ClusterPlan::kForwardBytes each),
// the cluster barrier, and the local passes with the slice's twiddles;
// returns with a[] in pass 0's layout (word m at slice position m*T + t)
// and no peer touching s. Every thread arrived on the cluster barrier
// when its block started, or after its last read of s in an earlier
// forward.
template <typename Plan>
__device__ __forceinline__ void cluster_forward(uint32_t* s, uint32_t (&a)[kRegWords],
                                                int r, int t,
                                                const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ twp,
                                                uint32_t q) {
  constexpr int kLogM = Plan::kLogM;
  using Local = RegPlan<kLogM>;
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int k = 0; k < Plan::kC; ++k) {
    const uint32_t base = cluster_addr(s, k);
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
      cluster_store(base + 4u * pad(CrossPass<Plan, false>::first(r, h, t)),
                    a[h * Plan::kC + k]);
  }
  cluster_arrive();
  cluster_wait();  // the slice is whole; no peer writes to s again

  const int lead = Plan::kC + r;
  using P0 = SlicePass<kLogM, 0, kLogRegWords, false>;
  using P1 = SlicePass<kLogM, kLogRegWords, Local::kR1, false>;
  P0::load(s, a, t);
  P0::run(a, t, lead, tw, twp, q);
  P0::store(s, a, t);
  __syncthreads();
  P1::load(s, a, t);
  P1::run(a, t, lead, tw, twp, q);
  if constexpr (Local::kR2 > 0) {
    using P2 = SlicePass<kLogM, kLogRegWords + Local::kR1, Local::kR2, false>;
    P1::store(s, a, t);
    __syncthreads();
    P2::load(s, a, t);
    P2::run(a, t, lead, tw, twp, q);
  }
  // the last pass's runs back to pass 0's layout
  RegLast<kLogM>::store(s, a, t);
  __syncthreads();
  RegPass<kLogM, 0, kLogRegWords>::load(s, a, t);
}

// Inverse of rank r on a[] loaded as the runs of the slice's last local
// pass (load_runs<RegLast<kLogM>>): the local passes, the scatter of pass
// 0's words to their cross-pass owners' buffers xs (kM words after the
// padded slice), the cluster barrier, and the cross pass; returns with
// a[] in CrossPass's layout (word k of group h at first(r, h, t) + k*N/C)
// and no peer touching this block's shared memory.
template <typename Plan>
__device__ __forceinline__ void cluster_inverse(uint32_t* s, uint32_t (&a)[kRegWords],
                                                int r, int t,
                                                const uint32_t* __restrict__ tw,
                                                const uint32_t* __restrict__ twp,
                                                uint32_t q) {
  constexpr int kLogM = Plan::kLogM;
  using Local = RegPlan<kLogM>;
  const int lead = Plan::kC + r;
  using P0 = SlicePass<kLogM, 0, kLogRegWords, true>;
  using P1 = SlicePass<kLogM, kLogRegWords, Local::kR1, true>;
  if constexpr (Local::kR2 > 0) {
    using P2 = SlicePass<kLogM, kLogRegWords + Local::kR1, Local::kR2, true>;
    P2::run(a, t, lead, tw, twp, q);
    P2::store(s, a, t);
    __syncthreads();
    P1::load(s, a, t);
  }
  P1::run(a, t, lead, tw, twp, q);
  P1::store(s, a, t);
  __syncthreads();
  P0::load(s, a, t);
  P0::run(a, t, lead, tw, twp, q);

  // word m at slice position p = m*T + t belongs to group p of the cross
  // pass: owner p / (M/C) = m / (32/C), word r of its group
  uint32_t* xs = s + pad(Plan::kM);
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int k = 0; k < Plan::kC; ++k) {
    const uint32_t base = cluster_addr(xs, k) + 4u * (r * Plan::kPerRank + t);
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
      cluster_store(base + 4u * (h * Plan::kThreads), a[k * Plan::kGroups + h]);
  }
  cluster_arrive();
  cluster_wait();  // xs is whole; no peer writes to it again
#pragma unroll
  for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
    for (int k = 0; k < Plan::kC; ++k)
      a[h * Plan::kC + k] = xs[k * Plan::kPerRank + h * Plan::kThreads + t];
  CrossPass<Plan, true>::run(a, tw, twp, q);
}

// The cluster kernels, by the id ckks_cluster_info takes; each source
// defines its own.
enum ClusterKernel { kClusterModDown = 0, kClusterNttForward = 1,
                     kClusterNttInverse = 2, kClusterKeySwitch = 3 };
const void* moddown_cluster_kernel();           // csrc/moddown.cu
const void* ntt_cluster_kernel(bool inverse);   // csrc/ntt.cu
const void* keyswitch_cluster_kernel();         // csrc/keyswitch.cu

// The launch of `planes` planes on clusters of Plan::kC blocks of
// Plan::kThreads with `smem` dynamic shared bytes each: the kernel opts in
// to the shared memory and, above 8 blocks, to a non-portable cluster
// size (err holds the first failure); cfg carries the cluster dimension.
template <typename Plan>
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  cudaError_t err;

  ClusterLaunch(const void* kernel, int planes, size_t smem, cudaStream_t stream) {
    err = reserve_smem(kernel, smem);
    if (err == cudaSuccess && Plan::kC > 8)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Plan::kC;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(planes * Plan::kC, 1, 1);
    cfg.blockDim = dim3(Plan::kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // cfg points into attr
};

// Launch kKernel on ClusterLaunch<Plan>. Returns kErrClusterDoesNotFit
// when no such cluster can be resident (checked once per kernel), else
// the launch's error code; never launches another form.
template <typename Plan, auto kKernel, typename... Args>
int launch_cluster(int planes, size_t smem, cudaStream_t stream, Args... args) {
  const void* fn = reinterpret_cast<const void*>(kKernel);
  ClusterLaunch<Plan> launch(fn, planes, smem, stream);
  if (launch.err != cudaSuccess) return static_cast<int>(launch.err);
  static int fit = 0;  // one query per kernel
  if (fit == 0) {
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fn, &launch.cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    fit = clusters >= 1 ? 1 : -1;
  }
  if (fit < 0) return kErrClusterDoesNotFit;
  const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, kKernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A cluster kernel of BigPlan as built and as it fits the current
// device: info[0..5] = registers a thread, local (spill) bytes a thread,
// threads a block, dynamic shared bytes a block, blocks a cluster, and
// clusters resident at once (cudaOccupancyMaxActiveClusters). Returns the
// first CUDA error (0 if none).
inline int cluster_info(const void* kernel, size_t smem, int* info) {
  ClusterLaunch<BigPlan> launch(kernel, 1, smem, nullptr);
  if (launch.err != cudaSuccess) return static_cast<int>(launch.err);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = BigPlan::kThreads;
  info[3] = static_cast<int>(smem);
  info[4] = BigPlan::kC;
  info[5] = clusters;
  return 0;
}

}  // namespace ckks
