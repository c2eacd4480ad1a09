// The register-pass NTT of one plane spread over a thread-block cluster
// of C blocks, shared by the cluster forms of K4 (csrc/ntt.cu,
// ntt_kernel_cluster, uint32 N = 2^16), K5 / K5' / K7 (ntt_kernel_cluster64,
// uint64 N = 2^13 .. 2^16), K3 / K3' (csrc/moddown.cu,
// moddown_kernel_cluster, uint32 2^16), K8 / K8' (moddown_kernel_cluster64,
// uint64 2^13 .. 2^16), K2 and K6 (csrc/keyswitch.cu,
// keyswitch_kernel_cluster at uint32 2^16, keyswitch_kernel_cluster64 at
// uint64 2^13 .. 2^16, one forward a digit) and K10 (csrc/coeff_ntt.cuh,
// tail_kernel_cluster: a coefficient slab as a plane whose twiddles start
// at its lead, uint32 slabs of 2^12 .. 2^15 and uint64 slabs of 2^12 ..
// 2^14 where coeff_ntt_gpu.slab_form picks it). The stage, group and
// twiddle conventions are those of ntt.cuh (tree order, the compact table
// of the whole plane), so the words equal the twins' and the one-block
// forms'. The plan is generic over the word (ntt_reg.cuh RegWords): W
// words a thread, uint32 planes W = 32 (BigPlan), uint64 planes W = 16
// (WidePlan).
//
// Rank r of the cluster holds the slice [r*M, (r+1)*M), M = N/C, in its
// shared memory; its M/W threads hold W words each (uint32 2^16 on C = 16:
// 128 threads, slices of 2^12). The plan (ClusterPlan):
//
// - Cross pass (stages 0 .. log2 C - 1, those with d >= M). Thread t of
//   rank r holds W/C groups; group h is the C words j + k*M, k < C, at
//   a[h*C + k], j = r*M/C + h*T + t (T threads a block), so its loads are
//   coalesced over t and the groups are spread evenly over the ranks. The
//   stage-l butterflies take the table entries (lead << l) + g, the same
//   C - 1 words for every thread: lead = 1 on a plane, P + p on slab p
//   of P (CrossPass).
// - Forward: after the cross pass, word k of group j goes to rank k's
//   shared memory at pad(j) through distributed shared memory, one store
//   of the word's size each (st.shared::cluster.u32 / .u64: the pad word
//   after every 128 bytes breaks 16-byte alignment), then one cluster
//   barrier. From there each block runs the one-block register passes of
//   a 2^(log2 N - log2 C)-word plane (ntt_reg.cuh RegPlan: 5+4+3 at
//   uint32 C = 16, 4+4+4 at uint64 2^16 and 4+4+3 at 2^15 on C = 16) on
//   its slice alone, the twiddle of local stage s' and slice group g' at
//   ((lead * C + r) << s') + g' (RegPass::run: on a plane, lead = 1,
//   global stage log2 C + s' and global group r * 2^s' + g'; on slab p,
//   lead = P + p, stage log2 P + log2 C + s', group (p*C + r) * 2^s' + g'),
//   and goes back to pass 0's layout for a coalesced store.
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
//   it. A kernel that runs the forward again on the same slice (K2 / K6,
//   once a digit) arrives between the two, after its last read of the
//   slice. Block barriers: 3 in the forward's local passes, 2 in the
//   inverse's.
// - Shared-memory banks: a uint64 word spans two 4-byte banks and a warp's
//   8-byte accesses go as two half-warps of 16, so the pad of one 8-byte
//   word after every 16 keeps the uint64 passes' exchanges (strides 1, and
//   8 or 16 in the last pass's runs) and the scatter free of conflicts
//   (tests/test_torch_cluster_plan.py counts them).
#pragma once

#include <type_traits>
#include <utility>

#include "ntt_reg.cuh"

namespace ckks {

constexpr int kClusterLogN = 16;  // the ring of the uint32 cluster forms
// C = 16 blocks a plane, a non-portable cluster size: of 4, 8 and 16 the
// fastest at the big path's shapes (more blocks of fewer threads won,
// though 15/16 of the words then cross SMs in the scatter)
constexpr int kLogCluster = 4;

template <int kLogRing, int kLogBlocks, typename Wd = Words32>
struct ClusterPlan {
  using Words = Wd;
  using Word = typename Wd::Word;
  static constexpr int kLogN = kLogRing;
  static constexpr int kLogC = kLogBlocks;
  static constexpr int kC = 1 << kLogC;
  static constexpr int kLogM = kLogN - kLogC;  // a rank's slice
  static constexpr int kM = 1 << kLogM;
  static constexpr int kW = Wd::kCount;  // words a thread
  static constexpr int kThreads = RegPlan<kLogM, Wd>::kThreads;
  static constexpr int kGroups = kW >> kLogC;  // cross-pass groups a thread
  static constexpr int kPerRank = kM >> kLogC;  // cross-pass groups a rank
  // 1024 threads an SM: 64 registers a thread
  static constexpr int kMinBlocks = RegPlan<kLogM, Wd>::kMinBlocksTwo;
  // the padded slice; the inverse adds the M-word buffer of the scatter
  static constexpr size_t kForwardBytes = sizeof(Word) * Wd::pad(kM);
  static constexpr size_t kInverseBytes = kForwardBytes + sizeof(Word) * kM;
  static_assert(kLogC >= 1 && kGroups >= 1 && kLogM >= 10, "a plan of 2..W ranks");
};

using BigPlan = ClusterPlan<kClusterLogN, kLogCluster>;

// The uint64 cluster forms: 16 words a thread; 16 blocks a plane at
// N = 2^15 and 2^16 (planes above 128 KiB), and at 2^13 and 2^14, where
// one block holds a plane but three passes of 16 words do not hold its
// stages, the C below, set by the forms' device times at the wide (8, 4,
// 2^13) and wide-62b (2, 3, 2^14) shapes on an H100: K6 on
// kWideLogCluster13 / 14 (C 4 / 8, one NTT a digit); K5 / K7 and K8 /
// K8' (one NTT a plane) on kWideNttLogCluster13 / 14 (C 8 / 16: the NTT
// 5-7% faster than on C 4 at 2^13 and 1-4% than on C 8 at 2^14, K8' 3%
// and 3-4%, K8 2% slower at 2^13 and 3% faster at 2^14; slices of 2^10
// keep 2-way bank conflicts in their middle pass).
// tests/test_torch_cluster_plan.py reads these constants.
constexpr int kLogWideWords = 4;
constexpr int kWideLogCluster13 = 2;
constexpr int kWideLogCluster14 = 3;
constexpr int kWideLogCluster15 = 4;
constexpr int kWideLogCluster16 = 4;
constexpr int kWideNttLogCluster13 = 3;
constexpr int kWideNttLogCluster14 = 4;
using WideWords = RegWords<uint64_t, kLogWideWords>;
// the uint64 cluster kernels: K5 / K5' forward, K7 (the inverse), K6, K8
// / K8'
enum WideForm { kWideForward = 0, kWideInverse = 1, kWideKeySwitch = 2, kWideModDown = 3 };
constexpr int kWideForms = 4;
// the rings of the uint64 cluster forms: every uint64 plane of 2^13 ..
// 2^16 runs on a cluster
constexpr bool wide_cluster_shape(int log_n) { return log_n >= 13 && log_n <= 16; }
// log2 C of a uint64 form at 2^log_n (wide_cluster_shape)
constexpr int wide_log_cluster(int form, int log_n) {
  return log_n == 15   ? kWideLogCluster15
         : log_n == 16 ? kWideLogCluster16
         : form == kWideKeySwitch
             ? (log_n == 13 ? kWideLogCluster13 : kWideLogCluster14)
             : (log_n == 13 ? kWideNttLogCluster13 : kWideNttLogCluster14);
}
template <int kLogN, int kForm>
using WidePlan = ClusterPlan<kLogN, wide_log_cluster(kForm, kLogN), WideWords>;

// f(std::integral_constant<int, log_n>{}) for a ring of the uint64
// cluster forms (wide_cluster_shape).
template <typename F>
auto wide_dispatch(int log_n, F f) -> decltype(f(std::integral_constant<int, 16>{})) {
  switch (log_n) {
    case 13: return f(std::integral_constant<int, 13>{});
    case 14: return f(std::integral_constant<int, 14>{});
    case 15: return f(std::integral_constant<int, 15>{});
    default: return f(std::integral_constant<int, 16>{});
  }
}

// Blocks a plane of the form that an entry launches for `form` (a
// WideForm; the uint32 entries take any) at log_n for `parts`
// (ntt_gpu.plane_split's P): a cluster of WidePlan's C on every uint64
// plane of 2^13 .. 2^16 whatever parts says, of BigPlan's C on uint32
// planes of 2^16 at parts above 1, else 1 (one block a plane: the
// register-pass or template forms) at parts 1 and 0 (refused) otherwise.
// The entries route by it; ckks_plane_blocks reports it.
constexpr int plane_blocks(int form, bool wide, int log_n, int parts) {
  if (wide && wide_cluster_shape(log_n)) return 1 << wide_log_cluster(form, log_n);
  if (!wide && parts > 1 && log_n == kClusterLogN) return BigPlan::kC;
  return parts == 1 ? 1 : 0;
}

// resident threads an SM that the uint64 cluster kernels promise ptxas
// (__launch_bounds__): 512, up to 128 registers a thread
constexpr int kWideThreadsPerSm = 512;

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
template <typename T>
__device__ __forceinline__ uint32_t cluster_addr(const T* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

// The cluster barriers order these stores; no local access aliases them.
__device__ __forceinline__ void cluster_store(uint32_t addr, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(addr), "r"(v));
}

// An 8-byte store: addr 8-byte aligned (a slot of a uint64 slice).
__device__ __forceinline__ void cluster_store(uint32_t addr, uint64_t v) {
  asm volatile("st.shared::cluster.u64 [%0], %1;\n" ::"r"(addr), "l"(v));
}

// The cross pass of a plan: W/C groups of C words a thread, stages
// 0 .. log2 C - 1 (the inverse from log2 C - 1 down), table entries
// (lead << l) + g: lead = 1 on a whole plane (2^l + g, the same C - 1
// words for every thread), P + p on slab p of P (RegPass::run).
template <typename Plan, bool kInverse>
struct CrossPass {
  using T = typename Plan::Word;
  static constexpr int kLogC = Plan::kLogC;

  // plane position of group h's word 0 for thread t of rank r
  __device__ __forceinline__ static int first(int r, int h, int t) {
    return r * Plan::kPerRank + h * Plan::kThreads + t;
  }

  template <int kH, int... kI>
  __device__ __forceinline__ static void group(T (&a)[Plan::kW], int lead,
                                               std::integer_sequence<int, kI...>,
                                               const T* __restrict__ tw,
                                               const T* __restrict__ twp, T q) {
    (pass_stage<kLogC, kH, kStageOf<kInverse, kLogC, kI>, kInverse>(
         a, lead << kStageOf<kInverse, kLogC, kI>, tw, twp, q),
     ...);
  }

  template <int... kH>
  __device__ __forceinline__ static void groups(T (&a)[Plan::kW], int lead,
                                                std::integer_sequence<int, kH...>,
                                                const T* __restrict__ tw,
                                                const T* __restrict__ twp, T q) {
    (group<kH>(a, lead, std::make_integer_sequence<int, kLogC>{}, tw, twp, q), ...);
  }

  __device__ __forceinline__ static void run(T (&a)[Plan::kW], const T* __restrict__ tw,
                                             const T* __restrict__ twp, T q, int lead = 1) {
    groups(a, lead, std::make_integer_sequence<int, Plan::kGroups>{}, tw, twp, q);
  }
};

// Forward, after the cross pass on a[] (CrossPass's layout) of rank r:
// the scatter into the ranks' slices s (ClusterPlan::kForwardBytes each),
// the cluster barrier, and the local passes with the slice's twiddles;
// returns with a[] in pass 0's layout (word m at slice position m*T + t)
// and no peer touching s. Every thread arrived on the cluster barrier
// when its block started, or after its last read of s in an earlier
// forward. lead: the cross pass's (CrossPass); the slice of rank r takes
// lead * C + r.
template <typename Plan, typename T = typename Plan::Word>
__device__ __forceinline__ void cluster_forward(T* s, T (&a)[Plan::kW], int r, int t,
                                                const T* __restrict__ tw,
                                                const T* __restrict__ twp, T q,
                                                int lead = 1) {
  using Wd = typename Plan::Words;
  constexpr int kLogM = Plan::kLogM;
  using Local = RegPlan<kLogM, Wd>;
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int k = 0; k < Plan::kC; ++k) {
    const uint32_t base = cluster_addr(s, k);
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
      cluster_store(base + static_cast<uint32_t>(sizeof(T)) *
                               Wd::pad(CrossPass<Plan, false>::first(r, h, t)),
                    a[h * Plan::kC + k]);
  }
  cluster_arrive();
  cluster_wait();  // the slice is whole; no peer writes to s again

  const int slice = lead * Plan::kC + r;
  using P0 = RegPass<kLogM, 0, Wd::kLog, Wd>;
  using P1 = RegPass<kLogM, Wd::kLog, Local::kR1, Wd>;
  P0::load(s, a, t);
  P0::run(a, t, tw, twp, q, slice);
  P0::store(s, a, t);
  __syncthreads();
  P1::load(s, a, t);
  P1::run(a, t, tw, twp, q, slice);
  if constexpr (Local::kR2 > 0) {
    using P2 = RegPass<kLogM, Wd::kLog + Local::kR1, Local::kR2, Wd>;
    P1::store(s, a, t);
    __syncthreads();
    P2::load(s, a, t);
    P2::run(a, t, tw, twp, q, slice);
  }
  // the last pass's runs back to pass 0's layout
  RegLast<kLogM, Wd>::store(s, a, t);
  __syncthreads();
  RegPass<kLogM, 0, Wd::kLog, Wd>::load(s, a, t);
}

// Inverse of rank r on a[] loaded as the runs of the slice's last local
// pass (load_runs<RegLast<kLogM, Words>>): the local passes, the scatter
// of pass 0's words to their cross-pass owners' buffers xs (kM words
// after the padded slice), the cluster barrier, and the cross pass;
// returns with a[] in CrossPass's layout (word k of group h at
// first(r, h, t) + k*N/C) and no peer touching this block's shared memory.
// lead as in cluster_forward.
template <typename Plan, typename T = typename Plan::Word>
__device__ __forceinline__ void cluster_inverse(T* s, T (&a)[Plan::kW], int r, int t,
                                                const T* __restrict__ tw,
                                                const T* __restrict__ twp, T q,
                                                int lead = 1) {
  using Wd = typename Plan::Words;
  constexpr int kLogM = Plan::kLogM;
  using Local = RegPlan<kLogM, Wd>;
  const int slice = lead * Plan::kC + r;
  using P0 = RegPassInv<kLogM, 0, Wd::kLog, Wd>;
  using P1 = RegPassInv<kLogM, Wd::kLog, Local::kR1, Wd>;
  if constexpr (Local::kR2 > 0) {
    using P2 = RegPassInv<kLogM, Wd::kLog + Local::kR1, Local::kR2, Wd>;
    P2::run(a, t, tw, twp, q, slice);
    P2::store(s, a, t);
    __syncthreads();
    P1::load(s, a, t);
  }
  P1::run(a, t, tw, twp, q, slice);
  P1::store(s, a, t);
  __syncthreads();
  P0::load(s, a, t);
  P0::run(a, t, tw, twp, q, slice);

  // word m at slice position p = m*T + t belongs to group p of the cross
  // pass: owner p / (M/C) = m / (W/C), word r of its group
  T* xs = s + Wd::pad(Plan::kM);
  constexpr uint32_t kBytes = sizeof(T);
  cluster_wait();  // every block of the cluster has started
#pragma unroll
  for (int k = 0; k < Plan::kC; ++k) {
    const uint32_t base = cluster_addr(xs, k) + kBytes * (r * Plan::kPerRank + t);
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
      cluster_store(base + kBytes * (h * Plan::kThreads), a[k * Plan::kGroups + h]);
  }
  cluster_arrive();
  cluster_wait();  // xs is whole; no peer writes to it again
#pragma unroll
  for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
    for (int k = 0; k < Plan::kC; ++k)
      a[h * Plan::kC + k] = xs[k * Plan::kPerRank + h * Plan::kThreads + t];
  CrossPass<Plan, true>::run(a, tw, twp, q, lead);
}

// The whole NTT of one plane (or, with its lead, one coefficient slab) on
// the cluster of Plan, rank r (K4 / K5' / K7's ntt_kernel_cluster{,64},
// K10's cluster form): the forward from the cross pass's coalesced loads
// of src, stored coalesced from pass 0's words of the slice; the inverse
// from the slice's runs (16-byte aligned), stored from the cross pass's
// words; then the optional final factor fin[ch] (fin null: none). Every
// thread arrived on the cluster barrier when its block started.
template <typename Plan, bool kInverse, typename T = typename Plan::Word>
__device__ __forceinline__ void cluster_ntt(T* s, const T* __restrict__ src,
                                            T* __restrict__ dst, int r, int tid,
                                            const T* __restrict__ tw,
                                            const T* __restrict__ twp, T q,
                                            const T* __restrict__ fin,
                                            const T* __restrict__ finp, int ch,
                                            int lead = 1) {
  using Cross = CrossPass<Plan, kInverse>;
  constexpr int kC = Plan::kC, kM = Plan::kM, kW = Plan::kW;
  T a[kW];
  if constexpr (!kInverse) {
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
      for (int k = 0; k < kC; ++k) a[h * kC + k] = ldg(src + Cross::first(r, h, tid) + k * kM);
    Cross::run(a, tw, twp, q, lead);
    cluster_forward<Plan>(s, a, r, tid, tw, twp, q, lead);
    store_words<Plan::kLogM, typename Plan::Words>(dst + r * kM, a, tid,
                                                   fin == nullptr ? nullptr : fin + ch,
                                                   fin == nullptr ? nullptr : finp + ch, q);
  } else {
    load_runs<RegLast<Plan::kLogM, typename Plan::Words>>(src + r * kM, a, tid);
    cluster_inverse<Plan>(s, a, r, tid, tw, twp, q, lead);
    if (fin != nullptr) {
      const T fv = fin[ch], fpv = finp[ch];
#pragma unroll
      for (int m = 0; m < kW; ++m) a[m] = harvey(a[m], fv, fpv, q);
    }
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
      for (int k = 0; k < kC; ++k) dst[Cross::first(r, h, tid) + k * kM] = a[h * kC + k];
  }
}

// The cluster kernels, by the id ckks_cluster_info takes: the uint32 forms
// at 2^16 (0 .. 3), then the uint64 forms by one rule, id = kClusterWide
// + kWideForms * (log2 N - 13) + WideForm, for log2 N = 13 .. 16 (4 .. 19:
// 2^13's forward 4, inverse 5, key switch 6, mod-down 7, then 2^14's from
// 8); each source defines its own kernels' accessors.
enum ClusterKernel { kClusterModDown = 0, kClusterNttForward = 1,
                     kClusterNttInverse = 2, kClusterKeySwitch = 3,
                     kClusterWide = 4 };
const void* moddown_cluster_kernel();               // csrc/moddown.cu
const void* moddown_cluster64_kernel(int log_n);    // csrc/moddown.cu
const void* ntt_cluster_kernel(bool inverse);       // csrc/ntt.cu
const void* ntt_cluster64_kernel(int log_n, bool inverse);  // csrc/ntt.cu
const void* keyswitch_cluster_kernel();             // csrc/keyswitch.cu
const void* keyswitch_cluster64_kernel(int log_n);  // csrc/keyswitch.cu

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

// A cluster kernel of Plan as built and as it fits the current device:
// info[0..5] = registers a thread, local (spill) bytes a thread, threads a
// block, dynamic shared bytes a block, blocks a cluster, and clusters
// resident at once (cudaOccupancyMaxActiveClusters). Returns the first
// CUDA error (0 if none).
template <typename Plan>
inline int cluster_info(const void* kernel, size_t smem, int* info) {
  ClusterLaunch<Plan> launch(kernel, 1, smem, nullptr);
  if (launch.err != cudaSuccess) return static_cast<int>(launch.err);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = Plan::kThreads;
  info[3] = static_cast<int>(smem);
  info[4] = Plan::kC;
  info[5] = clusters;
  return 0;
}

}  // namespace ckks
