// The register-pass NTT of one plane, shared by the one-block uint32 forms
// of K1 (csrc/ntt.cu, ntt_kernel_reg), K2 (csrc/keyswitch.cu,
// keyswitch_kernel_reg) and K3 (csrc/moddown.cu, moddown_kernel_reg) at
// N = 2^10 .. 2^15, by K10's one-block forms (csrc/coeff_ntt.cuh,
// tail_kernel_reg: a coefficient slab of 2^10 .. 2^15 uint32 words or
// 2^10 .. 2^12 uint64 words, its twiddles from the slab's lead, see
// RegPass::run), and by the slices of the cluster forms
// (csrc/ntt_cluster.cuh). The stage, group and twiddle conventions are
// those of ntt.cuh; the uint64 one-block forms of K5 / K7 and K8 keep its
// one-stage-per-barrier templates, as does K10 on slabs below 2^10.
//
// The passes are generic over the word (RegWords: its type, the words W a
// thread holds, the pad); uint32 planes take Words32, 32 words a thread,
// and the uint64 forms 16 (ntt_cluster.cuh WideWords). A block has
// N / W threads and each thread holds W words of the plane. A pass runs
// r <= log2 W consecutive stages on them without leaving registers:
// for pass (s, r) a thread's group is the 2^r positions blk * N/2^s +
// m * N/2^(s+r) + off, m < 2^r, and the stage s+l butterfly of (m, m +
// 2^(r-1-l)) takes twiddle tw[2^(s+l) + blk * 2^l + (m >> (r-l))] of the
// compact table, that of the whole plane, loaded once per pass. Passes of
// 32 words: 5+5 at 2^10, 5+3+3 at 2^11, 5+4+3 at 2^12, 5+4+4 at 2^13,
// 5+5+4 at 2^14, 5+5+5 at 2^15 (a thread holds W >> r groups of a pass).
// Between passes the plane goes through shared memory once, with one pad
// word after every 128 bytes (32 uint32 words: no bank conflict at 2^10,
// 2^14, 2^15; 2- to 4-way in the middle pass at 2^11 .. 2^13; 16 uint64
// words: see ntt_cluster.cuh). Pass 0's group is m * N/W + t for thread
// t, so its words come from coalesced loads; the last pass's groups are
// runs of 2^r adjacent words (RegLast), which the inverse reads as
// 16-byte vectors. The inverse (RegPassInv) runs the same passes in
// reverse order, each with its Gentleman-Sande stages from s+r-1 down
// to s.
#pragma once

#include <utility>

#include "ntt.cuh"

namespace ckks {

// The words of a register pass: type T, 2^kLogW of them a thread, and the
// shared-memory slot of a plane position (one pad word after every 128
// bytes: 32 uint32 words, 16 uint64 words).
template <typename T, int kLogW>
struct RegWords {
  using Word = T;
  static constexpr int kLog = kLogW;
  static constexpr int kCount = 1 << kLogW;
  static constexpr int kLogPad = sizeof(T) == 4 ? 5 : 4;

  __host__ __device__ static constexpr int pad(int p) { return p + (p >> kLogPad); }
};

using Words32 = RegWords<uint32_t, 5>;  // the uint32 forms: 32 words a thread

constexpr int kLogRegWords = Words32::kLog;
constexpr int kRegWords = Words32::kCount;  // plane words a thread holds

// Shared-memory word of uint32 plane position p: one pad word after every 32.
__host__ __device__ constexpr int pad(int p) { return Words32::pad(p); }

// The register-pass plan of one plane of 2^kLogN words of Wd.
template <int kLogN, typename Wd = Words32>
struct RegPlan {
  static constexpr int kThreads = 1 << (kLogN - Wd::kLog);
  static constexpr int kRest = kLogN - Wd::kLog;  // stages after pass 0
  static constexpr int kR1 = kRest <= Wd::kLog ? kRest : (kRest + 1) / 2;
  static constexpr int kR2 = kRest - kR1;  // 0: two passes
  // K2: 512 threads an SM, up to 128 registers a thread below 2^15 (one
  // block at 2^14; two blocks of 64 registers were 11% slower), 64 at 2^15
  static constexpr int kMinBlocks = kThreads >= 512 ? 1 : 512 / kThreads;
  // K1, K3: 1024 threads an SM, up to 64 registers a thread (two blocks at
  // 2^14 were 6-11% faster than one)
  static constexpr int kMinBlocksTwo = kThreads >= 1024 ? 1 : 1024 / kThreads;
  static constexpr size_t kSmemBytes = sizeof(typename Wd::Word) * Wd::pad(1 << kLogN);
  static_assert(kR1 <= Wd::kLog && kR2 <= Wd::kLog, "three passes at most");
};

// Stage kL of a pass of 2^kR-word groups on group kH of a[]: group g's
// twiddle is table entry k0 + g; forward Cooley-Tukey (x_u + w*x_v,
// x_u - w*x_v), inverse Gentleman-Sande (x_u + x_v, (x_u - x_v)*w). Every
// loop bound is a constant, so a[] stays in registers.
template <int kR, int kH, int kL, bool kInverse, typename T, int kW>
__device__ __forceinline__ void pass_stage(T (&a)[kW], int k0, const T* __restrict__ tw,
                                           const T* __restrict__ twp, T q) {
  constexpr int kHalf = 1 << (kR - 1 - kL);
#pragma unroll
  for (int g = 0; g < (1 << kL); ++g) {
    const T w = ldg(tw + k0 + g);
    const T wp = ldg(twp + k0 + g);
#pragma unroll
    for (int i = 0; i < kHalf; ++i) {
      const int u = (kH << kR) + 2 * kHalf * g + i;
      const T xu = a[u];
      if constexpr (kInverse) {
        const T xv = a[u + kHalf];
        a[u] = add_mod(xu, xv, q);
        a[u + kHalf] = harvey(sub_mod(xu, xv, q), w, wp, q);
      } else {
        const T xv = harvey(a[u + kHalf], w, wp, q);
        a[u] = add_mod(xu, xv, q);
        a[u + kHalf] = sub_mod(xu, xv, q);
      }
    }
  }
}

// The stage of a pass's step kI: forward kL = kI, inverse kL = kR - 1 - kI.
template <bool kInverse, int kR, int kI>
constexpr int kStageOf = kInverse ? kR - 1 - kI : kI;

// Pass (kS, kR) of the NTT on the W words a thread holds: word (h, m) of
// a[h * 2^kR + m] is plane position pos(t, h, m). The forward runs stages
// kS .. kS + kR - 1, the inverse (kInverse) the same stages from kS + kR
// - 1 down to kS. The twiddle of stage kS + kL and group g of the pass's
// group blk is entry (lead << (kS + kL)) + (blk << kL) + g (see run).
template <int kLogN, int kS, int kR, typename Wd = Words32, bool kInverse = false>
struct RegPass {
  using T = typename Wd::Word;
  static constexpr int kW = Wd::kCount;
  static constexpr int kGroups = kW >> kR;
  static constexpr int kLogOff = kLogN - kS - kR;

  __device__ __forceinline__ static int gid(int t, int h) {
    return t + (h << (kLogN - Wd::kLog));
  }
  // padded shared-memory word of (t, h, 0); word (t, h, m) lies pad(m <<
  // kLogOff) further (the pad is linear in m: a group spans an aligned
  // window of 2^(kR + kLogOff) positions)
  __device__ __forceinline__ static int base(int t, int h) {
    const int g = gid(t, h);
    return Wd::pad(((g >> kLogOff) << (kLogN - kS)) + (g & ((1 << kLogOff) - 1)));
  }

  __device__ __forceinline__ static void store(T* s, const T (&a)[kW], int t) {
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      T* p = s + base(t, h);
#pragma unroll
      for (int m = 0; m < (1 << kR); ++m) p[Wd::pad(m << kLogOff)] = a[(h << kR) + m];
    }
  }

  __device__ __forceinline__ static void load(const T* s, T (&a)[kW], int t) {
#pragma unroll
    for (int h = 0; h < kGroups; ++h) {
      const T* p = s + base(t, h);
#pragma unroll
      for (int m = 0; m < (1 << kR); ++m) a[(h << kR) + m] = p[Wd::pad(m << kLogOff)];
    }
  }

  template <int kH, int... kI>
  __device__ __forceinline__ static void group(T (&a)[kW], int t, int lead,
                                               std::integer_sequence<int, kI...>,
                                               const T* __restrict__ tw,
                                               const T* __restrict__ twp, T q) {
    const int blk = gid(t, kH) >> kLogOff;
    (pass_stage<kR, kH, kStageOf<kInverse, kR, kI>, kInverse>(
         a, (lead << (kS + kStageOf<kInverse, kR, kI>)) + (blk << kStageOf<kInverse, kR, kI>),
         tw, twp, q),
     ...);
  }

  template <int... kH>
  __device__ __forceinline__ static void groups(T (&a)[kW], int t, int lead,
                                                std::integer_sequence<int, kH...>,
                                                const T* __restrict__ tw,
                                                const T* __restrict__ twp, T q) {
    (group<kH>(a, t, lead, std::make_integer_sequence<int, kR>{}, tw, twp, q), ...);
  }

  // lead: 1 on a whole plane; on piece G of the 2^k equal pieces of a
  // plane (a coefficient slab, a cluster's slice), whose local stage s'
  // is the plane's stage k + s', lead = 2^k + G, so that local group g'
  // takes the plane's entry 2^(k + s') + G * 2^s' + g'
  __device__ __forceinline__ static void run(T (&a)[kW], int t, const T* __restrict__ tw,
                                             const T* __restrict__ twp, T q, int lead = 1) {
    groups(a, t, lead, std::make_integer_sequence<int, kGroups>{}, tw, twp, q);
  }
};

// The inverse pass (kS, kR): RegPass's words, its stages kS + kR - 1 down
// to kS as Gentleman-Sande butterflies with the inverse compact table.
template <int kLogN, int kS, int kR, typename Wd = Words32>
using RegPassInv = RegPass<kLogN, kS, kR, Wd, true>;

// The last forward pass of the plan (the first inverse one): its groups
// are the runs of 2^kR adjacent words at gid(t, h) << kR.
template <int kLogN, typename Wd = Words32>
using RegLast = RegPass<kLogN,
                        (RegPlan<kLogN, Wd>::kR2 > 0 ? Wd::kLog + RegPlan<kLogN, Wd>::kR1
                                                     : Wd::kLog),
                        (RegPlan<kLogN, Wd>::kR2 > 0 ? RegPlan<kLogN, Wd>::kR2
                                                     : RegPlan<kLogN, Wd>::kR1),
                        Wd>;

// Global words in the last forward pass's layout, the inverse's first:
// group h of thread t is the run of 2^kR adjacent plane words at gid(t, h)
// << kR, read into a[h * 2^kR ..] as 16-byte vectors (src 16-byte
// aligned).
template <typename Last>
__device__ __forceinline__ void load_runs(const typename Last::T* __restrict__ src,
                                          typename Last::T (&a)[Last::kW], int t) {
  static_assert(Last::kLogOff == 0, "runs of adjacent words: the last pass");
  constexpr int kRun = Last::kW / Last::kGroups;
#pragma unroll
  for (int h = 0; h < Last::kGroups; ++h) {
    if constexpr (sizeof(typename Last::T) == 4) {
      const uint4* p = reinterpret_cast<const uint4*>(src + Last::gid(t, h) * kRun);
#pragma unroll
      for (int i = 0; i < kRun / 4; ++i) {
        const uint4 v = __ldg(p + i);
        uint32_t* r = a + h * kRun + 4 * i;
        r[0] = v.x;
        r[1] = v.y;
        r[2] = v.z;
        r[3] = v.w;
      }
    } else {
      const ulonglong2* p =
          reinterpret_cast<const ulonglong2*>(src + Last::gid(t, h) * kRun);
#pragma unroll
      for (int i = 0; i < kRun / 2; ++i) {
        const ulonglong2 v = __ldg(p + i);
        a[h * kRun + 2 * i] = v.x;
        a[h * kRun + 2 * i + 1] = v.y;
      }
    }
  }
}

// The forward passes of the plan on a[] in pass 0's layout; returns with
// a[] in the last pass's layout (RegLast). s is the block's padded plane
// (RegPlan::kSmemBytes), not read by any thread at the call; lead as in
// RegPass::run.
template <int kLogN, typename Wd = Words32, typename T = typename Wd::Word>
__device__ __forceinline__ void reg_forward(T* s, T (&a)[Wd::kCount], int t,
                                            const T* __restrict__ tw,
                                            const T* __restrict__ twp, T q, int lead = 1) {
  using Plan = RegPlan<kLogN, Wd>;
  using P0 = RegPass<kLogN, 0, Wd::kLog, Wd>;
  using P1 = RegPass<kLogN, Wd::kLog, Plan::kR1, Wd>;
  P0::run(a, t, tw, twp, q, lead);
  P0::store(s, a, t);
  __syncthreads();
  P1::load(s, a, t);
  P1::run(a, t, tw, twp, q, lead);
  if constexpr (Plan::kR2 > 0) {
    using P2 = RegPass<kLogN, Wd::kLog + Plan::kR1, Plan::kR2, Wd>;
    P1::store(s, a, t);
    __syncthreads();
    P2::load(s, a, t);
    P2::run(a, t, tw, twp, q, lead);
  }
}

// The inverse passes of the plan on a[] in the last forward pass's layout
// (RegLast), stages log2 N - 1 down to 0; returns with a[] in pass 0's
// layout, every word at m * N/W + t. Same contract on s and lead as
// reg_forward.
template <int kLogN, typename Wd = Words32, typename T = typename Wd::Word>
__device__ __forceinline__ void reg_inverse(T* s, T (&a)[Wd::kCount], int t,
                                            const T* __restrict__ tw,
                                            const T* __restrict__ twp, T q, int lead = 1) {
  using Plan = RegPlan<kLogN, Wd>;
  using P0 = RegPassInv<kLogN, 0, Wd::kLog, Wd>;
  using P1 = RegPassInv<kLogN, Wd::kLog, Plan::kR1, Wd>;
  if constexpr (Plan::kR2 > 0) {
    using P2 = RegPassInv<kLogN, Wd::kLog + Plan::kR1, Plan::kR2, Wd>;
    P2::run(a, t, tw, twp, q, lead);
    P2::store(s, a, t);
    __syncthreads();
    P1::load(s, a, t);
  }
  P1::run(a, t, tw, twp, q, lead);
  P1::store(s, a, t);
  __syncthreads();
  P0::load(s, a, t);
  P0::run(a, t, tw, twp, q, lead);
}

// dst[m * N/W + tid] = a[m] * *f (Harvey), or a[m] where f is null.
template <int kLogN, typename Wd = Words32, typename T = typename Wd::Word>
__device__ __forceinline__ void store_words(T* __restrict__ dst, const T (&a)[Wd::kCount],
                                            int tid, const T* __restrict__ f,
                                            const T* __restrict__ fp, T q) {
  constexpr int kT = RegPlan<kLogN, Wd>::kThreads;
  if (f != nullptr) {
    const T fv = *f, fpv = *fp;
#pragma unroll
    for (int m = 0; m < Wd::kCount; ++m) dst[m * kT + tid] = harvey(a[m], fv, fpv, q);
  } else {
#pragma unroll
    for (int m = 0; m < Wd::kCount; ++m) dst[m * kT + tid] = a[m];
  }
}

// The whole register-pass NTT of one plane of 2^kLogN words that one
// block holds (K1's ntt_kernel_reg; K10's one-block form on a slab with
// its lead): the forward from coalesced loads of src in pass 0's layout,
// its last pass's runs back to that layout through s; the inverse from
// src's runs (16-byte aligned: load_runs); then the optional final
// factor *f and a coalesced store into dst.
template <int kLogN, bool kInverse, typename Wd = Words32, typename T = typename Wd::Word>
__device__ __forceinline__ void reg_ntt(T* s, const T* __restrict__ src, T* __restrict__ dst,
                                        int tid, const T* __restrict__ tw,
                                        const T* __restrict__ twp, T q,
                                        const T* __restrict__ f, const T* __restrict__ fp,
                                        int lead = 1) {
  using Last = RegLast<kLogN, Wd>;
  constexpr int kT = RegPlan<kLogN, Wd>::kThreads;
  T a[Wd::kCount];
  if constexpr (!kInverse) {
#pragma unroll
    for (int m = 0; m < Wd::kCount; ++m) a[m] = ldg(src + m * kT + tid);
    reg_forward<kLogN, Wd>(s, a, tid, tw, twp, q, lead);
    Last::store(s, a, tid);
    __syncthreads();
    RegPass<kLogN, 0, Wd::kLog, Wd>::load(s, a, tid);
  } else {
    load_runs<Last>(src, a, tid);
    reg_inverse<kLogN, Wd>(s, a, tid, tw, twp, q, lead);
  }
  store_words<kLogN, Wd>(dst, a, tid, f, fp, q);
}

// The shapes the register-pass kernels take: log2 N in [10, 15].
constexpr bool reg_shape(int log_n) { return log_n >= 10 && log_n <= 15; }

// f(std::integral_constant<int, log_n>{}) for a log_n that reg_shape takes.
template <typename F>
auto reg_dispatch(int log_n, F f) -> decltype(f(std::integral_constant<int, 15>{})) {
  switch (log_n) {
    case 10: return f(std::integral_constant<int, 10>{});
    case 11: return f(std::integral_constant<int, 11>{});
    case 12: return f(std::integral_constant<int, 12>{});
    case 13: return f(std::integral_constant<int, 13>{});
    case 14: return f(std::integral_constant<int, 14>{});
    default: return f(std::integral_constant<int, 15>{});
  }
}

// The register-pass kernels, by the id ckks_reg_info takes; each source
// defines its own (nullptr outside reg_shape).
enum RegKernel { kRegKeySwitch = 0, kRegModDown = 1, kRegNttForward = 2,
                 kRegNttInverse = 3 };
const void* keyswitch_reg_kernel(int log_n);          // csrc/keyswitch.cu
const void* moddown_reg_kernel(int log_n);            // csrc/moddown.cu
const void* ntt_reg_kernel(int log_n, bool inverse);  // csrc/ntt.cu

// A register-pass kernel at log_n (RegPlan's threads and shared memory) as
// built and as it fits the current device: info[0..4] = registers a thread,
// local (spill) bytes a thread, threads a block, dynamic shared bytes a
// block, resident blocks an SM. Returns the first CUDA error (0 if none).
inline int reg_info(const void* kernel, int log_n, int* info) {
  const int threads = 1 << (log_n - kLogRegWords);
  const size_t smem = sizeof(uint32_t) * pad(1 << log_n);
  cudaError_t err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.localSizeBytes);
  info[2] = threads;
  info[3] = static_cast<int>(smem);
  info[4] = blocks;
  return 0;
}

}  // namespace ckks
