// K10 / K11: the coefficient-sharded negacyclic NTT, on uint32 words (small
// chains: csrc/coeff_ntt.cu) and uint64 words (wide chains:
// csrc/coeff_ntt64.cu), both built from the templates here.
//
// Replaces the Pallas TPU kernels of toy_heaan_ckks_tpu/parallel/coeff_ntt.py:
// _tail_kernel (K10, the local stages of one shard's slab) and
// _cross_stage_remote_kernel (K11, one stage whose butterflies pair two
// shards, after a remote DMA of the partner's slab). The reference's wide
// sharded NTT has no kernel (its stage body is jnp); the uint64 entries
// here are the same templates.
//
// A plane (item, channel) of N = 2^log_n words is held as P contiguous slabs
// of S = N / P words, slab p on shard p of the coefficient mesh; each shard's
// tensor is (planes, S). The first log2 P stages (distance d >= S) pair slab
// p with slab p ^ (d / S) at the same offset: K11 runs one of them. The
// stages [log2 P, log2 N) stay inside a slab: K10 runs them all. Butterflies
// and twiddle indices are those of the whole plane (ntt.cuh), taken at the
// slab's global offset p * S, so the words equal K1's on the unsharded plane.
//
// One launch covers every shard that lies on one device: the host passes the
// P input and output slab pointers and the shards the launch writes inside
// the kernel's parameters (Slabs, by value: no device array to fill first).
// A partner slab on another card is read through its peer pointer
// (cudaDeviceEnablePeerAccess, ckks_enable_peer_access) with no change here.
//
// K10 treats a slab as a plane of S words whose twiddles start at a lead:
// local stage s' of slab p is the plane's stage log2 P + s' and local
// group g' its group p * 2^s' + g', table entry ((P + p) << s') + g', the
// rule of ntt_reg.cuh's RegPass::run. Its forms, by the slab's size and
// the host's cluster flag (coeff_ntt_gpu.slab_form):
//
// - below 2^10 words, tail_kernel<T>: the template, one block of 512
//   threads and one barrier a stage (ntt.cuh forward_local /
//   inverse_local);
// - flag 0, tail_kernel_reg<T, log2 S, inverse>: one block of S/W threads
//   a slab, K1's register passes (ntt_reg.cuh reg_ntt: 32 uint32 words a
//   thread at S = 2^10 .. 2^15, 16 uint64 words at 2^10 .. 2^12, three
//   passes at most), the forward from coalesced loads, the inverse from
//   16-byte runs, the final factor on pass 0's words;
// - flag 1, tail_kernel_cluster<T, log2 S, log2 C, inverse>: a cluster of
//   C = 2^kSlabLogCluster* blocks a slab, K4's plan (ntt_cluster.cuh
//   cluster_ntt) with the slab's lead, at S = 2^12 and up (slices of 2^10
//   words or more); the only form of a uint64 slab of 2^13 or 2^14.
//
// A flag for a form that is not built returns cudaErrorInvalidValue; a
// cluster that cannot be resident kErrClusterDoesNotFit. No form gives way
// to another.
//
// K11 has two forms. Where every shard of a launch lies on one card and P
// <= kStagesMaxShards, cross_stages_kernel runs all log2 P cross stages in
// one launch: a thread owns one offset (plane, i) across the P slabs, loads
// the P words into registers, runs the butterflies there and writes the P
// words, so each word is read once and written once per transform (the
// per-stage form reads it twice and writes it once a stage). Above that P,
// and where the shards span several cards, cross_kernel runs one stage a
// launch, the partner slab read through its (peer) pointer.
//
// What bounds them on an H100: K10 the integer pipe, as K1 and K4 (the
// template: its serial chain of log2 S shared-memory stages); K11 device
// memory (per stage two words read and one written per output word; all
// stages at once one read and one write). Measured on an
// NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py, device time, forward
// / inverse): (4, 4, 2^16) P 4, 64 slabs of 2^14 on clusters of 4,
// 0.0125-0.0126 / 0.0120-0.0121 ms against 0.0480-0.0482 / 0.0464 for the
// template; (4, 3, 2^15) uint64 P 4, 48 slabs of 2^13 on clusters of 8,
// 0.0114 / 0.0109 (0.0337-0.0365 / 0.0334); (32, 8, 2^14) P 8, 2,048
// slabs of 2^11 on one block each, 0.0216-0.0217 / 0.0223 (0.0526-0.0540
// / 0.0531-0.0535). K11, every cross stage of a forward transform, in
// turns with the per-stage launches on the same slabs: (4, 4, 2^16) P 4
// 0.0028 (0.0153); (4, 3, 2^15) uint64 P 4 0.0025 (0.0079); (32, 8, 2^14)
// P 8 0.0082 (0.0810; the 34 MB it moves stay in the 50 MB L2 between
// calls, so it reads faster than device memory could deliver).
#pragma once

#include <type_traits>

#include "ntt.cuh"
#include "ntt_cluster.cuh"
#include "ntt_reg.cuh"

namespace ckks {
// K10's uint64 form query (csrc/coeff_ntt64.cu), for ckks_coeff_tail_info.
int coeff_tail64_info(int log_s, int cluster, int inverse, int* info);
}  // namespace ckks

namespace {

constexpr int kMaxShards = 64;
constexpr int kCrossThreads = 256;
// the most shards K11's one-launch form holds (P words a thread, in
// registers); coeff_ntt_gpu.STAGES_MAX_SHARDS
constexpr int kStagesMaxShards = 16;

template <typename T>
struct Slabs {
  const T* in[kMaxShards];  // every shard's input slab
  T* out[kMaxShards];       // every shard's output slab
  int ids[kMaxShards];      // the shards this launch writes
};

// K10's template: one block per (shard ids[blockIdx.x / planes], plane).
// Forward stages log2 P .. log2 N - 1 or inverse stages log2 N - 1 .. log2
// P on the slab in shared memory, then the optional per-channel final
// factor.
template <typename T>
__global__ void __launch_bounds__(ckks::kThreads)
tail_kernel(Slabs<T> slabs, const T* __restrict__ tw, const T* __restrict__ twp,
            const T* __restrict__ q, const T* __restrict__ fin,
            const T* __restrict__ finp, int planes, int channels, int log_n,
            int log_s, int inverse) {
  T* s = ckks::smem_plane<T>();
  const int m = 1 << log_s;
  const int p = slabs.ids[blockIdx.x / planes];
  const long long plane = blockIdx.x % planes;
  const int ch = static_cast<int>(plane % channels);
  const int cross = log_n - log_s;
  const T qc = q[ch];
  const T* src = slabs.in[p] + (plane << log_s);
  T* dst = slabs.out[p] + (plane << log_s);
  const T* w = tw + (static_cast<long long>(ch) << log_n);
  const T* wp = twp + (static_cast<long long>(ch) << log_n);

  for (int i = threadIdx.x; i < m; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  if (inverse) {
    ckks::inverse_local(s, log_n, log_s, p, cross, w, wp, qc);
  } else {
    ckks::forward_local(s, log_n, log_s, p, cross, w, wp, qc);
  }
  if (fin != nullptr) {
    const T f = fin[ch], fp = finp[ch];
    for (int i = threadIdx.x; i < m; i += blockDim.x)
      dst[i] = ckks::harvey(s[i], f, fp, qc);
  } else {
    for (int i = threadIdx.x; i < m; i += blockDim.x) dst[i] = s[i];
  }
}

// The register words of K10's forms on T.
template <typename T>
using SlabWords = std::conditional_t<sizeof(T) == 4, ckks::Words32, ckks::WideWords>;

// log2 C of K10's cluster form by the slab's words 2^log2 S, uint32 and
// uint64 (tests/test_torch_cluster_plan.py reads these constants). Of C =
// 4, 8, 16 on an NVIDIA H100 80GB HBM3 at 700 W (device time,
// tools/kernel_ab.py --k10-forms on a build of every C; to time another
// C, build a copy with the constant changed): 64 uint32 slabs of 2^14
// took 0.0125 ms on 4, 0.0126 on 8, 0.0169 on 16; 48 uint64 slabs of 2^13
// 0.0113 on 8, 0.0114 on 4; 24 uint64 slabs of 2^14 0.0120 on 8, 0.0122
// on 16, 0.0130 on 4. The untimed sizes keep slices of 2^10 .. 2^12.
constexpr int kSlabLogCluster12 = 2;
constexpr int kSlabLogCluster13 = 2;
constexpr int kSlabLogCluster14 = 2;
constexpr int kSlabLogCluster15 = 3;
constexpr int kSlabLogClusterWide12 = 2;
constexpr int kSlabLogClusterWide13 = 3;
constexpr int kSlabLogClusterWide14 = 3;

// log2 C of K10's cluster form for a slab of 2^log_s words of T, 0 where
// it has none.
template <typename T>
constexpr int slab_log_cluster(int log_s) {
  if (sizeof(T) == 4) {
    return log_s == 12   ? kSlabLogCluster12
           : log_s == 13 ? kSlabLogCluster13
           : log_s == 14 ? kSlabLogCluster14
           : log_s == 15 ? kSlabLogCluster15
                         : 0;
  }
  return log_s == 12   ? kSlabLogClusterWide12
         : log_s == 13 ? kSlabLogClusterWide13
         : log_s == 14 ? kSlabLogClusterWide14
                       : 0;
}

// Whether K10 has a one-block register form for a slab of 2^log_s words
// of T: 2^10 words up to what three register passes hold.
template <typename T>
constexpr bool slab_one_block(int log_s) {
  return log_s >= 10 && log_s <= 3 * SlabWords<T>::kLog;
}

// One slab of a K10 launch: slab `slab` of 2^log_s words is shard
// ids[slab / planes]'s plane slab % planes, with its channel ch's
// whole-plane tables and modulus, and its lead P + p.
template <typename T>
struct SlabArgs {
  const T* src;
  T* dst;
  const T* w;
  const T* wp;
  T q;
  int ch;
  int lead;
};

template <typename T>
__device__ __forceinline__ SlabArgs<T> slab_args(const Slabs<T>& slabs, int slab,
                                                 const T* tw, const T* twp, const T* q,
                                                 int planes, int channels, int log_n,
                                                 int log_s) {
  const int p = slabs.ids[slab / planes];
  const long long plane = slab % planes;
  const int ch = static_cast<int>(plane % channels);
  const long long table = static_cast<long long>(ch) << log_n;
  return {slabs.in[p] + (plane << log_s), slabs.out[p] + (plane << log_s),
          tw + table, twp + table, q[ch], ch, (1 << (log_n - log_s)) + p};
}

using ckks::RegPlan;
template <typename T, int kLogS>
using SlabRegPlan = RegPlan<kLogS, SlabWords<T>>;
template <typename T, int kLogS, int kLogC>
using SlabPlan = ckks::ClusterPlan<kLogS, kLogC, SlabWords<T>>;

// Resident threads an SM the forms promise ptxas: K1's / K4's 1024 (64
// registers a thread) on uint32 words, the uint64 cluster forms' 512 (128)
// on uint64.
template <typename T, int kThreads>
constexpr int kTailMinBlocks = (sizeof(T) == 4 ? 1024 : ckks::kWideThreadsPerSm) / kThreads;

// K10's one-block form (the header): one block of S/W threads a slab.
template <typename T, int kLogS, bool kInverse>
__global__ void __launch_bounds__(SlabRegPlan<T, kLogS>::kThreads,
                                  kTailMinBlocks<T, SlabRegPlan<T, kLogS>::kThreads>)
tail_kernel_reg(Slabs<T> slabs, const T* __restrict__ tw, const T* __restrict__ twp,
                const T* __restrict__ q, const T* __restrict__ fin,
                const T* __restrict__ finp, int planes, int channels, int log_n) {
  const SlabArgs<T> a =
      slab_args(slabs, blockIdx.x, tw, twp, q, planes, channels, log_n, kLogS);
  ckks::reg_ntt<kLogS, kInverse, SlabWords<T>>(
      ckks::smem_plane<T>(), a.src, a.dst, threadIdx.x, a.w, a.wp, a.q,
      fin == nullptr ? nullptr : fin + a.ch, fin == nullptr ? nullptr : finp + a.ch, a.lead);
}

// K10's cluster form (the header): one cluster of C blocks of S/C/W
// threads a slab, rank blockIdx.x mod C.
template <typename T, int kLogS, int kLogC, bool kInverse>
__global__ void __launch_bounds__(SlabPlan<T, kLogS, kLogC>::kThreads,
                                  kTailMinBlocks<T, SlabPlan<T, kLogS, kLogC>::kThreads>)
tail_kernel_cluster(Slabs<T> slabs, const T* __restrict__ tw, const T* __restrict__ twp,
                    const T* __restrict__ q, const T* __restrict__ fin,
                    const T* __restrict__ finp, int planes, int channels, int log_n) {
  ckks::cluster_arrive_relaxed();  // this block has started
  const int r = static_cast<int>(blockIdx.x) & ((1 << kLogC) - 1);
  const SlabArgs<T> a = slab_args(slabs, static_cast<int>(blockIdx.x) >> kLogC, tw, twp, q,
                                  planes, channels, log_n, kLogS);
  ckks::cluster_ntt<SlabPlan<T, kLogS, kLogC>, kInverse>(
      ckks::smem_plane<T>(), a.src, a.dst, r, threadIdx.x, a.w, a.wp, a.q, fin, finp, a.ch,
      a.lead);
}

// K11: one thread per output word of the launch's shards. Stage st has
// distance d = N >> (st + 1) >= S; thread i of shard p reads its word x and
// the partner's y = in[p ^ (d / S)][same offset]. Both sides of a butterfly
// take twiddle tw[2^st + g], g = (p*S + i) >> (log2 d + 1), and p & (d / S)
// picks the side: forward (Cooley-Tukey) u = x + w*y, v = y - w*x; inverse
// (Gentleman-Sande) u = x + y, v = (y - x)*w. Then the optional final
// factor. Out and in are distinct slabs (each shard reads its partner's
// input while the partner writes its own output).
template <typename T>
__global__ void __launch_bounds__(kCrossThreads)
cross_kernel(Slabs<T> slabs, const T* __restrict__ tw, const T* __restrict__ twp,
             const T* __restrict__ q, const T* __restrict__ fin,
             const T* __restrict__ finp, long long total, int planes,
             int channels, int log_n, int log_s, int stage, int inverse) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long i = idx & ((1LL << log_s) - 1);
  const long long rest = idx >> log_s;
  const long long plane = rest % planes;
  const int p = slabs.ids[rest / planes];
  const int log_d = log_n - 1 - stage;
  const int shift = 1 << (log_d - log_s);
  const int ch = static_cast<int>(plane % channels);
  const long long off = (plane << log_s) + i;
  const T x = slabs.in[p][off];
  const T y = slabs.in[p ^ shift][off];
  const long long g = ((static_cast<long long>(p) << log_s) + i) >> (log_d + 1);
  const long long k = (static_cast<long long>(ch) << log_n) + (1LL << stage) + g;
  const T w = ckks::ldg(tw + k), wp = ckks::ldg(twp + k), qc = q[ch];
  T r;
  if ((p & shift) == 0) {
    r = inverse ? ckks::add_mod(x, y, qc)
                : ckks::add_mod(x, ckks::harvey(y, w, wp, qc), qc);
  } else {
    r = inverse ? ckks::harvey(ckks::sub_mod(y, x, qc), w, wp, qc)
                : ckks::sub_mod(y, ckks::harvey(x, w, wp, qc), qc);
  }
  if (fin != nullptr) r = ckks::harvey(r, fin[ch], finp[ch], qc);
  slabs.out[p][off] = r;
}

// K11's one-launch form: every cross stage of a transform, all P =
// 2^kLogP shards on the launch's card. Thread (plane, i) loads x[p] =
// in[p][plane * S + i] for every slab p (neighbouring threads take
// neighbouring i, so each slab's loads coalesce), runs the stages in
// registers and writes out[p] at the same offset. Stage st pairs slab p
// with p + h, h = P >> (st + 1) = d / S, for p & h == 0; both take twiddle
// tw[2^st + g] with g = (p * S + i) >> (log2 d + 1) = p / (2h), the index
// of cross_kernel. Forward (Cooley-Tukey) stages 0 .. log2 P - 1: x[p] +
// w x[p+h], x[p] - w x[p+h]; inverse (Gentleman-Sande) stages log2 P - 1
// .. 0: x[p] + x[p+h], (x[p] - x[p+h]) w; then the optional final factor
// on every word. The words equal log2 P launches of cross_kernel.
template <typename T, int kLogP>
__global__ void __launch_bounds__(kCrossThreads)
cross_stages_kernel(Slabs<T> slabs, const T* __restrict__ tw, const T* __restrict__ twp,
                    const T* __restrict__ q, const T* __restrict__ fin,
                    const T* __restrict__ finp, long long total, int channels, int log_n,
                    int log_s, int inverse) {
  constexpr int kP = 1 << kLogP;
  const long long off = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (off >= total) return;
  const int ch = static_cast<int>((off >> log_s) % channels);
  const T qc = q[ch];
  const T* w = tw + (static_cast<long long>(ch) << log_n);
  const T* wp = twp + (static_cast<long long>(ch) << log_n);
  T x[kP];
#pragma unroll
  for (int p = 0; p < kP; ++p) x[p] = slabs.in[p][off];
  if (!inverse) {
#pragma unroll
    for (int st = 0; st < kLogP; ++st) {
      const int h = kP >> (st + 1);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (p & h) continue;
        const int k = (1 << st) + p / (2 * h);
        const T v = ckks::harvey(x[p + h], ckks::ldg(w + k), ckks::ldg(wp + k), qc);
        const T u = x[p];
        x[p] = ckks::add_mod(u, v, qc);
        x[p + h] = ckks::sub_mod(u, v, qc);
      }
    }
  } else {
#pragma unroll
    for (int st = kLogP - 1; st >= 0; --st) {
      const int h = kP >> (st + 1);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (p & h) continue;
        const int k = (1 << st) + p / (2 * h);
        const T u = x[p], v = x[p + h];
        x[p] = ckks::add_mod(u, v, qc);
        x[p + h] = ckks::harvey(ckks::sub_mod(u, v, qc), ckks::ldg(w + k), ckks::ldg(wp + k), qc);
      }
    }
  }
  if (fin != nullptr) {
    const T f = fin[ch], fp = finp[ch];
#pragma unroll
    for (int p = 0; p < kP; ++p) x[p] = ckks::harvey(x[p], f, fp, qc);
  }
#pragma unroll
  for (int p = 0; p < kP; ++p) slabs.out[p][off] = x[p];
}

template <typename T>
int fill(Slabs<T>* slabs, const void* const* in, void* const* out,
         const int* ids, int count, int shards) {
  if (shards < 1 || shards > kMaxShards || count < 1 || count > shards)
    return cudaErrorInvalidValue;
  for (int p = 0; p < shards; ++p) {
    slabs->in[p] = static_cast<const T*>(in[p]);
    slabs->out[p] = static_cast<T*>(out[p]);
  }
  for (int j = 0; j < count; ++j) {
    if (ids[j] < 0 || ids[j] >= shards) return cudaErrorInvalidValue;
    slabs->ids[j] = ids[j];
  }
  return cudaSuccess;
}

// f(integral_constant<log S>, integral_constant<log C>) for K10's register
// form of a slab of 2^log_s words: one block (cluster 0, log C = 0) or
// the slab's cluster (cluster 1, log C = slab_log_cluster); else
// cudaErrorInvalidValue.
template <typename T, int kLogS = 10, typename F>
int tail_form_dispatch(int log_s, int cluster, F f) {
  if constexpr (kLogS > 15) {
    return cudaErrorInvalidValue;
  } else {
    if (log_s != kLogS) return tail_form_dispatch<T, kLogS + 1>(log_s, cluster, f);
    constexpr int kLogC = slab_log_cluster<T>(kLogS);
    if constexpr (kLogC > 0) {
      if (cluster)
        return f(std::integral_constant<int, kLogS>{}, std::integral_constant<int, kLogC>{});
    }
    if constexpr (slab_one_block<T>(kLogS)) {
      if (!cluster)
        return f(std::integral_constant<int, kLogS>{}, std::integral_constant<int, 0>{});
    }
    return cudaErrorInvalidValue;
  }
}

// K10 on count * planes slabs of 2^log_s words: the template below 2^10
// (cluster 0 only), else the register form of the cluster flag.
template <typename T>
int launch_tail(const void* const* in, void* const* out, const int* ids,
                int count, int shards, const T* tw, const T* twp, const T* q,
                const T* fin, const T* finp, int planes, int channels,
                int log_n, int log_s, int cluster, int inverse, cudaStream_t stream) {
  Slabs<T> slabs;
  int err = fill(&slabs, in, out, ids, count, shards);
  if (err != cudaSuccess) return err;
  const long long slab_count = static_cast<long long>(count) * planes;
  // (a cluster holds 16 blocks at most)
  if (log_s < 1 || log_s > log_n || shards != 1 << (log_n - log_s) || slab_count < 1 ||
      (slab_count << 4) > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int blocks = static_cast<int>(slab_count);
  if (log_s < 10) {
    if (cluster) return cudaErrorInvalidValue;
    const size_t smem = ckks::plane_bytes<T>(log_s);
    err = ckks::reserve_smem(reinterpret_cast<const void*>(tail_kernel<T>), smem);
    if (err != cudaSuccess) return err;
    tail_kernel<T><<<blocks, ckks::kThreads, smem, stream>>>(
        slabs, tw, twp, q, fin, finp, planes, channels, log_n, log_s, inverse);
    return static_cast<int>(cudaGetLastError());
  }
  return tail_form_dispatch<T>(log_s, cluster, [&](auto log_s_c, auto log_c_c) -> int {
    constexpr int kLogS = decltype(log_s_c)::value, kLogC = decltype(log_c_c)::value;
    if constexpr (kLogC == 0) {
      using Plan = SlabRegPlan<T, kLogS>;
      auto kernel = inverse ? tail_kernel_reg<T, kLogS, true> : tail_kernel_reg<T, kLogS, false>;
      const cudaError_t e =
          ckks::reserve_smem(reinterpret_cast<const void*>(kernel), Plan::kSmemBytes);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<blocks, Plan::kThreads, Plan::kSmemBytes, stream>>>(
          slabs, tw, twp, q, fin, finp, planes, channels, log_n);
      return static_cast<int>(cudaGetLastError());
    } else {
      using Plan = SlabPlan<T, kLogS, kLogC>;
      return inverse
                 ? ckks::launch_cluster<Plan, &tail_kernel_cluster<T, kLogS, kLogC, true>>(
                       blocks, Plan::kInverseBytes, stream, slabs, tw, twp, q, fin, finp,
                       planes, channels, log_n)
                 : ckks::launch_cluster<Plan, &tail_kernel_cluster<T, kLogS, kLogC, false>>(
                       blocks, Plan::kForwardBytes, stream, slabs, tw, twp, q, fin, finp,
                       planes, channels, log_n);
    }
  });
}

// K10's register form (log_s >= 10, the cluster flag) as built and as it
// fits the current device: info[0..5] = registers a thread, local (spill)
// bytes a thread, threads a block, dynamic shared bytes a block, blocks a
// slab, and slabs resident at once on the card (clusters, or blocks an SM
// times the SMs).
template <typename T>
int tail_info(int log_s, int cluster, int inverse, int* info) {
  return tail_form_dispatch<T>(log_s, cluster, [&](auto log_s_c, auto log_c_c) -> int {
    constexpr int kLogS = decltype(log_s_c)::value, kLogC = decltype(log_c_c)::value;
    if constexpr (kLogC == 0) {
      using Plan = SlabRegPlan<T, kLogS>;
      const void* kernel = inverse
                               ? reinterpret_cast<const void*>(tail_kernel_reg<T, kLogS, true>)
                               : reinterpret_cast<const void*>(tail_kernel_reg<T, kLogS, false>);
      cudaError_t err = ckks::reserve_smem(kernel, Plan::kSmemBytes);
      cudaFuncAttributes attr;
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
      int blocks = 0, device = 0, sms = 0;
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, Plan::kThreads,
                                                            Plan::kSmemBytes);
      if (err == cudaSuccess) err = cudaGetDevice(&device);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return static_cast<int>(err);
      info[0] = attr.numRegs;
      info[1] = static_cast<int>(attr.localSizeBytes);
      info[2] = Plan::kThreads;
      info[3] = static_cast<int>(Plan::kSmemBytes);
      info[4] = 1;
      info[5] = blocks * sms;
      return 0;
    } else {
      using Plan = SlabPlan<T, kLogS, kLogC>;
      return inverse
                 ? ckks::cluster_info<Plan>(
                       reinterpret_cast<const void*>(tail_kernel_cluster<T, kLogS, kLogC, true>),
                       Plan::kInverseBytes, info)
                 : ckks::cluster_info<Plan>(
                       reinterpret_cast<const void*>(tail_kernel_cluster<T, kLogS, kLogC, false>),
                       Plan::kForwardBytes, info);
    }
  });
}

template <typename T>
int launch_cross(const void* const* in, void* const* out, const int* ids,
                 int count, int shards, const T* tw, const T* twp, const T* q,
                 const T* fin, const T* finp, int planes, int channels,
                 int log_n, int log_s, int stage, int inverse,
                 cudaStream_t stream) {
  Slabs<T> slabs;
  int err = fill(&slabs, in, out, ids, count, shards);
  if (err != cudaSuccess) return err;
  const int log_d = log_n - 1 - stage;
  if (stage < 0 || log_d < log_s || (1 << (log_d - log_s)) >= shards)
    return cudaErrorInvalidValue;
  const long long total = (static_cast<long long>(count) * planes) << log_s;
  const long long blocks = (total + kCrossThreads - 1) / kCrossThreads;
  if (blocks < 1 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cross_kernel<T><<<static_cast<unsigned>(blocks), kCrossThreads, 0, stream>>>(
      slabs, tw, twp, q, fin, finp, total, planes, channels, log_n, log_s,
      stage, inverse);
  return static_cast<int>(cudaGetLastError());
}

// K11's one-launch form on `shards` slabs (planes, S), all on the current
// device, 2 <= shards <= kStagesMaxShards.
template <typename T>
int launch_cross_stages(const void* const* in, void* const* out, int shards, const T* tw,
                        const T* twp, const T* q, const T* fin, const T* finp, int planes,
                        int channels, int log_n, int log_s, int inverse,
                        cudaStream_t stream) {
  if (shards < 2 || shards > kStagesMaxShards || log_s < 1 ||
      shards != 1 << (log_n - log_s) || planes < 1)
    return cudaErrorInvalidValue;
  int ids[kMaxShards];
  for (int p = 0; p < shards; ++p) ids[p] = p;
  Slabs<T> slabs;
  const int err = fill(&slabs, in, out, ids, shards, shards);
  if (err != cudaSuccess) return err;
  const long long total = static_cast<long long>(planes) << log_s;
  const long long blocks = (total + kCrossThreads - 1) / kCrossThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = static_cast<unsigned>(blocks);
  switch (log_n - log_s) {
    case 1:
      cross_stages_kernel<T, 1><<<grid, kCrossThreads, 0, stream>>>(
          slabs, tw, twp, q, fin, finp, total, channels, log_n, log_s, inverse);
      break;
    case 2:
      cross_stages_kernel<T, 2><<<grid, kCrossThreads, 0, stream>>>(
          slabs, tw, twp, q, fin, finp, total, channels, log_n, log_s, inverse);
      break;
    case 3:
      cross_stages_kernel<T, 3><<<grid, kCrossThreads, 0, stream>>>(
          slabs, tw, twp, q, fin, finp, total, channels, log_n, log_s, inverse);
      break;
    default:
      cross_stages_kernel<T, 4><<<grid, kCrossThreads, 0, stream>>>(
          slabs, tw, twp, q, fin, finp, total, channels, log_n, log_s, inverse);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
