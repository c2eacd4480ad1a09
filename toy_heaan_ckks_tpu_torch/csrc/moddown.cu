// K3 / K8: fused RNS mod-down with combine.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/moddown_pallas.py
// _md_kernel_t (and, with t == nullptr, _md_kernel_no_t), called through
// mod_down_combine_pallas, on uint32 words (small chains: ckks_moddown);
// and ops/keyswitch_pallas_wide.py _md_kernel_wide_t (core _md_core_wide;
// with t == nullptr _md_kernel_wide_no_t), called through
// mod_down_combine_pallas_wide, on uint64 words (wide chains, Harvey64 with
// radix 2^64: ckks_moddown64). One block, or one thread-block cluster of
// 16 for a plane above 128 KiB (ntt_cluster.cuh; the factored branch of
// the reference, moddown_pallas.py:140, keyswitch_pallas_wide.py:575),
// owns one (kept channel j, item) pair; each block runs the sums and the
// combine on its own slice of the plane:
//
//   ext  = sum_m Harvey(yhat_m, c[m,j], cs[m,j])            (mod q_j)
//   ext  = forward NTT of ext (shared memory, all stages)
//   head = ks_j + Harvey(t_j, P mod q_j)                     (t optional)
//   out  = Harvey(head - ext, P_total^-1 mod q_j)
//
// yhat_m is a residue of a dropped prime and may exceed q_j: the Harvey
// multiply takes any word x. Bounds on an H100: one log2(N)-stage
// shared-memory NTT per block (serial __syncthreads chain) plus reading
// G + 2 planes and writing one; on uint64 words the integer pipe.
//
// uint32 planes that one block holds (N = 2^10 .. 2^15) run another body,
// moddown_kernel_reg<log2 N>, and uint32 planes of 2^16 a third,
// moddown_kernel_cluster (below); uint64 planes up to 2^12 run
// moddown_kernel above, and those of 2^13 .. 2^16 moddown_kernel_cluster64
// (the cluster plan on uint64 words, below). The one-block design is K2's
// (csrc/keyswitch.cu) with one digit and the combine as its epilogue:
//
// - NTT passes in registers (csrc/ntt_reg.cuh): N / 32 threads of 32
//   words, 5+5+4 stages at 2^14, one shared-memory exchange between
//   passes.
// - The Phat sum in the first pass's load: pass 0's group is m * N/32 + t
//   for thread t, so ext is formed in registers from coalesced loads of
//   the G yhat planes.
// - The combine in the epilogue, on coalesced words: the last pass's runs
//   of 2^r adjacent words go back to pass 0's layout through shared
//   memory (K2's epilogue). Combining on the runs themselves, with 16-byte
//   vector accesses of ks, t and out and one exchange fewer, was slower
//   (below).
// - Block barriers: 3 at 2^11 .. 2^15, 2 at 2^10 (15 in moddown_kernel at
//   2^14, 14 of them its NTT stages').
// - Two blocks of 512 threads an SM at 2^14 (64 registers, no spill;
//   2 x 66 KiB of shared memory): the main path's 224 (K3) and 256 (K3')
//   blocks are all resident at once on 132 SMs.
// - Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py,
//   device time; (32, 7 kept, 5 dropped, 2^14) with t): 0.043 ms against
//   0.125 for moddown_kernel; 0.047 / 0.048 at one block an SM; 0.044 /
//   0.046 with the combine on the runs at two blocks, 0.053 at one.
//   Without t (32, 8 kept, 4 dropped): 0.038 (0.106).
//
// K3 / K3' on uint32 planes of 2^16 (moddown_kernel_cluster) run K4's
// cluster plan (csrc/ntt_cluster.cuh: 16 blocks of 128 threads a plane)
// with the Phat sum formed in the cross pass's loads of the G yhat planes
// (groups of 16 words at stride N/16, coalesced over the threads) and the
// combine on the slice's coalesced words after the last exchange. Measured
// on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py, device time):
// (4, 3 kept, 3 dropped) with t 0.010-0.015 ms against 0.145 for
// moddown_kernel on clusters of 2; without t (4, 4 kept, 2 dropped) 0.016
// (0.133); on clusters of 8 blocks 0.016 / 0.020, of 4 0.025 / 0.022.
//
// K8 / K8' on uint64 planes of 2^15 and 2^16 (moddown_kernel_cluster64<log2
// N>) run the same body on the uint64 plan (ntt_cluster.cuh WidePlan: 16
// blocks of 16 words a thread, 128 threads at 2^15, 256 at 2^16), the Phat
// sum a Harvey64 in the cross pass's loads and the combine Harvey64s on the
// slice's words. moddown_kernel on clusters of 2 / 4 gave the big-wide
// path's 8 (K8) and 12 (K8') planes 16 and 24 blocks of 512 threads, 15
// one-stage barriers each; this gives 128 and 192 blocks. 122 / 128
// registers a thread at 2^15 / 2^16, no spill; 28 / 14 clusters
// resident. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/kernel_ab.py, device time): (4, 2 kept, 2 dropped, 2^15) with t
// 0.0161-0.0162 ms against 0.1027-0.1034 for moddown_kernel on clusters
// of 2; without t (4, 3 kept, 1 dropped) 0.0144 (0.0898-0.0903); at
// (1, 1 kept, 2 dropped, 2^16) 0.018 (0.110). On uint64 planes of 2^13
// and 2^14 the same kernel runs on clusters of kWideNttLogCluster13 / 14
// = 8 / 16 blocks of 64 threads (122 registers, no spill), where
// moddown_kernel ran one barrier a stage on one block of 512 threads a
// plane (24 blocks for the wide path's K8 at (8, 3 kept), 32 for its K8'
// at (8, 4 kept)). Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (tools/kernel_ab.py, device time): (8, 3 kept, 2 dropped, 2^13) with t
// 0.0118 ms against 0.0470-0.0473 for moddown_kernel (0.0116 on clusters
// of 4); without t (8, 4 kept, 1 dropped) 0.0120 (0.0410-0.0422; 0.0124
// on 4); (2, 2 kept, 2 dropped, 2^14) with t 0.0116 (0.0939-0.0944; 0.0119
// on 8).
#include "ntt.cuh"
#include "ntt_cluster.cuh"
#include "ntt_reg.cuh"

namespace {

template <typename T, bool kCluster>
__global__ void __launch_bounds__(ckks::kThreads)
moddown_kernel(const T* __restrict__ yhat, long long y_stride,
               const T* __restrict__ ks, long long ks_stride,
               const T* __restrict__ t, long long t_stride,
               const T* __restrict__ c, const T* __restrict__ cs,
               const T* __restrict__ q, const T* __restrict__ pm,
               const T* __restrict__ pms, const T* __restrict__ pinv,
               const T* __restrict__ pinvs, const T* __restrict__ tw,
               const T* __restrict__ twp, T* __restrict__ out, int dropped,
               int kept, int log_n) {
  T* s = ckks::smem_plane<T>();
  const ckks::PlanePart<kCluster> pp(log_n);
  const int n = 1 << log_n;
  const int m = pp.size();
  const int j = pp.plane % kept;
  const long long item = pp.plane / kept;
  const T qj = q[j];
  const T* yi = yhat + item * y_stride + pp.off;
  const long long jn = static_cast<long long>(j) * n;

  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    T acc = 0;
    for (int k = 0; k < dropped; ++k) {
      const int cj = k * kept + j;
      acc = ckks::add_mod(
          acc, ckks::harvey(yi[static_cast<long long>(k) * n + i], c[cj], cs[cj], qj),
          qj);
    }
    s[i] = acc;
  }
  __syncthreads();
  ckks::ntt_forward(s, pp, log_n, tw + jn, twp + jn, qj);

  const T* ksj = ks + item * ks_stride + jn + pp.off;
  const T* tj = t == nullptr ? nullptr : t + item * t_stride + jn + pp.off;
  T* o = out + (item * kept + j) * static_cast<long long>(n) + pp.off;
  const T p = pm[j], ps = pms[j], pi = pinv[j], pis = pinvs[j];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    T head = ksj[i];
    if (tj != nullptr) head = ckks::add_mod(head, ckks::harvey(tj[i], p, ps, qj), qj);
    o[i] = ckks::harvey(ckks::sub_mod(head, s[i], qj), pi, pis, qj);
  }
}

// One block a plane: moddown_kernel's one-block form (uint32 planes below
// 2^10, uint64 planes up to 2^12; the larger planes run the register-pass
// and cluster forms below).
template <typename T>
int launch_one_block(const T* yhat, long long y_stride, const T* ks, long long ks_stride,
                     const T* t, long long t_stride, const T* c, const T* cs, const T* q,
                     const T* pm, const T* pms, const T* pinv, const T* pinvs, const T* tw,
                     const T* twp, T* out, int outer, int dropped, int kept, int log_n,
                     cudaStream_t stream) {
  const size_t smem = ckks::plane_bytes<T>(log_n);
  const cudaError_t err = ckks::reserve_smem(
      reinterpret_cast<const void*>(moddown_kernel<T, false>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  moddown_kernel<T, false><<<outer * kept, ckks::kThreads, smem, stream>>>(
      yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv, pinvs, tw,
      twp, out, dropped, kept, log_n);
  return static_cast<int>(cudaGetLastError());
}

using ckks::kLogRegWords;
using ckks::kRegWords;
using ckks::RegPlan;

// The combine on pass 0's words of a 2^kLogN-word plane or slice of Wd
// (position m * T + tid, T threads of W words): out = Harvey((ks +
// Harvey(t, P mod q_j)) - ext, P^-1), without the t term unless kWithT.
template <int kLogN, bool kWithT, typename Wd = ckks::Words32,
          typename T = typename Wd::Word>
__device__ __forceinline__ void combine(const T (&a)[Wd::kCount], int tid,
                                        const T* __restrict__ ks,
                                        const T* __restrict__ t,
                                        T* __restrict__ o, T p, T ps, T pi, T pis,
                                        T q) {
  constexpr int kT = RegPlan<kLogN, Wd>::kThreads;
#pragma unroll
  for (int m = 0; m < Wd::kCount; ++m) {
    const int pos = m * kT + tid;
    T head = ckks::ldg(ks + pos);
    if constexpr (kWithT)
      head = ckks::add_mod(head, ckks::harvey(ckks::ldg(t + pos), p, ps, q), q);
    o[pos] = ckks::harvey(ckks::sub_mod(head, a[m], q), pi, pis, q);
  }
}

// K3 / K3' on uint32 planes that one block holds (see the header): one
// block of N / 32 threads per (item, kept channel j).
template <int kLogN>
__global__ void __launch_bounds__(RegPlan<kLogN>::kThreads,
                                  RegPlan<kLogN>::kMinBlocksTwo)
moddown_kernel_reg(const uint32_t* __restrict__ yhat, long long y_stride,
                   const uint32_t* __restrict__ ks, long long ks_stride,
                   const uint32_t* __restrict__ t, long long t_stride,
                   const uint32_t* __restrict__ c, const uint32_t* __restrict__ cs,
                   const uint32_t* __restrict__ q, const uint32_t* __restrict__ pm,
                   const uint32_t* __restrict__ pms, const uint32_t* __restrict__ pinv,
                   const uint32_t* __restrict__ pinvs,
                   const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ twp, uint32_t* __restrict__ out,
                   int dropped, int kept) {
  constexpr long long n = 1LL << kLogN;
  constexpr int kT = RegPlan<kLogN>::kThreads;
  uint32_t* s = ckks::smem_plane<uint32_t>();
  const int tid = threadIdx.x;
  const int j = blockIdx.x % kept;
  const long long item = blockIdx.x / kept;
  const uint32_t qj = q[j];

  // the Phat sum, into pass 0's words
  uint32_t a[kRegWords];
  const uint32_t* yi = yhat + item * y_stride + tid;
  {
    const uint32_t ck = c[j], cks = cs[j];
#pragma unroll
    for (int m = 0; m < kRegWords; ++m)
      a[m] = ckks::harvey(ckks::ldg(yi + m * kT), ck, cks, qj);
  }
  for (int k = 1; k < dropped; ++k) {
    const uint32_t ck = c[k * kept + j], cks = cs[k * kept + j];
    const uint32_t* yk = yi + k * n;
#pragma unroll
    for (int m = 0; m < kRegWords; ++m)
      a[m] = ckks::add_mod(a[m], ckks::harvey(ckks::ldg(yk + m * kT), ck, cks, qj), qj);
  }
  ckks::reg_forward<kLogN>(s, a, tid, tw + j * n, twp + j * n, qj);

  const uint32_t* ksj = ks + item * ks_stride + j * n;
  const uint32_t* tj = t == nullptr ? nullptr : t + item * t_stride + j * n;
  uint32_t* o = out + (item * kept + j) * n;
  const uint32_t p = pm[j], ps = pms[j], pi = pinv[j], pis = pinvs[j];
  // back to pass 0's layout: the combine reads ks and t and writes out
  // on coalesced words
  ckks::RegLast<kLogN>::store(s, a, tid);
  __syncthreads();
  ckks::RegPass<kLogN, 0, kLogRegWords>::load(s, a, tid);
  if (tj != nullptr) {
    combine<kLogN, true>(a, tid, ksj, tj, o, p, ps, pi, pis, qj);
  } else {
    combine<kLogN, false>(a, tid, ksj, static_cast<const uint32_t*>(nullptr), o, p, ps,
                          pi, pis, qj);
  }
}

template <int kLogN>
const void* reg_kernel() {
  return reinterpret_cast<const void*>(moddown_kernel_reg<kLogN>);
}

template <int kLogN>
int launch_reg(const uint32_t* yhat, long long y_stride, const uint32_t* ks,
               long long ks_stride, const uint32_t* t, long long t_stride,
               const uint32_t* c, const uint32_t* cs, const uint32_t* q,
               const uint32_t* pm, const uint32_t* pms, const uint32_t* pinv,
               const uint32_t* pinvs, const uint32_t* tw, const uint32_t* twp,
               uint32_t* out, int outer, int dropped, int kept,
               cudaStream_t stream) {
  using Plan = RegPlan<kLogN>;
  const cudaError_t err = ckks::reserve_smem(reg_kernel<kLogN>(), Plan::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  moddown_kernel_reg<kLogN><<<outer * kept, Plan::kThreads, Plan::kSmemBytes,
                              stream>>>(
      yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv,
      pinvs, tw, twp, out, dropped, kept);
  return static_cast<int>(cudaGetLastError());
}

using ckks::BigPlan;
// K8 / K8''s uint64 plan
template <int kLogN>
using ModDownWidePlan = ckks::WidePlan<kLogN, ckks::kWideModDown>;

// The cluster form of Plan (see the header): one cluster of Plan::kC
// blocks of N/C/W threads per (item, kept channel j).
template <typename Plan, typename T = typename Plan::Word>
__device__ __forceinline__ void moddown_cluster_body(
    const T* __restrict__ yhat, long long y_stride, const T* __restrict__ ks,
    long long ks_stride, const T* __restrict__ t, long long t_stride,
    const T* __restrict__ c, const T* __restrict__ cs, const T* __restrict__ q,
    const T* __restrict__ pm, const T* __restrict__ pms, const T* __restrict__ pinv,
    const T* __restrict__ pinvs, const T* __restrict__ tw, const T* __restrict__ twp,
    T* __restrict__ out, int dropped, int kept) {
  using Cross = ckks::CrossPass<Plan, false>;
  constexpr long long n = 1LL << Plan::kLogN;
  constexpr int kC = Plan::kC, kM = Plan::kM;
  ckks::cluster_arrive_relaxed();  // this block has started
  T* s = ckks::smem_plane<T>();
  const int tid = threadIdx.x;
  const int r = static_cast<int>(blockIdx.x) & (kC - 1);  // rank in the cluster
  const int plane = static_cast<int>(blockIdx.x) >> Plan::kLogC;
  const int j = plane % kept;
  const long long item = plane / kept;
  const T qj = q[j];

  // the Phat sum, into the cross pass's words
  T a[Plan::kW];
  const T* yi = yhat + item * y_stride;
  {
    const T ck = c[j], cks = cs[j];
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
      for (int k = 0; k < kC; ++k)
        a[h * kC + k] = ckks::harvey(ckks::ldg(yi + Cross::first(r, h, tid) + k * kM),
                                     ck, cks, qj);
  }
  for (int m = 1; m < dropped; ++m) {
    const T ck = c[m * kept + j], cks = cs[m * kept + j];
    const T* ym = yi + m * n;
#pragma unroll
    for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
      for (int k = 0; k < kC; ++k) {
        const int u = h * kC + k;
        a[u] = ckks::add_mod(
            a[u], ckks::harvey(ckks::ldg(ym + Cross::first(r, h, tid) + k * kM), ck, cks, qj),
            qj);
      }
  }
  Cross::run(a, tw + j * n, twp + j * n, qj);
  ckks::cluster_forward<Plan>(s, a, r, tid, tw + j * n, twp + j * n, qj);

  // the combine on pass 0's coalesced words of the slice
  using Wd = typename Plan::Words;
  const long long off = j * n + r * kM;
  const T* ksj = ks + item * ks_stride + off;
  T* o = out + (item * kept + j) * n + r * kM;
  const T p = pm[j], ps = pms[j], pi = pinv[j], pis = pinvs[j];
  if (t != nullptr) {
    combine<Plan::kLogM, true, Wd>(a, tid, ksj, t + item * t_stride + off, o, p, ps, pi,
                                   pis, qj);
  } else {
    combine<Plan::kLogM, false, Wd>(a, tid, ksj, static_cast<const T*>(nullptr), o, p, ps,
                                    pi, pis, qj);
  }
}

// K3 / K3' on uint32 planes of 2^16 words (see the header).
__global__ void __launch_bounds__(BigPlan::kThreads, BigPlan::kMinBlocks)
moddown_kernel_cluster(const uint32_t* __restrict__ yhat, long long y_stride,
                       const uint32_t* __restrict__ ks, long long ks_stride,
                       const uint32_t* __restrict__ t, long long t_stride,
                       const uint32_t* __restrict__ c, const uint32_t* __restrict__ cs,
                       const uint32_t* __restrict__ q, const uint32_t* __restrict__ pm,
                       const uint32_t* __restrict__ pms,
                       const uint32_t* __restrict__ pinv,
                       const uint32_t* __restrict__ pinvs,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ twp, uint32_t* __restrict__ out,
                       int dropped, int kept) {
  moddown_cluster_body<BigPlan>(yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm,
                                pms, pinv, pinvs, tw, twp, out, dropped, kept);
}

// K8 / K8' on uint64 planes of 2^kLogN words, 2^13 .. 2^16 (see the
// header).
template <int kLogN>
__global__ void __launch_bounds__(ModDownWidePlan<kLogN>::kThreads,
                                  ckks::kWideThreadsPerSm / ModDownWidePlan<kLogN>::kThreads)
moddown_kernel_cluster64(const uint64_t* __restrict__ yhat, long long y_stride,
                         const uint64_t* __restrict__ ks, long long ks_stride,
                         const uint64_t* __restrict__ t, long long t_stride,
                         const uint64_t* __restrict__ c, const uint64_t* __restrict__ cs,
                         const uint64_t* __restrict__ q, const uint64_t* __restrict__ pm,
                         const uint64_t* __restrict__ pms,
                         const uint64_t* __restrict__ pinv,
                         const uint64_t* __restrict__ pinvs,
                         const uint64_t* __restrict__ tw,
                         const uint64_t* __restrict__ twp, uint64_t* __restrict__ out,
                         int dropped, int kept) {
  moddown_cluster_body<ModDownWidePlan<kLogN>>(yhat, y_stride, ks, ks_stride, t, t_stride, c,
                                               cs, q, pm, pms, pinv, pinvs, tw, twp, out,
                                               dropped, kept);
}

template <int kLogN>
int launch_cluster64(const uint64_t* yhat, long long y_stride, const uint64_t* ks,
                     long long ks_stride, const uint64_t* t, long long t_stride,
                     const uint64_t* c, const uint64_t* cs, const uint64_t* q,
                     const uint64_t* pm, const uint64_t* pms, const uint64_t* pinv,
                     const uint64_t* pinvs, const uint64_t* tw, const uint64_t* twp,
                     uint64_t* out, int outer, int dropped, int kept,
                     cudaStream_t stream) {
  using Plan = ModDownWidePlan<kLogN>;
  return ckks::launch_cluster<Plan, &moddown_kernel_cluster64<kLogN>>(
      outer * kept, Plan::kForwardBytes, stream, yhat, y_stride, ks, ks_stride, t,
      t_stride, c, cs, q, pm, pms, pinv, pinvs, tw, twp, out, dropped, kept);
}

}  // namespace

// yhat: (outer, dropped, N) plain values, item stride y_stride; ks/t:
// (outer, kept, N) NTT-domain planes with item strides ks_stride/t_stride
// (t may be nullptr); c/cs: (dropped, kept); q/pm/pms/pinv/pinvs: (kept,);
// tw/twp: (kept, N) forward twiddles; out: contiguous (outer, kept, N);
// parts: 1 (one block a plane) or, at N = 2^16 only, above 1 (a cluster:
// moddown_kernel_cluster on ckks::BigPlan::kC blocks; the form is
// ckks::plane_blocks's). Returns the launch's error code (0 on success).
extern "C" int ckks_moddown(const uint32_t* yhat, long long y_stride,
                            const uint32_t* ks, long long ks_stride,
                            const uint32_t* t, long long t_stride,
                            const uint32_t* c, const uint32_t* cs,
                            const uint32_t* q, const uint32_t* pm,
                            const uint32_t* pms, const uint32_t* pinv,
                            const uint32_t* pinvs, const uint32_t* tw,
                            const uint32_t* twp, uint32_t* out, int outer,
                            int dropped, int kept, int log_n, int parts,
                            cudaStream_t stream) {
  const int blocks = ckks::plane_blocks(ckks::kWideModDown, false, log_n, parts);
  if (blocks > 1) {
    return ckks::launch_cluster<BigPlan, &moddown_kernel_cluster>(
        outer * kept, BigPlan::kForwardBytes, stream, yhat, y_stride, ks, ks_stride,
        t, t_stride, c, cs, q, pm, pms, pinv, pinvs, tw, twp, out, dropped, kept);
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ckks::reg_shape(log_n)) {
    return ckks::reg_dispatch(log_n, [&](auto log_n_c) {
      return launch_reg<decltype(log_n_c)::value>(
          yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv,
          pinvs, tw, twp, out, outer, dropped, kept, stream);
    });
  }
  return launch_one_block(yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm,
                          pms, pinv, pinvs, tw, twp, out, outer, dropped, kept, log_n,
                          stream);
}

const void* ckks::moddown_reg_kernel(int log_n) {
  if (!reg_shape(log_n)) return nullptr;
  return reg_dispatch(log_n, [](auto log_n_c) {
    return reg_kernel<decltype(log_n_c)::value>();
  });
}

const void* ckks::moddown_cluster_kernel() {
  return reinterpret_cast<const void*>(moddown_kernel_cluster);
}

const void* ckks::moddown_cluster64_kernel(int log_n) {
  if (!wide_cluster_shape(log_n)) return nullptr;
  return wide_dispatch(log_n, [](auto log_n_c) {
    return reinterpret_cast<const void*>(moddown_kernel_cluster64<decltype(log_n_c)::value>);
  });
}

// The same on uint64 words (wide chains, radix-2^64 Shoup companions): at
// N = 2^13 .. 2^16 a cluster (moddown_kernel_cluster64 on the C blocks of
// K8's ckks::WidePlan) whatever parts says; below, parts 1
// (moddown_kernel's one-block form).
extern "C" int ckks_moddown64(const uint64_t* yhat, long long y_stride,
                              const uint64_t* ks, long long ks_stride,
                              const uint64_t* t, long long t_stride,
                              const uint64_t* c, const uint64_t* cs,
                              const uint64_t* q, const uint64_t* pm,
                              const uint64_t* pms, const uint64_t* pinv,
                              const uint64_t* pinvs, const uint64_t* tw,
                              const uint64_t* twp, uint64_t* out, int outer,
                              int dropped, int kept, int log_n, int parts,
                              cudaStream_t stream) {
  const int blocks = ckks::plane_blocks(ckks::kWideModDown, true, log_n, parts);
  if (blocks > 1) {
    return ckks::wide_dispatch(log_n, [&](auto log_n_c) {
      return launch_cluster64<decltype(log_n_c)::value>(
          yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv, pinvs, tw,
          twp, out, outer, dropped, kept, stream);
    });
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_one_block(yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms,
                          pinv, pinvs, tw, twp, out, outer, dropped, kept, log_n, stream);
}
