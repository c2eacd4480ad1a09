// K3 / K8: fused RNS mod-down with combine.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/moddown_pallas.py
// _md_kernel_t (and, with t == nullptr, _md_kernel_no_t), called through
// mod_down_combine_pallas, on uint32 words (small chains: ckks_moddown);
// and ops/keyswitch_pallas_wide.py _md_kernel_wide_t (core _md_core_wide;
// with t == nullptr _md_kernel_wide_no_t), called through
// mod_down_combine_pallas_wide, on uint64 words (wide chains, Harvey64 with
// radix 2^64: ckks_moddown64). One block, or one cluster of 2 or 4 blocks
// for a plane above 128 KiB (ntt.cuh PlanePart; the factored branch of the
// reference, moddown_pallas.py:140, keyswitch_pallas_wide.py:575), owns one
// (kept channel j, item) pair; each block runs the sums and the combine on
// its own slice of the plane:
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
// moddown_kernel_reg<log2 N>; the uint64 form and the cluster form
// (N = 2^16) run moddown_kernel above. Its design is K2's
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
#include "ntt.cuh"
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

template <typename T>
int launch_moddown(const T* yhat, long long y_stride, const T* ks,
                   long long ks_stride, const T* t, long long t_stride,
                   const T* c, const T* cs, const T* q, const T* pm,
                   const T* pms, const T* pinv, const T* pinvs, const T* tw,
                   const T* twp, T* out, int outer, int dropped, int kept,
                   int log_n, int parts, cudaStream_t stream) {
  return ckks::launch_planes<T>(
      moddown_kernel<T, false>, moddown_kernel<T, true>, outer * kept, log_n,
      parts, stream, yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm,
      pms, pinv, pinvs, tw, twp, out, dropped, kept, log_n);
}

using ckks::kLogRegWords;
using ckks::kRegWords;
using ckks::RegPlan;

// The combine on pass 0's words (position m * N/32 + tid): out =
// Harvey((ks + Harvey(t, P mod q_j)) - ext, P^-1), without the t term
// unless kWithT.
template <int kLogN, bool kWithT>
__device__ __forceinline__ void combine(const uint32_t (&a)[kRegWords], int tid,
                                        const uint32_t* __restrict__ ks,
                                        const uint32_t* __restrict__ t,
                                        uint32_t* __restrict__ o, uint32_t p,
                                        uint32_t ps, uint32_t pi, uint32_t pis,
                                        uint32_t q) {
  constexpr int kT = RegPlan<kLogN>::kThreads;
#pragma unroll
  for (int m = 0; m < kRegWords; ++m) {
    const int pos = m * kT + tid;
    uint32_t head = ckks::ldg(ks + pos);
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
    combine<kLogN, false>(a, tid, ksj, nullptr, o, p, ps, pi, pis, qj);
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

}  // namespace

// yhat: (outer, dropped, N) plain values, item stride y_stride; ks/t:
// (outer, kept, N) NTT-domain planes with item strides ks_stride/t_stride
// (t may be nullptr); c/cs: (dropped, kept); q/pm/pms/pinv/pinvs: (kept,);
// tw/twp: (kept, N) forward twiddles; out: contiguous (outer, kept, N);
// parts: blocks per plane (1, or a cluster of 2 or 4). Returns the launch's
// error code (0 on success).
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
  if (parts == 1 && ckks::reg_shape(log_n)) {
    return ckks::reg_dispatch(log_n, [&](auto log_n_c) {
      return launch_reg<decltype(log_n_c)::value>(
          yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv,
          pinvs, tw, twp, out, outer, dropped, kept, stream);
    });
  }
  return launch_moddown(yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q,
                        pm, pms, pinv, pinvs, tw, twp, out, outer, dropped,
                        kept, log_n, parts, stream);
}

const void* ckks::moddown_reg_kernel(int log_n) {
  if (!reg_shape(log_n)) return nullptr;
  return reg_dispatch(log_n, [](auto log_n_c) {
    return reg_kernel<decltype(log_n_c)::value>();
  });
}

// The same on uint64 words (wide chains, radix-2^64 Shoup companions).
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
  return launch_moddown(yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q,
                        pm, pms, pinv, pinvs, tw, twp, out, outer, dropped,
                        kept, log_n, parts, stream);
}
