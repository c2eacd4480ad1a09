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
#include "ntt.cuh"

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
  return launch_moddown(yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q,
                        pm, pms, pinv, pinvs, tw, twp, out, outer, dropped,
                        kept, log_n, parts, stream);
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
