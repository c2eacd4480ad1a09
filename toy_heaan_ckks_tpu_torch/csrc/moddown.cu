// K3: fused RNS mod-down with combine.
//
// Replaces the Pallas TPU kernel toy_heaan_ckks_tpu/ops/moddown_pallas.py
// _md_kernel_t (and, with t == nullptr, _md_kernel_no_t), called through
// mod_down_combine_pallas. One block owns one (kept channel j, item) pair:
//
//   ext  = sum_m Harvey(yhat_m, c[m,j], cs[m,j])            (mod q_j)
//   ext  = forward NTT of ext (shared memory, all stages)
//   head = ks_j + Harvey(t_j, P mod q_j)                     (t optional)
//   out  = Harvey(head - ext, P_total^-1 mod q_j)
//
// Bounds on an H100: one 14-stage shared-memory NTT per block (serial
// __syncthreads chain) plus reading G + 2 planes and writing one.
#include "ntt.cuh"

namespace {

__global__ void __launch_bounds__(ckks::kThreads)
moddown_kernel(const uint32_t* __restrict__ yhat, long long y_stride,
               const uint32_t* __restrict__ ks, long long ks_stride,
               const uint32_t* __restrict__ t, long long t_stride,
               const uint32_t* __restrict__ c, const uint32_t* __restrict__ cs,
               const uint32_t* __restrict__ q, const uint32_t* __restrict__ pm,
               const uint32_t* __restrict__ pms,
               const uint32_t* __restrict__ pinv,
               const uint32_t* __restrict__ pinvs,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ twp, uint32_t* __restrict__ out,
               int dropped, int kept, int log_n) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int j = blockIdx.x % kept;
  const long long item = blockIdx.x / kept;
  const uint32_t qj = q[j];
  const uint32_t* yi = yhat + item * y_stride;
  const long long jn = static_cast<long long>(j) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t acc = 0;
    for (int m = 0; m < dropped; ++m) {
      const int cj = m * kept + j;
      acc = ckks::add_mod(
          acc, ckks::harvey(yi[static_cast<long long>(m) * n + i], c[cj], cs[cj], qj),
          qj);
    }
    s[i] = acc;
  }
  __syncthreads();
  ckks::ntt_forward_smem(s, log_n, tw + jn, twp + jn, qj);

  const uint32_t* ksj = ks + item * ks_stride + jn;
  const uint32_t* tj = t == nullptr ? nullptr : t + item * t_stride + jn;
  uint32_t* o = out + (item * kept + j) * static_cast<long long>(n);
  const uint32_t p = pm[j], ps = pms[j], pi = pinv[j], pis = pinvs[j];
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    uint32_t head = ksj[i];
    if (tj != nullptr) head = ckks::add_mod(head, ckks::harvey(tj[i], p, ps, qj), qj);
    o[i] = ckks::harvey(ckks::sub_mod(head, s[i], qj), pi, pis, qj);
  }
}

}  // namespace

// yhat: (outer, dropped, N) plain values, item stride y_stride; ks/t:
// (outer, kept, N) NTT-domain planes with item strides ks_stride/t_stride
// (t may be nullptr); c/cs: (dropped, kept); q/pm/pms/pinv/pinvs: (kept,);
// tw/twp: (kept, N) forward twiddles; out: contiguous (outer, kept, N).
// Returns cudaGetLastError() of the launch.
extern "C" int ckks_moddown(const uint32_t* yhat, long long y_stride,
                            const uint32_t* ks, long long ks_stride,
                            const uint32_t* t, long long t_stride,
                            const uint32_t* c, const uint32_t* cs,
                            const uint32_t* q, const uint32_t* pm,
                            const uint32_t* pms, const uint32_t* pinv,
                            const uint32_t* pinvs, const uint32_t* tw,
                            const uint32_t* twp, uint32_t* out, int outer,
                            int dropped, int kept, int log_n,
                            cudaStream_t stream) {
  cudaError_t err = ckks::reserve_smem(reinterpret_cast<const void*>(moddown_kernel), log_n);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) << log_n;
  moddown_kernel<<<outer * kept, ckks::kThreads, smem, stream>>>(
      yhat, y_stride, ks, ks_stride, t, t_stride, c, cs, q, pm, pms, pinv,
      pinvs, tw, twp, out, dropped, kept, log_n);
  return static_cast<int>(cudaGetLastError());
}
