// K1: the fused negacyclic NTT of whole planes, forward or inverse.
//
// Replaces the Pallas TPU kernel toy_heaan_ckks_tpu/ops/ntt_pallas.py
// _ntt_kernel (called through _ntt_planes_call). One block owns one
// (item, channel) plane of N <= 2^15 uint32 residues: it loads the plane
// into shared memory once, runs all log2(N) butterfly stages there, applies
// the per-channel final constant (inverse only: N^-1, or the folded
// constants of small_fast._fold_consts / moddown_pallas._down_consts) and
// writes the plane once. Device memory traffic is one read and one write of
// the plane; what bounds it on an H100 is the serial chain of 14
// shared-memory stages, each closed by __syncthreads, and the twiddle loads
// (compact per-stage tables read through the read-only cache).
#include "ntt.cuh"

namespace {

__global__ void __launch_bounds__(ckks::kThreads)
ntt_kernel(const uint32_t* __restrict__ x, long long x_stride,
           uint32_t* __restrict__ out, const uint32_t* __restrict__ tw,
           const uint32_t* __restrict__ twp, const uint32_t* __restrict__ q,
           const uint32_t* __restrict__ fin, const uint32_t* __restrict__ finp,
           int channels, int log_n, int inverse) {
  extern __shared__ uint32_t s[];
  const int n = 1 << log_n;
  const int ch = blockIdx.x % channels;
  const long long item = blockIdx.x / channels;
  const uint32_t qc = q[ch];
  const uint32_t* src = x + item * x_stride + static_cast<long long>(ch) * n;
  uint32_t* dst = out + (item * channels + ch) * static_cast<long long>(n);
  const uint32_t* w = tw + static_cast<long long>(ch) * n;
  const uint32_t* wp = twp + static_cast<long long>(ch) * n;

  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = src[i];
  __syncthreads();
  if (inverse) {
    ckks::ntt_inverse_smem(s, log_n, w, wp, qc);
  } else {
    ckks::ntt_forward_smem(s, log_n, w, wp, qc);
  }
  if (fin != nullptr) {
    const uint32_t f = fin[ch], fp = finp[ch];
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = ckks::harvey(s[i], f, fp, qc);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
  }
}

}  // namespace

// x: (outer, channels, N) with item stride x_stride (elements); out:
// contiguous (outer, channels, N); tw/twp: (channels, N) compact twiddles of
// the direction; q/fin/finp: (channels,); fin == nullptr skips the final
// multiply. Returns cudaGetLastError() of the launch.
extern "C" int ckks_ntt(const uint32_t* x, long long x_stride, uint32_t* out,
                        const uint32_t* tw, const uint32_t* twp,
                        const uint32_t* q, const uint32_t* fin,
                        const uint32_t* finp, int outer, int channels,
                        int log_n, int inverse, cudaStream_t stream) {
  cudaError_t err = ckks::reserve_smem(reinterpret_cast<const void*>(ntt_kernel), log_n);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(uint32_t) << log_n;
  ntt_kernel<<<outer * channels, ckks::kThreads, smem, stream>>>(
      x, x_stride, out, tw, twp, q, fin, finp, channels, log_n, inverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ckks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
