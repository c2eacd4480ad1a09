// K1 / K4 / K5+K7 / K5': the fused negacyclic NTT of whole planes, forward
// or inverse.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/ntt_pallas.py
// _ntt_kernel (K1) and _ntt_kernel_fac (K4, N = 2^16) for small chains
// (uint32 words: ckks_ntt), and, for wide chains (uint64 words:
// ckks_ntt64), ops/ntt_pallas_wide.py _ntt_kernel_wide (K5) and
// _ntt_kernel_fac_wide (K5', N >= 2^15) and ops/keyswitch_pallas_wide.py
// _inv_yhat_kernel_wide (K7, the inverse with a folded final constant).
// One block, or one cluster of 2 or 4 blocks for a plane above 128 KiB
// (ntt.cuh PlanePart), owns one (item, channel) plane of N residues: it
// loads the plane once, runs all log2(N) butterfly stages in shared
// memory, applies the per-channel final constant (inverse only: N^-1, or
// the folded constants of the mod-down yhat emission / the decomposition
// fold) and writes the plane once. Device memory traffic is one read and
// one write of the plane plus the compact twiddle tables. What bounds it on
// an H100: the serial chain of log2(N) shared-memory stages, each closed by
// __syncthreads (a cluster barrier for the cross-block stages); for uint64
// words also the integer pipe, since each butterfly's Harvey multiply is
// several 32-bit multiply instructions.
#include "ntt.cuh"

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

template <typename T>
int launch_ntt(const T* x, long long x_stride, T* out, const T* tw,
               const T* twp, const T* q, const T* fin, const T* finp,
               int outer, int channels, int log_n, int parts, int inverse,
               cudaStream_t stream) {
  return ckks::launch_planes<T>(ntt_kernel<T, false>, ntt_kernel<T, true>,
                                outer * channels, log_n, parts, stream, x,
                                x_stride, out, tw, twp, q, fin, finp,
                                channels, log_n, inverse);
}

}  // namespace

// x: (outer, channels, N) with item stride x_stride (elements); out:
// contiguous (outer, channels, N); tw/twp: (channels, N) compact twiddles of
// the direction; q/fin/finp: (channels,); fin == nullptr skips the final
// multiply; parts: blocks per plane (1, or a cluster of 2 or 4). Returns
// the launch's error code (0 on success).
extern "C" int ckks_ntt(const uint32_t* x, long long x_stride, uint32_t* out,
                        const uint32_t* tw, const uint32_t* twp,
                        const uint32_t* q, const uint32_t* fin,
                        const uint32_t* finp, int outer, int channels,
                        int log_n, int parts, int inverse,
                        cudaStream_t stream) {
  return launch_ntt(x, x_stride, out, tw, twp, q, fin, finp, outer, channels,
                    log_n, parts, inverse, stream);
}

// The same on uint64 words (wide chains, radix-2^64 Shoup companions).
extern "C" int ckks_ntt64(const uint64_t* x, long long x_stride,
                          uint64_t* out, const uint64_t* tw,
                          const uint64_t* twp, const uint64_t* q,
                          const uint64_t* fin, const uint64_t* finp,
                          int outer, int channels, int log_n, int parts,
                          int inverse, cudaStream_t stream) {
  return launch_ntt(x, x_stride, out, tw, twp, q, fin, finp, outer, channels,
                    log_n, parts, inverse, stream);
}

extern "C" const char* ckks_error_string(int code) {
  if (code == ckks::kErrClusterDoesNotFit)
    return "no thread-block cluster of this size and shared memory fits the "
           "device";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
