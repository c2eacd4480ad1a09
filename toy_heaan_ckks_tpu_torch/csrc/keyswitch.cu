// K2 / K6: fused hybrid gadget key-switch accumulation.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/keyswitch_pallas.py
// _ks_kernel (special channels) and _ks_kernel_base (base channels with the
// skip-own-tower shortcut), called through gadget_accumulate_pallas, on
// uint32 words (small chains: ckks_keyswitch); and their wide twins
// ops/keyswitch_pallas_wide.py _ks_kernel_wide / _ks_kernel_wide_base,
// called through gadget_accumulate_pallas_wide, on uint64 words (wide
// chains, Harvey64 and REDC64 with radix 2^64: ckks_keyswitch64). One block,
// or one cluster of 2 or 4 blocks for a plane above 128 KiB (ntt.cuh
// PlanePart; the reference's factored branches keyswitch_pallas.py:117,
// :170 and keyswitch_pallas_wide.py:149, :194), owns one (extended channel
// j, item) pair and loops over the digits itself (the TPU carried nothing
// across grid steps either, but its grid ran in order; here blocks run in
// any order and share nothing outside their cluster); each block runs the
// raise, the key products and the accumulation on its own slice:
//
//   for each digit t:
//     alpha = sum_{k in t} Harvey(y_k, c[k,j], cs[k,j])      (mod q_j)
//     alpha = forward NTT of alpha (shared memory, all stages)
//     ks0 += REDC(alpha, key_b[t,j]);  ks1 += REDC(alpha, key_a[t,j])
//
// For a base channel j (< L) with d given, its own digit t = j / digit_size
// skips the raise and the NTT: the raised digit is d itself mod q_j, so the
// key products use the NTT-resident input d directly. The accumulators live
// in the output arrays: each thread only ever touches its own elements.
// Bounds on an H100: one or more log2(N)-stage shared-memory NTTs per block
// (serial __syncthreads chain) plus reading L input planes and 2 key planes
// per digit from device memory; on uint64 words the integer pipe (a Harvey64
// or REDC64 is several 32-bit multiplies).
#include "ntt.cuh"

namespace {

template <typename T, bool kCluster>
__global__ void __launch_bounds__(ckks::kThreads)
keyswitch_kernel(const T* __restrict__ y, long long y_stride,
                 const T* __restrict__ d, long long d_stride,
                 const T* __restrict__ key_a, const T* __restrict__ key_b,
                 const T* __restrict__ c, const T* __restrict__ cs,
                 const T* __restrict__ q, const T* __restrict__ qinv,
                 const T* __restrict__ tw, const T* __restrict__ twp,
                 T* __restrict__ out0, T* __restrict__ out1, int base, int ext,
                 int digits, int digit_size, int log_n) {
  T* s = ckks::smem_plane<T>();
  const ckks::PlanePart<kCluster> pp(log_n);
  const int n = 1 << log_n;
  const int m = pp.size();
  const int j = pp.plane % ext;
  const long long item = pp.plane / ext;
  const T qj = q[j], qi = qinv[j];
  const T* yi = y + item * y_stride + pp.off;
  const T* w = tw + static_cast<long long>(j) * n;
  const T* wp = twp + static_cast<long long>(j) * n;
  const long long o_off = (item * ext + j) * static_cast<long long>(n) + pp.off;
  T* o0 = out0 + o_off;
  T* o1 = out1 + o_off;
  // key planes (digits, ext, N): digit t of channel j at (t * ext + j) * n
  const long long key_t = static_cast<long long>(ext) * n;
  const T* ka = key_a + static_cast<long long>(j) * n + pp.off;
  const T* kb = key_b + static_cast<long long>(j) * n + pp.off;

  int own = -1;
  if (d != nullptr && j < base) {
    own = j / digit_size;
    const T* dj = d + item * d_stride + static_cast<long long>(j) * n + pp.off;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const T x = dj[i];
      o0[i] = ckks::mont_redc(x, kb[own * key_t + i], qj, qi);
      o1[i] = ckks::mont_redc(x, ka[own * key_t + i], qj, qi);
    }
  }
  bool first = own < 0;
  for (int t = 0; t < digits; ++t) {
    if (t == own) continue;
    const int k0 = t * digit_size;
    const int k1 = min(k0 + digit_size, base);
    // no peer reads this slice now: the previous digit's ntt_forward ended
    // with a cluster barrier after its last cross-block stage
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      T acc = 0;
      for (int k = k0; k < k1; ++k) {
        const int cj = k * ext + j;
        acc = ckks::add_mod(
            acc, ckks::harvey(yi[static_cast<long long>(k) * n + i], c[cj], cs[cj], qj),
            qj);
      }
      s[i] = acc;
    }
    __syncthreads();
    ckks::ntt_forward(s, pp, log_n, w, wp, qj);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const T x = s[i];
      const T v0 = ckks::mont_redc(x, kb[t * key_t + i], qj, qi);
      const T v1 = ckks::mont_redc(x, ka[t * key_t + i], qj, qi);
      o0[i] = first ? v0 : ckks::add_mod(o0[i], v0, qj);
      o1[i] = first ? v1 : ckks::add_mod(o1[i], v1, qj);
    }
    first = false;
    __syncthreads();
  }
}

template <typename T>
int launch_keyswitch(const T* y, long long y_stride, const T* d,
                     long long d_stride, const T* key_a, const T* key_b,
                     const T* c, const T* cs, const T* q, const T* qinv,
                     const T* tw, const T* twp, T* out0, T* out1, int outer,
                     int base, int ext, int digits, int digit_size, int log_n,
                     int parts, cudaStream_t stream) {
  return ckks::launch_planes<T>(
      keyswitch_kernel<T, false>, keyswitch_kernel<T, true>, outer * ext,
      log_n, parts, stream, y, y_stride, d, d_stride, key_a, key_b, c, cs, q,
      qinv, tw, twp, out0, out1, base, ext, digits, digit_size, log_n);
}

}  // namespace

// y: (outer, base, N) plain digit values, item stride y_stride; d: NTT-domain
// input (outer, base, N) with stride d_stride, or nullptr (no skip-own);
// key_a/key_b: (digits, ext, N); c/cs: (digits * digit_size, ext);
// q/qinv: (ext,); tw/twp: (ext, N) forward twiddles; out0/out1: contiguous
// (outer, ext, N); parts: blocks per plane (1, or a cluster of 2 or 4).
// Returns the launch's error code (0 on success).
extern "C" int ckks_keyswitch(const uint32_t* y, long long y_stride,
                              const uint32_t* d, long long d_stride,
                              const uint32_t* key_a, const uint32_t* key_b,
                              const uint32_t* c, const uint32_t* cs,
                              const uint32_t* q, const uint32_t* qinv,
                              const uint32_t* tw, const uint32_t* twp,
                              uint32_t* out0, uint32_t* out1, int outer,
                              int base, int ext, int digits, int digit_size,
                              int log_n, int parts, cudaStream_t stream) {
  return launch_keyswitch(y, y_stride, d, d_stride, key_a, key_b, c, cs, q,
                          qinv, tw, twp, out0, out1, outer, base, ext, digits,
                          digit_size, log_n, parts, stream);
}

// The same on uint64 words (wide chains; qinv = -q^-1 mod 2^64).
extern "C" int ckks_keyswitch64(const uint64_t* y, long long y_stride,
                                const uint64_t* d, long long d_stride,
                                const uint64_t* key_a, const uint64_t* key_b,
                                const uint64_t* c, const uint64_t* cs,
                                const uint64_t* q, const uint64_t* qinv,
                                const uint64_t* tw, const uint64_t* twp,
                                uint64_t* out0, uint64_t* out1, int outer,
                                int base, int ext, int digits, int digit_size,
                                int log_n, int parts, cudaStream_t stream) {
  return launch_keyswitch(y, y_stride, d, d_stride, key_a, key_b, c, cs, q,
                          qinv, tw, twp, out0, out1, outer, base, ext, digits,
                          digit_size, log_n, parts, stream);
}
