// K10 / K11 on uint32 words (small chains): the C entries of
// csrc/coeff_ntt.cuh's kernels, and the peer access a K11 partner slab on
// another card needs. The uint64 entries are csrc/coeff_ntt64.cu.
#include "coeff_ntt.cuh"

// in/out: host arrays of the `shards` slab pointers, each slab (planes, S)
// contiguous with S = 2^log_s; ids: the `count` shards this launch writes
// (every one on the current device); tw/twp: (channels, N) compact twiddles
// of the direction; q/fin/finp: (channels,); fin == nullptr skips the final
// multiply; cluster: K10's register form from 2^10 words on (coeff_ntt.cuh:
// 0 one block a slab, 1 the slab's cluster; 0 below 2^10, the template;
// the register forms' inverse reads each slab as 16-byte vectors, so every
// slab 16-byte aligned). Returns the launch's error code (0 on success).
extern "C" int ckks_coeff_tail(const void* const* in, void* const* out,
                               const int* ids, int count, int shards,
                               const uint32_t* tw, const uint32_t* twp,
                               const uint32_t* q, const uint32_t* fin,
                               const uint32_t* finp, int planes, int channels,
                               int log_n, int log_s, int cluster, int inverse,
                               cudaStream_t stream) {
  return launch_tail(in, out, ids, count, shards, tw, twp, q, fin, finp,
                     planes, channels, log_n, log_s, cluster, inverse, stream);
}

// The same arguments (without cluster) and the stage st (distance N >> (st +
// 1) >= S).
extern "C" int ckks_coeff_cross(const void* const* in, void* const* out,
                                const int* ids, int count, int shards,
                                const uint32_t* tw, const uint32_t* twp,
                                const uint32_t* q, const uint32_t* fin,
                                const uint32_t* finp, int planes,
                                int channels, int log_n, int log_s, int stage,
                                int inverse, cudaStream_t stream) {
  return launch_cross(in, out, ids, count, shards, tw, twp, q, fin, finp,
                      planes, channels, log_n, log_s, stage, inverse, stream);
}

// K11's one-launch form: every cross stage of the transform on `shards`
// slabs (2 .. 16), all on the current device (in/out: host arrays of the
// slab pointers; the other arguments as ckks_coeff_tail's). fin applies
// after the last stage.
extern "C" int ckks_coeff_cross_stages(const void* const* in, void* const* out, int shards,
                                       const uint32_t* tw, const uint32_t* twp,
                                       const uint32_t* q, const uint32_t* fin,
                                       const uint32_t* finp, int planes, int channels,
                                       int log_n, int log_s, int inverse,
                                       cudaStream_t stream) {
  return launch_cross_stages(in, out, shards, tw, twp, q, fin, finp, planes, channels, log_n,
                             log_s, inverse, stream);
}

// K10's register form (log_s >= 10, the cluster flag) on uint32 (wide 0)
// or uint64 (wide 1) words as built and as it fits the current device
// (coeff_ntt.cuh tail_info: registers, spill bytes, threads, shared bytes,
// blocks a slab, resident slabs). Returns cudaErrorInvalidValue for a form
// that is not built.
extern "C" int ckks_coeff_tail_info(int wide, int log_s, int cluster, int inverse,
                                    int* info) {
  return wide ? ckks::coeff_tail64_info(log_s, cluster, inverse, info)
              : tail_info<uint32_t>(log_s, cluster, inverse, info);
}

// Lets `device` read `peer`'s memory (a K11 partner slab on another card);
// already enabled counts as success.
extern "C" int ckks_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err == cudaSuccess) {
    err = cudaDeviceEnablePeerAccess(peer, 0);
    if (err == cudaErrorPeerAccessAlreadyEnabled) {
      cudaGetLastError();
      err = cudaSuccess;
    }
  }
  const cudaError_t reset = cudaSetDevice(prev);
  return err != cudaSuccess ? err : reset;
}
