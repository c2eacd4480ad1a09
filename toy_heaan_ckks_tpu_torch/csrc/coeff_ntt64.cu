// K10 / K11 on uint64 words (wide chains): the C entries of
// csrc/coeff_ntt.cuh's kernels, built apart from the uint32 ones
// (csrc/coeff_ntt.cu) so that the two compile in parallel.
#include "coeff_ntt.cuh"

// ckks_coeff_tail's arguments on uint64 words.
extern "C" int ckks_coeff_tail64(const void* const* in, void* const* out,
                                 const int* ids, int count, int shards,
                                 const uint64_t* tw, const uint64_t* twp,
                                 const uint64_t* q, const uint64_t* fin,
                                 const uint64_t* finp, int planes,
                                 int channels, int log_n, int log_s, int cluster,
                                 int inverse, cudaStream_t stream) {
  return launch_tail(in, out, ids, count, shards, tw, twp, q, fin, finp,
                     planes, channels, log_n, log_s, cluster, inverse, stream);
}

// ckks_coeff_cross's arguments on uint64 words.
extern "C" int ckks_coeff_cross64(const void* const* in, void* const* out,
                                  const int* ids, int count, int shards,
                                  const uint64_t* tw, const uint64_t* twp,
                                  const uint64_t* q, const uint64_t* fin,
                                  const uint64_t* finp, int planes,
                                  int channels, int log_n, int log_s,
                                  int stage, int inverse,
                                  cudaStream_t stream) {
  return launch_cross(in, out, ids, count, shards, tw, twp, q, fin, finp,
                      planes, channels, log_n, log_s, stage, inverse, stream);
}

// ckks_coeff_cross_stages's arguments on uint64 words.
extern "C" int ckks_coeff_cross_stages64(const void* const* in, void* const* out, int shards,
                                         const uint64_t* tw, const uint64_t* twp,
                                         const uint64_t* q, const uint64_t* fin,
                                         const uint64_t* finp, int planes, int channels,
                                         int log_n, int log_s, int inverse,
                                         cudaStream_t stream) {
  return launch_cross_stages(in, out, shards, tw, twp, q, fin, finp, planes, channels, log_n,
                             log_s, inverse, stream);
}

int ckks::coeff_tail64_info(int log_s, int cluster, int inverse, int* info) {
  return tail_info<uint64_t>(log_s, cluster, inverse, info);
}
