// K10 / K11: the coefficient-sharded negacyclic NTT, on uint32 words (small
// chains) and uint64 words (wide chains).
//
// Replaces the Pallas TPU kernels of toy_heaan_ckks_tpu/parallel/coeff_ntt.py:
// _tail_kernel (K10, the local stages of one shard's slab) and
// _cross_stage_remote_kernel (K11, one stage whose butterflies pair two
// shards, after a remote DMA of the partner's slab). The reference's wide
// builder has no kernel (its stage body is jnp); the uint64 entries here are
// the same templates.
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
// What bounds them on an H100: K10 is ntt.cu's kernel on a slab (the serial
// chain of log2 S shared-memory stages, one block per (shard, plane)); K11
// reads two words and writes one per output word, so device memory.
#include "ntt.cuh"

namespace {

constexpr int kMaxShards = 64;
constexpr int kCrossThreads = 256;

template <typename T>
struct Slabs {
  const T* in[kMaxShards];  // every shard's input slab
  T* out[kMaxShards];       // every shard's output slab
  int ids[kMaxShards];      // the shards this launch writes
};

// K10: one block per (shard ids[blockIdx.x / planes], plane). Forward stages
// log2 P .. log2 N - 1 or inverse stages log2 N - 1 .. log2 P on the slab
// in shared memory, then the optional per-channel final factor.
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

template <typename T>
int launch_tail(const void* const* in, void* const* out, const int* ids,
                int count, int shards, const T* tw, const T* twp, const T* q,
                const T* fin, const T* finp, int planes, int channels,
                int log_n, int log_s, int inverse, cudaStream_t stream) {
  Slabs<T> slabs;
  int err = fill(&slabs, in, out, ids, count, shards);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(count) * planes;
  const size_t smem = ckks::plane_bytes<T>(log_s);
  if (log_s < 1 || log_s > log_n || smem > (128u << 10) || blocks < 1 ||
      blocks > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  err = ckks::reserve_smem(reinterpret_cast<const void*>(tail_kernel<T>), smem);
  if (err != cudaSuccess) return err;
  tail_kernel<T><<<static_cast<unsigned>(blocks), ckks::kThreads, smem, stream>>>(
      slabs, tw, twp, q, fin, finp, planes, channels, log_n, log_s, inverse);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// in/out: host arrays of the `shards` slab pointers, each slab (planes, S)
// contiguous with S = 2^log_s; ids: the `count` shards this launch writes
// (every one on the current device); tw/twp: (channels, N) compact twiddles
// of the direction; q/fin/finp: (channels,); fin == nullptr skips the final
// multiply. Returns the launch's error code (0 on success).
extern "C" int ckks_coeff_tail(const void* const* in, void* const* out,
                               const int* ids, int count, int shards,
                               const uint32_t* tw, const uint32_t* twp,
                               const uint32_t* q, const uint32_t* fin,
                               const uint32_t* finp, int planes, int channels,
                               int log_n, int log_s, int inverse,
                               cudaStream_t stream) {
  return launch_tail(in, out, ids, count, shards, tw, twp, q, fin, finp,
                     planes, channels, log_n, log_s, inverse, stream);
}

extern "C" int ckks_coeff_tail64(const void* const* in, void* const* out,
                                 const int* ids, int count, int shards,
                                 const uint64_t* tw, const uint64_t* twp,
                                 const uint64_t* q, const uint64_t* fin,
                                 const uint64_t* finp, int planes,
                                 int channels, int log_n, int log_s,
                                 int inverse, cudaStream_t stream) {
  return launch_tail(in, out, ids, count, shards, tw, twp, q, fin, finp,
                     planes, channels, log_n, log_s, inverse, stream);
}

// The same arguments and the stage st (distance N >> (st + 1) >= S).
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
