// K2 / K6: fused hybrid gadget key-switch accumulation.
//
// Replaces the Pallas TPU kernels toy_heaan_ckks_tpu/ops/keyswitch_pallas.py
// _ks_kernel (special channels) and _ks_kernel_base (base channels with the
// skip-own-tower shortcut), called through gadget_accumulate_pallas, on
// uint32 words (small chains: ckks_keyswitch); and their wide twins
// ops/keyswitch_pallas_wide.py _ks_kernel_wide / _ks_kernel_wide_base,
// called through gadget_accumulate_pallas_wide, on uint64 words (wide
// chains, Harvey64 and REDC64 with radix 2^64: ckks_keyswitch64). One block,
// or one thread-block cluster of 16 for a plane above 128 KiB
// (ntt_cluster.cuh; the reference's factored branches
// keyswitch_pallas.py:117, :170 and keyswitch_pallas_wide.py:149, :194),
// owns one (extended channel j, item) pair and loops over the digits
// itself (the TPU carried nothing
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
//
// uint32 planes that one block holds (N = 2^10 .. 2^15) run another body,
// keyswitch_kernel_reg<log2 N>, and uint32 planes of 2^16 a third,
// keyswitch_kernel_cluster (below); uint64 planes of 2^13 .. 2^16 run
// keyswitch_kernel_cluster64<log2 N> (below) and uint64 planes up to 2^12
// keyswitch_kernel above. The one-block design:
//
// - NTT passes in registers (csrc/ntt_reg.cuh, shared with K1 and K3):
//   N / 32 threads of 32 words, 5+5+4 stages at 2^14 with one
//   shared-memory exchange between passes.
// - The raise in the first pass's load. Pass 0's group is m * N/32 + t for
//   thread t, so alpha = sum_k Harvey(y_k, c[k,j]) is formed in registers
//   from coalesced loads of the y_k planes.
// - The key products in the epilogue. The last pass's groups are runs of
//   2^r adjacent words, so they go back through shared memory to pass 0's
//   layout, and the key products, the own-digit term (d given) and the
//   digit sum run on coalesced words; each thread reads and writes only
//   its own positions of out0/out1. A channel with one NTT digit (every
//   base channel of the main path with d) writes each output word once; a
//   later digit adds to the words the thread wrote for the earlier one.
// - Block barriers per digit: one per shared-memory exchange, 2 at 2^10
//   and 3 at 2^11 .. 2^15 (16 in keyswitch_kernel at 2^14, 14 of them its
//   NTT stages'). A thread writes each pass's results to the positions it
//   read them from, and the next digit's first write goes to the
//   positions its epilogue read, so no barrier guards a reuse of the
//   plane.
// - Balance: with d a special channel runs D NTTs and a base channel
//   D - 1, so the special channels' blocks come first in the grid: the
//   longest blocks start first and the base channels' shorter ones fill
//   the SMs they leave, in place of a tail of special blocks that start
//   last. At 2^14 a block of 512 threads holds 128 registers a thread and
//   66 KiB of shared memory, one block an SM: the main path's 384 blocks
//   (32 items x 12 channels, 512 NTTs) give each of the 132 SMs about 4
//   NTTs.
// - Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py,
//   (32, 8, 2^14), ds 4, with d): 0.148 ms against 0.296 for
//   keyswitch_kernel; 0.158 with the blocks in item order (special blocks
//   not first); 0.166 with two blocks of 64 registers an SM; 0.196 with
//   256 threads of 64 words (two blocks an SM). Without d: 0.183 (0.316).
//
// K2 on uint32 planes of 2^16 (keyswitch_kernel_cluster) runs K4's cluster
// plan (csrc/ntt_cluster.cuh: 16 blocks of 128 threads a plane) once per
// NTT digit: the raise formed in the cross pass's loads of the digit's y_k
// planes (groups of 16 words at stride N/16, coalesced over the threads),
// and the key products, the own-digit term and the digit sum on the
// slice's coalesced words after the last exchange, each thread reading and
// writing only its own words of out0/out1. The cluster barrier carries
// the digits: a block arrives once its threads have read the slice for the
// last time in a digit (the load back to pass 0's layout), and the next
// digit's scatter waits for every rank's arrival, so no store reaches a
// slice that its rank still reads; the raise, the cross pass and the
// epilogue lie between the two. A plane with no NTT digit (a base channel
// whose only digit is its own, D = 1 with d) never touches the barrier or
// a peer. 128 registers a thread, four blocks an SM (28 clusters resident,
// the big path's 24 planes at batch 4 at once; no spill at 64 either).
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py,
// device time; (4, 4 base, 2^16), ds 2, E 6): with d 0.0427 ms against
// 0.3011-0.3020 for keyswitch_kernel on clusters of 2, and 0.0458-0.0474
// at 64 registers (58 clusters resident); without d 0.0537-0.0542
// (0.3002-0.3070; 64 registers 0.0550-0.0563).
//
// K6 on uint64 planes of 2^13 .. 2^16 (keyswitch_kernel_cluster64<log2
// N>) runs the same body on the uint64 plan (ntt_cluster.cuh WidePlan: 16
// words a thread; 16 blocks a plane at 2^15 and 2^16, kWideLogCluster13 /
// 14 at 2^13 and 2^14, where one block holds the plane but three passes
// of 16 words do not hold its stages, and the template ran one barrier a
// stage on 40 blocks at the wide path's shape), the raise a Harvey64 in
// the cross pass's loads and the key products REDC64s on the slice's
// words. 126-128
// registers a thread, no spill; 28 clusters resident at 2^15 (the
// big-wide path's 16 planes at batch 4 at once), 14 at 2^16. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py, device time;
// (4, 3 base, 2^15), ds 1, E 4): with d 0.0606-0.0608 ms against
// 0.2912-0.2929 for keyswitch_kernel on clusters of 2, without d
// 0.0673-0.0677 (0.2897-0.2929); at (1, 2 base, 2^16) 0.046 (0.209); on
// clusters of 8 at 2^15 0.064 / 0.085; with 32 words a thread (232
// registers) 0.140-0.148. At the wide path's (8, 5, 2^13), ds 1: with d
// 0.0526 ms on clusters of 4 against 0.1828-0.1833 for keyswitch_kernel
// (0.0635-0.0641 on 8), without d 0.0577-0.0578 (0.1791-0.1848); at
// (2, 4, 2^14), 62-bit, 0.0447 on 8 against 0.2688-0.2700 (0.0531-0.0541
// on 4); 126-128 registers, no spill, 124 / 62 clusters resident.
#include "ntt.cuh"
#include "ntt_cluster.cuh"
#include "ntt_reg.cuh"

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
    // no thread reads the plane now: the previous digit ended with a block
    // barrier after its epilogue
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

// One block a plane: keyswitch_kernel's one-block form (uint32 planes
// below 2^10, uint64 planes up to 2^12; the larger planes run the forms
// below).
template <typename T>
int launch_one_block(const T* y, long long y_stride, const T* d, long long d_stride,
                     const T* key_a, const T* key_b, const T* c, const T* cs, const T* q,
                     const T* qinv, const T* tw, const T* twp, T* out0, T* out1, int outer,
                     int base, int ext, int digits, int digit_size, int log_n,
                     cudaStream_t stream) {
  const size_t smem = ckks::plane_bytes<T>(log_n);
  const cudaError_t err = ckks::reserve_smem(
      reinterpret_cast<const void*>(keyswitch_kernel<T, false>), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  keyswitch_kernel<T, false><<<outer * ext, ckks::kThreads, smem, stream>>>(
      y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp, out0, out1,
      base, ext, digits, digit_size, log_n);
  return static_cast<int>(cudaGetLastError());
}

using ckks::kLogRegWords;
using ckks::kRegWords;
using ckks::RegPass;
using ckks::RegPlan;

// K2 on uint32 planes that one block holds (see the header): one block of
// N / 32 threads per (item, extended channel j), the special channels'
// blocks first when d is given.
template <int kLogN>
__global__ void __launch_bounds__(RegPlan<kLogN>::kThreads,
                                  RegPlan<kLogN>::kMinBlocks)
keyswitch_kernel_reg(const uint32_t* __restrict__ y, long long y_stride,
                     const uint32_t* __restrict__ d, long long d_stride,
                     const uint32_t* __restrict__ key_a,
                     const uint32_t* __restrict__ key_b,
                     const uint32_t* __restrict__ c,
                     const uint32_t* __restrict__ cs,
                     const uint32_t* __restrict__ q,
                     const uint32_t* __restrict__ qinv,
                     const uint32_t* __restrict__ tw,
                     const uint32_t* __restrict__ twp,
                     uint32_t* __restrict__ out0, uint32_t* __restrict__ out1,
                     int outer, int base, int ext, int digits, int digit_size) {
  using P0 = RegPass<kLogN, 0, kLogRegWords>;
  constexpr long long n = 1LL << kLogN;
  constexpr int kT = RegPlan<kLogN>::kThreads;
  uint32_t* s = ckks::smem_plane<uint32_t>();
  const int t = threadIdx.x;

  const int spec = ext - base;
  const int heavy = d != nullptr ? outer * spec : 0;
  int j;
  long long item;
  if (static_cast<int>(blockIdx.x) < heavy) {
    item = blockIdx.x / spec;
    j = base + static_cast<int>(blockIdx.x % spec);
  } else {
    const int r = blockIdx.x - heavy;
    const int width = d != nullptr ? base : ext;
    item = r / width;
    j = r % width;
  }
  const uint32_t qj = q[j], qi = qinv[j];
  const uint32_t* w = tw + j * n;
  const uint32_t* wp = twp + j * n;
  // every global word below is at position m * kT + t of its plane
  const uint32_t* yi = y + item * y_stride + t;
  const long long o_off = (item * ext + j) * n + t;
  uint32_t* o0 = out0 + o_off;
  uint32_t* o1 = out1 + o_off;
  const long long key_t = ext * n;  // key planes (digits, ext, N)
  const uint32_t* ka = key_a + j * n + t;
  const uint32_t* kb = key_b + j * n + t;
  const int own = d != nullptr && j < base ? j / digit_size : -1;
  const uint32_t* dj = own >= 0 ? d + item * d_stride + j * n + t : nullptr;

  uint32_t a[kRegWords];
  bool first = true;
  for (int dt = 0; dt < digits; ++dt) {
    if (dt == own) continue;
    // the raise, into pass 0's words
    const int k0 = dt * digit_size;
    const int k1 = min(k0 + digit_size, base);
    {
      const uint32_t ck = c[k0 * ext + j], cks = cs[k0 * ext + j];
      const uint32_t* yk = yi + k0 * n;
#pragma unroll
      for (int m = 0; m < kRegWords; ++m)
        a[m] = ckks::harvey(ckks::ldg(yk + m * kT), ck, cks, qj);
    }
    for (int k = k0 + 1; k < k1; ++k) {
      const uint32_t ck = c[k * ext + j], cks = cs[k * ext + j];
      const uint32_t* yk = yi + k * n;
#pragma unroll
      for (int m = 0; m < kRegWords; ++m)
        a[m] = ckks::add_mod(
            a[m], ckks::harvey(ckks::ldg(yk + m * kT), ck, cks, qj), qj);
    }
    ckks::reg_forward<kLogN>(s, a, t, w, wp, qj);
    ckks::RegLast<kLogN>::store(s, a, t);
    __syncthreads();
    P0::load(s, a, t);
    // the key products, the own digit's (with the first NTT digit) and the
    // sum over the digits
    const uint32_t* kat = ka + dt * key_t;
    const uint32_t* kbt = kb + dt * key_t;
    const bool with_own = first && own >= 0;
#pragma unroll
    for (int m = 0; m < kRegWords; ++m) {
      const int p = m * kT;
      uint32_t v0 = ckks::mont_redc(a[m], ckks::ldg(kbt + p), qj, qi);
      uint32_t v1 = ckks::mont_redc(a[m], ckks::ldg(kat + p), qj, qi);
      if (with_own) {
        const uint32_t x = ckks::ldg(dj + p);
        v0 = ckks::add_mod(v0, ckks::mont_redc(x, ckks::ldg(kb + own * key_t + p), qj, qi), qj);
        v1 = ckks::add_mod(v1, ckks::mont_redc(x, ckks::ldg(ka + own * key_t + p), qj, qi), qj);
      }
      if (!first) {
        v0 = ckks::add_mod(v0, o0[p], qj);
        v1 = ckks::add_mod(v1, o1[p], qj);
      }
      o0[p] = v0;
      o1[p] = v1;
    }
    first = false;
  }
  if (first && own >= 0) {  // D = 1 with d: the own digit alone
#pragma unroll 4
    for (int m = 0; m < kRegWords; ++m) {
      const int p = m * kT;
      const uint32_t x = ckks::ldg(dj + p);
      o0[p] = ckks::mont_redc(x, ckks::ldg(kb + own * key_t + p), qj, qi);
      o1[p] = ckks::mont_redc(x, ckks::ldg(ka + own * key_t + p), qj, qi);
    }
  }
}

template <int kLogN>
const void* reg_kernel() {
  return reinterpret_cast<const void*>(keyswitch_kernel_reg<kLogN>);
}

template <int kLogN>
int launch_reg(const uint32_t* y, long long y_stride, const uint32_t* d,
               long long d_stride, const uint32_t* key_a,
               const uint32_t* key_b, const uint32_t* c, const uint32_t* cs,
               const uint32_t* q, const uint32_t* qinv, const uint32_t* tw,
               const uint32_t* twp, uint32_t* out0, uint32_t* out1, int outer,
               int base, int ext, int digits, int digit_size,
               cudaStream_t stream) {
  using Plan = RegPlan<kLogN>;
  const cudaError_t err = ckks::reserve_smem(reg_kernel<kLogN>(), Plan::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  keyswitch_kernel_reg<kLogN><<<outer * ext, Plan::kThreads, Plan::kSmemBytes,
                                stream>>>(
      y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp, out0,
      out1, outer, base, ext, digits, digit_size);
  return static_cast<int>(cudaGetLastError());
}

using ckks::BigPlan;
// K6's uint64 plan
template <int kLogN>
using KsWidePlan = ckks::WidePlan<kLogN, ckks::kWideKeySwitch>;

// The cluster form of Plan (see the header): one cluster of Plan::kC
// blocks of N/C/W threads per (item, extended channel j), the special
// channels' planes first when d is given.
template <typename Plan, typename T = typename Plan::Word>
__device__ __forceinline__ void keyswitch_cluster_body(
    const T* __restrict__ y, long long y_stride, const T* __restrict__ d,
    long long d_stride, const T* __restrict__ key_a, const T* __restrict__ key_b,
    const T* __restrict__ c, const T* __restrict__ cs, const T* __restrict__ q,
    const T* __restrict__ qinv, const T* __restrict__ tw, const T* __restrict__ twp,
    T* __restrict__ out0, T* __restrict__ out1, int outer, int base, int ext, int digits,
    int digit_size) {
  using Cross = ckks::CrossPass<Plan, false>;
  constexpr long long n = 1LL << Plan::kLogN;
  constexpr int kC = Plan::kC, kM = Plan::kM, kT = Plan::kThreads, kW = Plan::kW;
  const int tid = threadIdx.x;
  const int r = static_cast<int>(blockIdx.x) & (kC - 1);  // rank in the cluster
  const int plane = static_cast<int>(blockIdx.x) >> Plan::kLogC;
  const int spec = ext - base;
  const int heavy = d != nullptr ? outer * spec : 0;
  int j;
  long long item;
  if (plane < heavy) {
    item = plane / spec;
    j = base + plane % spec;
  } else {
    const int width = d != nullptr ? base : ext;
    item = (plane - heavy) / width;
    j = (plane - heavy) % width;
  }
  const int own = d != nullptr && j < base ? j / digit_size : -1;
  // the digits that run the cluster NTT, the same on every rank of the plane
  int ntts = own >= 0 ? digits - 1 : digits;
  if (ntts > 0) ckks::cluster_arrive_relaxed();  // this block has started
  T* s = ckks::smem_plane<T>();
  const T qj = q[j], qi = qinv[j];
  const T* w = tw + j * n;
  const T* wp = twp + j * n;
  const T* yi = y + item * y_stride;
  // every word of the epilogue is at slice position m * kT + tid of rank r
  const long long slice = r * kM + tid;
  const long long o_off = (item * ext + j) * n + slice;
  T* o0 = out0 + o_off;
  T* o1 = out1 + o_off;
  const long long key_t = ext * n;  // key planes (digits, ext, N)
  const T* ka = key_a + j * n + slice;
  const T* kb = key_b + j * n + slice;
  const T* dj = own >= 0 ? d + item * d_stride + j * n + slice : nullptr;

  T a[kW];
  bool first = true;
  for (int dt = 0; dt < digits; ++dt) {
    if (dt == own) continue;
    // the raise, into the cross pass's words
    const int k0 = dt * digit_size;
    const int k1 = min(k0 + digit_size, base);
    {
      const T ck = c[k0 * ext + j], cks = cs[k0 * ext + j];
      const T* yk = yi + k0 * n;
#pragma unroll
      for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
        for (int k = 0; k < kC; ++k)
          a[h * kC + k] = ckks::harvey(ckks::ldg(yk + Cross::first(r, h, tid) + k * kM),
                                       ck, cks, qj);
    }
    for (int k = k0 + 1; k < k1; ++k) {
      const T ck = c[k * ext + j], cks = cs[k * ext + j];
      const T* yk = yi + k * n;
#pragma unroll
      for (int h = 0; h < Plan::kGroups; ++h)
#pragma unroll
        for (int g = 0; g < kC; ++g) {
          const int u = h * kC + g;
          a[u] = ckks::add_mod(
              a[u], ckks::harvey(ckks::ldg(yk + Cross::first(r, h, tid) + g * kM), ck, cks, qj),
              qj);
        }
    }
    Cross::run(a, w, wp, qj);
    // waits for every rank's arrival, scatters, and returns once this
    // block has read its slice for the last time in this digit
    ckks::cluster_forward<Plan>(s, a, r, tid, w, wp, qj);
    if (--ntts > 0) ckks::cluster_arrive();  // the next digit's scatter may come
    // the key products, the own digit's (with the first NTT digit) and the
    // sum over the digits, on the slice's coalesced words
    const T* kat = ka + dt * key_t;
    const T* kbt = kb + dt * key_t;
    const bool with_own = first && own >= 0;
#pragma unroll
    for (int m = 0; m < kW; ++m) {
      const int p = m * kT;
      T v0 = ckks::mont_redc(a[m], ckks::ldg(kbt + p), qj, qi);
      T v1 = ckks::mont_redc(a[m], ckks::ldg(kat + p), qj, qi);
      if (with_own) {
        const T x = ckks::ldg(dj + p);
        v0 = ckks::add_mod(v0, ckks::mont_redc(x, ckks::ldg(kb + own * key_t + p), qj, qi), qj);
        v1 = ckks::add_mod(v1, ckks::mont_redc(x, ckks::ldg(ka + own * key_t + p), qj, qi), qj);
      }
      if (!first) {
        v0 = ckks::add_mod(v0, o0[p], qj);
        v1 = ckks::add_mod(v1, o1[p], qj);
      }
      o0[p] = v0;
      o1[p] = v1;
    }
    first = false;
  }
  if (first && own >= 0) {  // D = 1 with d: the own digit alone, no peer
#pragma unroll 4
    for (int m = 0; m < kW; ++m) {
      const int p = m * kT;
      const T x = ckks::ldg(dj + p);
      o0[p] = ckks::mont_redc(x, ckks::ldg(kb + own * key_t + p), qj, qi);
      o1[p] = ckks::mont_redc(x, ckks::ldg(ka + own * key_t + p), qj, qi);
    }
  }
}

// K2 on uint32 planes of 2^16 words (see the header).
__global__ void __launch_bounds__(BigPlan::kThreads, 4)  // 128 registers a thread
keyswitch_kernel_cluster(const uint32_t* __restrict__ y, long long y_stride,
                         const uint32_t* __restrict__ d, long long d_stride,
                         const uint32_t* __restrict__ key_a,
                         const uint32_t* __restrict__ key_b,
                         const uint32_t* __restrict__ c,
                         const uint32_t* __restrict__ cs,
                         const uint32_t* __restrict__ q,
                         const uint32_t* __restrict__ qinv,
                         const uint32_t* __restrict__ tw,
                         const uint32_t* __restrict__ twp,
                         uint32_t* __restrict__ out0, uint32_t* __restrict__ out1,
                         int outer, int base, int ext, int digits, int digit_size) {
  keyswitch_cluster_body<BigPlan>(y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv,
                                  tw, twp, out0, out1, outer, base, ext, digits,
                                  digit_size);
}

// K6 on uint64 planes of 2^kLogN words, 2^13 .. 2^16 (see the header).
template <int kLogN>
__global__ void __launch_bounds__(KsWidePlan<kLogN>::kThreads,
                                  ckks::kWideThreadsPerSm / KsWidePlan<kLogN>::kThreads)
keyswitch_kernel_cluster64(const uint64_t* __restrict__ y, long long y_stride,
                           const uint64_t* __restrict__ d, long long d_stride,
                           const uint64_t* __restrict__ key_a,
                           const uint64_t* __restrict__ key_b,
                           const uint64_t* __restrict__ c,
                           const uint64_t* __restrict__ cs,
                           const uint64_t* __restrict__ q,
                           const uint64_t* __restrict__ qinv,
                           const uint64_t* __restrict__ tw,
                           const uint64_t* __restrict__ twp,
                           uint64_t* __restrict__ out0, uint64_t* __restrict__ out1,
                           int outer, int base, int ext, int digits, int digit_size) {
  keyswitch_cluster_body<KsWidePlan<kLogN>>(y, y_stride, d, d_stride, key_a, key_b, c, cs, q,
                                            qinv, tw, twp, out0, out1, outer, base, ext,
                                            digits, digit_size);
}

template <int kLogN>
int launch_cluster64(const uint64_t* y, long long y_stride, const uint64_t* d,
                     long long d_stride, const uint64_t* key_a, const uint64_t* key_b,
                     const uint64_t* c, const uint64_t* cs, const uint64_t* q,
                     const uint64_t* qinv, const uint64_t* tw, const uint64_t* twp,
                     uint64_t* out0, uint64_t* out1, int outer, int base, int ext,
                     int digits, int digit_size, cudaStream_t stream) {
  using Plan = KsWidePlan<kLogN>;
  return ckks::launch_cluster<Plan, &keyswitch_kernel_cluster64<kLogN>>(
      outer * ext, Plan::kForwardBytes, stream, y, y_stride, d, d_stride, key_a, key_b, c,
      cs, q, qinv, tw, twp, out0, out1, outer, base, ext, digits, digit_size);
}

}  // namespace

// y: (outer, base, N) plain digit values, item stride y_stride; d: NTT-domain
// input (outer, base, N) with stride d_stride, or nullptr (no skip-own);
// key_a/key_b: (digits, ext, N); c/cs: (digits * digit_size, ext);
// q/qinv: (ext,); tw/twp: (ext, N) forward twiddles; out0/out1: contiguous
// (outer, ext, N); parts: 1 (one block a plane) or, at N = 2^16 only, above
// 1 (a cluster: keyswitch_kernel_cluster on ckks::BigPlan::kC blocks).
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
  const int blocks = ckks::plane_blocks(ckks::kWideKeySwitch, false, log_n, parts);
  if (blocks > 1) {
    return ckks::launch_cluster<BigPlan, &keyswitch_kernel_cluster>(
        outer * ext, BigPlan::kForwardBytes, stream, y, y_stride, d, d_stride, key_a,
        key_b, c, cs, q, qinv, tw, twp, out0, out1, outer, base, ext, digits,
        digit_size);
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ckks::reg_shape(log_n)) {
    return ckks::reg_dispatch(log_n, [&](auto log_n_c) {
      return launch_reg<decltype(log_n_c)::value>(
          y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp,
          out0, out1, outer, base, ext, digits, digit_size, stream);
    });
  }
  return launch_one_block(y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw,
                          twp, out0, out1, outer, base, ext, digits, digit_size, log_n,
                          stream);
}

const void* ckks::keyswitch_cluster_kernel() {
  return reinterpret_cast<const void*>(keyswitch_kernel_cluster);
}

const void* ckks::keyswitch_cluster64_kernel(int log_n) {
  if (!wide_cluster_shape(log_n)) return nullptr;
  return wide_dispatch(log_n, [](auto log_n_c) {
    return reinterpret_cast<const void*>(keyswitch_kernel_cluster64<decltype(log_n_c)::value>);
  });
}

const void* ckks::keyswitch_reg_kernel(int log_n) {
  if (!reg_shape(log_n)) return nullptr;
  return reg_dispatch(log_n, [](auto log_n_c) {
    return reg_kernel<decltype(log_n_c)::value>();
  });
}

// The register-pass kernel `kernel` (ckks::RegKernel: 0 K2, 1 K3, 2 K1
// forward, 3 K1 inverse) at log_n as built and as it fits the current
// device: info[0..4] = registers a thread, local (spill) bytes a thread,
// threads a block, dynamic shared bytes a block, resident blocks an SM.
// Returns cudaErrorInvalidValue outside log_n in [10, 15] or for another id.
extern "C" int ckks_reg_info(int kernel, int log_n, int* info) {
  if (!ckks::reg_shape(log_n)) return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel == ckks::kRegKeySwitch   ? ckks::keyswitch_reg_kernel(log_n)
                   : kernel == ckks::kRegModDown   ? ckks::moddown_reg_kernel(log_n)
                   : kernel == ckks::kRegNttForward ? ckks::ntt_reg_kernel(log_n, false)
                   : kernel == ckks::kRegNttInverse ? ckks::ntt_reg_kernel(log_n, true)
                                                    : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return ckks::reg_info(fn, log_n, info);
}

// The same on uint64 words (wide chains; qinv = -q^-1 mod 2^64): at N =
// 2^13 .. 2^16 a cluster (keyswitch_kernel_cluster64 on ckks::WidePlan's
// C blocks) whatever parts says; below, parts 1 (keyswitch_kernel's
// one-block form).
extern "C" int ckks_keyswitch64(const uint64_t* y, long long y_stride,
                                const uint64_t* d, long long d_stride,
                                const uint64_t* key_a, const uint64_t* key_b,
                                const uint64_t* c, const uint64_t* cs,
                                const uint64_t* q, const uint64_t* qinv,
                                const uint64_t* tw, const uint64_t* twp,
                                uint64_t* out0, uint64_t* out1, int outer,
                                int base, int ext, int digits, int digit_size,
                                int log_n, int parts, cudaStream_t stream) {
  const int blocks = ckks::plane_blocks(ckks::kWideKeySwitch, true, log_n, parts);
  if (blocks > 1) {
    return ckks::wide_dispatch(log_n, [&](auto log_n_c) {
      return launch_cluster64<decltype(log_n_c)::value>(
          y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp, out0, out1,
          outer, base, ext, digits, digit_size, stream);
    });
  }
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_one_block(y, y_stride, d, d_stride, key_a, key_b, c, cs, q, qinv, tw, twp,
                          out0, out1, outer, base, ext, digits, digit_size, log_n, stream);
}
