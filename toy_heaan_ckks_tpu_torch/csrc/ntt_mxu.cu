// K9: the tree-order negacyclic NTT of whole planes as two modular matrix
// products on the tensor cores (u8 x u8 -> s32 mma.sync), forward or
// inverse, on uint32 words of a small chain (every q < 2^31).
//
// Replaces the Pallas TPU kernel toy_heaan_ckks_tpu/ops/ntt_mxu.py
// _mxu_kernel. A plane of N = R * 128 words is seen as an (R, 128)
// row-major matrix X (ops/ntt_mxu.py):
//
//   forward:  A = Wr @ X (contract rows), B = A (.) T, out = B @ Wc^T
//   inverse:  A = X @ Wc*^T (contract lanes), B = A (.) T*, out = Wr* @ B
//
// Each modular product splits both operands into four 8-bit limbs and sums
// the sixteen limb products by limb weight in s32 accumulators,
// P_s = sum_{i+j=s} W_j @ X_i for s = 0..6, exact: P_s <= 4 * K * 255^2 <
// 2^27 for K <= 256. The fold acc = sum_s P_s * (2^(8s+32) mod q) < 2^61
// is taken in 64 bits, then one Montgomery reduction and a conditional
// subtraction give W @ X mod q in [0, q): the unique residue, so every
// output word equals K1's (csrc/ntt.cu) and the twin's.
//
// Both kernels split a plane into four u8 limb planes in shared memory,
// laid out as the first product's mma operand (transposed where the
// contracted axis is the row axis: ldmatrix.trans does not take 8-bit
// elements), and run the first product stripe by stripe: S = Rp / 16
// stripes of 2048 outputs, one m16n8 tile per warp, Rp = max(R, 32) the
// row count padded with zeros to the mma depth. A stripe's outputs are
// folded, reduced, twisted by T and split into limbs in the second
// product's operand layout, written over a slot whose input stripe is
// consumed (slots of 8 KiB: two full limb copies of the plane would not
// fit beside the matrices). The second product reads those limbs and
// writes the folded words to device memory. The launch picks the kernel
// by R (ckks_ntt_mxu_info reports it):
//
// - R <= kRunMaxRows (N <= 2^14, the small path's 2^14 included),
//   ntt_mxu_run_kernel<log2 Rp, inverse>: a block of 16 warps owns one
//   channel and a run of that channel's planes, so that its constant
//   operands are loaded once a block: both matrices' u8 limbs go to shared
//   memory by cp.async (16-byte chunks XOR-permuted by the row: fragment
//   loads are free of bank conflicts), once a run. Each warp keeps in
//   registers, for a plane, the operand it uses in every tile (the matrix
//   rows of its first-product tile; in the second product its eight
//   columns' operand across the row tiles) and reads the other from
//   shared memory. The stripes hand over without a block barrier: input
//   stripe k sits in slot k + kInSlot and its middle limbs go to slot k,
//   over stripe k - 2's input; each warp arrives on mbarrier[k mod 2]
//   after stripe k's products and waits for every warp's arrival on
//   stripe k - 2 before it writes, so the warps drift apart and one
//   warp's fold and twist run beside another's products. The middle limbs
//   are stored as 16-bit pairs (the inverse's after an exchange of words
//   with lane ^ 4), the twist read as 8-byte vectors, the output written
//   as 8-byte pairs. The grid is channels x runs, a run
//   ceil(planes / SMs) planes (kRunPlanes fixes it instead where > 0).
//   At R = 128: 80 KiB of slots + 128 KiB of matrix limbs.
// - R = 256 (N = 2^15), ntt_mxu_kernel<inverse>: one block per (channel,
//   item) plane, channel-major, its matrix fragments read from the tables
//   in device memory (L1/L2) and one block barrier a stripe (S + 1 slots,
//   136 KiB: the matrices do not fit beside them).
//
// What bounds it on an H100: the work is 16 * N * (R + 128) u8 MACs per
// plane on the tensor cores and ~50 32-bit integer instructions per word
// (each product's seven 64-bit multiply-adds and REDC, the twist, the limb
// split and the stores); from R = 64 up the MACs set the least time at the
// dense int8 rate (0.0174 ms at (32, 8, 2^14)). The plane-per-block kernel
// is bound by latency: each mma.sync waits on 32-bit matrix loads from
// L1/L2, with one block of 16 warps per SM and a barrier per stripe. On an
// NVIDIA H100 80GB HBM3 at 700 W (tools/kernel_ab.py --paths mxu, device
// ms, in turns) it took 0.163 at (32, 8, 2^14) and 0.079 at (1, 8, 2^14);
// the channel-run kernel 0.062-0.063 (runs of 2 planes; 1 plane
// 0.064-0.069, 4 planes 0.118-0.126) and 0.031-0.033. Timing-only probes
// of it: without the fold and REDC 0.054, with one mma in sixteen
// 0.038-0.043, so the integer work, the loads and the barriers hold most
// of the time beside the tensor cores; a second accumulator set (a tile's
// fold beside the next tile's products) spilled and ran 5-24% slower, and
// holding the second product's row tile in place of its columns spilled
// and ran 1-4% slower.
// wgmma with operands in its core-matrix layout is the form that would
// take the products off the warps' issue slots.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kLimbs = 4;
constexpr int kFolds = 2 * kLimbs - 1;
constexpr int kLanes = 128;           // C: the lane axis of every plane
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStripe = 2048;         // bytes of one limb of one stripe
constexpr int kSlot = kLimbs * kStripe;
// the channel-run kernel: input stripe k in slot k + kInSlot, its middle
// limbs in slot k (tests/test_torch_mxu_plan.py reads these constants)
constexpr int kInSlot = 2;
constexpr int kRunMaxRows = 128;  // the largest R it takes
constexpr int kRunPlanes = 0;     // planes a block; 0: ceil(planes / SMs)

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The sixteen limb products of one k-step: limb i of A times limb j of B
// accumulates into weight i + j.
__device__ __forceinline__ void mma_limbs(int (&acc)[kFolds][4],
                                          const uint32_t (&a)[kLimbs][4],
                                          const uint32_t (&b)[kLimbs][2]) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
#pragma unroll
    for (int j = 0; j < kLimbs; ++j) mma_u8(acc[i + j], a[i], b[j]);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ldg32(const uint8_t* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

// Byte offset of (row, col) in a limb plane with rows of `width` bytes (a
// power of two >= 32): the row's 4-byte words are XOR-swizzled by the row,
// so the eight rows of a fragment load fall in distinct banks.
__device__ __forceinline__ int swz(int row, int col, int width) {
  const int word = (col >> 2) ^ (((row & 7) << 2) & ((width >> 2) - 1));
  return row * width + (word << 2) + (col & 3);
}

// Four words -> their four limb words: limb i holds byte i of w0..w3 in
// bytes 0..3 (four consecutive elements of one u8 operand row).
__device__ __forceinline__ void split4(const uint32_t (&w)[4],
                                       uint32_t (&limb)[kLimbs]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  limb[0] = __byte_perm(lo01, lo23, 0x5410);
  limb[1] = __byte_perm(lo01, lo23, 0x7632);
  limb[2] = __byte_perm(hi01, hi23, 0x5410);
  limb[3] = __byte_perm(hi01, hi23, 0x7632);
}

// sum_s P_s * rs[s] (< 2^61), then REDC: the canonical residue of
// acc * 2^-32 mod q. qinv = -q^-1 mod 2^32; acc + m*q < 2^61 + 2^63.
__device__ __forceinline__ uint32_t fold_redc(const int (&acc)[kFolds][4],
                                              int e,
                                              const uint32_t (&rs)[kFolds],
                                              uint32_t q, uint32_t qinv) {
  uint64_t s = 0;
#pragma unroll
  for (int f = 0; f < kFolds; ++f)
    s += static_cast<uint64_t>(static_cast<uint32_t>(acc[f][e])) * rs[f];
  const uint32_t m = static_cast<uint32_t>(s) * qinv;
  const uint32_t r =
      static_cast<uint32_t>((s + static_cast<uint64_t>(m) * q) >> 32);
  return r >= q ? r - q : r;
}

// x * t mod q for x < q, t plain with Shoup companion tp (Harvey).
__device__ __forceinline__ uint32_t harvey(uint32_t x, uint32_t t,
                                           uint32_t tp, uint32_t q) {
  const uint32_t h = __umulhi(x, tp);
  const uint32_t r = x * t - h * q;
  return r >= q ? r - q : r;
}

// Shared memory: S + 1 slots of four 2048-byte limb planes. The first
// product's input stripe k sits in slot k + 1 and its output stripe k is
// written to slot k, which the second product reads. The layouts of an
// element in its slot (w = 2048 / Rp, the forward stripe's column count):
//
//   forward input  X^T (c, b): slot 1 + c / w, swz(c % w, b, Rp)
//   forward middle Y   (r, b): slot b / w,     r * w + b % w
//   inverse input  X   (r, b): slot 1 + r / 16, swz(r % 16, b, 128)
//   inverse middle Y^T (c, r): slot r / 16,    c * 16 + r % 16
//
// so the mma's A operand (row-major, K contiguous) and B operand (col:
// N rows of K contiguous) read 4 consecutive K bytes per register.
template <bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
ntt_mxu_kernel(const uint32_t* __restrict__ x, long long x_stride,
               uint32_t* __restrict__ out, const uint8_t* __restrict__ w1,
               const uint8_t* __restrict__ w2,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ twp,
               const uint32_t* __restrict__ rsv,
               const uint32_t* __restrict__ qv,
               const uint32_t* __restrict__ qinvv, int outer, int channels,
               int rows) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ch = static_cast<int>(blockIdx.x / outer);
  const long long item = blockIdx.x % outer;
  const int n = rows * kLanes;
  const int rp = rows < 32 ? 32 : rows;
  const int stripes = rp / 16;
  const int width = kStripe / rp;  // forward stripe columns
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const uint32_t q = qv[ch], qinv = qinvv[ch];
  uint32_t rs[kFolds];
#pragma unroll
  for (int f = 0; f < kFolds; ++f) rs[f] = rsv[ch * kFolds + f];
  const uint32_t* src = x + item * x_stride + static_cast<long long>(ch) * n;
  uint32_t* dst = out + (item * channels + ch) * static_cast<long long>(n);
  const uint32_t* tch = tw + static_cast<long long>(ch) * n;
  const uint32_t* tpch = twp + static_cast<long long>(ch) * n;
  // matrix limbs: the row contraction's table is Rp x Rp, the lane one's
  // 128 x 128, limb-major per channel
  const int k1 = kInverse ? kLanes : rp;
  const int k2 = kInverse ? rp : kLanes;
  const uint8_t* w1c = w1 + static_cast<long long>(ch) * kLimbs * k1 * k1;
  const uint8_t* w2c = w2 + static_cast<long long>(ch) * kLimbs * k2 * k2;

  // ── load: split into limbs, in the first product's operand layout ──
  for (int idx = threadIdx.x; idx < 32 * rp; idx += kThreads) {
    uint32_t wd[4] = {0, 0, 0, 0};
    uint32_t limb[kLimbs];
    int off, slot;
    if constexpr (!kInverse) {  // X^T: 4 consecutive rows b of column c
      const int c = idx % kLanes, b = 4 * (idx / kLanes);
      if (b < rows) {
#pragma unroll
        for (int i = 0; i < 4; ++i) wd[i] = src[(b + i) * kLanes + c];
      }
      slot = 1 + c / width;
      off = swz(c % width, b, rp);
    } else {  // X: 4 consecutive lanes b of row r
      const int b = 4 * (idx % 32), r = idx / 32;
      if (r < rows) {
#pragma unroll
        for (int i = 0; i < 4; ++i) wd[i] = src[r * kLanes + b + i];
      }
      slot = 1 + r / 16;
      off = swz(r % 16, b, kLanes);
    }
    split4(wd, limb);
#pragma unroll
    for (int i = 0; i < kLimbs; ++i)
      *reinterpret_cast<uint32_t*>(smem + slot * kSlot + i * kStripe + off) =
          limb[i];
  }

  // ── first product, stripe by stripe, into the second's operand layout ──
  for (int k = 0; k < stripes; ++k) {
    __syncthreads();  // slot k's input (stripe k - 1) is consumed
    const uint8_t* in = smem + (k + 1) * kSlot;
    uint8_t* mid = smem + k * kSlot;
    int acc[kFolds][4] = {};
    uint32_t a[kLimbs][4], b[kLimbs][2];
    int m0, n0;  // the warp's tile: rows and columns of the product
    if constexpr (!kInverse) {
      // out[a][c] = sum_b Wr[a][b] X[b][c]: rows a of Rp, columns c of the
      // stripe; A = Wr (table), B = X^T (shared)
      const int mtiles = rp / 16;
      m0 = (warp % mtiles) * 16;
      n0 = (warp / mtiles) * 8;  // within the stripe
      for (int kb = 0; kb < rp; kb += 32) {
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) {
          const uint8_t* wj = w1c + j * rp * rp + kb + 4 * t;
          a[j][0] = ldg32(wj + (m0 + g) * rp);
          a[j][1] = ldg32(wj + (m0 + g + 8) * rp);
          a[j][2] = ldg32(wj + (m0 + g) * rp + 16);
          a[j][3] = ldg32(wj + (m0 + g + 8) * rp + 16);
        }
#pragma unroll
        for (int i = 0; i < kLimbs; ++i) {
          const uint8_t* xi = in + i * kStripe;
          b[i][0] = lds32(xi + swz(n0 + g, kb + 4 * t, rp));
          b[i][1] = lds32(xi + swz(n0 + g, kb + 16 + 4 * t, rp));
        }
        mma_limbs(acc, a, b);
      }
    } else {
      // out[r][a] = sum_b X[r][b] Wc*[a][b]: the stripe's 16 rows r,
      // columns a of 128; A = X (shared), B = Wc* (table)
      m0 = 0;
      n0 = warp * 8;
      for (int kb = 0; kb < kLanes; kb += 32) {
#pragma unroll
        for (int i = 0; i < kLimbs; ++i) {
          const uint8_t* xi = in + i * kStripe;
          a[i][0] = lds32(xi + swz(g, kb + 4 * t, kLanes));
          a[i][1] = lds32(xi + swz(g + 8, kb + 4 * t, kLanes));
          a[i][2] = lds32(xi + swz(g, kb + 16 + 4 * t, kLanes));
          a[i][3] = lds32(xi + swz(g + 8, kb + 16 + 4 * t, kLanes));
        }
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) {
          const uint8_t* wj = w1c + (j * kLanes + n0 + g) * kLanes + kb + 4 * t;
          b[j][0] = ldg32(wj);
          b[j][1] = ldg32(wj + 16);
        }
        mma_limbs(acc, a, b);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lr = m0 + g + 8 * (e >> 1);  // tile row
      const int lc = n0 + 2 * t + (e & 1);   // tile column
      // the output's (R, C) position and its byte offset in `mid`
      const int row = kInverse ? 16 * k + lr : lr;
      const int col = kInverse ? lc : k * width + lc;
      const int off = kInverse ? col * 16 + lr : row * width + lc;
      uint32_t v = fold_redc(acc, e, rs, q, qinv);
      if (row < rows) {
        const int p = row * kLanes + col;
        v = harvey(v, __ldg(tch + p), __ldg(tpch + p), q);
      }  // a padded row is 0 and stays 0
#pragma unroll
      for (int i = 0; i < kLimbs; ++i)
        mid[i * kStripe + off] = static_cast<uint8_t>(v >> (8 * i));
    }
  }
  __syncthreads();

  // ── second product: each warp one column tile, every row tile ──
  const int n0 = warp * 8;
  for (int m0 = 0; m0 < rows; m0 += 16) {
    int acc[kFolds][4] = {};
    uint32_t a[kLimbs][4], b[kLimbs][2];
    if constexpr (!kInverse) {
      // out[r][a] = sum_b Y[r][b] Wc[a][b]: A = Y (shared), B = Wc (table)
      for (int kb = 0; kb < kLanes; kb += 32) {
        const int b0 = kb + 4 * t, b1 = b0 + 16;
        const uint8_t* y0 = smem + (b0 / width) * kSlot + b0 % width;
        const uint8_t* y1 = smem + (b1 / width) * kSlot + b1 % width;
#pragma unroll
        for (int i = 0; i < kLimbs; ++i) {
          a[i][0] = lds32(y0 + i * kStripe + (m0 + g) * width);
          a[i][1] = lds32(y0 + i * kStripe + (m0 + g + 8) * width);
          a[i][2] = lds32(y1 + i * kStripe + (m0 + g) * width);
          a[i][3] = lds32(y1 + i * kStripe + (m0 + g + 8) * width);
        }
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) {
          const uint8_t* wj = w2c + (j * kLanes + n0 + g) * kLanes + kb + 4 * t;
          b[j][0] = ldg32(wj);
          b[j][1] = ldg32(wj + 16);
        }
        mma_limbs(acc, a, b);
      }
    } else {
      // out[a][c] = sum_r Wr*[a][r] Y^T[c][r]: A = Wr* (table), B = Y^T
      for (int kb = 0; kb < rp; kb += 32) {
#pragma unroll
        for (int j = 0; j < kLimbs; ++j) {
          const uint8_t* wj = w2c + j * rp * rp + kb + 4 * t;
          a[j][0] = ldg32(wj + (m0 + g) * rp);
          a[j][1] = ldg32(wj + (m0 + g + 8) * rp);
          a[j][2] = ldg32(wj + (m0 + g) * rp + 16);
          a[j][3] = ldg32(wj + (m0 + g + 8) * rp + 16);
        }
        const int r0 = kb + 4 * t, r1 = r0 + 16;
        const uint8_t* y0 = smem + (r0 / 16) * kSlot + (n0 + g) * 16 + r0 % 16;
        const uint8_t* y1 = smem + (r1 / 16) * kSlot + (n0 + g) * 16 + r1 % 16;
#pragma unroll
        for (int i = 0; i < kLimbs; ++i) {
          b[i][0] = lds32(y0 + i * kStripe);
          b[i][1] = lds32(y1 + i * kStripe);
        }
        mma_limbs(acc, a, b);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + g + 8 * (e >> 1);
      const int col = n0 + 2 * t + (e & 1);
      if (row < rows) dst[row * kLanes + col] = fold_redc(acc, e, rs, q, qinv);
    }
  }
}

// ── the channel-run kernel (R <= kRunMaxRows) ────────────────────────────

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, col) in a limb plane or matrix limb with rows of
// kWidth bytes (32 .. 128): the row's 16-byte chunks XOR-permuted by the
// row, so that the eight rows x four consecutive words of a fragment load
// fall in 32 distinct banks.
template <int kWidth>
__device__ __forceinline__ int swz_run(int row, int col) {
  constexpr int kWords = kWidth >> 2;
  int x;
  if constexpr (kWords >= 32) {
    x = (row & 7) << 2;
  } else {
    x = ((row / (32 / kWords)) & ((kWords >> 2) - 1)) << 2;
  }
  return row * kWidth + (((col >> 2) ^ x) << 2) + (col & 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Byte i of lo and byte i of hi as one 16-bit store to each limb plane i.
__device__ __forceinline__ void store_pair(uint8_t* mid, int off, uint32_t lo, uint32_t hi) {
#pragma unroll
  for (int i = 0; i < kLimbs; ++i)
    *reinterpret_cast<uint16_t*>(mid + i * kStripe + off) =
        static_cast<uint16_t>(__byte_perm(lo, hi, i | ((4 + i) << 4)));
}

// The channel-run kernel's shapes and shared memory (bytes): S + kInSlot
// slots, the first and second product's matrix limbs (K x K each, the
// row contraction's K = Rp, the lane one's 128), two mbarriers and the
// fold constants rs[7], q, qinv.
template <int kLogRp, bool kInverse>
struct RunPlan {
  static constexpr int kRp = 1 << kLogRp;
  static constexpr int kStripes = kRp / 16;
  static constexpr int kWidth = kStripe / kRp;  // forward stripe columns
  static constexpr int kK1 = kInverse ? kLanes : kRp;
  static constexpr int kK2 = kInverse ? kRp : kLanes;
  static constexpr int kW1 = (kStripes + kInSlot) * kSlot;
  static constexpr int kW2 = kW1 + kLimbs * kK1 * kK1;
  static constexpr int kBars = kW2 + kLimbs * kK2 * kK2;
  static constexpr int kConsts = kBars + 16;
  static constexpr int kSmem = kConsts + 4 * (kFolds + 2);
};

// A channel's K x K limbs (4 of them, limb-major) into shared memory by
// 16-byte cp.async chunks, each row's chunks XOR-permuted (swz_run<K>).
template <int kK>
__device__ __forceinline__ void copy_matrix(uint8_t* dst, const uint8_t* src) {
  constexpr int kChunks = kLimbs * kK * kK / 16, kRowChunks = kK / 16;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const int limb = c / (kK * kRowChunks), within = c % (kK * kRowChunks);
    const int row = within / kRowChunks, chunk = within % kRowChunks;
    cp_async16(dst + limb * kK * kK + swz_run<kK>(row, chunk * 16), src + c * 16);
  }
}

template <int kLogRp, bool kInverse>
__global__ void __launch_bounds__(kThreads, 1)
ntt_mxu_run_kernel(const uint32_t* __restrict__ x, long long x_stride,
                   uint32_t* __restrict__ out, const uint8_t* __restrict__ w1,
                   const uint8_t* __restrict__ w2, const uint32_t* __restrict__ tw,
                   const uint32_t* __restrict__ twp, const uint32_t* __restrict__ rsv,
                   const uint32_t* __restrict__ qv, const uint32_t* __restrict__ qinvv,
                   int outer, int channels, int rows, int run) {
  using Plan = RunPlan<kLogRp, kInverse>;
  constexpr int kRp = Plan::kRp, kStripes = Plan::kStripes, kWidth = Plan::kWidth;
  constexpr int kK1 = Plan::kK1, kK2 = Plan::kK2;
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + Plan::kBars);
  uint32_t* consts = reinterpret_cast<uint32_t*>(smem + Plan::kConsts);
  const int runs = (outer + run - 1) / run;
  const int ch = static_cast<int>(blockIdx.x) / runs;
  const int first = (static_cast<int>(blockIdx.x) % runs) * run;
  const int last = min(outer, first + run);
  const int n = rows * kLanes;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const uint32_t* tch = tw + static_cast<long long>(ch) * n;
  const uint32_t* tpch = twp + static_cast<long long>(ch) * n;

  // the channel's constants, once a block
  copy_matrix<kK1>(smem + Plan::kW1, w1 + static_cast<long long>(ch) * kLimbs * kK1 * kK1);
  copy_matrix<kK2>(smem + Plan::kW2, w2 + static_cast<long long>(ch) * kLimbs * kK2 * kK2);
  if (threadIdx.x < kFolds) consts[threadIdx.x] = rsv[ch * kFolds + threadIdx.x];
  if (threadIdx.x == 0) {
    consts[kFolds] = qv[ch];
    consts[kFolds + 1] = qinvv[ch];
    mbar_init(&bars[0], kThreads);
    mbar_init(&bars[1], kThreads);
  }

  // the first product's tile of this warp
  const int m0 = kInverse ? 0 : (warp % (kRp / 16)) * 16;
  const int n0 = kInverse ? warp * 8 : (warp / (kRp / 16)) * 8;
  int stripe = 0;  // the block's stripes so far: stripe s on mbarrier s % 2, phase s / 2
  for (int item = first; item < last; ++item) {
    if (item != first) __syncthreads();  // the last plane's second product has read its slots
    // ── load: split into limbs, in the first product's operand layout ──
    // The inverse loads every word of its share before it splits any; the
    // forward one four-word group at a time (all at once, its kernel at R
    // = 128 spills 12 bytes and ran 2% slower, the inverse 3-5% faster;
    // tools/kernel_ab.py --paths mxu on an NVIDIA H100 80GB HBM3, 700 W).
    const uint32_t* src = x + item * x_stride + static_cast<long long>(ch) * n;
    constexpr int kLoads = 32 * kRp / kThreads;  // four-word groups a thread
    constexpr int kBatch = kInverse ? kLoads : 1;
    for (int it0 = 0; it0 < kLoads; it0 += kBatch) {
      uint32_t wd[kBatch][4];
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int idx = threadIdx.x + (it0 + it) * kThreads;
        // X^T (forward): 4 consecutive rows b of column c; X (inverse): 4
        // consecutive lanes b of row r
        const int c = idx % kLanes, b = 4 * (idx / kLanes);
        const int bi = 4 * (idx % 32), r = idx / 32;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (!kInverse) {
            wd[it][i] = b < rows ? src[(b + i) * kLanes + c] : 0;
          } else {
            wd[it][i] = r < rows ? src[r * kLanes + bi + i] : 0;
          }
        }
      }
#pragma unroll
      for (int it = 0; it < kBatch; ++it) {
        const int idx = threadIdx.x + (it0 + it) * kThreads;
        int off, slot;
        if constexpr (!kInverse) {
          const int c = idx % kLanes, b = 4 * (idx / kLanes);
          slot = kInSlot + c / kWidth;
          off = swz_run<kRp>(c % kWidth, b);
        } else {
          const int b = 4 * (idx % 32), r = idx / 32;
          slot = kInSlot + r / 16;
          off = swz_run<kLanes>(r % 16, b);
        }
        uint32_t limb[kLimbs];
        split4(wd[it], limb);
#pragma unroll
        for (int i = 0; i < kLimbs; ++i)
          *reinterpret_cast<uint32_t*>(smem + slot * kSlot + i * kStripe + off) = limb[i];
      }
    }
    if (item == first) cp_async_wait_all();
    __syncthreads();

    // ── first product: the warp's matrix rows held, stripe by stripe ──
    constexpr int kSteps1 = kK1 / 32;
    uint32_t held1[kSteps1][kLimbs][kInverse ? 2 : 4];
#pragma unroll
    for (int kk = 0; kk < kSteps1; ++kk) {
      const int kb = 32 * kk;
#pragma unroll
      for (int j = 0; j < kLimbs; ++j) {
        const uint8_t* wj = smem + Plan::kW1 + j * kK1 * kK1;
        if constexpr (!kInverse) {  // A = Wr rows m0.., K = rows of X
          held1[kk][j][0] = lds32(wj + swz_run<kK1>(m0 + g, kb + 4 * t));
          held1[kk][j][1] = lds32(wj + swz_run<kK1>(m0 + g + 8, kb + 4 * t));
          held1[kk][j][2] = lds32(wj + swz_run<kK1>(m0 + g, kb + 16 + 4 * t));
          held1[kk][j][3] = lds32(wj + swz_run<kK1>(m0 + g + 8, kb + 16 + 4 * t));
        } else {  // B = Wc* rows n0.., K = lanes of X
          held1[kk][j][0] = lds32(wj + swz_run<kK1>(n0 + g, kb + 4 * t));
          held1[kk][j][1] = lds32(wj + swz_run<kK1>(n0 + g, kb + 16 + 4 * t));
        }
      }
    }
    // stripe k's products (reading slot k + kInSlot), then its fold,
    // twist and middle limbs (written to slot k)
    auto products1 = [&](int(&acc)[kFolds][4], int k) {
      const uint8_t* in = smem + (k + kInSlot) * kSlot;
#pragma unroll
      for (int f = 0; f < kFolds; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][e] = 0;
#pragma unroll
      for (int kk = 0; kk < kSteps1; ++kk) {
        const int kb = 32 * kk;
        if constexpr (!kInverse) {
          // out[a][c] = sum_b Wr[a][b] X[b][c]: B = X^T (the stripe's columns)
          uint32_t b[kLimbs][2];
#pragma unroll
          for (int i = 0; i < kLimbs; ++i) {
            const uint8_t* xi = in + i * kStripe;
            b[i][0] = lds32(xi + swz_run<kRp>(n0 + g, kb + 4 * t));
            b[i][1] = lds32(xi + swz_run<kRp>(n0 + g, kb + 16 + 4 * t));
          }
          mma_limbs(acc, held1[kk], b);
        } else {
          // out[r][a] = sum_b X[r][b] Wc*[a][b]: A = X (the stripe's 16 rows)
          uint32_t a[kLimbs][4];
#pragma unroll
          for (int i = 0; i < kLimbs; ++i) {
            const uint8_t* xi = in + i * kStripe;
            a[i][0] = lds32(xi + swz_run<kLanes>(g, kb + 4 * t));
            a[i][1] = lds32(xi + swz_run<kLanes>(g + 8, kb + 4 * t));
            a[i][2] = lds32(xi + swz_run<kLanes>(g, kb + 16 + 4 * t));
            a[i][3] = lds32(xi + swz_run<kLanes>(g + 8, kb + 16 + 4 * t));
          }
          mma_limbs(acc, a, held1[kk]);
        }
      }
    };
    auto epilogue1 = [&](const int(&acc)[kFolds][4], int k) {
      uint32_t rs[kFolds];
#pragma unroll
      for (int f = 0; f < kFolds; ++f) rs[f] = consts[f];
      const uint32_t q = consts[kFolds], qinv = consts[kFolds + 1];
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = fold_redc(acc, e, rs, q, qinv);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = m0 + g + 8 * half, lc = n0 + 2 * t;
        const int row = kInverse ? 16 * k + lr : lr;
        const int col = kInverse ? lc : k * kWidth + lc;
        if (row < rows) {  // a padded row is 0 and stays 0
          const int p = row * kLanes + col;
          const uint2 tv = __ldg(reinterpret_cast<const uint2*>(tch + p));
          const uint2 tpv = __ldg(reinterpret_cast<const uint2*>(tpch + p));
          v[2 * half] = harvey(v[2 * half], tv.x, tpv.x, q);
          v[2 * half + 1] = harvey(v[2 * half + 1], tv.y, tpv.y, q);
        }
      }
      uint8_t* mid = smem + k * kSlot;
      if constexpr (!kInverse) {
        // Y (r, b): slot b / w, r * w + b % w; columns 2t, 2t + 1 adjacent
#pragma unroll
        for (int half = 0; half < 2; ++half)
          store_pair(mid, (m0 + g + 8 * half) * kWidth + n0 + 2 * t, v[2 * half],
                     v[2 * half + 1]);
      } else {
        // Y^T (c, r): slot r / 16, c * 16 + r % 16; rows g and g ^ 1 are
        // adjacent: the even-g lane keeps column 2t, the odd one 2t + 1
        const bool odd = g & 1;
        const uint32_t r0 = __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 4);
        const uint32_t r1 = __shfl_xor_sync(0xffffffffu, odd ? v[2] : v[3], 4);
        const int base = (n0 + 2 * t + odd) * 16 + (g & ~1);
        store_pair(mid, base, odd ? r0 : v[0], odd ? v[1] : r0);
        store_pair(mid, base + 8, odd ? r1 : v[2], odd ? v[3] : r1);
      }
    };
    // Slot k held stripe k - 2's input: before writing it a warp waits for
    // every warp's arrival on stripe k - 2, and it arrives on stripe k (on
    // mbarrier k % 2, whose phase k - 2 has then completed) once its
    // products have read slot k + kInSlot.
    for (int k = 0; k < kStripes; ++k, ++stripe) {
      int acc[kFolds][4];
      products1(acc, k);
      if (k >= 2) mbar_wait(&bars[stripe & 1], ((stripe - 2) >> 1) & 1);
      mbar_arrive(&bars[stripe & 1]);
      epilogue1(acc, k);
    }
    __syncthreads();

    // ── second product: each warp one column tile, its operand held ──
    uint32_t* dst = out + (static_cast<long long>(item) * channels + ch) * n;
    const int c0 = warp * 8;
    constexpr int kSteps2 = kK2 / 32;
    uint32_t held2[kSteps2][kLimbs][2];
#pragma unroll
    for (int kk = 0; kk < kSteps2; ++kk) {
      const int kb = 32 * kk;
#pragma unroll
      for (int i = 0; i < kLimbs; ++i) {
        if constexpr (!kInverse) {  // B = Wc rows c0..
          const uint8_t* wj = smem + Plan::kW2 + i * kK2 * kK2;
          held2[kk][i][0] = lds32(wj + swz_run<kK2>(c0 + g, kb + 4 * t));
          held2[kk][i][1] = lds32(wj + swz_run<kK2>(c0 + g, kb + 16 + 4 * t));
        } else {  // B = Y^T rows c0..: slot r / 16, c * 16 + r % 16
          const int r0 = kb + 4 * t, r1 = r0 + 16;
          held2[kk][i][0] = lds32(smem + (r0 / 16) * kSlot + i * kStripe + (c0 + g) * 16 + r0 % 16);
          held2[kk][i][1] = lds32(smem + (r1 / 16) * kSlot + i * kStripe + (c0 + g) * 16 + r1 % 16);
        }
      }
    }
    // a row tile's products, then its fold and 8-byte stores
    auto products2 = [&](int(&acc)[kFolds][4], int r0) {
#pragma unroll
      for (int f = 0; f < kFolds; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][e] = 0;
#pragma unroll
      for (int kk = 0; kk < kSteps2; ++kk) {
        const int kb = 32 * kk;
        uint32_t a[kLimbs][4];
        if constexpr (!kInverse) {
          // out[r][a] = sum_b Y[r][b] Wc[a][b]: A = Y
          const int b0 = kb + 4 * t, b1 = b0 + 16;
          const uint8_t* y0 = smem + (b0 / kWidth) * kSlot + b0 % kWidth;
          const uint8_t* y1 = smem + (b1 / kWidth) * kSlot + b1 % kWidth;
#pragma unroll
          for (int i = 0; i < kLimbs; ++i) {
            a[i][0] = lds32(y0 + i * kStripe + (r0 + g) * kWidth);
            a[i][1] = lds32(y0 + i * kStripe + (r0 + g + 8) * kWidth);
            a[i][2] = lds32(y1 + i * kStripe + (r0 + g) * kWidth);
            a[i][3] = lds32(y1 + i * kStripe + (r0 + g + 8) * kWidth);
          }
        } else {
          // out[a][c] = sum_r Wr*[a][r] Y^T[c][r]: A = Wr* rows r0..
#pragma unroll
          for (int j = 0; j < kLimbs; ++j) {
            const uint8_t* wj = smem + Plan::kW2 + j * kK2 * kK2;
            a[j][0] = lds32(wj + swz_run<kK2>(r0 + g, kb + 4 * t));
            a[j][1] = lds32(wj + swz_run<kK2>(r0 + g + 8, kb + 4 * t));
            a[j][2] = lds32(wj + swz_run<kK2>(r0 + g, kb + 16 + 4 * t));
            a[j][3] = lds32(wj + swz_run<kK2>(r0 + g + 8, kb + 16 + 4 * t));
          }
        }
        mma_limbs(acc, a, held2[kk]);
      }
    };
    auto store2 = [&](const int(&acc)[kFolds][4], int r0) {
      uint32_t rs[kFolds];
#pragma unroll
      for (int f = 0; f < kFolds; ++f) rs[f] = consts[f];
      const uint32_t q = consts[kFolds], qinv = consts[kFolds + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row < rows)
          *reinterpret_cast<uint2*>(dst + row * kLanes + c0 + 2 * t) =
              make_uint2(fold_redc(acc, 2 * half, rs, q, qinv),
                         fold_redc(acc, 2 * half + 1, rs, q, qinv));
      }
    };
    for (int r0 = 0; r0 < rows; r0 += 16) {
      int acc[kFolds][4];
      products2(acc, r0);
      store2(acc, r0);
    }
  }
}

// Planes a block of the channel-run kernel: kRunPlanes, or ceil(planes /
// SMs) so that the grid fills the card once; at most `outer`.
int run_planes(int outer, int channels, int* run) {
  int planes = kRunPlanes;
  if (planes <= 0) {
    int device = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(outer) * channels;
    planes = static_cast<int>((total + sms - 1) / sms);
  }
  *run = planes < 1 ? 1 : (planes > outer ? outer : planes);
  return 0;
}

// f(integral_constant<log2 Rp>) for the channel-run kernel of R rows.
template <typename F>
int run_dispatch(int rows, F f) {
  if (rows <= 32) return f(std::integral_constant<int, 5>{});
  if (rows == 64) return f(std::integral_constant<int, 6>{});
  return f(std::integral_constant<int, 7>{});
}

template <int kLogRp, bool kInverse>
const void* run_kernel() {
  return reinterpret_cast<const void*>(ntt_mxu_run_kernel<kLogRp, kInverse>);
}

template <bool kInverse>
int launch_run(const uint32_t* x, long long x_stride, uint32_t* out, const uint8_t* w1,
               const uint8_t* w2, const uint32_t* tw, const uint32_t* twp, const uint32_t* rs,
               const uint32_t* q, const uint32_t* qinv, int outer, int channels, int rows,
               cudaStream_t stream) {
  int run = 1;
  const int err = run_planes(outer, channels, &run);
  if (err != 0) return err;
  const int runs = (outer + run - 1) / run;
  return run_dispatch(rows, [&](auto log_rp) -> int {
    constexpr int kLogRp = decltype(log_rp)::value;
    constexpr int kSmem = RunPlan<kLogRp, kInverse>::kSmem;
    const cudaError_t e = cudaFuncSetAttribute(run_kernel<kLogRp, kInverse>(),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ntt_mxu_run_kernel<kLogRp, kInverse><<<channels * runs, kThreads, kSmem, stream>>>(
        x, x_stride, out, w1, w2, tw, twp, rs, q, qinv, outer, channels, rows, run);
    return static_cast<int>(cudaGetLastError());
  });
}

template <bool kInverse>
int launch(const uint32_t* x, long long x_stride, uint32_t* out,
           const uint8_t* w1, const uint8_t* w2, const uint32_t* tw,
           const uint32_t* twp, const uint32_t* rs, const uint32_t* q,
           const uint32_t* qinv, int outer, int channels, int rows,
           cudaStream_t stream) {
  const int rp = rows < 32 ? 32 : rows;
  const size_t smem = static_cast<size_t>(rp / 16 + 1) * kSlot;
  auto* kernel = ntt_mxu_kernel<kInverse>;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<outer * channels, kThreads, smem, stream>>>(
      x, x_stride, out, w1, w2, tw, twp, rs, q, qinv, outer, channels, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (outer, channels, R * 128) uint32 words with item stride x_stride
// (elements); out: contiguous, the same shape; w1 / w2: uint8 (channels, 4,
// K, K) limbs of the first / second matrix (the row contraction's K =
// max(R, 32), zero-padded; the lane contraction's 128); tw / twp:
// (channels, R * 128) twist and Shoup companions; rs: (channels, 7) fold
// constants; q / qinv: (channels,). R a power of two in [8, 256]. Returns
// the launch's error code (0 on success).
extern "C" int ckks_ntt_mxu(const uint32_t* x, long long x_stride,
                            uint32_t* out, const uint8_t* w1,
                            const uint8_t* w2, const uint32_t* tw,
                            const uint32_t* twp, const uint32_t* rs,
                            const uint32_t* q, const uint32_t* qinv,
                            int outer, int channels, int rows, int inverse,
                            cudaStream_t stream) {
  if (rows < 8 || rows > 256 || (rows & (rows - 1)) != 0 || outer < 1 ||
      channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= kRunMaxRows)
    return inverse ? launch_run<true>(x, x_stride, out, w1, w2, tw, twp, rs, q, qinv, outer,
                                      channels, rows, stream)
                   : launch_run<false>(x, x_stride, out, w1, w2, tw, twp, rs, q, qinv, outer,
                                       channels, rows, stream);
  return inverse ? launch<true>(x, x_stride, out, w1, w2, tw, twp, rs, q, qinv,
                                outer, channels, rows, stream)
                 : launch<false>(x, x_stride, out, w1, w2, tw, twp, rs, q,
                                 qinv, outer, channels, rows, stream);
}

// The kernel ckks_ntt_mxu launches for (outer, channels, R): info[0..7] =
// form (1 the channel-run kernel, 0 the plane-per-block one), planes a
// block, blocks, registers a thread, local (spill) bytes a thread,
// threads a block, dynamic shared bytes a block, blocks resident an SM.
extern "C" int ckks_ntt_mxu_info(int outer, int channels, int rows, int inverse, int* info) {
  if (rows < 8 || rows > 256 || (rows & (rows - 1)) != 0 || outer < 1 || channels < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel;
  int smem, run = 1;
  if (rows <= kRunMaxRows) {
    const int err = run_planes(outer, channels, &run);
    if (err != 0) return err;
    run_dispatch(rows, [&](auto log_rp) -> int {
      constexpr int kLogRp = decltype(log_rp)::value;
      kernel = inverse ? run_kernel<kLogRp, true>() : run_kernel<kLogRp, false>();
      smem = inverse ? RunPlan<kLogRp, true>::kSmem : RunPlan<kLogRp, false>::kSmem;
      return 0;
    });
  } else {
    kernel = inverse ? reinterpret_cast<const void*>(ntt_mxu_kernel<true>)
                     : reinterpret_cast<const void*>(ntt_mxu_kernel<false>);
    smem = (rows / 16 + 1) * kSlot;
  }
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  cudaFuncAttributes attr;
  int resident = 0;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int runs = (outer + run - 1) / run;
  info[0] = rows <= kRunMaxRows;
  info[1] = rows <= kRunMaxRows ? run : 1;
  info[2] = rows <= kRunMaxRows ? channels * runs : outer * channels;
  info[3] = attr.numRegs;
  info[4] = static_cast<int>(attr.localSizeBytes);
  info[5] = kThreads;
  info[6] = smem;
  info[7] = resident;
  return 0;
}
