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
// One block of 16 warps owns one (channel, item) plane; the grid is
// channel-major, so the blocks of one channel run together and its tables
// (the u8 limbs of both matrices, T and its Shoup companions) stay in L2.
// The block splits its plane into four u8 limb planes in shared memory,
// laid out as the first product's mma operand (transposed where the
// contracted axis is the row axis: ldmatrix.trans does not take 8-bit
// elements). The first product runs stripe by stripe: S = Rp / 16 stripes
// of 2048 outputs, one m16n8 tile per warp, Rp = max(R, 32) the row count
// padded with zeros to the mma depth. A stripe's outputs are folded,
// reduced, twisted by T and split into limbs in the second product's
// operand layout, written over the slot that held the previous stripe's
// input (S + 1 slots of 8 KiB: 136 KiB at N = 2^15, where two full limb
// copies of the plane would not fit). The second product reads those
// limbs and writes the folded words to device memory. Matrix fragments are
// read from the tables in device memory (L1/L2).
//
// What bounds it on an H100: the work is 16 * N * (R + 128) u8 MACs per
// plane on the tensor cores and ~50 32-bit integer instructions per word
// (each product's seven 64-bit multiply-adds and REDC, the twist, the limb
// split and scatter); from R = 64 up the MACs set the least time at the
// dense int8 rate. This first version does not reach it: it is bound by
// latency, each mma.sync waiting on 32-bit operand loads (the matrix limbs
// from L1/L2, the data limbs from shared memory) with one block of 16
// warps per SM, and a barrier per stripe. wgmma with TMA-staged operands
// is the form that would approach the tensor rate.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLimbs = 4;
constexpr int kFolds = 2 * kLimbs - 1;
constexpr int kLanes = 128;           // C: the lane axis of every plane
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStripe = 2048;         // bytes of one limb of one stripe
constexpr int kSlot = kLimbs * kStripe;

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
  return inverse ? launch<true>(x, x_stride, out, w1, w2, tw, twp, rs, q, qinv,
                                outer, channels, rows, stream)
                 : launch<false>(x, x_stride, out, w1, w2, tw, twp, rs, q,
                                 qinv, outer, channels, rows, stream);
}
