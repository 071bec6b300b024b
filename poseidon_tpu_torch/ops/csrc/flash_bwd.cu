// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of
// softmax(q k^T * scale) v over (B*H, S, D) row-major tensors, recomputing
// the probabilities tile by tile from the saved per-row logsumexp, so the
// (S, S) score matrix never reaches device memory.
//
// Replaces two Pallas TPU kernels of poseidon_tpu/ops/pallas_kernels.py,
// both reached through _flash_bwd (the backward of flash_attention and of
// the ring's per-chunk step):
//   _flash_dq_kernel  -> flash_dq_kernel  (one block per query tile)
//   _flash_dkv_kernel -> flash_dkv_kernel (one block per key tile: the
//                                          TPU kernel's swapped grid)
//
//   s[i,j]  = (q[i] . k[j]) * scale, masked to NEG_INF = -1e30 where a
//             causal row may not see column j (ring chunks: `mode` +1 all
//             live, 0 the in-chunk triangle, -1 all masked)
//   p[i,j]  = exp(s[i,j] - lse[i])
//   dp[i,j] = dO[i] . v[j]
//   ds[i,j] = p[i,j] * (dp[i,j] - delta[i]) * scale
//   dq[i]   = sum_j ds[i,j] k[j]
//   dk[j]   = sum_i ds[i,j] q[i],      dv[j] = sum_i p[i,j] dO[i]
//
// delta[i] = rowsum(dO[i] * out[i]) is computed by the caller (the JAX
// package computes it in XLA, outside the kernels) or passed in by the
// ring backward. A fully masked row (mode -1) has lse = -1e30 + log S,
// which is -1e30 in f32, so its p is exp(0) = 1 for every key, exactly as
// the TPU kernel computes it. Loads f32 or bf16, accumulates in f32, stores
// dq, dk, dv in the input dtype.
//
// Bound: operations. dQ does three S x S x D products per (b, h) (s, dp,
// ds k), dK/dV four (s, dp, p^T dO, ds^T q), halved when causal, against
// reading q, k, v, dO, lse and delta and writing one or two (S, D)
// outputs once each. At gpt_small's training shape (8, 12, 1024, 64)
// causal that is 19.3 GFLOP for dQ and 25.8 GFLOP for dK/dV. f32 runs each
// product as three TF32 products (below), so its least time is 3 x ops
// over the H100's 495 TFLOP/s TF32 rate: 0.117 ms (dQ) and 0.156 ms
// (dK/dV); at the 67 TFLOP/s of f32 outside the tensor cores they would be
// 0.289 and 0.385 ms. bf16 runs at the 989 TFLOP/s bf16 rate.
//
// Design. The JAX package runs these products at Precision.HIGHEST under
// its f32 policy, a multi-pass emulation of f32 on the TPU's matrix unit;
// this port does the same on Hopper's tensor cores and never runs a
// single TF32 pass:
//
// 1. Tensor cores, not FMAs. Every S x S x D product is a warp-level
//    mma.sync. f32: m16n8k8 TF32 as 3xTF32 (CUTLASS's FastF32): each
//    operand x is split into big = rna(x), rounded as cvt.rna.tf32 rounds
//    (an integer add and mask, which is what cvt.rna compiles to), and the
//    remainder small = x - big, which the tensor core reads truncated to
//    TF32; the products are summed small*big + big*small, then big*big.
//    The tensor core truncates its own f32 sums, so a long chain of MMAs on
//    one accumulator drifts toward zero: it sums at most two k8 steps (one
//    for dq, dk, dv) from zero, and each partial sum goes into the f32
//    accumulator with one rounded add. On the card the result is closer
//    to an f64 backward than the plain f32 version is.
//    bf16: m16n8k16 with f32 accumulation; q, k, v, dO enter as they are,
//    and p and ds, f32 in the accumulators, enter the second products as a
//    bf16 big part and a bf16 small remainder (two MMAs): rounded once they
//    miss the bf16 tolerance (tests/test_torch_flash_bwd_route.py).
// 2. Fragments, not scalars. A block is 4 warps, each owning 16 rows of
//    the block's 64-row tile (query rows in dQ, key rows in dK/dV). dQ
//    computes S = Q K^T and dP = dO V^T as m16n8 accumulators; dK/dV
//    computes S^T = K Q^T and dP^T = V dO^T directly, so p^T and ds^T come
//    out with key rows (lse and delta, per query, index the accumulators'
//    columns). An accumulator tile becomes the A operand of the second
//    product in registers, with no shuffle and no trip through shared
//    memory: for bf16 the layouts agree (FlashAttention-2's trick); for
//    TF32 the accumulator holds columns 2t and 2t+1 where the A operand
//    wants t and t+4, so the contraction index is permuted within each
//    8-column step and the B operand is loaded with the same permutation.
//    Shared rows are padded by 16 bytes (D + 4 floats, D + 8 bf16), which
//    makes every fragment load, and every ldmatrix row, free of bank
//    conflicts.
// 3. Copies overlap compute. The streamed tiles (K and V for dQ; Q, dO,
//    lse and delta for dK/dV) go through a two-stage ring loaded with
//    16-byte cp.async.cg (4-byte cp.async for lse and delta): tile n+1
//    lands while tile n computes. The zero-fill form writes zeros for rows
//    past S and for columns D..DMAX, so padding adds exactly nothing. When
//    D is not a multiple of 16 bytes the tiles are copied synchronously.
// 4. bf16 on bf16 tensor cores: tiles stay bf16 in shared memory (half the
//    bytes), and the B operands of the second products come through
//    ldmatrix.trans.
//
// Tiles: 64 own rows; streamed tiles of 32 rows in f32 and of 64 in bf16
// (32 at D = 128), so the register-held accumulators fit (dK/dV holds two
// 16 x D f32 accumulators a warp) and two blocks stay resident on an SM.
// The grid is (B*H, tiles) with the tile index on
// the slower axis, ordered so that the blocks with the most causal work
// start first: dQ's last query tiles, dK/dV's first key tiles. When causal
// and not chunked, dQ skips key tiles wholly above the diagonal and dK/dV
// skips query tiles that end before its key tile starts (the TPU kernels'
// block_live). Rows and keys past S are masked (scores past S are -inf, so
// they add exactly nothing), so any S >= 1 works; D up to 128. Each block
// owns its output tile: no atomics, and the result is the same from run to
// run.
//
// The kernels allocate nothing and launch on the caller's stream; each C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch. poseidon_flash_bwd_attrs reports each instantiation's registers,
// shared memory, spills and resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kOwn = 16 * kWarps;  // rows of the block's own tile
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

// k8 steps of the f32 s and dp products that the tensor core sums before
// one rounded f32 add (see add_partial): 2, or 1 at D = 128, where the
// partial sums' registers would spill
template <int DMAX>
struct FirstChain {
  static constexpr int value = DMAX > 64 ? 1 : 2;
};

template <typename T, int DMAX>
struct Layout {
  // streamed rows: f32 keeps two 16 x kStream score tiles and the chained
  // partial sums of the first products in registers beside its output
  // accumulators, so it streams 32 rows; bf16 64 (32 for D = 128)
  static constexpr int kStream =
      sizeof(T) == 4 ? 32 : (DMAX <= 64 ? 64 : 32);
  static constexpr int kStride = DMAX + 16 / (int)sizeof(T);  // elements
  static constexpr int kOwnElems = kOwn * kStride;
  static constexpr int kStreamElems = kStream * kStride;
  // own tile pair (q, dO or k, v), then two stages of the streamed pair
  static constexpr size_t kTileBytes =
      sizeof(T) * (size_t)(2 * kOwnElems + 4 * kStreamElems);
  static constexpr size_t kDqBytes = kTileBytes;
  // dK/dV also streams lse and delta, two stages
  static constexpr size_t kDkvBytes =
      kTileBytes + sizeof(float) * (size_t)(4 * kStream);
};

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid
// (src is then never read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a (S, D) slice into shared memory at the
// layout's stride, zero past S and in columns D..DMAX.
template <typename T, int DMAX, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int S, int D, int vec) {
  constexpr int kStride = Layout<T, DMAX>::kStride;
  if (vec) {
    constexpr int kVec = 16 / (int)sizeof(T);
    constexpr int kChunks = DMAX / kVec;
    for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int d = (idx - r * kChunks) * kVec;
      const int row = row0 + r;
      const bool ok = row < S && d < D;
      cp_async16(dst + r * kStride + d, ok ? src + (int64_t)row * D + d : src,
                 ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DMAX; idx += kThreads) {
      const int r = idx / DMAX;
      const int d = idx - r * DMAX;
      const int row = row0 + r;
      dst[r * kStride + d] = (row < S && d < D) ? src[(int64_t)row * D + d]
                                                : from_f32<T>(0.0f);
    }
  }
}

// lse or delta of rows [row0, row0 + ROWS), zero past S
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int S) {
  for (int r = threadIdx.x; r < ROWS; r += kThreads) {
    const bool ok = row0 + r < S;
    cp_async4(dst + r, ok ? src + row0 + r : src, ok);
  }
}

// The scaled score of (query row, key col), masked as the TPU kernels mask
// it (_causal_mask), or -inf past the sequence (exactly no weight).
__device__ __forceinline__ float masked_score(float dot, float scale, int row,
                                              int col, int S, int causal,
                                              int chunk, int mode) {
  if (row >= S || col >= S) return -INFINITY;
  const float x = dot * scale;
  if (!causal) return x;
  const bool live =
      chunk ? (mode > 0 || (mode == 0 && row >= col)) : row >= col;
  return live ? x : kNegInf;
}

// ---- f32: m16n8k8 TF32, three passes --------------------------------------

// x as a TF32 big part rna(x) (cvt.rna.tf32.f32's integer add and mask)
// and the exact remainder x - big, at most 2^-11 |x|, which the tensor core
// reads truncated to TF32: big + small is within 2^-21 |x| of x, and the
// dropped small*small term is below 2^-22 of the product.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b over one k8 step in 3xTF32 on the tensor core: small*big +
// big*small first, then big*big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// The tensor core truncates its f32 sums (rounds toward zero), so a long
// chain of MMAs on one accumulator drifts toward zero in proportion to its
// length. The kernels sum a few k8 steps on the tensor core, from zero,
// and add each such partial sum into the f32 accumulator with one rounded
// add: the s and dp products every kFirstChain steps, the dq, dk and dv
// products every step.
__device__ __forceinline__ void add_partial(float (&c)[4],
                                            const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// c1 = A B^T and c2 = A2 B2^T over d: A, A2 the warp's 16 own rows (from
// r0), B, B2 the streamed tile's NT*8 rows, all (rows, DMAX) at stride st.
// A fragment: rows g, g+8, columns t, t+4; B fragment: row (n) g, columns
// (k) t, t+4; accumulator c[nt]: rows g, g+8, columns 8 nt + 2t, 2t+1.
template <int DMAX, int NT>
__device__ __forceinline__ void first_products(
    const float* sA, const float* sB, const float* sA2, const float* sB2,
    int st, int r0, int lane, float (&c1)[NT][4], float (&c2)[NT][4]) {
  constexpr int kFirstChain = FirstChain<DMAX>::value;
  static_assert(DMAX % (8 * kFirstChain) == 0, "chain must divide DMAX");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[nt][e] = c2[nt][e] = 0.0f;
#pragma unroll
  for (int dc = 0; dc < DMAX; dc += 8 * kFirstChain) {
    float t1[NT][4], t2[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) t1[nt][e] = t2[nt][e] = 0.0f;
#pragma unroll
    for (int d0 = dc; d0 < dc + 8 * kFirstChain; d0 += 8) {
      uint32_t ab[4], as[4], a2b[4], a2s[4];
      const float* pa = sA + (r0 + g) * st + d0 + t;
      const float* pa2 = sA2 + (r0 + g) * st + d0 + t;
      split_tf32(pa[0], ab[0], as[0]);
      split_tf32(pa[8 * st], ab[1], as[1]);
      split_tf32(pa[4], ab[2], as[2]);
      split_tf32(pa[8 * st + 4], ab[3], as[3]);
      split_tf32(pa2[0], a2b[0], a2s[0]);
      split_tf32(pa2[8 * st], a2b[1], a2s[1]);
      split_tf32(pa2[4], a2b[2], a2s[2]);
      split_tf32(pa2[8 * st + 4], a2b[3], a2s[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* pb = sB + (nt * 8 + g) * st + d0 + t;
        const float* pb2 = sB2 + (nt * 8 + g) * st + d0 + t;
        uint32_t bb[2], bs[2], b2b[2], b2s[2];
        split_tf32(pb[0], bb[0], bs[0]);
        split_tf32(pb[4], bb[1], bs[1]);
        split_tf32(pb2[0], b2b[0], b2s[0]);
        split_tf32(pb2[4], b2b[1], b2s[1]);
        mma_3xtf32(t1[nt], ab, as, bb, bs);
        mma_3xtf32(t2[nt], a2b, a2s, b2b, b2s);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      add_partial(c1[nt], t1[nt]);
      add_partial(c2[nt], t2[nt]);
    }
  }
}

// acc += A B: A (16 x NT*8) in accumulator layout, B the streamed tile's
// NT*8 rows x DMAX. The contraction index is permuted within each step of
// 8: A's columns 2t, 2t+1 (the accumulator's) stand where m16n8k8 reads t,
// t+4, and B's rows 2t, 2t+1 are loaded in the same places.
template <int DMAX, int NT>
__device__ __forceinline__ void second_product(const float (&a)[NT][4],
                                               const float* sB, int st,
                                               int lane,
                                               float (&acc)[DMAX / 8][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    uint32_t ab[4], as[4];
    split_tf32(a[kk][0], ab[0], as[0]);  // row g,   column 2t
    split_tf32(a[kk][2], ab[1], as[1]);  // row g+8, column 2t
    split_tf32(a[kk][1], ab[2], as[2]);  // row g,   column 2t+1
    split_tf32(a[kk][3], ab[3], as[3]);  // row g+8, column 2t+1
    const float* pb = sB + (kk * 8 + 2 * t) * st + g;
#pragma unroll
    for (int nd = 0; nd < DMAX / 8; ++nd) {
      uint32_t bb[2], bs[2];
      split_tf32(pb[nd * 8], bb[0], bs[0]);
      split_tf32(pb[nd * 8 + st], bb[1], bs[1]);
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_3xtf32(part, ab, as, bb, bs);
      add_partial(acc[nd], part);
    }
  }
}

// ---- bf16: m16n8k16 --------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (lo, hi) as a bf16 pair big = rn(x) and small = rn(x - big)
__device__ __forceinline__ void split_bf16x2(float lo, float hi,
                                             uint32_t& big, uint32_t& small) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  const float2 bf = __bfloat1622float2(b);
  big = bf16x2_bits(b);
  small = bf16x2_bits(__floats2bfloat162_rn(lo - bf.x, hi - bf.y));
}

// four 8x8 b16 matrices, transposed: the B fragments of two n8 tiles
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// As the f32 version: A fragment rows g, g+8, column pairs 2t and 2t+8;
// B fragment row (n) g, column (k) pairs 2t and 2t+8.
template <int DMAX, int NT>
__device__ __forceinline__ void first_products(
    const bf16* sA, const bf16* sB, const bf16* sA2, const bf16* sB2, int st,
    int r0, int lane, float (&c1)[NT][4], float (&c2)[NT][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[nt][e] = c2[nt][e] = 0.0f;
#pragma unroll
  for (int d0 = 0; d0 < DMAX; d0 += 16) {
    const bf16* pa = sA + (r0 + g) * st + d0 + 2 * t;
    const bf16* pa2 = sA2 + (r0 + g) * st + d0 + 2 * t;
    const uint32_t a[4] = {ld_u32(pa), ld_u32(pa + 8 * st), ld_u32(pa + 8),
                           ld_u32(pa + 8 * st + 8)};
    const uint32_t a2[4] = {ld_u32(pa2), ld_u32(pa2 + 8 * st),
                            ld_u32(pa2 + 8), ld_u32(pa2 + 8 * st + 8)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* pb = sB + (nt * 8 + g) * st + d0 + 2 * t;
      const bf16* pb2 = sB2 + (nt * 8 + g) * st + d0 + 2 * t;
      mma_bf16(c1[nt], a, ld_u32(pb), ld_u32(pb + 8));
      mma_bf16(c2[nt], a2, ld_u32(pb2), ld_u32(pb2 + 8));
    }
  }
}

// acc += A B with A (f32 accumulators) split into bf16 big and small:
// accumulator tiles 2kk and 2kk+1 are m16n8k16's A fragment as they are.
template <int DMAX, int NT>
__device__ __forceinline__ void second_product(const float (&a)[NT][4],
                                               const bf16* sB, int st,
                                               int lane,
                                               float (&acc)[DMAX / 8][4]) {
  // ldmatrix: lanes 8m..8m+7 address matrix m's rows: k rows (m & 1) * 8,
  // n columns (m >> 1) * 8
  const bf16* rows =
      sB + ((lane & 7) + ((lane >> 3) & 1) * 8) * st + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t ab[4], as[4];
    split_bf16x2(a[2 * kk][0], a[2 * kk][1], ab[0], as[0]);
    split_bf16x2(a[2 * kk][2], a[2 * kk][3], ab[1], as[1]);
    split_bf16x2(a[2 * kk + 1][0], a[2 * kk + 1][1], ab[2], as[2]);
    split_bf16x2(a[2 * kk + 1][2], a[2 * kk + 1][3], ab[3], as[3]);
#pragma unroll
    for (int nd = 0; nd < DMAX / 16; ++nd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, rows + kk * 16 * st + nd * 16);
      mma_bf16(acc[2 * nd], as, b[0], b[1]);
      mma_bf16(acc[2 * nd], ab, b[0], b[1]);
      mma_bf16(acc[2 * nd + 1], as, b[2], b[3]);
      mma_bf16(acc[2 * nd + 1], ab, b[2], b[3]);
    }
  }
}

// ---- the kernels -----------------------------------------------------------

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int D, float scale, int causal, int chunk,
                    int mode, int vec) {
  using L = Layout<T, DMAX>;
  constexpr int kStream = L::kStream;
  constexpr int NT = kStream / 8;
  constexpr int ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sG = sQ + L::kOwnElems;
  T* sRing = sG + L::kOwnElems;  // stage s: k at 2s, v at 2s+1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  // the last query tiles carry the most causal work: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int64_t rbase = (int64_t)blockIdx.x * S;
  const T* kb = k + base;
  const T* vb = v + base;

  // causal self-attention: key tiles wholly above the diagonal contribute
  // nothing; chunked liveness depends on `mode` and is left to the mask
  int n_kt = (S + kStream - 1) / kStream;
  if (causal && !chunk) n_kt = min(n_kt, (min(q0 + kOwn, S) - 1) / kStream + 1);

  load_tile<T, DMAX, kOwn>(sQ, q + base, q0, S, D, vec);
  load_tile<T, DMAX, kOwn>(sG, g + base, q0, S, D, vec);
  load_tile<T, DMAX, kStream>(sRing, kb, 0, S, D, vec);
  load_tile<T, DMAX, kStream>(sRing + L::kStreamElems, vb, 0, S, D, vec);
  cp_async_commit();

  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + (lane >> 2) + 8 * h;
    lse_r[h] = row < S ? lse[rbase + row] : 0.0f;
    delta_r[h] = row < S ? delta[rbase + row] : 0.0f;
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) {
      T* next = sRing + ((kt + 1) & 1) * 2 * L::kStreamElems;
      load_tile<T, DMAX, kStream>(next, kb, (kt + 1) * kStream, S, D, vec);
      load_tile<T, DMAX, kStream>(next + L::kStreamElems, vb,
                                  (kt + 1) * kStream, S, D, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sK = sRing + (kt & 1) * 2 * L::kStreamElems;
    const T* sV = sK + L::kStreamElems;
    const int k0 = kt * kStream;

    float s[NT][4], dp[NT][4];
    first_products<DMAX, NT>(sQ, sK, sG, sV, L::kStride, r0, lane, s, dp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int row = q0 + r0 + (lane >> 2) + 8 * h;
        const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const float x =
            masked_score(s[nt][e], scale, row, col, S, causal, chunk, mode);
        const float p = expf(x - lse_r[h]);
        s[nt][e] = p * (dp[nt][e] - delta_r[h]) * scale;  // ds
      }
    second_product<DMAX, NT>(s, sK, L::kStride, lane, acc);  // dq += ds k
    __syncthreads();  // this stage is refilled next iteration
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + r0 + (lane >> 2) + 8 * (e >> 1);
      const int d = nd * 8 + 2 * (lane & 3) + (e & 1);
      if (row < S && d < D)
        dq[base + (int64_t)row * D + d] = from_f32<T>(acc[nd][e]);
    }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int D, float scale,
                     int causal, int chunk, int mode, int vec) {
  using L = Layout<T, DMAX>;
  constexpr int kStream = L::kStream;
  constexpr int NT = kStream / 8;
  constexpr int ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + L::kOwnElems;
  T* sRing = sV + L::kOwnElems;  // stage s: q at 2s, dO at 2s+1
  float* sRows = reinterpret_cast<float*>(sRing + 4 * L::kStreamElems);
  // stage s: lse at sRows + 2s * kStream, delta after it

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16;
  // the first key tiles carry the most causal work and start first
  const int k0 = blockIdx.y * kOwn;
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const int64_t rbase = (int64_t)blockIdx.x * S;
  const T* qb = q + base;
  const T* gb = g + base;

  // causal self-attention: query tiles that end before this key tile
  // starts see none of its keys
  const int n_qt = (S + kStream - 1) / kStream;
  const int qt0 = (causal && !chunk) ? k0 / kStream : 0;

  load_tile<T, DMAX, kOwn>(sK, k + base, k0, S, D, vec);
  load_tile<T, DMAX, kOwn>(sV, v + base, k0, S, D, vec);
  load_tile<T, DMAX, kStream>(sRing, qb, qt0 * kStream, S, D, vec);
  load_tile<T, DMAX, kStream>(sRing + L::kStreamElems, gb, qt0 * kStream, S,
                              D, vec);
  load_rows<kStream>(sRows, lse + rbase, qt0 * kStream, S);
  load_rows<kStream>(sRows + kStream, delta + rbase, qt0 * kStream, S);
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nd][e] = acc_v[nd][e] = 0.0f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int stage = (qt - qt0) & 1;
    if (qt + 1 < n_qt) {
      const int nxt = stage ^ 1;
      const int row0 = (qt + 1) * kStream;
      T* tiles = sRing + nxt * 2 * L::kStreamElems;
      float* rows = sRows + nxt * 2 * kStream;
      load_tile<T, DMAX, kStream>(tiles, qb, row0, S, D, vec);
      load_tile<T, DMAX, kStream>(tiles + L::kStreamElems, gb, row0, S, D,
                                  vec);
      load_rows<kStream>(rows, lse + rbase, row0, S);
      load_rows<kStream>(rows + kStream, delta + rbase, row0, S);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* sQ = sRing + stage * 2 * L::kStreamElems;
    const T* sG = sQ + L::kStreamElems;
    const float* sLse = sRows + stage * 2 * kStream;
    const float* sDelta = sLse + kStream;
    const int q0 = qt * kStream;

    // transposed tiles: s[nt][e] is the score of key row k0 + r0 + g (+8)
    // against query column q0 + 8 nt + 2t (+1), dp likewise
    float s[NT][4], dp[NT][4];
    first_products<DMAX, NT>(sK, sQ, sV, sG, L::kStride, r0, lane, s, dp);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int krow = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
        const int qc = nt * 8 + 2 * (lane & 3) + (e & 1);
        const float x = masked_score(s[nt][e], scale, q0 + qc, krow, S,
                                     causal, chunk, mode);
        const float p = expf(x - sLse[qc]);
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - sDelta[qc]) * scale;  // ds
      }
    second_product<DMAX, NT>(s, sG, L::kStride, lane, acc_v);   // p^T dO
    second_product<DMAX, NT>(dp, sQ, L::kStride, lane, acc_k);  // ds^T q
    __syncthreads();  // this stage is refilled next iteration
  }

#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = k0 + r0 + (lane >> 2) + 8 * (e >> 1);
      const int d = nd * 8 + 2 * (lane & 3) + (e & 1);
      if (row < S && d < D) {
        dk[base + (int64_t)row * D + d] = from_f32<T>(acc_k[nd][e]);
        dv[base + (int64_t)row * D + d] = from_f32<T>(acc_v[nd][e]);
      }
    }
}

// Opt in to more than 48 KB of dynamic shared memory (the attribute is per
// device, so it is set per launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* lse;
  const float* delta;
  void* out0;  // dq, or dk
  void* out1;  // dv (dK/dV only)
  int bh, s, d;
  float scale;
  int causal, chunk, mode;
  cudaStream_t stream;
};

// 16-byte copies need every row of q, k, v, dO on a 16-byte boundary
template <typename T>
int vector_ok(const Args& a) {
  const uintptr_t addr = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v |
                         (uintptr_t)a.g;
  return (a.d * (int)sizeof(T)) % 16 == 0 && addr % 16 == 0;
}

// (B*H, tiles of 64 own rows): the tile index on the slower axis, so each
// tile rank starts across every (b, h) before the next
dim3 grid_of(const Args& a) {
  return dim3((unsigned int)a.bh,
              (unsigned int)((a.s + kOwn - 1) / kOwn));
}

template <typename T, int DMAX>
int launch_dq(const Args& a) {
  constexpr size_t bytes = Layout<T, DMAX>::kDqBytes;
  auto kernel = flash_dq_kernel<T, DMAX>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      static_cast<T*>(a.out0), a.s, a.d, a.scale, a.causal, a.chunk, a.mode,
      vector_ok<T>(a));
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const Args& a) {
  constexpr size_t bytes = Layout<T, DMAX>::kDkvBytes;
  auto kernel = flash_dkv_kernel<T, DMAX>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(a), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.s, a.d, a.scale,
      a.causal, a.chunk, a.mode, vector_ok<T>(a));
  return (int)cudaGetLastError();
}

template <typename T, bool kDq>
int dispatch_d(const Args& a) {
  if (a.d <= 32) return kDq ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
  if (a.d <= 64) return kDq ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
  if (a.d <= 128) return kDq ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
  return (int)cudaErrorInvalidValue;
}

template <bool kDq>
int dispatch(int dtype, const Args& a) {
  if (a.bh < 1 || a.bh > 65535 || a.s < 1 || a.d < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float, kDq>(a);
  if (dtype == 1) return dispatch_d<bf16, kDq>(a);
  return (int)cudaErrorInvalidValue;
}

// out: registers a thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes a thread, threads a block, resident blocks per SM,
// own-tile rows, streamed-tile rows
template <typename Kernel>
int attrs_of(Kernel kernel, size_t bytes, int stream_rows, int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)bytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = kThreads;
  out[5] = blocks;
  out[6] = kOwn;
  out[7] = stream_rows;
  return 0;
}

template <typename T, int DMAX>
int attrs_t(int which, int* out) {
  using L = Layout<T, DMAX>;
  return which == 0
             ? attrs_of(flash_dq_kernel<T, DMAX>, L::kDqBytes, L::kStream, out)
             : attrs_of(flash_dkv_kernel<T, DMAX>, L::kDkvBytes, L::kStream,
                        out);
}

template <typename T>
int attrs_d(int which, int d, int* out) {
  if (d <= 32) return attrs_t<T, 32>(which, out);
  if (d <= 64) return attrs_t<T, 64>(which, out);
  if (d <= 128) return attrs_t<T, 128>(which, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, g (dO), dq, dk, dv: (bh, s, d)
// row-major in that dtype; lse, delta: (bh, s) f32. chunk = 0 ignores mode.
// Each returns a cudaError_t (0 = launched).
extern "C" int poseidon_flash_dq(const void* q, const void* k, const void* v,
                                 const void* g, const void* lse,
                                 const void* delta, void* dq, int dtype,
                                 int bh, int s, int d, float scale,
                                 int causal, int chunk, int mode,
                                 void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dq, nullptr, bh, s, d,
               scale, causal, chunk, mode, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(dtype, a);
}

extern "C" int poseidon_flash_dkv(const void* q, const void* k, const void* v,
                                  const void* g, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int dtype, int bh, int s, int d,
                                  float scale, int causal, int chunk,
                                  int mode, void* stream) {
  const Args a{q, k, v, g, static_cast<const float*>(lse),
               static_cast<const float*>(delta), dk, dv, bh, s, d,
               scale, causal, chunk, mode, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(dtype, a);
}

// which: 0 = flash_dq_kernel, 1 = flash_dkv_kernel; the instantiation for
// dtype and head dim d. Fills out[8] (see attrs_of); returns a cudaError_t.
extern "C" int poseidon_flash_bwd_attrs(int which, int dtype, int d,
                                        int* out) {
  if (dtype == 0) return attrs_d<float>(which, d, out);
  if (dtype == 1) return attrs_d<bf16>(which, d, out);
  return (int)cudaErrorInvalidValue;
}
