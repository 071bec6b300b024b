// Flash-attention forward for Hopper (sm_90a): out and the per-row
// logsumexp of softmax(q k^T * scale) v, over (B*H, S, D) row-major
// tensors, without ever writing the (S, S) score matrix to device memory.
//
// Replaces poseidon_tpu/ops/pallas_kernels.py:_flash_fwd_kernel (the
// Pallas TPU kernel reached through _flash_fwd / flash_attention /
// maybe_flash_attention):
//
//   s[i,j]  = (q[i] . k[j]) * scale, masked to NEG_INF = -1e30 where a
//             causal row may not see column j
//   out[i]  = sum_j exp(s[i,j] - m_i) v[j] / l_i,   lse[i] = m_i + log l_i
//
// with the TPU kernel's rules: l == 0 divides by 1; causal masks by the
// absolute position (row >= col); with chunk set, `mode` describes how a
// ring chunk of K/V aligns with the query chunk (+1 all live, 0 the
// in-chunk triangle, -1 all masked, so every score is NEG_INF and the row
// is the mean of V with lse = -1e30 + log S). Keys past S score -inf and
// add exactly nothing, so any S >= 1 works; D up to 128. Loads f32 or
// bf16, accumulates in f32, stores out in the input dtype and lse in f32.
//
// Bound: operations at long S, bytes at short S. The work is two S x S x D
// products per (b, h) (halved when causal): 4*S*S*D operations against
// reading q, k, v and writing out and lse once each. f32 runs each product
// as three TF32 products (below), so its least time is 3 x operations over
// the H100's 495 TFLOP/s TF32 rate; bf16 runs at 989 TFLOP/s.
//   - gpt_small training, (8,12,1024,64) causal f32: 12.88 GFLOP, 0.0781 ms
//     at the 3xTF32 rate (0.1923 ms at the 67 TFLOP/s of f32 outside the
//     tensor cores).
//   - (8,12,512,64) causal bf16: bytes, 0.0076 ms (25.4 MB at 3.35 TB/s;
//     its 3.2 GFLOP take 0.0033 ms at 989 TFLOP/s).
//   - the gpt_small prefill at bucket 256, (1,12,256,64) causal: 0.0015 ms.
//     In blocks of 64 query rows its grid is 48 blocks on 132 SMs, and the
//     last query tile's walk over every key tile sets the time, not the
//     card's rate (point 7).
//
// Design. The JAX package runs both products at Precision.HIGHEST under
// its f32 policy, a multi-pass emulation of f32 on the TPU's matrix unit;
// this port does the same on Hopper's tensor cores and never runs a single
// TF32 pass. The building blocks are those of flash_bwd.cu (K2, K3):
//
// 1. Tensor cores. A block is 4 warps; each owns 16 query rows of the
//    block's 64-row tile and computes S = Q K^T and O += P V with warp-level
//    mma.sync. f32: m16n8k8 TF32 as 3xTF32 (each operand split into big =
//    rna(x), rounded as cvt.rna.tf32 rounds, and the remainder small,
//    which the tensor core reads truncated to TF32; small*big + big*small
//    first, then big*big). bf16: m16n8k16 with f32 accumulation. The Q
//    tile is the same for every key tile, so its A fragments are taken
//    once: bf16 into registers; f32 split once, which takes a third of the
//    operand splits out of the S product, and written back over the Q
//    tile in fragment order (two 16-byte loads a k8 step), which keeps Q
//    out of the registers (f32 at D = 128 splits them from the Q tile every
//    tile instead).
// 2. The online softmax works on the accumulator fragments. A thread holds
//    two rows (g and g+8 of its warp's 16); the row max reduces over the
//    quad of lanes that share a row with two __shfl_xor_sync, the running
//    max m, the rescale factor alpha and the thread's share of the row sum
//    l stay in f32 registers (l reduces over the quad once, at the end),
//    and O is rescaled by alpha in f32 registers on every key tile. The
//    mask is applied by absolute row and column, the `mode` rule as in the
//    TPU kernel.
// 3. P feeds P V from registers, never through shared memory. bf16: the
//    accumulator layout is m16n8k16's A-operand layout (FlashAttention-2's
//    trick), and V's B fragments come through ldmatrix.trans. TF32: the
//    accumulator holds columns 2t and 2t+1 where m16n8k8's A operand reads
//    t and t+4, so the contraction index is permuted within each k8 step
//    and V's B fragments are loaded with the same permutation.
// 4. Short chains. The tensor core truncates its own f32 sums, so a long
//    chain of MMAs on one accumulator drifts toward zero. No chain holds
//    more than six MMAs from zero: two k8 steps of 3xTF32 in f32; in bf16
//    four k16 steps of S, and two k16 steps of P V with P in two parts.
//    Each partial sum goes into the f32 accumulators (S, and O) with one
//    rounded add.
// 5. bf16 P keeps f32 accuracy. The TPU kernel multiplies P by V in f32;
//    here P, f32 in the accumulators, enters P V as a bf16 big part and a
//    bf16 small remainder, two MMAs (rounded once, P misses the bf16
//    tolerance: tests/test_torch_flash_fwd_route.py).
// 6. Copies overlap compute. K and V tiles go through a two-stage ring of
//    16-byte cp.async.cg: tile n+1 lands while tile n computes. Tiles stay
//    in the input dtype (bf16 moves half the bytes), rows are padded by 16
//    bytes so every fragment load and ldmatrix row is free of bank
//    conflicts, and the zero-fill form covers rows past S and columns
//    D..DMAX. When D is not a multiple of 16 bytes the tiles are copied
//    synchronously. Key tiles are 32 rows in f32 (the split Q fragments, S
//    and its partial sums and O share the registers) and 64 in bf16 (32 at
//    D = 128).
// 7. Short grids. The grid is (B*H, query tiles) with the tile index on the
//    slower axis, ordered so the query tiles with the most causal work
//    start first; when causal and not chunked, key tiles wholly above the
//    diagonal are skipped. When blocks of 64 query rows would number fewer
//    than the card's SMs (the gpt_small prefill, the byte-level LM's
//    training shape), the C entry launches the key split instead: a block
//    owns 32 query rows, its two warp pairs take the two halves of each
//    tile of 2 x 32 (f32) or 2 x 64 (bf16) keys, and at the end the second
//    pair hands its m, l and O through shared memory to the first, which
//    merges them by lse (out of one launch: no second pass). Twice the
//    blocks, and each warp walks half the key tiles of its rows.
// 8. Registers. At D = 64 with whole key tiles (the training shapes) the
//    kernel is held to three resident blocks an SM (168 registers); short
//    grids and other widths keep the registers they take, which measured
//    faster there. Each block owns its output rows: no atomics, and the
//    result is the same from run to run.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch. poseidon_flash_fwd_attrs reports each instantiation's registers,
// shared memory, spills and resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

template <typename T, int DMAX>
struct Layout {
  // key rows a warp takes from a tile
  static constexpr int kBlockK = sizeof(T) == 4 ? 32 : (DMAX <= 64 ? 64 : 32);
  static constexpr int kStride = DMAX + 16 / (int)sizeof(T);  // elements
  // Q's A fragments are taken once: bf16 into registers, f32 split into
  // shared memory (f32 at D = 128 splits them from the Q tile every tile)
  static constexpr bool kQOnce = sizeof(T) == 2 || DMAX <= 64;
};

// A block's tiles. SPLIT = 1: the 4 warps own 16 query rows each (64 rows)
// and take every key tile. SPLIT = 2 (short grids): warps w and w + 2 own
// the same 16 of 32 query rows and take the two halves of each tile of
// 2 x kBlockK keys, and merge by lse at the end.
template <typename T, int DMAX, int SPLIT>
struct Tiles {
  using L = Layout<T, DMAX>;
  static constexpr int kRowGroups = kWarps / SPLIT;
  static constexpr int kBlockQ = 16 * kRowGroups;     // query rows
  static constexpr int kTileK = SPLIT * L::kBlockK;   // key rows a tile
  // the Q tile; f32's split fragments (each warp's DMAX * 128 bytes) go over
  // it, so its area is the larger of the two
  static constexpr int kQTile = kBlockQ * L::kStride;
  static constexpr int kQSplit =
      (sizeof(T) == 4 && L::kQOnce) ? kWarps * DMAX * 32 : 0;
  static constexpr int kQElems = kQTile > kQSplit ? kQTile : kQSplit;
  static constexpr int kKVElems = kTileK * L::kStride;
  // the Q tile, then two stages of the (K, V) pair
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kQElems + 4 * kKVElems);
  // the merge: m, l and O of the second key half, a float a lane each,
  // in the ring's place once the key loop is done
  static constexpr size_t kMergeBytes =
      sizeof(float) * (size_t)(kRowGroups * (4 + DMAX / 2) * 32);
  static_assert(SPLIT == 1 || kMergeBytes <= 4 * kKVElems * sizeof(T),
                "the merge fits in the ring");
  // resident blocks an SM that the registers are held to: three at D = 64
  // with whole key tiles (the training shapes), where a third block is
  // worth more than registers; elsewhere one, which lets nvcc take the
  // registers it wants (faster there, measured on the card)
  static constexpr int kMinBlocks = (DMAX == 64 && SPLIT == 1) ? 3 : 1;
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

// The scaled score of (query row, key col), masked as the TPU kernel masks
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

// One rounded f32 add of a tensor-core partial sum into an accumulator.
__device__ __forceinline__ void add_partial(float (&c)[4],
                                            const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// ---- f32: m16n8k8 TF32, three passes --------------------------------------

// x as a TF32 big part rna(x) (cvt.rna.tf32.f32's integer add and mask)
// and the exact remainder x - big, which the tensor core reads truncated to
// TF32: big + small is within 2^-21 |x| of x.
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

// c += a * b over one k8 step in 3xTF32: small*big + big*small, then
// big*big.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb[0], bb[1]);
  mma_tf32(c, ab, bs[0], bs[1]);
  mma_tf32(c, ab, bb[0], bb[1]);
}

// The A fragment of Q for k8 step ks of the warp's 16 rows (from r0), split:
// rows g, g+8, columns t, t+4.
template <int DMAX>
__device__ __forceinline__ void q_frag_tf32(const float* sQ, int r0, int lane,
                                            int ks, uint32_t (&b)[4],
                                            uint32_t (&s)[4]) {
  constexpr int st = Layout<float, DMAX>::kStride;
  const float* pa = sQ + (r0 + (lane >> 2)) * st + ks * 8 + (lane & 3);
  split_tf32(pa[0], b[0], s[0]);
  split_tf32(pa[8 * st], b[1], s[1]);
  split_tf32(pa[4], b[2], s[2]);
  split_tf32(pa[8 * st + 4], b[3], s[3]);
}

// Q's fragments: split once (D <= 64), or read from the Q tile and split on
// every use (D = 128).
template <typename T, int DMAX, bool kOnce = Layout<T, DMAX>::kQOnce>
struct QFrags;

// Split once into shared memory, in fragment order: for each k8 step a
// lane's four big parts, then its four small parts, 16 bytes each, over the
// Q tile (each warp DMAX * 128 bytes, its own). The loop then reads them
// with two 16-byte loads a k8 step and holds no Q in registers. Called by
// every thread of the block.
template <int DMAX>
struct QFrags<float, DMAX, true> {
  const uint4* frag;
  __device__ __forceinline__ void load(float* sQ, int r0, int warp,
                                       int lane) {
    uint32_t b[DMAX / 8][4], s[DMAX / 8][4];
#pragma unroll
    for (int ks = 0; ks < DMAX / 8; ++ks)
      q_frag_tf32<DMAX>(sQ, r0, lane, ks, b[ks], s[ks]);
    __syncthreads();  // every warp has read the Q tile: overwrite it
    uint4* own = reinterpret_cast<uint4*>(sQ) + warp * (DMAX / 8) * 64;
#pragma unroll
    for (int ks = 0; ks < DMAX / 8; ++ks) {
      own[2 * ks * 32 + lane] = make_uint4(b[ks][0], b[ks][1], b[ks][2],
                                           b[ks][3]);
      own[(2 * ks + 1) * 32 + lane] =
          make_uint4(s[ks][0], s[ks][1], s[ks][2], s[ks][3]);
    }
    __syncwarp();
    frag = own;
  }
  __device__ __forceinline__ void get(const float*, int, int lane, int ks,
                                      uint32_t (&ob)[4],
                                      uint32_t (&os)[4]) const {
    const uint4 b = frag[2 * ks * 32 + lane];
    const uint4 s = frag[(2 * ks + 1) * 32 + lane];
    ob[0] = b.x, ob[1] = b.y, ob[2] = b.z, ob[3] = b.w;
    os[0] = s.x, os[1] = s.y, os[2] = s.z, os[3] = s.w;
  }
};

template <int DMAX>
struct QFrags<float, DMAX, false> {
  __device__ __forceinline__ void load(float*, int, int, int) {}
  __device__ __forceinline__ void get(const float* sQ, int r0, int lane,
                                      int ks, uint32_t (&ob)[4],
                                      uint32_t (&os)[4]) const {
    q_frag_tf32<DMAX>(sQ, r0, lane, ks, ob, os);
  }
};

// s = Q K^T (unscaled) for the warp's 16 rows against the key tile. B
// fragment row (n) g, columns (k) t, t+4 of the key tile; accumulator
// s[nt]: rows g, g+8, columns 8 nt + 2t, 2t+1. Chains of two k8 steps from
// zero: the first is s itself, each later one is added with one rounded
// add.
template <int DMAX, int NT, typename Q>
__device__ __forceinline__ void scores(const Q& qf, const float* sQ,
                                       const float* sK, int r0, int lane,
                                       float (&s)[NT][4]) {
  constexpr int st = Layout<float, DMAX>::kStride;
  static_assert(DMAX % 16 == 0, "two k8 steps a chain");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < DMAX / 8; kc += 2) {
    float part[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
#pragma unroll
    for (int ks = kc; ks < kc + 2; ++ks) {
      uint32_t ab[4], as[4];
      qf.get(sQ, r0, lane, ks, ab, as);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* pb = sK + (nt * 8 + g) * st + ks * 8 + t;
        uint32_t bb[2], bs[2];
        split_tf32(pb[0], bb[0], bs[0]);
        split_tf32(pb[4], bb[1], bs[1]);
        mma_3xtf32(part[nt], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = kc == 0 ? part[nt][e] : s[nt][e] + part[nt][e];
  }
}

// acc += P V: P (16 x NT*8) in accumulator layout, V the key tile's NT*8
// rows x DMAX. The contraction index is permuted within each k8 step: P's
// columns 2t, 2t+1 (the accumulator's) stand where m16n8k8 reads t, t+4,
// and V's rows 2t, 2t+1 are loaded in the same places. Chains of two k8
// steps.
template <int DMAX, int NT>
__device__ __forceinline__ void pv(const float (&p)[NT][4], const float* sV,
                                   int lane, float (&acc)[DMAX / 8][4]) {
  constexpr int st = Layout<float, DMAX>::kStride;
  static_assert(NT % 2 == 0, "two k8 steps a chain");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < NT; kc += 2) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      split_tf32(p[kc + j][0], ab[j][0], as[j][0]);  // row g,   column 2t
      split_tf32(p[kc + j][2], ab[j][1], as[j][1]);  // row g+8, column 2t
      split_tf32(p[kc + j][1], ab[j][2], as[j][2]);  // row g,   column 2t+1
      split_tf32(p[kc + j][3], ab[j][3], as[j][3]);  // row g+8, column 2t+1
    }
#pragma unroll
    for (int nd = 0; nd < DMAX / 8; ++nd) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* pb = sV + ((kc + j) * 8 + 2 * t) * st + nd * 8 + g;
        uint32_t bb[2], bs[2];
        split_tf32(pb[0], bb[0], bs[0]);
        split_tf32(pb[st], bb[1], bs[1]);
        mma_3xtf32(part, ab[j], as[j], bb, bs);
      }
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

// Q's A fragments, in registers: rows g, g+8, column pairs 2t and 2t+8 of
// each k16 step.
template <int DMAX>
struct QFrags<bf16, DMAX, true> {
  uint32_t a[DMAX / 16][4];
  __device__ __forceinline__ void load(bf16* sQ, int r0, int, int lane) {
    constexpr int st = Layout<bf16, DMAX>::kStride;
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
      const bf16* pa = sQ + (r0 + (lane >> 2)) * st + ks * 16 + 2 * (lane & 3);
      a[ks][0] = ld_u32(pa);
      a[ks][1] = ld_u32(pa + 8 * st);
      a[ks][2] = ld_u32(pa + 8);
      a[ks][3] = ld_u32(pa + 8 * st + 8);
    }
  }
};

// s = Q K^T as the f32 version: B fragment row (n) g, column (k) pairs 2t
// and 2t+8. Chains of four k16 steps.
template <int DMAX, int NT>
__device__ __forceinline__ void scores(const QFrags<bf16, DMAX>& qf,
                                       const bf16*, const bf16* sK, int,
                                       int lane, float (&s)[NT][4]) {
  constexpr int st = Layout<bf16, DMAX>::kStride;
  constexpr int kSteps = DMAX / 16;
  constexpr int kChain = kSteps < 4 ? kSteps : 4;
  static_assert(kSteps % kChain == 0, "whole chains");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kc = 0; kc < kSteps; kc += kChain) {
    float part[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
#pragma unroll
    for (int ks = kc; ks < kc + kChain; ++ks) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* pb = sK + (nt * 8 + g) * st + ks * 16 + 2 * t;
        mma_bf16(part[nt], qf.a[ks], ld_u32(pb), ld_u32(pb + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = kc == 0 ? part[nt][e] : s[nt][e] + part[nt][e];
  }
}

// acc += P V with P (f32 accumulators) split into bf16 big and small:
// accumulator tiles 2kk and 2kk+1 are m16n8k16's A fragment as they are.
// Chains of two k16 steps (four MMAs).
template <int DMAX, int NT>
__device__ __forceinline__ void pv(const float (&p)[NT][4], const bf16* sV,
                                   int lane, float (&acc)[DMAX / 8][4]) {
  constexpr int st = Layout<bf16, DMAX>::kStride;
  constexpr int kSteps = NT / 2;  // k16 steps of the key tile
  static_assert(kSteps % 2 == 0 || kSteps == 1, "chains of two k16 steps");
  constexpr int kChain = kSteps < 2 ? kSteps : 2;
  // ldmatrix: lanes 8m..8m+7 address matrix m's rows: k rows (m & 1) * 8,
  // n columns (m >> 1) * 8
  const bf16* rows =
      sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * st + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < kSteps; kc += kChain) {
    uint32_t ab[kChain][4], as[kChain][4];
#pragma unroll
    for (int j = 0; j < kChain; ++j) {
      const int kk = kc + j;
      split_bf16x2(p[2 * kk][0], p[2 * kk][1], ab[j][0], as[j][0]);
      split_bf16x2(p[2 * kk][2], p[2 * kk][3], ab[j][1], as[j][1]);
      split_bf16x2(p[2 * kk + 1][0], p[2 * kk + 1][1], ab[j][2], as[j][2]);
      split_bf16x2(p[2 * kk + 1][2], p[2 * kk + 1][3], ab[j][3], as[j][3]);
    }
#pragma unroll
    for (int nd = 0; nd < DMAX / 16; ++nd) {
      float part0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float part1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kChain; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, rows + (kc + j) * 16 * st + nd * 16);
        mma_bf16(part0, as[j], b[0], b[1]);
        mma_bf16(part0, ab[j], b[0], b[1]);
        mma_bf16(part1, as[j], b[2], b[3]);
        mma_bf16(part1, ab[j], b[2], b[3]);
      }
      add_partial(acc[2 * nd], part0);
      add_partial(acc[2 * nd + 1], part1);
    }
  }
}

// ---- the kernel ------------------------------------------------------------

template <typename T, int DMAX, int SPLIT>
__global__ void __launch_bounds__(kThreads, (Tiles<T, DMAX, SPLIT>::kMinBlocks))
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int D, float scale,
                     int causal, int chunk, int mode, int vec) {
  using L = Layout<T, DMAX>;
  using B = Tiles<T, DMAX, SPLIT>;
  constexpr int kBlockK = L::kBlockK;
  constexpr int kBlockQ = B::kBlockQ;
  constexpr int kTileK = B::kTileK;
  constexpr int NT = kBlockK / 8;
  constexpr int ND = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sRing = sQ + B::kQElems;  // stage s: k at 2s, v at 2s+1

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % B::kRowGroups;  // the warp's 16 query rows
  const int half = warp / B::kRowGroups;  // the warp's part of a key tile
  const int r0 = rg * 16;
  // the last query tiles carry the most causal work: they start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const int64_t base = (int64_t)blockIdx.x * S * D;
  const T* kb = k + base;
  const T* vb = v + base;

  // causal self-attention: key tiles wholly above the diagonal contribute
  // nothing; chunked liveness depends on `mode` and is left to the mask
  int n_kt = (S + kTileK - 1) / kTileK;
  if (causal && !chunk)
    n_kt = min(n_kt, (min(q0 + kBlockQ, S) - 1) / kTileK + 1);

  // key tile kt goes to ring stage kt & 1 in copy group kt (Q rides in
  // group 0); tile kt + 2 is requested once tile kt is done
  auto load_kv = [&](int kt) {
    if (kt < n_kt) {
      T* stage = sRing + (kt & 1) * 2 * B::kKVElems;
      load_tile<T, DMAX, kTileK>(stage, kb, kt * kTileK, S, D, vec);
      load_tile<T, DMAX, kTileK>(stage + B::kKVElems, vb, kt * kTileK, S, D,
                                 vec);
    }
    cp_async_commit();  // an empty group past the last tile
  };
  load_tile<T, DMAX, kBlockQ>(sQ, q + base, q0, S, D, vec);
  load_kv(0);
  load_kv(1);

  int row[2];
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    row[h] = q0 + r0 + (lane >> 2) + 8 * h;
    m[h] = kNegInf;
    l[h] = 0.0f;  // this thread's share of the row sum
  }
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.0f;
  // Q's fragments, once, while tile 1 lands
  cp_async_wait<1>();
  __syncthreads();
  QFrags<T, DMAX> qf;
  qf.load(sQ, r0, warp, lane);

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<1>();  // tile kt has landed (tile kt + 1 may not have)
    __syncthreads();
    // this warp's kBlockK keys of the tile
    const T* sK = sRing + (kt & 1) * 2 * B::kKVElems + half * kBlockK *
                                                          L::kStride;
    const T* sV = sK + B::kKVElems;
    const int k0 = kt * kTileK + half * kBlockK;

    float s[NT][4];
    scores<DMAX, NT>(qf, sQ, sK, r0, lane, s);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const float x =
            masked_score(s[nt][e], scale, row[h], col, S, causal, chunk, mode);
        s[nt][e] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the quad of lanes 4g..4g+3 holds row g's columns
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = expf(s[nt][e] - m[h]);
        s[nt][e] = p;
        rs[h] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nd][e] *= alpha[e >> 1];

    pv<DMAX, NT>(s, sV, lane, acc);
    __syncthreads();  // every warp is done with this stage: refill it
    load_kv(kt + 2);
  }

  if (SPLIT == 2) {
    // merge the second key half into the first by lse: each lane of warp
    // rg + 2 hands m, l and O to the same lane of warp rg (the same rows
    // and columns), through the ring, which the loop no longer reads
    float* sm = reinterpret_cast<float*>(sRing) + rg * (4 + 4 * ND) * 32 + lane;
    if (half == 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sm[h * 32] = m[h];
        sm[(2 + h) * 32] = l[h];
      }
#pragma unroll
      for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) sm[(4 + nd * 4 + e) * 32] = acc[nd][e];
    }
    __syncthreads();
    if (half == 1) return;
    float a0[2], a1[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m1 = sm[h * 32];
      const float m_new = fmaxf(m[h], m1);
      a0[h] = expf(m[h] - m_new);
      a1[h] = expf(m1 - m_new);
      l[h] = l[h] * a0[h] + sm[(2 + h) * 32] * a1[h];
      m[h] = m_new;
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[nd][e] = acc[nd][e] * a0[e >> 1] +
                     sm[(4 + nd * 4 + e) * 32] * a1[e >> 1];
  }

  const int64_t rbase = (int64_t)blockIdx.x * S;
  float lsafe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    lsafe[h] = l[h] == 0.0f ? 1.0f : l[h];
    if ((lane & 3) == 0 && row[h] < S)
      lse[rbase + row[h]] = m[h] + logf(lsafe[h]);
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const int d = nd * 8 + 2 * (lane & 3) + (e & 1);
      if (row[h] < S && d < D)
        out[base + (int64_t)row[h] * D + d] =
            from_f32<T>(acc[nd][e] / lsafe[h]);
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
  void* out;
  float* lse;
  int bh, s, d;
  float scale;
  int causal, chunk, mode;
  cudaStream_t stream;
};

// 16-byte copies need every row of q, k, v on a 16-byte boundary
template <typename T>
int vector_ok(const Args& a) {
  const uintptr_t addr = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  return (a.d * (int)sizeof(T)) % 16 == 0 && addr % 16 == 0;
}

template <typename T, int DMAX, int SPLIT>
int launch(const Args& a) {
  using B = Tiles<T, DMAX, SPLIT>;
  constexpr size_t bytes = B::kBytes;
  auto kernel = flash_fwd_kernel<T, DMAX, SPLIT>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  // (B*H, query tiles): the tile index on the slower axis, so each tile
  // rank starts across every (b, h) before the next
  const dim3 grid((unsigned int)a.bh,
                  (unsigned int)((a.s + B::kBlockQ - 1) / B::kBlockQ));
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.s, a.d,
      a.scale, a.causal, a.chunk, a.mode, vector_ok<T>(a));
  return (int)cudaGetLastError();
}

template <typename T, int SPLIT>
int dispatch_d(const Args& a) {
  if (a.d <= 32) return launch<T, 32, SPLIT>(a);
  if (a.d <= 64) return launch<T, 64, SPLIT>(a);
  if (a.d <= 128) return launch<T, 128, SPLIT>(a);
  return (int)cudaErrorInvalidValue;
}

// The key split when blocks of 64 query rows would leave SMs idle (the
// gpt_small prefill at bucket 256 is 48 such blocks on 132 SMs): twice the
// blocks, and each warp walks half the key tiles of its rows.
int key_split(const Args& a) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  const int64_t blocks = (int64_t)a.bh * ((a.s + 63) / 64);
  return blocks < sms ? 2 : 1;
}

template <typename T>
int dispatch(const Args& a) {
  return key_split(a) == 2 ? dispatch_d<T, 2>(a) : dispatch_d<T, 1>(a);
}

// out: registers a thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes a thread, threads a block, resident blocks per SM,
// query rows a block, key rows a tile (all warps together)
template <typename T, int DMAX, int SPLIT>
int attrs_t(int* out) {
  using B = Tiles<T, DMAX, SPLIT>;
  auto kernel = flash_fwd_kernel<T, DMAX, SPLIT>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, B::kBytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, B::kBytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)B::kBytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = kThreads;
  out[5] = blocks;
  out[6] = B::kBlockQ;
  out[7] = B::kTileK;
  return 0;
}

template <typename T, int SPLIT>
int attrs_d(int d, int* out) {
  if (d <= 32) return attrs_t<T, 32, SPLIT>(out);
  if (d <= 64) return attrs_t<T, 64, SPLIT>(out);
  if (d <= 128) return attrs_t<T, 128, SPLIT>(out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: (bh, s, d) row-major;
// lse: (bh, s) f32. chunk = 0 ignores mode. Returns a cudaError_t
// (0 = launched).
extern "C" int poseidon_flash_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int dtype, int bh,
                                  int s, int d, float scale, int causal,
                                  int chunk, int mode, void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, static_cast<float*>(lse), bh, s, d, scale,
               causal, chunk, mode, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a);
  if (dtype == 1) return dispatch<bf16>(a);
  return (int)cudaErrorInvalidValue;
}

// The instantiation for the key split (1: blocks of 64 query rows, 2:
// blocks of 32 with the key tiles split between warp pairs), dtype and head
// dim d. Fills out[8] (see attrs_t); returns a cudaError_t.
extern "C" int poseidon_flash_fwd_attrs(int split, int dtype, int d,
                                        int* out) {
  if (split == 1 && dtype == 0) return attrs_d<float, 1>(d, out);
  if (split == 1 && dtype == 1) return attrs_d<bf16, 1>(d, out);
  if (split == 2 && dtype == 0) return attrs_d<float, 2>(d, out);
  if (split == 2 && dtype == 1) return attrs_d<bf16, 2>(d, out);
  return (int)cudaErrorInvalidValue;
}
