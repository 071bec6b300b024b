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
// the TPU kernel computes it. Loads f32 or bf16, computes and accumulates
// in f32, stores dq, dk, dv in the input dtype.
//
// Bound: operations. dQ does three S x S x D products per (b, h) (s, dp,
// ds k), dK/dV four (s, dp, p^T dO, ds^T q), halved when causal, against
// reading q, k, v, dO, lse and delta and writing one or two (S, D)
// outputs once each. The products run on the CUDA cores in full f32
// (FMA), never TF32, to keep the port's f32 policy, so the bound is
// 67 TFLOP/s f32: at gpt_small's training shape (8, 12, 1024, 64) causal,
// 19.3 GFLOP (0.289 ms) for dQ and 25.8 GFLOP (0.385 ms) for dK/dV.
//
// Design (simple and correct first), K1's layout (flash_fwd.cu) reused.
// 256 threads a block; the block's own tile (64 query rows for dQ, 64 key
// rows for dK/dV) and its row statistics stay in shared memory, and the
// other side's 64-row tiles stream through shared memory in a loop inside
// the block, which takes the place of the TPU's sequential third grid
// axis. Thread t owns own-tile rows 4*(t/16)+i (i < 4) and streamed rows
// (t%16)+16*j of each tile for the S x S products, and own-tile output
// columns (t%16)+16*c, whose f32 sums stay in registers until the single
// store: each block owns its output tile, so there are no atomics and the
// result is the same from run to run. p and ds go through shared memory
// once per tile for the products that contract over the streamed rows.
// Shared rows are padded by one float so strided reads are free of bank
// conflicts. When causal and not chunked, dQ skips key tiles wholly above
// the diagonal and dK/dV skips query tiles that end before its key tile
// starts (the TPU kernels' block_live). Rows and keys past S are masked
// (scores past S are -inf, so they add exactly nothing), so any S works;
// D up to 128. wgmma, TMA and bf16 tensor cores are later work.
//
// The kernels allocate nothing and launch on the caller's stream; each C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // rows of a query tile and of a key tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float load_as_f32(const float* p, int64_t i) {
  return p[i];
}

__device__ __forceinline__ float load_as_f32(const __nv_bfloat16* p,
                                             int64_t i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ void store_from_f32(float* p, int64_t i, float v) {
  p[i] = v;
}

__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, int64_t i,
                                               float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <int DMAX>
struct Smem {
  static constexpr int kStride = DMAX + 1;  // (64, D) tiles
  static constexpr int kPStride = kTile + 1;  // (64, 64) p / ds tiles
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kPFloats = kTile * kPStride;
  // dQ: q, dO, k, v tiles, ds, lse, delta
  static constexpr size_t kDqBytes =
      sizeof(float) * (size_t)(4 * kTileFloats + kPFloats + 2 * kTile);
  // dK/dV: k, v, q, dO tiles, p, ds, lse, delta
  static constexpr size_t kDkvBytes =
      sizeof(float) * (size_t)(4 * kTileFloats + 2 * kPFloats + 2 * kTile);
};

// Load rows [row0, row0 + kTile) of a (S, D) slice into shared memory at
// the given stride, zero past S.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int stride, int row0,
                                          int S, int D) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * stride + d] =
        row < S ? load_as_f32(src, (int64_t)row * D + d) : 0.0f;
  }
}

// lse or delta of rows [row0, row0 + kTile), zero past S
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          float* dst, int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads)
    dst[r] = row0 + r < S ? src[row0 + r] : 0.0f;
}

// The scaled score of (row, col), masked as the TPU kernels mask it
// (_causal_mask), or -inf past the sequence (exactly no weight).
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int D, float scale, int causal, int chunk,
                    int mode) {
  using L = Smem<DMAX>;
  constexpr int kCols = DMAX / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sG = sQ + L::kTileFloats;
  float* sK = sG + L::kTileFloats;
  float* sV = sK + L::kTileFloats;
  float* sDs = sV + L::kTileFloats;
  float* sLse = sDs + L::kPFloats;
  float* sDelta = sLse + kTile;

  const int q0 = blockIdx.x * kTile;
  const int64_t base = (int64_t)blockIdx.y * S * D;
  const int64_t rbase = (int64_t)blockIdx.y * S;
  const int rg = threadIdx.x >> 4;  // own rows 4*rg .. 4*rg+3
  const int cg = threadIdx.x & 15;  // streamed rows cg + 16*j; columns

  load_tile(q + base, sQ, L::kStride, q0, S, D);
  load_tile(g + base, sG, L::kStride, q0, S, D);
  load_rows(lse + rbase, sLse, q0, S);
  load_rows(delta + rbase, sDelta, q0, S);

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;

  // causal self-attention: key tiles wholly above the diagonal contribute
  // nothing; chunked liveness depends on `mode` and is left to the mask
  int n_kt = (S + kTile - 1) / kTile;
  if (causal && !chunk) {
    const int last_row = min(q0 + kTile, S) - 1;
    n_kt = min(n_kt, last_row / kTile + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(k + base, sK, L::kStride, k0, S, D);
    load_tile(v + base, sV, L::kStride, k0, S, D);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = sQ[(rg * 4 + i) * L::kStride + d];
        gv[i] = sG[(rg * 4 + i) * L::kStride + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = sK[(cg + 16 * j) * L::kStride + d];
        vv[j] = sV[(cg + 16 * j) * L::kStride + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const float lse_r = sLse[r];
      const float delta_r = sDelta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = masked_score(s[i][j], scale, q0 + r,
                                     k0 + cg + 16 * j, S, causal, chunk,
                                     mode);
        const float p = expf(x - lse_r);
        sDs[r * L::kPStride + cg + 16 * j] = p * (dp[i][j] - delta_r) * scale;
      }
    }
    __syncthreads();

    // dq += ds @ k over this key tile
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] = sDs[(rg * 4 + i) * L::kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = cg + 16 * c;
        const float kd = d < D ? sK[kk * L::kStride + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kd, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = cg + 16 * c;
      if (d < D) store_from_f32(dq, base + (int64_t)row * D + d, acc[i][c]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int D, float scale,
                     int causal, int chunk, int mode) {
  using L = Smem<DMAX>;
  constexpr int kCols = DMAX / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + L::kTileFloats;
  float* sQ = sV + L::kTileFloats;
  float* sG = sQ + L::kTileFloats;
  float* sP = sG + L::kTileFloats;
  float* sDs = sP + L::kPFloats;
  float* sLse = sDs + L::kPFloats;
  float* sDelta = sLse + kTile;

  const int k0 = blockIdx.x * kTile;
  const int64_t base = (int64_t)blockIdx.y * S * D;
  const int64_t rbase = (int64_t)blockIdx.y * S;
  const int rg = threadIdx.x >> 4;  // own key rows 4*rg .. 4*rg+3
  const int cg = threadIdx.x & 15;  // streamed query rows cg + 16*j

  load_tile(k + base, sK, L::kStride, k0, S, D);
  load_tile(v + base, sV, L::kStride, k0, S, D);

  float acc_k[4][kCols], acc_v[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;

  // causal self-attention: query tiles that end before this key tile
  // starts see none of its keys
  const int n_qt = (S + kTile - 1) / kTile;
  const int qt0 = (causal && !chunk) ? k0 / kTile : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile(q + base, sQ, L::kStride, q0, S, D);
    load_tile(g + base, sG, L::kStride, q0, S, D);
    load_rows(lse + rbase, sLse, q0, S);
    load_rows(delta + rbase, sDelta, q0, S);
    __syncthreads();

    // transposed tiles: s[i][j] is the score of query row q0+cg+16j
    // against key row k0+4*rg+i, dp[i][j] likewise
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[4], gv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = sK[(rg * 4 + i) * L::kStride + d];
        vv[i] = sV[(rg * 4 + i) * L::kStride + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        qv[j] = sQ[(cg + 16 * j) * L::kStride + d];
        gv[j] = sG[(cg + 16 * j) * L::kStride + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[j], kv[i], s[i][j]);
          dp[i][j] = fmaf(gv[j], vv[i], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = cg + 16 * j;
        const float x = masked_score(s[i][j], scale, q0 + qr, k0 + r, S,
                                     causal, chunk, mode);
        const float p = expf(x - sLse[qr]);
        sP[r * L::kPStride + qr] = p;
        sDs[r * L::kPStride + qr] = p * (dp[i][j] - sDelta[qr]) * scale;
      }
    }
    __syncthreads();

    // dv += p^T @ dO and dk += ds^T @ q over this query tile
#pragma unroll 4
    for (int qq = 0; qq < kTile; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sP[(rg * 4 + i) * L::kPStride + qq];
        dsv[i] = sDs[(rg * 4 + i) * L::kPStride + qq];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = cg + 16 * c;
        const float gd = d < D ? sG[qq * L::kStride + d] : 0.0f;
        const float qd = d < D ? sQ[qq * L::kStride + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc_v[i][c] = fmaf(pv[i], gd, acc_v[i][c]);
          acc_k[i][c] = fmaf(dsv[i], qd, acc_k[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + rg * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = cg + 16 * c;
      if (d < D) {
        store_from_f32(dk, base + (int64_t)row * D + d, acc_k[i][c]);
        store_from_f32(dv, base + (int64_t)row * D + d, acc_v[i][c]);
      }
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

template <typename T, int DMAX>
int launch_dq(const Args& a) {
  constexpr size_t bytes = Smem<DMAX>::kDqBytes;
  auto kernel = flash_dq_kernel<T, DMAX>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((a.s + kTile - 1) / kTile),
                  (unsigned int)a.bh);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      static_cast<T*>(a.out0), a.s, a.d, a.scale, a.causal, a.chunk, a.mode);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int launch_dkv(const Args& a) {
  constexpr size_t bytes = Smem<DMAX>::kDkvBytes;
  auto kernel = flash_dkv_kernel<T, DMAX>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((a.s + kTile - 1) / kTile),
                  (unsigned int)a.bh);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta,
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.s, a.d, a.scale,
      a.causal, a.chunk, a.mode);
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
  if (dtype == 1) return dispatch_d<__nv_bfloat16, kDq>(a);
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
