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
// is the mean of V with lse = -1e30 + log S). Loads f32 or bf16, computes
// and accumulates in f32, stores out in the input dtype and lse in f32.
//
// Bound: operations at long S, bytes at short S. The work is 4*S*S*D f32
// operations per (b, h) (halved when causal) against reading q, k, v and
// writing out and lse once each; the products run on the CUDA cores in
// full f32 (FMA), never TF32 tensor cores, to keep the port's f32 policy
// (the JAX package's Precision.HIGHEST), so the bound is 67 TFLOP/s f32.
// At the gpt_small prefill shapes (S <= 256, B*H = 12) the grid is a few
// dozen blocks and the kernel is latency-bound instead.
//
// Design (simple and correct first). One thread block of 256 threads per
// (b*h, 64-row query tile); the key/value tiles of 64 rows stream through
// shared memory in a loop inside the block, which takes the place of the
// TPU's sequential third grid axis. Thread t owns query rows 4*(t/16)+i
// (i < 4) and key columns (t%16)+16*j of each tile, so a row's 16 owners
// are 16 consecutive lanes and its max and sum reduce with four warp
// shuffles. The running max m, denominator l and the row's output
// accumulator (columns (t%16)+16*c) stay in f32 registers across tiles;
// probabilities go through shared memory once per tile for P @ V. Shared
// rows are padded by one float so the strided reads are free of bank
// conflicts. When causal and not chunked, key tiles wholly above the
// diagonal are skipped. Rows and keys past S are masked in the kernel
// (keys past S score -inf, so they add exactly nothing), so any S works;
// D up to 128. wgmma, TMA and bf16 tensor cores are later work.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
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

// max and sum over the 16 lanes that share a row (xor offsets < 16 stay
// inside the half-warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DMAX>
struct Smem {
  static constexpr int kQStride = DMAX + 1;
  static constexpr int kKStride = DMAX + 1;
  static constexpr int kVStride = DMAX;
  static constexpr int kPStride = kBlockK + 1;
  static constexpr int kFloats = kBlockQ * kQStride + kBlockK * kKStride +
                                 kBlockK * kVStride + kBlockQ * kPStride;
  static constexpr size_t kBytes = sizeof(float) * (size_t)kFloats;
};

// Load rows [row0, row0 + rows) of a (S, D) slice into shared memory at
// the given stride, zero past S.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          float* dst, int stride, int row0,
                                          int rows, int S, int D) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int row = row0 + r;
    dst[r * stride + d] =
        row < S ? load_as_f32(src, (int64_t)row * D + d) : 0.0f;
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int S, int D, float scale,
                     int causal, int chunk, int mode) {
  using L = Smem<DMAX>;
  constexpr int kCols = DMAX / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * L::kQStride;
  float* sV = sK + kBlockK * L::kKStride;
  float* sP = sV + kBlockK * L::kVStride;

  const int q0 = blockIdx.x * kBlockQ;
  const int64_t base = (int64_t)blockIdx.y * S * D;
  const int rg = threadIdx.x >> 4;  // row group: rows 4*rg .. 4*rg+3
  const int cg = threadIdx.x & 15;  // column group

  load_tile(q + base, sQ, L::kQStride, q0, kBlockQ, S, D);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // causal self-attention: key tiles wholly above the diagonal contribute
  // nothing; chunked liveness depends on `mode` and is left to the mask
  int n_kt = (S + kBlockK - 1) / kBlockK;
  if (causal && !chunk) {
    const int last_row = min(q0 + kBlockQ, S) - 1;
    n_kt = min(n_kt, last_row / kBlockK + 1);
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(k + base, sK, L::kKStride, k0, kBlockK, S, D);
    load_tile(v + base, sV, L::kVStride, k0, kBlockK, S, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg * 4 + i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(cg + 16 * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + cg + 16 * j;
        float x = s[i][j] * scale;
        if (col >= S) {
          x = -INFINITY;  // past the sequence: exactly no weight
        } else if (causal) {
          const bool live = chunk ? (mode > 0 || (mode == 0 && row >= col))
                                  : row >= col;
          if (!live) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(rg * 4 + i) * L::kPStride + cg + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg * 4 + i) * L::kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = cg + 16 * c;
        const float vv = d < D ? sV[kk * L::kVStride + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    if (row >= S) continue;
    const float lsafe = l[i] == 0.0f ? 1.0f : l[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = cg + 16 * c;
      if (d < D) store_from_f32(out, base + (int64_t)row * D + d,
                                acc[i][c] / lsafe);
    }
    if (cg == 0) lse[(int64_t)blockIdx.y * S + row] = m[i] + logf(lsafe);
  }
}

template <typename T, int DMAX>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int bh, int s, int d, float scale, int causal, int chunk,
           int mode, cudaStream_t stream) {
  constexpr size_t bytes = Smem<DMAX>::kBytes;
  auto kernel = flash_fwd_kernel<T, DMAX>;
  // above 48 KB only as opted-in dynamic shared memory (set per launch: the
  // attribute is per device)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)((s + kBlockQ - 1) / kBlockQ),
                  (unsigned int)bh);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), s, d, scale, causal, chunk, mode);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out,
             void* lse, int bh, int s, int d, float scale, int causal,
             int chunk, int mode, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, lse, bh, s, d, scale, causal, chunk,
                         mode, stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, lse, bh, s, d, scale, causal, chunk,
                         mode, stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, lse, bh, s, d, scale, causal, chunk,
                          mode, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh < 1 || bh > 65535 || s < 1 || d < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(q, k, v, out, lse, bh, s, d, scale, causal, chunk,
                           mode, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, lse, bh, s, d, scale, causal,
                                   chunk, mode, st);
  return (int)cudaErrorInvalidValue;
}
