// Cross-channel LRN backward for Hopper (sm_90a), NCHW.
//
// Replaces poseidon_tpu/ops/pallas_kernels.py:_lrn_bwd_kernel (the Pallas
// TPU kernel reached through lrn_fused_bwd), Caffe's analytic gradient
// (lrn_layer.cpp CrossChannelBackward):
//
//   s[c]  = k + alpha/size * sum_{t=0}^{size-1} x[c-pre+t]^2
//   r[j]  = g[j] * x[j] * s[j]^(-beta-1)
//   dx[c] = g[c] * s[c]^(-beta) - (2*alpha*beta/size) * x[c] * sum_{t=0}^{size-1} r[c-post+t]
//
// with pre = (size-1)/2, post = size-1-pre (the backward window is the
// forward window mirrored) and out-of-range channels contributing zero.
// s is recomputed from x, so the forward saves nothing but x. Loads f32 or
// bf16, computes in f32, stores in the input dtype.
//
// Bound: memory. A few flops and two powf per element against reading x and
// g once and writing dx once, below the card's operations-per-byte balance:
// at AlexNet's batch 256 in f32, norm1 (256,96,55,55) moves 892.1 MB (0.266
// ms at 3.35 TB/s) and norm2 (256,256,27,27) 573.3 MB (0.171 ms), 0.4374 ms
// for the pair.
//
// Design: a channel-parallel shared-memory tile. A block of 256 threads owns
// a chunk of at most 64 channels (C split into equal chunks: norm1's 96 into
// two of 48, norm2's 256 into four of 64) times a run of 32 consecutive h*w
// positions of one image, and stages in shared memory:
//   x for the chunk and a halo of size-1 channels on each side (the two
//     chained windows: s[j] for the r window of the chunk's edge channels
//     reaches size-1 channels past the chunk), zero outside [0, C);
//   g, then r in its place, for the chunk and the size-1 channels of the r
//     window (post before, pre after);
//   the first term g * s^(-beta) of each chunk channel.
// Every row is read from device memory once, coalesced along h*w (h*w is odd
// at AlexNet's 3025 and 729, so rows do not align to 16 bytes across
// channels and the loads are scalar). Each element's s and r is computed
// once, by one thread, from shared memory; then each thread forms dx of
// its elements from the r window. There is no serial walk over C, no ring
// and no modulo. The halo rows inside [0, C) are read by two neighbouring
// chunks: at size 5, norm1 reads x 1.083 times and g 1.042 times, norm2 x
// 1.094 and g 1.047 times (at most 1 + 2(size-1)/chunk and 1 +
// (size-1)/chunk). The chunks of one position run are consecutive blocks,
// so the re-read rows mostly come from L2.
//
// Both window sums start from zero and add the taps in ascending order
// (zeros past the channel range included) with explicitly rounded multiplies
// and adds, and each element takes the same two powf calls, the order of the
// plain version (ops/lrn.py:lrn_bwd_plain): no fused multiply-add changes
// the rounding, and the kernel is bitwise equal to the plain version on the
// card. The window size is a template argument at 5 (AlexNet's, the only
// size on the path) and a runtime value otherwise; the shared-memory halo
// grows with it, and the wrapper caps it at MAX_LRN_SIZE. Any C (smaller
// than the halo too) and any h*w work.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LRN_SIZE 32

namespace {

constexpr int kThreads = 256;
constexpr int kPos = 32;       // h*w positions of a tile: one warp's lanes
constexpr int kMaxChunk = 64;  // channels of a tile, at most

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

// Shared-memory rows of kPos floats for a chunk of cc channels: x with a
// halo of size-1 on each side, g/r with the r window's size-1, the first
// term of the chunk.
int tile_rows(int cc, int size) {
  return (cc + 2 * (size - 1)) + (cc + size - 1) + cc;
}

// SIZE > 0: the window size at compile time; 0: `size` at run time.
// Block b: chunk b % n_chunks of position tile b / n_chunks; a position tile
// is a run of kPos positions of one image.
template <typename T, int SIZE>
__global__ void __launch_bounds__(kThreads)
    lrn_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dx, int64_t hw, int channels, int chunk,
                   int n_chunks, int64_t tiles_per_image, int size,
                   float alpha_over_size, float neg_beta, float neg_beta_m1,
                   float coef, float k) {
  const int n = SIZE > 0 ? SIZE : size;
  const int pre = (n - 1) / 2;
  const int post = n - 1 - pre;
  const int64_t b = blockIdx.x;
  const int c0 = (int)(b % n_chunks) * chunk;
  const int cc = min(chunk, channels - c0);  // channels of this chunk
  const int64_t tile = b / n_chunks;
  const int64_t img = tile / tiles_per_image;
  const int64_t p0 = (tile - img * tiles_per_image) * kPos;
  const int np = (int)min((int64_t)kPos, hw - p0);
  const int64_t base = img * (int64_t)channels * hw + p0;

  // x row i: channel c0 - (n-1) + i; g/r row i: channel c0 - post + i;
  // first-term row i: channel c0 + i
  const int xrows = cc + 2 * (n - 1);
  const int rrows = cc + n - 1;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sr = sx + xrows * kPos;
  float* sf = sr + rrows * kPos;

  for (int i = threadIdx.x; i < xrows * kPos; i += kThreads) {
    const int row = i / kPos, p = i % kPos;
    const int c = c0 - (n - 1) + row;
    sx[i] = (c >= 0 && c < channels && p < np)
                ? load_as_f32(x, base + (int64_t)c * hw + p)
                : 0.0f;
  }
  for (int i = threadIdx.x; i < rrows * kPos; i += kThreads) {
    const int row = i / kPos, p = i % kPos;
    const int c = c0 - post + row;
    sr[i] = (c >= 0 && c < channels && p < np)
                ? load_as_f32(g, base + (int64_t)c * hw + p)
                : 0.0f;
  }
  __syncthreads();

  // s[j] and r[j] (in g's place) for each channel j of the r window, the
  // first term for the chunk's own; r is 0 outside [0, C), as the plain
  // version pads it
  for (int i = threadIdx.x; i < rrows * kPos; i += kThreads) {
    const int row = i / kPos, p = i % kPos;
    const int j = c0 - post + row;
    if (j < 0 || j >= channels) {
      sr[i] = 0.0f;
      continue;
    }
    // x[j - pre + t] is x row (j - pre + t) - (c0 - (n-1)) = row + t
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < (SIZE > 0 ? SIZE : MAX_LRN_SIZE); ++t) {
      if (SIZE == 0 && t >= n) break;
      const float v = sx[(row + t) * kPos + p];
      acc = __fadd_rn(acc, __fmul_rn(v, v));
    }
    const float s = __fadd_rn(k, __fmul_rn(alpha_over_size, acc));
    const float xj = sx[(row + pre) * kPos + p];
    const float gj = sr[i];
    sr[i] = __fmul_rn(__fmul_rn(gj, xj), powf(s, neg_beta_m1));
    if (j >= c0 && j < c0 + cc)
      sf[(j - c0) * kPos + p] = __fmul_rn(gj, powf(s, neg_beta));
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cc * kPos; i += kThreads) {
    const int row = i / kPos, p = i % kPos;
    if (p >= np) continue;
    // r[c - post + t] is r row (c - post + t) - (c0 - post) = row + t
    float rsum = 0.0f;
#pragma unroll
    for (int t = 0; t < (SIZE > 0 ? SIZE : MAX_LRN_SIZE); ++t) {
      if (SIZE == 0 && t >= n) break;
      rsum = __fadd_rn(rsum, sr[(row + t) * kPos + p]);
    }
    const float xc = sx[(row + n - 1) * kPos + p];
    const float second = __fmul_rn(__fmul_rn(coef, xc), rsum);
    store_from_f32(dx, base + (int64_t)(c0 + row) * hw + p,
                   __fsub_rn(sf[i], second));
  }
}

template <typename T, int SIZE>
int launch_t(const void* x, const void* g, void* dx, int64_t batch,
             int channels, int64_t hw, int size, float alpha_over_size,
             float neg_beta, float neg_beta_m1, float coef, float k,
             cudaStream_t stream) {
  // equal chunks of at most kMaxChunk channels
  const int n_chunks = (channels + kMaxChunk - 1) / kMaxChunk;
  const int chunk = (channels + n_chunks - 1) / n_chunks;
  const int64_t tiles_per_image = (hw + kPos - 1) / kPos;
  const int64_t blocks = batch * tiles_per_image * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * kPos * (size_t)tile_rows(chunk, size);
  auto kernel = lrn_bwd_kernel<T, SIZE>;
  // above 48 KB only as opted-in dynamic shared memory (large windows)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      hw, channels, chunk, n_chunks, tiles_per_image, size, alpha_over_size,
      neg_beta, neg_beta_m1, coef, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int64_t batch,
           int channels, int64_t hw, int size, float alpha_over_size,
           float neg_beta, float neg_beta_m1, float coef, float k,
           cudaStream_t stream) {
  if (size == 5)
    return launch_t<T, 5>(x, g, dx, batch, channels, hw, size,
                          alpha_over_size, neg_beta, neg_beta_m1, coef, k,
                          stream);
  return launch_t<T, 0>(x, g, dx, batch, channels, hw, size, alpha_over_size,
                        neg_beta, neg_beta_m1, coef, k, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The scalars arrive rounded to float
// from the wrapper's doubles (alpha/size, -beta, -beta-1, 2*alpha*beta/size),
// the same floats the plain version's scalar operands round to. Returns a
// cudaError_t (0 = launched).
extern "C" int poseidon_lrn_bwd(const void* x, const void* g, void* dx,
                                int dtype, long long batch, int channels,
                                long long hw, int size, float alpha_over_size,
                                float neg_beta, float neg_beta_m1, float coef,
                                float k, void* stream) {
  if (size < 1 || size > MAX_LRN_SIZE) return (int)cudaErrorInvalidValue;
  if (batch < 1 || channels < 1 || hw < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, g, dx, batch, channels, hw, size,
                         alpha_over_size, neg_beta, neg_beta_m1, coef, k, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, g, dx, batch, channels, hw, size,
                                 alpha_over_size, neg_beta, neg_beta_m1, coef,
                                 k, st);
  }
  return (int)cudaErrorInvalidValue;
}
