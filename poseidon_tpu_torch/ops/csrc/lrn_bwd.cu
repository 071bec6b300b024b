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
// g once and writing dx once, far below the card's operations-per-byte
// balance: at AlexNet's batch 256 in f32, norm1 moves 892.1 MB (0.266 ms at
// 3.35 TB/s) and norm2 573.3 MB (0.171 ms).
//
// Design (simple and correct first): one thread per (n, spatial position),
// as in lrn_fwd.cu, so each channel's loads are coalesced across the warp.
// The thread walks c upward and keeps the last `size` values of s and r in a
// small ring (registers or L1-resident local memory), so each r[j] and s[j]
// is computed once: every element costs `size` square loads for s, two powf
// and `size` adds for the r window. Both window sums run in ascending tap
// order with explicitly rounded multiplies and adds, the order of the plain
// version (ops/lrn.py:lrn_bwd_plain), so no fused multiply-add changes the
// rounding. The TPU kernel's VMEM tiling cap has no counterpart: any C
// works; size is capped at MAX_LRN_SIZE by the ring. Shared-memory channel
// tiles (one load per element instead of size) are later work.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LRN_SIZE 32

namespace {

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

template <typename T>
__global__ void lrn_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ g, T* __restrict__ dx,
                               int64_t positions, int64_t hw, int channels,
                               int size, int pre, float alpha_over_size,
                               float neg_beta, float neg_beta_m1, float coef,
                               float k) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= positions) return;
  const int64_t n = pos / hw;
  const int64_t sp = pos - n * hw;
  const int64_t base = n * (int64_t)channels * hw + sp;
  const int post = size - 1 - pre;
  float s_ring[MAX_LRN_SIZE];
  float r_ring[MAX_LRN_SIZE];

  // s[j] and r[j] into ring slot j % size
  auto fill = [&](int j) {
    float acc = 0.0f;
    for (int t = 0; t < size; ++t) {
      const int cc = j - pre + t;
      if (cc >= 0 && cc < channels) {
        const float v = load_as_f32(x, base + (int64_t)cc * hw);
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
    }
    const float s = __fadd_rn(k, __fmul_rn(alpha_over_size, acc));
    const int64_t i = base + (int64_t)j * hw;
    const float r = __fmul_rn(__fmul_rn(load_as_f32(g, i), load_as_f32(x, i)),
                              powf(s, neg_beta_m1));
    s_ring[j % size] = s;
    r_ring[j % size] = r;
  };

  // before c = 0 the window [c-post, c+pre] holds channels [0, pre)
  for (int j = 0; j < pre && j < channels; ++j) fill(j);
  for (int c = 0; c < channels; ++c) {
    // slide: channel c+pre enters, channel c-post-1 (same slot) leaves
    if (c + pre < channels) fill(c + pre);
    float rsum = 0.0f;
    for (int t = 0; t < size; ++t) {
      const int jj = c - post + t;
      if (jj >= 0 && jj < channels) rsum = __fadd_rn(rsum, r_ring[jj % size]);
    }
    const int64_t i = base + (int64_t)c * hw;
    const float xc = load_as_f32(x, i);
    const float gc = load_as_f32(g, i);
    const float first = __fmul_rn(gc, powf(s_ring[c % size], neg_beta));
    const float second = __fmul_rn(__fmul_rn(coef, xc), rsum);
    store_from_f32(dx, i, __fsub_rn(first, second));
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int64_t batch,
           int channels, int64_t hw, int size, float alpha_over_size,
           float neg_beta, float neg_beta_m1, float coef, float k,
           cudaStream_t stream) {
  const int64_t positions = batch * hw;
  const int threads = 128;
  const int64_t blocks = (positions + threads - 1) / threads;
  lrn_bwd_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      positions, hw, channels, size, (size - 1) / 2, alpha_over_size, neg_beta,
      neg_beta_m1, coef, k);
  return (int)cudaGetLastError();
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
