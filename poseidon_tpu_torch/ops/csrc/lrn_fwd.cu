// Cross-channel LRN forward for Hopper (sm_90a), NCHW.
//
// Replaces poseidon_tpu/ops/pallas_kernels.py:_lrn_kernel (the Pallas TPU
// kernel reached through _lrn_fused_fwd_impl / lrn_fused):
//
//   y[n,c,s] = x[n,c,s] * (k + alpha/size * sum_{t=0}^{size-1} x[n,c-pre+t,s]^2)^(-beta)
//
// with pre = (size-1)/2 and out-of-range channels contributing zero, so an
// even window is asymmetric (Caffe's rule, not torch's local_response_norm).
// Loads f32 or bf16, computes in f32, stores in the input dtype.
//
// Bound: memory. The work is a few flops per element against one read and
// one write of x, far below the card's operations-per-byte balance.
//
// Design (simple and correct first): one thread per (n, spatial position).
// Neighbouring threads hold neighbouring spatial positions, so every
// channel's load is coalesced across the warp. Each thread walks c in
// [0, C) and, for each c, sums the window's squares in ascending tap order
// (the order of the TPU kernel's slice loop) with explicitly rounded
// multiplies and adds, so no fused multiply-add changes the rounding. This
// reads each element up to size+1 times; the re-reads hit L1/L2, not device
// memory. The TPU kernel's VMEM tiling cap (_lrn_tile) has no counterpart:
// any C works. Shared-memory channel tiles and vector loads are later work.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__global__ void lrn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int64_t positions, int64_t hw, int channels,
                               int size, int pre, float alpha_over_size,
                               float neg_beta, float k) {
  const int64_t pos = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pos >= positions) return;
  const int64_t n = pos / hw;
  const int64_t s = pos - n * hw;
  const int64_t base = n * (int64_t)channels * hw + s;
  for (int c = 0; c < channels; ++c) {
    float acc = 0.0f;
    for (int t = 0; t < size; ++t) {
      const int cc = c - pre + t;
      if (cc >= 0 && cc < channels) {
        const float v = load_as_f32(x, base + (int64_t)cc * hw);
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
    }
    const float scale = __fadd_rn(k, __fmul_rn(alpha_over_size, acc));
    const int64_t i = base + (int64_t)c * hw;
    store_from_f32(y, i, __fmul_rn(load_as_f32(x, i), powf(scale, neg_beta)));
  }
}

template <typename T>
int launch(const void* x, void* y, int64_t batch, int channels, int64_t hw,
           int size, float alpha_over_size, float beta, float k,
           cudaStream_t stream) {
  const int64_t positions = batch * hw;
  const int threads = 256;
  const int64_t blocks = (positions + threads - 1) / threads;
  lrn_fwd_kernel<T><<<(unsigned int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), positions, hw, channels,
      size, (size - 1) / 2, alpha_over_size, -beta, k);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int poseidon_lrn_fwd(const void* x, void* y, int dtype,
                                long long batch, int channels, long long hw,
                                int size, float alpha_over_size, float beta,
                                float k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, y, batch, channels, hw, size, alpha_over_size,
                         beta, k, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, y, batch, channels, hw, size,
                                 alpha_over_size, beta, k, st);
  }
  return (int)cudaErrorInvalidValue;
}
