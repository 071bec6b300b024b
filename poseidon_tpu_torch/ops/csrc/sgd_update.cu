// Fused SGD + momentum + L2 update over the flat parameter arena, for
// Hopper (sm_90a).
//
// Replaces poseidon_tpu/ops/pallas_kernels.py:_sgd_update_kernel (the
// Pallas TPU kernel reached through fused_sgd / maybe_fused_sgd from
// solvers/updates.py), Caffe's SGD rule (solver.cpp ComputeUpdateValue)
// with per-segment multipliers:
//
//   g' = (decay[i] == 0) ? g[i] : g[i] + decay[i] * w[i]
//   h' = momentum * h[i] + (rate * lr_mult[i]) * g'
//   w' = w[i] - h'
//
// w and h are updated IN PLACE: the arena is the training step's own
// buffer, so nothing else reads the old values (the TPU kernel writes new
// arrays because JAX values are immutable).
//
// Bound: memory. Five f32 vectors read and two written per element against
// eight operations; at P = 60,965,224 (AlexNet) that is 1.71 GB per step,
// 0.510 ms at 3.35 TB/s.
//
// Design: one launch, a grid-stride loop with 16-byte vector loads (float4)
// over the bulk, the ragged tail taken one element by each of the first
// threads, and a grid of a few blocks per SM so the loads keep the memory
// system busy. Every multiply and add is explicitly rounded, in the plain
// version's order (ops/sgd.py), so no fused multiply-add changes the
// rounding; rate*lr_mult is one f32 multiply, as `local_rate = rate *
// lr_vec` rounds in the JAX package.
//
// Two entries share the kernel: poseidon_sgd_update takes the rate by
// value (a float the host computed for this step), and
// poseidon_sgd_update_devrate reads it from device memory at launch, so a
// CUDA graph that captured the launch applies whatever rate the host
// wrote into that float before each replay (under inv, poly, exp and
// sigmoid the rate changes every iteration; a by-value rate would be
// frozen at the captured step's). Every thread reads the one float once;
// the arithmetic is the same, so both entries give the same bits.
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entries return cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void update_one(float& w, float& h, float g,
                                           float lr, float dec, float rate,
                                           float momentum) {
  const float gr = (dec == 0.0f) ? g : __fadd_rn(g, __fmul_rn(dec, w));
  const float hn = __fadd_rn(__fmul_rn(momentum, h),
                             __fmul_rn(__fmul_rn(rate, lr), gr));
  h = hn;
  w = __fsub_rn(w, hn);
}

// kDevRate: the rate is *rate_ptr (read once a thread), else rate_arg.
template <bool kDevRate>
__global__ void sgd_update_kernel(float* __restrict__ w,
                                  float* __restrict__ h,
                                  const float* __restrict__ g,
                                  const float* __restrict__ lr,
                                  const float* __restrict__ dec, int64_t n,
                                  float rate_arg,
                                  const float* __restrict__ rate_ptr,
                                  float momentum) {
  float rate = rate_arg;
  if constexpr (kDevRate) rate = __ldg(rate_ptr);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t n4 = n / 4;
  float4* w4 = reinterpret_cast<float4*>(w);
  float4* h4 = reinterpret_cast<float4*>(h);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* l4 = reinterpret_cast<const float4*>(lr);
  const float4* d4 = reinterpret_cast<const float4*>(dec);
  for (int64_t i = tid; i < n4; i += stride) {
    float4 wv = w4[i], hv = h4[i];
    const float4 gv = g4[i], lv = l4[i], dv = d4[i];
    update_one(wv.x, hv.x, gv.x, lv.x, dv.x, rate, momentum);
    update_one(wv.y, hv.y, gv.y, lv.y, dv.y, rate, momentum);
    update_one(wv.z, hv.z, gv.z, lv.z, dv.z, rate, momentum);
    update_one(wv.w, hv.w, gv.w, lv.w, dv.w, rate, momentum);
    w4[i] = wv;
    h4[i] = hv;
  }
  // the ragged tail (n % 4 < 4 elements): the first threads take one each
  const int64_t i = n4 * 4 + tid;
  if (i < n) {
    float wv = w[i], hv = h[i];
    update_one(wv, hv, g[i], lr[i], dec[i], rate, momentum);
    w[i] = wv;
    h[i] = hv;
  }
}

// The launch shape both entries share: a grid-stride loop of a few blocks
// an SM. Returns a cudaError_t.
template <bool kDevRate>
int launch(void* w, void* h, const void* g, const void* lr, const void* dec,
           long long n, float rate, const void* rate_ptr, float momentum,
           int sm_count, void* stream) {
  const uintptr_t mis = ((uintptr_t)w | (uintptr_t)h | (uintptr_t)g |
                         (uintptr_t)lr | (uintptr_t)dec) & 15u;
  if (mis) return (int)cudaErrorMisalignedAddress;
  if (n <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (n / 4 + threads) / threads;
  const int64_t cap = (int64_t)(sm_count > 0 ? sm_count : 132) * 8;
  if (blocks > cap) blocks = cap;
  sgd_update_kernel<kDevRate><<<(unsigned int)blocks, threads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<float*>(h),
      static_cast<const float*>(g), static_cast<const float*>(lr),
      static_cast<const float*>(dec), n, rate,
      static_cast<const float*>(rate_ptr), momentum);
  return (int)cudaGetLastError();
}

}  // namespace

// All five pointers address n contiguous float32 values. The float4 body
// needs 16-byte aligned pointers; the wrapper passes whole tensors, whose
// storage the caching allocator aligns. One launch covers the whole arena.
// Returns a cudaError_t.
extern "C" int poseidon_sgd_update(void* w, void* h, const void* g,
                                   const void* lr, const void* dec,
                                   long long n, float rate, float momentum,
                                   int sm_count, void* stream) {
  return launch<false>(w, h, g, lr, dec, n, rate, nullptr, momentum,
                       sm_count, stream);
}

// The same update with the rate read from the device float at rate_ptr
// (4-byte aligned) when the kernel runs, not when it is
// launched.
extern "C" int poseidon_sgd_update_devrate(void* w, void* h, const void* g,
                                           const void* lr, const void* dec,
                                           long long n, const void* rate_ptr,
                                           float momentum, int sm_count,
                                           void* stream) {
  if (rate_ptr == nullptr) return (int)cudaErrorInvalidValue;
  return launch<true>(w, h, g, lr, dec, n, 0.0f, rate_ptr, momentum,
                      sm_count, stream);
}
