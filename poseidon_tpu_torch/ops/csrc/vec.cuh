// Vector accesses of the channels-last kernels (lrn_fwd.cu, lrn_bwd.cu,
// pool_bwd.cu):
// V consecutive elements of float or bfloat16 moved as one access of
// V * sizeof(T) bytes (16, 8, 4 or 2), converted to and from f32 exactly as
// __bfloat162float and __float2bfloat16_rn convert one element.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace vec {

// the access type of B bytes
template <int B>
struct Raw;
template <>
struct Raw<16> {
  using type = uint4;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<4> {
  using type = unsigned int;
};
template <>
struct Raw<2> {
  using type = unsigned short;
};

// 32-bit words of a B-byte access (a 2-byte access in the low half)
template <int B>
__host__ __device__ constexpr int words() {
  return B < 4 ? 1 : B / 4;
}

__device__ __forceinline__ void split(const uint4& r, unsigned* w) {
  w[0] = r.x;
  w[1] = r.y;
  w[2] = r.z;
  w[3] = r.w;
}
__device__ __forceinline__ void split(const uint2& r, unsigned* w) {
  w[0] = r.x;
  w[1] = r.y;
}
__device__ __forceinline__ void split(unsigned r, unsigned* w) { w[0] = r; }
__device__ __forceinline__ void split(unsigned short r, unsigned* w) {
  w[0] = r;
}

__device__ __forceinline__ void join(const unsigned* w, uint4& r) {
  r = make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ void join(const unsigned* w, uint2& r) {
  r = make_uint2(w[0], w[1]);
}
__device__ __forceinline__ void join(const unsigned* w, unsigned& r) {
  r = w[0];
}
__device__ __forceinline__ void join(const unsigned* w, unsigned short& r) {
  r = (unsigned short)w[0];
}

// the raw words of V elements of T at p (aligned to V * sizeof(T))
template <typename T, int V>
__device__ __forceinline__ void load_raw(const T* p, unsigned* w) {
  using R = typename Raw<V * (int)sizeof(T)>::type;
  split(*reinterpret_cast<const R*>(p), w);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const unsigned* w, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (sizeof(T) == 4)
      f[i] = __uint_as_float(w[i]);
    else
      f[i] = __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u)
                                     : (w[i >> 1] << 16));
  }
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&f)[V]) {
  unsigned w[words<V * (int)sizeof(T)>()];
  load_raw<T, V>(p, w);
  unpack<T, V>(w, f);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&f)[V]) {
  constexpr int B = V * (int)sizeof(T);
  unsigned w[words<B>()];
#pragma unroll
  for (int i = 0; i < words<B>(); ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if constexpr (sizeof(T) == 4)
      w[i] = __float_as_uint(f[i]);
    else
      w[i >> 1] |= (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[i]))
                   << (16 * (i & 1));
  }
  typename Raw<B>::type r;
  join(w, r);
  *reinterpret_cast<typename Raw<B>::type*>(p) = r;
}

// V 16-bit codes from their raw words (load_raw<uint16_t, V>), as ints,
// and V codes stored at p (aligned to 2V bytes)
template <int V>
__device__ __forceinline__ void unpack_u16(const unsigned* w, int (&c)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) c[i] = (int)((w[i >> 1] >> (16 * (i & 1))) &
                                           0xffffu);
}

template <int V>
__device__ __forceinline__ void store_u16(uint16_t* p, const int (&c)[V]) {
  unsigned w[words<2 * V>()];
#pragma unroll
  for (int i = 0; i < words<2 * V>(); ++i) w[i] = 0u;
#pragma unroll
  for (int i = 0; i < V; ++i)
    w[i >> 1] |= ((unsigned)c[i] & 0xffffu) << (16 * (i & 1));
  typename Raw<2 * V>::type r;
  join(w, r);
  *reinterpret_cast<typename Raw<2 * V>::type*>(p) = r;
}

// B bytes from global to shared memory: cp.async for 4, 8 and 16 bytes
// (completed by __pipeline_commit and __pipeline_wait_prior), a plain
// copy for 2
template <int B>
__device__ __forceinline__ void copy_async(void* shared_dst,
                                           const void* global_src) {
  if constexpr (B >= 4)
    __pipeline_memcpy_async(shared_dst, global_src, B);
  else
    *static_cast<unsigned short*>(shared_dst) =
        *static_cast<const unsigned short*>(global_src);
}

}  // namespace vec
