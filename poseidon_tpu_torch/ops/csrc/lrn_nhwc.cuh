// The warp schedule of the channels-last LRN kernels, K4-NHWC (lrn_fwd.cu)
// and K5-NHWC (lrn_bwd.cu): a warp's run of consecutive pixels walked as
// one stream of pixels * C elements in rounds of 32 lanes x V channels, the
// channel window's taps taken from the neighbouring lanes by __shfl_sync
// (lane 0 from the previous round, lane 31 from the next), zero where the
// tap's channel leaves [0, C).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_NHWC_CHANNELS 4096

namespace lrn_nhwc {

constexpr int kLanes = 32;
constexpr int kMinWarps = 132 * 32;    // warps to fill the card's SMs
constexpr unsigned kAll = 0xffffffffu;

// The window sums of a lane's V elements: out[i] = the sum over t of
// e[i + t], t = 0 .. LO + HI, where e is the lane's elements with LO taps
// before (from the lanes below, lane 0 from `prev`) and HI after (from the
// lanes above, lane 31 from `next`), zero outside [0, C). c is the channel
// of the lane's first element. (One shuffle a tap, each lane sending the
// round its reader wants, saved no time and cost a spill in f32.)
template <int V, int LO, int HI>
__device__ __forceinline__ void window(const float (&prev)[V],
                                       const float (&cur)[V],
                                       const float (&next)[V], int c,
                                       int channels, int lane,
                                       float (&out)[V]) {
  float e[LO + V + HI];
#pragma unroll
  for (int h = -LO; h < 0; ++h) {
    const int s = -((-h + V - 1) / V);  // lanes away, rounded down
    const int j = h - s * V;
    const int src = lane + s;
    const float a = __shfl_sync(kAll, cur[j], src & (kLanes - 1));
    const float b = __shfl_sync(kAll, prev[j], src & (kLanes - 1));
    e[LO + h] = c + h >= 0 ? (src >= 0 ? a : b) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) e[LO + i] = cur[i];
#pragma unroll
  for (int h = V; h < V + HI; ++h) {
    const int s = h / V, j = h % V;
    const int src = lane + s;
    const float a = __shfl_sync(kAll, cur[j], src & (kLanes - 1));
    const float b = __shfl_sync(kAll, next[j], src & (kLanes - 1));
    e[LO + h] = c + h < channels ? (src < kLanes ? a : b) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t <= LO + HI; ++t) acc = __fadd_rn(acc, e[i + t]);
    out[i] = acc;
  }
}

// The same for one element a lane (V = 1) and a window of n taps, lo of
// them before, taken at run time a tap at a time.
__device__ __forceinline__ float window_rt(float prev, float cur, float next,
                                          int c, int channels, int lane,
                                          int lo, int n) {
  float acc = 0.0f;
  for (int t = 0; t < n; ++t) {
    const int d = t - lo;
    const int src = lane + d;
    const float a = __shfl_sync(kAll, cur, src & (kLanes - 1));
    const float b = __shfl_sync(kAll, d < 0 ? prev : next,
                                src & (kLanes - 1));
    const float v = (src >= 0 && src < kLanes) ? a : b;
    acc = __fadd_rn(acc, (c + d >= 0 && c + d < channels) ? v : 0.0f);
  }
  return acc;
}

inline int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Pixels a warp's run: about `rounds` rounds, in whole rounds where a few
// pixels fill them (`unit` pixels end on a round), fewer when the tensor
// is too small to give every SM kMinWarps / 132 warps.
inline int pixels_per_warp(long long n_pixels, int channels,
                           int round_elems, int rounds) {
  const int unit = round_elems / gcd(channels, round_elems);
  long long p = (long long)rounds * round_elems / channels;
  if (p < 1) p = 1;
  if (unit <= p) p = p / unit * unit;
  const long long cap = (n_pixels + kMinWarps - 1) / kMinWarps;
  if (p > cap) p = cap;
  return (int)p;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace lrn_nhwc
