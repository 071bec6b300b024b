// Cross-channel LRN backward for Hopper (sm_90a), NCHW; the channels-last
// (NHWC) kernel follows the NCHW one (poseidon_lrn_nhwc_bwd).
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

#include "lrn_nhwc.cuh"
#include "vec.cuh"

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


// ---------------------------------------------------------------------------
// The channels-last (NHWC) backward: poseidon_tpu/ops/pallas_kernels.py:
// _lrn_bwd_kernel in its layout="NHWC" form, the same s, r and dx on tensors
// whose C channels of a pixel are contiguous.
//
// Bound: by its bytes, memory (0.4374 ms for AlexNet's pair at batch 256 in
// f32, 0.2188 in bf16); by its instructions, the two powf an element, which
// stay because the plain version calls pow twice (poseidon_lrn_powf_floor
// times them alone: on the H100 they take longer than the bytes). So the
// design spends as little else as it can: no shared memory, no barrier,
// every element loaded and stored once as part of a vector, the window
// sums from registers.
//
// Design: registers and warp shuffles. A warp owns a run of `pixels`
// consecutive pixels, one contiguous stream of pixels * C elements, and
// walks it in rounds of 32 * V elements: lane l holds the V consecutive
// elements at l * V of the round, loaded and stored as one access (V = 4
// where C and the pointers allow: 16 bytes in f32, 8 in bf16; else 2 or 1:
// the wrapper's ops/vector.vector_width). V divides C, so a lane's elements
// lie in one pixel; a round may end one pixel and start the next, so no
// lane idles but in a run's last round (the C entry picks the run: about
// kRounds rounds, whole ones where a few pixels fill them: norm1 20 pixels
// in 15 rounds, norm2 8 in 16). The window taps beyond a lane's own
// elements (pre before and post after for s, post before and pre after for
// r) come from the lanes next to it by __shfl_sync, from the previous
// round for lane 0 and the next for lane 31; a tap in another pixel (its
// channel outside [0, C)) is zero (the window, the run and the helpers
// shared with K4-NHWC are in lrn_nhwc.cuh). r of a neighbour is that lane's
// own r, so no channel's s or powf is computed twice. The rounds are a
// pipeline: at step k the loads of round k+2 are issued, round k+1 is
// converted, then round k's s, r and first term and round k-1's dx are
// computed, so a round's loads are in flight while the warp computes.
//
// Both window sums start from 0.0f and add the taps in ascending order with
// __fmul_rn and __fadd_rn, each element takes the same two powf, and the
// terms are formed in the plain version's order: the kernel is bitwise
// equal to ops/lrn.py:lrn_bwd_plain on the same channels-last tensors. A
// window of 5 (AlexNet's) is compiled in for every V; other windows (1 to
// MAX_LRN_SIZE) take their size at run time with V = 1, a tap at a time.

// channels a lane, at most: at 8 (16 bytes of bf16) a lane holds about 112
// registers and an SM 4 blocks, which ran slower than 4 channels (71-80
// registers, 6-7 blocks)
#define MAX_NHWC_LANE_CHANNELS 4

namespace {
namespace nhwc {

using namespace lrn_nhwc;

constexpr int kWarps = 4;   // warps a block
constexpr int kRounds = 16;  // rounds a warp's run, about
constexpr int kThreadsBwd = kLanes * kWarps;

// The raw words of x and g at a lane's elements of round j, zero past the
// run's len elements
template <typename T, int V>
__device__ __forceinline__ void fetch_round(const T* __restrict__ x,
                                            const T* __restrict__ g, int j,
                                            int lane, int len, unsigned* wx,
                                            unsigned* wg) {
  constexpr int W = vec::words<V * (int)sizeof(T)>();
  const int at = j * kLanes * V + lane * V;
#pragma unroll
  for (int i = 0; i < W; ++i) wx[i] = wg[i] = 0u;
  if (at < len) {
    vec::load_raw<T, V>(x + at, wx);
    vec::load_raw<T, V>(g + at, wg);
  }
}

// SIZE > 0: the window at compile time; 0: `size` at run time (V = 1).
template <typename T, int V, int SIZE>
__global__ void __launch_bounds__(kThreadsBwd)
    lrn_nhwc_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        T* __restrict__ dx, long long n_pixels, int channels,
                        int pixels, int size, float alpha_over_size,
                        float neg_beta, float neg_beta_m1, float coef,
                        float k) {
  static_assert(SIZE > 0 || V == 1, "a run-time window takes V = 1");
  constexpr int kPre = SIZE > 0 ? (SIZE - 1) / 2 : 0;
  constexpr int kPost = SIZE > 0 ? SIZE - 1 - kPre : 0;
  constexpr int R = kLanes * V;  // elements a round
  constexpr int W = vec::words<V * (int)sizeof(T)>();
  const int lane = threadIdx.x % kLanes;
  const long long p0 =
      ((long long)blockIdx.x * kWarps + threadIdx.x / kLanes) * pixels;
  if (p0 >= n_pixels) return;  // the whole warp
  const long long np = n_pixels - p0 < pixels ? n_pixels - p0 : pixels;
  const int len = (int)np * channels;
  const int rounds = (len + R - 1) / R;
  const int step = R % channels;  // a lane's channel advances by this a round
  const int pre = SIZE > 0 ? kPre : (size - 1) / 2;
  const int post = SIZE > 0 ? kPost : size - 1 - pre;
  x += p0 * channels;
  g += p0 * channels;
  dx += p0 * channels;


  // x, g and the squares of rounds k-1, k, k+1; r of k-2, k-1, k; the
  // first term of k-1, k; the channel of the lane's first element in
  // rounds k-1 and k
  float xp[V], xc[V], xn[V], gc[V], gn[V], qp[V], qc[V], qn[V];
  float rp2[V], rp[V], rc[V], fp[V], fc[V];
  unsigned wx[W], wg[W], wx2[W], wg2[W];
  fetch_round<T, V>(x, g, 0, lane, len, wx, wg);
  vec::unpack<T, V>(wx, xc);
  vec::unpack<T, V>(wg, gc);
  fetch_round<T, V>(x, g, 1, lane, len, wx, wg);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    qc[i] = __fmul_rn(xc[i], xc[i]);
    xp[i] = qp[i] = rp2[i] = rp[i] = fp[i] = 0.0f;
  }
  int c_prev = 0, c_cur = (lane * V) % channels;

  for (int kk = 0; kk <= rounds; ++kk) {
    fetch_round<T, V>(x, g, kk + 2, lane, len, wx2, wg2);
    vec::unpack<T, V>(wx, xn);
    vec::unpack<T, V>(wg, gn);
#pragma unroll
    for (int i = 0; i < V; ++i) qn[i] = __fmul_rn(xn[i], xn[i]);

    // s, r and the first term of round kk
    if (kk < rounds) {
      float ws[V];
      if (SIZE > 0) {
        window<V, kPre, kPost>(qp, qc, qn, c_cur, channels, lane, ws);
      } else {
        ws[0] = window_rt(qp[0], qc[0], qn[0], c_cur, channels, lane, pre,
                          size);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float s = __fadd_rn(k, __fmul_rn(alpha_over_size, ws[i]));
        rc[i] = __fmul_rn(__fmul_rn(gc[i], xc[i]), powf(s, neg_beta_m1));
        fc[i] = __fmul_rn(gc[i], powf(s, neg_beta));
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) rc[i] = fc[i] = 0.0f;
    }

    // dx of round kk-1 from the r window (post before, pre after)
    if (kk > 0) {
      float rs[V], out[V];
      if (SIZE > 0) {
        window<V, kPost, kPre>(rp2, rp, rc, c_prev, channels, lane, rs);
      } else {
        rs[0] = window_rt(rp2[0], rp[0], rc[0], c_prev, channels, lane,
                          post, size);
      }
#pragma unroll
      for (int i = 0; i < V; ++i)
        out[i] = __fsub_rn(fp[i], __fmul_rn(__fmul_rn(coef, xp[i]), rs[i]));
      const int at = (kk - 1) * R + lane * V;
      if (at < len) vec::store<T, V>(dx + at, out);
    }

#pragma unroll
    for (int i = 0; i < V; ++i) {
      xp[i] = xc[i];
      xc[i] = xn[i];
      gc[i] = gn[i];
      qp[i] = qc[i];
      qc[i] = qn[i];
      rp2[i] = rp[i];
      rp[i] = rc[i];
      fp[i] = fc[i];
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      wx[i] = wx2[i];
      wg[i] = wg2[i];
    }
    c_prev = c_cur;
    c_cur += step;
    if (c_cur >= channels) c_cur -= channels;
  }
}

// The powf floor: only the powf an element of an LRN kernel, over n
// elements from registers (s from the element's index, in the range the
// layer's s takes), one float a thread written so that nothing is dropped.
// POWFS = 2: the backward's two (s^(-beta-1) and s^(-beta)); 1: the
// forward's one (s^(-beta)).
template <int POWFS>
__global__ void __launch_bounds__(256)
    lrn_powf_floor_kernel(long long n, float alpha_over_size,
                          float neg_beta, float neg_beta_m1, float k,
                          float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  for (long long i = t; i < n; i += stride) {
    const float s =
        __fadd_rn(k, __fmul_rn(alpha_over_size, (float)(int)(i & 1023)));
    if (POWFS == 2)
      acc = __fadd_rn(acc,
                      __fadd_rn(powf(s, neg_beta_m1), powf(s, neg_beta)));
    else
      acc = __fadd_rn(acc, powf(s, neg_beta));
  }
  out[t] = acc;
}

bool valid(long long n_pixels, int channels, int size) {
  return n_pixels >= 1 && channels >= 1 && channels <= MAX_NHWC_CHANNELS &&
         size >= 1 && size <= MAX_LRN_SIZE;
}

// the channels of a lane: 1, 2 or 4 (MAX_NHWC_LANE_CHANNELS)
bool valid_vec(int v) {
  return v >= 1 && v <= MAX_NHWC_LANE_CHANNELS && (v & (v - 1)) == 0;
}

struct Args {
  const void* x;
  const void* g;
  void* dx;
  long long n_pixels;
  int channels, size;
  float alpha_over_size, neg_beta, neg_beta_m1, coef, k;
};

// launch (out == nullptr) or report attributes of one instantiation
template <typename T, int V, int SIZE>
int run_t(const Args& a, cudaStream_t stream, int* out) {
  auto kernel = lrn_nhwc_bwd_kernel<T, V, SIZE>;
  if (out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kThreadsBwd, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.sharedSizeBytes;
    out[2] = 0;
    out[3] = (int)fa.localSizeBytes;
    out[4] = kThreadsBwd;
    out[5] = blocks;
    return 0;
  }
  const int pixels = pixels_per_warp(a.n_pixels, a.channels, kLanes * V,
                                     kRounds);
  const long long warps = (a.n_pixels + pixels - 1) / pixels;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL ||
      (long long)pixels * a.channels >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned int)blocks, kThreadsBwd, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g),
      static_cast<T*>(a.dx), a.n_pixels, a.channels, pixels, a.size,
      a.alpha_over_size, a.neg_beta, a.neg_beta_m1, a.coef, a.k);
  return (int)cudaGetLastError();
}

// the instantiation for dtype, vec and the window; a window other than 5
// runs one element a lane
template <typename T>
int run(int vec, const Args& a, cudaStream_t stream, int* out) {
  if (a.size != 5) return run_t<T, 1, 0>(a, stream, out);
  switch (vec) {
    case 1:
      return run_t<T, 1, 5>(a, stream, out);
    case 2:
      return run_t<T, 2, 5>(a, stream, out);
    default:
      return run_t<T, 4, 5>(a, stream, out);
  }
}

int dispatch(int dtype, int vec, const Args& a, cudaStream_t stream,
             int* out) {
  if (!valid_vec(vec)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run<float>(vec, a, stream, out);
  if (dtype == 1) return run<__nv_bfloat16>(vec, a, stream, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace nhwc
}  // namespace

// x, g, dx channels-last (n_pixels, C) tensors, C at most MAX_NHWC_CHANNELS;
// vec: the channels a lane moves as one access (ops/vector.vector_width),
// 1, 2 or 4, dividing C, every pointer aligned to vec elements. The scalars arrive rounded to float from
// the wrapper's doubles (alpha/size, -beta, -beta-1, 2*alpha*beta/size),
// the same floats the plain version's scalar operands round to. Returns a
// cudaError_t.
extern "C" int poseidon_lrn_nhwc_bwd(const void* x, const void* g, void* dx,
                                     int dtype, long long n_pixels,
                                     int channels, int vec, int size,
                                     float alpha_over_size, float neg_beta,
                                     float neg_beta_m1, float coef, float k,
                                     void* stream) {
  if (!nhwc::valid(n_pixels, channels, size) || !nhwc::valid_vec(vec) ||
      channels % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = vec * (dtype == 0 ? 4 : 2);
  if (!nhwc::aligned(x, bytes) || !nhwc::aligned(g, bytes) ||
      !nhwc::aligned(dx, bytes))
    return (int)cudaErrorInvalidValue;
  const nhwc::Args a{x,    g,        dx,          n_pixels, channels,
                     size, alpha_over_size, neg_beta, neg_beta_m1, coef, k};
  return nhwc::dispatch(dtype, vec, a, static_cast<cudaStream_t>(stream),
                        nullptr);
}

// The instantiation for dtype, vec and the window: out[6] = registers a
// thread, static shared bytes, dynamic shared bytes, local (spill) bytes a
// thread, threads a block, resident blocks per SM. Returns a cudaError_t.
extern "C" int poseidon_lrn_nhwc_bwd_attrs(int dtype, int vec, int size,
                                           int* out) {
  if (size < 1 || size > MAX_LRN_SIZE) return (int)cudaErrorInvalidValue;
  nhwc::Args a{};
  a.size = size;
  return nhwc::dispatch(dtype, vec, a, nullptr, out);
}

// The powf of an LRN kernel alone over n elements (see
// lrn_powf_floor_kernel): powfs = 2 for the backward's two an element, 1
// for the forward's one; out holds blocks * 256 floats. Returns a
// cudaError_t.
extern "C" int poseidon_lrn_powf_floor(long long n, int blocks, int powfs,
                                       float alpha_over_size, float neg_beta,
                                       float neg_beta_m1, float k, void* out,
                                       void* stream) {
  if (n < 1 || blocks < 1 || (powfs != 1 && powfs != 2))
    return (int)cudaErrorInvalidValue;
  auto kernel = powfs == 2 ? nhwc::lrn_powf_floor_kernel<2>
                           : nhwc::lrn_powf_floor_kernel<1>;
  kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      n, alpha_over_size, neg_beta, neg_beta_m1, k, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
