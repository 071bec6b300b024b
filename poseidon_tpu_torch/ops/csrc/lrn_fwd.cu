// Cross-channel LRN forward for Hopper (sm_90a), NCHW; the channels-last
// (NHWC) kernel follows the NCHW one (poseidon_lrn_nhwc_fwd).
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
// Bound: memory. A few flops and one powf per element against one read and
// one write of x: at AlexNet's batch 256 in f32, norm1 (256,96,55,55) moves
// 594.7 MB (0.178 ms at 3.35 TB/s) and norm2 (256,256,27,27) 382.2 MB
// (0.114 ms), 0.2916 ms for the pair.
//
// Design: the LRN backward's channel-parallel shared-memory tile
// (lrn_bwd.cu). A block of 256 threads owns a chunk of at most 64 channels
// (C split into the fewest equal chunks, as the backward splits it: norm1's
// 96 into two of 48, norm2's 256 into four of 64) times a run of kPos
// consecutive h*w positions of one image. It stages x for the chunk and
// its halo (pre channels before, post = size-1-pre after; zero outside
// [0, C)) in shared memory, read once from device memory and coalesced
// along h*w (h*w is odd at AlexNet's 3025 and 729, so rows do not align to
// 16 bytes across channels and the loads are scalar), and each square once
// beside it. Each thread then forms the window sums of its elements from
// the squares, takes one powf each and writes y coalesced. The halo rows
// inside [0, C) are read by two neighbouring chunks: at size 5, norm1 reads
// x 1.042 times, norm2 1.047 times (1 + (chunks-1)(size-1)/C). Index math is
// 32-bit inside a tile; a tile's first element is found with 64-bit math
// once.
//
// The window sum starts from zero and adds the squares in ascending tap
// order (zeros past the channel range included) with explicitly rounded
// multiplies and adds, and each element takes the same powf call, the
// order of the plain version (ops/lrn.py:lrn_across_channels_plain): no
// fused multiply-add changes the rounding, and the kernel is bitwise equal
// to the plain version on the card. The window size is a template argument
// at 5 (AlexNet's, the only size on the path) and a runtime value
// otherwise; the halo grows with it, and the wrapper caps it at
// MAX_LRN_SIZE, as the backward's. Any C (smaller than the halo too) and
// any h*w work.
//
// (The first version, one thread per (n, h*w position) walking all C
// channels and reloading each window's taps from device memory, measured
// 3.4x its bound; PERF.md keeps both times.)
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch. poseidon_lrn_fwd_attrs reports its registers, shared memory,
// spills and resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LRN_SIZE 32

namespace {

constexpr int kThreads = 256;
constexpr int kPos = 64;       // h*w positions of a tile
constexpr int kMaxChunk = 64;  // channels of a tile, at most
constexpr int kRowStep = kThreads / kPos;  // tile rows a pass of the block

__device__ __forceinline__ float load_as_f32(const float* p) { return *p; }

__device__ __forceinline__ float load_as_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Channels of a tile: C split into the fewest equal chunks of at most
// kMaxChunk.
int chunk_of(int channels) {
  const int n_chunks = (channels + kMaxChunk - 1) / kMaxChunk;
  return (channels + n_chunks - 1) / n_chunks;
}

// Shared-memory bytes of a tile of cc channels: x and its squares for the
// chunk and its halo of size-1 channels.
int tile_bytes(int cc, int size) {
  return (int)sizeof(float) * 2 * (cc + size - 1) * kPos;
}

// SIZE > 0: the window size at compile time; 0: `size` at run time.
// Block b: chunk b % n_chunks of position tile b / n_chunks; a position tile
// is a run of kPos positions of one image.
template <typename T, int SIZE>
__global__ void __launch_bounds__(kThreads)
    lrn_fwd_tile_kernel(const T* __restrict__ x, T* __restrict__ y, int hw,
                        int channels, int chunk, int n_chunks,
                        int tiles_per_image, int size, float alpha_over_size,
                        float neg_beta, float k) {
  const int n = SIZE > 0 ? SIZE : size;
  const int pre = (n - 1) / 2;
  const int b = blockIdx.x;
  const int tile = b / n_chunks;
  const int c0 = (b - tile * n_chunks) * chunk;
  const int cc = min(chunk, channels - c0);  // channels of this chunk
  const int img = tile / tiles_per_image;
  const int p0 = (tile - img * tiles_per_image) * kPos;
  const int np = min(kPos, hw - p0);
  const int64_t base = (int64_t)img * channels * hw + p0;
  const T* xb = x + base;
  T* yb = y + base;

  // row i: channel c0 - pre + i, for the chunk and its halo
  const int rows = cc + n - 1;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sq = sx + rows * kPos;
  const int p = threadIdx.x % kPos;  // this thread's position, every pass
  const int row0 = threadIdx.x / kPos;
  const bool in_run = p < np;

  // stage x and its squares, four rows of loads in flight a thread
  for (int r = row0; r < rows; r += 4 * kRowStep) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 - pre + r + u * kRowStep;
      v[u] = (r + u * kRowStep < rows && in_run && c >= 0 && c < channels)
                 ? load_as_f32(xb + c * hw + p)
                 : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = (r + u * kRowStep) * kPos + p;
      if (r + u * kRowStep < rows) {
        sx[i] = v[u];
        sq[i] = __fmul_rn(v[u], v[u]);
      }
    }
  }
  __syncthreads();
  if (!in_run) return;

  for (int r = row0; r < cc; r += kRowStep) {
    // the window of channel c0 + r is square rows r .. r + n - 1
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < (SIZE > 0 ? SIZE : MAX_LRN_SIZE); ++t) {
      if (SIZE == 0 && t >= n) break;
      acc = __fadd_rn(acc, sq[(r + t) * kPos + p]);
    }
    const float scale = __fadd_rn(k, __fmul_rn(alpha_over_size, acc));
    store_from_f32(yb + (c0 + r) * hw + p,
                   __fmul_rn(sx[(r + pre) * kPos + p], powf(scale, neg_beta)));
  }
}

// Dynamic shared memory above the 48 KB every launch may take (large
// windows) must be opted in to; launches within it skip the host call.
template <typename F>
cudaError_t allow_smem(F kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int SIZE>
int launch_t(const void* x, void* y, long long batch, int channels, int hw,
             int size, float alpha_over_size, float beta, float k,
             cudaStream_t stream) {
  const int chunk = chunk_of(channels);
  const int n_chunks = (channels + chunk - 1) / chunk;
  const int tiles_per_image = (hw + kPos - 1) / kPos;
  const long long blocks = batch * tiles_per_image * n_chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = tile_bytes(chunk, size);
  auto kernel = lrn_fwd_tile_kernel<T, SIZE>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), hw, channels, chunk,
      n_chunks, tiles_per_image, size, alpha_over_size, -beta, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, void* y, long long batch, int channels, int hw,
           int size, float alpha_over_size, float beta, float k,
           cudaStream_t stream) {
  if (size == 5)
    return launch_t<T, 5>(x, y, batch, channels, hw, size, alpha_over_size,
                          beta, k, stream);
  return launch_t<T, 0>(x, y, batch, channels, hw, size, alpha_over_size,
                        beta, k, stream);
}

template <typename T, int SIZE>
int attrs_t(int channels, int size, int* out) {
  const int chunk = chunk_of(channels);
  const int bytes = tile_bytes(chunk, size);
  auto kernel = lrn_fwd_tile_kernel<T, SIZE>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = bytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = kThreads;
  out[5] = blocks;
  out[6] = chunk;
  return 0;
}

bool valid(int channels, int size) {
  return size >= 1 && size <= MAX_LRN_SIZE && channels >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. One image must hold fewer than 2^31
// elements. Returns a cudaError_t (0 = launched).
extern "C" int poseidon_lrn_fwd(const void* x, void* y, int dtype,
                                long long batch, int channels, long long hw,
                                int size, float alpha_over_size, float beta,
                                float k, void* stream) {
  if (!valid(channels, size) || batch < 1 || hw < 1 ||
      channels * hw >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, batch, channels, (int)hw, size,
                         alpha_over_size, beta, k, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, batch, channels, (int)hw, size,
                                 alpha_over_size, beta, k, st);
  return (int)cudaErrorInvalidValue;
}

// The instantiation for dtype and size (5 or the runtime one) at the tile
// of C channels: out[7] = registers a thread, static shared bytes, dynamic
// shared bytes, local (spill) bytes a thread, threads a block, resident
// blocks per SM, the tile's channels. Returns a cudaError_t.
extern "C" int poseidon_lrn_fwd_attrs(int dtype, int channels, int size,
                                      int* out) {
  if (!valid(channels, size)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return size == 5 ? attrs_t<float, 5>(channels, size, out)
                     : attrs_t<float, 0>(channels, size, out);
  if (dtype == 1)
    return size == 5 ? attrs_t<__nv_bfloat16, 5>(channels, size, out)
                     : attrs_t<__nv_bfloat16, 0>(channels, size, out);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The channels-last (NHWC) forward: poseidon_tpu/ops/pallas_kernels.py:
// _lrn_kernel in its layout="NHWC" form (_lrn_specs keeps channels minor).
//
// In NHWC a run of consecutive pixels with all their channels is one
// contiguous stretch of memory, and the channel window slides along the
// contiguous axis. A block of 256 threads owns a run of `pixels`
// consecutive pixels of the N*H*W (about kNhwcElems elements: 42 pixels at
// AlexNet's norm1 C = 96, 16 at norm2's 256) and copies them, coalesced,
// into shared memory, each pixel's channels into a row with zeros around
// them (pre before, post after); then every element is formed by one
// thread from its row: the window's taps squared and summed, one powf. A
// warp takes a pixel, its lanes the channels.
// There is no halo to re-read and no channel chunking; a pixel's row must
// fit one block (MAX_NHWC_CHANNELS, checked by the wrapper). Bound:
// memory, the same bytes as the NCHW kernel (0.2916 ms for AlexNet's pair
// at batch 256 in f32). The arithmetic is the NCHW kernel's and the plain
// version's (window taps from zero in ascending order, the zeros past the
// channel range included, explicitly rounded, the same powf), so it is
// bitwise equal to ops/lrn.py:lrn_across_channels_plain on the same
// channels-last tensor.

#define MAX_NHWC_CHANNELS 4096

namespace {
namespace nhwc {

constexpr int kNhwcElems = 4096;  // elements a forward block, about
constexpr int kMaxSmem = 227 * 1024;

// A block's 8 warps take a pixel each and their 32 lanes the pixel's
// channels (consecutive lanes on consecutive channels: coalesced loads and
// stores, conflict-free shared rows); no thread divides to find its
// element.
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;

// Copy np pixels of C contiguous channels into rows of `row` floats,
// pixel r's channel c at r * row + lead + c.
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int np, int channels, int row,
                                           int lead) {
  const int lane = threadIdx.x % kLanes;
  for (int r = threadIdx.x / kLanes; r < np; r += kWarps) {
    const T* s = src + r * channels;
    float* d = dst + r * row + lead;
#pragma unroll 4
    for (int c = lane; c < channels; c += kLanes) d[c] = load_as_f32(s + c);
  }
}

// Zero the `before` floats ahead of each pixel's channels and the `after`
// floats behind them, in rows of `row` floats.
__device__ __forceinline__ void zero_margins(float* __restrict__ dst, int np,
                                             int channels, int row,
                                             int before, int after) {
  const int lane = threadIdx.x % kLanes;
  for (int r = threadIdx.x / kLanes; r < np; r += kWarps)
    for (int t = lane; t < before + after; t += kLanes)
      dst[r * row + (t < before ? t : channels + t)] = 0.0f;
}

// Block b: pixels [b * pixels, b * pixels + pixels) of all n*h*w pixels.
template <typename T, int SIZE>
__global__ void __launch_bounds__(kThreads)
    lrn_nhwc_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        long long n_pixels, int channels, int pixels,
                        int size, float alpha_over_size, float neg_beta,
                        float k) {
  const int n = SIZE > 0 ? SIZE : size;
  const int pre = (n - 1) / 2;
  const long long p0 = (long long)blockIdx.x * pixels;
  const int np = (int)(n_pixels - p0 < pixels ? n_pixels - p0 : pixels);
  const int row = channels + n - 1;
  extern __shared__ float sx[];
  T* yb = y + p0 * channels;

  zero_margins(sx, np, channels, row, pre, n - 1 - pre);
  stage_rows(sx, x + p0 * channels, np, channels, row, pre);
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  for (int r = threadIdx.x / kLanes; r < np; r += kWarps) {
    for (int c = lane; c < channels; c += kLanes) {
      // the window of channel c is row entries c .. c + n - 1
      const float* w = sx + r * row + c;
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < (SIZE > 0 ? SIZE : MAX_LRN_SIZE); ++t) {
        if (SIZE == 0 && t >= n) break;
        acc = __fadd_rn(acc, __fmul_rn(w[t], w[t]));
      }
      const float scale = __fadd_rn(k, __fmul_rn(alpha_over_size, acc));
      store_from_f32(yb + r * channels + c,
                     __fmul_rn(w[pre], powf(scale, neg_beta)));
    }
  }
}

// Pixels a block: about `elems` elements, at least one pixel, within the
// shared memory a block can take at `floats_a_pixel`.
int pixels_of(int channels, int elems, int floats_a_pixel) {
  int p = elems / channels;
  if (p < 1) p = 1;
  const int cap = kMaxSmem / (4 * floats_a_pixel);
  return p < cap ? p : cap;
}

bool valid(long long n_pixels, int channels, int size) {
  return n_pixels >= 1 && channels >= 1 && channels <= MAX_NHWC_CHANNELS &&
         size >= 1 && size <= MAX_LRN_SIZE;
}

template <typename T, int SIZE>
int fwd_t(const void* x, void* y, long long n_pixels, int channels, int size,
          float alpha_over_size, float beta, float k, cudaStream_t stream) {
  const int row = channels + size - 1;
  const int pixels = pixels_of(channels, kNhwcElems, row);
  const long long blocks = (n_pixels + pixels - 1) / pixels;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bytes = 4 * pixels * row;
  auto kernel = lrn_nhwc_fwd_kernel<T, SIZE>;
  const cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)blocks, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n_pixels, channels,
      pixels, size, alpha_over_size, -beta, k);
  return (int)cudaGetLastError();
}

}  // namespace nhwc
}  // namespace

// x, y: n_pixels pixels of C contiguous channels (an NHWC tensor, n_pixels
// = N*H*W). dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 =
// launched).
extern "C" int poseidon_lrn_nhwc_fwd(const void* x, void* y, int dtype,
                                     long long n_pixels, int channels,
                                     int size, float alpha_over_size,
                                     float beta, float k, void* stream) {
  if (!nhwc::valid(n_pixels, channels, size))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace nhwc;
  if (dtype == 0) {
    auto f = size == 5 ? fwd_t<float, 5> : fwd_t<float, 0>;
    return f(x, y, n_pixels, channels, size, alpha_over_size, beta, k, st);
  }
  if (dtype == 1) {
    auto f = size == 5 ? fwd_t<__nv_bfloat16, 5> : fwd_t<__nv_bfloat16, 0>;
    return f(x, y, n_pixels, channels, size, alpha_over_size, beta, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

