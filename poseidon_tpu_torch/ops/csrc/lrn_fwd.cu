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

#include "lrn_nhwc.cuh"
#include "vec.cuh"

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
// Bound: by its bytes, memory (0.2916 ms for AlexNet's pair at batch 256 in
// f32, 0.1458 in bf16); by its instructions, the one powf an element, which
// stays because the plain version calls pow (poseidon_lrn_powf_floor with
// powfs = 1 times it alone). So the design spends as little else as it
// can: no shared memory, no barrier, every element loaded and stored once
// as part of a vector, each squared once, the window sums from registers.
//
// Design: K5-NHWC's (lrn_bwd.cu) with one input stream, on the schedule of
// lrn_nhwc.cuh. A warp owns a run of `pixels` consecutive pixels, one
// contiguous stream of pixels * C elements, and walks it in rounds of 32 * V
// elements: lane l holds the V consecutive elements at l * V of the round,
// loaded and stored as one access (V from the wrapper's
// ops/vector.vector_width: 16 bytes where C and the pointers allow, 4 f32
// or 8 bf16 channels; else fewer). V divides C, so a lane's elements lie in
// one pixel; a round may end one pixel and start the next (the C entry
// picks the run: about kRounds rounds, whole ones where a few pixels fill
// them: norm1 16 pixels in 12 rounds in f32, 32 in bf16; norm2 6 and 12).
// Blocks of 4 warps. Each element is squared once; the window's taps beyond a lane's
// own V squares (pre before, post after) come from the lanes next to it by
// __shfl_sync, from the previous round for lane 0 and the next for lane 31,
// and a tap in another pixel (its channel outside [0, C)) is zero. With
// MAX_LRN_SIZE 32 and V = 1 a tap lies at most 16 lanes away, so one
// neighbouring round is always enough. The rounds are a pipeline: at step
// k the loads of round k+2 are issued, round k+1 is converted and squared,
// then round k's y is computed and stored, so a round's loads are in flight
// while the warp takes its powf.
//
// The window sum starts from 0.0f and adds the squares in ascending tap
// order (zeros past the channel range included) with __fmul_rn and
// __fadd_rn, scale = k + alpha/size * sum, y = x * powf(scale, -beta): the
// NCHW kernel's arithmetic and the plain version's, so the kernel is
// bitwise equal to ops/lrn.py:lrn_across_channels_plain on the same
// channels-last tensor. A window of 5 (AlexNet's) is compiled in for every
// V; other windows (1 to MAX_LRN_SIZE) take their size at run time with
// V = 1, a tap at a time. A pixel's C is capped at MAX_NHWC_CHANNELS, as
// the backward's, which takes the forward's tensors.
//
// (The first version staged a block's pixels in shared memory as f32 rows
// with zero margins, then squared every tap of every window again; PERF.md
// keeps both times.)

// channels a lane, at most: 8 bf16 channels are 16 bytes
#define MAX_NHWC_FWD_LANE_CHANNELS 8

namespace {
namespace nhwc {

using namespace lrn_nhwc;

// warps a block and rounds a warp's run, about: blocks of 8 warps and runs
// of 16 rounds (K5-NHWC's) ran 1-5% slower on the H100 (PERF.md)
constexpr int kWarps = 4;
constexpr int kRounds = 12;
constexpr int kThreadsFwd = kLanes * kWarps;

// The raw words of x at a lane's elements of round j, zero past the run's
// len elements
template <typename T, int V>
__device__ __forceinline__ void fetch_round(const T* __restrict__ x, int j,
                                            int lane, int len, unsigned* w) {
  constexpr int W = vec::words<V * (int)sizeof(T)>();
  const int at = j * kLanes * V + lane * V;
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u;
  if (at < len) vec::load_raw<T, V>(x + at, w);
}

// SIZE > 0: the window at compile time; 0: `size` at run time (V = 1).
template <typename T, int V, int SIZE>
__global__ void __launch_bounds__(kThreadsFwd)
    lrn_nhwc_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                        long long n_pixels, int channels, int pixels,
                        int size, float alpha_over_size, float neg_beta,
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
  x += p0 * channels;
  y += p0 * channels;

  // x of round k; the squares of rounds k-1, k, k+1; the raw words of
  // rounds k+1 and k+2; the channel of the lane's first element in round k
  float xc[V], xn[V], qp[V], qc[V], qn[V];
  unsigned w[W], w2[W];
  fetch_round<T, V>(x, 0, lane, len, w);
  vec::unpack<T, V>(w, xc);
  fetch_round<T, V>(x, 1, lane, len, w);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    qc[i] = __fmul_rn(xc[i], xc[i]);
    qp[i] = 0.0f;
  }
  int c = (lane * V) % channels;

  for (int kk = 0; kk < rounds; ++kk) {
    fetch_round<T, V>(x, kk + 2, lane, len, w2);
    vec::unpack<T, V>(w, xn);
#pragma unroll
    for (int i = 0; i < V; ++i) qn[i] = __fmul_rn(xn[i], xn[i]);

    float ws[V], out[V];
    if (SIZE > 0) {
      window<V, kPre, kPost>(qp, qc, qn, c, channels, lane, ws);
    } else {
      ws[0] = window_rt(qp[0], qc[0], qn[0], c, channels, lane, pre, size);
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float scale = __fadd_rn(k, __fmul_rn(alpha_over_size, ws[i]));
      out[i] = __fmul_rn(xc[i], powf(scale, neg_beta));
    }
    const int at = kk * R + lane * V;
    if (at < len) vec::store<T, V>(y + at, out);

#pragma unroll
    for (int i = 0; i < V; ++i) {
      xc[i] = xn[i];
      qp[i] = qc[i];
      qc[i] = qn[i];
    }
#pragma unroll
    for (int i = 0; i < W; ++i) w[i] = w2[i];
    c += step;
    if (c >= channels) c -= channels;
  }
}

bool valid(long long n_pixels, int channels, int size) {
  return n_pixels >= 1 && channels >= 1 && channels <= MAX_NHWC_CHANNELS &&
         size >= 1 && size <= MAX_LRN_SIZE;
}

// the channels of a lane: 1, 2, 4 or 8 (MAX_NHWC_FWD_LANE_CHANNELS), at
// most 16 bytes
bool valid_vec(int v, int dtype) {
  return v >= 1 && v <= MAX_NHWC_FWD_LANE_CHANNELS && (v & (v - 1)) == 0 &&
         v * (dtype == 0 ? 4 : 2) <= 16;
}

struct Args {
  const void* x;
  void* y;
  long long n_pixels;
  int channels, size;
  float alpha_over_size, neg_beta, k;
};

// launch (out == nullptr) or report attributes of one instantiation
template <typename T, int V, int SIZE>
int run_t(const Args& a, cudaStream_t stream, int* out) {
  auto kernel = lrn_nhwc_fwd_kernel<T, V, SIZE>;
  if (out) {
    cudaFuncAttributes fa;
    cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kThreadsFwd, 0);
    if (err != cudaSuccess) return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.sharedSizeBytes;
    out[2] = 0;
    out[3] = (int)fa.localSizeBytes;
    out[4] = kThreadsFwd;
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
  kernel<<<(unsigned int)blocks, kThreadsFwd, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<T*>(a.y), a.n_pixels,
      a.channels, pixels, a.size, a.alpha_over_size, a.neg_beta, a.k);
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
    case 4:
      return run_t<T, 4, 5>(a, stream, out);
    default:
      if constexpr (sizeof(T) == 2) return run_t<T, 8, 5>(a, stream, out);
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int vec, const Args& a, cudaStream_t stream,
             int* out) {
  if (!valid_vec(vec, dtype)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return run<float>(vec, a, stream, out);
  if (dtype == 1) return run<__nv_bfloat16>(vec, a, stream, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace nhwc
}  // namespace

// x, y: n_pixels pixels of C contiguous channels (an NHWC tensor, n_pixels
// = N*H*W), C at most MAX_NHWC_CHANNELS. dtype: 0 = float32, 1 = bfloat16.
// vec: the channels a lane moves as one access (ops/vector.vector_width),
// 1, 2, 4 or 8 within 16 bytes, dividing C, both pointers aligned to vec
// elements. The scalars arrive rounded to float from the wrapper's doubles
// (alpha/size, beta), the same floats the plain version's scalar operands
// round to. Returns a cudaError_t (0 = launched).
extern "C" int poseidon_lrn_nhwc_fwd(const void* x, void* y, int dtype,
                                     long long n_pixels, int channels,
                                     int vec, int size, float alpha_over_size,
                                     float beta, float k, void* stream) {
  if (!nhwc::valid(n_pixels, channels, size) ||
      !nhwc::valid_vec(vec, dtype) || channels % vec != 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = vec * (dtype == 0 ? 4 : 2);
  if (!nhwc::aligned(x, bytes) || !nhwc::aligned(y, bytes))
    return (int)cudaErrorInvalidValue;
  const nhwc::Args a{x, y, n_pixels, channels, size, alpha_over_size, -beta,
                     k};
  return nhwc::dispatch(dtype, vec, a, static_cast<cudaStream_t>(stream),
                        nullptr);
}

// The instantiation for dtype, vec and the window: out[6] = registers a
// thread, static shared bytes, dynamic shared bytes, local (spill) bytes a
// thread, threads a block, resident blocks per SM. Returns a cudaError_t.
extern "C" int poseidon_lrn_nhwc_fwd_attrs(int dtype, int vec, int size,
                                           int* out) {
  if (size < 1 || size > MAX_LRN_SIZE) return (int)cudaErrorInvalidValue;
  nhwc::Args a{};
  a.size = size;
  return nhwc::dispatch(dtype, vec, a, nullptr, out);
}
