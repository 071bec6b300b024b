// Pooling backward (MAX and AVE) for Hopper (sm_90a), NCHW; the channels-
// last (NHWC) kernel follows the NCHW one (poseidon_pool_nhwc_bwd).
//
// Replaces poseidon_tpu/ops/pallas_kernels.py:_pool_bwd_kernel (the Pallas
// TPU kernel reached through pool_bwd_plane, routed by ops/nn.py:_pool_bwd):
// the gradient of Caffe pooling on the padded input, cropped to exactly the
// extent the output grid consumes, with the padding cropped off again.
//
//   MAX: each window's cotangent goes to the FIRST maximum of the window
//        (Caffe's strict `>` update over row-major taps), recomputed from x;
//        pad positions count as -inf and NaN never wins. A window with no
//        value above -inf keeps the initial argmax, flat index 0 of the
//        whole padded, cropped plane (width pwidth = (ow-1)*sw + kw): only
//        window (0, 0) covers that position, so any other such window's
//        cotangent is dropped (the rule of the plain taps version,
//        ops/pool.py:pool_bwd_plain).
//   AVE: each window's cotangent divided by Caffe's divisor (the window
//        clipped to the padded extent) goes to every position it covers.
//
// Bound: memory. The arithmetic is a few compares per tap against reading
// x and g once and writing dx once: at AlexNet's batch 256 in f32, pool1
// moves 666.4 MB (0.199 ms at 3.35 TB/s), pool2 426.5 MB (0.127 ms), pool5
// 98.0 MB (0.029 ms), 0.3555 ms for the three.
//
// Design: one launch, one pass over shared-memory bands, no global scratch.
// A block of 128 threads owns a band of dx rows of one plane, or the whole
// plane of each of several consecutive planes (pool2's 27x27 planes go 5
// to a block, pool5's 13x13 ones 24); the wrapper (ops/pool.py:
// pool_band_plan) sizes the band to a shared-memory budget and passes
// band_rows, planes_per_block and the most x rows and window rows any band
// stages; the C entry checks that this fits 227 KB. For its band the block
//   1. stages the x rows its covering windows read (MAX only) and
//   2. the g rows of those windows, each plane's rows contiguous in NCHW,
//      loaded coalesced, four loads in flight a thread, converted to f32;
//   3. MAX: takes each window's first maximum once from shared memory and
//      codes where its cotangent goes: the element (if it lies in this
//      band) and the window's slot, its rank among the windows covering
//      the element, output row and column descending (for tap (a, b) of
//      window (oy, ox): min(a / sh, oh-1-oy) and min(b / sw, ow-1-ox), at
//      most min(ceil(kh / sh), oh) x min(ceil(kw / sw), ow) slots, one for
//      a global pool). Then, over the x rows' space zeroed as the band's
//      dx, one pass a slot in ascending order adds each window's cotangent
//      to its element: in a pass an element takes at most one window, so
//      no atomics are needed and every element adds its windows in the
//      plain version's order.
//      AVE: divides each window's g by its divisor once, then each dx
//      element gathers its covering windows (two small shared tables give
//      the range of each band row and column) in that order;
//   4. writes the band's dx coalesced, once.
// Windows on a band boundary are recomputed by both neighbouring blocks,
// identically. x and g come from device memory about once and dx is
// written once. Threads walk (plane, row, column) with increments, not
// divisions. A 3 x 3 window is a template instantiation (its taps
// unrolled); other windows take their size at run time.
//
// Every dx element is summed from 0.0f with explicitly rounded adds in the
// plain version's order (taps (dh, dw) row-major: covering windows with
// the output row and column descending), and AVE's divisor is the product
// of the two axis extents rounded once, the division IEEE: the kernel is
// bitwise equal to the plain version. (MAX adds only the windows whose
// argmax is the element; the plain version also adds 0.0f for the others,
// which changes no sum: the running sum is never -0.0f.) A window with no
// value above -inf keeps flat index 0 of the whole padded plane, never of
// the band. Input beyond the ceil-mode crop, and input that a stride larger
// than the window leaves uncovered, get 0. The TPU kernel's 0/1
// selection-matrix matmuls (a Mosaic workaround) and its VMEM feasibility
// cap have no counterpart. Index math is 32-bit inside a block; a block's
// first plane is found with 64-bit math once.
//
// (Earlier versions, measured in PERF.md: one pass recomputing every
// covering window's argmax per input element, 31x its bound on pool1; then
// an argmax pass into an int32 scratch and a gather pass, 4.6x for the
// three pools; this design 1.9x.)
//
// The kernel allocates nothing and launches on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch. poseidon_pool_bwd_attrs reports its registers, shared memory,
// spills and resident blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "vec.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;  // loads in flight a thread while staging
constexpr int kMaxSmem = 227 * 1024;
// A MAX argmax code is (slot << 16) | element: the element is below 2^16
// (a block's shared memory holds at most 58,112 words) and the slot below
// 2^15, so a code is never negative
constexpr int kElemBits = 16;
constexpr int kMaxSlots = 1 << 15;
static_assert(kMaxSmem / 4 <= (1 << kElemBits), "element code overflows");

__device__ __forceinline__ float load_as_f32(const float* p) { return *p; }

__device__ __forceinline__ float load_as_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }

__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}

struct Geometry {
  int h, w;      // input plane
  int oh, ow;    // output plane
  int kh, kw;    // window
  int sh, sw;    // stride
  int ph, pw;    // padding before (top, left)
  int pwidth;    // width of the padded, cropped plane: (ow-1)*sw + kw
};

// first window along one axis that covers padded coordinate p
__host__ __device__ __forceinline__ int cover_lo(int p, int kernel,
                                                 int stride) {
  const int first = p - kernel + 1;
  return first <= 0 ? 0 : (first + stride - 1) / stride;
}

// last window along one axis that covers padded coordinate p
__host__ __device__ __forceinline__ int cover_hi(int p, int stride,
                                                 int n_out) {
  return imin(p / stride, n_out - 1);
}

// Band j of band_rows dx rows: rows [r0, r1), the window rows that cover
// them [oy0, oy0 + nwy), and the x rows those windows read [xr0, xr0 + nxr)
// (ops/pool.py:pool_band computes the same to plan the shared memory).
struct Band {
  int r0, r1, oy0, nwy, xr0, nxr;
};

__host__ __device__ inline Band band_of(const Geometry& g, int band_rows,
                                        int j) {
  Band b;
  b.r0 = j * band_rows;
  b.r1 = imin(g.h, b.r0 + band_rows);
  b.oy0 = cover_lo(b.r0 + g.ph, g.kh, g.sh);
  const int hi = cover_hi(b.r1 - 1 + g.ph, g.sh, g.oh);
  b.nwy = imax(0, hi - b.oy0 + 1);
  b.xr0 = 0;
  b.nxr = 0;
  if (b.nwy > 0) {
    b.xr0 = imax(0, b.oy0 * g.sh - g.ph);
    b.nxr = imax(0, imin(g.h, hi * g.sh - g.ph + g.kh) - b.xr0);
  }
  return b;
}

// Caffe's AVE divisor of output row/column o: the window clipped to
// [start, in + pad), start = o*stride - pad (may be negative).
__device__ __forceinline__ int ave_extent(int o, int stride, int pad,
                                          int kernel, int in) {
  const int start = o * stride - pad;
  const int end = imin(start + kernel, in + pad);
  return end - start;
}

// Walks a thread's elements of (planes, len) with a step of kThreads:
// (p, off) advance by increments, one division pair at the start.
struct Walk2 {
  int p, off, dp, doff, len;
  __device__ Walk2(int len_) : len(len_) {
    const int t = threadIdx.x;
    p = t / len;
    off = t - p * len;
    dp = kThreads / len;
    doff = kThreads - dp * len;
  }
  __device__ void next() {
    off += doff;
    p += dp;
    if (off >= len) {
      off -= len;
      ++p;
    }
  }
};

// The same over (planes, rows, cols), a step of kStride.
template <int kStride>
struct Walk3Of {
  int p, r, c, dp, dr, dc, rows, cols;
  __device__ Walk3Of(int rows_, int cols_) : rows(rows_), cols(cols_) {
    const int plane = rows * cols;
    const int t = threadIdx.x;
    p = t / plane;
    int rem = t - p * plane;
    r = rem / cols;
    c = rem - r * cols;
    dp = kStride / plane;
    rem = kStride - dp * plane;
    dr = rem / cols;
    dc = rem - dr * cols;
  }
  __device__ void next() {
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
    if (r >= rows) {
      r -= rows;
      ++p;
    }
    p += dp;
  }
};
using Walk3 = Walk3Of<kThreads>;

// Copy len contiguous elements of each of np planes (plane stride gstride
// in src) into dst (plane stride sstride) as f32, kUnroll loads in flight.
template <typename T>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const T* __restrict__ src, int np,
                                      int len, int gstride, int sstride) {
  if (len <= 0) return;
  Walk2 it(len);
  while (it.p < np) {
    float v[kUnroll];
    int at[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      at[u] = -1;
      if (it.p < np) {
        v[u] = load_as_f32(src + it.p * gstride + it.off);
        at[u] = it.p * sstride + it.off;
      }
      it.next();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (at[u] >= 0) dst[at[u]] = v[u];
  }
}

// The most windows along one axis that cover one input row (column): a
// MAX element's slots on that axis, min(ceil(kernel / stride), n_out).
__host__ __device__ __forceinline__ int slots(int kernel, int stride,
                                              int n_out) {
  return imin((kernel + stride - 1) / stride, n_out);
}

// Shared memory of a block, in 4-byte words (ops/pool.py:pool_smem_bytes
// plans with the same). MAX: per plane x_rows * w of x, whose space then
// holds the band's dx (band_rows * w), and win_rows * ow of g and of the
// windows' argmax codes. AVE: per plane win_rows * ow of g / divisor, then
// the covering-window tables, 2 per band row and 2 per column.
inline long long smem_words(const Geometry& g, int is_max,
                                          int band_rows, int ppb, int xcap,
                                          int wcap) {
  if (is_max)
    return (long long)ppb * (imax(xcap, band_rows) * (long long)g.w +
                             2LL * wcap * g.ow);
  return (long long)ppb * wcap * g.ow + 2LL * band_rows + 2LL * g.w;
}

// Copy np planes of len f32 words from shared memory (plane stride len) to
// dst (plane stride gstride).
template <typename T>
__device__ __forceinline__ void unstage(T* __restrict__ dst,
                                        const float* __restrict__ src,
                                        int np, int len, int gstride) {
  if (len <= 0) return;
  for (Walk2 it(len); it.p < np; it.next())
    store_from_f32(dst + it.p * gstride + it.off, src[it.p * len + it.off]);
}

// K > 0: a K x K window at compile time (3, AlexNet's and most pools);
// 0: geo.kh x geo.kw at run time.
template <typename T, bool kMax, int K>
__global__ void __launch_bounds__(kThreads)
    pool_bwd_band_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         T* __restrict__ dx, long long planes, Geometry geo,
                         int band_rows, int n_bands, int ppb, int xcap,
                         int wcap) {
  extern __shared__ float smem[];
  const int kh = K > 0 ? K : geo.kh;
  const int kw = K > 0 ? K : geo.kw;
  const long long blk = blockIdx.x;
  const long long group = blk / n_bands;
  const Band b = band_of(geo, band_rows, (int)(blk - group * n_bands));
  const long long p0 = group * ppb;
  const int np = planes - p0 < ppb ? (int)(planes - p0) : ppb;
  const int hw = geo.h * geo.w;
  const int ohw = geo.oh * geo.ow;
  const int nrows = b.r1 - b.r0;
  const int bel = nrows * geo.w;       // a plane's dx elements in the band
  const int wlen = b.nwy * geo.ow;     // a plane's windows
  const int nwin = np * wlen;
  T* dxb = dx + p0 * hw + b.r0 * geo.w;

  if (kMax) {
    // x (then dx) | g | argmax codes; planes packed at this band's sizes
    float* sx = smem;
    float* sg = sx + ppb * imax(xcap, band_rows) * geo.w;
    int* sarg = reinterpret_cast<int*>(sg + ppb * wcap * geo.ow);
    const int xlen = b.nxr * geo.w;
    stage(sx, x + p0 * hw + b.xr0 * geo.w, np, xlen, hw, xlen);
    stage(sg, g + p0 * ohw + b.oy0 * geo.ow, np, wlen, ohw, wlen);
    __syncthreads();

    // Each window's first maximum once (strict >, row-major taps). Its
    // cotangent goes to that tap's element if the element is in this band
    // (else the neighbouring band, which stages the window too, sends it),
    // coded as (slot << kElemBits) | element: the slot ranks the window
    // among those covering the element, output row and column descending.
    // A window with nothing above -inf keeps flat index 0 of the padded
    // plane, which only window (0, 0) covers, as its tap (0, 0).
    const int sx_slots = slots(kw, geo.sw, geo.ow);
    if (b.nwy > 0) {
      int i = threadIdx.x;
      for (Walk3 it(b.nwy, geo.ow); it.p < np; it.next(), i += kThreads) {
        const int oy = b.oy0 + it.r;
        const int ox = it.c;
        const float* xp = sx + it.p * xlen;
        const int y0 = oy * geo.sh - geo.ph;  // input row of tap a = 0
        const int x0 = ox * geo.sw - geo.pw;
        float mx = -INFINITY;
        int ba = -1, bb = -1;
#pragma unroll
        for (int a = 0; a < kh; ++a) {
          const int y = y0 + a;
          if (y < 0 || y >= geo.h) continue;
          const float* row = xp + (y - b.xr0) * geo.w;
#pragma unroll
          for (int c = 0; c < kw; ++c) {
            const int xx = x0 + c;
            if (xx < 0 || xx >= geo.w) continue;
            const float v = row[xx];
            if (v > mx) {
              mx = v;
              ba = a;
              bb = c;
            }
          }
        }
        if (ba < 0 && oy == 0 && ox == 0 && geo.ph == 0 && geo.pw == 0)
          ba = bb = 0;
        int code = -1;
        const int row = y0 + ba - b.r0;
        if (ba >= 0 && row >= 0 && row < nrows)
          code = (imin(ba / geo.sh, geo.oh - 1 - oy) * sx_slots +
                  imin(bb / geo.sw, geo.ow - 1 - ox)) << kElemBits |
                 (it.p * bel + row * geo.w + x0 + bb);
        sarg[i] = code;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < np * bel; i += kThreads) sx[i] = 0.0f;
    __syncthreads();
    // One pass a slot, ascending: in a pass each element takes at most one
    // window, so the adds need no atomics and run in the plain version's
    // order from 0.0f.
    const int n_slots = slots(kh, geo.sh, geo.oh) * sx_slots;
    for (int slot = 0; slot < n_slots; ++slot) {
      for (int i = threadIdx.x; i < nwin; i += kThreads) {
        const int code = sarg[i];
        if (code >= 0 && (code >> kElemBits) == slot) {
          const int e = code & ((1 << kElemBits) - 1);
          sx[e] = __fadd_rn(sx[e], sg[i]);
        }
      }
      __syncthreads();
    }
    unstage(dxb, sx, np, bel, hw);
    return;
  }

  // AVE: each window's g / divisor once, then each dx element gathers its
  // covering windows with the output row and column descending
  float* sg = smem;
  int* srow = reinterpret_cast<int*>(sg + ppb * wcap * geo.ow);
  int* scol = srow + 2 * band_rows;
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    const int py = b.r0 + r + geo.ph;
    srow[2 * r] = cover_lo(py, kh, geo.sh) - b.oy0;
    srow[2 * r + 1] = cover_hi(py, geo.sh, geo.oh) - b.oy0;
  }
  for (int c = threadIdx.x; c < geo.w; c += kThreads) {
    const int px = c + geo.pw;
    scol[2 * c] = cover_lo(px, kw, geo.sw);
    scol[2 * c + 1] = cover_hi(px, geo.sw, geo.ow);
  }
  stage(sg, g + p0 * ohw + b.oy0 * geo.ow, np, wlen, ohw, wlen);
  __syncthreads();
  if (b.nwy > 0) {
    int i = threadIdx.x;
    for (Walk3 it(b.nwy, geo.ow); it.p < np; it.next(), i += kThreads) {
      const float denom = __fmul_rn(
          (float)ave_extent(b.oy0 + it.r, geo.sh, geo.ph, kh, geo.h),
          (float)ave_extent(it.c, geo.sw, geo.pw, kw, geo.w));
      sg[i] = __fdiv_rn(sg[i], denom);
    }
  }
  __syncthreads();
  if (nrows <= 0) return;
  for (Walk3 it(nrows, geo.w); it.p < np; it.next()) {
    const float* gv = sg + it.p * wlen;
    const int ylo = srow[2 * it.r], yhi = srow[2 * it.r + 1];
    const int xlo = scol[2 * it.c], xhi = scol[2 * it.c + 1];
    float acc = 0.0f;
    for (int wy = yhi; wy >= ylo; --wy)
      for (int ox = xhi; ox >= xlo; --ox)
        acc = __fadd_rn(acc, gv[wy * geo.ow + ox]);
    store_from_f32(dxb + it.p * hw + it.r * geo.w + it.c, acc);
  }
}

// Dynamic shared memory above the 48 KB every launch may take must be opted
// in to; launches within it skip the host call.
template <typename F>
cudaError_t allow_smem(F kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

struct Launch {
  int n_bands, bytes;
  long long blocks;
};

// The launch of the wrapper's band plan; xcap and wcap are the most x rows
// and window rows any band stages (ops/pool.py:pool_band_plan, checked
// there over every band). Refuses a plan whose shared memory passes
// kMaxSmem and a MAX window of more than kMaxSlots slots.
int plan_launch(const Geometry& g, int is_max, long long planes,
                int band_rows, int ppb, int xcap, int wcap, Launch& l) {
  if (band_rows < 1 || ppb < 1 || planes < 1 || xcap < 0 || wcap < 0)
    return 1;
  if (ppb > 1 && band_rows < g.h) return 1;  // several planes: whole ones
  if (is_max && slots(g.kh, g.sh, g.oh) * slots(g.kw, g.sw, g.ow) > kMaxSlots)
    return 1;
  l.n_bands = (g.h + band_rows - 1) / band_rows;
  const long long words = smem_words(g, is_max, band_rows, ppb, xcap, wcap);
  if (4 * words > kMaxSmem) return 1;
  l.bytes = (int)(4 * words);
  l.blocks = (planes + ppb - 1) / ppb * l.n_bands;
  if (l.blocks > 0x7fffffffLL) return 1;
  return 0;
}

template <typename T, bool kMax, int K>
int launch_t(const void* x, const void* g, void* dx, long long planes,
             const Geometry& geo, int band_rows, int ppb, int xcap, int wcap,
             cudaStream_t stream) {
  Launch l;
  if (plan_launch(geo, kMax, planes, band_rows, ppb, xcap, wcap, l))
    return (int)cudaErrorInvalidValue;
  auto kernel = pool_bwd_band_kernel<T, kMax, K>;
  const cudaError_t err = allow_smem(kernel, l.bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned int)l.blocks, kThreads, l.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      planes, geo, band_rows, l.n_bands, ppb, xcap, wcap);
  return (int)cudaGetLastError();
}

template <typename T, bool kMax, int K>
int attrs_t(const Geometry& geo, int band_rows, int ppb, int xcap, int wcap,
            int* out) {
  Launch l;
  if (plan_launch(geo, kMax, ppb, band_rows, ppb, xcap, wcap, l))
    return (int)cudaErrorInvalidValue;
  auto kernel = pool_bwd_band_kernel<T, kMax, K>;
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err == cudaSuccess) err = allow_smem(kernel, l.bytes);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, l.bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = l.bytes;
  out[3] = (int)fa.localSizeBytes;
  out[4] = kThreads;
  out[5] = blocks;
  return 0;
}

bool geometry(int h, int w, int oh, int ow, int kh, int kw, int sh, int sw,
              int ph, int pw, Geometry& geo) {
  if (h < 1 || w < 1 || oh < 1 || ow < 1 || kh < 1 || kw < 1 || sh < 1 ||
      sw < 1 || ph < 0 || pw < 0)
    return false;
  geo = Geometry{h, w, oh, ow, kh, kw, sh, sw, ph, pw, (ow - 1) * sw + kw};
  const long long pheight = (long long)(oh - 1) * sh + kh;
  return (long long)h * w < (1LL << 31) &&
         pheight * geo.pwidth < (1LL << 31);
}

// launch (0) or report attributes (1) of the instantiation for dtype,
// is_max and the window
// The band plan the wrapper passes: band_rows dx rows a block of ppb
// planes, staging at most xcap x rows and wcap window rows a plane.
struct Plan {
  int band_rows, ppb, xcap, wcap;
};

template <typename T, bool kMax>
int dispatch_k(int what, const void* x, const void* g, void* dx,
               long long planes, const Geometry& geo, const Plan& p,
               cudaStream_t stream, int* out) {
  if (geo.kh == 3 && geo.kw == 3)
    return what ? attrs_t<T, kMax, 3>(geo, p.band_rows, p.ppb, p.xcap,
                                      p.wcap, out)
                : launch_t<T, kMax, 3>(x, g, dx, planes, geo, p.band_rows,
                                       p.ppb, p.xcap, p.wcap, stream);
  return what ? attrs_t<T, kMax, 0>(geo, p.band_rows, p.ppb, p.xcap, p.wcap,
                                    out)
              : launch_t<T, kMax, 0>(x, g, dx, planes, geo, p.band_rows,
                                     p.ppb, p.xcap, p.wcap, stream);
}

int dispatch(int what, int dtype, int is_max, const void* x, const void* g,
             void* dx, long long planes, const Geometry& geo, Plan p,
             cudaStream_t stream, int* out) {
  p.band_rows = imin(p.band_rows, geo.h);
  if (dtype == 0)
    return is_max ? dispatch_k<float, true>(what, x, g, dx, planes, geo, p,
                                            stream, out)
                  : dispatch_k<float, false>(what, x, g, dx, planes, geo, p,
                                             stream, out);
  if (dtype == 1)
    return is_max ? dispatch_k<__nv_bfloat16, true>(what, x, g, dx, planes,
                                                    geo, p, stream, out)
                  : dispatch_k<__nv_bfloat16, false>(what, x, g, dx, planes,
                                                     geo, p, stream, out);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; is_max: 1 = MAX, 0 = AVE (x is then not
// read and may be null). x (planes, h, w), g (planes, oh, ow), dx (planes,
// h, w), all contiguous. band_rows, planes_per_block, x_rows and win_rows
// are the wrapper's band plan (ops/pool.py:pool_band_plan): a block takes
// band_rows dx rows of one plane, or whole planes (band_rows >= h) of
// planes_per_block consecutive planes, and stages at most x_rows x rows
// and win_rows window rows a plane. One plane, padded, must hold fewer
// than 2^31 elements. Returns a cudaError_t.
extern "C" int poseidon_pool_bwd(const void* x, const void* g, void* dx,
                                 int dtype, int is_max, long long planes,
                                 int h, int w, int oh, int ow, int kh, int kw,
                                 int sh, int sw, int ph, int pw,
                                 int band_rows, int planes_per_block,
                                 int x_rows, int win_rows, void* stream) {
  Geometry geo;
  if (!geometry(h, w, oh, ow, kh, kw, sh, sw, ph, pw, geo))
    return (int)cudaErrorInvalidValue;
  return dispatch(0, dtype, is_max, x, g, dx, planes, geo,
                  Plan{band_rows, planes_per_block, x_rows, win_rows},
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The instantiation for dtype, is_max and the window at a band plan:
// out[6] = registers a thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes a thread, threads a block, resident blocks per SM.
// Returns a cudaError_t.
extern "C" int poseidon_pool_bwd_attrs(int dtype, int is_max, int h, int w,
                                       int oh, int ow, int kh, int kw, int sh,
                                       int sw, int ph, int pw, int band_rows,
                                       int planes_per_block, int x_rows,
                                       int win_rows, int* out) {
  Geometry geo;
  if (!geometry(h, w, oh, ow, kh, kw, sh, sw, ph, pw, geo))
    return (int)cudaErrorInvalidValue;
  return dispatch(1, dtype, is_max, nullptr, nullptr, nullptr,
                  planes_per_block, geo,
                  Plan{band_rows, planes_per_block, x_rows, win_rows},
                  nullptr, out);
}

// ---------------------------------------------------------------------------
// The channels-last (NHWC) backward: the same gradient where the JAX package
// runs _pool_bwd_kernel on an NHWC graph (ops/nn.py:_pool_bwd transposes the
// padded plane and the cotangent to NCHW around its NCHW-only kernel and
// the result back). This kernel computes it straight on channels-last
// tensors, C the fast axis, so no transpose is needed.
//
// Bound: memory, the same bytes as the NCHW kernel (0.3555 ms for AlexNet's
// three pools at batch 256 in f32, 0.1778 in bf16). What held the kernel's
// earlier designs far above it was the latency of small loads: a thread
// moved one 2- or 4-byte channel a load.
//
// Design: one launch, no global scratch, 16-byte channel vectors. A block
// of 256 threads owns a band of dx rows of one image times a group of
// channels; a thread moves V channels as one access (V = 16 bytes /
// element size where C and the pointers allow, else 8, 4 or 2 bytes). The
// wrapper (ops/pool.py:pool_nhwc_plan) picks V, the group (about 64 bytes
// of a pixel: 16 channels in f32, 32 in bf16, so a band can be tall) and
// the band's rows within a shared-memory budget, and passes the most x
// rows and window rows a band stages; the C entry checks every band
// against them and the total against 227 KB. For its band the block
//   1. copies the x rows its covering windows read (MAX only) and the g
//      rows of those windows into shared memory with cp.async, V channels
//      a copy, coalesced along C;
//   2. MAX: takes each window's first maximum once from shared memory and
//      writes the tap it is at (a 16-bit code a channel) beside the
//      window's g;
//   3. each dx element gathers its covering windows from shared memory in
//      K6's slot order (output row and column descending), adding a
//      window's g where its code is this element's tap (MAX), or g over
//      Caffe's divisor (AVE), from 0.0f in f32, and writes its V channels
//      once. At most ceil(K/S) x ceil(K/S) windows cover an element; for a
//      3 x 3, stride 2 window (compiled in at full width) their loads are
//      issued together before the adds.
// Windows on a band boundary are computed by both neighbouring blocks,
// identically, as in the NCHW kernel, so x and g come from device memory
// about once (a band's halo rows mostly from L2) and dx is written once.
// A gather in slot order adds what K6's slot passes add, in the same
// order, without an f32 tile of dx in shared memory, its zeroing and a
// barrier a slot; the codes take 2 bytes a channel.
//
// The rules are the NCHW kernel's: first maximum by strict `>` over
// row-major taps, pad and NaN never winning, a window with no value above
// -inf keeping flat index 0 of the padded plane (only window (0, 0) covers
// it, at its tap (0, 0)); every dx element summed from 0.0f with rounded
// adds in the plain version's order; AVE's divisor the product of the two
// axis extents rounded once, the division IEEE (taken at each gather of a
// window: the same float every time). So it is bitwise equal to
// ops/pool.py:pool_bwd_plain on the same channels-last tensors.

namespace {
namespace nhwc {

constexpr int kThreadsNhwc = 256;
// the code of a window with nothing above -inf, bar window (0, 0): no tap
constexpr int kNone = 0xffff;
using Walk = Walk3Of<kThreadsNhwc>;

// A block's shared memory in bytes (ops/pool.py:pool_nhwc_smem_bytes plans
// with the same): a pixel's group is gvec vectors of vec elements, vb
// bytes each; MAX stages x_rows * w pixels of x, win_rows * ow of g and
// the windows' codes (2 bytes a channel), AVE the g rows alone.
inline long long smem_bytes(const Geometry& g, int is_max, int vec, int vb,
                            int gvec, int xcap, int wcap) {
  const long long gb = (long long)wcap * g.ow * gvec * vb;
  if (!is_max) return gb;
  return (long long)xcap * g.w * gvec * vb + gb +
         (long long)wcap * g.ow * gvec * vec * 2;
}

// rows x cols pixels of nv vectors from src (a pixel every `channels`
// elements) into dst (a pixel every gvec vectors), one cp.async a vector
template <typename T, int V>
__device__ __forceinline__ void stage_tile(unsigned char* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int rows, int cols, int nv,
                                           int gvec, int channels) {
  constexpr int VB = V * (int)sizeof(T);
  if (rows <= 0 || nv <= 0) return;
  for (Walk it(cols, nv); it.p < rows; it.next())
    vec::copy_async<VB>(dst + ((it.p * cols + it.r) * gvec + it.c) * VB,
                        src + (it.p * cols + it.r) * channels + it.c * V);
}

// Block b: channel group b % n_groups of band (b / n_groups) % n_bands of
// image b / (n_groups * n_bands). K, S > 0: the window and the stride at
// compile time (3 and 2, AlexNet's pools).
template <typename T, int V, bool kMax, int K, int S>
__global__ void __launch_bounds__(kThreadsNhwc)
    pool_nhwc_band_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          T* __restrict__ dx, Geometry geo, int channels,
                          int gvec, int n_groups, int band_rows, int n_bands,
                          int xcap, int wcap) {
  extern __shared__ __align__(16) unsigned char smem_nhwc[];
  constexpr int VB = V * (int)sizeof(T);
  constexpr int kWords = vec::words<VB>(), kCodeWords = vec::words<2 * V>();
  const int kh = K > 0 ? K : geo.kh, kw = K > 0 ? K : geo.kw;
  const int sh = S > 0 ? S : geo.sh, sw = S > 0 ? S : geo.sw;
  const int grp = (int)(blockIdx.x % n_groups);
  const unsigned rest = blockIdx.x / n_groups;
  const Band b = band_of(geo, band_rows, (int)(rest % n_bands));
  const long long img = rest / n_bands;
  const int c0 = grp * gvec * V;
  const int nv = imin(gvec, (channels - c0) / V);  // this group's vectors
  const long long in_img = (long long)geo.h * geo.w * channels;
  const T* xi = x + img * in_img + c0;
  const T* gi = g + img * (long long)geo.oh * geo.ow * channels + c0;
  T* dxi = dx + img * in_img + c0;
  const int gpitch = gvec * VB;  // bytes of a pixel's group
  // x (MAX) | g | codes (MAX)
  unsigned char* sx = smem_nhwc;
  unsigned char* sg = sx + (kMax ? xcap * geo.w * gpitch : 0);
  uint16_t* scode = reinterpret_cast<uint16_t*>(sg + wcap * geo.ow * gpitch);

  if (kMax)
    stage_tile<T, V>(sx, xi + b.xr0 * geo.w * channels, b.nxr, geo.w, nv,
                     gvec, channels);
  stage_tile<T, V>(sg, gi + b.oy0 * geo.ow * channels, b.nwy, geo.ow, nv,
                   gvec, channels);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  if (kMax) {
    // each window's first maximum once, V channels a thread: the tap a * kw
    // + c it is at, or kNone (0 for window (0, 0): flat index 0 of the
    // padded plane is its tap (0, 0))
    if (b.nwy > 0) {
      for (Walk it(geo.ow, nv); it.p < b.nwy; it.next()) {
        const int oy = b.oy0 + it.p, ox = it.r;
        const int y0 = oy * sh - geo.ph, x0 = ox * sw - geo.pw;
        float mx[V];
        int best[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          mx[j] = -INFINITY;
          best[j] = -1;
        }
#pragma unroll
        for (int a = 0; a < kh; ++a) {
          const int y = y0 + a;
          if (y < 0 || y >= geo.h) continue;
          const unsigned char* row =
              sx + ((y - b.xr0) * geo.w * gvec + it.c) * VB;
#pragma unroll
          for (int c = 0; c < kw; ++c) {
            const int xx = x0 + c;
            if (xx < 0 || xx >= geo.w) continue;
            float v[V];
            vec::load<T, V>(reinterpret_cast<const T*>(row + xx * gpitch), v);
#pragma unroll
            for (int j = 0; j < V; ++j) {
              if (v[j] > mx[j]) {
                mx[j] = v[j];
                best[j] = a * kw + c;
              }
            }
          }
        }
        const int none = (oy == 0 && ox == 0) ? 0 : kNone;
#pragma unroll
        for (int j = 0; j < V; ++j) best[j] = best[j] >= 0 ? best[j] : none;
        vec::store_u16<V>(scode + ((it.p * geo.ow + ox) * gvec + it.c) * V,
                          best);
      }
    }
    __syncthreads();
  }

  // each dx element gathers its covering windows, output row and column
  // descending (K6's slots in ascending order)
  const int nrows = b.r1 - b.r0;
  for (Walk it(geo.w, nv); it.p < nrows; it.next()) {
    const int y = b.r0 + it.p, xx = it.r;
    const int py = y + geo.ph, px = xx + geo.pw;
    const int ylo = cover_lo(py, kh, sh), yhi = cover_hi(py, sh, geo.oh);
    const int xlo = cover_lo(px, kw, sw), xhi = cover_hi(px, sw, geo.ow);
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.0f;
    // window (oy, ox)'s g and codes as raw words (unpacked at their add,
    // so the windows in flight hold few registers)
    auto fetch = [&](int oy, int ox, unsigned (&gw)[kWords],
                     unsigned (&cw)[kCodeWords]) {
      const int wi = ((oy - b.oy0) * geo.ow + ox) * gvec + it.c;
      vec::load_raw<T, V>(reinterpret_cast<const T*>(sg + wi * VB), gw);
      if (kMax) vec::load_raw<uint16_t, V>(scode + wi * V, cw);
    };
    auto add = [&](int oy, int ox, const unsigned (&gw)[kWords],
                   const unsigned (&cw)[kCodeWords]) {
      float gv[V];
      vec::unpack<T, V>(gw, gv);
      if (kMax) {
        int cd[V];
        vec::unpack_u16<V>(cw, cd);
        const int tap = (py - oy * sh) * kw + (px - ox * sw);
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (cd[j] == tap) acc[j] = __fadd_rn(acc[j], gv[j]);
      } else {
        const float d =
            __fmul_rn((float)ave_extent(oy, sh, geo.ph, kh, geo.h),
                      (float)ave_extent(ox, sw, geo.pw, kw, geo.w));
#pragma unroll
        for (int j = 0; j < V; ++j)
          acc[j] = __fadd_rn(acc[j], __fdiv_rn(gv[j], d));
      }
    };
    if (K > 0 && S > 0) {
      // at most ceil(K / S) covering windows an axis, known at compile
      // time: every load is issued before the first add
      constexpr int kMw = K > 0 && S > 0 ? (K + S - 1) / S : 1;
      unsigned gw[kMw][kMw][kWords], cw[kMw][kMw][kCodeWords];
#pragma unroll
      for (int u = 0; u < kMw; ++u)
#pragma unroll
        for (int v = 0; v < kMw; ++v)
          if (yhi - u >= ylo && xhi - v >= xlo)
            fetch(yhi - u, xhi - v, gw[u][v], cw[u][v]);
#pragma unroll
      for (int u = 0; u < kMw; ++u)
#pragma unroll
        for (int v = 0; v < kMw; ++v)
          if (yhi - u >= ylo && xhi - v >= xlo)
            add(yhi - u, xhi - v, gw[u][v], cw[u][v]);
    } else {
      for (int oy = yhi; oy >= ylo; --oy) {
        for (int ox = xhi; ox >= xlo; --ox) {
          unsigned gw[kWords], cw[kCodeWords];
          fetch(oy, ox, gw, cw);
          add(oy, ox, gw, cw);
        }
      }
    }
    vec::store<T, V>(dxi + (y * geo.w + xx) * channels + it.c * V, acc);
  }
}

// The wrapper's plan: vec elements a vector, gvec vectors a block's group,
// band_rows dx rows a band, at most xcap x rows and wcap window rows a band
struct Plan {
  int vec, gvec, band_rows, xcap, wcap;
};

struct Launch {
  int n_groups, n_bands, bytes;
  long long blocks;
};

// Refuses a plan whose vector does not divide C or passes 16 bytes, a band
// that stages more rows than the plan's x_rows and win_rows, shared memory
// past 227 KB, or a grid past 2^31 - 1 blocks.
int plan_launch(const Geometry& g, int is_max, int elem_bytes,
                long long batch, int channels, const Plan& p, Launch& l) {
  if (p.vec < 1 || channels % p.vec != 0 || p.vec * elem_bytes > 16 ||
      (p.vec & (p.vec - 1)) != 0 || p.gvec < 1 || p.band_rows < 1 ||
      p.xcap < 0 || p.wcap < 0 || batch < 1)
    return 1;
  const int rows = imin(p.band_rows, g.h);
  l.n_bands = (g.h + rows - 1) / rows;
  for (int j = 0; j < l.n_bands; ++j) {
    const Band b = band_of(g, rows, j);
    if (b.nwy > p.wcap || (is_max && b.nxr > p.xcap)) return 1;
  }
  l.n_groups = (channels / p.vec + p.gvec - 1) / p.gvec;
  const long long bytes = smem_bytes(g, is_max, p.vec, p.vec * elem_bytes,
                                     p.gvec, p.xcap, p.wcap);
  if (bytes > kMaxSmem) return 1;
  l.bytes = (int)bytes;
  l.blocks = batch * l.n_groups * l.n_bands;
  if (l.blocks > 0x7fffffffLL) return 1;
  return 0;
}

struct Args {
  const void* x;
  const void* g;
  void* dx;
  long long batch;
  int channels;
  Geometry geo;
  Plan plan;
};

// launch (out == nullptr) or report the attributes of one instantiation
template <typename T, int V, bool kMax, int K, int S>
int run_t(const Args& a, cudaStream_t stream, int* out) {
  Launch l;
  if (plan_launch(a.geo, kMax, (int)sizeof(T), a.batch, a.channels, a.plan,
                  l))
    return (int)cudaErrorInvalidValue;
  auto kernel = pool_nhwc_band_kernel<T, V, kMax, K, S>;
  cudaError_t err = allow_smem(kernel, l.bytes);
  if (err != cudaSuccess) return (int)err;
  if (out) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kThreadsNhwc, l.bytes);
    if (err != cudaSuccess) return (int)err;
    out[0] = fa.numRegs;
    out[1] = (int)fa.sharedSizeBytes;
    out[2] = l.bytes;
    out[3] = (int)fa.localSizeBytes;
    out[4] = kThreadsNhwc;
    out[5] = blocks;
    return 0;
  }
  kernel<<<(unsigned int)l.blocks, kThreadsNhwc, l.bytes, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.g),
      static_cast<T*>(a.dx), a.geo, a.channels, a.plan.gvec, l.n_groups,
      imin(a.plan.band_rows, a.geo.h), l.n_bands, a.plan.xcap, a.plan.wcap);
  return (int)cudaGetLastError();
}

// a 3 x 3, stride 2 window compiled in at the full 16-byte width
template <typename T, int V, bool kMax>
int run_w(const Args& a, cudaStream_t stream, int* out) {
  const Geometry& g = a.geo;
  if constexpr (V * sizeof(T) == 16) {
    if (g.kh == 3 && g.kw == 3 && g.sh == 2 && g.sw == 2)
      return run_t<T, V, kMax, 3, 2>(a, stream, out);
  }
  return run_t<T, V, kMax, 0, 0>(a, stream, out);
}

template <typename T, bool kMax>
int run_v(const Args& a, cudaStream_t stream, int* out) {
  switch (a.plan.vec) {
    case 1:
      return run_w<T, 1, kMax>(a, stream, out);
    case 2:
      return run_w<T, 2, kMax>(a, stream, out);
    case 4:
      return run_w<T, 4, kMax>(a, stream, out);
    default:
      if constexpr (sizeof(T) == 2) return run_w<T, 8, kMax>(a, stream, out);
      return (int)cudaErrorInvalidValue;
  }
}

int dispatch(int dtype, int is_max, const Args& a, cudaStream_t stream,
             int* out) {
  if (dtype == 0)
    return is_max ? run_v<float, true>(a, stream, out)
                  : run_v<float, false>(a, stream, out);
  if (dtype == 1)
    return is_max ? run_v<__nv_bfloat16, true>(a, stream, out)
                  : run_v<__nv_bfloat16, false>(a, stream, out);
  return (int)cudaErrorInvalidValue;
}

// the geometry of an NHWC call: the NCHW kernel's rules, at most 65534 taps
// a window (a 16-bit code, 0xffff for none), an image of x or g under 2^31
// elements
bool geometry_nhwc(int channels, int h, int w, int oh, int ow, int kh, int kw,
                   int sh, int sw, int ph, int pw, Geometry& geo) {
  if (channels < 1 || (long long)kh * kw > 65534 ||
      !geometry(h, w, oh, ow, kh, kw, sh, sw, ph, pw, geo))
    return false;
  return (long long)h * w * channels < (1LL << 31) &&
         (long long)oh * ow * channels < (1LL << 31);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace nhwc
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; is_max: 1 = MAX, 0 = AVE (x is then not
// read and may be null). x (batch, h, w, C), g (batch, oh, ow, C), dx
// (batch, h, w, C), all contiguous (NHWC tensors). vec, group_vecs,
// band_rows, x_rows and win_rows are the wrapper's plan
// (ops/pool.py:pool_nhwc_plan): vec channels a vector (a power of two
// within 16 bytes that divides C, every pointer read or written aligned to
// it), group_vecs vectors a block's channel group, band_rows dx rows a
// block, at most x_rows x rows and win_rows window rows a band. A window
// takes at most 65534 taps; an image of x or g holds fewer than 2^31
// elements. Returns a cudaError_t.
extern "C" int poseidon_pool_nhwc_bwd(const void* x, const void* g, void* dx,
                                      int dtype, int is_max, long long batch,
                                      int channels, int h, int w, int oh,
                                      int ow, int kh, int kw, int sh, int sw,
                                      int ph, int pw, int vec, int group_vecs,
                                      int band_rows, int x_rows,
                                      int win_rows, void* stream) {
  Geometry geo;
  if (!nhwc::geometry_nhwc(channels, h, w, oh, ow, kh, kw, sh, sw, ph, pw,
                           geo))
    return (int)cudaErrorInvalidValue;
  const int bytes = vec * (dtype == 0 ? 4 : 2);
  if (vec < 1 || !nhwc::aligned(g, bytes) || !nhwc::aligned(dx, bytes) ||
      (is_max && !nhwc::aligned(x, bytes)))
    return (int)cudaErrorInvalidValue;
  const nhwc::Plan plan{vec, group_vecs, band_rows, x_rows, win_rows};
  return nhwc::dispatch(dtype, is_max,
                        nhwc::Args{x, g, dx, batch, channels, geo, plan},
                        static_cast<cudaStream_t>(stream), nullptr);
}

// The instantiation for dtype, is_max, the window and vec at a plan:
// out[6] = registers a thread, static shared bytes, dynamic shared bytes,
// local (spill) bytes a thread, threads a block, resident blocks per SM.
// Returns a cudaError_t.
extern "C" int poseidon_pool_nhwc_bwd_attrs(int dtype, int is_max,
                                            int channels, int h, int w,
                                            int oh, int ow, int kh, int kw,
                                            int sh, int sw, int ph, int pw,
                                            int vec, int group_vecs,
                                            int band_rows, int x_rows,
                                            int win_rows, int* out) {
  Geometry geo;
  if (!nhwc::geometry_nhwc(channels, h, w, oh, ow, kh, kw, sh, sw, ph, pw,
                           geo))
    return (int)cudaErrorInvalidValue;
  const nhwc::Plan plan{vec, group_vecs, band_rows, x_rows, win_rows};
  return nhwc::dispatch(dtype, is_max,
                        nhwc::Args{nullptr, nullptr, nullptr, 1, channels,
                                   geo, plan},
                        nullptr, out);
}
