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
__device__ __forceinline__ int cover_lo(int p, int kernel, int stride) {
  const int first = p - kernel + 1;
  return first <= 0 ? 0 : (first + stride - 1) / stride;
}

// last window along one axis that covers padded coordinate p
__device__ __forceinline__ int cover_hi(int p, int stride, int n_out) {
  return imin(p / stride, n_out - 1);
}

// Band j of band_rows dx rows: rows [r0, r1), the window rows that cover
// them [oy0, oy0 + nwy), and the x rows those windows read [xr0, xr0 + nxr)
// (ops/pool.py:pool_band computes the same to plan the shared memory).
struct Band {
  int r0, r1, oy0, nwy, xr0, nxr;
};

__device__ inline Band band_of(const Geometry& g, int band_rows,
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

// The same over (planes, rows, cols).
struct Walk3 {
  int p, r, c, dp, dr, dc, rows, cols;
  __device__ Walk3(int rows_, int cols_) : rows(rows_), cols(cols_) {
    const int plane = rows * cols;
    const int t = threadIdx.x;
    p = t / plane;
    int rem = t - p * plane;
    r = rem / cols;
    c = rem - r * cols;
    dp = kThreads / plane;
    rem = kThreads - dp * plane;
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
// Design: two passes, every access coalesced across C (a warp's lanes on
// consecutive channels of one pixel), no shared memory and no window
// taken twice. A thread owns one (window, channel) in the first pass and
// one (input element, channel) in the second; a block is 32 channels x 8
// columns of one row of one image, from its block and thread indices, so
// no thread divides to find its element, and AlexNet's 3 x 3, stride 2
// window is compiled in (the divisions by the stride become shifts, and
// the gather issues the loads of its at most 2 x 2 windows together
// before adding: the pass is held by memory latency otherwise).
//   1. MAX only: each window's first maximum, as the tap's index in the
//      window (a byte; 16 bits for windows of more than 254 taps), into a
//      scratch the wrapper allocates beside dx (one entry a cotangent
//      element: 1/4 of g's bytes in f32).
//   2. Each dx element gathers its covering windows, output row and column
//      descending, adding a window's cotangent when its argmax tap is this
//      element (MAX), or the cotangent over Caffe's divisor (AVE); dx is
//      written once.
// Bound: memory, the same bytes as the NCHW kernel (0.3555 ms for AlexNet's
// three pools at batch 256 in f32); the scratch adds a write and about
// two reads of a quarter of g's bytes.
//
// The rules are the NCHW kernel's: first maximum by strict `>` over
// row-major taps, pad and NaN never winning, a window with no value above
// -inf keeping flat index 0 of the padded plane (only window (0, 0) covers
// it, at its tap (0, 0)); every dx element summed from 0.0f with rounded
// adds in the plain version's order; AVE's divisor the product of the two
// axis extents rounded once, the division IEEE (taken at each gather of a
// window: the same float every time). So it is bitwise equal to
// ops/pool.py:pool_bwd_plain on the same channels-last tensors. A 3 x 3,
// stride 2 window is a template instantiation; others take their size at
// run time.

namespace {
namespace nhwc {

// A block is 32 channels (a warp's lanes) x kCols columns of one row of
// one image: no thread divides to find its element.
constexpr int kLanes = 32;
constexpr int kCols = 8;

struct Geometry {
  int h, w;    // input plane
  int oh, ow;  // output plane
  int kh, kw;  // window
  int sh, sw;  // stride
  int ph, pw;  // padding before (top, left)
};

// first window along one axis that covers padded coordinate p
__device__ __forceinline__ int cover_lo(int p, int kernel, int stride) {
  const int first = p - kernel + 1;
  return first <= 0 ? 0 : (first + stride - 1) / stride;
}

// last window along one axis that covers padded coordinate p
__device__ __forceinline__ int cover_hi(int p, int stride, int n_out) {
  return imin(p / stride, n_out - 1);
}

// Pass 1, MAX: block (b, row * col_blocks + cb, img) takes channels
// [32 b, 32 b + 32) of output columns [8 cb, 8 cb + 8) of output row `row`.
// Code: the first maximum's tap a * kw + b, or `none` where no value is
// above -inf (0 for window (0, 0): flat index 0 of the padded plane is its
// tap (0, 0)). K, S > 0: the window and the stride at compile time (3 and
// 2, AlexNet's pools), so the divisions by the stride are shifts.
template <typename T, int K, int S, typename C>
__global__ void __launch_bounds__(kLanes * kCols)
    pool_nhwc_argmax_kernel(const T* __restrict__ x, C* __restrict__ code,
                            Geometry geo, int channels, C none) {
  const int kh = K > 0 ? K : geo.kh, kw = K > 0 ? K : geo.kw;
  const int sh = S > 0 ? S : geo.sh, sw = S > 0 ? S : geo.sw;
  const int col_blocks = (geo.ow + kCols - 1) / kCols;
  const int oy = blockIdx.y / col_blocks;
  const int ox = (blockIdx.y - oy * col_blocks) * kCols + threadIdx.y;
  const int c = blockIdx.x * kLanes + threadIdx.x;
  if (c >= channels || ox >= geo.ow) return;
  const long long img = blockIdx.z;
  const T* xi = x + img * geo.h * geo.w * (long long)channels + c;
  const int y0 = oy * sh - geo.ph;
  const int x0 = ox * sw - geo.pw;
  float mx = -INFINITY;
  int best = -1;
#pragma unroll
  for (int a = 0; a < kh; ++a) {
    const int y = y0 + a;
    if (y < 0 || y >= geo.h) continue;
#pragma unroll
    for (int b = 0; b < kw; ++b) {
      const int xx = x0 + b;
      if (xx < 0 || xx >= geo.w) continue;
      const float v = load_as_f32(xi + (y * geo.w + xx) * channels);
      if (v > mx) {
        mx = v;
        best = a * kw + b;
      }
    }
  }
  if (best < 0) best = (oy == 0 && ox == 0) ? 0 : (int)none;
  code[img * geo.oh * geo.ow * (long long)channels +
       (oy * geo.ow + ox) * channels + c] = (C)best;
}

// Pass 2: block (b, y * col_blocks + cb, img) takes channels [32 b, ...)
// of input columns [8 cb, 8 cb + 8) of input row y; each element gathers
// its covering windows.
template <typename T, bool kMax, int K, int S, typename C>
__global__ void __launch_bounds__(kLanes * kCols)
    pool_nhwc_bwd_kernel(const T* __restrict__ g, const C* __restrict__ code,
                         T* __restrict__ dx, Geometry geo, int channels) {
  const int kh = K > 0 ? K : geo.kh, kw = K > 0 ? K : geo.kw;
  const int sh = S > 0 ? S : geo.sh, sw = S > 0 ? S : geo.sw;
  const int col_blocks = (geo.w + kCols - 1) / kCols;
  const int y = blockIdx.y / col_blocks;
  const int xx = (blockIdx.y - y * col_blocks) * kCols + threadIdx.y;
  const int c = blockIdx.x * kLanes + threadIdx.x;
  if (c >= channels || xx >= geo.w) return;
  const long long img = blockIdx.z;
  const long long goff = img * geo.oh * geo.ow * (long long)channels + c;
  const T* gi = g + goff;
  const C* ci = kMax ? code + goff : nullptr;
  const int py = y + geo.ph, px = xx + geo.pw;
  const int ylo = cover_lo(py, kh, sh), yhi = cover_hi(py, sh, geo.oh);
  const int xlo = cover_lo(px, kw, sw), xhi = cover_hi(px, sw, geo.ow);
  float acc = 0.0f;
  if (K > 0 && S > 0) {
    // at most ceil(K / S) covering windows an axis, known at compile time:
    // every load is issued before the first add, so a thread waits on
    // memory once, not once a window (the adds keep their order)
    constexpr int kMw = K > 0 && S > 0 ? (K + S - 1) / S : 1;
    float gv[kMw][kMw];
    bool take[kMw][kMw];
#pragma unroll
    for (int u = 0; u < kMw; ++u) {
#pragma unroll
      for (int v = 0; v < kMw; ++v) {
        const int oy = yhi - u, ox = xhi - v;
        take[u][v] = oy >= ylo && ox >= xlo;
        gv[u][v] = 0.0f;
        if (take[u][v]) {
          const int j = (oy * geo.ow + ox) * channels;
          gv[u][v] = load_as_f32(gi + j);
          if (kMax)
            take[u][v] = (int)ci[j] == (py - oy * sh) * kw + (px - ox * sw);
          else
            gv[u][v] = __fdiv_rn(gv[u][v], __fmul_rn(
                (float)ave_extent(oy, sh, geo.ph, kh, geo.h),
                (float)ave_extent(ox, sw, geo.pw, kw, geo.w)));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMw; ++u)
#pragma unroll
      for (int v = 0; v < kMw; ++v)
        if (take[u][v]) acc = __fadd_rn(acc, gv[u][v]);
    store_from_f32(dx + img * geo.h * geo.w * (long long)channels +
                       (y * geo.w + xx) * channels + c,
                   acc);
    return;
  }
  for (int oy = yhi; oy >= ylo; --oy) {
    const int a = py - oy * sh;
    float ey = 0.0f;
    if (!kMax) ey = (float)ave_extent(oy, sh, geo.ph, kh, geo.h);
    for (int ox = xhi; ox >= xlo; --ox) {
      const int j = (oy * geo.ow + ox) * channels;
      if (kMax) {
        if ((int)ci[j] == a * kw + (px - ox * sw))
          acc = __fadd_rn(acc, load_as_f32(gi + j));
      } else {
        const float denom = __fmul_rn(
            ey, (float)ave_extent(ox, sw, geo.pw, kw, geo.w));
        acc = __fadd_rn(acc, __fdiv_rn(load_as_f32(gi + j), denom));
      }
    }
  }
  store_from_f32(dx + img * geo.h * geo.w * (long long)channels +
                     (y * geo.w + xx) * channels + c,
                 acc);
}

template <typename T, bool kMax, int K, int S, typename C>
int launch_t(const void* x, const void* g, void* code, void* dx,
             long long batch, int channels, const Geometry& geo,
             cudaStream_t stream) {
  const dim3 block(kLanes, kCols);
  const unsigned int lanes = (channels + kLanes - 1) / kLanes;
  const long long out_rows = (long long)geo.oh * ((geo.ow + kCols - 1) / kCols);
  const long long in_rows = (long long)geo.h * ((geo.w + kCols - 1) / kCols);
  if (batch > 65535 || out_rows > 65535 || in_rows > 65535)
    return (int)cudaErrorInvalidValue;
  if (kMax) {
    pool_nhwc_argmax_kernel<T, K, S, C>
        <<<dim3(lanes, (unsigned int)out_rows, (unsigned int)batch), block,
           0, stream>>>(static_cast<const T*>(x), static_cast<C*>(code), geo,
                        channels, (C)(sizeof(C) == 1 ? 0xff : 0xffff));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pool_nhwc_bwd_kernel<T, kMax, K, S, C>
      <<<dim3(lanes, (unsigned int)in_rows, (unsigned int)batch), block, 0,
         stream>>>(static_cast<const T*>(g), static_cast<const C*>(code),
                   static_cast<T*>(dx), geo, channels);
  return (int)cudaGetLastError();
}

template <typename T, bool kMax>
int launch_k(const void* x, const void* g, void* code, void* dx,
             long long batch, int channels, const Geometry& geo,
             cudaStream_t stream) {
  if (geo.kh == 3 && geo.kw == 3 && geo.sh == 2 && geo.sw == 2)
    return launch_t<T, kMax, 3, 2, uint8_t>(x, g, code, dx, batch, channels,
                                            geo, stream);
  if (geo.kh * geo.kw <= 254)
    return launch_t<T, kMax, 0, 0, uint8_t>(x, g, code, dx, batch, channels,
                                            geo, stream);
  return launch_t<T, kMax, 0, 0, uint16_t>(x, g, code, dx, batch, channels,
                                           geo, stream);
}

}  // namespace nhwc
}  // namespace

// dtype: 0 = float32, 1 = bfloat16; is_max: 1 = MAX, 0 = AVE (x and code
// are then not read and may be null). x (batch, h, w, C), g (batch, oh, ow,
// C), dx (batch, h, w, C), all contiguous (NHWC tensors); code: MAX's
// scratch of batch * oh * ow * C entries of one byte (two where kh * kw >
// 254; at most 65534 taps). The batch, h * ceil(w / 8) and oh * ceil(ow /
// 8) are at most 65535, and one image must hold fewer than 2^31 elements of
// x and of g. Returns a cudaError_t.
extern "C" int poseidon_pool_nhwc_bwd(const void* x, const void* g,
                                      void* code, void* dx, int dtype,
                                      int is_max, long long batch,
                                      int channels, int h, int w, int oh,
                                      int ow, int kh, int kw, int sh, int sw,
                                      int ph, int pw, void* stream) {
  if (batch < 1 || channels < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 ||
      kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0 ||
      (long long)kh * kw > 65534)
    return (int)cudaErrorInvalidValue;
  if ((long long)h * w * channels >= (1LL << 31) ||
      (long long)oh * ow * channels >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const nhwc::Geometry geo{h, w, oh, ow, kh, kw, sh, sw, ph, pw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using namespace nhwc;
  if (dtype == 0) {
    auto f = is_max ? launch_k<float, true> : launch_k<float, false>;
    return f(x, g, code, dx, batch, channels, geo, st);
  }
  if (dtype == 1) {
    auto f = is_max ? launch_k<__nv_bfloat16, true>
                    : launch_k<__nv_bfloat16, false>;
    return f(x, g, code, dx, batch, channels, geo, st);
  }
  return (int)cudaErrorInvalidValue;
}
