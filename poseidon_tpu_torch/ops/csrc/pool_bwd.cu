// Pooling backward (MAX and AVE) for Hopper (sm_90a), NCHW.
//
// Replaces poseidon_tpu/ops/pallas_kernels.py:_pool_bwd_kernel (the Pallas
// TPU kernel reached through pool_bwd_plane, routed by ops/nn.py:_pool_bwd):
// the gradient of Caffe pooling on the padded input, cropped to exactly the
// extent the output grid consumes, with the padding cropped off again.
//
//   MAX: each window's cotangent goes to the FIRST maximum of the window
//        (Caffe's strict `>` update over row-major taps), recomputed from x;
//        pad positions count as -inf. A window with no value above -inf
//        keeps the initial argmax, flat padded index 0 (the rule of the
//        plain taps version, ops/nn.py:_pool_max_args).
//   AVE: each window's cotangent divided by Caffe's divisor (the window
//        clipped to the padded extent) goes to every position it covers.
//
// Bound: memory. The arithmetic is a few compares per tap against reading
// x and g once and writing dx once: at AlexNet's batch 256 in f32, pool1
// moves 666.4 MB (0.199 ms at 3.35 TB/s), pool2 426.5 MB (0.127 ms), pool5
// 98.0 MB (0.029 ms).
//
// Design: two passes, each one thread per element, no atomics, so the
// result is deterministic.
//   1. (MAX only) one thread per OUTPUT window finds the window's argmax
//      once (k*k loads of x) and writes it, as a flat index into the
//      padded plane, to an int32 scratch the wrapper allocates.
//   2. one thread per INPUT element gathers over the output windows that
//      cover it (at most ceil(k/s)^2): for MAX it adds a window's
//      cotangent where the stored argmax is this element, for AVE it adds
//      every covering window's cotangent over its divisor.
// Contributions are summed in the plain version's order: taps (dh, dw)
// row-major, i.e. covering windows with the output row and column
// descending, with explicitly rounded adds and an IEEE division for AVE.
// Index math is 32-bit inside a plane, and the one division that finds a
// thread's plane is 32-bit too while the tensor holds fewer than 2^32
// elements; the covering-window ranges come from two divisions per axis.
// Padding and the ceil-mode crop fold into the index arithmetic. The TPU
// kernel's 0/1 selection-matrix matmuls (a Mosaic workaround) and its VMEM
// feasibility cap have no counterpart: any window works.
//
// (A first version, one pass with every covering window's argmax
// recomputed per input element and 64-bit index math throughout, measured
// 31x its bound on pool1; PERF.md keeps both times.)
//
// The kernels allocate nothing and launch on the caller's stream; the C
// entry returns cudaGetLastError() so the wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

struct Geometry {
  int h, w;      // input plane
  int oh, ow;    // output plane
  int kh, kw;    // window
  int sh, sw;    // stride
  int ph, pw;    // padding before (top, left)
  int pwidth;    // width of the padded, cropped plane: (ow-1)*sw + kw
};

// Caffe's AVE divisor of output row/column o: the window clipped to
// [start, in + pad), start = o*stride - pad (may be negative).
__device__ __forceinline__ int ave_extent(int o, int stride, int pad,
                                          int kernel, int in) {
  const int start = o * stride - pad;
  const int end = min(start + kernel, in + pad);
  return end - start;
}

// I: the element index type, uint32_t when the whole tensor has fewer than
// 2^32 elements (a 32-bit division per thread), else int64_t
template <typename T, typename I>
__global__ void pool_argmax_kernel(const T* __restrict__ x,
                                   int* __restrict__ arg, I total,
                                   Geometry geo) {
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const I owin = (I)(geo.oh * geo.ow);
  const I plane = idx / owin;
  const int r = (int)(idx - plane * owin);
  const int oy = r / geo.ow;
  const int ox = r - oy * geo.ow;
  const T* xp = x + (int64_t)plane * geo.h * geo.w;
  // first-max-wins argmax over row-major taps; pad taps are -inf and never
  // win, and a window with nothing above -inf keeps flat index 0
  float mx = -INFINITY;
  int best = 0;
  for (int a = 0; a < geo.kh; ++a) {
    const int wy = oy * geo.sh + a;        // padded row
    const int y = wy - geo.ph;             // input row
    if (y < 0 || y >= geo.h) continue;
    for (int b = 0; b < geo.kw; ++b) {
      const int wx = ox * geo.sw + b;
      const int xx = wx - geo.pw;
      if (xx < 0 || xx >= geo.w) continue;
      const float v = load_as_f32(xp, y * geo.w + xx);
      if (v > mx) {
        mx = v;
        best = wy * geo.pwidth + wx;
      }
    }
  }
  arg[idx] = best;
}

// covering windows of padded coordinate p along one axis: o in [lo, hi]
__device__ __forceinline__ void covering(int p, int kernel, int stride,
                                         int n_out, int& lo, int& hi) {
  hi = min(p / stride, n_out - 1);
  const int first = p - kernel + 1;
  lo = first <= 0 ? 0 : (first + stride - 1) / stride;
}

template <typename T, typename I, bool kMax>
__global__ void pool_gather_kernel(const int* __restrict__ arg,
                                   const T* __restrict__ g,
                                   T* __restrict__ dx, I total,
                                   Geometry geo) {
  const I idx = (I)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const I hw = (I)(geo.h * geo.w);
  const I plane = idx / hw;
  const int r = (int)(idx - plane * hw);
  const int ih = r / geo.w;
  const int iw = r - ih * geo.w;
  const int64_t obase = (int64_t)plane * geo.oh * geo.ow;
  const T* gp = g + obase;
  // this element on the padded plane
  const int py = ih + geo.ph;
  const int px = iw + geo.pw;
  const int my_flat = py * geo.pwidth + px;
  int oy_lo, oy_hi, ox_lo, ox_hi;
  covering(py, geo.kh, geo.sh, geo.oh, oy_lo, oy_hi);
  covering(px, geo.kw, geo.sw, geo.ow, ox_lo, ox_hi);

  float acc = 0.0f;
  // descending window index = ascending tap (dh, dw): the plain order
  for (int oy = oy_hi; oy >= oy_lo; --oy) {
    for (int ox = ox_hi; ox >= ox_lo; --ox) {
      const int o = oy * geo.ow + ox;
      const float gv = load_as_f32(gp, o);
      float contrib;
      if (kMax) {
        contrib = (arg[obase + o] == my_flat) ? gv : 0.0f;
      } else {
        const float denom = __fmul_rn(
            (float)ave_extent(oy, geo.sh, geo.ph, geo.kh, geo.h),
            (float)ave_extent(ox, geo.sw, geo.pw, geo.kw, geo.w));
        contrib = __fdiv_rn(gv, denom);
      }
      acc = __fadd_rn(acc, contrib);
    }
  }
  store_from_f32(dx, idx, acc);
}

template <typename T, typename I>
int launch_indexed(const void* x, const void* g, void* dx, int* arg,
                   int64_t planes, const Geometry& geo, int is_max,
                   cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = planes * (int64_t)geo.h * geo.w;
  const int64_t blocks = (total + threads - 1) / threads;
  if (is_max) {
    const int64_t windows = planes * (int64_t)geo.oh * geo.ow;
    pool_argmax_kernel<T, I>
        <<<(unsigned int)((windows + threads - 1) / threads), threads, 0,
           stream>>>(static_cast<const T*>(x), arg, (I)windows, geo);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    pool_gather_kernel<T, I, true><<<(unsigned int)blocks, threads, 0,
                                     stream>>>(
        arg, static_cast<const T*>(g), static_cast<T*>(dx), (I)total, geo);
  } else {
    pool_gather_kernel<T, I, false><<<(unsigned int)blocks, threads, 0,
                                      stream>>>(
        nullptr, static_cast<const T*>(g), static_cast<T*>(dx), (I)total,
        geo);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int* arg, int64_t planes,
           const Geometry& geo, int is_max, cudaStream_t stream) {
  // + one block of headroom so idx never wraps in the 32-bit variant
  if (planes * (int64_t)geo.h * geo.w + 256 < ((int64_t)1 << 32))
    return launch_indexed<T, uint32_t>(x, g, dx, arg, planes, geo, is_max,
                                       stream);
  return launch_indexed<T, int64_t>(x, g, dx, arg, planes, geo, is_max,
                                    stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; is_max: 1 = MAX, 0 = AVE (x and arg
// are then not read and may be null). x (planes, h, w), g and arg (planes,
// oh, ow), dx (planes, h, w), all contiguous; arg is int32 scratch the
// wrapper allocates. One plane must hold fewer than 2^31 elements.
// Returns a cudaError_t.
extern "C" int poseidon_pool_bwd(const void* x, const void* g, void* dx,
                                 void* arg, int dtype, int is_max,
                                 long long planes, int h, int w, int oh,
                                 int ow, int kh, int kw, int sh, int sw,
                                 int ph, int pw, void* stream) {
  if (kh < 1 || kw < 1 || sh < 1 || sw < 1 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  Geometry geo{h, w, oh, ow, kh, kw, sh, sw, ph, pw, (ow - 1) * sw + kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* scratch = static_cast<int*>(arg);
  if (dtype == 0)
    return launch<float>(x, g, dx, scratch, planes, geo, is_max, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g, dx, scratch, planes, geo, is_max, st);
  return (int)cudaErrorInvalidValue;
}
