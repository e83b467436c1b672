// A conv's epilogue: bias, then ReLU or Caffe's per-channel PReLU, and an
// optional second store at a channel offset of a wider buffer or an optional
// 2x2 stride-2 max pool, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package a conv's bias and
// activation are elementwise consumers that XLA fuses into the conv. The
// port runs each conv through cuDNN without bias; after it the bias add
// (a (1, C, 1, 1) broadcast over a channels-last tensor, which PyTorch
// runs in its non-vectorised elementwise kernel), the activation and, in a
// BODY_25 dense block, the concat were separate passes, each reading and
// writing the whole activation. This is one pass:
//   t   = T(y + T(bias))                          the bias add, rounded to T
//   out = isnan(t) ? t : max(t, 0)                ReLU, as F.relu
//   out = t > 0 ? t : T(T(slope) * t)             PReLU, as F.prelu
//   pooled = F.max_pool2d(out, 2, 2)              the pool, where asked
// in float32 arithmetic on T = bf16 or float32 values, the operations and
// roundings of those PyTorch expressions, so the result is theirs bit for
// bit. The pool takes PyTorch's rule: the window's elements in row-major
// order, each replacing the running max where it is larger or NaN (so the
// last NaN wins, and of 0 and -0 the first); an odd last row or column is
// dropped. Bias and slope are read as float32 parameters and rounded to T in
// registers, as `bias.to(T)` rounds them.
//
// What bounds it on the H100: bytes. It reads the conv output (NCHW stored
// channels-last, so NHWC in memory) once and writes it once, and once more
// where a dense block's buffer takes it (channels [offset, offset + C) of
// a channels-last buffer of `wide_c` channels); 2 operations an element
// against ~4 bytes. A thread owns 8 channels of one pixel (16-byte loads and
// stores in bf16, neighbouring threads on neighbouring addresses) and walks
// the pixels with a stride that is a multiple of the channel groups, so
// its channels, and their bias and slope in registers, stay the same; two
// pixels a step keep two loads in flight. The grid is what the SMs hold at
// once. Where C, the wide buffer's channels, the offset or a pointer does
// not allow 16-byte access, the same walk loads and stores element by
// element, the last group of a ragged C taking the channels it has.
//
// Pooled (a VGG block's last conv, whose full-size output only the pool
// read), a thread owns 8 channels of one pooled pixel: it loads the four
// groups of its 2x2 window, activates each value as above, reduces them and
// stores the pooled group alone, so the full-size activation is never
// written (read 4 units, write 1, against 1 and 1 unpooled). The walk
// steps over pooled pixels, its window's input pixel advanced by adding
// the step's rows and columns (no division in the loop).
//
// It allocates nothing and never synchronises: the wrapper's outputs make
// the call capturable in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;    // channels a thread owns at a pixel
constexpr int kUnroll = 2;   // pixels a step
constexpr int kMaxDevices = 64;

struct Bf16 {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float load(T v) { return __bfloat162float(v); }
  static __device__ __forceinline__ T round(float v) { return __float2bfloat16_rn(v); }
};

struct F32 {
  using T = float;
  static __device__ __forceinline__ float load(T v) { return v; }
  static __device__ __forceinline__ T round(float v) { return v; }
};

// 8 elements from or to `p`: 16-byte words (one in bf16, two in float32)
// where `kVec`, else element by element, the first `n` of them.
template <class E, bool kVec>
__device__ __forceinline__ void load8(const typename E::T* p, int n,
                                      typename E::T (&v)[kGroup]) {
  if (kVec) {
    constexpr int words = sizeof(v) / sizeof(uint4);
#pragma unroll
    for (int i = 0; i < words; ++i)
      reinterpret_cast<uint4*>(v)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < n) v[i] = p[i];
  }
}

template <class E, bool kVec>
__device__ __forceinline__ void store8(typename E::T* p, int n,
                                       const typename E::T (&v)[kGroup]) {
  if (kVec) {
    constexpr int words = sizeof(v) / sizeof(uint4);
#pragma unroll
    for (int i = 0; i < words; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(v)[i];
  } else {
#pragma unroll
    for (int i = 0; i < kGroup; ++i)
      if (i < n) p[i] = v[i];
  }
}

template <class E, bool kPrelu>
__device__ __forceinline__ typename E::T activate(typename E::T y, float b,
                                                  float s) {
  const typename E::T tv = E::round(E::load(y) + b);
  const float t = E::load(tv);
  if (kPrelu) return t > 0.f ? tv : E::round(s * t);
  return isnan(t) ? tv : E::round(fmaxf(t, 0.f));
}

// The pooled walk's position: pooled pixel (r, x), r = image * ho + pooled
// row, x the pooled column, of a grid of ho x wo pooled pixels an image.
struct Cursor {
  long long r;
  int x;
  __device__ __forceinline__ void advance(long long dr, int dx, int wo) {
    r += dr;
    x += dx;
    if (x >= wo) {
      x -= wo;
      ++r;
    }
  }
  // the input pixel at the top left of its window in images of h x w
  __device__ __forceinline__ long long corner(int h, int w) const {
    const long long row = 2 * r + ((h & 1) ? r / (h >> 1) : 0);
    return row * w + 2 * x;
  }
};

// Unpooled: y (pixels, c) -> out (pixels, c) and, unless null,
// wide[:, offset:offset + c] of (pixels, wide_c). Pooled (kPool): y
// (images * h * w, c) -> out (pixels, c), pixels = images * (h / 2) *
// (w / 2). `active` threads (a multiple of `groups`) walk the pixels; the
// rest return.
template <class E, bool kPrelu, bool kVec, bool kPool>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const typename E::T* __restrict__ y,
                const float* __restrict__ bias,
                const float* __restrict__ slope, typename E::T* __restrict__ out,
                typename E::T* __restrict__ wide, long long pixels, int c,
                int groups, int wide_c, int offset, int active, int h,
                int w) {
  using T = typename E::T;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= active) return;
  const int c0 = (t % groups) * kGroup;
  const int n = min(kGroup, c - c0);
  float b[kGroup], s[kGroup];
#pragma unroll
  for (int i = 0; i < kGroup; ++i) {
    b[i] = i < n ? E::load(E::round(bias[c0 + i])) : 0.f;
    s[i] = kPrelu && i < n ? E::load(E::round(slope[c0 + i])) : 0.f;
  }
  const long long step = active / groups;
  if (kPool) {
    const int wo = w >> 1;
    const long long first = t / groups;
    Cursor at{first / wo, static_cast<int>(first % wo)};
    const long long dr = step / wo;
    const int dx = static_cast<int>(step % wo);
    // the four groups of a window: (0, 0), (0, 1), (1, 0), (1, 1)
    const long long taps[4] = {0, c, static_cast<long long>(w) * c,
                               static_cast<long long>(w + 1) * c};
    for (long long p = first; p < pixels; p += kUnroll * step) {
      alignas(16) T v[kUnroll][4][kGroup];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (p + u * step < pixels) {
          const T* src = y + at.corner(h, w) * c + c0;
#pragma unroll
          for (int k = 0; k < 4; ++k) load8<E, kVec>(src + taps[k], n, v[u][k]);
        }
        at.advance(dr, dx, wo);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long q = p + u * step;
        if (q >= pixels) break;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          T m = activate<E, kPrelu>(v[u][0][i], b[i], s[i]);
          float mf = E::load(m);
#pragma unroll
          for (int k = 1; k < 4; ++k) {
            const T a = activate<E, kPrelu>(v[u][k][i], b[i], s[i]);
            const float af = E::load(a);
            const bool take = af > mf || isnan(af);
            m = take ? a : m;
            mf = take ? af : mf;
          }
          v[u][0][i] = m;
        }
        store8<E, kVec>(out + q * c + c0, n, v[u][0]);
      }
    }
    return;
  }
  for (long long p = t / groups; p < pixels; p += kUnroll * step) {
    alignas(16) T v[kUnroll][kGroup];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (p + u * step < pixels)
        load8<E, kVec>(y + (p + u * step) * c + c0, n, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = p + u * step;
      if (q >= pixels) break;
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        v[u][i] = activate<E, kPrelu>(v[u][i], b[i], s[i]);
      store8<E, kVec>(out + q * c + c0, n, v[u]);
      if (wide != nullptr)
        store8<E, kVec>(wide + q * wide_c + offset + c0, n, v[u]);
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % sizeof(uint4) == 0;
}

template <class E, bool kPrelu, bool kVec, bool kPool>
int run(const void* y, const float* bias, const float* slope, void* out,
        void* wide, long long pixels, int c, int wide_c, int offset, int h,
        int w, int device, cudaStream_t st) {
  using T = typename E::T;
  auto kernel = bias_act_kernel<E, kPrelu, kVec, kPool>;
  // blocks the card holds at once, per instance and device (found once)
  static int resident[kMaxDevices];
  if (resident[device] == 0) {
    int per_sm = 0, sms = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 0);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident[device] = per_sm * sms;
  }
  const int groups = (c + kGroup - 1) / kGroup;
  const long long work = pixels * groups;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident[device]) blocks = resident[device];
  if (blocks * kThreads < groups) blocks = (groups + kThreads - 1) / kThreads;
  const int active = static_cast<int>(blocks * kThreads / groups * groups);
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const T*>(y), bias, slope, static_cast<T*>(out),
      static_cast<T*>(wide), pixels, c, groups, wide_c, offset, active, h, w);
  return static_cast<int>(cudaGetLastError());
}

template <class E, bool kPrelu>
int launch(const void* y, const float* bias, const float* slope, void* out,
           void* wide, long long pixels, int c, int wide_c, int offset,
           int h, int w, bool pool, int device, cudaStream_t st) {
  using T = typename E::T;
  // 16-byte access: every group of 8 channels starts on a 16-byte boundary
  // of each tensor it touches
  const bool vec =
      c % kGroup == 0 && aligned(y) && aligned(out) &&
      (wide == nullptr ||
       (wide_c % kGroup == 0 && offset % kGroup == 0 &&
        aligned(static_cast<T*>(wide) + offset)));
  using Run = int (*)(const void*, const float*, const float*, void*, void*,
                      long long, int, int, int, int, int, int, cudaStream_t);
  const Run runs[2][2] = {
      {run<E, kPrelu, false, false>, run<E, kPrelu, false, true>},
      {run<E, kPrelu, true, false>, run<E, kPrelu, true, true>}};
  return runs[vec][pool](y, bias, slope, out, wide, pixels, c, wide_c, offset,
                         h, w, device, st);
}

}  // namespace

// y (pixels, c) bf16 (dtype 0) or float32 (1), bias and slope (c) float32
// (slope null: ReLU, else PReLU) -> out (pixels, c) and, unless wide is
// null, channels [offset, offset + c) of wide (pixels, wide_c), of y's
// type. With `pool` (wide null) y's pixels are images of h x w and out
// holds their 2x2 stride-2 max pool, (images * (h / 2) * (w / 2), c).
extern "C" int bias_act_launch(const void* y, const void* bias,
                               const void* slope, void* out, void* wide,
                               long long pixels, int c, int wide_c,
                               int offset, int h, int w, int pool, int dtype,
                               int device, void* stream) {
  if (pixels < 0 || c < 1 || (dtype != 0 && dtype != 1) ||
      out == nullptr || device < 0 ||
      device >= kMaxDevices ||
      (wide != nullptr && (offset < 0 || offset + c > wide_c)) ||
      (pool != 0 && (wide != nullptr || h < 1 || w < 1 ||
                     pixels % (static_cast<long long>(h) * w) != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pool != 0)
    pixels = pixels / (static_cast<long long>(h) * w) * (h / 2) * (w / 2);
  if (pixels == 0) return 0;
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(slope);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool p = pool != 0;
  if (dtype == 0)
    return s == nullptr
               ? launch<Bf16, false>(y, b, s, out, wide, pixels, c, wide_c,
                                     offset, h, w, p, device, st)
               : launch<Bf16, true>(y, b, s, out, wide, pixels, c, wide_c,
                                    offset, h, w, p, device, st);
  return s == nullptr
             ? launch<F32, false>(y, b, s, out, wide, pixels, c, wide_c,
                                  offset, h, w, p, device, st)
             : launch<F32, true>(y, b, s, out, wide, pixels, c, wide_c,
                                 offset, h, w, p, device, st);
}
