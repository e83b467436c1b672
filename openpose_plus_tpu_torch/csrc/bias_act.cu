// A conv's epilogue: bias, then ReLU or Caffe's per-channel PReLU, and an
// optional second store at a channel offset of a wider buffer, hand-written
// for Hopper (sm_90a).
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
// in float32 arithmetic on T = bf16 or float32 values, the operations and
// roundings of those PyTorch expressions, so the result is theirs bit for
// bit. Bias and slope are read as float32 parameters and rounded to T in
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

// y (pixels, c) -> out (pixels, c) and, unless null, wide[:, offset:offset
// + c] of (pixels, wide_c). `active` threads (a multiple
// of `groups`) walk the pixels; the rest return.
template <class E, bool kPrelu, bool kVec>
__global__ void __launch_bounds__(kThreads)
bias_act_kernel(const typename E::T* __restrict__ y,
                const float* __restrict__ bias,
                const float* __restrict__ slope, typename E::T* __restrict__ out,
                typename E::T* __restrict__ wide, long long pixels, int c,
                int groups, int wide_c, int offset, int active) {
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

template <class E, bool kPrelu, bool kVec>
int run(const void* y, const float* bias, const float* slope, void* out,
        void* wide, long long pixels, int c, int wide_c, int offset,
        int device, cudaStream_t st) {
  using T = typename E::T;
  auto kernel = bias_act_kernel<E, kPrelu, kVec>;
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
      static_cast<T*>(wide), pixels, c, groups, wide_c, offset, active);
  return static_cast<int>(cudaGetLastError());
}

template <class E, bool kPrelu>
int launch(const void* y, const float* bias, const float* slope, void* out,
           void* wide, long long pixels, int c, int wide_c, int offset,
           int device, cudaStream_t st) {
  using T = typename E::T;
  // 16-byte access: every group of 8 channels starts on a 16-byte boundary
  // of each tensor it touches
  const bool vec =
      c % kGroup == 0 && aligned(y) && aligned(out) &&
      (wide == nullptr ||
       (wide_c % kGroup == 0 && offset % kGroup == 0 &&
        aligned(static_cast<T*>(wide) + offset)));
  return vec ? run<E, kPrelu, true>(y, bias, slope, out, wide, pixels, c,
                                    wide_c, offset, device, st)
             : run<E, kPrelu, false>(y, bias, slope, out, wide, pixels, c,
                                     wide_c, offset, device, st);
}

}  // namespace

// y (pixels, c) bf16 (dtype 0) or float32 (1), bias and slope (c) float32
// (slope null: ReLU, else PReLU) -> out (pixels, c) and, unless wide is
// null, channels [offset, offset + c) of wide (pixels, wide_c), of y's
// type.
extern "C" int bias_act_launch(const void* y, const void* bias,
                               const void* slope, void* out, void* wide,
                               long long pixels, int c, int wide_c,
                               int offset, int dtype, int device,
                               void* stream) {
  if (pixels < 0 || c < 1 || (dtype != 0 && dtype != 1) ||
      out == nullptr || device < 0 ||
      device >= kMaxDevices ||
      (wide != nullptr && (offset < 0 || offset + c > wide_c)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (pixels == 0) return 0;
  const float* b = static_cast<const float*>(bias);
  const float* s = static_cast<const float*>(slope);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return s == nullptr
               ? launch<Bf16, false>(y, b, s, out, wide, pixels, c, wide_c,
                                     offset, device, st)
               : launch<Bf16, true>(y, b, s, out, wide, pixels, c, wide_c,
                                    offset, device, st);
  return s == nullptr
             ? launch<F32, false>(y, b, s, out, wide, pixels, c, wide_c,
                                  offset, device, st)
             : launch<F32, true>(y, b, s, out, wide, pixels, c, wide_c,
                                 offset, device, st);
}
