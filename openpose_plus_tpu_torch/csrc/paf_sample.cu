// Nearest-neighbour PAF sampling, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `sample_paf_pallas` / `_sample_kernel`
// (openpose_plus_tpu/ops/pallas/paf_sample.py): both PAF channels of every
// limb sampled at integer (y, x) points, bit-identical to a gather. The TPU
// kernel expressed the gather as one-hot matmuls on the MXU over a hand
// split of the f32 plane into three bf16 parts; Hopper loads any address,
// so this is the gather itself.
//
// What bounds it on the H100: latency and scattered 4-byte reads, not
// flops. One thread per (image, limb, sample): it reads its (y, x), the
// limb's two channel indices from the (L, 2) table, and the two map values
// at that pixel, which share a 32-byte sector when the channels are close.
// Offsets are 64-bit (the fidelity() map is 368 x 432 x 38 per image).
// Coordinates are in bounds by the caller's contract.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sample_paf_kernel(const float* __restrict__ paf, const int* __restrict__ sy,
                  const int* __restrict__ sx,
                  const long long* __restrict__ chans, float* __restrict__ px,
                  float* __restrict__ py, int h, int w, int c, int n_limbs,
                  int n, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / n;              // image * n_limbs + limb
  const long long img = row / n_limbs;
  const int limb = static_cast<int>(row - img * n_limbs);
  const long long base = ((img * h + sy[i]) * w + sx[i]) * c;
  px[i] = paf[base + chans[2 * limb]];
  py[i] = paf[base + chans[2 * limb + 1]];
}

}  // namespace

// paf (batch, h, w, c) float32; sy, sx (batch, n_limbs, n) int32;
// chans (n_limbs, 2) int64 -> px, py (batch, n_limbs, n) float32.
extern "C" int sample_paf_launch(const void* paf, const void* sy,
                                 const void* sx, const void* chans, void* px,
                                 void* py, int batch, int h, int w, int c,
                                 int n_limbs, int n, int device,
                                 void* stream) {
  if (batch < 0 || h < 1 || w < 1 || c < 1 || n_limbs < 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(batch) * n_limbs * n;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  sample_paf_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(paf), static_cast<const int*>(sy),
      static_cast<const int*>(sx), static_cast<const long long*>(chans),
      static_cast<float*>(px), static_cast<float*>(py), h, w, c, n_limbs, n,
      total);
  return static_cast<int>(cudaGetLastError());
}
