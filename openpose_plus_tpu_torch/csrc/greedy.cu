// Greedy per-limb candidate assignment, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `greedy_assign_pallas` / `_greedy_kernel`
// (openpose_plus_tpu/ops/pallas/greedy.py). For each image and each of the
// 19 limbs: K rounds of "take the max of the remaining K x K candidate
// scores, ties to the LOWEST row-major index; emit (slot_a, slot_b, score,
// valid); mask that candidate's row and column to -inf".
//
// What bounds it on the H100: launch latency and the serial dependency
// between rounds, not bytes (B * 19 * K * K floats in, a few KB out). The
// design keeps the whole round loop on chip: one block per image, one warp
// per limb, the limb's K*K scores in registers (NPL per lane), each round a
// warp max-reduce followed by a min-index reduce over the lanes holding the
// max. No argmax with an unspecified tie order is used. K <= 32.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kLimbs = 19;
constexpr unsigned kFullMask = 0xffffffffu;

template <int NPL>
__global__ void __launch_bounds__(32 * kLimbs)
greedy_assign_kernel(const float* __restrict__ scores, int k,
                     int* __restrict__ slot_a, int* __restrict__ slot_b,
                     float* __restrict__ score, bool* __restrict__ valid) {
  const int limb = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int kk = k * k;
  const long long row = static_cast<long long>(blockIdx.x) * kLimbs + limb;
  const float* src = scores + row * kk;

  // Candidate j = lane + 32 * i lives in v[i]; slots past K*K hold -inf.
  // ab[i] packs the candidate's (a, b) = (j / k, j % k) as a << 16 | b.
  float v[NPL];
  int ab[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < kk ? src[j] : -CUDART_INF_F;
    ab[i] = ((j / k) << 16) | (j % k);
  }

  for (int t = 0; t < k; ++t) {
    float best = v[0];
#pragma unroll
    for (int i = 1; i < NPL; ++i) best = fmaxf(best, v[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(kFullMask, best, off));

    // Lowest candidate index holding the max (this lane's lowest, then
    // the warp's). With every candidate at -inf this is index 0, as in
    // the reference's argmax.
    int jmin = kk;
#pragma unroll
    for (int i = NPL - 1; i >= 0; --i) {
      const int j = lane + 32 * i;
      if (j < kk && v[i] == best) jmin = j;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      jmin = min(jmin, __shfl_xor_sync(kFullMask, jmin, off));

    const bool ok = best > -CUDART_INF_F;
    const int ja = jmin / k;
    const int jb = jmin - ja * k;
    if (ok) {
#pragma unroll
      for (int i = 0; i < NPL; ++i)
        if ((ab[i] >> 16) == ja || (ab[i] & 0xffff) == jb) v[i] = -CUDART_INF_F;
    }
    if (lane == 0) {
      const long long o = row * k + t;
      slot_a[o] = ok ? ja : 0;
      slot_b[o] = ok ? jb : 0;
      score[o] = ok ? best : 0.0f;
      valid[o] = ok;
    }
  }
}

template <int NPL>
void launch(const float* scores, int batch, int k, int* slot_a, int* slot_b,
            float* score, bool* valid, cudaStream_t stream) {
  greedy_assign_kernel<NPL><<<batch, 32 * kLimbs, 0, stream>>>(
      scores, k, slot_a, slot_b, score, valid);
}

}  // namespace

// scores (batch, 19, k, k) float32 -> slot_a, slot_b (batch, 19, k) int32,
// score (batch, 19, k) float32, valid (batch, 19, k) bool. All contiguous.
extern "C" int greedy_assign_launch(const void* scores, int batch, int k,
                                    void* slot_a, void* slot_b, void* score,
                                    void* valid, int device, void* stream) {
  if (k < 1 || k > 32 || batch < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const float* s = static_cast<const float*>(scores);
  int* sa = static_cast<int*>(slot_a);
  int* sb = static_cast<int*>(slot_b);
  float* sc = static_cast<float*>(score);
  bool* ok = static_cast<bool*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npl = (k * k + 31) / 32;
  if (npl <= 1) launch<1>(s, batch, k, sa, sb, sc, ok, st);
  else if (npl <= 2) launch<2>(s, batch, k, sa, sb, sc, ok, st);
  else if (npl <= 4) launch<4>(s, batch, k, sa, sb, sc, ok, st);
  else if (npl <= 8) launch<8>(s, batch, k, sa, sb, sc, ok, st);
  else if (npl <= 16) launch<16>(s, batch, k, sa, sb, sc, ok, st);
  else launch<32>(s, batch, k, sa, sb, sc, ok, st);
  return static_cast<int>(cudaGetLastError());
}
