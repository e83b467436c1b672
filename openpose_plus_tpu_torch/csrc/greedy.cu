// Greedy per-limb candidate assignment, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `greedy_assign_pallas` / `_greedy_kernel`
// (openpose_plus_tpu/ops/pallas/greedy.py). For each image and each of its
// limbs (19 for COCO, 26 for BODY_25, a runtime count): K rounds of "take the max of the remaining K x K candidate
// scores, ties to the LOWEST row-major index; emit (slot_a, slot_b, score,
// valid); mask that candidate's row and column to -inf".
//
// What bounds it on the H100: the serial chain of rounds, not bytes
// (B * limbs * K * K floats in, a few KB out). Each round is a warp max, a
// warp min-index and a masking pass, each depending on the one before, and
// its compares, selects and min/max issue on the integer pipe at half a
// warp instruction a cycle, so a round costs its instruction count as much
// as its latency. The design keeps that chain short and on chip:
//
// - One warp per (image, limb), four to a block of 128 threads, so a thread
//   may hold its K*K/32 candidates in registers at K = 32 with no spill
//   (a block of 19 warps would cap a thread at ~104 registers).
// - Each score is turned once, at load, into an order-preserving unsigned
//   key (`key_of`): -0.0 and +0.0 share one key, as they tie under the
//   plain version's `rem == best`; a NaN sorts above everything, as the
//   plain version's amax propagates it (and then no round is valid). A
//   round's max is then one `redux.sync` (__reduce_max_sync) and its
//   lowest index one more (__reduce_min_sync): one instruction each where a
//   shuffle tree takes five dependent steps.
// - A candidate j = lane + 32 * i keeps its column j % K in a register,
//   computed at load; the winner's row is a multiply-high by ceil(2^32 / K)
//   (exact for j < 1024, K <= 32), and the row test is
//   (unsigned)(j - ja * K) < K: no integer division in the round loop.
//   A masked candidate gets key 0, below the key of -inf.
// - Once a round finds nothing above -inf (or a NaN), every later round
//   would repeat it, so the loop ends: the warp runs as many rounds as the
//   limb accepts connections, plus one.
// - Lane t keeps round t's result; the warp stores all K results once,
//   coalesced, after the loop.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;                      // (image, limb) rows a block
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kKeyNegInf = 0x007fffffu;   // key_of(-inf)
constexpr unsigned kKeyNaN = 0xffffffffu;      // key_of(NaN)

// a < b  <=>  key_of(a) < key_of(b) for floats that are not NaN
__device__ __forceinline__ unsigned key_of(float x) {
  unsigned u = __float_as_uint(x);
  u = u == 0x80000000u ? 0u : u;               // -0.0 -> +0.0
  const unsigned key = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return x != x ? kKeyNaN : key;
}

__device__ __forceinline__ float float_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// v[0] = max (or min) of v[0 .. 2W), as a tree; W is a compile-time power
// of two, so every index is a constant and v stays in registers.
template <int W, bool kMax, typename T>
__device__ __forceinline__ void tree(T* v) {
  if constexpr (W > 0) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      v[i] = kMax ? max(v[i], v[i + W]) : min(v[i], v[i + W]);
    tree<W / 2, kMax>(v);
  }
}

template <int NPL>
__global__ void __launch_bounds__(32 * kWarps)
greedy_assign_kernel(const float* __restrict__ scores, int rows, int k,
                     int* __restrict__ slot_a, int* __restrict__ slot_b,
                     float* __restrict__ score, bool* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;                     // the whole warp
  const int kk = k * k;
  // ceil(2^32 / k); wraps to 0 at k = 1, where every index is 0
  const unsigned kdiv = 0xffffffffu / static_cast<unsigned>(k) + 1u;
  const float* src = scores + static_cast<long long>(row) * kk;

  // Candidate j = lane + 32 * i: key[i], column col[i]. Slots past K*K
  // hold key 0 and are never chosen. Every load is issued before any is
  // used (a load guarded by a branch and used inside it would wait there).
  float x[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) x[i] = __ldg(src + min(lane + 32 * i, kk - 1));
  unsigned key[NPL];
  int col[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const int j = lane + 32 * i;
    key[i] = j < kk ? key_of(x[i]) : 0u;
    col[i] = j - static_cast<int>(__umulhi(j, kdiv)) * k;
  }

  int res_a = 0, res_b = 0;                    // round `lane`'s result
  unsigned res_key = 0u;
  bool res_ok = false;
  for (int t = 0; t < k; ++t) {
    unsigned m[NPL];                           // this lane's max
#pragma unroll
    for (int i = 0; i < NPL; ++i) m[i] = key[i];
    tree<NPL / 2, true>(m);
    const unsigned best = __reduce_max_sync(kFullMask, m[0]);
    if (best <= kKeyNegInf || best == kKeyNaN) break;   // warp-uniform

    // lowest candidate index holding the max: this lane's, then the warp's
    int jl[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) jl[i] = key[i] == best ? lane + 32 * i : kk;
    tree<NPL / 2, false>(jl);
    const int jmin = __reduce_min_sync(kFullMask, jl[0]);
    const int ja = static_cast<int>(__umulhi(jmin, kdiv));
    const int jb = jmin - ja * k;
    if (lane == t) {
      res_a = ja;
      res_b = jb;
      res_key = best;
      res_ok = true;
    }
    const int base = lane - ja * k;            // candidate j's row is ja iff
#pragma unroll                                 // 0 <= j - ja * k < k
    for (int i = 0; i < NPL; ++i)
      if (static_cast<unsigned>(base + 32 * i) < static_cast<unsigned>(k) ||
          col[i] == jb)
        key[i] = 0u;
  }

  if (lane < k) {
    const long long o = static_cast<long long>(row) * k + lane;
    slot_a[o] = res_a;
    slot_b[o] = res_b;
    score[o] = res_ok ? float_of(res_key) : 0.0f;
    valid[o] = res_ok;
  }
}

template <int NPL>
void launch(const float* scores, int rows, int k, int* slot_a, int* slot_b,
            float* score, bool* valid, cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  greedy_assign_kernel<NPL><<<blocks, 32 * kWarps, 0, stream>>>(
      scores, rows, k, slot_a, slot_b, score, valid);
}

}  // namespace

// scores (batch, n_limbs, k, k) float32 -> slot_a, slot_b (batch, n_limbs,
// k) int32, score (batch, n_limbs, k) float32, valid (batch, n_limbs, k)
// bool. All contiguous.
extern "C" int greedy_assign_launch(const void* scores, int batch,
                                    int n_limbs, int k, void* slot_a,
                                    void* slot_b, void* score, void* valid,
                                    int device, void* stream) {
  if (k < 1 || k > 32 || batch < 0 || n_limbs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const float* s = static_cast<const float*>(scores);
  const int rows = batch * n_limbs;
  int* sa = static_cast<int*>(slot_a);
  int* sb = static_cast<int*>(slot_b);
  float* sc = static_cast<float*>(score);
  bool* ok = static_cast<bool*>(valid);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int npl = (k * k + 31) / 32;
  if (npl <= 1) launch<1>(s, rows, k, sa, sb, sc, ok, st);
  else if (npl <= 2) launch<2>(s, rows, k, sa, sb, sc, ok, st);
  else if (npl <= 4) launch<4>(s, rows, k, sa, sb, sc, ok, st);
  else if (npl <= 8) launch<8>(s, rows, k, sa, sb, sc, ok, st);
  else if (npl <= 16) launch<16>(s, rows, k, sa, sb, sc, ok, st);
  else launch<32>(s, rows, k, sa, sb, sc, ok, st);
  return static_cast<int>(cudaGetLastError());
}
