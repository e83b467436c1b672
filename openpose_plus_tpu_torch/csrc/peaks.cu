// Heatmap peaks: 3x3 NMS, an exact per-part top K and the subpixel
// refinement, hand-written for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's NMS and top K are plain lax
// code (`openpose_plus_tpu/postproc/nms.py` find_peaks). The port's plain
// version (`postproc/nms.py` find_peaks_plain) is two max-pools, four
// masking passes and a full stable sort of every (image, part) row of H*W
// pixels, only to keep K of them; this computes the same PeakSet, bit for
// bit, in two launches and a memset.
//
// Its bound on the H100 is the bytes of the smoothed part maps, read once
// (8 x 368 x 432 x 18 float32 at the fidelity() decode, 92 MB, more than
// the 50 MB L2); the NMS's instructions are what hold it above that (1.).
// After NMS a row holds tens to a few hundred peaks, so the selection is
// small; its worst case is a checkerboard, where no two peaks are
// 8-adjacent (two adjacent peaks would be equal candidates, and the
// plateau tie-break keeps one): at most ceil(H/2) * ceil(W/2) a row.
//
// 1. `peak_keys_kernel`, one block a 32 x 8 tile of one image, all 18 parts
//    (BODY_25's 25 parts in two groups of 13, a block a group: 25 planes
//    and their candidacy would take 52 KB of shared memory, over the 48 KB
//    a block holds statically; the second group's last plane lies past the
//    parts, holds -inf and finds nothing):
//    the tile and a 2-pixel halo (the tie-break reads its neighbours'
//    candidacy, which reads theirs) come into shared memory once, by
//    asynchronous 4-byte copies (all of a thread's in flight together),
//    channel planes apart, -inf outside the map as max_pool2d pads. Then,
//    as the plain version computes it,
//      cand    = v >= the max of its 3x3 window (a row max, then a column
//                max, each NaN if any value is, as max_pool2d propagates
//                NaN) and v > threshold (in float32, as PyTorch compares a
//                tensor with a Python float),
//      is_peak = cand and no candidate among its four neighbours of lower
//                flat index (the plain version's -index max-pool).
//    It issues ~1,900 instructions a thread for 256 pixels of 18 parts, and
//    that, more than the bytes, sets its time (0.137 ms at the fidelity()
//    shape on an H100, against 0.027 ms for the bytes).
//    A warp is one tile row of one part, so the peaks it finds go to their
//    row's list with one atomic (a warp-aggregated append). A peak's key is
//    the order-preserving bits of its score above (-0.0 as +0.0, as
//    torch.sort ties them) and the complement of its flat index below:
//    descending keys are descending scores, ties to the lowest index, and
//    no two keys of a row are equal, so the order of the appends changes
//    nothing downstream.
// 2. `select_kernel`, one block a row: if the row holds more than K keys,
//    a radix select (8 bits a pass, from the top, stopping where a bucket
//    is taken whole) finds the least key of the top K; the selected keys are
//    ranked by counting the greater ones (in shared memory for up to
//    kRankCap of them), and each writes its slot: y, x, its score read
//    back from the map (its own bits), valid, and the 3-tap refinement op
//    for op as the plain version's float32 tensor code computes it, with
//    IEEE division and no contraction. Slots past the row's peaks get index
//    0, score 0 and valid false.
//
// The map is read through its strides (the decode's einsum leaves the
// (B, H, W, C) maps with H outermost), so no copy is made. The kernels
// allocate nothing and never synchronise: the wrapper's buffers and one
// memset make the call capturable in a CUDA graph.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kTileX = 32;                      // a warp's row
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;       // a warp per tile row
constexpr int kHalo = 2;
constexpr int kLoadX = kTileX + 2 * kHalo;
constexpr int kLoadY = kTileY + 2 * kHalo;
// an odd plane stride spreads a warp's stores over 18 channels across banks
constexpr int kPlane = kLoadY * kLoadX + 1;
constexpr int kCandX = kTileX + 2;              // the tile and a 1-pixel ring
constexpr int kCandY = kTileY + 2;
constexpr int kCandPlane = kCandY * kCandX;
constexpr int kSelectThreads = 256;
constexpr int kRankCap = 1024;                  // selected keys in shared memory
constexpr unsigned kFullMask = 0xffffffffu;

// a < b  <=>  ordered(a) < ordered(b) for floats that are not NaN; -0.0 and
// +0.0 share one value
__device__ __forceinline__ unsigned ordered(float s) {
  const unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// max(a, b), NaN if either is (as max_pool2d takes it)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float max3(float a, float b, float c) {
  return nan_max(nan_max(a, b), c);
}

// kParts parts, kGroup of them a block (all of them where kGroups is 1)
template <int kParts, int kGroup>
__global__ void __launch_bounds__(kThreads)
peak_keys_kernel(const float* __restrict__ maps, long long sb, long long sy,
                 long long sx, long long sc, int h, int w, float threshold,
                 int cap, unsigned long long* __restrict__ keys,
                 int* __restrict__ counts) {
  constexpr int kGroups = (kParts + kGroup - 1) / kGroup;
  __shared__ float v[kGroup * kPlane];
  __shared__ unsigned char cand[kGroup * kCandPlane];
  const int b = blockIdx.z / kGroups;
  const int c0 = (blockIdx.z - b * kGroups) * kGroup;   // the group's first
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y * kTileY;
  const float* img = maps + b * sb;

  // channels innermost, as the map lies: neighbouring threads, neighbouring
  // addresses; asynchronous copies, so a thread's ~30 loads are all in
  // flight at once
  for (int i = threadIdx.x; i < kLoadY * kLoadX * kGroup; i += kThreads) {
    const int c = i % kGroup;
    const int p = i / kGroup;
    const int lx = p % kLoadX;
    const int ly = p / kLoadX;
    const int gx = x0 - kHalo + lx;
    const int gy = y0 - kHalo + ly;
    float* dst = v + c * kPlane + ly * kLoadX + lx;
    const bool part = kGroups == 1 || c0 + c < kParts;
    if (part && gx >= 0 && gx < w && gy >= 0 && gy < h)
      __pipeline_memcpy_async(dst, img + gy * sy + gx * sx + (c0 + c) * sc,
                              sizeof(float));
    else
      *dst = -INFINITY;
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // candidacy of the tile and its ring, one column of one part a thread:
  // each row's 3-wide max, then the 3-high max of three of those, both
  // propagating NaN as max_pool2d does; a pixel outside the map holds -inf,
  // which is above no threshold
  for (int col = threadIdx.x; col < kGroup * kCandX; col += kThreads) {
    const int c = col / kCandX;
    const int cx = col - c * kCandX;
    const float* s = v + c * kPlane + cx;       // the windows' left column
    float above = max3(s[0], s[1], s[2]);
    float here = max3(s[kLoadX], s[kLoadX + 1], s[kLoadX + 2]);
    for (int cy = 0; cy < kCandY; ++cy) {
      const float* r = s + (cy + 2) * kLoadX;
      const float below = max3(r[0], r[1], r[2]);
      const float centre = s[(cy + 1) * kLoadX + 1];
      cand[c * kCandPlane + cy * kCandX + cx] =
          centre >= nan_max(nan_max(above, here), below) && centre > threshold;
      above = here;
      here = below;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int gx = x0 + lane;
  const int gy = y0 + ty;
  for (int c = 0; c < kGroup; ++c) {
    if (kGroups > 1 && c0 + c >= kParts) break;
    const unsigned char* q = cand + c * kCandPlane + (ty + 1) * kCandX + lane + 1;
    const bool peak = q[0] && !q[-kCandX - 1] && !q[-kCandX] &&
                      !q[-kCandX + 1] && !q[-1];
    const unsigned ballot = __ballot_sync(kFullMask, peak);
    if (ballot == 0) continue;
    int base = 0;
    if (lane == 0)
      base = atomicAdd(counts + b * kParts + c0 + c, __popc(ballot));
    base = __shfl_sync(kFullMask, base, 0);
    const int slot = base + __popc(ballot & ((1u << lane) - 1u));
    if (peak && slot < cap) {
      const float s = v[c * kPlane + (ty + kHalo) * kLoadX + lane + kHalo];
      const unsigned idx = static_cast<unsigned>(gy * w + gx);
      keys[static_cast<long long>(b * kParts + c0 + c) * cap + slot] =
          (static_cast<unsigned long long>(ordered(s)) << 32) | ~idx;
    }
  }
}

// the plain version's axis_offset: (0.5 * (next - prev)) / denom where
// |denom| > 1e-6 (false for NaN), else 0, clamped to [-0.5, 0.5] with NaN
// passed through as torch.clamp passes it
__device__ __forceinline__ float axis_offset(float centre, float prev,
                                             float next) {
  const float denom = __fsub_rn(__fsub_rn(__fmul_rn(2.0f, centre), next), prev);
  float off = 0.0f;
  if (fabsf(denom) > 1e-6f)
    off = __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(next, prev)), denom);
  return isnan(off) ? off : fminf(fmaxf(off, -0.5f), 0.5f);
}

struct Outputs {
  int* y;
  int* x;
  float* score;
  bool* valid;
  float* ry;
  float* rx;
};

template <int kParts>
__global__ void __launch_bounds__(kSelectThreads)
select_kernel(const float* __restrict__ maps, long long sb, long long sy,
              long long sx, long long sc, int h, int w, int k, int cap,
              const unsigned long long* __restrict__ keys,
              const int* __restrict__ counts, Outputs out) {
  __shared__ unsigned hist[256];
  __shared__ unsigned long long sel[kRankCap];
  __shared__ int n_sel, s_digit, s_above, s_bucket;
  const int row = blockIdx.x;                  // image * kParts + part
  const int b = row / kParts;
  const int part = row - b * kParts;
  const unsigned long long* rk = keys + static_cast<long long>(row) * cap;
  const int n = min(counts[row], cap);
  const int tid = threadIdx.x;

  // the least selected key: every key of the row when it holds at most k
  unsigned long long least = 0;
  if (n > k) {
    unsigned long long mask = 0;
    int rem = k;                                // still to take below prefix
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = tid; i < 256; i += kSelectThreads) hist[i] = 0;
      __syncthreads();
      for (int i = tid; i < n; i += kSelectThreads) {
        const unsigned long long key = rk[i];
        if ((key & mask) == least)
          atomicAdd(hist + ((key >> shift) & 255u), 1u);
      }
      __syncthreads();
      if (tid < 32) {                           // lane l: digits 255-8l ... 248-8l
        unsigned c[8];
        unsigned sum = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) sum += c[j] = hist[255 - 8 * tid - j];
        unsigned incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned o = __shfl_up_sync(kFullMask, incl, d);
          if (tid >= d) incl += o;
        }
        const unsigned hit = __ballot_sync(kFullMask, incl >= static_cast<unsigned>(rem));
        if (tid == __ffs(hit) - 1) {
          unsigned above = incl - sum;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (above + c[j] >= static_cast<unsigned>(rem)) {
              s_digit = 255 - 8 * tid - j;
              s_above = static_cast<int>(above);
              s_bucket = static_cast<int>(c[j]);
              break;
            }
            above += c[j];
          }
        }
      }
      __syncthreads();
      least |= static_cast<unsigned long long>(s_digit) << shift;
      mask |= 0xffull << shift;
      rem -= s_above;
      if (s_bucket == rem) break;               // the bucket is taken whole
    }
  }
  const int m = min(n, k);

  auto emit = [&](int rank, unsigned long long key) {
    const int idx = static_cast<int>(~static_cast<unsigned>(key));
    const int py = idx / w;
    const int px = idx - py * w;
    const float* p = maps + b * sb + part * sc;
    const float centre = p[py * sy + px * sx];
    float oy = 0.0f, ox = 0.0f;
    if (px > 0 && px < w - 1)
      ox = axis_offset(centre, p[py * sy + (px - 1) * sx],
                       p[py * sy + (px + 1) * sx]);
    if (py > 0 && py < h - 1)
      oy = axis_offset(centre, p[(py - 1) * sy + px * sx],
                       p[(py + 1) * sy + px * sx]);
    const long long o = static_cast<long long>(row) * k + rank;
    out.y[o] = py;
    out.x[o] = px;
    out.score[o] = centre;
    out.valid[o] = true;
    out.ry[o] = __fadd_rn(static_cast<float>(py), oy);
    out.rx[o] = __fadd_rn(static_cast<float>(px), ox);
  };

  if (m <= kRankCap) {
    if (tid == 0) n_sel = 0;
    __syncthreads();
    for (int i = tid; i < n; i += kSelectThreads) {
      const unsigned long long key = rk[i];
      if (key >= least) sel[atomicAdd(&n_sel, 1)] = key;
    }
    __syncthreads();
    for (int i = tid; i < m; i += kSelectThreads) {
      const unsigned long long key = sel[i];
      int rank = 0;
      for (int j = 0; j < m; ++j) rank += sel[j] > key;
      emit(rank, key);
    }
  } else {
    for (int i = tid; i < n; i += kSelectThreads) {
      const unsigned long long key = rk[i];
      if (key < least) continue;
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += rk[j] > key;
      emit(rank, key);
    }
  }
  for (int r = m + tid; r < k; r += kSelectThreads) {
    const long long o = static_cast<long long>(row) * k + r;
    out.y[o] = 0;
    out.x[o] = 0;
    out.score[o] = 0.0f;
    out.valid[o] = false;
    out.ry[o] = 0.0f;
    out.rx[o] = 0.0f;
  }
}

template <int kParts, int kGroup>
cudaError_t launch(const float* m, long long sb, long long sy, long long sx,
                   long long sc, int batch, int h, int w, float threshold,
                   int k, int cap, unsigned long long* keys, int* counts,
                   const Outputs& out, cudaStream_t st) {
  constexpr int kGroups = (kParts + kGroup - 1) / kGroup;
  if (batch * kGroups > 65535) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(counts, 0, sizeof(int) * batch * kParts, st);
  if (err != cudaSuccess) return err;
  const dim3 tiles((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY,
                   batch * kGroups);
  peak_keys_kernel<kParts, kGroup><<<tiles, kThreads, 0, st>>>(
      m, sb, sy, sx, sc, h, w, threshold, cap, keys, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  select_kernel<kParts><<<batch * kParts, kSelectThreads, 0, st>>>(
      m, sb, sy, sx, sc, h, w, k, cap, keys, counts, out);
  return cudaGetLastError();
}

}  // namespace

// maps (batch, h, w, >= n_parts) float32 at element strides (sb, sy, sx,
// sc); n_parts 18 (COCO) or 25 (BODY_25); keys (batch * n_parts * cap)
// uint64 and counts (batch * n_parts) int32 scratch, cap = ceil(h / 2) *
// ceil(w / 2); y, x (batch, n_parts, k) int32, score, ry, rx float32, valid
// bool. counts ends holding the peaks of each row.
extern "C" int find_peaks_launch(const void* maps, long long sb, long long sy,
                                 long long sx, long long sc, int batch, int h,
                                 int w, int n_parts, float threshold, int k,
                                 void* keys, int cap, void* counts, void* y,
                                 void* x, void* score, void* valid, void* ry,
                                 void* rx, int device, void* stream) {
  if (batch < 0 || batch > 65535 || h < 1 || w < 1 || k < 0 ||
      (n_parts != 18 && n_parts != 25) ||
      static_cast<long long>(h) * w > (1ll << 24) ||
      cap != ((h + 1) / 2) * ((w + 1) / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(maps);
  auto* kp = static_cast<unsigned long long*>(keys);
  auto* cp = static_cast<int*>(counts);
  const Outputs out{static_cast<int*>(y), static_cast<int*>(x),
                    static_cast<float*>(score), static_cast<bool*>(valid),
                    static_cast<float*>(ry), static_cast<float*>(rx)};
  err = n_parts == 18
            ? launch<18, 18>(m, sb, sy, sx, sc, batch, h, w, threshold, k, cap,
                             kp, cp, out, st)
            : launch<25, 13>(m, sb, sy, sx, sc, batch, h, w, threshold, k, cap,
                             kp, cp, out, st);
  return static_cast<int>(err);
}
