// Sequential subset merge (human assembly), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `assemble_pallas` / `_merge_kernel`
// (openpose_plus_tpu/ops/pallas/merge.py), with semantics bit-identical to
// `openpose_plus_tpu/postproc/group.py::assemble`: the CMU merge over the
// accepted limb connections in limb-major order. For each valid connection
// (A, B): find the rows holding A or B; one row -> attach B to it (the
// overwrite-and-count quirk: count and score bump even if the slot held
// another peak); two rows -> merge them if their parts are disjoint, else
// attach to the first; none -> create a row at the first empty slot, only
// for limbs < n_create and only while a row is free.
//
// What bounds it on the H100: launch latency and the serial dependency from
// one connection to the next, not bytes (a few KB per image). One block per
// image, ONE warp: lane r owns table row r (max_humans <= 32), its score and
// count live in that lane's registers, and the (18, 32) part table lives in
// shared memory column-major so lane r reads row r without bank conflicts.
// "First found row", "second found row" and "first empty row" are
// __ballot_sync + __ffs, exactly the reference's lowest-index choices. The
// per-connection gathers of the Pallas wrapper (gids, peak scores) happen
// in-kernel, and instead of compacting the valid slots the kernel walks all
// 19*K slots and skips the invalid ones, which are exact no-ops.
//
// Float associations are kept exactly as in the reference:
//   attach: score[j1] + (b_ps + cscore)
//   merge:  score[j1] + (score[j2] + cscore)
//   create: (a_ps + b_ps) + cscore
// (no multiplies, so FMA contraction cannot touch them; never build with
// --use_fast_math, which could reassociate).

#include <cuda_runtime.h>

namespace {

constexpr int kParts = 18;
constexpr int kMaxRows = 32;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(32)
assemble_kernel(const int* __restrict__ slot_a, const int* __restrict__ slot_b,
                const float* __restrict__ cscore,
                const bool* __restrict__ cvalid,
                const float* __restrict__ peak_score,
                const int* __restrict__ pairs, int n_limbs, int k, int m,
                int n_create, int* __restrict__ parts_out,
                float* __restrict__ score_out, int* __restrict__ count_out) {
  __shared__ int table[kParts][kMaxRows];   // table[part][row]; -1 = none
  const int lane = threadIdx.x;
  const bool live = lane < m;
  const long long img = blockIdx.x;
#pragma unroll
  for (int c = 0; c < kParts; ++c) table[c][lane] = -1;
  float score = 0.0f;
  int count = 0;
  __syncwarp();

  const long long conn0 = img * n_limbs * k;
  const float* ps = peak_score + img * kParts * k;
  for (int limb = 0; limb < n_limbs; ++limb) {
    const int ia = pairs[2 * limb];
    const int ib = pairs[2 * limb + 1];
    for (int t = 0; t < k; ++t) {
      const long long s = conn0 + static_cast<long long>(limb) * k + t;
      if (!cvalid[s]) continue;             // warp-uniform branch
      const int a_gid = ia * k + slot_a[s];
      const int b_gid = ib * k + slot_b[s];
      const float cs = cscore[s];
      const float a_ps = ps[a_gid];
      const float b_ps = ps[b_gid];

      const bool found =
          live && (table[ia][lane] == a_gid || table[ib][lane] == b_gid);
      const unsigned fmask = __ballot_sync(kFullMask, found);
      const int nfound = __popc(fmask);
      const int j1 = fmask ? __ffs(fmask) - 1 : 0;
      const unsigned fmask2 = fmask & ~(1u << j1);
      const int j2 = fmask2 ? __ffs(fmask2) - 1 : 0;
      const unsigned emask = __ballot_sync(kFullMask, live && count == 0);
      const int jnew = emask ? __ffs(emask) - 1 : 0;
      const bool overlap =
          __ballot_sync(kFullMask, lane < kParts && table[lane][j1] >= 0 &&
                                       table[lane][j2] >= 0) != 0;
      const int row1_ib = table[ib][j1];
      const float score2 = __shfl_sync(kFullMask, score, j2);
      const int count2 = __shfl_sync(kFullMask, count, j2);

      const bool attach =
          (nfound == 1 && row1_ib != b_gid) || (nfound == 2 && overlap);
      const bool merge = nfound == 2 && !overlap;
      const bool create = nfound == 0 && limb < n_create && emask != 0;
      __syncwarp();                         // every read before any write
      if (attach) {
        if (lane == j1) {
          table[ib][j1] = b_gid;
          score = score + (b_ps + cs);
          count += 1;
        }
      } else if (merge) {
        if (lane < kParts) {                // lane c moves column c
          const int v2 = table[lane][j2];
          table[lane][j1] = v2 >= 0 ? v2 : table[lane][j1];
          table[lane][j2] = -1;
        }
        if (lane == j1) {
          score = score + (score2 + cs);
          count += count2;
        } else if (lane == j2) {
          score = 0.0f;
          count = 0;
        }
      } else if (create) {
        if (lane < kParts)
          table[lane][jnew] = lane == ia ? a_gid : (lane == ib ? b_gid : -1);
        if (lane == jnew) {
          score = (a_ps + b_ps) + cs;
          count = 2;
        }
      }
      __syncwarp();
    }
  }

  if (live) {
    const long long r = img * m + lane;
    int* out = parts_out + r * kParts;
#pragma unroll
    for (int c = 0; c < kParts; ++c) out[c] = table[c][lane];
    score_out[r] = score;
    count_out[r] = count;
  }
}

}  // namespace

// Connections slot_a, slot_b (batch, n_limbs, k) int32, score (.., k)
// float32, valid (.., k) bool; peak_score (batch, 18, k) float32; pairs
// (n_limbs, 2) int32 -> parts (batch, m, 18) int32, subset score (batch, m)
// float32, count (batch, m) int32. All contiguous; m <= 32.
extern "C" int assemble_launch(const void* slot_a, const void* slot_b,
                               const void* score, const void* valid,
                               const void* peak_score, const void* pairs,
                               int batch, int n_limbs, int k, int max_humans,
                               int n_create, void* parts, void* subset_score,
                               void* count, int device, void* stream) {
  if (max_humans < 1 || max_humans > kMaxRows || k < 1 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  assemble_kernel<<<batch, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot_a), static_cast<const int*>(slot_b),
      static_cast<const float*>(score), static_cast<const bool*>(valid),
      static_cast<const float*>(peak_score), static_cast<const int*>(pairs),
      n_limbs, k, max_humans, n_create, static_cast<int*>(parts),
      static_cast<float*>(subset_score), static_cast<int*>(count));
  return static_cast<int>(cudaGetLastError());
}

// Human-readable text of a CUDA error code returned by the entries above.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
