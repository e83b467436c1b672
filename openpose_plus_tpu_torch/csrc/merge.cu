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
// What bounds it on the H100: the dependent on-chip path of one step times
// the number of valid connections, not bytes (a few KB per image): ballots,
// a popcount and a few predicates in registers. One block of 128 threads
// per image, in two parts:
//
// 1. Stage, then compact (all four warps). Every global load comes first:
//    the image's connection fields and its (parts, K) peak scores are copied
//    into shared memory, 16 bytes a thread where the layout allows. Then the
//    valid slots are compacted, in limb-major order, by `__ballot_sync` /
//    `__popc` prefix counts over 32-slot chunks, into 32-byte records that
//    hold what the chain needs: both global peak ids, both part columns,
//    whether the limb may create a row, the connection score and the two
//    sums the reference forms from peak scores (as the TPU wrapper
//    precomputed them). Invalid slots are exact no-ops and vanish here.
// 2. The chain (warp 0), over the n_valid records only. Lane r owns table
//    row r (max_humans <= 32): its score, count and part-occupancy mask (a
//    bit a part: 18 for COCO, 25 for BODY_25, the part count a template
//    parameter) live in that lane's registers; the (parts, 32) table of
//    peak ids
//    lives in shared memory column-major, so lane r reads row r without
//    bank conflicts. A step compares table[ia][r] and table[ib][r] with the
//    connection's peaks and takes three ballots ("found", "found by B",
//    "empty"). The reference's lowest-index choices need no index on the
//    common path: the lane that attaches is the first found row (no found
//    row below it), the lane that creates the first empty row, and both
//    write their own row with predicated stores, no branch. So the next
//    step's two cells are read before this step writes, and the acting
//    lane forwards its own writes into them: no shared-memory round trip
//    is left on the chain. Only a two-row find (merge or overlap) finds j1
//    and j2 (__ffs) and shuffles their occupancy masks (overlap is their
//    AND); a merge moves cells between rows and reads the next cells
//    again. Records are loaded two steps ahead (they never depend on the
//    table); one __syncwarp a step orders its writes before later reads.
//    Outputs are stored once, coalesced, after the chain.
//
// Float associations are kept exactly as in the reference:
//   attach: score[j1] + (b_ps + cscore)
//   merge:  score[j1] + (score[j2] + cscore)
//   create: (a_ps + b_ps) + cscore
// (round-to-nearest adds, `__fadd_rn`, which no contraction or fast-math
// flag may touch; never build with --use_fast_math).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxRows = 32;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunks16 = 2;       // 16-byte staging: chunks a thread a field
constexpr unsigned kFullMask = 0xffffffffu;

// One valid connection, as the chain reads it (two 16-byte loads).
struct alignas(16) Record {
  unsigned gids;    // a_gid | b_gid << 16
  unsigned cells;   // byte offsets of table columns ia, ib: off_a | off_b << 16
  unsigned bit_b;   // 1 << ib
  unsigned bit_ab;  // 1 << ia | 1 << ib
  float cs;         // connection score
  float bcs;        // b_ps + cs              (attach)
  float fresh;      // (a_ps + b_ps) + cs     (create)
  int create;       // limb < n_create: may create a row
};

// Shared-memory word access by 32-bit shared address. The chain's table
// addresses are computed once, before it: left to itself the compiler
// recomputes the table's shared window base (S2R SR_CgaCtaId) inside the
// loop, on every step's dependent path.
__device__ __forceinline__ int lds(unsigned addr) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts(unsigned addr, int v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Dynamic shared memory, in bytes from its start: the staged fields, the
// per-chunk valid counts, the records.
struct Layout {
  int slot_a, slot_b, cscore, valid, peaks, counts, records, total;
  __host__ __device__ Layout(int n_slots, int n_peaks) {
    const int words = round16(4 * n_slots);
    slot_a = 0;
    slot_b = slot_a + words;
    cscore = slot_b + words;
    valid = cscore + words;
    peaks = valid + round16(n_slots);
    counts = peaks + round16(4 * n_peaks);
    records = counts + round16(4 * ((n_slots + 31) / 32));
    total = records + static_cast<int>(sizeof(Record)) * n_slots;
  }
};

// Copy the image's five input fields into shared memory. 16 bytes a thread,
// every load issued before any store, where each field's source is 16-byte
// aligned and a multiple of 16 bytes that fits kMaxChunks16 chunks a
// thread; element by element otherwise.
__device__ void stage(unsigned char* smem, const Layout& lay, int n_slots,
                      int n_peaks, const int* slot_a, const int* slot_b,
                      const float* cscore, const bool* cvalid,
                      const float* peaks) {
  const int tid = threadIdx.x;
  const void* src[5] = {slot_a, slot_b, cscore, cvalid, peaks};
  const int dst[5] = {lay.slot_a, lay.slot_b, lay.cscore, lay.valid,
                      lay.peaks};
  const int bytes[5] = {4 * n_slots, 4 * n_slots, 4 * n_slots, n_slots,
                        4 * n_peaks};
  bool wide = true;
#pragma unroll
  for (int f = 0; f < 5; ++f)
    wide = wide && (reinterpret_cast<uintptr_t>(src[f]) & 15) == 0 &&
           (bytes[f] & 15) == 0 && bytes[f] <= 16 * kThreads * kMaxChunks16;
  if (wide) {
    int4 v[5][kMaxChunks16];
#pragma unroll
    for (int f = 0; f < 5; ++f)
#pragma unroll
      for (int u = 0; u < kMaxChunks16; ++u) {
        const int i = tid + u * kThreads;
        if (16 * i < bytes[f])
          v[f][u] = __ldg(static_cast<const int4*>(src[f]) + i);
      }
#pragma unroll
    for (int f = 0; f < 5; ++f)
#pragma unroll
      for (int u = 0; u < kMaxChunks16; ++u) {
        const int i = tid + u * kThreads;
        if (16 * i < bytes[f])
          reinterpret_cast<int4*>(smem + dst[f])[i] = v[f][u];
      }
    return;
  }
  int* sa = reinterpret_cast<int*>(smem + lay.slot_a);
  int* sb = reinterpret_cast<int*>(smem + lay.slot_b);
  float* sc = reinterpret_cast<float*>(smem + lay.cscore);
  bool* sv = reinterpret_cast<bool*>(smem + lay.valid);
  float* sp = reinterpret_cast<float*>(smem + lay.peaks);
  for (int i = tid; i < n_slots; i += kThreads) {
    sa[i] = slot_a[i];
    sb[i] = slot_b[i];
    sc[i] = cscore[i];
    sv[i] = cvalid[i];
  }
  for (int i = tid; i < n_peaks; i += kThreads) sp[i] = peaks[i];
}

template <int kParts>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(const int* __restrict__ slot_a, const int* __restrict__ slot_b,
                const float* __restrict__ cscore,
                const bool* __restrict__ cvalid,
                const float* __restrict__ peak_score,
                const int* __restrict__ pairs, int n_limbs, int k, int m,
                int n_create, int* __restrict__ parts_out,
                float* __restrict__ score_out, int* __restrict__ count_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int table[kParts][kMaxRows];   // table[part][row]; -1 = none
  __shared__ int pair_cols[2 * 32];         // (ia, ib) per limb
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long img = blockIdx.x;
  const int n_slots = n_limbs * k;
  const int n_peaks = kParts * k;
  const int n_chunks = (n_slots + 31) / 32;
  const Layout lay(n_slots, n_peaks);

  // ---- 1. stage (every global load of the kernel), then compact ---------
  if (tid < 2 * n_limbs) pair_cols[tid] = pairs[tid];
  stage(smem, lay, n_slots, n_peaks, slot_a + img * n_slots,
        slot_b + img * n_slots, cscore + img * n_slots,
        cvalid + img * n_slots, peak_score + img * n_peaks);
  for (int i = tid; i < kParts * kMaxRows; i += kThreads)
    (&table[0][0])[i] = -1;
  __syncthreads();

  const int* sa = reinterpret_cast<const int*>(smem + lay.slot_a);
  const int* sb = reinterpret_cast<const int*>(smem + lay.slot_b);
  const float* sc = reinterpret_cast<const float*>(smem + lay.cscore);
  const bool* sv = reinterpret_cast<const bool*>(smem + lay.valid);
  const float* ps = reinterpret_cast<const float*>(smem + lay.peaks);
  int* counts = reinterpret_cast<int*>(smem + lay.counts);
  Record* recs = reinterpret_cast<Record*>(smem + lay.records);
  for (int c = warp; c < n_chunks; c += kWarps) {
    const int s = 32 * c + lane;
    const unsigned vm = __ballot_sync(kFullMask, s < n_slots && sv[s]);
    if (lane == 0) counts[c] = __popc(vm);
  }
  __syncthreads();
  for (int c = warp; c < n_chunks; c += kWarps) {
    int base = 0;                             // valid slots before chunk c
    for (int c0 = 0; c0 < c; c0 += 32)
      base += __reduce_add_sync(kFullMask,
                                c0 + lane < c ? counts[c0 + lane] : 0);
    const int s = 32 * c + lane;
    const bool v = s < n_slots && sv[s];
    const unsigned vm = __ballot_sync(kFullMask, v);
    if (v) {
      const int limb = s / k;
      const int ia = pair_cols[2 * limb];
      const int ib = pair_cols[2 * limb + 1];
      const int a_gid = ia * k + sa[s];
      const int b_gid = ib * k + sb[s];
      const float cs = sc[s];
      const float a_ps = ps[a_gid];
      const float b_ps = ps[b_gid];
      Record r;
      r.gids = static_cast<unsigned>(a_gid) |
               (static_cast<unsigned>(b_gid) << 16);
      r.cells = 4u * kMaxRows * (ia | (ib << 16));
      r.bit_b = 1u << ib;
      r.bit_ab = (1u << ia) | (1u << ib);
      r.cs = cs;
      r.bcs = __fadd_rn(b_ps, cs);
      r.fresh = __fadd_rn(__fadd_rn(a_ps, b_ps), cs);
      r.create = limb < n_create;
      recs[base + __popc(vm & ((1u << lane) - 1u))] = r;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // ---- 2. the chain: warp 0, lane r owns row r ----------------------------
  int n_valid = 0;
  for (int c0 = 0; c0 < n_chunks; c0 += 32)
    n_valid += __reduce_add_sync(kFullMask,
                                 c0 + lane < n_chunks ? counts[c0 + lane] : 0);
  const bool live = lane < m;
  const unsigned below = (1u << lane) - 1u;   // lanes < this one
  // table[c][row] is at tab + 4 * (kMaxRows * c + row); this lane's cell of
  // column c at mine + 4 * kMaxRows * c (a record's `cells`)
  const unsigned tab =
      static_cast<unsigned>(__cvta_generic_to_shared(&table[0][0]));
  const unsigned mine = tab + 4u * lane;
  float score = 0.0f;
  int count = 0;
  unsigned occ = 0u;                          // bit c: table[c][lane] >= 0
  const int last = max(n_valid - 1, 0);       // (recs[0] unused if none)
  Record r = recs[0];
  Record ahead = recs[min(1, last)];
  int va = 0, vb = 0;
  if (n_valid > 0) {                          // r holds a column offset
    va = lds(mine + (r.cells & 0xffffu));
    vb = lds(mine + (r.cells >> 16));
  }
  // two steps an iteration: the record rotation (r = n) is renaming, not
  // register moves
#pragma unroll 2
  for (int i = 0; i < n_valid; ++i) {
    // The next step's record and cells, read before this step writes: the
    // common path writes only this lane's own row, and forwards it below.
    // Records never depend on the table: load two ahead.
    const Record n = ahead;
    ahead = recs[min(i + 2, last)];
    const unsigned na = mine + (n.cells & 0xffffu);
    const unsigned nb = mine + (n.cells >> 16);
    int va_next = lds(na);
    int vb_next = lds(nb);

    const int a_gid = r.gids & 0xffffu;
    const int b_gid = r.gids >> 16;
    const bool has_b = live & (vb == b_gid);
    const bool found = has_b | (live & (va == a_gid));
    const bool empty = live & (count == 0);
    const unsigned fmask = __ballot_sync(kFullMask, found);
    const unsigned bmask = __ballot_sync(kFullMask, has_b);
    const unsigned emask = __ballot_sync(kFullMask, empty);
    const int nfound = __popc(fmask);
    // One found row attaches unless it holds B already (then bmask is that
    // row); no found row creates at the first empty row. The lane that acts
    // is the row itself: the first found, or the first empty.
    bool attach = nfound == 1 && bmask == 0u;
    const bool create = nfound == 0 && r.create && emask != 0u;
    const bool first = found && (fmask & below) == 0u;
    if (nfound == 2) {                        // warp-uniform
      const int j1 = __ffs(fmask) - 1;
      const int j2 = __ffs(fmask & (fmask - 1u)) - 1;
      const unsigned occ1 = __shfl_sync(kFullMask, occ, j1);
      const unsigned occ2 = __shfl_sync(kFullMask, occ, j2);
      const float score2 = __shfl_sync(kFullMask, score, j2);
      const int count2 = __shfl_sync(kFullMask, count, j2);
      attach = (occ1 & occ2) != 0u;
      if (!attach) {                          // merge row j2 into row j1
        if (lane < kParts && ((occ2 >> lane) & 1u)) {
          const unsigned col = tab + 4u * kMaxRows * lane;
          sts(col + 4u * j1, lds(col + 4u * j2));
          sts(col + 4u * j2, -1);
        }
        if (lane == j1) {
          score = __fadd_rn(score, __fadd_rn(score2, r.cs));
          count += count2;
          occ |= occ2;
        } else if (lane == j2) {
          score = 0.0f;
          count = 0;
          occ = 0u;
        }
        __syncwarp();                         // other rows moved: read again
        va_next = lds(na);
        vb_next = lds(nb);
      }
    }
    // attach to the first found row; create at the first empty row (which
    // holds no part, so only its two new cells are written)
    const bool do_attach = attach && first;
    const bool do_create = create && empty && (emask & below) == 0u;
    const unsigned cell_a = mine + (r.cells & 0xffffu);
    const unsigned cell_b = mine + (r.cells >> 16);
    if (do_attach || do_create) {
      sts(cell_b, b_gid);
      va_next = na == cell_b ? b_gid : va_next;
      vb_next = nb == cell_b ? b_gid : vb_next;
    }
    if (do_create) {
      sts(cell_a, a_gid);
      va_next = na == cell_a ? a_gid : va_next;
      vb_next = nb == cell_a ? a_gid : vb_next;
    }
    score = do_attach ? __fadd_rn(score, r.bcs) : do_create ? r.fresh : score;
    count = do_attach ? count + 1 : do_create ? 2 : count;
    occ = do_attach ? occ | r.bit_b : do_create ? r.bit_ab : occ;
    r = n;
    va = va_next;
    vb = vb_next;
    __syncwarp();
  }

  // ---- outputs, once: the image's (m, parts) block in order ----------------
  int* out = parts_out + img * m * kParts;
  for (int e = lane; e < m * kParts; e += 32) {
    const int row = e / kParts;
    out[e] = table[e - row * kParts][row];
  }
  if (live) {
    score_out[img * m + lane] = score;
    count_out[img * m + lane] = count;
  }
}

}  // namespace

template <int kParts>
cudaError_t launch(const void* slot_a, const void* slot_b, const void* score,
                   const void* valid, const void* peak_score,
                   const void* pairs, int batch, int n_limbs, int k,
                   int max_humans, int n_create, void* parts,
                   void* subset_score, void* count, cudaStream_t stream) {
  if (kParts * k > 0xffff) return cudaErrorInvalidValue;
  const int smem = Layout(n_limbs * k, kParts * k).total;
  if (smem > 48 * 1024) {                     // large K only (K > ~50)
    const cudaError_t err = cudaFuncSetAttribute(
        assemble_kernel<kParts>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  assemble_kernel<kParts><<<batch, kThreads, smem, stream>>>(
      static_cast<const int*>(slot_a), static_cast<const int*>(slot_b),
      static_cast<const float*>(score), static_cast<const bool*>(valid),
      static_cast<const float*>(peak_score), static_cast<const int*>(pairs),
      n_limbs, k, max_humans, n_create, static_cast<int*>(parts),
      static_cast<float*>(subset_score), static_cast<int*>(count));
  return cudaGetLastError();
}

// Connections slot_a, slot_b (batch, n_limbs, k) int32, score (.., k)
// float32, valid (.., k) bool; peak_score (batch, n_parts, k) float32;
// pairs (n_limbs, 2) int32 -> parts (batch, m, n_parts) int32, subset score
// (batch, m) float32, count (batch, m) int32. All contiguous; n_parts 18
// (COCO) or 25 (BODY_25), m <= 32, n_limbs <= 32.
extern "C" int assemble_launch(const void* slot_a, const void* slot_b,
                               const void* score, const void* valid,
                               const void* peak_score, const void* pairs,
                               int batch, int n_limbs, int n_parts, int k,
                               int max_humans, int n_create, void* parts,
                               void* subset_score, void* count, int device,
                               void* stream) {
  if (max_humans < 1 || max_humans > kMaxRows || k < 1 || batch < 0 ||
      n_limbs < 1 || n_limbs > 32 || (n_parts != 18 && n_parts != 25))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      n_parts == 18
          ? launch<18>(slot_a, slot_b, score, valid, peak_score, pairs, batch,
                       n_limbs, k, max_humans, n_create, parts, subset_score,
                       count, st)
          : launch<25>(slot_a, slot_b, score, valid, peak_score, pairs, batch,
                       n_limbs, k, max_humans, n_create, parts, subset_score,
                       count, st));
}

// Human-readable text of a CUDA error code returned by the entries above.
extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
