// Fused depthwise-separable conv and the depthwise probe, hand-written for
// Hopper (sm_90a).
//
// fused_sepconv replaces the TPU kernel `fused_sepconv` / `_sepconv_kernel`
// (openpose_plus_tpu/ops/pallas/sepconv.py):
//   y = relu(bf16(pw1x1(relu(bf16(dw3x3(x)) + b_dw))) + b_pw)
// stride 1, SAME (zero) padding, NHWC bf16 in and out, f32 accumulation.
// dw3x3_relu and copy_bias replace the probe `run`'s two bodies
// (scripts/profile_pallas_dw.py: `dw_kernel`, `copy_kernel`): the 9-tap
// depthwise + ReLU alone (no bias, f32 ReLU, one bf16 rounding), and
// `x + dwk[0, :]` in bf16 with the same I/O.
//
// What bounds fused_sepconv on the H100: at the model's shapes (batch 8,
// 46x54, C 128..537, F 128..384) it moves (C + F) * 2 bytes a pixel and
// does 2 * C * F flops of pointwise product plus 18 f32 operations a
// channel-pixel of depthwise taps: ~100 flops a byte, below the bf16 tensor
// cores' ridge (~295), so its bound is the bytes. On the CUDA cores (the
// first version) it was held by the f32 FMA rate; here the pointwise runs
// on the tensor cores, and what holds it is the instruction issue of the
// taps (18 f32 operations a channel-pixel, kept separate for bit-equality),
// of the copies (hence TMA where the layout allows) and of mma.sync at 8-24
// warps an SM (PERF.md).
//
// Design:
// - A block of 8 warps owns a tile of pixels and an F tile of 64, 128 or
//   192 outputs, and loops over the input channels in chunks of 32. F <= 192
//   is one F tile, so the halo is loaded and the taps computed once a pixel;
//   then the tile is 8x8 (two or three blocks an SM). F = 384 is three
//   tiles of 128 on a 128-pixel tile (8x16 or 16x8, whichever pads the image
//   least).
// - Loads are asynchronous: chunk k+1's haloed input tile, its depthwise
//   taps and bias, and its 32 rows of the pointwise weights go to shared
//   memory while chunk k runs its taps and chunk k-1 its products, one
//   barrier a chunk (spans double-, weight tiles triple-, depthwise tiles
//   double-buffered). The tile stays bf16 in shared memory. With C % 8 ==
//   0 one thread loads the spans as three TMA boxes (the haloed tile of the
//   NHWC tensor at (y0 - 1, x0 - 1): the zero fill of out-of-bounds
//   elements is the SAME padding and the channels past C), completing on an
//   mbarrier. C = 537 (pixel rows of 1074 bytes: no TMA, no 16-byte copy
//   of a channel chunk) takes 16-byte cp.async of the five aligned chunks
//   that hold each pixel's 32 channels, from a per-thread copy plan made
//   once a block (a chunk only moves each copy by c0), and one pass moves
//   each span back to its slot's start (a funnel shift by its 0..7
//   elements); SAME padding comes from zero-filled copies, and a channel
//   past C is forced to 0 after the taps, so whatever a chunk brought in
//   from beyond it never reaches the product. The weight rows come by TMA
//   too, as 32 x 64 boxes in the 128-byte swizzle (F % 8 == 0; else element
//   by element).
// - Depthwise: a thread owns two channels of a column segment (8 pixels on
//   a 128-pixel tile, 4 on an 8x8) and slides a 3x3 window down it, f32
//   taps. The rounded, biased, ReLU'd bf16 result goes to a pixels x 32 bf16
//   tile in shared memory (16-byte chunks XOR-swizzled: ldmatrix reads it
//   without bank conflicts).
// - Pointwise on tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32, A from
//   that tile, B from the weight rows (swizzled the same way, ldmatrix
//   .trans). A warp owns 32 pixels x FT/2 (128-pixel tile) or FT/4 (8x8)
//   outputs: 64 f32 accumulators a thread at FT = 128 on 128 pixels, 32 at
//   FT = 128 on 8x8, 48 at FT = 192 on 8x8, kept in registers across all of
//   C. Half the warps multiply first and half run their taps first, so each
//   scheduler has work for both pipes.
// - Epilogue: f32 -> bf16, the bias as a bf16 add, ReLU, staged in shared
//   memory and stored 16 bytes a thread where F % 8 == 0.
// dw3x3_relu runs the same loader and depthwise stage (no bias, f32 ReLU) on
// 128-pixel tiles and stores each chunk from the swizzled tile with 16-byte
// stores.
//
// Numerics follow the reference body: the tap sum is dy-major with each
// product rounded before its add (__fmul_rn/__fadd_rn: no FMA contraction,
// the plain version's `acc + tap * w`); the f32 sum is rounded to bf16 and
// the bias added as a bf16 add, round(f32(a) + f32(b)); ReLU. So the
// depthwise half is bit-identical to the plain version. The pointwise sum
// is exact bf16 products accumulated in f32 in the tensor cores' order,
// rounded to bf16, the bias as a bf16 add, ReLU. Never build with
// --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"   // TMA, mbarriers, tensor-map encoders

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 32;    // input channels per pipeline stage
constexpr int kThreads = 256;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A bf16 + bf16 add as both frameworks compute it: round(f32(a) + f32(b)).
__device__ __forceinline__ float add_bf16(float a, float b) {
  return round_bf16(a + b);
}

// max(v, 0) that keeps a NaN, as jnp.maximum and torch.relu do.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// 16-byte cp.async from global to shared; src_bytes < 16 zero-fills the
// rest (0: nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Element offset of (row, 16-byte chunk) in the 128 x 32 bf16 tile: the
// chunk index XOR (row / 2) % 4, so 8 consecutive rows of one chunk (an
// ldmatrix read) and two rows of four chunks (a depthwise write) fall in
// distinct banks.
__device__ __forceinline__ int tile_at(int row, int chunk) {
  return row * kChunk + ((chunk ^ ((row >> 1) & 3)) << 3);
}

// Element offset of (k, 16-byte chunk) in a kChunk x FT weight tile: FT / 64
// blocks of kChunk rows of 128 bytes, the 16-byte chunk index XOR k % 8 in
// each (TMA's 128-byte swizzle; ldmatrix .trans reads 8 consecutive k of
// one chunk without bank conflicts).
__device__ __forceinline__ int wtile_at(int k, int chunk) {
  return (chunk >> 3) * (kChunk * 64) + k * 64 + (((chunk & 7) ^ (k & 7)) << 3);
}

// Geometry of one block's TH x TW pixel tile (128 or 64 pixels). The
// depthwise threads are 16 channel pairs x 16 column segments of kSegRows
// pixels; the products' 8 warps are kWarpsM (32 pixels each) x kWarpsN.
template <int TH, int TW>
struct Tile {
  static constexpr int kW = TW;
  static constexpr int kPix = TH * TW;
  static constexpr int kHaloW = TW + 2;
  static constexpr int kHalo = (TH + 2) * kHaloW;   // haloed pixels
  static constexpr int kSegRows = kPix / 16;
  static constexpr int kWarpsM = kPix / 32;
  static constexpr int kWarpsN = 8 / kWarpsM;
  static_assert(kPix == 128 || kPix == 64, "128- or 64-pixel tiles");
  static_assert(TW <= 16 && 16 % TW == 0, "whole segments per column");
};

// A "span" is the 32 channels [c0, c0 + 32) of one row of C elements (a
// halo pixel, a depthwise tap, the depthwise bias) in shared memory.
// kShift == false: C % 8 == 0, the spans come as TMA boxes, PS = 32.
// kShift == true: any C; the five 16-byte cp.async chunks that hold the
// span, from the chunk of its first element E, so the span sits at element
// E % 8 of its PS = 40 until realign_spans moves it.
template <bool kShift>
struct Span {
  static constexpr int PS = kShift ? 40 : 32;
};

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// One stage of spans: the haloed tile (span j = hy * (TW + 2) + hx), the 9
// taps right after it, and with kBias the bias; the blocks a TMA load
// fills (C % 8 == 0) start 128-byte aligned.
template <int TH, int TW, bool kShift, bool kBias>
struct SpanStage {
  static constexpr int PS = Span<kShift>::PS;
  static constexpr int kTapsOff = Tile<TH, TW>::kHalo * PS * 2;
  static constexpr int kBiasOff = align128(kTapsOff + 9 * PS * 2);
  static constexpr int kBytes =
      align128(kBias ? kBiasOff + PS * 2 : kBiasOff);
  static_assert(kShift || kTapsOff % 128 == 0, "TMA destinations");
};

// One 16-byte cp.async of every chunk (shifted spans), planned once per
// block: its source at chunk 0, its destination (bytes into a stage
// buffer), and `lim`, which less the chunk's `lim_step` is the elements its
// row still holds from the copy's start (the copy moves min(16, 2 * that)
// bytes, zero-filling the rest). kPadding: a zero-filled copy (SAME
// padding); dst == kNoCopy: none.
struct Copy {
  const bf16* src;
  uint32_t dst;
  int lim;
};
static_assert(sizeof(Copy) == 16, "one 16-byte shared load a copy");
constexpr int kPadding = -(1 << 30);
constexpr uint32_t kNoCopy = 0xffffffffu;

constexpr int per_thread(int copies) {
  return (copies + kThreads - 1) / kThreads;
}

// The copies of a stage's shifted spans (C % 8 != 0): the haloed tile
// (kHalo), the 9 taps, and with kBias the bias; five 16-byte chunks a span.
template <int TH, int TW, bool kBias>
struct SpanPlan {
  static constexpr int kSpans = Tile<TH, TW>::kHalo + 9 + (kBias ? 1 : 0);
  static constexpr int kSpanCopies = 5;
  static constexpr int kCopies = kSpans * kSpanCopies;
  static constexpr int kPerThread = per_thread(kCopies);

  // plan[r * kThreads + tid]: thread tid's r-th copy.
  static __device__ void make(Copy* plan, const bf16* x, const bf16* dwk,
                              const bf16* dwb, long long n_x, int h, int w,
                              int c, int y0, int x0, long long img) {
    using T = Tile<TH, TW>;
    using SS = SpanStage<TH, TW, true, kBias>;
    for (int r = 0; r < kPerThread; ++r) {
      const int i = threadIdx.x + r * kThreads;
      Copy cp{x, kNoCopy, kPadding};
      if (i < kCopies) {
        const int j = i / kSpanCopies, q = i - j * kSpanCopies;
        const bf16* base = x;
        long long e, n = n_x;
        bool in = true;
        if (j < T::kHalo) {
          const int hy = j / T::kHaloW, hx = j - hy * T::kHaloW;
          const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
          in = gy >= 0 && gy < h && gx >= 0 && gx < w;
          e = ((img * h + (in ? gy : 0)) * w + (in ? gx : 0)) * c;
        } else if (j < T::kHalo + 9) {
          base = dwk;
          e = static_cast<long long>(j - T::kHalo) * c;
          n = 9LL * c;
        } else {
          base = dwb;
          e = 0;
          n = c;
        }
        // c0 is a multiple of 32: a chunk moves every copy by c0 elements
        const long long start = (e & ~7LL) + 8 * q;
        const long long lim = n - start;
        cp.src = base + start;
        cp.dst = static_cast<uint32_t>(
            (j < T::kHalo + 9 ? j * SS::PS * 2 : SS::kBiasOff) + 16 * q);
        cp.lim = in ? static_cast<int>(lim < (1 << 30) ? lim : (1 << 30))
                    : kPadding;
      }
      plan[r * kThreads + threadIdx.x] = cp;
    }
  }
};

// Issue this thread's planned copies of one chunk into `stage`: sources
// `src_step` elements on, `lim_step` off the plan's limits.
template <int kPerThread>
__device__ __forceinline__ void issue_copies(const Copy* plan,
                                             unsigned char* stage,
                                             long long src_step,
                                             int lim_step) {
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const Copy cp = plan[r * kThreads + threadIdx.x];
    if (cp.dst == kNoCopy) continue;
    const int rem = cp.lim - lim_step;
    const int bytes = rem >= 8 ? 16 : (rem > 0 ? 2 * rem : 0);
    cp_async16(stage + cp.dst, bytes ? cp.src + src_step : cp.src, bytes);
  }
}

// The packed element shifts (mod 8) of a chunk's spans: bits 0-2 the halo's
// first span's (row 0, column 0), bits 3-5 the step per halo row ((W * C) %
// 8), bits 6-8 the step per halo column and per tap (C % 8); the bias
// span's is 0 (c0 is a multiple of 32).
__device__ __forceinline__ int span_shifts(long long img, int h, int w, int c,
                                           int y0, int x0, int c0) {
  const long long e0 = ((img * h + y0 - 1) * w + x0 - 1) * c + c0;
  return static_cast<int>(e0 & 7) |
         static_cast<int>((static_cast<long long>(w) * c) & 7) << 3 |
         (c & 7) << 6;
}

// Shifted spans (C % 8 != 0) moved in place to the start of their slots, so
// the depthwise stage reads every span aligned: a thread a span, its 17
// words read, funnel-shifted by the span's shift, 16 written back.
template <int TH, int TW, bool kBias>
__device__ __forceinline__ void realign_spans(bf16* spans, int shifts) {
  using T = Tile<TH, TW>;
  constexpr int kSpans = T::kHalo + 9 + (kBias ? 1 : 0);
  constexpr int PS = Span<true>::PS;
  const int s0 = shifts & 7, srow = (shifts >> 3) & 7,
            scol = (shifts >> 6) & 7;
  for (int j = threadIdx.x; j < kSpans; j += kThreads) {
    int sh = 0;
    if (j < T::kHalo) {
      const int hy = j / T::kHaloW, hx = j - hy * T::kHaloW;
      sh = (s0 + hy * srow + hx * scol) & 7;
    } else if (j < T::kHalo + 9) {
      sh = ((j - T::kHalo) * scol) & 7;
    }
    if (sh == 0) continue;
    uint32_t* words = reinterpret_cast<uint32_t*>(spans + j * PS);
    uint32_t v[17], o[16];
#pragma unroll
    for (int m = 0; m < 17; ++m) v[m] = words[(sh >> 1) + m];
#pragma unroll
    for (int m = 0; m < 16; ++m)
      o[m] = (sh & 1) ? __byte_perm(v[m], v[m + 1], 0x5432) : v[m];
#pragma unroll
    for (int m = 0; m < 16; m += 4)
      *reinterpret_cast<uint4*>(words + m) =
          make_uint4(o[m], o[m + 1], o[m + 2], o[m + 3]);
  }
}

// Two channels (cl, cl + 1) of an aligned span, as f32.
__device__ __forceinline__ float2 read_pair(const bf16* s, int cl) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(s + cl));
}

// The depthwise stage of one chunk: thread -> channels 2 * (tid % 16) + {0,
// 1} of the 8-pixel column segment tid / 16, a 3x3 window slid down it.
// Writes the 128 x 32 bf16 tile `a` (swizzled): with kFused relu(bf16(taps)
// + bias) (the fused layer's first half), else relu(taps) rounded once (the
// probe). Channels past C are written as 0. The spans are aligned (kShift:
// after realign_spans).
template <int TH, int TW, bool kShift, bool kFused>
__device__ __forceinline__ void dw_stage(const bf16* spans, bf16* a,
                                         int rem) {
  using T = Tile<TH, TW>;
  using S = Span<kShift>;
  const int cp = threadIdx.x & 15, seg = threadIdx.x >> 4;
  const int col = seg % T::kW, row0 = (seg / T::kW) * T::kSegRows;
  const int cl = 2 * cp;
  const bool va = cl < rem, vb = cl + 1 < rem;
  const bf16* taps = spans + T::kHalo * S::PS;
  float wa[9], wb[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float2 v = read_pair(taps + t * S::PS, cl);
    wa[t] = v.x;
    wb[t] = v.y;
  }
  float ba = 0.0f, bb = 0.0f;
  if (kFused) {
    const float2 v = read_pair(
        spans + SpanStage<TH, TW, kShift, true>::kBiasOff / 2, cl);
    ba = v.x;
    bb = v.y;
  }
  float win[3][3][2] = {};   // [row of the window][dx][channel]
#pragma unroll
  for (int rr = 0; rr < T::kSegRows + 2; ++rr) {
    const int hy = row0 + rr;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        win[dy][dx][0] = win[dy + 1][dx][0];
        win[dy][dx][1] = win[dy + 1][dx][1];
      }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const float2 v =
          read_pair(spans + (hy * T::kHaloW + col + dx) * S::PS, cl);
      win[2][dx][0] = v.x;
      win[2][dx][1] = v.y;
    }
    if (rr >= 2) {
      float acc_a = 0.0f, acc_b = 0.0f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          acc_a = __fadd_rn(acc_a, __fmul_rn(win[dy][dx][0], wa[dy * 3 + dx]));
          acc_b = __fadd_rn(acc_b, __fmul_rn(win[dy][dx][1], wb[dy * 3 + dx]));
        }
      float oa, ob;
      if (kFused) {
        oa = relu(add_bf16(round_bf16(acc_a), ba));
        ob = relu(add_bf16(round_bf16(acc_b), bb));
      } else {
        oa = relu(acc_a);
        ob = relu(acc_b);
      }
      const int p = (row0 + rr - 2) * T::kW + col;
      *reinterpret_cast<__nv_bfloat162*>(a + tile_at(p, cl >> 3) + (cl & 7)) =
          __floats2bfloat162_rn(va ? oa : 0.0f, vb ? ob : 0.0f);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, m16n8k16, bf16 x bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The weight tile of one chunk element by element (F % 8 != 0 or
// unaligned rows): plain loads and stores, visible after the next barrier.
template <int FT>
__device__ __forceinline__ void load_weights_scalar(bf16* wt, const bf16* pwk,
                                                    int c, int f, int c0,
                                                    int f0) {
  for (int i = threadIdx.x; i < kChunk * FT; i += kThreads) {
    const int k = i / FT, fl = i - k * FT;
    const int gc = c0 + k, gf = f0 + fl;
    wt[wtile_at(k, fl >> 3) + (fl & 7)] =
        gc < c && gf < f ? pwk[static_cast<long long>(gc) * f + gf]
                         : __float2bfloat16_rn(0.0f);
  }
}

// The pointwise product of one chunk: warp (wm, wn) adds the 32 pixels
// wm * 32 .. x the FT / kWarpsN outputs from wn * FT / kWarpsN of `a`
// (pixels x 32) times `wt` (32 x FT) into its accumulators.
template <int FT, int kWarpsN>
__device__ __forceinline__ void mma_chunk(
    const bf16* a, const bf16* wt, float (&acc)[2][FT / kWarpsN / 8][4],
    int wm, int wn, int lane) {
  constexpr int kNT = FT / kWarpsN / 8;   // n8 tiles a warp owns
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(af[mt], a + tile_at(wm * 32 + mt * 16 + (lane & 15),
                                      kk * 2 + (lane >> 4)));
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bf[4];
      ldmatrix_x4_trans(
          bf, wt + wtile_at(kk * 16 + (lane & 15),
                                (wn * (FT / kWarpsN) + np * 16) / 8 +
                                    (lane >> 4)));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

constexpr int max_of(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory of fused_sepconv_kernel: three stages of weight
// tiles (1024-byte aligned, for the 128-byte swizzle), two of spans, two
// pixels x 32 depthwise tiles, the span copy plan (kShift; else TMA loads
// the spans), the mbarriers of the span and weight stages; the staged
// output aliases them after the loop.
template <int TH, int TW, int FT, bool kShift>
struct FusedSmem {
  static constexpr int kWeightBytes = kChunk * FT * 2;
  static constexpr int kSpanOff = 3 * kWeightBytes;
  static constexpr int kSpanBytes = SpanStage<TH, TW, kShift, true>::kBytes;
  static constexpr int kTileBytes = Tile<TH, TW>::kPix * kChunk * 2;
  static constexpr int kTileOff = kSpanOff + 2 * kSpanBytes;
  static constexpr int kPlanOff = kTileOff + 2 * kTileBytes;
  static constexpr int kPlanBytes =
      kShift ? SpanPlan<TH, TW, true>::kPerThread * kThreads *
                   static_cast<int>(sizeof(Copy))
             : 0;
  static constexpr int kBarOff = kPlanOff + kPlanBytes;
  static constexpr int kOutStride = FT + 8;   // elements; conflict-free
  static constexpr int kBytes =
      max_of(kBarOff + 5 * 8, Tile<TH, TW>::kPix * kOutStride * 2);
  static_assert(kWeightBytes % 1024 == 0, "swizzle atoms");
};

// The stage's spans as three TMA boxes (C % 8 == 0): the haloed tile of
// image `img` at (y0 - 1, x0 - 1) (SAME padding from the zero fill), the
// taps and the bias, channels [c0, c0 + 32). One thread issues them.
template <int TH, int TW, bool kBias>
__device__ __forceinline__ void tma_spans(unsigned char* stage,
                                          const CUtensorMap* x_map,
                                          const CUtensorMap* dwk_map,
                                          const CUtensorMap* dwb_map, int c0,
                                          int y0, int x0, int img,
                                          uint64_t* bar) {
  using SS = SpanStage<TH, TW, false, kBias>;
  // whole boxes, the out-of-bounds elements as zeros
  bar_arrive(bar, (Tile<TH, TW>::kHalo + 9 + (kBias ? 1 : 0)) * kChunk * 2);
  tma_load(stage, x_map, c0, x0 - 1, y0 - 1, img, bar);
  tma_load(stage + SS::kTapsOff, dwk_map, c0, 0, bar);
  if (kBias) tma_load(stage + SS::kBiasOff, dwb_map, c0, bar);
}

// grid (tiles_y * tiles_x, ceil(F / FT), batch), kThreads threads.
template <int TH, int TW, int FT, bool kShift>
__global__ void __launch_bounds__(
    kThreads, TH * TW * FT / kThreads <= 32 ? 3
              : TH * TW * FT / kThreads <= 64 ? 2 : 1)
fused_sepconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                     const bf16* __restrict__ dwb,
                     const bf16* __restrict__ pwk,
                     const bf16* __restrict__ pwb, bf16* __restrict__ y,
                     int h, int w, int c, int f, int tiles_x, bool vec_w,
                     bool vec_y, const __grid_constant__ CUtensorMap x_map,
                     const __grid_constant__ CUtensorMap dwk_map,
                     const __grid_constant__ CUtensorMap dwb_map,
                     const __grid_constant__ CUtensorMap pwk_map) {
  using T = Tile<TH, TW>;
  using L = FusedSmem<TH, TW, FT, kShift>;
  constexpr int kNT = FT / T::kWarpsN / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % T::kWarpsM, wn = warp / T::kWarpsM;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * T::kW;
  const int f0 = blockIdx.y * FT;
  const long long img = blockIdx.z;
  const long long n_x = static_cast<long long>(gridDim.z) * h * w * c;
  const int n_chunks = (c + kChunk - 1) / kChunk;

  auto spans = [&](int k) {
    return reinterpret_cast<bf16*>(smem + L::kSpanOff +
                                   (k & 1) * L::kSpanBytes);
  };
  auto weights = [&](int k) {
    return reinterpret_cast<bf16*>(smem + (k % 3) * L::kWeightBytes);
  };
  auto tile = [&](int k) {
    return reinterpret_cast<bf16*>(smem + L::kTileOff +
                                   (k & 1) * L::kTileBytes);
  };
  // Thread 0 loads the weight tiles (vec_w) and, with C % 8 == 0, the
  // spans by TMA, completing on each stage's mbarrier (one arrival a
  // phase); with kShift each thread plans its span copies once and reads
  // back only its own entries.
  using SP = SpanPlan<TH, TW, true>;
  Copy* span_plan = reinterpret_cast<Copy*>(smem + L::kPlanOff);
  uint64_t* span_bar = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* weight_bar = span_bar + 2;
  if constexpr (kShift) SP::make(span_plan, x, dwk, dwb, n_x, h, w, c, y0,
                                 x0, img);
  if (tid == 0) {
    for (int i = 0; i < 5; ++i) bar_init(span_bar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  auto issue = [&](int k) {
    const int c0 = k * kChunk;
    if constexpr (kShift) {
      issue_copies<SP::kPerThread>(
          span_plan, smem + L::kSpanOff + (k & 1) * L::kSpanBytes, c0, c0);
      cp_async_commit();
    } else if (tid == 0) {
      tma_spans<TH, TW, true>(smem + L::kSpanOff + (k & 1) * L::kSpanBytes,
                              &x_map, &dwk_map, &dwb_map, c0, y0, x0,
                              static_cast<int>(img), span_bar + (k & 1));
    }
    if (!vec_w) {
      load_weights_scalar<FT>(weights(k), pwk, c, f, c0, f0);
    } else if (tid == 0) {
      // FT / 64 boxes of 32 rows x 64 columns; rows past C and columns past
      // F come in as zeros
      bar_arrive(weight_bar + k % 3, kChunk * FT * 2);
      for (int b = 0; b < FT / 64; ++b)
        tma_load(reinterpret_cast<unsigned char*>(weights(k)) +
                     b * kChunk * 128,
                 &pwk_map, f0 + 64 * b, c0, weight_bar + k % 3);
    }
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  // Step k: chunk k+1's copies go out, chunk k's taps and chunk k-1's
  // products run, one barrier a step. Chunk k+1's spans reuse the buffer of
  // chunk k-1's (its taps ran in step k-1), its weights the third buffer
  // (chunk k-1's are being read), chunk k's depthwise tile the buffer
  // chunk k-2's products read in step k-1. Warps 0-3 multiply first and
  // 4-7 run their taps first, so each scheduler has one warp on the tensor
  // cores while the other is on the f32 pipe.
  const bool mma_first = warp < 4;
  issue(0);
  for (int k = 0; k <= n_chunks; ++k) {
    cp_async_wait_all();   // chunk k has landed (TMA: see below)
    fence_async();         // before the TMA loads after the barrier
    __syncthreads();
    if (k + 1 < n_chunks) issue(k + 1);
    if (!kShift && k < n_chunks) bar_wait(span_bar + (k & 1), (k >> 1) & 1);
    if (vec_w && k > 0) bar_wait(weight_bar + (k - 1) % 3, ((k - 1) / 3) & 1);
    if constexpr (kShift) {
      if (k < n_chunks)
        realign_spans<TH, TW, true>(
            spans(k), span_shifts(img, h, w, c, y0, x0, k * kChunk));
      __syncthreads();
    }
    if (k > 0 && mma_first)
      mma_chunk<FT, T::kWarpsN>(tile(k - 1), weights(k - 1), acc, wm, wn,
                                lane);
    if (k < n_chunks)
      dw_stage<TH, TW, kShift, true>(spans(k), tile(k), c - k * kChunk);
    if (k > 0 && !mma_first)
      mma_chunk<FT, T::kWarpsN>(tile(k - 1), weights(k - 1), acc, wm, wn,
                                lane);
  }
  __syncthreads();   // the staged output aliases the stages

  constexpr int OS = L::kOutStride;
  bf16* out = reinterpret_cast<bf16*>(smem);
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int fl = wn * (FT / T::kWarpsN) + nt * 8 + 2 * (lane & 3);
    const int gf = f0 + fl;
    const float b0 = gf < f ? __bfloat162float(pwb[gf]) : 0.0f;
    const float b1 = gf + 1 < f ? __bfloat162float(pwb[gf + 1]) : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = wm * 32 + mt * 16 + (lane >> 2) + 8 * half;
        *reinterpret_cast<__nv_bfloat162*>(out + p * OS + fl) =
            __floats2bfloat162_rn(
                relu(add_bf16(round_bf16(acc[mt][nt][2 * half]), b0)),
                relu(add_bf16(round_bf16(acc[mt][nt][2 * half + 1]), b1)));
      }
  }
  __syncthreads();
  if (vec_y) {   // 16 bytes a thread
    constexpr int kGran = FT / 8;
    for (int i = tid; i < T::kPix * kGran; i += kThreads) {
      const int p = i / kGran, g = i - p * kGran;
      const int gy = y0 + p / T::kW, gx = x0 + p % T::kW, gf = f0 + 8 * g;
      if (gy < h && gx < w && gf < f)
        *reinterpret_cast<uint4*>(y + ((img * h + gy) * w + gx) * f + gf) =
            *reinterpret_cast<const uint4*>(out + p * OS + 8 * g);
    }
  } else {
    for (int i = tid; i < T::kPix * FT; i += kThreads) {
      const int p = i / FT, fl = i - p * FT;
      const int gy = y0 + p / T::kW, gx = x0 + p % T::kW, gf = f0 + fl;
      if (gy < h && gx < w && gf < f)
        y[((img * h + gy) * w + gx) * f + gf] = out[p * OS + fl];
    }
  }
}

// Dynamic shared memory of dw3x3_relu_kernel: two stages of spans (halo and
// taps), two result tiles, the copy plan (kShift; else TMA loads the spans)
// or the stages' mbarriers.
template <int TH, int TW, bool kShift>
struct ProbeSmem {
  static constexpr int kStage = SpanStage<TH, TW, kShift, false>::kBytes;
  static constexpr int kTileBytes = Tile<TH, TW>::kPix * kChunk * 2;
  static constexpr int kTileOff = 2 * kStage;
  static constexpr int kPlanOff = kTileOff + 2 * kTileBytes;
  static constexpr int kBytes =
      kPlanOff +
      (kShift ? SpanPlan<TH, TW, false>::kPerThread * kThreads *
                    static_cast<int>(sizeof(Copy))
              : 2 * 8);
};

// Probe body 1: relu(f32 tap sum) rounded once to bf16, no bias. A block
// loops over the channel chunks of its 128-pixel tile: in step k chunk
// k+1's copies go out, chunk k's taps run and chunk k-1's result tile is
// stored, one barrier a step.
// grid (tiles_y * tiles_x, 1, batch), kThreads threads.
template <int TH, int TW, bool kShift>
__global__ void __launch_bounds__(kThreads)
dw3x3_relu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                  bf16* __restrict__ y, int h, int w, int c, int tiles_x,
                  bool vec_y, const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap dwk_map) {
  using T = Tile<TH, TW>;
  using L = ProbeSmem<TH, TW, kShift>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * T::kW;
  const long long img = blockIdx.z;
  const long long n_x = static_cast<long long>(gridDim.z) * h * w * c;
  const int n_chunks = (c + kChunk - 1) / kChunk;
  auto spans = [&](int k) {
    return reinterpret_cast<bf16*>(smem + (k & 1) * L::kStage);
  };
  auto tile = [&](int k) {
    return reinterpret_cast<bf16*>(smem + L::kTileOff +
                                   (k & 1) * L::kTileBytes);
  };
  using SP = SpanPlan<TH, TW, false>;
  Copy* plan = reinterpret_cast<Copy*>(smem + L::kPlanOff);
  uint64_t* span_bar = reinterpret_cast<uint64_t*>(smem + L::kPlanOff);
  if constexpr (kShift) {
    SP::make(plan, x, dwk, dwk, n_x, h, w, c, y0, x0, img);
  } else if (tid == 0) {
    bar_init(span_bar, 1);
    bar_init(span_bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  auto issue = [&](int k) {
    if constexpr (kShift) {
      issue_copies<SP::kPerThread>(plan, smem + (k & 1) * L::kStage,
                                   k * kChunk, k * kChunk);
      cp_async_commit();
    } else if (tid == 0) {
      tma_spans<TH, TW, false>(smem + (k & 1) * L::kStage, &x_map, &dwk_map,
                               &dwk_map, k * kChunk, y0, x0,
                               static_cast<int>(img), span_bar + (k & 1));
    }
  };

  issue(0);
  for (int k = 0; k <= n_chunks; ++k) {
    cp_async_wait_all();   // chunk k has landed (TMA: see below)
    fence_async();         // before the TMA loads after the barrier
    __syncthreads();
    if (k + 1 < n_chunks) issue(k + 1);
    if (!kShift && k < n_chunks) bar_wait(span_bar + (k & 1), (k >> 1) & 1);
    if constexpr (kShift) {
      if (k < n_chunks)
        realign_spans<TH, TW, false>(
            spans(k), span_shifts(img, h, w, c, y0, x0, k * kChunk));
      __syncthreads();
    }
    if (k < n_chunks)
      dw_stage<TH, TW, kShift, false>(spans(k), tile(k), c - k * kChunk);
    if (k == 0) continue;
    const bf16* a = tile(k - 1);
    const int c0 = (k - 1) * kChunk;
    if (vec_y) {   // 16 bytes a thread
      for (int i = tid; i < T::kPix * 4; i += kThreads) {
        const int p = i >> 2, g = i & 3;
        const int gy = y0 + p / T::kW, gx = x0 + p % T::kW, gc = c0 + 8 * g;
        if (gy < h && gx < w && gc < c)
          *reinterpret_cast<uint4*>(y + ((img * h + gy) * w + gx) * c + gc) =
              *reinterpret_cast<const uint4*>(a + tile_at(p, g));
      }
    } else {
      for (int i = tid; i < T::kPix * kChunk; i += kThreads) {
        const int p = i / kChunk, cl = i - p * kChunk;
        const int gy = y0 + p / T::kW, gx = x0 + p % T::kW, gc = c0 + cl;
        if (gy < h && gx < w && gc < c)
          y[((img * h + gy) * w + gx) * c + gc] =
              a[tile_at(p, cl >> 3) + (cl & 7)];
      }
    }
  }
}

// Probe body 2: y = x + dwk[0, channel] in bf16, 8 elements a thread with
// 16-byte loads and stores (C % 8 == 0, 16-byte aligned pointers).
__global__ void __launch_bounds__(kThreads)
copy_bias_vec8_kernel(const uint4* __restrict__ x, const bf16* __restrict__ dwk,
                      uint4* __restrict__ y, long long n_vec, int c) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_vec) return;
  uint4 v = x[i];
  bf16* e = reinterpret_cast<bf16*>(&v);
  const int c0 = static_cast<int>((i * 8) % c);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    e[k] = __float2bfloat16_rn(__bfloat162float(e[k]) +
                               __bfloat162float(dwk[c0 + k]));
  y[i] = v;
}

// Probe body 2 for any C: one element a thread.
__global__ void __launch_bounds__(kThreads)
copy_bias_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                 bf16* __restrict__ y, long long n, int c) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  y[i] = __float2bfloat16_rn(__bfloat162float(x[i]) +
                             __bfloat162float(dwk[i % c]));
}

int prologue(int batch, int h, int w, int c, int device) {
  if (batch < 0 || batch > 65535 || h < 1 || w < 1 || c < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaSetDevice(device));
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<std::uintptr_t>(p) % bytes == 0;
}

// Of the 128-pixel tiles, 16x8 (true) or 8x16, whichever pads an h x w image
// to fewer pixels (8x16 on a tie).
bool tall_tile(int h, int w) {
  const long long a8 = ((h + 7) / 8 * 8LL) * ((w + 15) / 16 * 16);
  const long long a16 = ((h + 15) / 16 * 16LL) * ((w + 7) / 8 * 8);
  return a16 < a8;
}

// Output channels a block computes: the whole of F up to 192 (64, 128 or
// 192, the least that covers it), else tiles of 128.
int f_tile(int f) {
  if (f <= 64) return 64;
  if (f <= 128) return 128;
  return f <= 192 ? 192 : 128;
}

struct SepArgs {
  const bf16 *x, *dwk, *dwb, *pwk, *pwb;
  bf16* y;
  int h, w, c, f;
  bool vec_w, vec_y;
};

// A bf16 tensor map of `rank` dimensions (innermost first; the outer ones'
// strides in elements) read in boxes `box`, out-of-bounds elements zero.
int bf16_map(CUtensorMap* map, const void* base, int rank,
             const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box,
             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  cuuint64_t stride_bytes[4];
  for (int i = 0; i + 1 < rank; ++i) stride_bytes[i] = strides[i] * 2;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, stride_bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The tensor maps of fused_sepconv and the probe: for a TH x TW tile (C %
// 8 == 0) x (batch, h, w, c) in boxes of (1, TH + 2, TW + 2, 32),
// dw_kernel (9, c) in (9, 32) and, given, dw_bias (c) in (32); and
// (F % 8 == 0) pw_kernel (c, f) in (32, 64), swizzled.
struct SpanMaps {
  CUtensorMap x, dwk, dwb, pwk;
};

int weight_map(CUtensorMap* map, const bf16* pwk, int c, int f) {
  const cuuint64_t dims[2] = {cuuint64_t(f), cuuint64_t(c)};
  const cuuint64_t stride = f;
  const cuuint32_t box[2] = {64, kChunk};
  return bf16_map(map, pwk, 2, dims, &stride, box,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int TH, int TW>
int span_maps(SpanMaps* m, const bf16* x, const bf16* dwk, const bf16* dwb,
              int batch, int h, int w, int c) {
  const cuuint64_t cc = c;
  const cuuint64_t x_dims[4] = {cc, cuuint64_t(w), cuuint64_t(h),
                                cuuint64_t(batch)};
  const cuuint64_t x_strides[3] = {cc, cc * w, cc * w * h};
  const cuuint32_t x_box[4] = {kChunk, TW + 2, TH + 2, 1};
  int err = bf16_map(&m->x, x, 4, x_dims, x_strides, x_box);
  const cuuint64_t k_dims[2] = {cc, 9};
  const cuuint32_t k_box[2] = {kChunk, 9};
  if (err == 0) err = bf16_map(&m->dwk, dwk, 2, k_dims, &cc, k_box);
  const cuuint32_t b_box[1] = {kChunk};
  if (err == 0 && dwb != nullptr)
    err = bf16_map(&m->dwb, dwb, 1, &cc, nullptr, b_box);
  return err;
}

template <int TH, int TW, int FT, bool kShift>
int launch_fused(const SepArgs& p, int batch, int device, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  const auto kernel = fused_sepconv_kernel<TH, TW, FT, kShift>;
  constexpr int bytes = FusedSmem<TH, TW, FT, kShift>::kBytes;
  int err = set_smem(kernel, bytes, device, done);
  SpanMaps maps{};
  if (err == 0 && !kShift)
    err = span_maps<TH, TW>(&maps, p.x, p.dwk, p.dwb, batch, p.h, p.w, p.c);
  if (err == 0 && p.vec_w) err = weight_map(&maps.pwk, p.pwk, p.c, p.f);
  if (err != 0) return err;
  const int tiles_x = (p.w + Tile<TH, TW>::kW - 1) / Tile<TH, TW>::kW;
  const dim3 grid(((p.h + TH - 1) / TH) * tiles_x, (p.f + FT - 1) / FT,
                  batch);
  kernel<<<grid, kThreads, bytes, st>>>(p.x, p.dwk, p.dwb, p.pwk, p.pwb, p.y,
                                        p.h, p.w, p.c, p.f, tiles_x, p.vec_w,
                                        p.vec_y, maps.x, maps.dwk, maps.dwb,
                                        maps.pwk);
  return static_cast<int>(cudaGetLastError());
}

template <int TH, int TW, int FT>
int launch_fused_shift(const SepArgs& p, bool shift, int batch, int device,
                       cudaStream_t st) {
  return shift ? launch_fused<TH, TW, FT, true>(p, batch, device, st)
              : launch_fused<TH, TW, FT, false>(p, batch, device, st);
}

// The tiles, as measured on the H100 (PERF.md). With one F tile (F
// <= 192) the taps run once a pixel, and an 8x8 tile (twice the blocks of a
// 128-pixel tile, 16-48 accumulators a thread, two or three blocks an SM)
// evens out the SMs' work and hides more latency. With F > 192, 128-wide F
// tiles on a 128-pixel tile: a 192-wide tile holds 96 accumulators a thread
// (~180 registers, one block an SM), and on the 8x8 tile the taps, run once
// for each F tile, weigh more.
int launch_fused_tiles(const SepArgs& p, int ft, bool shift, int batch,
                       int device, cudaStream_t st) {
  if (p.f <= 192) {
    if (ft == 64)
      return launch_fused_shift<8, 8, 64>(p, shift, batch, device, st);
    if (ft == 128)
      return launch_fused_shift<8, 8, 128>(p, shift, batch, device, st);
    return launch_fused_shift<8, 8, 192>(p, shift, batch, device, st);
  }
  return tall_tile(p.h, p.w)
             ? launch_fused_shift<16, 8, 128>(p, shift, batch, device, st)
             : launch_fused_shift<8, 16, 128>(p, shift, batch, device, st);
}

template <int TH, int TW, bool kShift>
int launch_probe(const bf16* x, const bf16* dwk, bf16* y, int batch, int h,
                 int w, int c, bool vec_y, int device, cudaStream_t st) {
  static bool done[kMaxDevices] = {};
  const auto kernel = dw3x3_relu_kernel<TH, TW, kShift>;
  constexpr int bytes = ProbeSmem<TH, TW, kShift>::kBytes;
  int err = set_smem(kernel, bytes, device, done);
  SpanMaps maps{};
  if (err == 0 && !kShift)
    err = span_maps<TH, TW>(&maps, x, dwk, nullptr, batch, h, w, c);
  if (err != 0) return err;
  const int tiles_x = (w + Tile<TH, TW>::kW - 1) / Tile<TH, TW>::kW;
  const dim3 grid(((h + TH - 1) / TH) * tiles_x, 1, batch);
  kernel<<<grid, kThreads, bytes, st>>>(x, dwk, y, h, w, c, tiles_x, vec_y,
                                        maps.x, maps.dwk);
  return static_cast<int>(cudaGetLastError());
}

template <int TH, int TW>
int launch_probe_shift(const bf16* x, const bf16* dwk, bf16* y, int batch,
                       int h, int w, int c, bool shift, bool vec_y,
                       int device, cudaStream_t st) {
  return shift ? launch_probe<TH, TW, true>(x, dwk, y, batch, h, w, c, vec_y,
                                            device, st)
               : launch_probe<TH, TW, false>(x, dwk, y, batch, h, w, c,
                                             vec_y, device, st);
}

}  // namespace

// x (batch, h, w, c), dw_kernel (9, c), dw_bias (c), pw_kernel (c, f),
// pw_bias (f) -> y (batch, h, w, f). All bf16, contiguous; x, dw_kernel and
// dw_bias 16-byte aligned.
extern "C" int fused_sepconv_launch(const void* x, const void* dw_kernel,
                                    const void* dw_bias, const void* pw_kernel,
                                    const void* pw_bias, void* y, int batch,
                                    int h, int w, int c, int f, int device,
                                    void* stream) {
  int err = prologue(batch, h, w, c, device);
  if (err != 0) return err;
  const int ft = f < 1 ? 0 : f_tile(f);
  if (f < 1 || (f + ft - 1) / ft > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned(x, 16) && aligned(dw_kernel, 16) && aligned(dw_bias, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (batch == 0) return 0;
  const SepArgs p{static_cast<const bf16*>(x),
                  static_cast<const bf16*>(dw_kernel),
                  static_cast<const bf16*>(dw_bias),
                  static_cast<const bf16*>(pw_kernel),
                  static_cast<const bf16*>(pw_bias),
                  static_cast<bf16*>(y),
                  h, w, c, f,
                  f % 8 == 0 && aligned(pw_kernel, 16),
                  f % 8 == 0 && aligned(y, 16)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_fused_tiles(p, ft, c % 8 != 0, batch, device, st);
}

// x (batch, h, w, c), dw_kernel (9, c) -> y (batch, h, w, c). bf16; x and
// dw_kernel 16-byte aligned.
extern "C" int dw3x3_relu_launch(const void* x, const void* dw_kernel, void* y,
                                 int batch, int h, int w, int c, int device,
                                 void* stream) {
  int err = prologue(batch, h, w, c, device);
  if (err != 0) return err;
  if (!(aligned(x, 16) && aligned(dw_kernel, 16)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (batch == 0) return 0;
  const bool vec_y = c % 8 == 0 && aligned(y, 16);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* kb = static_cast<const bf16*>(dw_kernel);
  bf16* yb = static_cast<bf16*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shift = c % 8 != 0;
  // the 128-pixel tiles: faster than 8x8 here (PERF.md)
  return tall_tile(h, w)
             ? launch_probe_shift<16, 8>(xb, kb, yb, batch, h, w, c, shift,
                                         vec_y, device, st)
             : launch_probe_shift<8, 16>(xb, kb, yb, batch, h, w, c, shift,
                                         vec_y, device, st);
}

// x (batch, h, w, c), dw_kernel (9, c) -> y = x + dw_kernel[0]. bf16.
extern "C" int copy_bias_launch(const void* x, const void* dw_kernel, void* y,
                                int batch, int h, int w, int c, int device,
                                void* stream) {
  int err = prologue(batch, h, w, c, device);
  if (err != 0) return err;
  if (batch == 0) return 0;
  const long long n = static_cast<long long>(batch) * h * w * c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (reinterpret_cast<std::uintptr_t>(x) |
                    reinterpret_cast<std::uintptr_t>(y)) % 16 == 0;
  if (c % 8 == 0 && vec) {
    const long long n_vec = n / 8;
    const unsigned blocks = static_cast<unsigned>((n_vec + kThreads - 1) / kThreads);
    copy_bias_vec8_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(x), static_cast<const bf16*>(dw_kernel),
        static_cast<uint4*>(y), n_vec, c);
  } else {
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    copy_bias_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(dw_kernel),
        static_cast<bf16*>(y), n, c);
  }
  return static_cast<int>(cudaGetLastError());
}
