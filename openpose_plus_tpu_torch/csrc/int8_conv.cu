// Calibrated int8 convolution, hand-written for Hopper (sm_90a).
//
// Replaces the XLA int8 convolution of the JAX package's quantized layers
// (`_int8_conv`, openpose_plus_tpu/models/common.py:129: a
// conv_general_dilated of int8 by int8 into int32, then a float rescale,
// bias, ReLU and optional requantization). No Pallas kernel exists for it.
//
// int8_conv_kernel: one conv layer, NHWC, as an implicit GEMM on the int8
// tensor cores. M = B*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin with Cin
// a multiple of 64 (zero channels: quantize_pad_kernel writes its output
// so, the wrapper pads any other input, and the packed weights hold zeros
// there), so each 64-deep stage of K is one
// tap and 64 channels. A block of 128 threads owns a 128x64 tile of the
// output, each warp a 64x32 part of it as 2 x 4x4 `mma.sync.m16n8k32` s8 x
// s8 -> s32 products a stage, the stage's fragments read with `ldmatrix`
// before its products are issued. The tiles come through a 3-deep ring of
// 16-byte `cp.async` copies that allocate in L1, where the taps of
// neighbouring output pixels find the input rows again (zero-filled at the
// image border of SAME padding and at the M and N edges); their sources
// advance by 64 bytes a stage and are recomputed only at a new tap; one
// barrier a stage. Shared
// rows are padded to 80 bytes, so the 8 rows of each `ldmatrix` read hit
// distinct banks.
//
// The epilogue is the reference's, in float32, each operation correctly
// rounded and none contracted into an FMA:
//   y = max(fl(fl(float(acc) * rescale[c]) + bias[c]), 0)
// then either bf16(y), or the int8 requantization at s_out,
//   rint(clip(y / s_out, -1, 1) * 127), with a true division.
// The int32 sums are exact, so the kernel is bit-equal to its plain
// version (ops/cuda/int8_conv.py).
//
// What bounds it on the H100: the products, 2*M*N*K int8 operations at
// 1,979 TOPS, against the bytes (the input, the weights and the output
// read or written once) at 3.35 TB/s, both counted without the channel
// padding; the larger is the bound (chip_smoke.py `int8_bound`). The 3x3
// and 7x7 layers of the zoo's forwards are bound by their operations
// there, the 1x1s and VGG's full-resolution stem by their bytes. This
// kernel takes neither wgmma nor TMA; `mma.sync` alone tops out near two
// thirds of the int8 peak on the card (chip_smoke.py --mma-ceiling), and
// this kernel reaches a fraction of that (PERF.md).
//
// quantize_kernel: bf16 -> int8 at a calibrated per-tensor scale,
// rint(clip(x / max(s, 1e-6), -1, 1) * 127), 8 elements a thread with
// 16-byte loads. Bound by its bytes (2 read and 1 written an element).
// quantize_pad_kernel: the same into rows of cp >= c channels, the last
// cp - c zero: it writes the channel-padded layout that int8_conv_kernel
// reads, so an input of an odd channel count (the image's 3, a pointwise
// input of 24 or 537, a dense stage input of 185) is padded in the pass
// that quantizes it, not by a copy of its own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;       // output pixels a block
constexpr int kBN = 64;        // output channels a block
constexpr int kBK = 64;        // K a stage: two mma k32 steps
constexpr int kRow = 80;       // shared bytes a tile row: 64 + 16 of padding
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kWarpsM = 2;     // warps along M
constexpr int kWarpsN = 2;     // warps along N, each 32 channels
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kMT = kBM / kWarpsM / 16;     // m16 tiles a warp
constexpr int kARows = 2 * kBM / kThreads;  // A rows a thread copies
static_assert(kBN / kWarpsN == 32 && kARows >= 1 && 2 * kBN <= kThreads,
              "tile shape");

struct alignas(128) Tiles {
  int8_t a[kStages][kBM * kRow];
  int8_t b[kStages][kBN * kRow];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously, through L1 (.ca: a conv's
// taps re-read the input rows of neighbouring pixels); zero-filled when
// !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rint(clip(v / s, -1, 1) * 127) as int8; s > 0.
__device__ __forceinline__ int8_t requant(float v, float s) {
  const float t = fminf(fmaxf(__fdiv_rn(v, s), -1.0f), 1.0f);
  return static_cast<int8_t>(rintf(__fmul_rn(t, 127.0f)));
}

// y = max(fl(fl(acc * rescale) + bias), 0), in the reference's order
__device__ __forceinline__ float epilogue(int acc, float rs, float bs) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), rs), bs), 0.0f);
}

// Cin is a multiple of 64 (quantize_pad_kernel or the wrapper pads it), so
// each 64-deep stage of K is one tap (ky, kx) and 64 channels: a thread
// copies 32 contiguous bytes of kARows pixel rows of A and (the first
// 2 * kBN threads) of one weight row of B.
// kQuant: int8 output requantized at *s_out, else bf16.
template <bool kQuant>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
                 const float* __restrict__ rescale,
                 const float* __restrict__ bias,
                 const float* __restrict__ s_out, void* __restrict__ y,
                 int h, int wd, int cin, int cout, int ho, int wo, int ksize,
                 int stride, int pad_top, int pad_left, long long m_total) {
  __shared__ Tiles tiles;
  const int tid = threadIdx.x;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // this thread's copies: A rows r + i * kThreads / 2, B row r, bytes
  // [part, part + 32) of each 64-byte stage
  const int r = tid >> 1;
  const int part = (tid & 1) * 32;
  int iy0[kARows], ix0[kARows];
  const int8_t* img[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long m = m0 + r + kThreads / 2 * i;
    iy0[i] = -(1 << 28);             // out of the image: zero fill
    ix0[i] = 0;
    img[i] = q;
    if (m < m_total) {
      const long long hw = static_cast<long long>(ho) * wo;
      const long long b = m / hw;
      const int pix = static_cast<int>(m - b * hw);
      const int oy = pix / wo, ox = pix - (pix / wo) * wo;
      iy0[i] = oy * stride - pad_top;
      ix0[i] = ox * stride - pad_left;
      img[i] = q + b * h * static_cast<long long>(wd) * cin + part;
    }
  }
  const long long k_total = static_cast<long long>(ksize) * ksize * cin;
  const bool b_copy = r < kBN;          // this thread copies a B row
  const bool n_ok = b_copy && n0 + r < cout;
  const int8_t* w_src = (n_ok ? w + (n0 + r) * k_total : w) + part;
  const int w_step = n_ok ? kBK : 0;

  // the stage being issued: tap (ky, kx) and its rows' sources, which
  // advance by 64 bytes a stage within the tap
  int ky = 0, kx = 0, c0 = 0;
  const int8_t* a_src[kARows];
  bool a_in[kARows];
  auto start_tap = [&]() {
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      a_in[i] = iy >= 0 && iy < h && ix >= 0 && ix < wd;
      a_src[i] = a_in[i]
          ? img[i] + (static_cast<long long>(iy) * wd + ix) * cin : q;
    }
  };
  start_tap();
  long long issued = 0;
  const long long stages_total = k_total / kBK;
  auto issue = [&](int stage) {
    if (issued < stages_total) {
#pragma unroll
      for (int i = 0; i < kARows; ++i) {
        int8_t* dst =
            &tiles.a[stage][(r + kThreads / 2 * i) * kRow + part];
        cp_async16(dst, a_src[i], a_in[i]);
        cp_async16(dst + 16, a_src[i] + 16, a_in[i]);
      }
      if (b_copy) {
        int8_t* dst = &tiles.b[stage][r * kRow + part];
        cp_async16(dst, w_src, n_ok);
        cp_async16(dst + 16, w_src + 16, n_ok);
      }
      w_src += w_step;
      c0 += kBK;
      if (c0 == cin) {
        c0 = 0;
        if (++kx == ksize) {
          kx = 0;
          ++ky;
        }
        start_tap();
      } else {
#pragma unroll
        for (int i = 0; i < kARows; ++i)
          if (a_in[i]) a_src[i] += kBK;
      }
      ++issued;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  int acc[kMT][4][4];         // rows wm * kMT * 16.., cols wn * 32..
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // ldmatrix lane addresses: A rows (lane & 15), byte (lane >> 4) * 16; B
  // rows (lane >> 4) * 8 + (lane & 7), byte ((lane >> 3) & 1) * 16; plus
  // 32 bytes for the stage's second k32 step
  const int a_off =
      (wm * kMT * 16 + (lane & 15)) * kRow + (lane >> 4) * 16;
  const int b_off = (wn * 32 + (lane >> 4) * 8 + (lane & 7)) * kRow +
                    ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (long long s = 0; s < stages_total; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();
    issue(static_cast<int>((s + kStages - 1) % kStages));
    const int8_t* ta = tiles.a[s % kStages];
    const int8_t* tb = tiles.b[s % kStages];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t af[kMT][4], bf[2][4];
      ldmatrix_x4(bf[0], tb + b_off + kk * 32);
      ldmatrix_x4(bf[1], tb + b_off + 16 * kRow + kk * 32);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
        ldmatrix_x4(af[i], ta + a_off + i * 16 * kRow + kk * 32);
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_s8(acc[i][j], af[i], bf[j >> 1][(j & 1) * 2],
                 bf[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // epilogue: rows g and g + 8 of each 16-row tile, columns tq*2, tq*2 + 1
  const int g = lane >> 2, tq = lane & 3;
  const float s_q = kQuant ? fmaxf(*s_out, 1e-6f) : 1.0f;
  const bool pairs = (cout & 1) == 0;   // 2 outputs a store
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = n0 + wn * 32 + j * 8 + tq * 2;
    if (c >= cout) continue;
    const bool two = c + 1 < cout;
    const float rs0 = rescale[c], bs0 = bias[c];
    const float rs1 = two ? rescale[c + 1] : 0.0f;
    const float bs1 = two ? bias[c + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long mo = m0 + (wm * kMT + i) * 16 + g + hh * 8;
        if (mo >= m_total) continue;
        const float v0 = epilogue(acc[i][j][hh * 2], rs0, bs0);
        const float v1 = epilogue(acc[i][j][hh * 2 + 1], rs1, bs1);
        const long long at = mo * cout + c;
        if (kQuant) {
          int8_t* out = static_cast<int8_t*>(y) + at;
          const int8_t q0 = requant(v0, s_q);
          if (pairs && two) {
            const int8_t q1 = requant(v1, s_q);
            *reinterpret_cast<uint16_t*>(out) = static_cast<uint16_t>(
                static_cast<uint8_t>(q0) |
                (static_cast<uint16_t>(static_cast<uint8_t>(q1)) << 8));
          } else {
            out[0] = q0;
            if (two) out[1] = requant(v1, s_q);
          }
        } else {
          __nv_bfloat16* out = static_cast<__nv_bfloat16*>(y) + at;
          if (pairs && two) {
            *reinterpret_cast<__nv_bfloat162*>(out) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            out[0] = __float2bfloat16_rn(v0);
            if (two) out[1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

constexpr int kQuantThreads = 256;

__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ scale, int8_t* __restrict__ out,
                long long n) {
  const float s = fmaxf(*scale, 1e-6f);
  const long long stride =
      static_cast<long long>(gridDim.x) * kQuantThreads * 8;
  for (long long i = (static_cast<long long>(blockIdx.x) * kQuantThreads +
                      threadIdx.x) * 8;
       i < n; i += stride) {
    if (i + 8 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + i);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      uint32_t word[2] = {0, 0};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        word[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                            requant(__bfloat162float(e[j]), s)))
                        << (8 * (j & 3));
      *reinterpret_cast<uint2*>(out + i) = make_uint2(word[0], word[1]);
    } else {
      for (long long j = i; j < n; ++j)
        out[j] = requant(__bfloat162float(x[j]), s);
    }
  }
}

// One thread a 16-channel chunk of an output row: two 16-byte loads where the
// chunk's 16 inputs are in the row and c % 8 == 0, else one at a time; one
// 16-byte store. Index is int where the chunks fit (its division is cheaper).
template <typename Index>
__global__ void __launch_bounds__(kQuantThreads)
quantize_pad_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ scale, int8_t* __restrict__ out,
                    Index rows, Index c, Index cp) {
  const float s = fmaxf(*scale, 1e-6f);
  const Index chunks = cp / 16;
  const Index total = rows * chunks;
  const Index stride = static_cast<Index>(gridDim.x) * kQuantThreads;
  for (Index i = static_cast<Index>(blockIdx.x) * kQuantThreads +
                 static_cast<Index>(threadIdx.x);
       i < total; i += stride) {
    const Index row = i / chunks;
    const Index j = (i - row * chunks) * 16;
    const __nv_bfloat16* src = x + static_cast<long long>(row) * c + j;
    uint32_t word[4] = {0, 0, 0, 0};
    if (c % 8 == 0 && j + 16 <= c) {
      const uint4 v[2] = {*reinterpret_cast<const uint4*>(src),
                          *reinterpret_cast<const uint4*>(src + 8)};
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(v);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        word[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                            requant(__bfloat162float(e[k]), s)))
                        << (8 * (k & 3));
    } else {
      for (int k = 0; k < 16 && j + k < c; ++k)
        word[k >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                            requant(__bfloat162float(src[k]), s)))
                        << (8 * (k & 3));
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(row) * cp + j) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

}  // namespace

// q (batch, h, w, cin) int8 with cin a multiple of 64; w (cout,
// kernel*kernel*cin) int8; rescale, bias (cout,) float32; s_out one float32
// on the device, or null for a bf16 output; y (batch, ho, wo, cout) int8
// or bf16. q and w 16-byte aligned.
extern "C" int int8_conv_launch(const void* q, const void* w,
                                const void* rescale, const void* bias,
                                const void* s_out, void* y, int batch, int h,
                                int wd, int cin, int cout, int ho, int wo,
                                int kernel, int stride, int pad_top,
                                int pad_left, int device, void* stream) {
  if (batch < 0 || h < 1 || wd < 1 || cin < 1 || cin % kBK != 0 ||
      cout < 1 || ho < 1 || wo < 1 || kernel < 1 ||
      (stride != 1 && stride != 2) || pad_top < 0 || pad_left < 0 ||
      cout > 65535 * kBN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long m_total = static_cast<long long>(batch) * ho * wo;
  if (m_total == 0) return 0;
  const dim3 grid(static_cast<unsigned>((m_total + kBM - 1) / kBM),
                  static_cast<unsigned>((cout + kBN - 1) / kBN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* rp = static_cast<const float*>(rescale);
  const auto* bp = static_cast<const float*>(bias);
  const auto* sp = static_cast<const float*>(s_out);
  if (s_out != nullptr)
    int8_conv_kernel<true><<<grid, kThreads, 0, st>>>(
        qp, wp, rp, bp, sp, y, h, wd, cin, cout, ho, wo, kernel, stride,
        pad_top, pad_left, m_total);
  else
    int8_conv_kernel<false><<<grid, kThreads, 0, st>>>(
        qp, wp, rp, bp, sp, y, h, wd, cin, cout, ho, wo, kernel, stride,
        pad_top, pad_left, m_total);
  return static_cast<int>(cudaGetLastError());
}

// x (rows, c) bf16, 16-byte aligned; scale one float32 on the device; out
// (rows, cp) int8, 16-byte aligned, with cp == c or cp a multiple of 16
// above c (its last cp - c channels zero).
extern "C" int quantize_act_launch(const void* x, const void* scale,
                                   void* out, long long rows, long long c,
                                   long long cp, int device, void* stream) {
  if (rows < 0 || c < 1 || cp < c || (cp != c && cp % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const long long threads = cp == c ? (rows * c + 7) / 8 : rows * cp / 16;
  long long blocks = (threads + kQuantThreads - 1) / kQuantThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cp == c)
    quantize_kernel<<<static_cast<unsigned>(blocks), kQuantThreads, 0, st>>>(
        xp, sp, op, rows * c);
  else if (threads + blocks * kQuantThreads < (1LL << 31) &&
           rows * c < (1LL << 31))
    quantize_pad_kernel<int><<<static_cast<unsigned>(blocks), kQuantThreads,
                               0, st>>>(xp, sp, op, static_cast<int>(rows),
                                        static_cast<int>(c),
                                        static_cast<int>(cp));
  else
    quantize_pad_kernel<long long><<<static_cast<unsigned>(blocks),
                                     kQuantThreads, 0, st>>>(xp, sp, op, rows,
                                                             c, cp);
  return static_cast<int>(cudaGetLastError());
}
