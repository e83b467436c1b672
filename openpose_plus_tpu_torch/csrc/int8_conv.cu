// Calibrated int8 convolution, hand-written for Hopper (sm_90a).
//
// Replaces the XLA int8 convolution of the JAX package's quantized layers
// (`_int8_conv`, openpose_plus_tpu/models/common.py:129: a
// conv_general_dilated of int8 by int8 into int32, then a float rescale,
// bias, ReLU and optional requantization) and its input quantization
// (`quantize_act`, common.py:84). No Pallas kernel exists for either.
//
// int8_conv_kernel: one conv layer, NHWC, as an implicit GEMM on the int8
// tensor cores. M = B*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin with Cin
// a multiple of 64 (zero channels: quantize_pad_kernel writes its output
// so, the wrapper pads any other input, and the packed weights hold zeros
// there), so each 64-deep stage of K is one tap (ky, kx) and 64 channels.
// A block owns BM output pixels (consecutive in NHW order, across rows and
// images) by BN output channels: 192 x 128 alone on an SM, or 128 x 64 two
// an SM; the wrapper's `tile_plan` chooses per layer shape
// (ops/cuda/int8_conv.py).
// - Loads: both operands come by TMA, through a ring of up to 8 stages in
//   dynamic shared memory, each with a "full" mbarrier (completed by the
//   copies' bytes) and an "empty" one (one arrival per consumer
//   warpgroup). The activations are an im2col tensor map over the NHWC
//   input: one load a stage brings the tile's BM pixels shifted by the
//   tap, 64 channels each; the map's bounding box (lower corner -pad,
//   upper corner (Wo - 1) * stride - pad - (W - 1), traversal stride =
//   the conv's) makes the hardware walk the output grid, and pixels outside
//   the image (SAME padding) or past the batch come in as zeros. The
//   weights are a 2-D tiled map over the packed (Cout, K) matrix, a box
//   of BN rows by 64 bytes of K (rows past Cout zero). Both land in
//   64-byte rows under the 64-byte swizzle, which the wgmma descriptors
//   name too. No thread computes a load address.
// - Warp roles: warpgroup 0 is the producer (one thread issues the loads;
//   `setmaxnreg` gives its registers to the others), warpgroups 1..BM/64
//   are consumers, each owning 64 rows of the tile: per stage two
//   `wgmma.mma_async` m64nBNk32 s8 x s8 -> s32 with both operands read
//   from shared memory through descriptors, one commit group in flight,
//   the stage released once the group after it is issued and its own has
//   completed. The s32 accumulators (BN / 2 a thread) stay in registers
//   across all of K.
// - Epilogue: each consumer fetches the tile's rescale and bias into
//   shared memory while its first loads fly, writes its 64 x BN result
//   into a padded shared tile, then stores whole 16-byte pieces of rows (a
//   row of a tile with BN = Cout is one contiguous span); rows past M,
//   columns past Cout and rows whose byte count is not a multiple of 16
//   take a masked element path.
//
// The epilogue is the reference's, in float32, each operation correctly
// rounded and none contracted into an FMA:
//   y = max(fl(fl(float(acc) * rescale[c]) + bias[c]), 0)
// then either bf16(y), or the int8 requantization at s_out,
//   rint(clip(y / s_out, -1, 1) * 127), with a true division,
// which `requant_try` reproduces from a multiply by fl(127 / s_out) wherever
// that decides the integer (all but at most about one value in 8,000; the
// rest take the division). The int32 sums are exact, so the kernel is
// bit-equal to its plain version (ops/cuda/int8_conv.py).
//
// What bounds it on the H100: the products, 2*M*N*K int8 operations at
// 1,979 TOPS, against the bytes (the input, the weights and the output
// read or written once) at 3.35 TB/s, both counted without the channel
// padding; the larger is the bound (chip_smoke.py `int8_bound`). The 3x3
// and 7x7 layers of the zoo's forwards are bound by their operations
// there, the 1x1s and VGG's full-resolution stem by their bytes. `wgmma`
// from shared memory is the only way to the int8 peak (chip_smoke.py
// --mma-ceiling measures both instructions); TMA keeps the issue slots
// for it.
//
// quantize_kernel: bf16 -> int8 at a calibrated per-tensor scale,
// rint(clip(x / max(s, 1e-6), -1, 1) * 127), 8 elements a thread with
// 16-byte loads. Bound by its bytes (2 read and 1 written an element).
// quantize_pad_kernel: the same into rows of cp >= c channels, the last
// cp - c zero: it writes the channel-padded layout that int8_conv_kernel
// reads, so an input of an odd channel count (the image's 3, a pointwise
// input of 24 or 537, a dense stage input of 185) is padded in the pass
// that quantizes it, not by a copy of its own. A block owns a run of rows:
// it reads their contiguous rows * c bf16 span in 16-byte loads (only the
// span's unaligned head and tail, and the tensor's last partial piece, are
// masked), quantizes each 8 elements as they arrive into the rows' padded
// places in shared memory, and stores the rows, zero tails included, in
// 16-byte pieces: a row of 537 channels costs the loads of one of 544.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"   // TMA, mbarriers, tensor-map encoders

#ifdef INT8_CONV_PHASES
// Built so only by chip_smoke.py --int8-phases: the clock64 stamps (the
// SM's own counter) of the first kPhaseBlocks blocks of the last launch,
// read back by int8_conv_phases(): [0] the block starts, [1] its barriers
// are set up, [2] the first stage has arrived, [3] the products are done,
// [4] the tile is staged in shared memory, [5] its rows are stored (the
// first consumer warpgroup's thread 0 stamps 2-5).
constexpr int kPhaseBlocks = 4096;
__device__ long long g_phases[kPhaseBlocks][6];
#define INT8_PHASE(i, who)                      \
  if ((who) && blockIdx.x < kPhaseBlocks)       \
  g_phases[blockIdx.x][i] = clock64()
extern "C" int int8_conv_phases(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, g_phases, sizeof(g_phases)));
}
#else
#define INT8_PHASE(i, who)
#endif

namespace {

constexpr int kBK = 64;          // K a stage: one tap, 64 channels
constexpr int kWGRows = 64;      // output pixels a consumer warpgroup owns
constexpr int kSmemSM = 233472;  // shared memory of an SM
constexpr int kMaxStages = 8;

// The shared-memory and register plan of one instance: kWG consumer
// warpgroups (BM = 64 * kWG pixels), BN output channels, int8 (kQuant) or
// bf16 output, kBlocks blocks resident on an SM.
template <int kWG, int kBN, bool kQuant, int kBlocks>
struct Plan {
  static constexpr int kBM = kWGRows * kWG;
  static constexpr int kThreads = 128 * (kWG + 1);
  // each block also holds 1 KB of the SM's shared memory for the system
  static constexpr int kMaxSmem =
      kBlocks == 1 ? 232448 : kSmemSM / kBlocks - 1024;
  static constexpr int kProducerRegs = kBlocks == 1 ? 40 : 24;
  static constexpr int kOutBytes = kQuant ? 1 : 2;
  // the staged output tile: rows padded by 16 bytes, so the 8 rows of a
  // fragment store fall in distinct banks
  static constexpr int kPitch = kBN * kOutBytes + 16;
  static constexpr int kStageA = kBM * kBK;
  static constexpr int kStageB = kBN * kBK;
  static constexpr int kStage = kStageA + kStageB;
  static constexpr int kOut = kBM * kPitch;
  // each consumer warpgroup's copy of the tile's rescale and bias
  static constexpr int kParams = kWG * 2 * kBN * 4;
  static constexpr int kFree = kMaxSmem - 1024 - kOut - kParams -
                               16 * kMaxStages;
  static constexpr int kStages =
      kFree / kStage < kMaxStages ? kFree / kStage : kMaxStages;
  static constexpr int kOutOff = kStages * kStage;
  static constexpr int kParamOff = kOutOff + kOut;
  static constexpr int kBarOff = kParamOff + kParams;
  // + 1024: the ring's base is rounded up to the swizzle's 1024 bytes
  static constexpr int kSmem = 1024 + kBarOff + 16 * kStages;
  // registers: a thread is launched with 65536 / (kThreads * kBlocks)
  // (ptxas takes the launch bounds' most with setmaxnreg), the producer's
  // drop to kProducerRegs and the consumers take what that frees
  static constexpr int kLaunchRegs = 65536 / (kThreads * kBlocks) / 8 * 8;
  static constexpr int kConsumerFree =
      (kLaunchRegs * kThreads - 128 * kProducerRegs) / (128 * kWG) / 8 * 8;
  static constexpr int kConsumerRegs =
      kConsumerFree > 240 ? 240 : kConsumerFree;
  static_assert(kStages >= 4, "ring too shallow");
  static_assert(kStageA % 1024 == 0 && kStageB % 1024 == 0,
                "swizzled stages must stay 1024-byte aligned");
};

// A wgmma shared-memory descriptor of a K-major tile of 64-byte rows under
// the 64-byte swizzle (the TMA maps' CU_TENSOR_MAP_SWIZZLE_64B): start
// address, leading offset 1 (unused by swizzled K-major layouts), stride
// 512 bytes between groups of 8 rows, layout type 2 (64-byte swizzle).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// The 128 threads of one warpgroup meet at named barrier `id` (1..3).
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// Keeps the compiler from moving the accumulators across the asynchronous
// products that read and write them.
template <int kN>
__device__ __forceinline__ void fence_regs(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A (64 x 32, shared) * B (64 x 32, shared)^T, s8 x s8 -> s32, into
// the accumulators of the m64n64k32 fragment (sm_90a).
__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += A (64 x 32, shared) * B (128 x 32, shared)^T, s8 x s8 -> s32, into
// the accumulators of the m64n128k32 fragment (sm_90a).
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                   uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int kBN>
__device__ __forceinline__ void wgmma_tile(int (&d)[kBN / 2], uint64_t a,
                                           uint64_t b) {
  if constexpr (kBN == 128)
    wgmma_n128(d, a, b);
  else
    wgmma_n64(d, a, b);
}

// rint(clip(v / s, -1, 1) * 127) as int8; s > 0.
__device__ __forceinline__ int8_t requant(float v, float s) {
  const float t = fminf(fmaxf(__fdiv_rn(v, s), -1.0f), 1.0f);
  return static_cast<int8_t>(rintf(__fmul_rn(t, 127.0f)));
}

// requant, out of line: the rare values requant_try leaves take it.
__device__ __noinline__ int requant_exact(float v, float s) {
  return requant(v, s);
}

// requant(v, s) without its division, and with no conversion instruction
// (those issue at a quarter of the float rate): r127 = fl(127 / s). The
// int8 result is the low byte of `bits`, unless it returns true: then it
// cannot decide, and the result must come from requant_exact. u =
// fl(v * r127) and the exact path's fl(fl(v / s) * 127) are each within
// two roundings (2^-24 relative each) of 127 v / s, so they differ by less
// than |u| * 2^-21.9; where u is farther than |u| * 2^-21 from a
// half-integer both round to the same integer, clipped or not (|u| >= 127
// rounds to 127 on both paths, NaN to -127 as requant's clip takes it).
// u clipped to [-127, 127] plus 1.5 * 2^23 rounds it to an integer, ties
// to even, whose two's complement low byte is then the sum's. About one
// value in 8,000 lies that near a half-integer where |u| is near 127,
// fewer the smaller |u|. No branch: callers gather the answers in a mask
// and revisit the values it marks after their loop, which so stays one
// scheduling region.
__device__ __forceinline__ bool requant_try(float v, float r127,
                                            uint32_t& bits) {
  constexpr float kMagic = 12582912.0f;           // 1.5 * 2^23
  const float u = fminf(fmaxf(__fmul_rn(v, r127), -127.0f), 127.0f);
  const float m = __fadd_rn(u, kMagic);
  bits = __float_as_uint(m);
  return fabsf(__fadd_rn(u, -__fadd_rn(m, -kMagic))) >=
         __fadd_rn(0.5f, -__fmul_rn(fabsf(u), 0x1p-21f));
}

// requant of 8 values, byte k of the result from f[k]; bit-equal to
// requant.
__device__ __forceinline__ uint64_t requant8(const float (&f)[8], float s,
                                             float r127) {
  uint32_t b[8];
  uint32_t undecided = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (requant_try(f[k], r127, b[k])) undecided |= 1u << k;
  if (undecided != 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (undecided >> k & 1) b[k] = requant_exact(f[k], s);
  }
  return static_cast<uint64_t>(__byte_perm(__byte_perm(b[0], b[1], 0x40),
                                           __byte_perm(b[2], b[3], 0x40),
                                           0x5410)) |
         static_cast<uint64_t>(__byte_perm(__byte_perm(b[4], b[5], 0x40),
                                           __byte_perm(b[6], b[7], 0x40),
                                           0x5410))
             << 32;
}

// y = max(fl(fl(acc * rescale) + bias), 0), in the reference's order
__device__ __forceinline__ float epilogue(int acc, float rs, float bs) {
  return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(acc), rs), bs), 0.0f);
}

// One block: the tile of output pixels [m0, m0 + BM) by channels
// [n0, n0 + BN), tile index blockIdx.x = m_tile * n_tiles + n_tile.
// kQuant: int8 output requantized at *s_out, else bf16.
template <int kWG, int kBN, bool kQuant, int kBlocks>
__global__ void __launch_bounds__(Plan<kWG, kBN, kQuant, kBlocks>::kThreads,
                                  kBlocks)
int8_conv_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map,
                 const float* __restrict__ rescale,
                 const float* __restrict__ bias,
                 const float* __restrict__ s_out, void* __restrict__ y,
                 int cin, int cout, int ho, int wo, int ksize, int stride,
                 int pad_top, int pad_left, long long m_total, int n_tiles,
                 bool vec_out) {
  using P = Plan<kWG, kBN, kQuant, kBlocks>;
  extern __shared__ uint8_t smem_raw[];
  // the ring's base rounded up to 1024 bytes (an offset from the shared
  // array, so the compiler keeps shared-memory instructions)
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::kBarOff);
  uint64_t* empty = full + P::kStages;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const long long m0 = static_cast<long long>(blockIdx.x / n_tiles) * P::kBM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  const int k_stages = ksize * ksize * (cin / kBK);
  INT8_PHASE(0, tid == 0);

  if (tid == 0) {
    // the maps' descriptors on their way to the TMA unit during the set-up
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&a_map) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(&b_map) : "memory");
    for (int s = 0; s < P::kStages; ++s) {
      bar_init(full + s, 1);
      bar_init(empty + s, kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  INT8_PHASE(1, tid == 0);

  if (wg == 0) {
    // ---- producer: one thread walks the taps and channel slices --------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::kProducerRegs));
    if (tid == 0) {
      // the tile's first output pixel (n, oy, ox) and the input pixel its
      // tap (0, 0) reads
      const long long hw = static_cast<long long>(ho) * wo;
      const int n = static_cast<int>(m0 / hw);
      const int pix = static_cast<int>(m0 - n * hw);
      const int oy = pix / wo;
      const int w0 = (pix - oy * wo) * stride - pad_left;
      const int h0 = oy * stride - pad_top;
      int c0 = 0, kx = 0, ky = 0;
      for (int i = 0; i < k_stages; ++i) {
        const int s = i % P::kStages;
        bar_wait_bounded(empty + s, ((i / P::kStages) & 1) ^ 1);
        uint8_t* a = smem + s * P::kStage;
        bar_arrive(full + s, P::kStage);
        tma_load_im2col(a, &a_map, c0, w0, h0, n, static_cast<uint16_t>(kx),
                        static_cast<uint16_t>(ky), full + s);
        tma_load(a + P::kStageA, &b_map, i * kBK, n0, full + s);
        c0 += kBK;
        if (c0 == cin) {
          c0 = 0;
          if (++kx == ksize) {
            kx = 0;
            ++ky;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 * (wg - 1) of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        P::kConsumerRegs));
    const int cw = wg - 1;
    // the epilogue's parameters, fetched while the first loads fly: this
    // warpgroup's copy of rescale and bias over the tile's columns (zero
    // past Cout), and the output scale
    float* params = reinterpret_cast<float*>(smem + P::kParamOff) +
                    cw * 2 * kBN;
    for (int c = tid & 127; c < kBN; c += 128) {
      params[c] = n0 + c < cout ? rescale[n0 + c] : 0.0f;
      params[kBN + c] = n0 + c < cout ? bias[n0 + c] : 0.0f;
    }
    const float s_q = kQuant ? fmaxf(*s_out, 1e-6f) : 1.0f;
    const float r127 = kQuant ? __fdiv_rn(127.0f, s_q) : 1.0f;
    warpgroup_sync(cw + 1);
    int acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < k_stages; ++i) {
      const int s = i % P::kStages;
      bar_wait_bounded(full + s, (i / P::kStages) & 1);
      INT8_PHASE(2, i == 0 && tid == 128);
      const uint32_t a = smem_addr(smem + s * P::kStage + cw * kWGRows * kBK);
      const uint32_t b = smem_addr(smem + s * P::kStage + P::kStageA);
      fence_regs(acc);
      wgmma_fence();
      wgmma_tile<kBN>(acc, sw64_desc(a), sw64_desc(b));
      wgmma_tile<kBN>(acc, sw64_desc(a + 32), sw64_desc(b + 32));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (i > 0 && (tid & 127) == 0)
        bar_arrive(empty + (i - 1) % P::kStages);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    INT8_PHASE(3, tid == 128);

    // ---- epilogue: fragment -> padded shared tile -> 16-byte row pieces
    // fragment: warp w of the warpgroup holds rows 16w + g and 16w + g + 8,
    // columns 8j + 2tq and 8j + 2tq + 1 in acc[4j + {0, 1}] / [4j + {2, 3}]
    const int lane = tid & 31, warp = (tid & 127) >> 5;
    const int g = lane >> 2, tq = lane & 3;
    uint8_t* tile = smem + P::kOutOff + cw * kWGRows * P::kPitch;
    uint64_t undecided = 0;   // int8: values requant_try left, bit 4j+2hh+e
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      const float2 rs = *reinterpret_cast<const float2*>(params + col);
      const float2 bs = *reinterpret_cast<const float2*>(params + kBN + col);
      const float rs0 = rs.x, rs1 = rs.y, bs0 = bs.x, bs1 = bs.y;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        const float v0 = epilogue(acc[4 * j + 2 * hh], rs0, bs0);
        const float v1 = epilogue(acc[4 * j + 2 * hh + 1], rs1, bs1);
        uint8_t* at = tile + row * P::kPitch + col * P::kOutBytes;
        if (kQuant) {
          uint32_t b0, b1;
          if (requant_try(v0, r127, b0)) undecided |= 1ull << (4 * j + 2 * hh);
          if (requant_try(v1, r127, b1))
            undecided |= 1ull << (4 * j + 2 * hh + 1);
          *reinterpret_cast<uint16_t*>(at) =
              static_cast<uint16_t>(__byte_perm(b0, b1, 0x40));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(at) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
    if (kQuant && undecided != 0) {   // at most one thread in 125
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (undecided >> (4 * j + 2 * hh + e) & 1) {
              const int col = 8 * j + 2 * tq + e;
              tile[(16 * warp + g + 8 * hh) * P::kPitch + col] =
                  static_cast<uint8_t>(requant_exact(
                      epilogue(acc[4 * j + 2 * hh + e], params[col],
                               params[kBN + col]),
                      s_q));
            }
    }
    warpgroup_sync(cw + 1);
    INT8_PHASE(4, tid == 128);
    constexpr int kChunks = kBN * P::kOutBytes / 16;   // 16-byte pieces a row
    constexpr int kPer = 16 / P::kOutBytes;            // channels a piece
    const long long row0 = m0 + cw * kWGRows;
    for (int idx = tid & 127; idx < kWGRows * kChunks; idx += 128) {
      const int r = idx / kChunks, ch = idx - (idx / kChunks) * kChunks;
      const long long m = row0 + r;
      const int c = n0 + ch * kPer;
      if (m >= m_total || c >= cout) continue;
      const uint8_t* src = tile + r * P::kPitch + ch * 16;
      uint8_t* dst = static_cast<uint8_t*>(y) +
                     (m * cout + c) * P::kOutBytes;
      if (vec_out && c + kPer <= cout) {
        *reinterpret_cast<uint4*>(dst) =
            *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < kPer && c + e < cout; ++e) {
          if (kQuant)
            dst[e] = src[e];
          else
            reinterpret_cast<uint16_t*>(dst)[e] =
                reinterpret_cast<const uint16_t*>(src)[e];
        }
      }
    }
#ifdef INT8_CONV_PHASES
    warpgroup_sync(cw + 1);
    INT8_PHASE(5, tid == 128);
#endif
  }
}

constexpr int kQuantThreads = 256;
constexpr int kQuantTile = 16384;   // bytes of int8 rows a block stages

__global__ void __launch_bounds__(kQuantThreads)
quantize_kernel(const __nv_bfloat16* __restrict__ x,
                const float* __restrict__ scale, int8_t* __restrict__ out,
                long long n) {
  const float s = fmaxf(*scale, 1e-6f);
  const float r127 = __fdiv_rn(127.0f, s);
  const long long stride =
      static_cast<long long>(gridDim.x) * kQuantThreads * 8;
  for (long long i = (static_cast<long long>(blockIdx.x) * kQuantThreads +
                      threadIdx.x) * 8;
       i < n; i += stride) {
    if (i + 8 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + i);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = __bfloat162float(e[j]);
      *reinterpret_cast<uint64_t*>(out + i) = requant8(f, s, r127);
    } else {
      for (long long j = i; j < n; ++j)
        out[j] = requant(__bfloat162float(x[j]), s);
    }
  }
}

// Bytes [0, keep) of a 16-byte piece kept, the rest zero (keep in 0..16).
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int keep) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = keep - 4 * i;
    w[i] &= k >= 4 ? 0xffffffffu : (k <= 0 ? 0u : (1u << (8 * k)) - 1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A block owns rows [row0, row0 + rows_per) (fewer in the last block) of
// the (rows, c) input, staged as int8 rows of cp bytes in shared memory.
// x and out 16-byte aligned; cp a multiple of 16, rows_per * cp <=
// kQuantTile.
__global__ void __launch_bounds__(kQuantThreads)
quantize_pad_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ scale, int8_t* __restrict__ out,
                    long long rows, int c, int cp, int rows_per) {
  __shared__ __align__(16) uint8_t tile[kQuantTile];
  const float s = fmaxf(*scale, 1e-6f);
  const float r127 = __fdiv_rn(127.0f, s);
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per;
  const int nrows =
      static_cast<int>(rows - row0 < rows_per ? rows - row0 : rows_per);
  const long long e0 = row0 * c;        // the span's first element
  const int span = nrows * c;           // and its length
  const long long total = rows * c;
  // the 8-element pieces that overlap the span, 16 bytes each
  const long long p0 = e0 / 8;
  const long long p1 = (e0 + span + 7) / 8;
  for (long long p = p0 + threadIdx.x; p < p1; p += kQuantThreads) {
    const long long e = p * 8;
    float f[8];                         // the tensor's last piece: 0s
    if (e + 8 <= total) {
      const uint4 v = *reinterpret_cast<const uint4*>(x + e);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) f[k] = __bfloat162float(h[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k)
        f[k] = e + k < total ? __bfloat162float(x[e + k]) : 0.0f;
    }
    const uint64_t q = requant8(f, s, r127);   // byte k from element e + k
    const int rel = static_cast<int>(e - e0);   // -7 .. span - 1
    if (c % 8 == 0 && rel >= 0) {
      // the piece lies in one row, at a multiple of 8 of it
      const int r = rel / c;
      *reinterpret_cast<uint64_t*>(tile + r * cp + (rel - r * c)) = q;
    } else {
      const int first = rel < 0 ? -rel : 0;
      int r = (rel + first) / c;
      int at = rel + first - r * c;
      for (int k = first; k < 8 && rel + k < span; ++k) {
        tile[r * cp + at] = static_cast<uint8_t>(q >> (8 * k));
        if (++at == c) {
          at = 0;
          ++r;
        }
      }
    }
  }
  __syncthreads();
  // the rows are contiguous in out: 16-byte pieces, channels >= c zero
  const int pieces = cp / 16;
  uint4* dst = reinterpret_cast<uint4*>(out + row0 * cp);
  for (int i = threadIdx.x; i < nrows * pieces; i += kQuantThreads) {
    const int col = (i - (i / pieces) * pieces) * 16;
    uint4 v = reinterpret_cast<const uint4*>(tile)[i];
    if (col + 16 > c) v = keep_bytes(v, c - col);
    dst[i] = v;
  }
}

// The tensor maps of one conv: the input q (batch, h, w, cin) as an im2col
// map read in columns of `bm` pixels by 64 channels, the packed weights
// (cout, k_total) as a tiled map read in boxes of `bn` rows by 64 bytes;
// both under the 64-byte swizzle. Returns 0, or the encoder's own CUresult
// (CUDA_ERROR_INVALID_VALUE is cudaErrorInvalidValue's 1).
int conv_maps(CUtensorMap* a_map, CUtensorMap* b_map, const void* q,
              const void* w, int batch, int h, int wd, int cin, int cout,
              int ho, int wo, int kernel, int stride, int pad_top,
              int pad_left, int bm, int bn) {
  const EncodeIm2col im2col = im2col_map_encoder();
  const EncodeTiled tiled = tensor_map_encoder();
  if (im2col == nullptr || tiled == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t c = cin;
  const cuuint64_t a_dims[4] = {c, cuuint64_t(wd), cuuint64_t(h),
                                cuuint64_t(batch)};
  const cuuint64_t a_strides[3] = {c, c * wd, c * wd * h};
  // the bounding box of the column walk: the output grid's first and last
  // tap-(0, 0) input pixels, relative to the image's corners
  const int lower[2] = {-pad_left, -pad_top};
  const int upper[2] = {(wo - 1) * stride - pad_left - (wd - 1),
                        (ho - 1) * stride - pad_top - (h - 1)};
  const cuuint32_t a_steps[4] = {1, cuuint32_t(stride), cuuint32_t(stride),
                                 1};
  CUresult r = im2col(a_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4,
                      const_cast<void*>(q), a_dims, a_strides, lower, upper,
                      kBK, bm, a_steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_64B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  // drivers up to 13.1 mis-handle im2col maps of tensors under 128 KiB
  // unless this bit is cleared (as CUTLASS's make_im2col_tma_copy_desc
  // does)
  int driver = 0;
  if (cudaDriverGetVersion(&driver) == cudaSuccess && driver <= 13010 &&
      c * wd * h * batch < 131072)
    reinterpret_cast<uint64_t*>(a_map)[1] &= ~(1ull << 21);
  const cuuint64_t k_total = static_cast<cuuint64_t>(kernel) * kernel * c;
  const cuuint64_t b_dims[2] = {k_total, cuuint64_t(cout)};
  const cuuint32_t b_box[2] = {kBK, cuuint32_t(bn)};
  const cuuint32_t b_steps[2] = {1, 1};
  r = tiled(b_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
            b_dims, &k_total, b_box, b_steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return static_cast<int>(r);
}

struct ConvArgs {
  const void *q, *w;
  const float *rescale, *bias, *s_out;
  void* y;
  int batch, h, wd, cin, cout, ho, wo, kernel, stride, pad_top, pad_left;
};

template <int kWG, int kBN, bool kQuant, int kBlocks>
int launch_conv(const ConvArgs& p, int device, cudaStream_t st) {
  using P = Plan<kWG, kBN, kQuant, kBlocks>;
  static bool done[kMaxDevices] = {};
  const auto kernel = int8_conv_kernel<kWG, kBN, kQuant, kBlocks>;
  // setmaxnreg moves registers inside the block's launch allotment: a
  // kernel launched with fewer than the consumers take would deadlock
  static const int regs = [kernel] {
    cudaFuncAttributes attr;
    return cudaFuncGetAttributes(&attr, kernel) == cudaSuccess ? attr.numRegs
                                                               : 0;
  }();
  if (regs * P::kThreads < 128 * (P::kProducerRegs + kWG * P::kConsumerRegs))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  int err = set_smem(kernel, P::kSmem, device, done);
  CUtensorMap a_map, b_map;
  if (err == 0)
    err = conv_maps(&a_map, &b_map, p.q, p.w, p.batch, p.h, p.wd, p.cin,
                    p.cout, p.ho, p.wo, p.kernel, p.stride, p.pad_top,
                    p.pad_left, P::kBM, kBN);
  if (err != 0) return err;
  const long long m_total = static_cast<long long>(p.batch) * p.ho * p.wo;
  const long long n_tiles = (p.cout + kBN - 1) / kBN;
  const long long blocks = (m_total + P::kBM - 1) / P::kBM * n_tiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_out =
      (static_cast<long long>(p.cout) * P::kOutBytes) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  kernel<<<static_cast<unsigned>(blocks), P::kThreads, P::kSmem, st>>>(
      a_map, b_map, p.rescale, p.bias, p.s_out, p.y, p.cin, p.cout, p.ho,
      p.wo, p.kernel, p.stride, p.pad_top, p.pad_left, m_total,
      static_cast<int>(n_tiles), vec_out);
  return static_cast<int>(cudaGetLastError());
}

// The tile plans (ops/cuda/int8_conv.py `PLANS`), one instance each and
// output type: 192 x 128 blocks alone on an SM, 128 x 64 blocks two an SM
// (ptxas compiles a kernel within its launch allotment, setmaxnreg or not:
// at two 384-thread blocks an SM, 80 registers, too few for a 64 x 128 s32
// fragment). Any other plan is refused.
template <bool kQuant>
int launch_plan(const ConvArgs& p, int bm, int bn, int device,
                cudaStream_t st) {
  if (bm == 192 && bn == 128)
    return launch_conv<3, 128, kQuant, 1>(p, device, st);
  if (bm == 128 && bn == 64)
    return launch_conv<2, 64, kQuant, 2>(p, device, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (batch, h, w, cin) int8 with cin a multiple of 64; w (cout,
// kernel*kernel*cin) int8; rescale, bias (cout,) float32; s_out one float32
// on the device, or null for a bf16 output; y (batch, ho, wo, cout) int8
// or bf16. q and w 16-byte aligned. (block_m, block_n), the tile plan
// (ops/cuda/int8_conv.py `tile_plan`): (192, 128) or (128, 64).
// The SAME padding's im2col corners must lie in [-128, 127].
extern "C" int int8_conv_launch(const void* q, const void* w,
                                const void* rescale, const void* bias,
                                const void* s_out, void* y, int batch, int h,
                                int wd, int cin, int cout, int ho, int wo,
                                int kernel, int stride, int pad_top,
                                int pad_left, int block_m, int block_n,
                                int device, void* stream) {
  if (batch < 0 || h < 1 || wd < 1 || cin < 1 || cin % kBK != 0 ||
      cout < 1 || ho < 1 || wo < 1 || kernel < 1 || kernel > 7 ||
      (stride != 1 && stride != 2) || pad_top < 0 || pad_left < 0 ||
      pad_top >= kernel || pad_left >= kernel)
    return static_cast<int>(cudaErrorInvalidValue);
  const int up_w = (wo - 1) * stride - pad_left - (wd - 1);
  const int up_h = (ho - 1) * stride - pad_top - (h - 1);
  if (up_w < -128 || up_w > 127 || up_h < -128 || up_h > 127)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return 0;
  const ConvArgs p{q, w, static_cast<const float*>(rescale),
                   static_cast<const float*>(bias),
                   static_cast<const float*>(s_out), y, batch, h, wd, cin,
                   cout, ho, wo, kernel, stride, pad_top, pad_left};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s_out != nullptr
             ? launch_plan<true>(p, block_m, block_n, device, st)
             : launch_plan<false>(p, block_m, block_n, device, st);
}

// x (rows, c) bf16, 16-byte aligned; scale one float32 on the device; out
// (rows, cp) int8, 16-byte aligned, with cp == c or cp a multiple of 16
// above c, at most kQuantTile (its last cp - c channels zero).
extern "C" int quantize_act_launch(const void* x, const void* scale,
                                   void* out, long long rows, long long c,
                                   long long cp, int device, void* stream) {
  if (rows < 0 || c < 1 || cp < c ||
      (cp != c && (cp % 16 != 0 || cp > kQuantTile)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<int8_t*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cp == c) {
    const long long threads = (rows * c + 7) / 8;
    long long blocks = (threads + kQuantThreads - 1) / kQuantThreads;
    if (blocks > 132 * 32) blocks = 132 * 32;
    quantize_kernel<<<static_cast<unsigned>(blocks), kQuantThreads, 0, st>>>(
        xp, sp, op, rows * c);
  } else {
    // rows a block: enough blocks for 8 an SM, no more rows than the
    // staging tile holds
    long long per = (rows + 132 * 8 - 1) / (132 * 8);
    if (per > kQuantTile / cp) per = kQuantTile / cp;
    const long long blocks = (rows + per - 1) / per;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    quantize_pad_kernel<<<static_cast<unsigned>(blocks), kQuantThreads, 0,
                          st>>>(xp, sp, op, rows, static_cast<int>(c),
                                static_cast<int>(cp), static_cast<int>(per));
  }
  return static_cast<int>(cudaGetLastError());
}
