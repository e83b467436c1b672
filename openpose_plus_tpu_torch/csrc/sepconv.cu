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
// What bounds fused_sepconv on the H100: at the model's shapes (46x54,
// batch 8, C 192..537, F 128..384) the pointwise product is 2*C*F flops per
// pixel against (C + F) * 2 bytes: ~100 flops a byte, so it is compute
// bound on the CUDA cores this kernel uses (the unfused pair runs the PW on
// tensor cores and round-trips the DW result through device memory). The
// TPU kernel held one whole image per program in VMEM; here a block owns an
// 8x8 pixel tile and 64 output channels, and loops over the input channels
// in chunks of 32: the haloed 10x10 input chunk goes to shared memory, the
// 9 taps run in f32, the DW result stays in shared memory (as the bf16
// value, stored as float), and the PW products accumulate in f32 registers
// (4 pixels x 4 outputs a thread). The DW is recomputed for each 64-channel
// slice of F: 9 MACs against the PW's 64. About 30 KB of static shared
// memory a block, under the 48 KB that needs no opt-in. No tensor cores,
// TMA or pipelining yet.
//
// Numerics follow the reference body: the tap sum is dy-major with each
// product rounded before its add (__fmul_rn/__fadd_rn: no FMA contraction,
// the plain version's `acc + tap * w`); the f32 sum is rounded to bf16 and
// the bias added as a bf16 add, round(f32(a) + f32(b)); ReLU; the same for
// the PW sum. Folding a bias into an f32 sum would give other numbers.
// Never build with --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 8;               // output tile side, pixels
constexpr int kHalo = kTile + 2;       // haloed input tile side
constexpr int kPlane = kHalo * kHalo;  // one channel of the haloed tile
constexpr int kPix = kTile * kTile;    // pixels a block computes
constexpr int kChunk = 32;             // input channels per shared chunk
constexpr int kTileF = 64;             // output channels per block
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

// Zero-padded haloed input tile of channels [c0, c0 + kChunk) around the
// tile at (y0, x0) of one image -> xs[cl][hy][hx] (float). Pixels outside
// the image (SAME padding) and channels past C read as 0. kThreads threads.
__device__ __forceinline__ void load_halo(const bf16* __restrict__ img,
                                          int h, int w, int c, int y0,
                                          int x0, int c0, float* xs) {
  for (int i = threadIdx.x; i < kPlane * kChunk; i += kThreads) {
    const int cl = i % kChunk;   // neighbouring threads: neighbouring channels
    const int pix = i / kChunk;
    const int hy = pix / kHalo, hx = pix % kHalo;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx, gc = c0 + cl;
    float v = 0.0f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w && gc < c)
      v = __bfloat162float(img[(static_cast<long long>(gy) * w + gx) * c + gc]);
    xs[cl * kPlane + hy * kHalo + hx] = v;
  }
}

// Depthwise taps of channels [c0, c0 + kChunk): dwk (9, C) -> ws[tap][cl].
__device__ __forceinline__ void load_taps(const bf16* __restrict__ dwk, int c,
                                          int c0, float* ws) {
  for (int i = threadIdx.x; i < 9 * kChunk; i += kThreads) {
    const int tap = i / kChunk, gc = c0 + i % kChunk;
    ws[i] = gc < c ? __bfloat162float(dwk[tap * c + gc]) : 0.0f;
  }
}

// f32 sum of the 9 taps of pixel p (tile coords) in chunk channel cl,
// dy-major, each product rounded before its add.
__device__ __forceinline__ float dw9(const float* xs, const float* ws, int cl,
                                     int p) {
  const float* plane = xs + cl * kPlane + (p / kTile) * kHalo + p % kTile;
  float acc = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      acc = __fadd_rn(acc, __fmul_rn(plane[dy * kHalo + dx],
                                     ws[(dy * 3 + dx) * kChunk + cl]));
  return acc;
}

// grid (tiles_y * tiles_x, ceil(F / kTileF), batch), kThreads threads.
__global__ void __launch_bounds__(kThreads)
fused_sepconv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                     const bf16* __restrict__ dwb,
                     const bf16* __restrict__ pwk,
                     const bf16* __restrict__ pwb, bf16* __restrict__ y,
                     int h, int w, int c, int f, int tiles_x) {
  __shared__ float xs[kChunk * kPlane];
  __shared__ float ws[9 * kChunk];
  __shared__ float bs[kChunk];
  __shared__ __align__(16) float dws[kChunk * kPix];    // [cl][p]
  __shared__ __align__(16) float pws[kChunk * kTileF];  // [cl][fl]

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int f0 = blockIdx.y * kTileF;
  const long long img = blockIdx.z;
  const bf16* xi = x + img * h * w * c;

  // PW register tile: pixels 4*ty .. 4*ty+3 (half a tile row), outputs
  // f0 + 4*tx .. f0 + 4*tx+3.
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < c; c0 += kChunk) {
    load_halo(xi, h, w, c, y0, x0, c0, xs);
    load_taps(dwk, c, c0, ws);
    if (tid < kChunk)
      bs[tid] = c0 + tid < c ? __bfloat162float(dwb[c0 + tid]) : 0.0f;
    for (int i = tid; i < kChunk * kTileF; i += kThreads) {
      const int gc = c0 + i / kTileF, gf = f0 + i % kTileF;
      pws[i] = gc < c && gf < f
                   ? __bfloat162float(pwk[static_cast<long long>(gc) * f + gf])
                   : 0.0f;
    }
    __syncthreads();

    // DW: thread -> pixel tid % 64, channels tid / 64 + 4 j. A channel
    // past C gives relu(0 + 0) = 0 and meets a zero PW weight.
    {
      const int p = tid % kPix;
      for (int cl = tid / kPix; cl < kChunk; cl += kThreads / kPix)
        dws[cl * kPix + p] =
            relu(add_bf16(round_bf16(dw9(xs, ws, cl, p)), bs[cl]));
    }
    __syncthreads();

    // PW: in f32 registers, input channels in order.
#pragma unroll 8
    for (int cl = 0; cl < kChunk; ++cl) {
      const float4 a = *reinterpret_cast<const float4*>(dws + cl * kPix + 4 * ty);
      const float4 b =
          *reinterpret_cast<const float4*>(pws + cl * kTileF + 4 * tx);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float bias[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gf = f0 + 4 * tx + j;
    bias[j] = gf < f ? __bfloat162float(pwb[gf]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = 4 * ty + i;
    const int gy = y0 + p / kTile, gx = x0 + p % kTile;
    if (gy >= h || gx >= w) continue;
    bf16* out = y + ((img * h + gy) * w + gx) * f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gf = f0 + 4 * tx + j;
      if (gf < f)
        out[gf] = __float2bfloat16_rn(
            relu(add_bf16(round_bf16(acc[i][j]), bias[j])));
    }
  }
}

// Probe body 1: relu(f32 tap sum) rounded once to bf16, no bias.
// grid (tiles_y * tiles_x, ceil(C / kChunk), batch), kThreads threads.
__global__ void __launch_bounds__(kThreads)
dw3x3_relu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                  bf16* __restrict__ y, int h, int w, int c, int tiles_x) {
  __shared__ float xs[kChunk * kPlane];
  __shared__ float ws[9 * kChunk];
  __shared__ float out[kPix * (kChunk + 1)];   // [p][cl], padded row

  const int tid = threadIdx.x;
  const int y0 = (blockIdx.x / tiles_x) * kTile;
  const int x0 = (blockIdx.x % tiles_x) * kTile;
  const int c0 = blockIdx.y * kChunk;
  const long long img = blockIdx.z;
  load_halo(x + img * h * w * c, h, w, c, y0, x0, c0, xs);
  load_taps(dwk, c, c0, ws);
  __syncthreads();
  {
    const int p = tid % kPix;
    for (int cl = tid / kPix; cl < kChunk; cl += kThreads / kPix)
      out[p * (kChunk + 1) + cl] = relu(dw9(xs, ws, cl, p));
  }
  __syncthreads();
  // Store with neighbouring threads on neighbouring channels.
  for (int i = tid; i < kPix * kChunk; i += kThreads) {
    const int cl = i % kChunk, p = i / kChunk;
    const int gy = y0 + p / kTile, gx = x0 + p % kTile, gc = c0 + cl;
    if (gy < h && gx < w && gc < c)
      y[((img * h + gy) * w + gx) * c + gc] =
          __float2bfloat16_rn(out[p * (kChunk + 1) + cl]);
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

}  // namespace

// x (batch, h, w, c), dw_kernel (9, c), dw_bias (c), pw_kernel (c, f),
// pw_bias (f) -> y (batch, h, w, f). All bf16, contiguous.
extern "C" int fused_sepconv_launch(const void* x, const void* dw_kernel,
                                    const void* dw_bias, const void* pw_kernel,
                                    const void* pw_bias, void* y, int batch,
                                    int h, int w, int c, int f, int device,
                                    void* stream) {
  int err = prologue(batch, h, w, c, device);
  if (err != 0) return err;
  if (f < 1 || (f + kTileF - 1) / kTileF > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int tiles_x = (w + kTile - 1) / kTile;
  const dim3 grid(((h + kTile - 1) / kTile) * tiles_x,
                  (f + kTileF - 1) / kTileF, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_sepconv_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dw_kernel),
      static_cast<const bf16*>(dw_bias), static_cast<const bf16*>(pw_kernel),
      static_cast<const bf16*>(pw_bias), static_cast<bf16*>(y), h, w, c, f,
      tiles_x);
  return static_cast<int>(cudaGetLastError());
}

// x (batch, h, w, c), dw_kernel (9, c) -> y (batch, h, w, c). bf16.
extern "C" int dw3x3_relu_launch(const void* x, const void* dw_kernel, void* y,
                                 int batch, int h, int w, int c, int device,
                                 void* stream) {
  int err = prologue(batch, h, w, c, device);
  if (err != 0) return err;
  if (batch == 0) return 0;
  const int tiles_x = (w + kTile - 1) / kTile;
  const dim3 grid(((h + kTile - 1) / kTile) * tiles_x,
                  (c + kChunk - 1) / kChunk, batch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dw3x3_relu_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dw_kernel),
      static_cast<bf16*>(y), h, w, c, tiles_x);
  return static_cast<int>(cudaGetLastError());
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
  const bool aligned = (reinterpret_cast<std::uintptr_t>(x) |
                        reinterpret_cast<std::uintptr_t>(y)) % 16 == 0;
  if (c % 8 == 0 && aligned) {
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
