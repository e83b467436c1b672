// The card's tensor-core ceilings (chip_smoke.py --mma-ceiling), timed with
// CUDA events after a warm-up launch, no global memory traffic:
// - mma.sync m16n8k32 s8 and m16n8k16 bf16 when every warp issues 8
//   independent MMAs from registers in a loop; 528 blocks (4 an SM) of 4,
//   8 and 16 warps;
// - wgmma.mma_async m64n128k32 s8 and m64n128k16 bf16 with both operands
//   in shared memory (64-byte rows under the 64-byte swizzle, the int8
//   conv's layout), 4 products a commit group and one group in flight, as
//   csrc/int8_conv.cu issues them; 132 blocks (one an SM) of 1, 2 and 3
//   warpgroups.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

constexpr int kChains = 8;

// the wgmma descriptor of a K-major tile of 64-byte rows, 64-byte swizzle
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a,
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

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// kWG warpgroups, each 4 wgmma a group (two 32-byte K steps of A 64 x 64
// bytes by B 128 x 64 bytes, twice) for `iters` groups, one in flight.
template <bool kS8>
__global__ void __launch_bounds__(384, 1) wgmma_loop(int iters, int* out) {
  __shared__ __align__(1024) uint8_t tiles[(64 + 128) * 64];
  for (int i = threadIdx.x; i < (64 + 128) * 64; i += blockDim.x)
    tiles[i] = static_cast<uint8_t>(i * 7 + 3) & 0x3f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tiles));
  const uint32_t b = a + 64 * 64;
  using Acc = typename std::conditional<kS8, int, float>::type;
  Acc d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t off = (k & 1) * 32;
      if constexpr (kS8)
        wgmma_s8(d, sw64_desc(a + off), sw64_desc(b + off));
      else
        wgmma_bf16(d, sw64_desc(a + off), sw64_desc(b + off));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  Acc s = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) s += d[i];
  if (s == Acc(0x7fff)) out[0] = 1;     // keeps the products alive
}

__global__ void mma_s8_loop(int iters, int* out) {
  int acc[kChains][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = a0 ^ 9, b1 = a0 ^ 11;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]),
            "+r"(acc[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 0x7fffffff) out[0] = s;     // keeps the products alive
}

__global__ void mma_bf16_loop(int iters, int* out) {
  float acc[kChains][4] = {};
  const uint32_t a0 = threadIdx.x, a1 = a0 * 3, a2 = a0 * 5, a3 = a0 * 7;
  const uint32_t b0 = a0 ^ 9, b1 = a0 ^ 11;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 1234.5f) out[0] = 1;
}

int main() {
  int* out;
  cudaMalloc(&out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 20000, blocks = 132 * 4;
  for (int warps : {4, 8, 16}) {
    const double mmas = double(kChains) * iters * blocks * warps;
    float ms;
    mma_s8_loop<<<blocks, 32 * warps>>>(iters, out);
    cudaEventRecord(e0);
    mma_s8_loop<<<blocks, 32 * warps>>>(iters, out);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("mma.sync s8 m16n8k32: %d warps/block x %d blocks: %.1f TOPS\n",
           warps, blocks, 2.0 * 16 * 8 * 32 * mmas / ms / 1e9);
    mma_bf16_loop<<<blocks, 32 * warps>>>(iters, out);
    cudaEventRecord(e0);
    mma_bf16_loop<<<blocks, 32 * warps>>>(iters, out);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("mma.sync bf16 m16n8k16: %d warps/block x %d blocks: %.1f "
           "TFLOPS\n", warps, blocks, 2.0 * 16 * 8 * 16 * mmas / ms / 1e9);
  }
  const int wg_iters = 20000, sms = 132;
  for (int wgs : {1, 2, 3}) {
    const double products = 4.0 * wg_iters * sms * wgs;
    float ms;
    wgmma_loop<true><<<sms, 128 * wgs>>>(wg_iters, out);
    cudaEventRecord(e0);
    wgmma_loop<true><<<sms, 128 * wgs>>>(wg_iters, out);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("wgmma s8 m64n128k32 (shared): %d warpgroups/block x %d blocks: "
           "%.1f TOPS\n", wgs, sms, 2.0 * 64 * 128 * 32 * products / ms / 1e9);
    wgmma_loop<false><<<sms, 128 * wgs>>>(wg_iters, out);
    cudaEventRecord(e0);
    wgmma_loop<false><<<sms, 128 * wgs>>>(wg_iters, out);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
    printf("wgmma bf16 m64n128k16 (shared): %d warpgroups/block x %d blocks: "
           "%.1f TFLOPS\n", wgs, sms,
           2.0 * 64 * 128 * 16 * products / ms / 1e9);
  }
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
