// The card's mma.sync ceiling (chip_smoke.py --mma-ceiling): the
// TOPS of mma.sync m16n8k32 s8 and m16n8k16 bf16 when every warp issues 8
// independent MMAs from registers in a loop, no memory traffic; 528 blocks
// (4 an SM) of 4, 8 and 16 warps, timed with CUDA events after a warm-up
// launch.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kChains = 8;

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
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
