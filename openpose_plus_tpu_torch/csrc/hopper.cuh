// Hopper (sm_90a) building blocks shared by the port's kernels: TMA loads
// of tensor-map boxes (tiled and im2col) completing on mbarriers, the
// mbarrier operations, the opt-in to more than 48 KB of dynamic shared
// memory, and the CUDA driver's tensor-map encoders reached through cudart
// (no libcuda link). Included by csrc/sepconv.cu and csrc/int8_conv.cu;
// ops/cuda/build.py hashes it with the sources.
#pragma once

#include <cuda.h>   // CUtensorMap (the encoders are reached through cudart)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TMA loads of one box of a tensor map into shared memory (128-byte aligned),
// completing on mbarrier `bar`; coordinates innermost first, out-of-bounds
// elements zero-filled.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// An im2col TMA load of an NHWC tensor map (cuTensorMapEncodeIm2col): the
// column of pixels that starts at pixel (n, h, w) of the map's bounding box
// and walks it W-, then H-, then N-major, each pixel shifted by (dx, dy)
// (a filter tap) and read as the channels [c, c + channelsPerPixel);
// pixels outside the tensor are zeros.
__device__ __forceinline__ void tma_load_im2col(void* dst,
                                                const CUtensorMap* map, int c,
                                                int w, int h, int n,
                                                uint16_t dx, uint16_t dy,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(c), "r"(w), "r"(h), "r"(n),
      "r"(smem_addr(bar)), "h"(dx), "h"(dy)
      : "memory");
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// This thread's arrival on `bar` for the current phase, announcing `bytes`
// more of the phase's bulk copies (0 if it issued none).
__device__ __forceinline__ void bar_arrive(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// A plain arrival on `bar` (no transaction bytes).
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bar_wait, except that a phase that never completes (a load the hardware
// refused) traps after ~2^26 polls, seconds, instead of hanging the card.
__device__ __forceinline__ void bar_wait_bounded(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

// Orders this thread's earlier shared-memory accesses before the bulk
// copies issued after the next barrier (another proxy writes them).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kMaxDevices = 64;

// Opt a kernel into `bytes` of dynamic shared memory (above 48 KB) once per
// device.
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, int device, bool (&done)[kMaxDevices]) {
  if (bytes <= 48 * 1024 || device < 0 || device >= kMaxDevices ||
      done[device])
    return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err == 0) done[device] = true;
  return err;
}

// A CUDA driver API entry point of the 12.0 ABI, reached through cudart;
// null if the driver lacks it.
template <typename Fn>
Fn driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                       &found) != cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    p = nullptr;
  return reinterpret_cast<Fn>(p);
}

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
using EncodeIm2col = decltype(&cuTensorMapEncodeIm2col);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn =
      driver_entry<EncodeTiled>("cuTensorMapEncodeTiled");
  return fn;
}

EncodeIm2col im2col_map_encoder() {
  static const EncodeIm2col fn =
      driver_entry<EncodeIm2col>("cuTensorMapEncodeIm2col");
  return fn;
}

}  // namespace
