// The pieces of a TMA ring that the tiled paths of csrc/dg_rows.cu and
// csrc/dd_rows.cu share: the mbarriers a stage is handed over by, the copies
// that fill it (a row's bulk copy, or a tensor map's box), and the launch's
// per-device facts.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

// The ring's bulk copies (the TMA unit's 1-D form: one instruction copies a
// contiguous row and reports its bytes to an mbarrier in shared memory).
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// the producer's one arrival of a phase, which expects `bytes` of copies
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// one arrival on `bar`
__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of `bar` with this parity has completed
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from device to shared memory, both on 16
// bytes, reported to `bar`
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the box of a 4-D tensor map at (c0, 0, 0, 0) into shared memory (on 128
// bytes), its bytes reported to `bar`
__device__ __forceinline__ void tensor_copy_4d(void* dst,
                                               const CUtensorMap* map, int c0,
                                               unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %3, %3}], [%4];\n"
      ::"r"(smem_addr(dst)), "l"(map), "r"(c0), "r"(0), "r"(smem_addr(bar))
      : "memory");
}

// order this thread's earlier shared-memory accesses before the bulk copies
// it issues next (a stage written by plain stores, then refilled by TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The tiled launch's per-device facts, looked up once: the SM count, and
// each kernel's dynamic shared-memory attribute at the size last set.
constexpr int kMaxDevices = 64;

int sm_count(int device) {
  static int counts[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return 0;
  if (!counts[device]) {
    cudaDeviceGetAttribute(&counts[device], cudaDevAttrMultiProcessorCount,
                           device);
  }
  return counts[device];
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int device, size_t smem) {
  struct Set {
    Kernel kernel;
    int device;
    size_t smem;
  };
  static Set done[4 * kMaxDevices];
  static int ndone = 0;
  int k = 0;
  while (k < ndone && (done[k].kernel != kernel || done[k].device != device)) {
    ++k;
  }
  if (k < ndone && done[k].smem == smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && k < 4 * kMaxDevices) {
    done[k] = {kernel, device, smem};
    ndone = k == ndone ? ndone + 1 : ndone;
  }
  return err;
}

}  // namespace
