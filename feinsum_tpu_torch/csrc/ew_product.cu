// ew_product_f32: the contraction-free rows of a batched einsum.
//
// Replaces two TPU kernels on their contraction-free rows: out = prod of the
// row's operands, elementwise, over operands that share the output's stored
// layout, so every row is a flat array of n floats.
//
// * feinsum_tpu/ops/pallas_emitter.py::build_pallas_executable (K1) on the
//   suite's copy row (ij,ij->ij with i the element axis): a grid-stride
//   loop over at most 2**20 blocks (block_long = 0 here);
// * feinsum_tpu/ops/pallas_emitter.py::_try_build_flat_elementwise (K3),
//   the flatten route of 1-D operands: block b covers the block_long
//   consecutive elements [b * block_long, (b + 1) * block_long), so the
//   tuner's block length sets the launch.
//
// What bounds it on an H100: bytes.  Each element reads nops floats and
// writes one, with nops - 1 multiplies, so the only lever is streaming at
// the HBM rate.  Each thread moves 16 bytes per operand per step (float4)
// when every pointer is 16-byte aligned and n (and block_long) % 4 == 0,
// else 4 bytes; all rows go in one launch (blockIdx.y is the row).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 4;
constexpr int kMaxOps = 8;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

struct EwRow {
  const float* in[kMaxOps];
  float* out;
};

struct EwRows {
  EwRow row[kMaxRows];
};

// This thread's first index, end and step over [0, n): the per-block range
// [b * per_block, (b + 1) * per_block) when per_block > 0, else a grid-stride
// loop over all of it.
struct Range {
  long long first, end, step;
};

__device__ inline Range thread_range(long long n, long long per_block) {
  if (per_block > 0) {
    const long long b = static_cast<long long>(blockIdx.x) * per_block;
    return {b + threadIdx.x, min(n, b + per_block), kThreads};
  }
  return {static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x, n,
          static_cast<long long>(gridDim.x) * kThreads};
}

__global__ void __launch_bounds__(kThreads)
ew_product_f32_vec4(const EwRows rows, const int nops, const long long n4,
                    const long long per_block4) {
  const EwRow rw = rows.row[blockIdx.y];
  const Range r = thread_range(n4, per_block4);
  for (long long k = r.first; k < r.end; k += r.step) {
    float4 acc = reinterpret_cast<const float4*>(rw.in[0])[k];
#pragma unroll
    for (int o = 1; o < kMaxOps; ++o) {
      if (o < nops) {
        const float4 v = reinterpret_cast<const float4*>(rw.in[o])[k];
        acc.x *= v.x;
        acc.y *= v.y;
        acc.z *= v.z;
        acc.w *= v.w;
      }
    }
    reinterpret_cast<float4*>(rw.out)[k] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
ew_product_f32_scalar(const EwRows rows, const int nops, const long long n,
                      const long long per_block) {
  const EwRow rw = rows.row[blockIdx.y];
  const Range r = thread_range(n, per_block);
  for (long long k = r.first; k < r.end; k += r.step) {
    float acc = rw.in[0][k];
#pragma unroll
    for (int o = 1; o < kMaxOps; ++o) {
      if (o < nops) acc *= rw.in[o][k];
    }
    rw.out[k] = acc;
  }
}

}  // namespace

extern "C" {

int ew_product_f32_max_rows() { return kMaxRows; }

int ew_product_f32_max_ops() { return kMaxOps; }

// ins: nrows x nops input pointers; outs: nrows output pointers; n floats
// per operand; block_long elements per thread block, or 0 for the
// grid-stride loop.  Returns the CUDA error of the launch (0 on success).
int ew_product_f32(int nrows, int nops, void* const* ins, void* const* outs,
                   long long n, long long block_long, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || nops < 1 || nops > kMaxOps || n < 1 ||
      block_long < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  EwRows rows;
  bool aligned = n % 4 == 0 && block_long % 4 == 0;
  for (int r = 0; r < nrows; ++r) {
    for (int o = 0; o < nops; ++o) {
      rows.row[r].in[o] = static_cast<const float*>(ins[r * nops + o]);
      aligned = aligned && reinterpret_cast<uintptr_t>(ins[r * nops + o]) %
                               16 == 0;
    }
    for (int o = nops; o < kMaxOps; ++o) rows.row[r].in[o] = nullptr;
    rows.row[r].out = static_cast<float*>(outs[r]);
    aligned = aligned && reinterpret_cast<uintptr_t>(outs[r]) % 16 == 0;
  }
  const long long work = aligned ? n / 4 : n;
  const long long per_block = aligned ? block_long / 4 : block_long;
  long long nblocks;
  if (per_block > 0) {
    nblocks = (work + per_block - 1) / per_block;
    if (nblocks > 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    nblocks = (work + kThreads - 1) / kThreads;
    if (nblocks > kMaxBlocks) nblocks = kMaxBlocks;
  }
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned) {
    ew_product_f32_vec4<<<grid, kThreads, 0, s>>>(rows, nops, work,
                                                 per_block);
  } else {
    ew_product_f32_scalar<<<grid, kThreads, 0, s>>>(rows, nops, work,
                                                   per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
