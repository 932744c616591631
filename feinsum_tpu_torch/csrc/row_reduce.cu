// row_reduce_f32: the DG rows with no i output axis.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) on the rows whose output is the long axis
// alone (the extended suite's vecmat, ej,j->e, and rowsum, ej->e): for every
// planned row (ops/dg_rows.py::plan_reduce_row),
//
//     out[e] = sum_j w[j] * u[e, j]
//
// with w absent (taken as 1) for rowsum.  It is a kernel of its own rather
// than a variant of dg_rows_f32: with no i axis and no resident matrix R,
// nothing of dg_rows_f32's shared-memory R staging is left, and each
// element's J products sum to one value instead of I.
//
// What bounds it on an H100: bytes.  A row reads 4 * J bytes per element and
// writes 4, with J multiply-adds, so at J = 35 it needs 0.25 flop per byte,
// far below the fp32 ridge (about 20).  The design streams u once:
//
// * w lives in shared memory (J floats per block, loaded once);
// * one thread owns one element per pass of kThreads elements, and a block
//   covers block_long consecutive elements;
// * u's stored strides decide the load order.  Dof-major (J, E), e at
//   stride 1: each thread walks j, and at each j a warp reads 32 consecutive
//   floats (coalesced).  Element-major (E, J), j at stride 1: a pass's
//   kThreads * J floats are one contiguous range, so the block copies it
//   into shared memory with consecutive threads on consecutive addresses,
//   then each thread sums its element's J values from there (rows padded to
//   an odd length, so the 32 threads of a warp hit 32 banks).  Other
//   strides, or a tile over 48 KB, take the per-thread walk.
//
// All rows of a batched einsum run in one launch: blockIdx.y is the row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 4;
constexpr int kThreads = 128;  // threads per block, one element each per pass
constexpr size_t kMaxStaticSmem = 48 * 1024;
constexpr int kMaxJ = 8192;    // w in shared memory: 32 KB

struct ReduceRow {
  const float* u;  // (E, J) through its strides
  const float* w;  // (J,) contiguous, or nullptr: weight 1
  float* out;      // (E,) contiguous
  long long su_e, su_j;
};

struct ReduceRows {
  ReduceRow row[kMaxRows];
};

__host__ __device__ inline int odd_pitch(int J) { return J | 1; }

__device__ inline void load_w(const ReduceRow& rw, int J, float* w_sh) {
  for (int j = threadIdx.x; j < J; j += kThreads) {
    w_sh[j] = rw.w ? rw.w[j] : 1.f;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
row_reduce_strided(const ReduceRows rows, const int J, const long long E,
                   const int block_long) {
  extern __shared__ float w_sh[];
  const ReduceRow rw = rows.row[blockIdx.y];
  load_w(rw, J, w_sh);
  const long long e_begin = static_cast<long long>(blockIdx.x) * block_long;
  const long long e_end = min(E, e_begin + block_long);
  for (long long e = e_begin + threadIdx.x; e < e_end; e += kThreads) {
    const float* p = rw.u + e * rw.su_e;
    float acc0 = 0.f, acc1 = 0.f;
    int j = 0;
    for (; j + 1 < J; j += 2) {
      acc0 = fmaf(w_sh[j], p[j * rw.su_j], acc0);
      acc1 = fmaf(w_sh[j + 1], p[(j + 1) * rw.su_j], acc1);
    }
    if (j < J) acc0 = fmaf(w_sh[j], p[j * rw.su_j], acc0);
    rw.out[e] = acc0 + acc1;
  }
}

// u element-major and dense: row e's J values at u + e * J.
__global__ void __launch_bounds__(kThreads)
row_reduce_staged(const ReduceRows rows, const int J, const long long E,
                  const int block_long) {
  extern __shared__ float smem[];
  float* w_sh = smem;                 // [J]
  float* tile = smem + odd_pitch(J);  // [kThreads][odd_pitch(J)]
  const int pitch = odd_pitch(J);
  const ReduceRow rw = rows.row[blockIdx.y];
  load_w(rw, J, w_sh);
  const long long e_begin = static_cast<long long>(blockIdx.x) * block_long;
  const long long e_end = min(E, e_begin + block_long);
  for (long long base = e_begin; base < e_end; base += kThreads) {
    const int n = static_cast<int>(min(static_cast<long long>(kThreads),
                                       e_end - base));
    const float* src = rw.u + base * J;
    for (int k = threadIdx.x; k < n * J; k += kThreads) {
      tile[(k / J) * pitch + k % J] = src[k];
    }
    __syncthreads();
    if (threadIdx.x < n) {
      const float* v = tile + threadIdx.x * pitch;
      float acc0 = 0.f, acc1 = 0.f;
      int j = 0;
      for (; j + 1 < J; j += 2) {
        acc0 = fmaf(w_sh[j], v[j], acc0);
        acc1 = fmaf(w_sh[j + 1], v[j + 1], acc1);
      }
      if (j < J) acc0 = fmaf(w_sh[j], v[j], acc0);
      rw.out[base + threadIdx.x] = acc0 + acc1;
    }
    __syncthreads();
  }
}

size_t staged_smem_bytes(int J) {
  return sizeof(float) * (static_cast<size_t>(odd_pitch(J)) +
                          static_cast<size_t>(kThreads) * odd_pitch(J));
}

}  // namespace

extern "C" {

int row_reduce_f32_max_rows() { return kMaxRows; }

int row_reduce_f32_max_j() { return kMaxJ; }

// Whether a launch with these u strides takes the staged element-major path.
int row_reduce_f32_staged(int J, long long su_e, long long su_j) {
  return su_j == 1 && su_e == J && staged_smem_bytes(J) <= kMaxStaticSmem;
}

// ptrs: nrows x {u, w (may be null), out}; strides: nrows x {u: e, j} in
// elements.  Returns the CUDA error of the launch (0 on success).
int row_reduce_f32(int nrows, void* const* ptrs, const long long* strides,
                   int J, long long E, int block_long, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || J < 1 || J > kMaxJ || E < 1 ||
      block_long < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ReduceRows rows;
  bool staged = true;
  for (int r = 0; r < nrows; ++r) {
    ReduceRow& rw = rows.row[r];
    rw.u = static_cast<const float*>(ptrs[3 * r + 0]);
    rw.w = static_cast<const float*>(ptrs[3 * r + 1]);
    rw.out = static_cast<float*>(ptrs[3 * r + 2]);
    rw.su_e = strides[2 * r + 0];
    rw.su_j = strides[2 * r + 1];
    staged = staged && row_reduce_f32_staged(J, rw.su_e, rw.su_j);
  }
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (staged) {
    row_reduce_staged<<<grid, kThreads, staged_smem_bytes(J), s>>>(
        rows, J, E, block_long);
  } else {
    row_reduce_strided<<<grid, kThreads, sizeof(float) * J, s>>>(
        rows, J, E, block_long);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
