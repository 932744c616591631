// dg_rows_f32: the fused DG row kernel.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) on the rows it fuses: for every planned row
// (ops/dg_rows.py),
//
//     out[x, i, e] = sum_s F[x, s, e] * sum_j R[s, i, j] * u[s?, j, e]
//
// with F absent (taken as 1) for matvec, S = 1 when there is no s letter and
// X = 1 when there is no x letter.  Every operand comes with one stride per
// logical letter, so any stored permutation works; the dof-major layout
// (e stride 1) is the coalesced one.
//
// Design.  One thread block covers block_long consecutive elements; each
// thread owns one element per pass of kThreads elements.  R (zero-padded in
// i to a multiple of 4) is staged once per block in shared memory, laid out
// [s][j][i] so that one broadcast float4 load feeds four i at once; each
// thread stages its own u column [s][j] in shared memory (only that thread
// reads it, so no barrier is needed).  For each block of four i the thread
// keeps t[s][k] = sum_j R[s, i0+k, j] * u[s?, j, e] in registers, then
// writes out[x, i, e] = sum_s F[x, s, e] * t[s][k] for every x, so grad
// computes its j-dots once for all three x.  fp32 FMA on the CUDA cores; no
// TF32.
//
// What bounds it on an H100.  A dof-major (35, E) row moves 280 bytes per
// element and does about 2 * 35 * 35 * S flops, so DG rows sit near the
// ridge of the fp32 CUDA-core roofline (about 20 flop/byte).  In this
// simple design the limit is the shared-memory load rate: per j and four i
// it issues 1 + S loads (u and S broadcast float4 of R) for 4 * S FMAs.
// Register tiling over several elements per thread (or tensor-core mma with
// a 3xTF32 split) is later work.
//
// All rows of a batched einsum run in one launch: blockIdx.y is the row,
// and the rows' pointers and strides travel by value (at most kMaxRows).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 4;
constexpr int kMaxS = 4;
constexpr int kMaxX = 4;
constexpr int kIB = 4;         // i per register block (one float4 of R)
constexpr int kThreads = 128;  // threads per block, one element each per pass

struct DGRow {
  const float* u;    // (S_u, J, E), S_u = S if u carries s else 1
  const float* R;    // (S, I, J)
  const float* F;    // (X, S, E), or nullptr: factor 1
  float* out;        // (X, I, E)
  long long su_s, su_j, su_e;
  long long sr_s, sr_i, sr_j;
  long long sf_x, sf_s, sf_e;
  long long so_x, so_i, so_e;
};

struct DGRows {
  DGRow row[kMaxRows];
};

__host__ __device__ inline int padded_i(int I) {
  return (I + kIB - 1) / kIB * kIB;
}

__host__ __device__ inline size_t smem_floats(int S, int I, int J,
                                              bool u_has_s) {
  return static_cast<size_t>(S) * J * padded_i(I) +
         static_cast<size_t>(u_has_s ? S : 1) * J * kThreads;
}

template <bool kUHasS>
__global__ void __launch_bounds__(kThreads)
dg_rows_f32_kernel(const DGRows rows, const int X, const int S, const int I,
                   const int J, const long long E, const int block_long) {
  extern __shared__ float4 smem4[];
  float* r_sh = reinterpret_cast<float*>(smem4);   // [S][J][I4]
  const int I4 = padded_i(I);
  float* u_sh = r_sh + static_cast<size_t>(S) * J * I4;  // [S_u][J][kThreads]
  const DGRow rw = rows.row[blockIdx.y];
  const int tid = threadIdx.x;

  for (int idx = tid; idx < S * J * I4; idx += kThreads) {
    const int i = idx % I4;
    const int sj = idx / I4;
    const int j = sj % J;
    const int s = sj / J;
    r_sh[idx] = i < I ? rw.R[s * rw.sr_s + i * rw.sr_i + j * rw.sr_j] : 0.f;
  }
  __syncthreads();

  const int Su = kUHasS ? S : 1;
  const long long e_begin = static_cast<long long>(blockIdx.x) * block_long;
  const long long e_end = min(E, e_begin + block_long);
  for (long long e = e_begin + tid; e < e_end; e += kThreads) {
    for (int s = 0; s < Su; ++s) {
      for (int j = 0; j < J; ++j) {
        u_sh[(s * J + j) * kThreads + tid] =
            rw.u[s * rw.su_s + j * rw.su_j + e * rw.su_e];
      }
    }
    float f[kMaxX][kMaxS];
#pragma unroll
    for (int x = 0; x < kMaxX; ++x) {
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
        f[x][s] = 0.f;
        if (x < X && s < S) {
          f[x][s] = rw.F ? rw.F[x * rw.sf_x + s * rw.sf_s + e * rw.sf_e]
                         : 1.f;
        }
      }
    }

    for (int i0 = 0; i0 < I; i0 += kIB) {
      float t[kMaxS][kIB];
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
#pragma unroll
        for (int k = 0; k < kIB; ++k) t[s][k] = 0.f;
      }
      for (int j = 0; j < J; ++j) {
        const float u0 = u_sh[j * kThreads + tid];
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          if (s < S) {
            const float uj = kUHasS ? u_sh[(s * J + j) * kThreads + tid] : u0;
            const float4 r =
                *reinterpret_cast<const float4*>(&r_sh[(s * J + j) * I4 + i0]);
            t[s][0] = fmaf(r.x, uj, t[s][0]);
            t[s][1] = fmaf(r.y, uj, t[s][1]);
            t[s][2] = fmaf(r.z, uj, t[s][2]);
            t[s][3] = fmaf(r.w, uj, t[s][3]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < kMaxX; ++x) {
        if (x < X) {
#pragma unroll
          for (int k = 0; k < kIB; ++k) {
            if (i0 + k < I) {
              float acc = 0.f;
#pragma unroll
              for (int s = 0; s < kMaxS; ++s) {
                if (s < S) acc = fmaf(f[x][s], t[s][k], acc);
              }
              rw.out[x * rw.so_x + (i0 + k) * rw.so_i + e * rw.so_e] = acc;
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of dg_rows_f32 needs, in bytes.
size_t dg_rows_f32_smem_bytes(int S, int I, int J, int u_has_s) {
  return sizeof(float) * smem_floats(S, I, J, u_has_s != 0);
}

int dg_rows_f32_max_rows() { return kMaxRows; }

// ptrs: nrows x {u, R, F (may be null), out}; strides: nrows x {u: s, j, e;
// R: s, i, j; F: x, s, e; out: x, i, e} in elements.  Returns the CUDA
// error of the launch (0 on success).
int dg_rows_f32(int nrows, void* const* ptrs, const long long* strides,
                int X, int S, int I, int J, long long E, int u_has_s,
                int block_long, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || X < 1 || X > kMaxX || S < 1 ||
      S > kMaxS || I < 1 || J < 1 || E < 1 || block_long < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DGRows rows;
  for (int r = 0; r < nrows; ++r) {
    DGRow& rw = rows.row[r];
    rw.u = static_cast<const float*>(ptrs[4 * r + 0]);
    rw.R = static_cast<const float*>(ptrs[4 * r + 1]);
    rw.F = static_cast<const float*>(ptrs[4 * r + 2]);
    rw.out = static_cast<float*>(ptrs[4 * r + 3]);
    const long long* st = strides + 12 * r;
    rw.su_s = st[0]; rw.su_j = st[1]; rw.su_e = st[2];
    rw.sr_s = st[3]; rw.sr_i = st[4]; rw.sr_j = st[5];
    rw.sf_x = st[6]; rw.sf_s = st[7]; rw.sf_e = st[8];
    rw.so_x = st[9]; rw.so_i = st[10]; rw.so_e = st[11];
  }
  const size_t smem = dg_rows_f32_smem_bytes(S, I, J, u_has_s);
  void (*kernel)(const DGRows, int, int, int, int, long long, int) =
      u_has_s ? dg_rows_f32_kernel<true> : dg_rows_f32_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      rows, X, S, I, J, E, block_long);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
