// dd_rows: the fp64 DG row kernel on float32 hi/lo pair storage.
//
// Replaces the TPU kernel feinsum_tpu/ops/dd_emitter.py::build_dd_executable
// (K4): for every planned row (ops/dg_rows.py),
//
//     out[x, i, e] = sum_s F[x, s, e] * sum_j R[s, i, j] * u[s?, j, e]
//
// held to the float64 oracle (1e-12 of max|ref|).  Every operand and the
// output are stored as (2, ...) float32 pairs, hi + lo being the float64
// value (the storage contract of the TPU kernel), and each comes with one
// stride per logical letter plus the stride between its hi and lo planes,
// so any stored permutation works; the dof-major layout (e stride 1) is the
// coalesced one.  F absent means a factor of 1; S = 1 when there is no s
// letter and X = 1 when there is no x letter.
//
// Arithmetic.  The TPU has no FP64 units, so K4 computes in error-free
// float32 pair arithmetic (about 24 float32 operations per multiply-add).
// Hopper has FP64 FMA units: each operand is loaded as (double)hi +
// (double)lo, the row is accumulated with fma in double, and the result is
// stored as hi = rn_f32(acc), lo = rn_f32(acc - hi).
//
// Design (that of dg_rows_f32).  One thread block covers block_long
// consecutive elements; each thread owns one element per pass of kThreads
// elements.  R, as double and zero-padded in i to a multiple of 4, is
// staged once per block in shared memory, laid out [s][j][i] so that two
// broadcast double2 loads feed four i at once; each thread stages its own u
// column [s][j] as double in shared memory (only that thread reads it, so
// no barrier is needed).  For each block of four i the thread keeps
// t[s][k] = sum_j R[s, i0+k, j] * u[s?, j, e] in registers, then writes
// out[x, i, e] = sum_s F[x, s, e] * t[s][k] for every x, so grad computes
// its j-dots once for all three x.
//
// What bounds it on an H100.  A div row at ndof 35 does 2 * 3 * 35 * 35
// flops per element against 584 bytes of pairs (u, J and the output):
// about 13 flop/byte, just right of the FP64 ridge (34 TFLOP/s over
// 3.35 TB/s, about 10 flop/byte); grad, with three outputs, and mass and
// face-mass sit left of it.  So the data-sheet bounds are FP64 FMA issue
// and device-memory bytes, close together.  Per j and four i this design
// issues one u load and two R loads per s for four FMAs per s, so
// shared-memory loads may come to bound it before either; register
// tiling over several elements per thread, or DMMA (the FP64 tensor-core
// mma), is later work.
//
// Restriction rows.  The wave model's face restriction fji,ei->fej, a
// matvec whose resident carries every output letter but e, comes here as a
// row with S = 1, X = 1 and no F: ops/dd_emitter.py merges the output
// letters (f, j) into i as views of the pair tensors (R a (2, 1, F*Pf, P)
// view, the output a (2, 1, F*Pf, E) view of (2, F, Pf, E)), so the kernel
// needs no case of its own.  At ndof 35 and 4 x 15 face dofs, i = 60: R is
// 60 x 35 doubles (16.8 KB) beside the u columns (35.8 KB), 52.6 KB of
// shared memory a block, taken through cudaFuncSetAttribute.
//
// All rows of a batched einsum run in one launch: blockIdx.y is the row,
// and the rows' pointers and strides travel by value (at most kMaxRows).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 4;
constexpr int kMaxS = 4;
constexpr int kMaxX = 4;
constexpr int kIB = 4;         // i per register block (two double2 of R)
constexpr int kThreads = 128;  // threads per block, one element each per pass

struct DDRow {
  const float* u;    // (2, S_u, J, E), S_u = S if u carries s else 1
  const float* R;    // (2, S, I, J)
  const float* F;    // (2, X, S, E), or nullptr: factor 1
  float* out;        // (2, X, I, E)
  long long su_p, su_s, su_j, su_e;
  long long sr_p, sr_s, sr_i, sr_j;
  long long sf_p, sf_x, sf_s, sf_e;
  long long so_p, so_x, so_i, so_e;
};

struct DDRows {
  DDRow row[kMaxRows];
};

__host__ __device__ inline int padded_i(int I) {
  return (I + kIB - 1) / kIB * kIB;
}

__host__ __device__ inline size_t smem_doubles(int S, int I, int J,
                                               bool u_has_s) {
  return static_cast<size_t>(S) * J * padded_i(I) +
         static_cast<size_t>(u_has_s ? S : 1) * J * kThreads;
}

// the float64 value of the pair at offset off: hi + lo
__device__ __forceinline__ double load_pair(const float* p, long long off,
                                            long long plane) {
  return static_cast<double>(p[off]) + static_cast<double>(p[off + plane]);
}

// S is a template parameter, so the s loops are unrolled exactly and no
// predicated-off FMA takes an issue slot (mass has S = 1, div and grad 3).
template <bool kUHasS, int S>
__global__ void __launch_bounds__(kThreads)
dd_rows_kernel(const DDRows rows, const int X, const int I, const int J,
               const long long E, const int block_long) {
  extern __shared__ double2 smem_d2[];
  double* r_sh = reinterpret_cast<double*>(smem_d2);   // [S][J][I4]
  const int I4 = padded_i(I);
  double* u_sh = r_sh + static_cast<size_t>(S) * J * I4;  // [S_u][J][kThreads]
  const DDRow rw = rows.row[blockIdx.y];
  const int tid = threadIdx.x;

  for (int idx = tid; idx < S * J * I4; idx += kThreads) {
    const int i = idx % I4;
    const int sj = idx / I4;
    const int j = sj % J;
    const int s = sj / J;
    r_sh[idx] = i < I ? load_pair(rw.R, s * rw.sr_s + i * rw.sr_i +
                                            j * rw.sr_j, rw.sr_p)
                      : 0.0;
  }
  __syncthreads();

  const int Su = kUHasS ? S : 1;
  const long long e_begin = static_cast<long long>(blockIdx.x) * block_long;
  const long long e_end = min(E, e_begin + block_long);
  for (long long e = e_begin + tid; e < e_end; e += kThreads) {
    for (int s = 0; s < Su; ++s) {
      for (int j = 0; j < J; ++j) {
        u_sh[(s * J + j) * kThreads + tid] = load_pair(
            rw.u, s * rw.su_s + j * rw.su_j + e * rw.su_e, rw.su_p);
      }
    }
    double f[kMaxX][S];
#pragma unroll
    for (int x = 0; x < kMaxX; ++x) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        f[x][s] = 0.0;
        if (x < X) {
          f[x][s] = rw.F ? load_pair(rw.F, x * rw.sf_x + s * rw.sf_s +
                                               e * rw.sf_e, rw.sf_p)
                         : 1.0;
        }
      }
    }

    for (int i0 = 0; i0 < I; i0 += kIB) {
      double t[S][kIB];
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int k = 0; k < kIB; ++k) t[s][k] = 0.0;
      }
#pragma unroll 2
      for (int j = 0; j < J; ++j) {
        const double u0 = u_sh[j * kThreads + tid];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const double uj = kUHasS ? u_sh[(s * J + j) * kThreads + tid] : u0;
          const double* r = &r_sh[(s * J + j) * I4 + i0];
          const double2 ra = *reinterpret_cast<const double2*>(r);
          const double2 rb = *reinterpret_cast<const double2*>(r + 2);
          t[s][0] = fma(ra.x, uj, t[s][0]);
          t[s][1] = fma(ra.y, uj, t[s][1]);
          t[s][2] = fma(rb.x, uj, t[s][2]);
          t[s][3] = fma(rb.y, uj, t[s][3]);
        }
      }
#pragma unroll
      for (int x = 0; x < kMaxX; ++x) {
        if (x < X) {
#pragma unroll
          for (int k = 0; k < kIB; ++k) {
            if (i0 + k < I) {
              double acc = 0.0;
#pragma unroll
              for (int s = 0; s < S; ++s) acc = fma(f[x][s], t[s][k], acc);
              const float hi = __double2float_rn(acc);
              const float lo =
                  __double2float_rn(acc - static_cast<double>(hi));
              const long long o =
                  x * rw.so_x + (i0 + k) * rw.so_i + e * rw.so_e;
              rw.out[o] = hi;
              rw.out[o + rw.so_p] = lo;
            }
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of dd_rows needs, in bytes.
size_t dd_rows_smem_bytes(int S, int I, int J, int u_has_s) {
  return sizeof(double) * smem_doubles(S, I, J, u_has_s != 0);
}

int dd_rows_max_rows() { return kMaxRows; }

// ptrs: nrows x {u, R, F (may be null), out}; strides: nrows x {u: pair, s,
// j, e; R: pair, s, i, j; F: pair, x, s, e; out: pair, x, i, e} in
// elements.  Returns the CUDA error of the launch (0 on success).
int dd_rows(int nrows, void* const* ptrs, const long long* strides, int X,
            int S, int I, int J, long long E, int u_has_s, int block_long,
            void* stream) {
  if (nrows < 1 || nrows > kMaxRows || X < 1 || X > kMaxX || S < 1 ||
      S > kMaxS || I < 1 || J < 1 || E < 1 || block_long < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DDRows rows;
  for (int r = 0; r < nrows; ++r) {
    DDRow& rw = rows.row[r];
    rw.u = static_cast<const float*>(ptrs[4 * r + 0]);
    rw.R = static_cast<const float*>(ptrs[4 * r + 1]);
    rw.F = static_cast<const float*>(ptrs[4 * r + 2]);
    rw.out = static_cast<float*>(ptrs[4 * r + 3]);
    const long long* st = strides + 16 * r;
    rw.su_p = st[0]; rw.su_s = st[1]; rw.su_j = st[2]; rw.su_e = st[3];
    rw.sr_p = st[4]; rw.sr_s = st[5]; rw.sr_i = st[6]; rw.sr_j = st[7];
    rw.sf_p = st[8]; rw.sf_x = st[9]; rw.sf_s = st[10]; rw.sf_e = st[11];
    rw.so_p = st[12]; rw.so_x = st[13]; rw.so_i = st[14]; rw.so_e = st[15];
  }
  const size_t smem = dd_rows_smem_bytes(S, I, J, u_has_s);
  using Kernel = void (*)(const DDRows, int, int, int, long long, int);
  static const Kernel kernels[2][kMaxS] = {
      {dd_rows_kernel<false, 1>, dd_rows_kernel<false, 2>,
       dd_rows_kernel<false, 3>, dd_rows_kernel<false, 4>},
      {dd_rows_kernel<true, 1>, dd_rows_kernel<true, 2>,
       dd_rows_kernel<true, 3>, dd_rows_kernel<true, 4>}};
  const Kernel kernel = kernels[u_has_s ? 1 : 0][S - 1];
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
      rows, X, I, J, E, block_long);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
