// dg_rows_3xtf32: the fused DG row kernel on Hopper's tensor cores, its
// j-dot in three TF32 passes over an f32 hi/lo split.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) on the rows it fuses when the schedule's
// precision is "bf16_3x".  There each in-kernel dot runs
// feinsum_tpu/ops/kernel_lowering.py::_dot_bf16_3x: an f32 product as three
// bf16 MXU passes, hi*hi + hi*lo + lo*hi.  Here the same algorithm runs on
// TF32 tensor cores (10 explicit mantissa bits instead of bf16's 7): each
// f32 operand x splits into hi = tf32(x) and lo = tf32(x - hi), where tf32()
// rounds to nearest with ties away from zero on the bit pattern, the
// rounding of cvt.rna.tf32.f32, and leaves the low 13 bits zero.  A product
// of two TF32 values is exact in f32, so the split loses only lo*lo and lo's
// own rounding: about 2**-21 of each product.  For every planned row
// (ops/dg_rows.py),
//
//     out[x, i, e] = sum_s F[x, s, e] * t[s, i, e],
//     t[s, i, e]   = sum_j R[s, i, j] * u[s?, j, e]   (the 3xTF32 j-dot)
//
// with F absent (taken as 1) for matvec; the sum over s and the product by F
// run in f32 on the CUDA cores, as the reference keeps its VPU work in f32.
//
// Design.  The j-dot of each s is a GEMM with M = e, N = i and K = j:
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, three per k-step and
// n tile (lo*hi, hi*lo, hi*hi, the small terms first), each pass over all n
// tiles of a chunk before the next, so that consecutive products are
// independent and a warp does not wait out each one's latency.  They
// accumulate into fresh fragments that are then added to the running sums
// in IEEE f32: the tensor cores' accumulate truncates, and carried over a
// whole K it would drift by ulps of the sum per k-step.  R is split once per block
// into shared memory, i and j padded to multiples of 8 with zero hi and
// lo, laid out so that one 16-byte load gives a thread its B fragment's hi
// and lo (conflict-free: rows n and n + 1 fall in opposite bank halves).
// Then each of the block's 4 warps walks its own tiles of 16 consecutive
// elements (one m16 tile; the warps' tiles interleave over the block's
// block_long elements) with no block-wide barrier: cp.async copies the next
// tile's u [s?][j][e] and F [x][s][e] into the warp's second buffer while it
// computes on the first (rows of 16 elements along e: coalesced in the
// dof-major layout, e stride 1; ragged edges and padded j zero-filled).  A
// fragments are read from the buffer and split as they are read.  i runs in
// chunks of 5 n tiles (40 values), so a thread holds at most X * 5 * 4 sums
// and 5 * 4 partial dots.  The warp's outputs go back through its own
// shared tile and are written 16 consecutive elements per row (an m16n8
// fragment holds 2 e x 2 i per thread, so direct stores would scatter).
//
// What bounds it on an H100.  At 3 TF32 passes the tensor cores give about
// 165 TFLOP/s of f32 (495 / 3), so a dof-major (35, E) row (i and j padded to
// 40) needs about 0.06 ms of tensor-core time per row at E = 1M against
// 0.08 ms of bytes: the row is bound by device memory, where dg_rows_f32 is
// bound by f32 FMA.  mma.sync fed from shared memory with the split done per
// fragment, at two blocks of 4 warps per SM for the suite's rows, stays
// well under both; wgmma, TMA and persistent blocks are later work.
//
// All rows of a batched einsum run in one launch: blockIdx.y is the row,
// and the rows' pointers and strides travel by value (at most kMaxRows).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 4;
constexpr int kMaxS = 4;
constexpr int kMaxX = 4;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTE = 16;           // elements per warp tile: one m16 tile
constexpr int kNC = 5;            // n tiles (8 values of i) per register chunk
constexpr int kUP = kTE + 8;      // u tile pitch: conflict-free A fragments
constexpr int kOP = kTE + 4;      // output tile pitch: conflict-free stores

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

__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

// R's row pitch in floats: 16 per k tile (hi and lo of 8 values of j), and
// 16 more when the k tiles are even in number, so that consecutive rows
// start in opposite halves of the 32 banks
__host__ __device__ inline int r_pitch(int J) {
  const int kt = pad8(J) / 8;
  return 16 * kt + (kt % 2 == 0 ? 16 : 0);
}

// a warp's shared memory: two u tiles and two F tiles (double-buffered)
// and its output tile
__host__ __device__ inline size_t warp_floats(int X, int S, int I, int J,
                                              bool u_has_s) {
  return 2 * static_cast<size_t>(u_has_s ? S : 1) * pad8(J) * kUP +
         2 * static_cast<size_t>(X) * S * kTE +
         static_cast<size_t>(X) * pad8(I) * kOP;
}

__host__ __device__ inline size_t smem_floats(int X, int S, int I, int J,
                                              bool u_has_s) {
  return static_cast<size_t>(S) * pad8(I) * r_pitch(J) +
         kWarps * warp_floats(X, S, I, J, u_has_s);
}

// one float from device to shared memory, asynchronously (cp.async); a
// false `valid` writes a zero and reads nothing
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32: to nearest, ties away from zero, on the bit pattern
// (cvt.rna.tf32.f32's rounding); the low 13 bits of the result are zero.
// Infinities and NaN pass unchanged.
__device__ __forceinline__ float tf32_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

// d += a * b: one m16n8k8 TF32 product on the tensor cores, f32 accumulate
// (not volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const float (&a)[4],
                                         float b0, float b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

template <int kX, bool kUHasS>
__global__ void __launch_bounds__(kThreads)
dg_rows_3xtf32_kernel(const DGRows rows, const int S, const int I,
                      const int J, const long long E, const int block_long) {
  extern __shared__ float4 smem4[];
  const int NP = pad8(I);
  const int KP = pad8(J);
  const int NT = NP / 8;
  const int KT = KP / 8;
  const int RP = r_pitch(J);
  const int Su = kUHasS ? S : 1;
  const DGRow rw = rows.row[blockIdx.y];
  const bool has_f = rw.F != nullptr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;     // the thread in the group
  const int half = lane >> 4;   // staging: the row of a pair
  const int el = lane & 15;     // staging: the element of a row
  const size_t u_floats = static_cast<size_t>(Su) * KP * kUP;
  const size_t f_floats = static_cast<size_t>(kX) * S * kTE;
  float* r_sh = reinterpret_cast<float*>(smem4);          // [S][NP][RP]
  float* w_sh = r_sh + static_cast<size_t>(S) * NP * RP +
                warp * warp_floats(kX, S, I, J, kUHasS);
  float* o_sh = w_sh + 2 * u_floats + 2 * f_floats;        // [kX][NP][kOP]

  // R split into hi and lo once per block.  Per row n and k tile, the 16
  // floats hold for each tig: hi(j = tig), hi(tig + 4), lo(tig), lo(tig + 4).
  // A thread loads kBatch values before it splits any, so that their loads
  // are in flight together
  {
    constexpr int kBatch = 8;
    const int total = S * NP * KP;
    for (int base = tid; base < total; base += kBatch * kThreads) {
      float v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const int idx = base + q * kThreads;
        const int k = idx % KP;
        const int n = (idx / KP) % NP;
        const int s = idx / (KP * NP);
        dst[q] = (s * NP + n) * RP + (k / 8) * 16 + (k % 4) * 4 + (k % 8) / 4;
        v[q] = idx < total && n < I && k < J
                   ? rw.R[s * rw.sr_s + n * rw.sr_i + k * rw.sr_j]
                   : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (base + q * kThreads < total) {
          const float hi = tf32_round(v[q]);
          r_sh[dst[q]] = hi;
          r_sh[dst[q] + 2] = tf32_round(v[q] - hi);
        }
      }
    }
  }
  __syncthreads();

  const bool out_e_fast = rw.so_e <= rw.so_i;
  const long long e_begin = static_cast<long long>(blockIdx.x) * block_long;
  const long long e_end = min(E, e_begin + block_long);
  // the u and F of the tile at e0 into buffer `buf`, rows of 16 elements,
  // two rows per warp instruction; zeros past e_end and for padded j
  auto stage = [&](int buf, long long e0) {
    const bool in = e0 + el < e_end;
    float* us = w_sh + buf * u_floats;
    for (int s = 0; s < Su; ++s) {
      for (int j = half; j < KP; j += 2) {
        const bool valid = in && j < J;
        copy_async(us + (s * KP + j) * kUP + el,
                   valid ? rw.u + s * rw.su_s + j * rw.su_j +
                               (e0 + el) * rw.su_e
                         : rw.u,
                   valid);
      }
    }
    if (has_f) {
      float* fs = w_sh + 2 * u_floats + buf * f_floats;
      for (int x = 0; x < kX; ++x) {
        for (int s = half; s < S; s += 2) {
          copy_async(fs + (x * S + s) * kTE + el,
                     in ? rw.F + x * rw.sf_x + s * rw.sf_s +
                              (e0 + el) * rw.sf_e
                        : rw.F,
                     in);
        }
      }
    }
  };

  const long long step = static_cast<long long>(kWarps) * kTE;
  long long e0 = e_begin + warp * kTE;
  if (e0 < e_end) stage(0, e0);
  copy_commit();
  for (int buf = 0; e0 < e_end; e0 += step, buf ^= 1) {
    // every lane commits one group per tile, empty past the end, so that
    // the group counts stay uniform
    if (e0 + step < e_end) stage(buf ^ 1, e0 + step);
    copy_commit();
    copy_wait<1>();   // this lane's copies of the tile at e0 landed
    __syncwarp();     // and every lane's
    const float* ub = w_sh + buf * u_floats;
    const float* fb_sh = w_sh + 2 * u_floats + buf * f_floats;
    for (int nc = 0; nc < NT; nc += kNC) {
      float o[kX][kNC][4];
#pragma unroll
      for (int x = 0; x < kX; ++x) {
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
#pragma unroll
          for (int q = 0; q < 4; ++q) o[x][c][q] = 0.f;
        }
      }
      for (int s = 0; s < S; ++s) {
        const float* us = ub + static_cast<size_t>(kUHasS ? s : 0) * KP * kUP;
        const float* rs = r_sh + static_cast<size_t>(s) * NP * RP;
        float t[kNC][4];
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
#pragma unroll
          for (int q = 0; q < 4; ++q) t[c][q] = 0.f;
        }
        for (int kt = 0; kt < KT; ++kt) {
          // A fragment (e x j): (gid, tig), (gid + 8, tig), (gid, tig + 4),
          // (gid + 8, tig + 4)
          const float* ua = us + (kt * 8 + tig) * kUP + gid;
          const float a[4] = {ua[0], ua[8], ua[4 * kUP], ua[4 * kUP + 8]};
          float ahi[4], alo[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            ahi[q] = tf32_round(a[q]);
            alo[q] = tf32_round(a[q] - ahi[q]);
          }
          // B fragments (j x i): (tig, gid), (tig + 4, gid), hi and lo
          float4 b[kNC];
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            b[c] = nc + c < NT
                       ? *reinterpret_cast<const float4*>(
                             rs + static_cast<size_t>((nc + c) * 8 + gid) *
                                      RP + kt * 16 + tig * 4)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
          // lo*hi, hi*lo, hi*hi (the small terms first) into fresh
          // fragments, each pass over every n tile before the next, so
          // that consecutive products are independent; then added in f32
          float d[kNC][4];
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
#pragma unroll
            for (int q = 0; q < 4; ++q) d[c][q] = 0.f;
          }
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            if (nc + c < NT) mma_tf32(d[c], alo, b[c].x, b[c].y);
          }
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            if (nc + c < NT) mma_tf32(d[c], ahi, b[c].z, b[c].w);
          }
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            if (nc + c < NT) mma_tf32(d[c], ahi, b[c].x, b[c].y);
          }
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
#pragma unroll
            for (int q = 0; q < 4; ++q) t[c][q] += d[c][q];
          }
        }
        // sum_s F t in f32; C fragment rows gid (q = 0, 1), gid + 8 (2, 3)
#pragma unroll
        for (int x = 0; x < kX; ++x) {
          const float fa = has_f ? fb_sh[(x * S + s) * kTE + gid] : 1.f;
          const float fb = has_f ? fb_sh[(x * S + s) * kTE + gid + 8] : 1.f;
#pragma unroll
          for (int c = 0; c < kNC; ++c) {
            o[x][c][0] = fmaf(fa, t[c][0], o[x][c][0]);
            o[x][c][1] = fmaf(fa, t[c][1], o[x][c][1]);
            o[x][c][2] = fmaf(fb, t[c][2], o[x][c][2]);
            o[x][c][3] = fmaf(fb, t[c][3], o[x][c][3]);
          }
        }
      }
      // C fragment (e x i): (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, ...)
#pragma unroll
      for (int x = 0; x < kX; ++x) {
#pragma unroll
        for (int c = 0; c < kNC; ++c) {
          if (nc + c < NT) {
            const int n = (nc + c) * 8 + 2 * tig;
            float* dst = o_sh + (static_cast<size_t>(x) * NP + n) * kOP + gid;
            dst[0] = o[x][c][0];
            dst[kOP] = o[x][c][1];
            dst[8] = o[x][c][2];
            dst[kOP + 8] = o[x][c][3];
          }
        }
      }
    }
    __syncwarp();
    const int ne = static_cast<int>(min(static_cast<long long>(kTE),
                                        e_end - e0));
    if (out_e_fast) {
      // 16 consecutive elements per row, two rows per warp instruction
      for (int x = 0; x < kX; ++x) {
        for (int i = half; i < I; i += 2) {
          if (el < ne) {
            rw.out[x * rw.so_x + i * rw.so_i + (e0 + el) * rw.so_e] =
                o_sh[(static_cast<size_t>(x) * NP + i) * kOP + el];
          }
        }
      }
    } else {
      for (int idx = lane; idx < kX * I * kTE; idx += 32) {
        const int i = idx % I;
        const int e = (idx / I) % kTE;
        const int x = idx / (I * kTE);
        if (e < ne) {
          rw.out[x * rw.so_x + i * rw.so_i + (e0 + e) * rw.so_e] =
              o_sh[(static_cast<size_t>(x) * NP + i) * kOP + e];
        }
      }
    }
    __syncwarp();     // the output tile and this buffer are free again
  }
  copy_wait<0>();
}

template <int kX, bool kUHasS>
int launch(const DGRows& rows, int nrows, int S, int I, int J, long long E,
           int block_long, size_t smem, cudaStream_t stream) {
  void (*kernel)(const DGRows, int, int, int, long long, int) =
      dg_rows_3xtf32_kernel<kX, kUHasS>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  kernel<<<grid, kThreads, smem, stream>>>(rows, S, I, J, E, block_long);
  return static_cast<int>(cudaGetLastError());
}

template <bool kUHasS>
int dispatch(const DGRows& rows, int nrows, int X, int S, int I, int J,
             long long E, int block_long, size_t smem, cudaStream_t stream) {
  switch (X) {
    case 1: return launch<1, kUHasS>(rows, nrows, S, I, J, E, block_long,
                                     smem, stream);
    case 2: return launch<2, kUHasS>(rows, nrows, S, I, J, E, block_long,
                                     smem, stream);
    case 3: return launch<3, kUHasS>(rows, nrows, S, I, J, E, block_long,
                                     smem, stream);
    case 4: return launch<4, kUHasS>(rows, nrows, S, I, J, E, block_long,
                                     smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of dg_rows_3xtf32 needs, in bytes.
size_t dg_rows_3xtf32_smem_bytes(int X, int S, int I, int J, int u_has_s) {
  return sizeof(float) * smem_floats(X, S, I, J, u_has_s != 0);
}

int dg_rows_3xtf32_max_rows() { return kMaxRows; }

// ptrs: nrows x {u, R, F (may be null), out}; strides: nrows x {u: s, j, e;
// R: s, i, j; F: x, s, e; out: x, i, e} in elements.  Returns the CUDA
// error of the launch (0 on success).
int dg_rows_3xtf32(int nrows, void* const* ptrs, const long long* strides,
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
  const size_t smem = dg_rows_3xtf32_smem_bytes(X, S, I, J, u_has_s);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return u_has_s
             ? dispatch<true>(rows, nrows, X, S, I, J, E, block_long, smem, s)
             : dispatch<false>(rows, nrows, X, S, I, J, E, block_long, smem,
                               s);
}

}  // extern "C"
