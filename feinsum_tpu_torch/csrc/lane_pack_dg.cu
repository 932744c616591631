// lane_pack_dg_f32: K1's three-step schedule of a lane-packed DG program.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) on the programs that the DG lane-pack
// rewrite builds (tuning/impls/_common.py::rewrite_lane_pack_dg): g
// consecutive elements share one packed row, the resident is the
// block-diagonal T[m] = kron(I_g, R[m]) and a 0/1 matrix EXP spreads each
// element's scale over its output lanes.  For every row of the batched
// program, with E counting packed rows,
//
//     V[m, e, gi] = sum_gj u'[u_of_m[m], e, gj] * T[m, gi, gj]
//     W[w, e, gi] = sum_pk J'[j_of_w[w], e, pk] * EXP[exp_of_w[w], pk, gi]
//     out[o, e, gi] = sum over the terms (m, w, o) of V[m] * W[w]
//
// which is what K1 computes on these operands (lower_step's two dots and
// the product summed over the shared letters), the dense kron dots
// included: g times the multiply-adds of the unpacked row.  The host gives
// the terms and every operand slice's offset (ops/lane_pack.py plans them),
// and one stride per remaining axis, so any stored permutation works.
//
// Design.  A block owns a tile of 64 packed rows x 64 output lanes (128 x
// 32 when the output has at most 32 lanes), 256 threads with 4 rows x 4
// lanes each, and walks block_long packed rows tile by tile.  Per tile it
// computes V[m] for each m in turn and, for each term of that m, W[w], and
// adds V * W to the term's output in registers: V and W never reach device
// memory.  A thread keeps sums for one output slice, or for kMaxOut when
// the program has several (grad's x), so that a one-output program fits
// two blocks on an SM.  Each dot walks its contracted lanes in chunks of
// 16: both tiles of the chunk are staged in shared memory (rows along the
// stride-1 axis of each operand, so the loads are coalesced in either
// stored layout; ragged rows, lanes and chunks zero-filled), each thread
// loading its values of the next chunk into registers while the block
// computes on this one, 16 x 4 x 4 FMAs from two float4 loads per k.  T
// and EXP are read through the read-only path: at the suite's widths they
// are a few MB, resident in the 50 MB L2, and no block stages all of T
// (g*d reaches 4096).  Consecutive blocks share a row tile and differ in
// their lane tile, so u' and J' come from device memory about once.
//
// At "bf16_3x" both dots take the reference's split
// (feinsum_tpu/ops/kernel_lowering.py::_dot_bf16_3x) with TF32 halves: each
// staged value x is stored as hi = tf32(x) and lo = tf32(x - hi), and a
// product is lo*hi + hi*lo + hi*hi, on the CUDA cores (a product of two
// TF32 values is exact in f32).  The sum of the terms stays f32.
//
// What bounds it on an H100.  The dense kron dots make the packed program
// compute-bound on the CUDA cores: div at ndof 20 and g = 8 does 66.6
// GFLOP over its three rows at E = 1M, about 1 ms at the 67 TFLOP/s fp32
// peak, against 0.15 ms for the bytes of the logical einsum.  This design
// reaches 14-28% of that peak; skipping T's zero blocks (g times less
// work), tensor cores for the 3x variant, or running a packed point on
// dg_rows_f32's view of the same bytes is later work.
//
// All rows of a batched program run in one launch: blockIdx.y is the row,
// and the rows' pointers, strides and offsets travel by value (at most
// kMaxRows; the kernel parameter is __grid_constant__).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxRows = 4;
constexpr int kMaxM = 4;       // T slices
constexpr int kMaxW = 16;      // W slices
constexpr int kMaxOut = 4;     // output slices
constexpr int kMaxTerms = 16;  // terms (m, w, o)
constexpr int kThreads = 256;
constexpr int kKC = 16;        // contracted lanes per staged chunk
constexpr int kTM = 4;         // packed rows per thread
constexpr int kTN = 4;         // output lanes per thread

struct LPRow {
  const float* u;    // (e, gj) slices at u_off
  const float* T;    // (gi, gj) slices at t_off
  const float* J;    // (e, pk) slices at j_off
  const float* X;    // EXP: (pk, gi) slices at x_off
  float* out;        // (e, gi) slices at o_off
  long long su_e, su_j, st_i, st_j, sj_e, sj_k, sx_k, sx_i, so_e, so_i;
  long long u_off[kMaxM], t_off[kMaxM];
  long long j_off[kMaxW], x_off[kMaxW];
  long long o_off[kMaxOut];
};

struct LPArgs {
  LPRow row[kMaxRows];
  int term_m[kMaxTerms], term_w[kMaxTerms], term_o[kMaxTerms];
};

// rows (packed elements) of a block's tile for its lane width
__host__ __device__ constexpr int tile_rows(int ti) {
  return kThreads * kTM * kTN / ti;
}

__host__ __device__ inline size_t smem_floats(int gi, bool split) {
  const int ti = gi <= 32 ? 32 : 64;
  return static_cast<size_t>(split ? 2 : 1) * kKC *
         ((tile_rows(ti) + 4) + (ti + 4));
}

// x rounded to TF32: to nearest, ties away from zero, on the bit pattern
// (cvt.rna.tf32.f32's rounding); the low 13 bits of the result are zero.
// Infinities and NaN pass unchanged.
__device__ __forceinline__ float tf32_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

// a value into shared memory: as it is, or as its TF32 hi and lo halves
// (the lo plane `plane` floats further on)
template <bool kSplit>
__device__ __forceinline__ void stage(float* dst, int plane, float x) {
  if (kSplit) {
    const float hi = tf32_round(x);
    dst[0] = hi;
    dst[plane] = tf32_round(x - hi);
  } else {
    dst[0] = x;
  }
}

// acc[r][c] += sum_k A[e0 + ty*4 + r, k] * B[k, i0 + tx*4 + c] over k < K:
// A (rows, k) and B (k, lanes) through their strides, one chunk of kKC k
// at a time staged in a_sh [k][row] and b_sh [k][lane]; each thread loads
// its values of the next chunk into registers while the block computes on
// the current one
template <int kTI, bool kSplit>
__device__ __forceinline__ void dot_tile(
    float (&acc)[kTM][kTN], const float* __restrict__ A, long long sa_e,
    long long sa_k, const float* __restrict__ B, long long sb_k,
    long long sb_i, int K, long long e0, long long E, int i0, int GI,
    float* a_sh, float* b_sh) {
  constexpr int kTE = tile_rows(kTI);
  constexpr int kAP = kTE + 4;
  constexpr int kBP = kTI + 4;
  constexpr int kAPlane = kKC * kAP;
  constexpr int kBPlane = kKC * kBP;
  constexpr int kAV = kTE * kKC / kThreads;   // A values a thread stages
  constexpr int kBV = kTI * kKC / kThreads;   // B values a thread stages
  const int tid = threadIdx.x;
  const int tx = tid % (kTI / kTN);
  const int ty = tid / (kTI / kTN);
#pragma unroll
  for (int r = 0; r < kTM; ++r) {
#pragma unroll
    for (int c = 0; c < kTN; ++c) acc[r][c] = 0.f;
  }
  // a thread's n-th value of a chunk: (row or lane, k), the stride-1 axis
  // running fastest across the threads
  const bool a_rows_fast = sa_e == 1;
  const bool b_lanes_fast = sb_i == 1;
  auto a_at = [&](int n, int& e, int& k) {
    const int idx = tid + n * kThreads;
    e = a_rows_fast ? idx % kTE : idx / kKC;
    k = a_rows_fast ? idx / kTE : idx % kKC;
  };
  auto b_at = [&](int n, int& i, int& k) {
    const int idx = tid + n * kThreads;
    i = b_lanes_fast ? idx % kTI : idx / kKC;
    k = b_lanes_fast ? idx / kTI : idx % kKC;
  };
  float av[kAV], bv[kBV];
  auto load = [&](int k0) {
#pragma unroll
    for (int n = 0; n < kAV; ++n) {
      int e, k;
      a_at(n, e, k);
      const long long ge = e0 + e;
      const int gk = k0 + k;
      av[n] = (ge < E && gk < K) ? __ldg(A + ge * sa_e + gk * sa_k) : 0.f;
    }
#pragma unroll
    for (int n = 0; n < kBV; ++n) {
      int i, k;
      b_at(n, i, k);
      const int gi = i0 + i;
      const int gk = k0 + k;
      bv[n] = (gi < GI && gk < K) ? __ldg(B + gk * sb_k + gi * sb_i) : 0.f;
    }
  };
  load(0);
  for (int k0 = 0; k0 < K; k0 += kKC) {
#pragma unroll
    for (int n = 0; n < kAV; ++n) {
      int e, k;
      a_at(n, e, k);
      stage<kSplit>(a_sh + k * kAP + e, kAPlane, av[n]);
    }
#pragma unroll
    for (int n = 0; n < kBV; ++n) {
      int i, k;
      b_at(n, i, k);
      stage<kSplit>(b_sh + k * kBP + i, kBPlane, bv[n]);
    }
    __syncthreads();
    if (k0 + kKC < K) load(k0 + kKC);
#pragma unroll
    for (int k = 0; k < kKC; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(
          a_sh + k * kAP + ty * kTM);
      const float4 b4 = *reinterpret_cast<const float4*>(
          b_sh + k * kBP + tx * kTN);
      const float a[kTM] = {a4.x, a4.y, a4.z, a4.w};
      const float b[kTN] = {b4.x, b4.y, b4.z, b4.w};
      if (kSplit) {
        const float4 al4 = *reinterpret_cast<const float4*>(
            a_sh + kAPlane + k * kAP + ty * kTM);
        const float4 bl4 = *reinterpret_cast<const float4*>(
            b_sh + kBPlane + k * kBP + tx * kTN);
        const float al[kTM] = {al4.x, al4.y, al4.z, al4.w};
        const float bl[kTN] = {bl4.x, bl4.y, bl4.z, bl4.w};
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
#pragma unroll
          for (int c = 0; c < kTN; ++c) {
            acc[r][c] = fmaf(al[r], b[c], acc[r][c]);
            acc[r][c] = fmaf(a[r], bl[c], acc[r][c]);
            acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
#pragma unroll
          for (int c = 0; c < kTN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
      }
    }
    __syncthreads();
  }
}

// kNO: the output slices a thread keeps sums for (1, or kMaxOut)
template <int kTI, bool kSplit, int kNO>
__global__ void __launch_bounds__(kThreads)
lane_pack_dg_kernel(const __grid_constant__ LPArgs args, const int nterms,
                    const int NO, const long long E, const int GI,
                    const int GJ, const int PK, const long long block_rows,
                    const int n_itiles) {
  constexpr int kTE = tile_rows(kTI);
  constexpr int kParts = kSplit ? 2 : 1;
  __shared__ __align__(16) float a_sh[kParts * kKC * (kTE + 4)];
  __shared__ __align__(16) float b_sh[kParts * kKC * (kTI + 4)];
  const LPRow& rw = args.row[blockIdx.y];
  const int i0 = static_cast<int>(blockIdx.x % n_itiles) * kTI;
  const long long e_begin = (blockIdx.x / n_itiles) * block_rows;
  const long long e_end = min(E, e_begin + block_rows);
  const int tx = threadIdx.x % (kTI / kTN);
  const int ty = threadIdx.x / (kTI / kTN);

  for (long long e0 = e_begin; e0 < e_end; e0 += kTE) {
    float acc[kNO][kTM][kTN];
#pragma unroll
    for (int o = 0; o < kNO; ++o) {
#pragma unroll
      for (int r = 0; r < kTM; ++r) {
#pragma unroll
        for (int c = 0; c < kTN; ++c) acc[o][r][c] = 0.f;
      }
    }
    float v[kTM][kTN];
    int v_m = -1;
    for (int t = 0; t < nterms; ++t) {
      const int m = args.term_m[t];
      const int w = args.term_w[t];
      const int to = args.term_o[t];
      if (m != v_m) {   // the terms come ordered by m: each V once
        dot_tile<kTI, kSplit>(v, rw.u + rw.u_off[m], rw.su_e, rw.su_j,
                              rw.T + rw.t_off[m], rw.st_j, rw.st_i, GJ, e0,
                              E, i0, GI, a_sh, b_sh);
        v_m = m;
      }
      float wt[kTM][kTN];
      dot_tile<kTI, kSplit>(wt, rw.J + rw.j_off[w], rw.sj_e, rw.sj_k,
                            rw.X + rw.x_off[w], rw.sx_k, rw.sx_i, PK, e0, E,
                            i0, GI, a_sh, b_sh);
#pragma unroll
      for (int o = 0; o < kNO; ++o) {
        if (o == to) {
#pragma unroll
          for (int r = 0; r < kTM; ++r) {
#pragma unroll
            for (int c = 0; c < kTN; ++c) {
              acc[o][r][c] = fmaf(v[r][c], wt[r][c], acc[o][r][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kNO; ++o) {
      if (o < NO) {
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
          const long long e = e0 + ty * kTM + r;
          if (e >= E) continue;
#pragma unroll
          for (int c = 0; c < kTN; ++c) {
            const int gi = i0 + tx * kTN + c;
            if (gi < GI) {
              rw.out[rw.o_off[o] + e * rw.so_e + gi * rw.so_i] = acc[o][r][c];
            }
          }
        }
      }
    }
  }
}

template <bool kSplit>
int launch(int nrows, void* const* ptrs, const long long* strides,
           const long long* offsets, const int* terms, int M, int NW, int NO,
           int nterms, long long E, int GI, int GJ, int PK, int block_long,
           void* stream) {
  if (nrows < 1 || nrows > kMaxRows || M < 1 || M > kMaxM || NW < 1 ||
      NW > kMaxW || NO < 1 || NO > kMaxOut || nterms < 1 ||
      nterms > kMaxTerms || E < 1 || GI < 1 || GJ < 1 || PK < 1 ||
      block_long < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LPArgs args;
  for (int t = 0; t < nterms; ++t) {
    args.term_m[t] = terms[3 * t];
    args.term_w[t] = terms[3 * t + 1];
    args.term_o[t] = terms[3 * t + 2];
    if (args.term_m[t] < 0 || args.term_m[t] >= M || args.term_w[t] < 0 ||
        args.term_w[t] >= NW || args.term_o[t] < 0 || args.term_o[t] >= NO ||
        (t > 0 && args.term_m[t] < args.term_m[t - 1])) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int n_off = 2 * M + 2 * NW + NO;
  for (int r = 0; r < nrows; ++r) {
    LPRow& rw = args.row[r];
    rw.u = static_cast<const float*>(ptrs[5 * r + 0]);
    rw.T = static_cast<const float*>(ptrs[5 * r + 1]);
    rw.J = static_cast<const float*>(ptrs[5 * r + 2]);
    rw.X = static_cast<const float*>(ptrs[5 * r + 3]);
    rw.out = static_cast<float*>(ptrs[5 * r + 4]);
    const long long* st = strides + 10 * r;
    rw.su_e = st[0]; rw.su_j = st[1];
    rw.st_i = st[2]; rw.st_j = st[3];
    rw.sj_e = st[4]; rw.sj_k = st[5];
    rw.sx_k = st[6]; rw.sx_i = st[7];
    rw.so_e = st[8]; rw.so_i = st[9];
    const long long* off = offsets + static_cast<long long>(n_off) * r;
    for (int m = 0; m < M; ++m) rw.u_off[m] = off[m];
    for (int m = 0; m < M; ++m) rw.t_off[m] = off[M + m];
    for (int w = 0; w < NW; ++w) rw.j_off[w] = off[2 * M + w];
    for (int w = 0; w < NW; ++w) rw.x_off[w] = off[2 * M + NW + w];
    for (int o = 0; o < NO; ++o) rw.o_off[o] = off[2 * M + 2 * NW + o];
  }
  const int ti = GI <= 32 ? 32 : 64;
  const int te = tile_rows(ti);
  // a block's rows: block_long rounded up to whole tiles
  const long long block_rows =
      (static_cast<long long>(block_long) + te - 1) / te * te;
  const int n_itiles = (GI + ti - 1) / ti;
  const long long nblocks = (E + block_rows - 1) / block_rows * n_itiles;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  void (*kernel)(const LPArgs, int, int, long long, int, int, int,
                 long long, int) =
      ti == 32 ? (NO == 1 ? lane_pack_dg_kernel<32, kSplit, 1>
                          : lane_pack_dg_kernel<32, kSplit, kMaxOut>)
               : (NO == 1 ? lane_pack_dg_kernel<64, kSplit, 1>
                          : lane_pack_dg_kernel<64, kSplit, kMaxOut>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, nterms, NO, E, GI, GJ, PK, block_rows, n_itiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (static; it does not grow with
// g*d).
size_t lane_pack_dg_smem_bytes(int GI, int split) {
  return sizeof(float) * smem_floats(GI, split != 0);
}

int lane_pack_dg_max_rows() { return kMaxRows; }

// ptrs: nrows x {u', T, J', EXP, out}; strides: nrows x {u': e, gj; T: gi,
// gj; J': e, pk; EXP: pk, gi; out: e, gi} in elements; offsets: nrows x
// {u_off[M], t_off[M], j_off[NW], x_off[NW], o_off[NO]} in elements;
// terms: nterms x {m, w, o}, ordered by m.  Returns the CUDA error of the
// launch (0 on success).
int lane_pack_dg_f32(int nrows, void* const* ptrs, const long long* strides,
                     const long long* offsets, const int* terms, int M,
                     int NW, int NO, int nterms, long long E, int GI, int GJ,
                     int PK, int block_long, void* stream) {
  return launch<false>(nrows, ptrs, strides, offsets, terms, M, NW, NO,
                       nterms, E, GI, GJ, PK, block_long, stream);
}

// lane_pack_dg_f32 with both dots in three passes over the TF32 split.
int lane_pack_dg_3xtf32(int nrows, void* const* ptrs,
                        const long long* strides, const long long* offsets,
                        const int* terms, int M, int NW, int NO, int nterms,
                        long long E, int GI, int GJ, int PK, int block_long,
                        void* stream) {
  return launch<true>(nrows, ptrs, strides, offsets, terms, M, NW, NO,
                      nterms, E, GI, GJ, PK, block_long, stream);
}

}  // extern "C"
