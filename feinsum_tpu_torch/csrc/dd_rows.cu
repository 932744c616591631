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
// stored as hi = rn_f32(acc), lo = rn_f32(acc - hi).  No TF32, no float32
// products, no DMMA.
//
// What bounds a row on an H100 (34 TFLOP/s of FP64 FMA, 3.35 TB/s, so the
// ridge is about 10 flop per byte; 8 bytes a pair).  At ndof 35 a div row
// does 2 * 3 * 35 * 35 flops an element for 584 bytes (u, its three J and
// the output): 12.6 flop/byte, bound by operations.  grad (X = 3, 1,192
// bytes), the face lift (S = 4 with u over s, J = 15: 792 bytes for 4,200
// flops) and the face restriction (I = 60, S = 1: 760 bytes) are bound by
// bytes.
//
// The general path (any stored layout): one thread block covers block_long
// consecutive elements and each thread owns one element per pass of
// kThreads.  R, as double and zero-padded in i to a multiple of 4, is staged
// once per block, laid out [s][j][i] so that two broadcast double2 loads feed
// four i; each thread stages its own u column [s][j] as double in shared
// memory.  For each block of four i it keeps t[s][k] = sum_j R[s, i0+k, j] *
// u[s?, j, e] in registers, then writes out[x, i, e] = sum_s F[x, s, e] *
// t[s][k] for every x.  Per j it issues 2 broadcast R loads and a u load per
// s for 4 FMAs (about 2 shared-memory cycles per FMA cycle), and its 52-78 KB
// blocks of 128 threads leave 8-12 warps on an SM: it reaches 27-46% of the
// rows' bounds.
//
// The tiled path (taken where u, F and out store e at stride 1, every row and
// pair plane of them starts on 16 bytes, no axis is broadcast, E (below
// 2^31) and block_long are multiples of 4 and the ring fits): dg_rows_f32's
// tiled design for FP64 registers and pair storage.  A thread block takes a
// run of whole blocks of block_long elements, one thread block to an SM,
// split among the rows, and walks its run in tiles of kTE = 128 elements:
// * R (i padded to the register tile's i) is combined once per thread block
//   into shared memory as double, [i group][j][s][i], so that one broadcast
//   double2 feeds two i;
// * a ring of 2-4 stages takes each tile's u (S_u x J rows) and F (X x S
//   rows) by the TMA unit, one box of a tensor map per operand: u as (e, j,
//   s, pair plane), F as (e, s, x, pair plane), each box kTE elements by
//   the whole of the other axes, landing as its hi rows and then its lo
//   rows.  (One bulk copy per row and pair plane, 76 for a div tile, cost
//   the issuing warp about 75 cycles a copy, 5-10 K cycles a tile, and
//   held the byte-bound rows at 1.5-2 TB/s; an L2 prefetch of the tiles
//   ahead made every row slower.)  A stage's "full" mbarrier counts its
//   bytes.  The ring runs across the whole run and never drains between
//   blocks of block_long; the computing warp that finishes a tile's last
//   unit (a counter in shared memory) refills its stage with the tile
//   `stages` on;
// * four combining warps, one on each of the SM's schedulers, combine each
//   landed pair once, in place: lane m reads floats 4m .. 4m + 3 of a row's
//   hi and lo rows and writes elements 4m, 4m + 1 as a double2 over the hi
//   floats it read and 4m + 2, 4m + 3 over the lo ones, so that the
//   computing warps' double2 loads are conflict-free; then they arrive on
//   the stage's "ready" mbarrier.  (Combining in every i-group pass would
//   spend FP64 issue slots on conversions 9 times over; one combining warp
//   loaded its scheduler's FP64 pipe with all of them);
// * up to 8 computing warps walk the units (an i group by a tile) in turn.
//   A lane owns elements 4l .. 4l + 3 of the tile and keeps t[s][i][4 e] in
//   double registers: 6 i at S = 3 (72 accumulators; per j 2 u loads of
//   512 bytes, 4 shared-memory cycles each, and 9 broadcast R loads, about
//   2 each: 208 cycles of shared memory an SM for 288 of its FMA pipes), 8
//   i where t has one s.  (4 i at S = 3 took 160 cycles for 192, and div
//   ran 6% slower: shared memory, with the pairs' combining and the
//   copies' writes, came close to the FMA pipes' time.)  72 accumulators
//   do not fit the 168 registers a thread that 12 warps an SM leave: the
//   combining warpgroup gives the computing ones registers (setmaxnreg),
//   224 a thread, where a tile has more than 48 (at 168 the S = 3 tiles
//   spilled and ran 20-110% slower);
// * the face lift (u over s, X = 1) folds F into u as the pair is combined,
//   w[s, j, e] = F[s, e] u[s, j, e], and sums over (s, j) at once, so t loses
//   its s index.  That reassociates: each w carries one more rounding, and
//   the row is a dot of length S J whose error is within (S J + 2) 2^-53 of
//   sum |R| |F| |u| (about 7e-15 of it at S J = 60), far inside the
//   oracle's 1e-12;
// * the epilogue computes sum_s F t in double and stores hi and lo as float4
//   along e, a warp's 512 contiguous bytes of each plane;
// * S, X, whether u carries s and whether F exists are template parameters,
//   so every loop over them unrolls.  Where t keeps s, each t[s][k][m] is the
//   general path's chain over j in the same order, and sum_s F t is summed in
//   the same order: the two paths agree bit for bit.
//
// Restriction rows.  The wave model's face restriction fji,ei->fej, a
// matvec whose resident carries every output letter but e, comes here as a
// row with S = 1, X = 1 and no F: ops/dd_emitter.py merges the output
// letters (f, j) into i as views of the pair tensors (R a (2, 1, F*Pf, P)
// view, the output a (2, 1, F*Pf, E) view of (2, F, Pf, E)), so the kernel
// needs no case of its own.  At ndof 35 and 4 x 15 face dofs, i = 60.
//
// All rows of a batched einsum run in one launch: blockIdx.y is the row,
// and the rows' pointers and strides travel by value (at most kMaxRows).

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tma_ring.cuh"

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

// The tiled path.

constexpr int kTE = 128;        // elements per tile (32 lanes x 4)
constexpr int kConsumers = 8;   // computing warps at most, two warpgroups
constexpr int kCombiners = 4;   // warps that combine the pairs, one an SMSP
// a tile of more than 48 accumulators: the combining warpgroup hands
// registers to the computing ones (12 warps, 3 to each SMSP, leave 168 a
// thread; these take 224 and leave the combining warps 56)
constexpr int kWideRegs = 224;
constexpr int kNarrowRegs = 56;
constexpr int kMaxStages = 4;   // ring stages at most
constexpr int kMaxBox = 256;    // the longest side of a TMA box (J at most)
// the dynamic shared memory of the one thread block an SM holds: the most a
// Hopper block can use, less room for its barriers and counters
constexpr size_t kTiledSmem = 232448 - 128;

// The register tile of a (S, X, u over s) row: whether F folds into u (the
// face lift), the s it keeps, and its i: 8 where it keeps one s, 6 where it
// keeps three (72 accumulators; 35 i pad to 36), else 4.
__host__ __device__ constexpr bool tile_folds(int X, bool u_has_s) {
  return u_has_s && X == 1;
}

__host__ __device__ constexpr int tile_s(int S, int X, bool u_has_s) {
  return tile_folds(X, u_has_s) ? 1 : S;
}

__host__ __device__ constexpr int tile_i(int S, int X, bool u_has_s) {
  return tile_s(S, X, u_has_s) == 1 ? 8 : tile_s(S, X, u_has_s) == 3 ? 6 : 4;
}

// the tiled path's shared memory: `stages` ring stages of u and F rows, a
// pair (two floats) and then its double in each of kTE places, and R as
// double (i padded to the tile's i)
inline size_t tiled_smem_bytes(int X, int S, int I, int J, bool u_has_s,
                               bool has_f, int stages) {
  const int ib = tile_i(S, X, u_has_s);
  const size_t r = static_cast<size_t>((I + ib - 1) / ib) * ib * S * J;
  const size_t stage = static_cast<size_t>((u_has_s ? S : 1) * J +
                                           (has_f ? X * S : 0)) * kTE;
  return sizeof(double) * (stages * stage + r);
}

// the most stages (4, 3 or 2) with which the block fits; 0 where none does
inline int tiled_stages(int X, int S, int I, int J, bool u_has_s,
                        bool has_f) {
  if (J > kMaxBox) return 0;
  for (int stages = kMaxStages; stages >= 2; --stages) {
    if (tiled_smem_bytes(X, S, I, J, u_has_s, has_f, stages) <= kTiledSmem) {
      return stages;
    }
  }
  return 0;
}

// The TMA boxes of a row: u as (e, j, s, pair plane) and F as (e, s, x,
// pair plane), each a box of kTE elements by the whole of its other axes.
// A box lands in shared memory as [plane][.][.][kTE]: its hi rows, then
// its lo rows, 512 bytes each.
struct DDMaps {
  CUtensorMap u[kMaxRows];
  CUtensorMap f[kMaxRows];
};

// a row's pair (hi in one 512-byte row, lo in another) combined in place:
// lane m's elements 4m, 4m + 1 become the double2 over the hi floats it
// read, 4m + 2, 4m + 3 the double2 over the lo floats
__device__ __forceinline__ void combine_row(double2* hi, double2* lo,
                                            int lane, double2& a,
                                            double2& b) {
  const float4 h = reinterpret_cast<const float4*>(hi)[lane];
  const float4 l = reinterpret_cast<const float4*>(lo)[lane];
  a = make_double2(static_cast<double>(h.x) + static_cast<double>(l.x),
                   static_cast<double>(h.y) + static_cast<double>(l.y));
  b = make_double2(static_cast<double>(h.z) + static_cast<double>(l.z),
                   static_cast<double>(h.w) + static_cast<double>(l.w));
}

__device__ __forceinline__ void fma4(double (&t)[4], double r, double2 a,
                                     double2 b) {
  t[0] = fma(r, a.x, t[0]);
  t[1] = fma(r, a.y, t[1]);
  t[2] = fma(r, b.x, t[2]);
  t[3] = fma(r, b.y, t[3]);
}

template <int S, int X, bool kUHasS, bool kHasF>
__global__ void __launch_bounds__((kConsumers + kCombiners) * 32, 1)
dd_rows_tiled(const DDRows rows, const __grid_constant__ DDMaps maps,
              const int I, const int J, const long long E,
              const int block_long, const long long nblocks,
              const int stages, const int consumers) {
  constexpr bool kFold = tile_folds(X, kUHasS);
  constexpr int Su = kUHasS ? S : 1;
  constexpr int St = tile_s(S, X, kUHasS);   // the s of t
  constexpr int IB = tile_i(S, X, kUHasS);   // the i of t
  constexpr int Sl = kFold ? 1 : Su;         // u rows a j step loads
  // j steps unrolled: two where t has at most 32 accumulators
  constexpr int kUnroll = St * IB > 8 ? 1 : 2;
  constexpr bool kWide = St * IB > 12;
  constexpr int kRow = kTE / 4;              // 16-byte pieces in a row
  extern __shared__ __align__(128) double2 smem2[];
  // per stage: its copies landed (the issuer's arrival and their bytes);
  // its pairs are combined (every combining lane); and the units done with
  // it, counted over all its tiles
  __shared__ unsigned long long full[kMaxStages], ready[kMaxStages];
  __shared__ int units_done[kMaxStages];
  const DDRow rw = rows.row[blockIdx.y];
  const CUtensorMap* map_u = &maps.u[blockIdx.y];
  const CUtensorMap* map_f = &maps.f[blockIdx.y];
  const int Jt = kFold ? S * J : J;  // the j of t's dot: (s, j) when folded
  const int IG = (I + IB - 1) / IB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int nu = Su * J;                  // u rows [s][j], then F's [x][s]
  const int nf = kHasF ? X * S : 0;
  const int stage2 = 2 * (nu + nf) * kRow;  // 16-byte pieces in a stage
  double2* ring = smem2;  // stages of [u hi][u lo][F hi][F lo] rows
  double* r_sh = reinterpret_cast<double*>(ring + stages * stage2);
  // [IG][Jt][St][IB]

  // this block's run of whole blocks of block_long elements
  const long long b0 = nblocks * blockIdx.x / gridDim.x;
  const long long b1 = nblocks * (blockIdx.x + 1) / gridDim.x;
  const long long e_begin = b0 * block_long;
  const long long e_end = min(E, b1 * block_long);
  const int ntiles = static_cast<int>((e_end - e_begin + kTE - 1) / kTE);

  if (tid == 0) {
    for (int k = 0; k < stages; ++k) {
      bar_init(&full[k], 1);
      bar_init(&ready[k], 32 * kCombiners);
      units_done[k] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // tile t's u and F boxes into its stage, one TMA copy each (a box past E
  // is filled with zeros; what a tile holds past the run's end is never
  // stored), by lane 0 of the calling warp
  auto produce = [&](int t) {
    if (lane != 0) return;
    const int st = t % stages;
    double2* dst = ring + st * stage2;
    const int e0 = static_cast<int>(e_begin + static_cast<long long>(t) * kTE);
    bar_expect(&full[st], 2 * (nu + nf) * kTE * sizeof(float));
    tensor_copy_4d(dst, map_u, e0, &full[st]);
    if (kHasF) tensor_copy_4d(dst + 2 * nu * kRow, map_f, e0, &full[st]);
  };
  // combining warp c's rows of tile t (every kCombiners-th row from c)
  // combined in place; on the lift F is folded into u (its rows then
  // unread: each combining warp combines them for itself)
  auto combine = [&](int t, int c) {
    double2* stage = ring + (t % stages) * stage2;
    double2* u_hi = stage;
    double2* u_lo = stage + nu * kRow;
    double2* f_hi = stage + 2 * nu * kRow;
    double2* f_lo = f_hi + nf * kRow;
    if constexpr (kFold) {
      double2 fa[S], fb[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if constexpr (kHasF) {
          combine_row(f_hi + s * kRow, f_lo + s * kRow, lane, fa[s], fb[s]);
        } else {
          fa[s] = fb[s] = make_double2(1.0, 1.0);
        }
      }
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int j0 = ((c - s * J) % kCombiners + kCombiners) % kCombiners;
#pragma unroll 2
        for (int j = j0; j < J; j += kCombiners) {
          const int r = s * J + j;
          double2 a, b;
          combine_row(u_hi + r * kRow, u_lo + r * kRow, lane, a, b);
          if constexpr (kHasF) {
            a.x *= fa[s].x;
            a.y *= fa[s].y;
            b.x *= fb[s].x;
            b.y *= fb[s].y;
          }
          u_hi[r * kRow + lane] = a;
          u_lo[r * kRow + lane] = b;
        }
      }
    } else {
#pragma unroll 2
      for (int r = c; r < nu + nf; r += kCombiners) {
        double2* hi = r < nu ? u_hi + r * kRow : f_hi + (r - nu) * kRow;
        double2* lo = r < nu ? u_lo + r * kRow : f_lo + (r - nu) * kRow;
        double2 a, b;
        combine_row(hi, lo, lane, a, b);
        hi[lane] = a;
        lo[lane] = b;
      }
    }
  };
  if (warp == kConsumers) {
    for (int t = 0; t < stages && t < ntiles; ++t) produce(t);
  }
  // R under the first tiles' copies, [g][j'][s'][k] with i = g IB + k and
  // (s, j) = (s', j'), or (j' / J, j' % J) when folded
  const int rtotal = IG * IB * S * J;
  for (int idx = tid; idx < rtotal; idx += blockDim.x) {
    const int k = idx % IB;
    const int rest = idx / IB;
    const int jp = rest / St % Jt;
    const int g = rest / St / Jt;
    const int i = g * IB + k;
    const int s = kFold ? jp / J : rest % St;
    const int j = kFold ? jp % J : jp;
    r_sh[idx] = i < I ? load_pair(rw.R, s * rw.sr_s + i * rw.sr_i +
                                            j * rw.sr_j, rw.sr_p)
                      : 0.0;
  }
  __syncthreads();

  // warps kConsumers .. kConsumers + 3 combine, one on each of the SM's
  // schedulers; of the kConsumers before them the first `consumers` compute
  if (warp >= kConsumers) {
    if constexpr (kWide) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kNarrowRegs));
    }
    // a combining warp: its rows of each tile once the tile lands
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % stages;
      bar_wait(&full[st], (t / stages) & 1);
      combine(t, warp - kConsumers);
      bar_arrive(&ready[st]);
    }
    return;
  }

  // the consumers: unit n is i group n % IG of tile n / IG; warp w takes
  // the units w, w + consumers, ...  Two units of a warp lie at most
  // consumers / IG (rounded up) <= stages tiles apart (the launch's choice),
  // so no warp waits on a stage's phase ahead of time.  The warp that does
  // a tile's last unit refills its stage with the tile `stages` on
  if constexpr (kWide) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWideRegs));
  }
  for (int n = warp; warp < consumers && n < ntiles * IG; n += consumers) {
    const int t = n / IG;
    const int g = n - t * IG;
    const int st = t % stages;
    bar_wait(&ready[st], (t / stages) & 1);
    const double2* tile = ring + st * stage2;
    const double2* uph = tile + lane;            // elements 4l, 4l + 1
    const double2* upl = tile + nu * kRow + lane;  // elements 4l + 2, 4l + 3
    const long long e = e_begin + static_cast<long long>(t) * kTE + 4 * lane;
    double acc[St][IB][4];
#pragma unroll
    for (int s = 0; s < St; ++s) {
#pragma unroll
      for (int k = 0; k < IB; ++k) {
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[s][k][m] = 0.0;
      }
    }
    const double2* rp = reinterpret_cast<const double2*>(
        r_sh + static_cast<size_t>(g) * Jt * St * IB);
#pragma unroll kUnroll
    for (int j = 0; j < Jt; ++j) {
      double2 ua[Sl], ub[Sl];
#pragma unroll
      for (int s = 0; s < Sl; ++s) {
        ua[s] = uph[(s * J + j) * kRow];
        ub[s] = upl[(s * J + j) * kRow];
      }
#pragma unroll
      for (int s = 0; s < St; ++s) {
        const int su = Sl == 1 ? 0 : s;
#pragma unroll
        for (int kk = 0; kk < IB / 2; ++kk) {
          const double2 r = rp[(j * St + s) * (IB / 2) + kk];
          fma4(acc[s][2 * kk], r.x, ua[su], ub[su]);
          fma4(acc[s][2 * kk + 1], r.y, ua[su], ub[su]);
        }
      }
    }
    if (e < e_end) {
#pragma unroll
      for (int x = 0; x < X; ++x) {
        double2 fa[St], fb[St];
#pragma unroll
        for (int s = 0; s < St; ++s) {
          if constexpr (kHasF && !kFold) {
            fa[s] = uph[(2 * nu + x * S + s) * kRow];
            fb[s] = uph[(2 * nu + nf + x * S + s) * kRow];
          } else {
            fa[s] = fb[s] = make_double2(1.0, 1.0);
          }
        }
#pragma unroll
        for (int k = 0; k < IB; ++k) {
          const int i = g * IB + k;
          if (i < I) {
            double o[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
            for (int s = 0; s < St; ++s) {
              o[0] = fma(fa[s].x, acc[s][k][0], o[0]);
              o[1] = fma(fa[s].y, acc[s][k][1], o[1]);
              o[2] = fma(fb[s].x, acc[s][k][2], o[2]);
              o[3] = fma(fb[s].y, acc[s][k][3], o[3]);
            }
            float4 hi, lo;
            hi.x = __double2float_rn(o[0]);
            hi.y = __double2float_rn(o[1]);
            hi.z = __double2float_rn(o[2]);
            hi.w = __double2float_rn(o[3]);
            lo.x = __double2float_rn(o[0] - static_cast<double>(hi.x));
            lo.y = __double2float_rn(o[1] - static_cast<double>(hi.y));
            lo.z = __double2float_rn(o[2] - static_cast<double>(hi.z));
            lo.w = __double2float_rn(o[3] - static_cast<double>(hi.w));
            float* out = rw.out + x * rw.so_x + i * rw.so_i + e;
            *reinterpret_cast<float4*>(out) = hi;
            *reinterpret_cast<float4*>(out + rw.so_p) = lo;
          }
        }
      }
    }
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      __threadfence_block();
      last = (atomicAdd(&units_done[st], 1) + 1) % IG == 0;
    }
    if (__shfl_sync(0xffffffffu, last, 0) && t + stages < ntiles) {
      __threadfence_block();
      fence_proxy_async();
      produce(t + stages);
    }
  }
}

using TiledKernel = void (*)(const DDRows, const DDMaps, int, int, long long,
                            int, long long, int, int);

template <int S, int X, bool kHasF>
TiledKernel tiled_instance(bool u_has_s) {
  if constexpr (S > 1) {
    if (u_has_s) return dd_rows_tiled<S, X, true, kHasF>;
  }
  return dd_rows_tiled<S, X, false, kHasF>;
}

template <int S>
TiledKernel tiled_for_s(int X, bool u_has_s, bool has_f) {
  if (!has_f) return X == 1 ? tiled_instance<S, 1, false>(u_has_s) : nullptr;
  switch (X) {
    case 1: return tiled_instance<S, 1, true>(u_has_s);
    case 2: return tiled_instance<S, 2, true>(u_has_s);
    case 3: return tiled_instance<S, 3, true>(u_has_s);
    case 4: return tiled_instance<S, 4, true>(u_has_s);
    default: return nullptr;
  }
}

TiledKernel tiled_kernel(int X, int S, bool u_has_s, bool has_f) {
  switch (S) {
    case 1: return tiled_for_s<1>(X, u_has_s, has_f);
    case 2: return tiled_for_s<2>(X, u_has_s, has_f);
    case 3: return tiled_for_s<3>(X, u_has_s, has_f);
    case 4: return tiled_for_s<4>(X, u_has_s, has_f);
    default: return nullptr;
  }
}

// a (2, n0, n1, E) pair operand the tiled path can copy: e at stride 1, its
// pointer and every stride of an axis longer than 1 (the pair planes' too)
// on 16 bytes and not 0
bool tileable(const void* p, int n0, int n1, long long sp, long long s0,
              long long s1, long long se) {
  return se == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 && sp != 0 &&
         sp % 4 == 0 && (n0 == 1 || (s0 != 0 && s0 % 4 == 0)) &&
         (n1 == 1 || (s1 != 0 && s1 % 4 == 0));
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// the (e, a, b, pair plane) map of a (2, na, nb, E) pair operand, strides in
// floats, boxes of kTE x na x nb x 2; an axis of length 1 gets a stride
// that keeps the map's strides increasing.  False where it cannot be made.
bool pair_map(CUtensorMap* map, const float* p, long long E, int na, int nb,
              long long sa, long long sb, long long sp) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(E),
                              static_cast<cuuint64_t>(na),
                              static_cast<cuuint64_t>(nb), 2};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(sa) * 4,
                           static_cast<cuuint64_t>(sb) * 4,
                           static_cast<cuuint64_t>(sp) * 4};
  if (na == 1) strides[0] = (static_cast<cuuint64_t>(E) * 4 + 15) / 16 * 16;
  if (nb == 1) strides[1] = strides[0] * na;
  const cuuint32_t box[4] = {kTE, static_cast<cuuint32_t>(na),
                             static_cast<cuuint32_t>(nb), 2};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<float*>(p), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}


}  // namespace

extern "C" {

// Dynamic shared memory one block of dd_rows's general path needs, in bytes;
// a shape is taken when it fits in a Hopper block.
size_t dd_rows_smem_bytes(int S, int I, int J, int u_has_s) {
  return sizeof(double) * smem_doubles(S, I, J, u_has_s != 0);
}

// Dynamic shared memory one block of the tiled path needs, in bytes, at the
// stages it runs with; 0 where no ring fits (the general path runs).
size_t dd_rows_tiled_smem_bytes(int X, int S, int I, int J, int u_has_s,
                                int has_f) {
  const bool us = u_has_s != 0 && S > 1;
  const int stages = tiled_stages(X, S, I, J, us, has_f != 0);
  return stages ? tiled_smem_bytes(X, S, I, J, us, has_f != 0, stages) : 0;
}

int dd_rows_max_rows() { return kMaxRows; }

// ptrs: nrows x {u, R, F (may be null), out}; strides: nrows x {u: pair, s,
// j, e; R: pair, s, i, j; F: pair, x, s, e; out: pair, x, i, e} in
// elements.  `tiled` asks for the tiled path; a layout or shape it does not
// take is refused.  Returns the CUDA error of the launch (0 on success).
int dd_rows(int nrows, void* const* ptrs, const long long* strides, int X,
            int S, int I, int J, long long E, int u_has_s, int block_long,
            int tiled, void* stream) {
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
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);

  if (tiled) {
    const bool us = u_has_s != 0 && S > 1;
    const bool has_f = rows.row[0].F != nullptr;
    const int stages = tiled_stages(X, S, I, J, us, has_f);
    const TiledKernel kernel = tiled_kernel(X, S, us, has_f);
    if (!stages || !kernel || E % 4 || block_long % 4 || E >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    DDMaps maps;
    for (int r = 0; r < nrows; ++r) {
      const DDRow& rw = rows.row[r];
      const int Su = us ? S : 1;
      if ((rw.F != nullptr) != has_f ||
          !tileable(rw.u, Su, J, rw.su_p, rw.su_s, rw.su_j, rw.su_e) ||
          (has_f && !tileable(rw.F, X, S, rw.sf_p, rw.sf_x, rw.sf_s,
                              rw.sf_e)) ||
          !tileable(rw.out, X, I, rw.so_p, rw.so_x, rw.so_i, rw.so_e) ||
          !pair_map(&maps.u[r], rw.u, E, J, Su, rw.su_j, rw.su_s, rw.su_p) ||
          (has_f && !pair_map(&maps.f[r], rw.F, E, S, X, rw.sf_s, rw.sf_x,
                              rw.sf_p))) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
    const size_t smem = tiled_smem_bytes(X, S, I, J, us, has_f, stages);
    int device = 0;
    cudaGetDevice(&device);
    if (smem > 48 * 1024) {
      const cudaError_t err = set_smem(kernel, device, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    // blocks: one to an SM, split among the rows, each taking a run of
    // whole blocks of block_long elements; computing warps: at most
    // kConsumers, and few enough that a warp's next unit lies at most
    // `stages` tiles on; and the combining warps
    const int sms = std::max(1, sm_count(device));
    const long long runs = std::max(1LL, std::min(
        nblocks, static_cast<long long>(sms) / nrows));
    const int groups = (I + tile_i(S, X, us) - 1) / tile_i(S, X, us);
    const int consumers = std::min(kConsumers, groups * stages);
    const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(nrows));
    kernel<<<grid, 32 * (kConsumers + kCombiners), smem, cs>>>(
        rows, maps, I, J, E, block_long, nblocks, stages, consumers);
    return static_cast<int>(cudaGetLastError());
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
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  kernel<<<grid, kThreads, smem, cs>>>(rows, X, I, J, E, block_long);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
