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
// What bounds a row on an H100 (67 TFLOP/s fp32 on the CUDA cores, 3.35
// TB/s, so the ridge is 20 flop per byte).  At ndof 35 a dof-major row does
// 2 * 35 * 35 * S flops an element and moves 4 * (35 S_u + X S + 35 X)
// bytes: div and curl (S = 3, 7,560 flops for 292 bytes) are bound by
// operations, grad (X = 3, 596 bytes), the face lift (S = 4 with u over s,
// J = 15) and the face restriction (I = 60, S = 1) by bytes.  One element
// per thread with its u column loaded by plain loads (the general path
// below) runs these rows at 0.7-0.84 TB/s and 11.9 TFLOP/s: bound by
// latency and issue, far from both.
//
// The tiled path (taken where u, F and out store e at stride 1, every row
// of them starts on 16 bytes, E and block_long are multiples of 4 and the
// ring fits).  The elements fall in blocks of block_long (the descriptor's
// knob); a thread block takes a run of whole such blocks, as many thread
// blocks as the card holds at once, split among the rows, and walks its
// run in tiles of kTE = 128 elements:
// * R (i padded to a multiple of 4) is loaded once per thread block into
//   shared memory as [i / 4][j][s][4], so that one broadcast float4 feeds
//   four i;
// * a copying warp puts each tile's u (S_u x J rows of 128 elements) and F
//   (X x S rows) into a ring of 2-4 shared-memory stages by the TMA unit,
//   one bulk copy per row; a stage's "full" mbarrier counts its bytes, its
//   "empty" one the units done with it.  The ring runs across the whole
//   run, so it never drains between blocks of block_long, and R is not
//   loaded again.  (Per-thread 16-byte cp.async copies, one tile ring per
//   block of block_long, stalled the computing warps on the copies' issue
//   and refilled R and the ring every 512 elements: 1.5x slower);
// * 8 computing warps (fewer where I has fewer groups of 4 i), two to
//   each of the SM's four schedulers, walk the units (an i group by a
//   tile) in turn: warp w takes units w, w + warps, ...  (A warp per i
//   group, nine at ndof 35, left one scheduler a third more work.)  A lane
//   owns elements 4l .. 4l + 3 of the tile.  A thread keeps t[s][4 i][4 e]
//   in registers and, per j, loads S_u float4 of u and S float4 of R for
//   16 S FMAs: on the S = 3 rows 7 shared-memory wavefronts per 48 warp
//   FMAs, so FMA issue, not shared memory, is the limit;
// * the epilogue computes sum_s F[x, s, e] t[s] in registers and stores
//   out[x, i, e .. e + 3] as float4, a warp's 512 contiguous bytes;
// * S, X, whether u carries s and whether F exists are template parameters
//   (dd_rows's lesson), so every loop over them unrolls.  The launch bound
//   fits two thread blocks of 9 warps on an SM (96 registers a thread).
// Any other stored layout takes the general path: each thread owns one
// element, stages its u column in shared memory and keeps t[s][4 i].
// Both paths do every product and sum as an fp32 FMA in the same order
// over j; no TF32.
//
// All rows of a batched einsum run in one launch: blockIdx.y is the row,
// and the rows' pointers and strides travel by value (at most kMaxRows).

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tma_ring.cuh"

namespace {

constexpr int kMaxRows = 4;
constexpr int kMaxS = 4;
constexpr int kMaxX = 4;
constexpr int kIB = 4;          // i per register block (one float4 of R)
constexpr int kThreads = 128;   // general path: threads, one element each
constexpr int kTE = 128;        // tiled path: elements per tile (32 x 4)
constexpr int kConsumers = 8;   // tiled path: computing warps at most
constexpr int kMaxStages = 4;   // tiled path: ring stages at most
// shared memory a Hopper thread block can use
constexpr size_t kMaxSmem = 232448;
// the tiled path's dynamic shared memory: of a block of which two fit on an
// SM (228 KB, 1 KB reserved per block, the barriers), and of one block
constexpr size_t kTwoBlockSmem = 112 * 1024;
constexpr size_t kOneBlockSmem = kMaxSmem - 64;

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

// the tiled path's shared memory: R and `stages` ring stages of u and F
inline size_t tiled_smem_bytes(int X, int S, int I, int J, bool u_has_s,
                               bool has_f, int stages) {
  const size_t stage = static_cast<size_t>((u_has_s ? S : 1) * J +
                                           (has_f ? X * S : 0)) * kTE;
  return sizeof(float) *
         (static_cast<size_t>(S) * J * padded_i(I) + stages * stage);
}

// The tiled path's ring: the most stages (4, 3 or 2) with which two blocks
// fit on an SM, else the most (3 or 2) with which one block fits; 0 where
// no ring fits (the general path).  Its blocks to an SM: 2 or 1.
inline int tiled_stages(int X, int S, int I, int J, bool u_has_s,
                        bool has_f) {
  for (int stages = kMaxStages; stages >= 2; --stages) {
    if (tiled_smem_bytes(X, S, I, J, u_has_s, has_f, stages) <=
        kTwoBlockSmem) {
      return stages;
    }
  }
  for (int stages = 3; stages >= 2; --stages) {
    if (tiled_smem_bytes(X, S, I, J, u_has_s, has_f, stages) <=
        kOneBlockSmem) {
      return stages;
    }
  }
  return 0;
}

__device__ __forceinline__ void fma4(float (&t)[4], float r, float4 u) {
  t[0] = fmaf(r, u.x, t[0]);
  t[1] = fmaf(r, u.y, t[1]);
  t[2] = fmaf(r, u.z, t[2]);
  t[3] = fmaf(r, u.w, t[3]);
}

template <int S, int X, bool kUHasS, bool kHasF>
__global__ void __launch_bounds__((kConsumers + 1) * 32, 2)
dg_rows_f32_tiled(const DGRows rows, const int I, const int J,
                  const long long E, const int block_long,
                  const long long nblocks, const int stages) {
  constexpr int Su = kUHasS ? S : 1;
  // j steps unrolled: two where a step holds a few float4, one at S_u S > 4
  constexpr int kUnroll = Su * S > 4 ? 1 : 2;
  extern __shared__ float4 smem4[];
  // per stage: its copies landed (the producer's arrival and their bytes);
  // its units are done (one arrival per i group)
  __shared__ unsigned long long full[kMaxStages], empty[kMaxStages];
  const DGRow rw = rows.row[blockIdx.y];
  const int IG = (I + kIB - 1) / kIB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int consumers = blockDim.x / 32 - 1;  // the last warp copies
  float4* r_sh = smem4;  // [IG][J][S] float4 of four i
  float* ring = reinterpret_cast<float*>(r_sh + static_cast<size_t>(IG) * J *
                                                    S);
  const int nrows = Su * J + (kHasF ? X * S : 0);  // kTE floats each
  const int stage_floats = nrows * kTE;

  // this block's run of whole blocks of block_long elements
  const long long b0 = nblocks * blockIdx.x / gridDim.x;
  const long long b1 = nblocks * (blockIdx.x + 1) / gridDim.x;
  const long long e_begin = b0 * block_long;
  const long long e_end = min(E, b1 * block_long);
  const int ntiles = static_cast<int>((e_end - e_begin + kTE - 1) / kTE);

  if (tid == 0) {
    for (int k = 0; k < stages; ++k) {
      bar_init(&full[k], 1);
      bar_init(&empty[k], IG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer: tile t's u rows [s][j] and F rows [x][s] into stage t %
  // stages once the units of tile t - stages are done, a bulk copy per row;
  // a row past the run's end is cut short, and what it leaves in the stage
  // is never stored
  auto produce = [&](int t) {
    const int st = t % stages;
    if (t >= stages) bar_wait(&empty[st], (t / stages - 1) & 1);
    float* dst = ring + st * stage_floats;
    const long long e0 = e_begin + static_cast<long long>(t) * kTE;
    const unsigned bytes = static_cast<unsigned>(
        min(static_cast<long long>(kTE), e_end - e0) * sizeof(float));
    if (lane == 0) bar_expect(&full[st], bytes * nrows);
    __syncwarp();
    for (int row = lane; row < nrows; row += 32) {
      const float* src;
      if (row < Su * J) {
        const int s = Su == 1 ? 0 : row / J;
        src = rw.u + s * rw.su_s + (row - s * J) * rw.su_j;
      } else {
        const int xs = row - Su * J;
        src = rw.F + (xs / S) * rw.sf_x + (xs % S) * rw.sf_s;
      }
      bulk_copy(dst + row * kTE, src + e0, bytes, &full[st]);
    }
  };
  if (warp == consumers) {
    for (int t = 0; t < stages && t < ntiles; ++t) produce(t);
  }
  // R under the first tiles' copies: a warp per (s, i) row, a lane per j
  float* r_f = reinterpret_cast<float*>(r_sh);
  for (int si = warp; si < S * IG * kIB; si += consumers + 1) {
    const int s = si / (IG * kIB);
    const int i = si - s * (IG * kIB);
    const float* src = rw.R + s * rw.sr_s + min(i, I - 1) * rw.sr_i;
    float* dst = r_f + ((i / kIB) * J * S + s) * kIB + i % kIB;
    for (int j = lane; j < J; j += 32) {
      dst[j * S * kIB] = i < I ? src[j * rw.sr_j] : 0.f;
    }
  }
  __syncthreads();
  if (warp == consumers) {
    for (int t = stages; t < ntiles; ++t) produce(t);
    return;
  }

  // the consumers: unit n is i group n % IG of tile n / IG; warp w takes
  // the units w, w + consumers, ..., so that every warp has a unit in every
  // tile (consumers <= IG) and none waits on a stage's phase ahead of time
  for (int n = warp; n < ntiles * IG; n += consumers) {
    const int t = n / IG;
    const int g = n - t * IG;
    const int st = t % stages;
    bar_wait(&full[st], (t / stages) & 1);
    const float* tile = ring + st * stage_floats;
    const float4* up = reinterpret_cast<const float4*>(tile) + lane;
    const long long e = e_begin + static_cast<long long>(t) * kTE + 4 * lane;
    float acc[S][kIB][4];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int k = 0; k < kIB; ++k) {
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[s][k][m] = 0.f;
      }
    }
    const float4* rp = r_sh + static_cast<size_t>(g) * J * S;
#pragma unroll kUnroll
    for (int j = 0; j < J; ++j) {
      float4 uv[Su];
#pragma unroll
      for (int s = 0; s < Su; ++s) uv[s] = up[(s * J + j) * (kTE / 4)];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 r = rp[j * S + s];
        const float4 v = uv[kUHasS ? s : 0];
        fma4(acc[s][0], r.x, v);
        fma4(acc[s][1], r.y, v);
        fma4(acc[s][2], r.z, v);
        fma4(acc[s][3], r.w, v);
      }
    }
    if (e < e_end) {
#pragma unroll
      for (int x = 0; x < X; ++x) {
        float4 f[S];
#pragma unroll
        for (int s = 0; s < S; ++s) {
          f[s] = kHasF ? reinterpret_cast<const float4*>(
                             tile + (Su * J + x * S + s) * kTE)[lane]
                       : make_float4(1.f, 1.f, 1.f, 1.f);
        }
#pragma unroll
        for (int k = 0; k < kIB; ++k) {
          const int i = g * kIB + k;
          if (i < I) {
            float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int s = 0; s < S; ++s) {
              o[0] = fmaf(f[s].x, acc[s][k][0], o[0]);
              o[1] = fmaf(f[s].y, acc[s][k][1], o[1]);
              o[2] = fmaf(f[s].z, acc[s][k][2], o[2]);
              o[3] = fmaf(f[s].w, acc[s][k][3], o[3]);
            }
            *reinterpret_cast<float4*>(rw.out + x * rw.so_x + i * rw.so_i +
                                       e) = make_float4(o[0], o[1], o[2],
                                                        o[3]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[st]);  // the unit is done with the stage
  }
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

using TiledKernel = void (*)(const DGRows, int, int, long long, int,
                            long long, int);

template <int S, int X, bool kHasF>
TiledKernel tiled_instance(bool u_has_s) {
  if constexpr (S > 1) {
    if (u_has_s) return dg_rows_f32_tiled<S, X, true, kHasF>;
  }
  return dg_rows_f32_tiled<S, X, false, kHasF>;
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

// a (n0, n1, E) operand the tiled path can copy: e at stride 1, its
// pointer and every stride of an axis longer than 1 on 16 bytes
bool tileable(const void* p, int n0, int n1, long long s0, long long s1,
              long long se) {
  return se == 1 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (n0 == 1 || s0 % 4 == 0) && (n1 == 1 || s1 % 4 == 0);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of dg_rows_f32's general path needs, in
// bytes; a shape is taken when it fits in a Hopper block.
size_t dg_rows_f32_smem_bytes(int S, int I, int J, int u_has_s) {
  return sizeof(float) * smem_floats(S, I, J, u_has_s != 0);
}

// Dynamic shared memory one block of the tiled path needs, in bytes, at the
// stages it runs with; 0 where no ring fits (the general path runs).
size_t dg_rows_f32_tiled_smem_bytes(int X, int S, int I, int J, int u_has_s,
                                    int has_f) {
  const int stages = tiled_stages(X, S, I, J, u_has_s != 0, has_f != 0);
  return stages ? tiled_smem_bytes(X, S, I, J, u_has_s != 0, has_f != 0,
                                   stages)
                : 0;
}

int dg_rows_f32_max_rows() { return kMaxRows; }

// ptrs: nrows x {u, R, F (may be null), out}; strides: nrows x {u: s, j, e;
// R: s, i, j; F: x, s, e; out: x, i, e} in elements.  `tiled` asks for the
// tiled path; a layout or shape it does not take is refused.  Returns the
// CUDA error of the launch (0 on success).
int dg_rows_f32(int nrows, void* const* ptrs, const long long* strides,
                int X, int S, int I, int J, long long E, int u_has_s,
                int block_long, int tiled, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || X < 1 || X > kMaxX || S < 1 ||
      S > kMaxS || I < 1 || J < 1 || E < 1 || block_long < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool us = u_has_s != 0 && S > 1;
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
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  if (tiled) {
    const bool has_f = rows.row[0].F != nullptr;
    const int stages = tiled_stages(X, S, I, J, us, has_f);
    const TiledKernel kernel = tiled_kernel(X, S, us, has_f);
    if (!stages || !kernel || E % 4 || block_long % 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int r = 0; r < nrows; ++r) {
      const DGRow& rw = rows.row[r];
      if ((rw.F != nullptr) != has_f ||
          !tileable(rw.u, us ? S : 1, J, rw.su_s, rw.su_j, rw.su_e) ||
          (has_f && !tileable(rw.F, X, S, rw.sf_x, rw.sf_s, rw.sf_e)) ||
          !tileable(rw.out, X, I, rw.so_x, rw.so_i, rw.so_e)) {
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
    // blocks: as many as the card holds at once, split among the rows,
    // each taking a run of whole blocks of block_long elements; a computing
    // warp per i group, at most kConsumers, and the copying warp
    const int sms = std::max(1, sm_count(device));
    const int per_sm = smem <= kTwoBlockSmem ? 2 : 1;
    const long long runs = std::max(1LL, std::min(
        nblocks, static_cast<long long>(per_sm) * sms / nrows));
    const int groups = (I + kIB - 1) / kIB;
    const int consumers = std::min(groups, kConsumers);
    const dim3 tgrid(static_cast<unsigned>(runs), static_cast<unsigned>(nrows));
    kernel<<<tgrid, 32 * (consumers + 1), smem, st>>>(
        rows, I, J, E, block_long, nblocks, stages);
    return static_cast<int>(cudaGetLastError());
  }

  const size_t smem = dg_rows_f32_smem_bytes(S, I, J, us);
  void (*kernel)(const DGRows, int, int, int, int, long long, int) =
      us ? dg_rows_f32_kernel<true> : dg_rows_f32_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(rows, X, S, I, J, E, block_long);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
