// tc_grid_3xtf32: one dense tensor-contraction step on Hopper's tensor
// cores, f32 by three TF32 passes over a hi/lo split,
//
//     C[out] = sum_K A[...] * B[...]
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::_build_multigrid
// (K2) when the schedule's precision is "bf16_3x": there the step's dot runs
// feinsum_tpu/ops/kernel_lowering.py::_dot_bf16_3x, three bf16 MXU passes,
// hi*hi + hi*lo + lo*hi.  Here each f32 operand x splits into hi = tf32(x)
// and lo = tf32(x - hi) (round to nearest, ties away from zero, on the bit
// pattern: cvt.rna.tf32.f32's rounding; the low 13 bits zero), and each
// k-step runs lo*hi, hi*lo and hi*hi as mma.sync.aligned.m16n8k8 TF32
// products.  A product of two TF32 values is exact in f32; the split loses
// lo*lo and lo's own rounding, about 2**-21 of each product.
//
// It takes the same steps, offset tables and flags as tc_grid_f32
// (csrc/tc_grid.cu, classified on the host by ops/kernels.py): rows (M),
// columns (N) and contracted letters (K) arrive as offset tables, cells
// (the grid letters and the batch letters) as base offsets, so any stored
// permutation of any operand works and C is written once, in place, in its
// stored layout.  The four tile variants are tc_grid_f32's.
//
// Design.  A thread block computes a BM x BN tile of one cell with 8 warps
// laid out WM x WN; each warp owns (BM / WM) x (BN / WN) outputs as m16n8
// fragments.  K is staged 8 at a time (one k-step) in a ring of three
// shared-memory buffers filled by cp.async two stages ahead, as in
// tc_grid_f32, with each element load's thread mapping following the
// operand's stride-1 letter.  Fragments are read from shared memory at row
// strides that are 8 mod 32 floats (conflict-free) and split as they are
// read.  Per k-step the three products of a fragment accumulate into a
// fresh fragment that is added to the running sum in IEEE f32 (the tensor
// cores' accumulate truncates, and over K = 5184, tccg_21, a running sum
// carried by them would drift by ulps per k-step); each pass runs over all
// n tiles of a warp before the next, so consecutive products are
// independent.  The output tile goes back through shared memory one m16
// tile of every warp row at a time; the lanes of a warp then store along
// the side whose fastest letter is the output's stride-1 letter (the
// staging is transposed for a row-fast output), so the in-place write is
// coalesced.  Ragged edges of M, N and K are zero-filled by cp.async and
// predicated on the store.  (Staging through registers, split once per
// element into hi and lo planes, measured slower on every TCCG row: PERF.md,
// PR 6.)
//
// What bounds it on an H100.  Three TF32 passes give about 165 TFLOP/s of
// f32 (495 / 3) where f32 FMA gives 67: tccg_21 (K = 5184, 4.16 ms of f32
// FMA) has about 1.7 ms of tensor-core work, and the byte-bound TCCG rows
// stay bound by device memory.  mma.sync from a cp.async ring, one k-step
// per barrier, with the split done per fragment (the instructions per MMA,
// not the MMAs, bound it), reaches well under the tensor cores' peak;
// wgmma, TMA and persistent blocks are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kBK = 8;          // contracted indices per stage: one k-step
constexpr int kStages = 3;      // stages in flight: cp.async runs 2 ahead

// flags (those of csrc/tc_grid.cu)
constexpr int kAKFast = 1;      // A's fastest letter is a k letter
constexpr int kBKFast = 2;      // B's fastest letter is a k letter
constexpr int kStoreMFast = 4;  // C's fastest letter is a row letter
constexpr int kOffsets32 = 8;   // the tables hold int32 offsets (else int64)

template <typename Off>
struct TcArgs {
  const float* A;
  const float* B;
  float* C;
  const Off* off_am;  // [Mc] row -> offset in A
  const Off* off_cm;  // [Mc] row -> offset in C
  const Off* off_bn;  // [Nc] column -> offset in B
  const Off* off_cn;  // [Nc] column -> offset in C
  const Off* off_ak;  // [K]  k -> offset in A
  const Off* off_bk;  // [K]  k -> offset in B
  const Off* base_a;  // [ncells] cell -> offset in A
  const Off* base_b;  // [ncells]
  const Off* base_c;  // [ncells]
  int Mc, Nc, K;
  int tiles_m, tiles_n;
  int flags;
};

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

template <typename Off, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(kThreads, 2)
tc_grid_3xtf32_kernel(const TcArgs<Off> p) {
  static_assert(WM * WN * 32 == kThreads, "8 warps per block");
  constexpr int MT = BM / WM / 16;      // m16 tiles per warp
  constexpr int NT = BN / WN / 8;       // n8 tiles per warp
  constexpr int SA = BM + 8;            // shared row strides, 8 mod 32 floats
  constexpr int SB = BN + 8;
  constexpr int kStage = kBK * (SA + SB);
  constexpr int CR = 16 * WM;           // output rows per write-back chunk
  constexpr int SCR = BN + 8;           // chunk [row][column] pitch
  constexpr int SCC = CR + 4;           // chunk [column][row] pitch
  constexpr int kChunk = CR * SCR > BN * SCC ? CR * SCR : BN * SCC;
  constexpr int kSmem =
      kStages * kStage > kChunk ? kStages * kStage : kChunk;
  constexpr int LA = BM * kBK / kThreads;   // A elements a thread stages
  constexpr int LB = BN * kBK / kThreads;
  static_assert(MT >= 1 && NT >= 1 && LA >= 1 && LB >= 1, "tile shape");
  __shared__ __align__(16) float smem[kSmem];
  __shared__ Off am_sh[BM];
  __shared__ Off cm_sh[BM];
  __shared__ Off bn_sh[BN];
  __shared__ Off cn_sh[BN];

  const int tid = threadIdx.x;
  long long blk = blockIdx.x;
  const int tile_n = static_cast<int>(blk % p.tiles_n);
  blk /= p.tiles_n;
  const int tile_m = static_cast<int>(blk % p.tiles_m);
  const long long cell = blk / p.tiles_m;
  const int m0 = tile_m * BM;
  const int n0 = tile_n * BN;
  const float* A = p.A + p.base_a[cell];
  const float* B = p.B + p.base_b[cell];
  float* C = p.C + p.base_c[cell];

  for (int i = tid; i < BM; i += kThreads) {
    const bool in = m0 + i < p.Mc;
    am_sh[i] = in ? p.off_am[m0 + i] : 0;
    cm_sh[i] = in ? p.off_cm[m0 + i] : 0;
  }
  for (int j = tid; j < BN; j += kThreads) {
    const bool in = n0 + j < p.Nc;
    bn_sh[j] = in ? p.off_bn[n0 + j] : 0;
    cn_sh[j] = in ? p.off_cn[n0 + j] : 0;
  }
  __syncthreads();

  const bool a_k_fast = (p.flags & kAKFast) != 0;
  const bool b_k_fast = (p.flags & kBKFast) != 0;
  const bool store_m_fast = (p.flags & kStoreMFast) != 0;

  // stage `buf` of the ring: the A and B elements of k0 .. k0 + kBK,
  // copied asynchronously from device memory into shared memory
  auto issue = [&](int buf, int k0) {
    float* as = smem + buf * kStage;
    float* bs = as + kBK * SA;
#pragma unroll
    for (int r = 0; r < LA; ++r) {
      const int idx = tid + r * kThreads;
      const int m = a_k_fast ? idx / kBK : idx % BM;
      const int k = a_k_fast ? idx % kBK : idx / BM;
      const bool valid = m0 + m < p.Mc && k0 + k < p.K;
      copy_async(as + k * SA + m,
                 valid ? A + am_sh[m] + __ldg(p.off_ak + k0 + k) : A, valid);
    }
#pragma unroll
    for (int r = 0; r < LB; ++r) {
      const int idx = tid + r * kThreads;
      const int n = b_k_fast ? idx / kBK : idx % BN;
      const int k = b_k_fast ? idx % kBK : idx / BN;
      const bool valid = n0 + n < p.Nc && k0 + k < p.K;
      copy_async(bs + k * SB + n,
                 valid ? B + bn_sh[n] + __ldg(p.off_bk + k0 + k) : B, valid);
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;    // the fragment's row group
  const int tig = lane & 3;     // the thread in the group
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int mw = wm * MT * 16;  // the warp's first row and column in the tile
  const int nw = wn * NT * 8;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
    }
  }

  // every thread commits one group per stage, empty past the end of K, so
  // that the group counts stay uniform
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s * kBK < p.K) issue(s, s * kBK);
    copy_commit();
  }
  for (int s = 0; s * kBK < p.K; ++s) {
    copy_wait<kStages - 2>();   // this thread's copies of stage s landed
    __syncthreads();            // everyone's; and stage s - 1 is consumed
    const int next = s + kStages - 1;
    if (next * kBK < p.K) issue(next % kStages, next * kBK);
    copy_commit();
    const float* as = smem + (s % kStages) * kStage;
    const float* bs = as + kBK * SA;
    // B fragments (k x n): (tig, gid), (tig + 4, gid)
    float bhi[NT][2], blo[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = nw + j * 8 + gid;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = bs[(tig + 4 * h) * SB + n];
        bhi[j][h] = tf32_round(v);
        blo[j][h] = tf32_round(v - bhi[j][h]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      // A fragment (m x k): (gid, tig), (gid + 8, tig), (gid, tig + 4),
      // (gid + 8, tig + 4)
      const float* a_ = as + tig * SA + mw + i * 16 + gid;
      const float a[4] = {a_[0], a_[8], a_[4 * SA], a_[4 * SA + 8]};
      float ahi[4], alo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ahi[q] = tf32_round(a[q]);
        alo[q] = tf32_round(a[q] - ahi[q]);
      }
      // lo*hi, hi*lo, hi*hi (the small terms first) into fresh fragments,
      // each pass over every n tile before the next, so that consecutive
      // products are independent; then added to the sums in f32
      float d[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(d[j], alo, bhi[j][0], bhi[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(d[j], ahi, blo[j][0], blo[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) mma_tf32(d[j], ahi, bhi[j][0], bhi[j][1]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += d[j][q];
      }
    }
  }
  copy_wait<0>();
  __syncthreads();

  // write-back, one m16 tile of every warp row (CR rows) at a time through
  // shared memory; chunk row r is tile row (r / 16) * MT * 16 + i * 16 + r % 16
  float* cs = smem;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = wm * 16 + gid;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      // C fragment (m x n): (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, ...)
      const int n = nw + j * 8 + 2 * tig;
      if (store_m_fast) {
        cs[n * SCC + r] = acc[i][j][0];
        cs[(n + 1) * SCC + r] = acc[i][j][1];
        cs[n * SCC + r + 8] = acc[i][j][2];
        cs[(n + 1) * SCC + r + 8] = acc[i][j][3];
      } else {
        *reinterpret_cast<float2*>(cs + r * SCR + n) =
            make_float2(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<float2*>(cs + (r + 8) * SCR + n) =
            make_float2(acc[i][j][2], acc[i][j][3]);
      }
    }
    __syncthreads();
    if (store_m_fast) {
      // a thread keeps one row and walks columns kThreads / CR apart
      const int rl = tid % CR;
      const int m = (rl / 16) * MT * 16 + i * 16 + rl % 16;
      if (m0 + m < p.Mc) {
        const Off cm = cm_sh[m];
#pragma unroll 4
        for (int n = tid / CR; n < BN; n += kThreads / CR) {
          if (n0 + n < p.Nc) C[cm + cn_sh[n]] = cs[n * SCC + rl];
        }
      }
    } else {
      // a thread keeps one column and walks rows kThreads / BN apart
      const int n = tid % BN;
      if (n0 + n < p.Nc) {
        const Off cn = cn_sh[n];
#pragma unroll 4
        for (int rl = tid / BN; rl < CR; rl += kThreads / BN) {
          const int m = (rl / 16) * MT * 16 + i * 16 + rl % 16;
          if (m0 + m < p.Mc) C[cm_sh[m] + cn] = cs[rl * SCR + n];
        }
      }
    }
    __syncthreads();
  }
}

// tile variants (those of csrc/tc_grid.cu): BM x BN outputs per block, on
// WM x WN warps
constexpr int kVariants = 4;
constexpr int kBM[kVariants] = {128, 64, 128, 32};
constexpr int kBN[kVariants] = {128, 64, 32, 128};

template <typename Off, int BM, int BN, int WM, int WN>
int launch(const TcArgs<Off>& args, long long ncells, cudaStream_t stream) {
  TcArgs<Off> p = args;
  p.tiles_m = (p.Mc + BM - 1) / BM;
  p.tiles_n = (p.Nc + BN - 1) / BN;
  const long long nblocks =
      ncells * static_cast<long long>(p.tiles_m) * p.tiles_n;
  if (nblocks < 1 || nblocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tc_grid_3xtf32_kernel<Off, BM, BN, WM, WN>
      <<<static_cast<unsigned>(nblocks), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename Off>
int dispatch(const float* A, const float* B, float* C, const void* tables,
             int Mc, int Nc, int K, long long ncells, int flags, int variant,
             cudaStream_t stream) {
  TcArgs<Off> p{};
  p.A = A;
  p.B = B;
  p.C = C;
  p.off_am = static_cast<const Off*>(tables);
  p.off_cm = p.off_am + Mc;
  p.off_bn = p.off_cm + Mc;
  p.off_cn = p.off_bn + Nc;
  p.off_ak = p.off_cn + Nc;
  p.off_bk = p.off_ak + K;
  p.base_a = p.off_bk + K;
  p.base_b = p.base_a + ncells;
  p.base_c = p.base_b + ncells;
  p.Mc = Mc;
  p.Nc = Nc;
  p.K = K;
  p.flags = flags;
  switch (variant) {
    case 0: return launch<Off, 128, 128, 2, 4>(p, ncells, stream);
    case 1: return launch<Off, 64, 64, 2, 4>(p, ncells, stream);
    case 2: return launch<Off, 128, 32, 4, 2>(p, ncells, stream);
    case 3: return launch<Off, 32, 128, 2, 4>(p, ncells, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Rows and columns of a thread block's output tile for a variant, or -1.
int tc_grid_3xtf32_tile_rows(int variant) {
  return variant >= 0 && variant < kVariants ? kBM[variant] : -1;
}

int tc_grid_3xtf32_tile_cols(int variant) {
  return variant >= 0 && variant < kVariants ? kBN[variant] : -1;
}

// The arguments of tc_grid_f32 (csrc/tc_grid.cu): tables holds, in order,
// off_am[Mc], off_cm[Mc], off_bn[Nc], off_cn[Nc], off_ak[K], off_bk[K],
// base_a[ncells], base_b[ncells], base_c[ncells] (int32 when flags has bit
// 3, else int64).  Returns the CUDA error of the launch (0 on success).
int tc_grid_3xtf32(const float* A, const float* B, float* C,
                   const void* tables, int Mc, int Nc, int K, long long ncells,
                   int flags, int variant, void* stream) {
  if (Mc < 1 || Nc < 1 || K < 1 || ncells < 1 || tables == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (flags & kOffsets32) {
    return dispatch<int>(A, B, C, tables, Mc, Nc, K, ncells, flags, variant,
                         s);
  }
  return dispatch<long long>(A, B, C, tables, Mc, Nc, K, ncells, flags,
                             variant, s);
}

}  // extern "C"
