// tc_grid_f32: one dense tensor-contraction step,
//
//     C[out] = sum_K A[...] * B[...]
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::_build_multigrid
// (K2): a concrete tensor contraction gridded over a tuple of output letters,
// each grid cell computing its slice of the output and writing it once, in
// place, in the output's stored layout.  It is GETT-style: the letters of the
// step are classified on the host (ops/kernels.py) into
//
//   rows (M): output letters of the row operand only,
//   cols (N): output letters of the column operand only,
//   K:        letters contracted between the two operands,
//   cells:    the descriptor's grid letters (with their blocks) and the batch
//             letters, walked by the CUDA grid outside the tile,
//
// and every axis arrives as offset tables built once per plan (int32 when
// every tensor spans fewer than 2**31 elements, else int64): row ->
// (offset in A, offset in C), column -> (B, C), k -> (A, B), cell -> (A, B,
// C).  The kernel addresses A[base_a + off_am[m] + off_ak[k]] with no div or
// mod over letters, so any stored permutation of any operand works and C is
// written where the output's stored layout puts it, with no transpose before
// or after.
//
// Design.  A thread block computes a BM x BN tile of one cell's (rows x
// columns) output with 256 threads (16 x 16), each holding a TM x TN register
// tile (BM = 16 TM, BN = 16 TN; four instantiations, chosen on the host from
// the cell's shape).  A thread owns groups of up to four consecutive rows
// (and columns), read from shared memory as one float4 (or float2).  K is
// staged kBK = 8 at a time in a ring of three shared-memory buffers filled by
// cp.async two stages ahead of the FMAs, one barrier per stage, so the loads
// hold no registers and their latency hides behind two stages of FMAs.  Each
// element load's
// thread mapping follows the operand's stride-1 letter (along k or along
// the row/column), so the loads are coalesced where the layout allows.  The
// output tile goes back through shared memory a group of rows at a time,
// and the lanes of a warp then store along the side whose fastest letter is
// the output's stride-1 letter: the in-place write is coalesced.  Ragged
// edges of M, N and K are predicated (zero-filled in shared memory).  IEEE
// fp32 FMAs on the CUDA cores, no TF32: the float32 oracle is 2e-5.
//
// What bounds it on an H100.  The TCCG rows are mostly bound by device
// memory (tccg_35 writes a 151 MB output from two 0.6 MB operands: 45 us at
// 3.35 TB/s against 27 us of fp32 FMA); tccg_21 (K = 5184) by fp32 FMA
// (4.16 ms at 67 TFLOP/s).  Per k the 8 x 8 tile issues four vector
// shared-memory loads for 64 FMAs.  No TMA and no tensor cores (3xTF32)
// yet: later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads per block
constexpr int kBK = 8;          // contracted indices per shared-memory stage
constexpr int kStages = 3;      // stages in flight: cp.async runs 2 ahead

// flags
constexpr int kAKFast = 1;      // A's fastest letter is a k letter
constexpr int kBKFast = 2;      // B's fastest letter is a k letter
constexpr int kStoreMFast = 4;  // C's fastest letter is a row letter
constexpr int kOffsets32 = 8;   // the tables hold int32 offsets (else int64)

// Off: the offsets' type, int when every tensor spans fewer than 2**31
// elements (fewer registers and integer instructions), else long long
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

// G consecutive floats of shared memory into registers (G = 4, 2 or 1;
// the address is aligned to G floats)
template <int G>
__device__ __forceinline__ void load_group(const float* src, float* dst) {
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else if constexpr (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = *src;
  }
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

// blocks per SM the register budget must allow: two for the 8 x 8 tile
// (its 64 accumulators), three for the smaller ones
template <int TM, int TN>
constexpr int kMinBlocks = TM * TN >= 64 ? 2 : 3;

template <typename Off, int TM, int TN>
__global__ void __launch_bounds__(kThreads, (kMinBlocks<TM, TN>))
tc_grid_f32_kernel(const TcArgs<Off> p) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  // a thread's rows: TM / GM groups of GM consecutive rows, 16 GM apart
  constexpr int GM = TM < 4 ? TM : 4;
  constexpr int GN = TN < 4 ? TN : 4;
  constexpr int SA = BM + 4;            // shared row strides, 16-byte multiples
  constexpr int SB = BN + 4;
  constexpr int kStage = kBK * (SA + SB);
  constexpr int kChunkRows = 16 * GM;   // output rows per write-back chunk
  constexpr int SC = BN + 1;
  constexpr int kChunk = kChunkRows * SC;
  constexpr int kSmem =
      kStages * kStage > kChunk ? kStages * kStage : kChunk;
  constexpr int LA = BM * kBK / kThreads;   // A elements a thread stages
  constexpr int LB = BN * kBK / kThreads;
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

  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
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
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int g = 0; g < TM / GM; ++g) {
        load_group<GM>(as + k * SA + g * 16 * GM + ty * GM, a + g * GM);
      }
#pragma unroll
      for (int g = 0; g < TN / GN; ++g) {
        load_group<GN>(bs + k * SB + g * 16 * GN + tx * GN, b + g * GN);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
  copy_wait<0>();
  __syncthreads();

  // write-back, one group of rows at a time through shared memory, so that
  // a warp's stores run along the output's stride-1 letter
  float* cs = smem;
#pragma unroll
  for (int g = 0; g < TM / GM; ++g) {
#pragma unroll
    for (int r = 0; r < GM; ++r) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = (j / GN) * 16 * GN + tx * GN + j % GN;
        cs[(ty * GM + r) * SC + n] = acc[g * GM + r][j];
      }
    }
    __syncthreads();
    if (store_m_fast) {
      // a thread keeps one row and walks columns kThreads / kChunkRows apart
      const int ml = tid % kChunkRows;
      const int m = g * kChunkRows + ml;
      const Off cm = cm_sh[m];
      if (m0 + m < p.Mc) {
#pragma unroll 4
        for (int n = tid / kChunkRows; n < BN; n += kThreads / kChunkRows) {
          if (n0 + n < p.Nc) C[cm + cn_sh[n]] = cs[ml * SC + n];
        }
      }
    } else {
      // a thread keeps one column and walks rows kThreads / BN apart
      const int n = tid % BN;
      const Off cn = cn_sh[n];
      if (n0 + n < p.Nc) {
#pragma unroll 4
        for (int ml = tid / BN; ml < kChunkRows; ml += kThreads / BN) {
          const int m = g * kChunkRows + ml;
          if (m0 + m < p.Mc) C[cm_sh[m] + cn] = cs[ml * SC + n];
        }
      }
    }
    __syncthreads();
  }
}

// tile variants: (TM, TN) per thread
constexpr int kVariants = 4;
constexpr int kTM[kVariants] = {8, 4, 8, 2};
constexpr int kTN[kVariants] = {8, 4, 2, 8};

template <typename Off, int TM, int TN>
int launch(const TcArgs<Off>& args, long long ncells, cudaStream_t stream) {
  constexpr int BM = 16 * TM;
  constexpr int BN = 16 * TN;
  TcArgs<Off> p = args;
  p.tiles_m = (p.Mc + BM - 1) / BM;
  p.tiles_n = (p.Nc + BN - 1) / BN;
  const long long nblocks =
      ncells * static_cast<long long>(p.tiles_m) * p.tiles_n;
  if (nblocks < 1 || nblocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  tc_grid_f32_kernel<Off, TM, TN><<<static_cast<unsigned>(nblocks), kThreads,
                                    0, stream>>>(p);
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
    case 0: return launch<Off, 8, 8>(p, ncells, stream);
    case 1: return launch<Off, 4, 4>(p, ncells, stream);
    case 2: return launch<Off, 8, 2>(p, ncells, stream);
    case 3: return launch<Off, 2, 8>(p, ncells, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Rows and columns of a thread block's output tile for a variant, or -1.
int tc_grid_f32_tile_rows(int variant) {
  return variant >= 0 && variant < kVariants ? 16 * kTM[variant] : -1;
}

int tc_grid_f32_tile_cols(int variant) {
  return variant >= 0 && variant < kVariants ? 16 * kTN[variant] : -1;
}

// tables: one device array of offsets (in elements; int32 when flags has
// bit 3, else int64) holding, in order, off_am[Mc], off_cm[Mc], off_bn[Nc],
// off_cn[Nc], off_ak[K], off_bk[K], base_a[ncells], base_b[ncells],
// base_c[ncells].  flags: bit 0 A's fastest letter is a k letter, bit 1 the
// same for B, bit 2 the output's fastest letter is a row letter.  Returns
// the CUDA error of the launch (0 on success).
int tc_grid_f32(const float* A, const float* B, float* C, const void* tables,
                int Mc, int Nc, int K, long long ncells, int flags,
                int variant, void* stream) {
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
