// probe_apply_f32 / probe_apply_3xtf32: the contraction probe,
//
//     out_b[i, e] = sigma(i, e) * sum_{s<S} J_b[s, e]
//                                 * sum_{j<K} R[s, i, j] * u_b[j, e]
//
// for b <= 3 rows in one launch (R shared, u, J, sigma and out per row).
//
// Replaces the TPU probes' contraction kernels, hand-written Pallas kernels
// that measured a v5e's matrix unit on DG-shaped dots in one layout or
// another (scripts/):
//
// * the matvec out = D @ u at ndof 20 and 35, element-major (E, nd),
//   dof-major (nd, E) and folded (nd, 8, E / 8) merged (I) or per-run (III):
//   tpu_layout_probe.py:101, :119; tpu_fold_probe.py:117;
//   tpu_fold_probe2.py:102, :123; tpu_fold_probe3.py:95, :109;
//   tpu_fold_probe4.py:95, :110, :201; tpu_fold_probe5.py:87, :102, :187;
// * the kron matvec (D kron I_8) @ u over (8 nd, E / 8), optionally times
//   jac[f, c]: tpu_fold_probe.py:162; tpu_fold_probe3.py:122;
//   tpu_kron_probe.py:62 (R = kron(D, I_8), sigma = jac);
// * the div sum_s J_s * (D_s @ u), S = 3, b = 1 or 3 rows in one kernel:
//   tpu_fold_probe2.py:191; tpu_fold_probe3.py:158, :183;
//   tpu_fold_probe4.py:144, :163; tpu_fold_probe5.py:133, :151;
// * tpu_lane_reshape_probe.py:52, kernels C ((x @ K) * j broadcast over d:
//   R = K^T, sigma = j) and D (x @ K).
//
// u, J, sigma and out are strided (row, element) views, so one kernel takes
// every storage; sigma is a view over the output's rows split in two,
// i = i1 * I2 + i2, and the elements.  The elements a thread block takes are
// `runs` runs of n elements, run r at r * run + (block) * n: runs = 1 is a
// contiguous range (the dof-major tiling, and the folded mapping III, whose
// blocks stay inside one run), runs = 8 the folded mapping I (a block takes
// n elements from each of the 8 runs of the merged view).
//
// Design: a tiled product with a strided B.  A block owns a TI x 128 output
// tile (TI = 8 * RT rows, RT = ceil(I / 8) up to 8, so ndof 35 takes one
// 40-row tile and R = 640 x 640 ten 64-row tiles) and walks the chunks
// (s, 16 j's) of the K-folded sum: R's and u's chunks go into a ring of three
// shared-memory stages filled by cp.async two chunks ahead (16 bytes per
// thread where u's element axis is contiguous and aligned, else 4 with the
// lanes along u's stride-1 axis), so neither R (up to 1.6 MB) nor u has to
// fit in a block.  After each s's last chunk the s-partial is weighted by
// J_b[s, e] in registers.  The epilogue multiplies by sigma and writes the
// tile: directly as float4 where out's element axis is contiguous, else
// through shared memory with the lanes along out's stride-1 axis.
//
// * probe_apply_f32: each thread owns RT rows (8 apart) x 4 elements; per j
//   it reads RT broadcast R values and one float4 of u from shared memory
//   and issues 4 RT FMAs in IEEE f32.
// * probe_apply_3xtf32: the dot on Hopper's tensor cores, three TF32
//   mma.sync.aligned.m16n8k8 passes (lo*hi + hi*lo + hi*hi) over the split
//   hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away, on the bit
//   pattern: cvt.rna.tf32.f32's rounding), as csrc/dg_rows_3x.cu and
//   csrc/tc_grid_3x.cu do (their helpers are copied here, so that they stay
//   as they are).  Each warp owns 16 elements (M) x TI rows (N = 8 per
//   tile); each k-step's three products go into a fresh fragment that is
//   added to the sum in IEEE f32 (the tensor cores' accumulate truncates).
//
// What bounds it on an H100.  The matvec and the div at ndof 20-35 sit below
// the fp32 ridge (about 20 flop per byte): bytes, 0.0876 ms for the matvec
// at ndof 35 and E = 2^20.  The kron matvec (K = 8 nd) and lane-reshape C
// and D (K = g d, up to 640) are dense products: operations, 0.307 ms of
// f32 FMA for the kron matvec at ndof 35.  The simple design keeps u's
// loads in flight through the ring and every R value in shared memory; the
// f32 kernel is then bound by its shared-memory reads (RT + 1 per 4 RT
// FMAs), the 3x kernel by the split and fragment loads per MMA.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kTE = 128;        // elements per sub-tile
constexpr int kKC = 16;         // contracted indices per stage
constexpr int kStages = 3;      // stages in flight: cp.async runs 2 ahead
constexpr int kSU = kTE + 8;    // u chunk pitch, 8 mod 32 floats
constexpr int kMaxRows = 3;
constexpr int kMaxS = 3;
constexpr int kMaxDim = 2048;   // the most rows (I) and j's (K) R may have

// flags
constexpr int kUVec = 1;          // u staged 16 bytes at a time
constexpr int kUKFast = 2;        // u's stride-1 axis is j
constexpr int kOutElemMajor = 4;  // out's stride-1 axis is i
constexpr int kOutVec = 8;        // out stored as float4 (f32 kernel)
constexpr int kHasJ = 16;
constexpr int kHasSigma = 32;

struct RowPtrs {
  const float* u;
  const float* J;
  const float* sigma;
  float* out;
};

struct ApplyArgs {
  RowPtrs row[kMaxRows];
  const float* R;              // (S, I, K), contiguous
  int S, I, K;
  long long su_k, su_e;        // u strides
  long long sj_s, sj_e;        // J strides
  long long sg_1, sg_2, sg_e;  // sigma strides over (i / I2, i % I2, e)
  int I2;
  long long so_i, so_e;        // out strides
  long long run;               // elements per run
  int runs;                    // runs a block takes its elements from
  int n;                       // elements per run per block
  int nsub;                    // kTE sub-tiles per block
  int tiles_i;                 // row tiles
  int flags;
};

// R's chunk pitch for TI rows: the smallest >= TI that is 8 mod 32 floats
__host__ __device__ constexpr int r_pitch(int ti) {
  return ti + (((8 - ti) % 32) + 32) % 32;
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// the element of local index l of element block eb, or -1 past the end
__device__ __forceinline__ long long elem(const ApplyArgs& p, long long eb,
                                          int l) {
  if (l >= p.runs * p.n) return -1;
  const int f = l / p.n;
  const long long c = eb * p.n + (l - f * p.n);
  return c < p.run ? f * p.run + c : -1;
}

__device__ __forceinline__ float sigma_at(const ApplyArgs& p,
                                          const float* sigma, int i,
                                          long long e) {
  return __ldg(sigma + (i / p.I2) * p.sg_1 + (i % p.I2) * p.sg_2 +
               e * p.sg_e);
}

// one float (or four) from device to shared memory, asynchronously; a false
// `valid` writes zeros and reads nothing
__device__ __forceinline__ void copy_async4(float* dst, const float* src,
                                            bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void copy_async16(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32: to nearest, ties away from zero, on the bit pattern
// (cvt.rna.tf32.f32's rounding); infinities and NaN pass unchanged
__device__ __forceinline__ float tf32_round(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

// d += a * b: one m16n8k8 TF32 product on the tensor cores, f32 accumulate
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

// Stage chunk c (s = c / nk, j from (c % nk) * kKC) of the sub-tile at l0
// into ring buffer `stage`: R's TI x kKC slab as [j][i], u's kKC x kTE slab
// as [j][l]; zeros past I, K and the block's elements.
template <int TI>
__device__ __forceinline__ void issue(const ApplyArgs& p, const float* u,
                                      float* stage, int c, int nk, int i0,
                                      long long eb, int l0) {
  constexpr int SR = r_pitch(TI);
  const int tid = threadIdx.x;
  const int s = c / nk;
  const int k0 = (c - s * nk) * kKC;
  float* rs = stage;
  float* us = stage + kKC * SR;
  for (int idx = tid; idx < TI * kKC; idx += kThreads) {
    const int k = idx % kKC;
    const int i = idx / kKC;
    const bool valid = i0 + i < p.I && k0 + k < p.K;
    copy_async4(rs + k * SR + i,
                valid ? p.R + (static_cast<long long>(s) * p.I + i0 + i) *
                                  p.K + k0 + k
                      : p.R,
                valid);
  }
  if (p.flags & kUVec) {
    for (int idx = tid; idx < kKC * kTE / 4; idx += kThreads) {
      const int l = (idx % (kTE / 4)) * 4;
      const int k = idx / (kTE / 4);
      const long long e = elem(p, eb, l0 + l);
      const bool valid = e >= 0 && k0 + k < p.K;
      copy_async16(us + k * kSU + l, valid ? u + (k0 + k) * p.su_k + e : u,
                   valid);
    }
  } else {
    const bool k_fast = (p.flags & kUKFast) != 0;
    for (int idx = tid; idx < kKC * kTE; idx += kThreads) {
      const int k = k_fast ? idx % kKC : idx / kTE;
      const int l = k_fast ? idx / kKC : idx % kTE;
      const long long e = elem(p, eb, l0 + l);
      const bool valid = e >= 0 && k0 + k < p.K;
      copy_async4(us + k * kSU + l,
                  valid ? u + (k0 + k) * p.su_k + e * p.su_e : u, valid);
    }
  }
}

// t[a][q] += R[j][row tr + 8 a] * u[j][element 4 te + q] for one j of the
// staged chunk
template <int RT, int SR>
__device__ __forceinline__ void fma_row(float (&t)[RT][4], const float* rs,
                                        const float* us, int k, int te,
                                        int tr) {
  const float4 uv = *reinterpret_cast<const float4*>(us + k * kSU + te * 4);
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    const float r = rs[k * SR + tr + 8 * a];
    t[a][0] = fmaf(r, uv.x, t[a][0]);
    t[a][1] = fmaf(r, uv.y, t[a][1]);
    t[a][2] = fmaf(r, uv.z, t[a][2]);
    t[a][3] = fmaf(r, uv.w, t[a][3]);
  }
}

template <int RT>
__global__ void __launch_bounds__(kThreads, 2)
probe_apply_f32_kernel(const ApplyArgs p) {
  constexpr int TI = 8 * RT;
  constexpr int SR = r_pitch(TI);
  constexpr int kStage = kKC * (SR + kSU);
  constexpr int kOP = kTE + 4;  // the element-major write-back's [i][l] pitch
  constexpr int kSmem = cmax(kStages * kStage, TI * kOP);
  __shared__ __align__(16) float smem[kSmem];

  const int tid = threadIdx.x;
  const int ti = static_cast<int>(blockIdx.x % p.tiles_i);
  const long long eb = blockIdx.x / p.tiles_i;
  const int i0 = ti * TI;
  const RowPtrs rw = p.row[blockIdx.y];
  const int nk = (p.K + kKC - 1) / kKC;
  const int nc = p.S * nk;
  const int te = tid % 32;  // the thread's 4 elements: te * 4 + q
  const int tr = tid / 32;  // its rows: tr + 8 a

  for (int st = 0; st < p.nsub; ++st) {
    const int l0 = st * kTE;
    long long e4[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) e4[q] = elem(p, eb, l0 + te * 4 + q);
    float acc[RT][4], t[RT][4];
#pragma unroll
    for (int a = 0; a < RT; ++a) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][q] = t[a][q] = 0.f;
    }
    // one committed group per stage, empty past the end, so that the group
    // counts stay uniform
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nc) issue<TI>(p, rw.u, smem + c * kStage, c, nk, i0, eb, l0);
      copy_commit();
    }
    for (int c = 0; c < nc; ++c) {
      copy_wait<kStages - 2>();  // this thread's copies of chunk c landed
      __syncthreads();           // everyone's; and chunk c - 1 is consumed
      const int next = c + kStages - 1;
      if (next < nc) {
        issue<TI>(p, rw.u, smem + (next % kStages) * kStage, next, nk, i0,
                  eb, l0);
      }
      copy_commit();
      const float* rs = smem + (c % kStages) * kStage;
      const float* us = rs + kKC * SR;
      const int s = c / nk;
      // the j's of this chunk: a whole chunk unrolled, the last one of a
      // K that is no multiple of kKC (35 = 16 + 16 + 3) only its own
      const int kn = p.K - (c - s * nk) * kKC;
      if (kn >= kKC) {
#pragma unroll
        for (int k = 0; k < kKC; ++k) fma_row<RT, SR>(t, rs, us, k, te, tr);
      } else {
#pragma unroll 1
        for (int k = 0; k < kn; ++k) fma_row<RT, SR>(t, rs, us, k, te, tr);
      }
      if (c - s * nk == nk - 1) {  // s's last chunk: weight by J_b[s, e]
        float jv[4] = {1.f, 1.f, 1.f, 1.f};
        if (p.flags & kHasJ) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            jv[q] = e4[q] >= 0 ? __ldg(rw.J + s * p.sj_s + e4[q] * p.sj_e)
                               : 0.f;
          }
        }
#pragma unroll
        for (int a = 0; a < RT; ++a) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[a][q] = fmaf(jv[q], t[a][q], acc[a][q]);
            t[a][q] = 0.f;
          }
        }
      }
    }
    copy_wait<0>();
    __syncthreads();

    const bool has_sigma = (p.flags & kHasSigma) != 0;
    if (p.flags & kOutElemMajor) {
      // through shared memory, [i][l]; then the lanes along i
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const int i = i0 + tr + 8 * a;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = acc[a][q];
          if (has_sigma && i < p.I && e4[q] >= 0) {
            v[q] *= sigma_at(p, rw.sigma, i, e4[q]);
          }
        }
        *reinterpret_cast<float4*>(smem + (tr + 8 * a) * kOP + te * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();
      for (int idx = tid; idx < TI * kTE; idx += kThreads) {
        const int i = idx % TI;
        const int l = idx / TI;
        const long long e = elem(p, eb, l0 + l);
        if (i0 + i < p.I && e >= 0) {
          rw.out[(i0 + i) * p.so_i + e * p.so_e] = smem[i * kOP + l];
        }
      }
    } else {
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        const int i = i0 + tr + 8 * a;
        if (i >= p.I) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = acc[a][q];
          if (has_sigma && e4[q] >= 0) v[q] *= sigma_at(p, rw.sigma, i, e4[q]);
        }
        if ((p.flags & kOutVec) && e4[0] >= 0) {
          *reinterpret_cast<float4*>(rw.out + i * p.so_i + e4[0]) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (e4[q] >= 0) rw.out[i * p.so_i + e4[q] * p.so_e] = v[q];
          }
        }
      }
    }
    __syncthreads();  // the ring (or the write-back tile) is free again
  }
}

// (no second block per SM asked for: at NT = 8 the fragments and the two
// sums take more than the 128 registers that would leave)
template <int NT>
__global__ void __launch_bounds__(kThreads)
probe_apply_3xtf32_kernel(const ApplyArgs p) {
  constexpr int TI = 8 * NT;
  constexpr int SR = r_pitch(TI);
  constexpr int kStage = kKC * (SR + kSU);
  constexpr int kOP = TI + 1;  // the write-back's [l][i] pitch
  constexpr int kSmem = cmax(kStages * kStage, kTE * kOP);
  __shared__ __align__(16) float smem[kSmem];

  const int tid = threadIdx.x;
  const int ti = static_cast<int>(blockIdx.x % p.tiles_i);
  const long long eb = blockIdx.x / p.tiles_i;
  const int i0 = ti * TI;
  const RowPtrs rw = p.row[blockIdx.y];
  const int nk = (p.K + kKC - 1) / kKC;
  const int nc = p.S * nk;
  const int lane = tid & 31;
  const int gid = lane >> 2;      // the fragment's row group
  const int tig = lane & 3;       // the thread in the group
  const int m0 = (tid >> 5) * 16; // the warp's 16 elements

  for (int st = 0; st < p.nsub; ++st) {
    const int l0 = st * kTE;
    // the elements of the thread's accumulator rows: m0 + gid (+ 8)
    const long long e2[2] = {elem(p, eb, l0 + m0 + gid),
                             elem(p, eb, l0 + m0 + gid + 8)};
    float acc[NT][4], t[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = t[j][q] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < kStages - 1; ++c) {
      if (c < nc) issue<TI>(p, rw.u, smem + c * kStage, c, nk, i0, eb, l0);
      copy_commit();
    }
    for (int c = 0; c < nc; ++c) {
      copy_wait<kStages - 2>();
      __syncthreads();
      const int next = c + kStages - 1;
      if (next < nc) {
        issue<TI>(p, rw.u, smem + (next % kStages) * kStage, next, nk, i0,
                  eb, l0);
      }
      copy_commit();
      const float* rs = smem + (c % kStages) * kStage;
      const float* us = rs + kKC * SR;
      // the k-steps of 8 this chunk holds j's for (zeros past K)
      const int kn = p.K - (c - (c / nk) * nk) * kKC;
#pragma unroll 2
      for (int kk = 0; kk < kKC && kk < kn; kk += 8) {
        // A (m = element, k = j): (gid, tig), (gid + 8, tig), (gid, tig +
        // 4), (gid + 8, tig + 4)
        const float* a_ = us + (kk + tig) * kSU + m0 + gid;
        const float a[4] = {a_[0], a_[8], a_[4 * kSU], a_[4 * kSU + 8]};
        float ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ahi[q] = tf32_round(a[q]);
          alo[q] = tf32_round(a[q] - ahi[q]);
        }
        // B (k = j, n = row): (tig, gid), (tig + 4, gid)
        float bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = rs[(kk + tig + 4 * h) * SR + 8 * j + gid];
            bhi[j][h] = tf32_round(v);
            blo[j][h] = tf32_round(v - bhi[j][h]);
          }
        }
        // lo*hi, hi*lo, hi*hi (the small terms first) into fresh
        // fragments, each pass over every n tile before the next; then
        // added to the sums in f32
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
          for (int q = 0; q < 4; ++q) t[j][q] += d[j][q];
        }
      }
      const int s = c / nk;
      if (c - s * nk == nk - 1) {
        float jv[2] = {1.f, 1.f};
        if (p.flags & kHasJ) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            jv[h] = e2[h] >= 0 ? __ldg(rw.J + s * p.sj_s + e2[h] * p.sj_e)
                               : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[j][q] = fmaf(jv[q >> 1], t[j][q], acc[j][q]);
            t[j][q] = 0.f;
          }
        }
      }
    }
    copy_wait<0>();
    __syncthreads();

    // write-back through shared memory, [l][i]; C fragment (m x n): (gid,
    // 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig), (gid + 8, 2 tig + 1)
    const bool has_sigma = (p.flags & kHasSigma) != 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = m0 + gid + 8 * (q >> 1);
        const int il = 8 * j + 2 * tig + (q & 1);
        float v = acc[j][q];
        if (has_sigma && i0 + il < p.I && e2[q >> 1] >= 0) {
          v *= sigma_at(p, rw.sigma, i0 + il, e2[q >> 1]);
        }
        smem[l * kOP + il] = v;
      }
    }
    __syncthreads();
    const bool i_fast = (p.flags & kOutElemMajor) != 0;
    for (int idx = tid; idx < TI * kTE; idx += kThreads) {
      const int i = i_fast ? idx % TI : idx / kTE;
      const int l = i_fast ? idx / TI : idx % kTE;
      const long long e = elem(p, eb, l0 + l);
      if (i0 + i < p.I && e >= 0) {
        rw.out[(i0 + i) * p.so_i + e * p.so_e] = smem[l * kOP + i];
      }
    }
    __syncthreads();
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <template <int> class Launch>
int dispatch(int rt, const ApplyArgs& p, dim3 grid, cudaStream_t s) {
  switch (rt) {
    case 1: return Launch<1>::run(p, grid, s);
    case 2: return Launch<2>::run(p, grid, s);
    case 3: return Launch<3>::run(p, grid, s);
    case 4: return Launch<4>::run(p, grid, s);
    case 5: return Launch<5>::run(p, grid, s);
    case 6: return Launch<6>::run(p, grid, s);
    case 7: return Launch<7>::run(p, grid, s);
    case 8: return Launch<8>::run(p, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int RT>
struct LaunchF32 {
  static int run(const ApplyArgs& p, dim3 grid, cudaStream_t s) {
    probe_apply_f32_kernel<RT><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int NT>
struct Launch3x {
  static int run(const ApplyArgs& p, dim3 grid, cudaStream_t s) {
    probe_apply_3xtf32_kernel<NT><<<grid, kThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
};

// Checks the arguments and fills the kernel's; the grid in *grid and the
// row-tile factor in *rt.  Returns 0 or cudaErrorInvalidValue.
int prepare(ApplyArgs* p, dim3* grid, int* rt, int nrows,
            void* const* us, void* const* Js, void* const* sigmas,
            void* const* outs, const void* R, int S, int I, int K,
            const long long* strides, int I2, long long run, int runs, int n,
            int flags) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nrows < 1 || nrows > kMaxRows || S < 1 || S > kMaxS || I < 1 ||
      I > kMaxDim || K < 1 || K > kMaxDim || I2 < 1 || run < 1 ||
      runs < 1 || n < 1 || R == nullptr) {
    return bad;
  }
  *p = ApplyArgs{};
  p->R = static_cast<const float*>(R);
  p->S = S;
  p->I = I;
  p->K = K;
  p->su_k = strides[0];
  p->su_e = strides[1];
  p->sj_s = strides[2];
  p->sj_e = strides[3];
  p->sg_1 = strides[4];
  p->sg_2 = strides[5];
  p->sg_e = strides[6];
  p->so_i = strides[7];
  p->so_e = strides[8];
  p->I2 = I2;
  p->run = run;
  p->runs = runs;
  p->n = n;
  p->flags = flags;
  const bool vec_e = n % 4 == 0 && run % 4 == 0;
  for (int b = 0; b < nrows; ++b) {
    p->row[b].u = static_cast<const float*>(us[b]);
    p->row[b].J = (flags & kHasJ) ? static_cast<const float*>(Js[b]) : nullptr;
    p->row[b].sigma =
        (flags & kHasSigma) ? static_cast<const float*>(sigmas[b]) : nullptr;
    p->row[b].out = static_cast<float*>(outs[b]);
    if (p->row[b].u == nullptr || p->row[b].out == nullptr ||
        ((flags & kHasJ) && p->row[b].J == nullptr) ||
        ((flags & kHasSigma) && p->row[b].sigma == nullptr)) {
      return bad;
    }
    if ((flags & kUVec) &&
        !(vec_e && p->su_e == 1 && p->su_k % 4 == 0 && aligned16(us[b]))) {
      return bad;
    }
    if ((flags & kOutVec) &&
        !(vec_e && p->so_e == 1 && p->so_i % 4 == 0 && aligned16(outs[b]))) {
      return bad;
    }
  }
  if (!(flags & kHasJ) && S != 1) return bad;
  const long long total = static_cast<long long>(runs) * n;
  p->nsub = static_cast<int>((total + kTE - 1) / kTE);
  if (total > 0x7fffffffLL) return bad;
  *rt = (I + 7) / 8 < 8 ? (I + 7) / 8 : 8;
  p->tiles_i = (I + 8 * *rt - 1) / (8 * *rt);
  const long long nb = (run + n - 1) / n;
  const long long nblocks = nb * p->tiles_i;
  if (nblocks > 0x7fffffffLL) return bad;
  *grid = dim3(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  return 0;
}

}  // namespace

extern "C" {

int probe_apply_max_rows() { return kMaxRows; }

int probe_apply_max_s() { return kMaxS; }

int probe_apply_max_dim() { return kMaxDim; }

// nrows rows, each with u, J (when flags has kHasJ), sigma (when flags has
// kHasSigma) and out pointers; R (S, I, K) contiguous; strides: u (k, e),
// J (s, e), sigma (i / I2, i % I2, e), out (i, e), in elements; a block
// takes n elements from each of `runs` runs of `run` elements.  Returns the
// CUDA error of the launch (0 on success).
int probe_apply_f32(int nrows, void* const* us, void* const* Js,
                    void* const* sigmas, void* const* outs, const void* R,
                    int S, int I, int K, const long long* strides, int I2,
                    long long run, int runs, int n, int flags, void* stream) {
  ApplyArgs p;
  dim3 grid;
  int rt = 0;
  const int err = prepare(&p, &grid, &rt, nrows, us, Js, sigmas, outs, R, S,
                          I, K, strides, I2, run, runs, n, flags);
  if (err) return err;
  return dispatch<LaunchF32>(rt, p, grid, static_cast<cudaStream_t>(stream));
}

int probe_apply_3xtf32(int nrows, void* const* us, void* const* Js,
                       void* const* sigmas, void* const* outs, const void* R,
                       int S, int I, int K, const long long* strides, int I2,
                       long long run, int runs, int n, int flags,
                       void* stream) {
  ApplyArgs p;
  dim3 grid;
  int rt = 0;
  const int err = prepare(&p, &grid, &rt, nrows, us, Js, sigmas, outs, R, S,
                          I, K, strides, I2, run, runs, n,
                          flags & ~kOutVec);
  if (err) return err;
  return dispatch<Launch3x>(rt, p, grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
