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
// They also serve the archive: a packed matvec or vecmat whose kron
// resident kron(I_g, D) exceeds dg_rows_f32's shared memory, and a
// tc_gemm_v0 row with a large resident factor (ops/cuda_emitter.py).
//
// u, J, sigma and out are strided (row, element) views, so one kernel takes
// every storage; sigma is a view over the output's rows split in two,
// i = i1 * I2 + i2, and the elements.  An element block is `runs` runs of n
// elements, run r at r * run + (block) * n: runs = 1 is a contiguous range
// (the dof-major tiling, and the folded mapping III, whose blocks stay
// inside one run), runs = 8 the folded mapping I (a block takes n elements
// from each of the 8 runs of the merged view).
//
// Design.  The work is items (row tile, element block, sub-tile of BE
// elements), the row tile fastest so that a sub-tile's row tiles run side
// by side and read u from L2.  The grid is persistent: as many blocks as
// fit on the card, each walking the items blockIdx.x + k gridDim.x.  A block
// streams the chunks (16 j's) of its items' K-folded sums through one ring
// of four shared-memory stages filled by cp.async three chunks ahead; the
// ring runs on from one item into the next, so an item's first chunks land
// while the one before finishes.  u is staged 16 bytes at a time along e
// where its element axis is contiguous and aligned, 16 bytes along j into a
// j-fast chunk (an element's 16 j's 20 floats apart) where its j axis is
// and its rows are 16-byte aligned, else 4 with the lanes along its
// stride-1 axis.  Neither R (up to 48 MB) nor u has to fit in a block.
// Each item's sums stay in registers and are written from there: as float4
// along the elements of a dof-major output, as float4 along the rows of an
// element-major output whose rows are contiguous and 16-byte aligned, else
// one float at a time.  The walk's bookkeeping is kept off the FMA path: a
// block reads the range table into shared memory once, decodes an item once
// when its cursor reaches it, steps its staging indices without divisions,
// and asks the runtime for its occupancy once per kernel and shared-memory
// size.
//
// The pre-pass probe_apply_ranges, launched by the same C entry on the same
// stream before the main kernel, one block per (row tile, s, 32 j's), does
// two things.  (1) It skips R's zero chunks: each block writes the least
// and the greatest j of its nonzeros of R into an int32 scratch; the main
// kernel reduces them per (s, row tile) and stages and multiplies only the
// chunks of 16 j's between (none where there is no nonzero), u's
// included.  A block-diagonal R such as the lane-pack facts' kron(I_g, D)
// then costs its band, not its square; a dense R costs one small extra
// launch.  Exactness: a chunk whose entries of R are all +-0 adds exactly 0
// to every finite sum, and a NaN counts as nonzero; the one difference from
// the dense product is 0 * Inf where u holds an Inf, where the skipped
// chunk gives the logical einsum's answer and the dense product NaN.
// Nothing is synchronised with the host and R is never read there.  (2) It
// writes R j-major, (S, K, tiles x rows) with zero rows past I, into a
// float scratch (at 3x its TF32 split, a hi and a lo plane), so that the
// ring stages R's chunks 16 bytes at a time with no bounds on i.
//
// * probe_apply_f32: IEEE f32 FMAs only.  At the descriptor's default
//   precision a product is a float32 product; TF32 and 3xTF32 belong to
//   bf16_3x, so this kernel does not use the tensor cores.  Each thread owns
//   a TM x 8 register tile: TM rows, four contiguous every 4 RG, and 8
//   elements (RG row groups, NEG element groups).  Where I > 64 at S = 1,
//   TM = 8 and a tile of 128, 96 or 64 rows (RG 16, 12 or 8: whichever pads
//   I least; I = 280 takes three of 96, not 128 + 128 + 24); else TM = 4
//   and tiles of at most 64 rows as even as can be (ndof 35 takes 36 rows,
//   ndof 20 all 20).  Per j a thread reads TM / 4 float4 of R and two float4
//   of u (four contiguous elements every 4 NEG) or, from a j-fast chunk, one
//   float2 of two j's for each of its elements (one every NEG), for 8 TM
//   FMAs.  Where RG is a multiple of 8 a warp is 8 row groups x 4 element
//   groups, so a float4 read of R or u covers at most 128 bytes, one
//   wavefront; else its lanes run along the row groups.  The pitches are
//   4 mod 32 floats (and 20 in a j-fast chunk), which keeps the reads free
//   of bank conflicts and halves those of the 4-byte cp.async writes.  At
//   S > 1 a chunk holds R's slabs of every s for one chunk of u, and
//   J_b[s, e] weights u per element before the FMAs: one set of sums, u
//   staged once for all s, a third of the chunks.
// * probe_apply_3xtf32: the dot on Hopper's tensor cores, three TF32
//   mma.sync.aligned.m16n8k8 passes (lo*hi + hi*lo + hi*hi) over the split
//   hi = tf32(x), lo = tf32(x - hi) (round to nearest, ties away, on the bit
//   pattern: cvt.rna.tf32.f32's rounding, ops/kernels.tf32_split's), as
//   csrc/dg_rows_3x.cu and csrc/tc_grid_3x.cu do (their helpers are copied
//   here, so that they stay as they are).  R is split once per launch, by
//   the pre-pass; the ring stages both planes, and B fragments are read
//   with no ALU work.  Each warp owns MT = 2 m16 element tiles (32 elements)
//   x NT n8 row tiles, so each B fragment pair feeds two MMA triples; u's A
//   fragments are split once per (k-step, element tile).  8 warps:
//   8 ceil(I / 8) rows x 256 elements where I <= 64, else 2 x 4 warps over
//   even tiles of 80 to 128 rows x 128 elements.  Each k-step's three
//   products go into a fresh fragment that is added to the sum in IEEE f32
//   (the tensor cores' accumulate truncates) as an FMA with a weight: 1, or
//   J_b[s, e] where J weights S > 1 partials, so one set of sums serves
//   every S and two blocks fit on an SM.  wgmma is not used: TF32 wgmma
//   needs both operands K-major in shared memory, and u is dof-major in most
//   storages.
//
// What bounds it on an H100.  The matvec and the div at ndof 20-35 sit below
// the fp32 ridge (about 20 flop per byte): bytes, 0.0876 ms for the matvec
// at ndof 35 and E = 2^20.  The kron matvec (K = 8 nd) and lane-reshape C
// and D (K = g d, up to 640) are dense products: operations, 0.307 ms of
// f32 FMA for the kron matvec at ndof 35.  The register tiles put the FMA
// units, not the shared-memory reads, on the f32 kernel's critical path;
// the 3x kernel is bound by its instructions per MMA (the A split, the
// fragment loads and the f32 FMAs of the fresh fragments).  PERF.md has
// what the card measured.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;   // 8 warps
constexpr int kKC = 16;         // contracted indices per chunk
constexpr int kStages = 4;      // ring stages: cp.async runs 3 chunks ahead
constexpr int kMaxRows = 3;
constexpr int kMaxS = 3;
constexpr int kMaxDim = 2048;   // the most rows (I) and j's (K) R may have
constexpr int kMaxGroups = 64;  // f32: element groups per block (512 elems)
constexpr int kMaxTiles = 32;   // row tiles: 2048 / 64
constexpr int kPreCols = 32;    // the pre-pass's j's per block
constexpr int kUP = kKC + 4;    // an element's pitch in a j-fast u chunk

// flags
constexpr int kUVec = 1;          // u staged 16 bytes at a time along e
constexpr int kUKFast = 2;        // u's stride-1 axis is j
constexpr int kOutElemMajor = 4;  // out's stride-1 axis is i
constexpr int kOutVec = 8;        // out stored as float4 along e (f32)
constexpr int kHasJ = 16;
constexpr int kHasSigma = 32;
constexpr int kOutRowVec = 64;    // out stored as float4 along i (set here)
constexpr int kUKVec = 128;       // u staged 16 bytes at a time along j,
                                  // j-fast in the chunk (set here)

struct RowPtrs {
  const float* u;
  const float* J;
  const float* sigma;
  float* out;
};

struct ApplyArgs {
  RowPtrs row[kMaxRows];
  const float* RT;             // (S, K, ip): R j-major (f32), its hi plane
  const float* RTlo;           // (S, K, ip): the lo plane (3x)
  const int* ranges;           // (2, S, tiles_i, ncb): the pre-pass's least
                               // and greatest j of R's nonzeros
  int S, I, K;
  int ip;                      // R's rows padded to whole tiles
  int ncb;                     // the pre-pass's column blocks
  long long su_k, su_e;        // u strides
  long long sj_s, sj_e;        // J strides
  long long sg_1, sg_2, sg_e;  // sigma strides over (i / I2, i % I2, e)
  int I2;
  long long so_i, so_e;        // out strides
  long long run;               // elements per run
  int runs;                    // runs an element block takes from
  int n;                       // elements per run per element block
  int nsub;                    // sub-tiles per element block
  int tiles_i;                 // row tiles
  int nitems;                  // tiles_i x element blocks x nsub
  int bi, be;                  // rows per tile, elements per sub-tile
  int rg, neg;                 // f32: row groups, element groups
  int fuse;                    // f32 at S > 1: a chunk holds every s's R
  int sr, su;                  // R's and u's chunk pitches, in floats
  int uk, ul;                  // u's chunk strides along j and e (3x)
  int stage;                   // floats per ring stage
  int flags;
};

// The tile of each kernel for R with I rows (ops/probe_kernels.apply_tile);
// `two`: J weights S > 1 partials.  Where I needs several row tiles, they
// pad I little: f32 at TM = 8 takes 64, 96 or 128 rows (I = 280: three of
// 96, not 128 + 128 + 24), else they are as even as the row quantum allows
// (3x at I = 280: three of 96 too).
struct Tile {
  int bi, be, rg, neg;
};

Tile f32_tile(int I, bool two) {
  const int tm = I <= 64 || two ? 4 : 8;
  int rg;
  if (tm == 8) {
    // 16, 12 or 8 row groups, whichever pads I least (the larger on a tie)
    rg = 16;
    for (int g = 12; g >= 8; g -= 4) {
      const int rows = 8 * g, best = 8 * rg;
      if ((I + rows - 1) / rows * rows < (I + best - 1) / best * best) rg = g;
    }
  } else {
    const int tiles = (I + 63) / 64;
    rg = ((I + tiles - 1) / tiles + 3) / 4;
  }
  int neg = kThreads / rg / 4 * 4;
  if (neg > kMaxGroups) neg = kMaxGroups;
  return Tile{rg * tm, 8 * neg, rg, neg};
}

// 3x: one warp row of NT n8 tiles up to I = 64 (256 elements), else two of
// 5 to 8 (128 elements)
Tile x3_tile(int I) {
  if (I <= 64) return Tile{8 * ((I + 7) / 8), 256, 0, 0};
  const int tiles = (I + 127) / 128;
  return Tile{16 * (((I + tiles - 1) / tiles + 15) / 16), 128, 0, 0};
}

// the smallest pitch >= n that is m mod 32 floats
__host__ __device__ constexpr int pitch(int n, int m) {
  return n + (((m - n) % 32) + 32) % 32;
}

// the element of local index l of element block eb (e0 = eb n), or -1 past
// the end
__device__ __forceinline__ long long elem(const ApplyArgs& p, long long eb,
                                          long long e0, int l) {
  if (p.runs == 1) return l < p.n && e0 + l < p.run ? e0 + l : -1;
  if (l >= p.runs * p.n) return -1;
  const int f = l / p.n;
  const long long c = e0 + (l - f * p.n);
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

// The pre-pass: block (ti, s, jb) reads R[s]'s row tile ti over the
// kPreCols j's of column block jb through a shared tile; writes it j-major
// into rt[s][j][i] (rows past I zero; with rt_lo, R's TF32 split: hi into
// rt, lo into rt_lo) and the least and the greatest j of its nonzeros
// (v != 0: NaN counts, +-0 does not; INT_MAX and -1 for none) into
// part[0][s][ti][jb] and part[1][s][ti][jb].
__global__ void __launch_bounds__(kThreads)
probe_apply_ranges(const float* __restrict__ R, int I, int K, int bi,
                   int tiles_i, int ip, int* __restrict__ part,
                   float* __restrict__ rt, float* __restrict__ rt_lo) {
  __shared__ float tile[128][kPreCols + 1];
  __shared__ int bmin, bmax;
  const int tid = threadIdx.x;
  const int ti = blockIdx.x, s = blockIdx.y, j0 = blockIdx.z * kPreCols;
  const int i0 = ti * bi;
  if (tid == 0) {
    bmin = INT_MAX;
    bmax = -1;
  }
  int mn = INT_MAX, mx = -1;
  for (int idx = tid; idx < bi * kPreCols; idx += kThreads) {
    const int r = idx / kPreCols, c = idx % kPreCols;
    const int i = i0 + r, j = j0 + c;
    float v = 0.f;
    if (i < I && j < K) {
      v = R[(static_cast<long long>(s) * I + i) * K + j];
      if (v != 0.f) {
        mn = j < mn ? j : mn;
        mx = j > mx ? j : mx;
      }
    }
    tile[r][c] = v;
  }
  __syncthreads();
  for (int idx = tid; idx < bi * kPreCols; idx += kThreads) {
    const int r = idx % bi, c = idx / bi;
    const int j = j0 + c;
    if (j >= K) continue;
    const long long o = (static_cast<long long>(s) * K + j) * ip + i0 + r;
    const float v = tile[r][c];
    if (rt_lo != nullptr) {
      const float h = tf32_round(v);
      rt[o] = h;
      rt_lo[o] = tf32_round(v - h);
    } else {
      rt[o] = v;
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const int a = __shfl_xor_sync(0xffffffffu, mn, o);
    const int b = __shfl_xor_sync(0xffffffffu, mx, o);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  if ((tid & 31) == 0) {
    atomicMin(&bmin, mn);
    atomicMax(&bmax, mx);
  }
  __syncthreads();
  if (tid == 0) {
    const int o = (s * tiles_i + ti) * gridDim.z + blockIdx.z;
    part[o] = bmin;
    part[gridDim.y * tiles_i * gridDim.z + o] = bmax;
  }
}

// The range table in shared memory: the chunk range of each (s, row tile)
// (where a chunk holds every s's R, their union, in rng[0]) and each tile's
// chunk count
struct Table {
  int2 rng[kMaxS][kMaxTiles];
  int cnt[kMaxTiles];
};

// the chunks [first, last + 1) of j that the least and the greatest j of
// R's nonzeros span, (0, 0) for none
__device__ __forceinline__ void load_table(const ApplyArgs& p, Table& t) {
  const int tid = threadIdx.x;
  const int n = p.S * p.tiles_i;
  const int* lo = p.ranges;
  const int* hi = p.ranges + n * p.ncb;
  for (int idx = tid; idx < n; idx += kThreads) {
    int mn = INT_MAX, mx = -1;
#pragma unroll 4
    for (int c = 0; c < p.ncb; ++c) {
      const int a = lo[idx * p.ncb + c], b = hi[idx * p.ncb + c];
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    t.rng[idx / p.tiles_i][idx % p.tiles_i] =
        mx < 0 ? make_int2(0, 0) : make_int2(mn / kKC, mx / kKC + 1);
  }
  __syncthreads();
  for (int ti = tid; ti < p.tiles_i; ti += kThreads) {
    if (p.fuse) {
      int2 u = make_int2(INT_MAX, 0);
      for (int s = 0; s < p.S; ++s) {
        const int2 r = t.rng[s][ti];
        if (r.y > r.x) u = make_int2(min(u.x, r.x), max(u.y, r.y));
      }
      t.rng[0][ti] = u.y > 0 ? u : make_int2(0, 0);
      t.cnt[ti] = t.rng[0][ti].y - t.rng[0][ti].x;
    } else {
      int c = 0;
      for (int s = 0; s < p.S; ++s) c += t.rng[s][ti].y - t.rng[s][ti].x;
      t.cnt[ti] = c;
    }
  }
  __syncthreads();
}

// chunk cc of row tile ti's list: its s (0 where a chunk holds every s),
// its chunk of j (returned) and whether it is s's last
__device__ __forceinline__ int chunk_of(const ApplyArgs& p, const Table& t,
                                        int ti, int cc, int* s_out,
                                        bool* last) {
  int s = 0;
  for (; s < (p.fuse ? 0 : p.S - 1); ++s) {
    const int len = t.rng[s][ti].y - t.rng[s][ti].x;
    if (cc < len) break;
    cc -= len;
  }
  *s_out = s;
  *last = cc == t.rng[s][ti].y - t.rng[s][ti].x - 1;
  return t.rng[s][ti].x + cc;
}

// An item w, decoded: its row tile, element block (and eb n) and first
// local element; the chunk cc of its n that a cursor stands at
struct Item {
  int w, ti, l0, cc, n;
  long long eb, e0;
};

__device__ __forceinline__ void decode(const ApplyArgs& p, const Table& t,
                                       Item& it) {
  const int r = it.w / p.tiles_i;
  it.ti = it.w - r * p.tiles_i;
  const int eb = r / p.nsub;
  it.l0 = (r - eb * p.nsub) * p.be;
  it.eb = eb;
  it.e0 = it.eb * p.n;
  it.cc = 0;
  it.n = t.cnt[it.ti];
}

// move a cursor to the first chunk at or after it, past items without
// chunks; w >= nitems past the block's last item
__device__ __forceinline__ void settle(const ApplyArgs& p, const Table& t,
                                       Item& c) {
  while (c.w < p.nitems && c.cc >= c.n) {
    c.w += gridDim.x;
    if (c.w < p.nitems) decode(p, t, c);
  }
}

// A thread's walk over the (row, column) cells of a rows x w grid, the
// threads along the columns: its first cell and its step
struct Steps {
  int r, c, dr, dc, w;
};

__device__ __forceinline__ Steps steps_of(int w) {
  const int tid = threadIdx.x;
  return Steps{tid / w, tid % w, kThreads / w, kThreads % w, w};
}

__device__ __forceinline__ void advance(Steps& st) {
  st.r += st.dr;
  st.c += st.dc;
  if (st.c >= st.w) {
    st.c -= st.w;
    ++st.r;
  }
}

// The staging of a block: R's chunk as (kKC rows of j) x (bi / 4 float4 of
// i); u's as kKC x (be / 4) float4, be x (kKC / 4) float4 (j-fast) or
// kKC x be floats
struct Stager {
  Steps r, u;
};

// Stage chunk (s, kc) of item `it` into `stage`: R's bi x kKC slab as
// [j][i] (3x: the hi plane, then the lo plane), u's kKC x be slab as
// [j][l], or as [l][j] with an element's pitch kUP where it is staged
// along j; zeros past K and the block's elements.
template <bool SPLIT>
__device__ __forceinline__ void issue(const ApplyArgs& p, const float* u,
                                      float* stage, const Stager& sg, int s,
                                      int kc, const Item& it) {
  const int k0 = kc * kKC;
  // the slabs: R[s] (3x: its hi and lo planes), or R[0 .. S - 1] fused
  const int slabs = p.fuse ? p.S : 1;
  for (int sl = 0; sl < slabs; ++sl) {
    const long long r0 =
        (static_cast<long long>(p.fuse ? sl : s) * p.K + k0) * p.ip +
        it.ti * p.bi;
    float* rs = stage + sl * kKC * p.sr;
    for (Steps st = sg.r; st.r < kKC; advance(st)) {
      const bool valid = k0 + st.r < p.K;
      const long long o = valid ? r0 + static_cast<long long>(st.r) * p.ip +
                                      4 * st.c
                                : 0;
      copy_async16(rs + st.r * p.sr + 4 * st.c, p.RT + o, valid);
      if (SPLIT) {
        copy_async16(rs + (kKC + st.r) * p.sr + 4 * st.c, p.RTlo + o,
                     valid);
      }
    }
  }
  float* us = stage + (SPLIT ? 2 : slabs) * kKC * p.sr;
  if (p.flags & kUVec) {
    for (Steps st = sg.u; st.r < kKC; advance(st)) {
      const long long e = elem(p, it.eb, it.e0, it.l0 + 4 * st.c);
      const bool valid = e >= 0 && k0 + st.r < p.K;
      copy_async16(us + st.r * p.su + 4 * st.c,
                   valid ? u + (k0 + st.r) * p.su_k + e : u, valid);
    }
  } else if (p.flags & kUKVec) {
    // element r's four j's 4 c ... 4 c + 3
    for (Steps st = sg.u; st.r < p.be; advance(st)) {
      const long long e = elem(p, it.eb, it.e0, it.l0 + st.r);
      const bool valid = e >= 0 && k0 + 4 * st.c < p.K;
      copy_async16(us + st.r * kUP + 4 * st.c,
                   valid ? u + e * p.su_e + k0 + 4 * st.c : u, valid);
    }
  } else if (p.flags & kUKFast) {
    // the lanes along j
    for (int idx = threadIdx.x; idx < kKC * p.be; idx += kThreads) {
      const int k = idx % kKC;
      const int l = idx / kKC;
      const long long e = elem(p, it.eb, it.e0, it.l0 + l);
      const bool valid = e >= 0 && k0 + k < p.K;
      copy_async4(us + k * p.su + l, valid ? u + (k0 + k) + e * p.su_e : u,
                  valid);
    }
  } else {
    for (Steps st = sg.u; st.r < kKC; advance(st)) {
      const long long e = elem(p, it.eb, it.e0, it.l0 + st.c);
      const bool valid = e >= 0 && k0 + st.r < p.K;
      copy_async4(us + st.r * p.su + st.c,
                  valid ? u + (k0 + st.r) * p.su_k + e * p.su_e : u, valid);
    }
  }
}

template <bool SPLIT>
__device__ __forceinline__ void issue_next(const ApplyArgs& p,
                                           const Table& t, const float* u,
                                           float* stage, const Stager& sg,
                                           Item& c) {
  if (c.w >= p.nitems) return;
  int s;
  bool last;
  const int kc = chunk_of(p, t, c.ti, c.cc, &s, &last);
  issue<SPLIT>(p, u, stage, sg, s, kc, c);
  ++c.cc;
  settle(p, t, c);
}

// The block's walk over its items.  `tile` holds a thread's sums: begin()
// zeroes them, chunk() adds a staged chunk, end() writes the item.
template <bool SPLIT, class T>
__device__ __forceinline__ void walk(const ApplyArgs& p, const RowPtrs& rw,
                                     float* smem, Table& table, T& tile) {
  load_table(p, table);
  Stager sg;
  sg.r = steps_of(p.bi / 4);
  sg.u = steps_of((p.flags & kUVec)    ? p.be / 4
                  : (p.flags & kUKVec) ? kKC / 4
                                       : p.be);
  Item cur;  // the producer's cursor
  cur.w = blockIdx.x;
  decode(p, table, cur);
  settle(p, table, cur);
  // one committed group per stage, empty past the end, so that the group
  // counts stay uniform
#pragma unroll 1
  for (int c = 0; c < kStages - 1; ++c) {
    issue_next<SPLIT>(p, table, rw.u, smem + c * p.stage, sg, cur);
    copy_commit();
  }
  int slot = 0;  // the stage of the next chunk consumed
  Item it;
  for (it.w = blockIdx.x; it.w < p.nitems; it.w += gridDim.x) {
    decode(p, table, it);
    tile.begin(p, rw, it);
    for (int cc = 0; cc < it.n; ++cc) {
      copy_wait<kStages - 2>();  // this thread's copies of the chunk landed
      __syncthreads();           // everyone's; and the last stage is free
      issue_next<SPLIT>(p, table, rw.u,
                        smem + ((slot + kStages - 1) % kStages) * p.stage,
                        sg, cur);
      copy_commit();
      int s;
      bool last;
      const int kc = chunk_of(p, table, it.ti, cc, &s, &last);
      tile.chunk(p, rw, it, smem + slot * p.stage, s, kc, last);
      slot = slot == kStages - 1 ? 0 : slot + 1;
    }
    tile.end(p, rw, it);
  }
}

// A thread's TM x 8 sums of the f32 kernel.  FUSE: a chunk holds R's
// slabs of every s for one chunk of u, and J_b[s, e] weights u per element
// before the FMAs (one set of sums; u staged once for all s).  UK: u's
// chunk is j-fast.
template <int TM, bool FUSE, bool UK>
struct F32Tile {
  float acc[TM][8];
  float jv[FUSE ? kMaxS : 1][8];  // J_b[s, e] of the thread's elements
  int rgi, egi;
  bool active;

  // local row of register a, local element of register q: four
  // contiguous elements every 4 NEG, or (u j-fast) one every NEG
  __device__ __forceinline__ int row(const ApplyArgs& p, int a) const {
    return rgi * 4 + (a & 3) + (a >> 2) * 4 * p.rg;
  }
  __device__ __forceinline__ int col(const ApplyArgs& p, int q) const {
    if constexpr (UK) return egi + q * p.neg;
    return egi * 4 + (q & 3) + (q >> 2) * 4 * p.neg;
  }

  __device__ __forceinline__ void begin(const ApplyArgs& p, const RowPtrs& rw,
                                        const Item& it) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
    }
    if constexpr (FUSE) {
      if (!active) return;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const long long e = elem(p, it.eb, it.e0, it.l0 + col(p, q));
#pragma unroll
        for (int s = 0; s < kMaxS; ++s) {
          jv[s][q] = e >= 0 && s < p.S
                         ? __ldg(rw.J + s * p.sj_s + e * p.sj_e)
                         : 0.f;
        }
      }
    }
  }

  static __device__ __forceinline__ void load_r(float (&rv)[TM],
                                                const float* r, int rstep) {
#pragma unroll
    for (int h = 0; h < TM / 4; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(r + h * rstep);
      rv[4 * h] = v.x;
      rv[4 * h + 1] = v.y;
      rv[4 * h + 2] = v.z;
      rv[4 * h + 3] = v.w;
    }
  }

  // acc += R's row j (r: the thread's rows of j in slab 0) x u's row j (uv:
  // the thread's elements), for every s where fused
  __device__ __forceinline__ void fma_j(const ApplyArgs& p, const float* r,
                                        const float (&uv)[8], int rstep) {
    if constexpr (FUSE) {
#pragma unroll
      for (int s = 0; s < kMaxS; ++s) {
        if (s >= p.S) break;
        float rv[TM], w[8];
        load_r(rv, r + s * kKC * p.sr, rstep);
#pragma unroll
        for (int q = 0; q < 8; ++q) w[q] = uv[q] * jv[s][q];
#pragma unroll
        for (int a = 0; a < TM; ++a) {
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[a][q] = fmaf(rv[a], w[q], acc[a][q]);
        }
      }
    } else {
      float rv[TM];
      load_r(rv, r, rstep);
#pragma unroll
      for (int a = 0; a < TM; ++a) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[a][q] = fmaf(rv[a], uv[q], acc[a][q]);
      }
    }
  }

  // u's chunk [j][l]: per j, two float4 of u (and TM / 4 of R per s)
  __device__ __forceinline__ void u_row(float (&uv)[8], const float* u,
                                        int ustep) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(u + h * ustep);
      uv[4 * h] = v.x;
      uv[4 * h + 1] = v.y;
      uv[4 * h + 2] = v.z;
      uv[4 * h + 3] = v.w;
    }
  }

  __device__ __forceinline__ void run(const ApplyArgs& p, const float* stage,
                                      int kn) {
    const float* rs = stage + rgi * 4;
    const float* us = stage + (FUSE ? p.S : 1) * kKC * p.sr + egi * 4;
    const int rstep = 4 * p.rg, ustep = 4 * p.neg;
    if (kn >= kKC) {
      // 8 j's unrolled at a time, which keeps the loop in the instruction
      // cache
#pragma unroll 1
      for (int k0 = 0; k0 < kKC; k0 += 8) {
#pragma unroll
        for (int k = k0; k < k0 + 8; ++k) {
          float uv[8];
          u_row(uv, us + k * p.su, ustep);
          fma_j(p, rs + k * p.sr, uv, rstep);
        }
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < kn; ++k) {
        float uv[8];
        u_row(uv, us + k * p.su, ustep);
        fma_j(p, rs + k * p.sr, uv, rstep);
      }
    }
  }

  // u's chunk [l][j]: per two j's, one float2 of u for each of the 8
  // elements (consecutive lanes on consecutive elements, kUP = 20 floats
  // apart: no bank conflicts), then per j TM / 4 float4 of R per s (K is a
  // multiple of 4 here)
  __device__ __forceinline__ void run_uk(const ApplyArgs& p,
                                         const float* stage, int kn) {
    const float* rs = stage + rgi * 4;
    const float* us = stage + (FUSE ? p.S : 1) * kKC * p.sr + egi * kUP;
    const int ustep = p.neg * kUP;
    const int rstep = 4 * p.rg;
    const int n2 = (kn < kKC ? kn : kKC) / 2;
#pragma unroll 1
    for (int k2 = 0; k2 < n2; ++k2) {
      float2 uq[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uq[q] = *reinterpret_cast<const float2*>(us + q * ustep + 2 * k2);
      }
      // one j at a time (unrolled, the two j's' R reads would spill the
      // 8 x 8 tile's registers)
#pragma unroll 1
      for (int kk = 0; kk < 2; ++kk) {
        float uv[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) uv[q] = kk ? uq[q].y : uq[q].x;
        fma_j(p, rs + (2 * k2 + kk) * p.sr, uv, rstep);
      }
    }
  }

  __device__ __forceinline__ void chunk(const ApplyArgs& p, const RowPtrs& rw,
                                        const Item& it, const float* stage,
                                        int s, int kc, bool last) {
    if (!active) return;
    if constexpr (UK) {
      run_uk(p, stage, p.K - kc * kKC);
    } else {
      run(p, stage, p.K - kc * kKC);
    }
  }

  __device__ __forceinline__ void end(const ApplyArgs& p, const RowPtrs& rw,
                                      const Item& it) {
    if (!active) return;
    const int i0 = it.ti * p.bi;
    long long e[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      e[q] = elem(p, it.eb, it.e0, it.l0 + col(p, q));
    }
    const bool has_j = !FUSE && (p.flags & kHasJ);
    const bool has_sigma = (p.flags & kHasSigma) != 0;
    if (has_j) {  // at S = 1 J weights the one sum here
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float w = e[q] >= 0 ? __ldg(rw.J + e[q] * p.sj_e) : 0.f;
#pragma unroll
        for (int a = 0; a < TM; ++a) acc[a][q] = w * acc[a][q];
      }
    }
    if (has_sigma) {
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int i = i0 + row(p, a);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (i < p.I && e[q] >= 0) {
            acc[a][q] *= sigma_at(p, rw.sigma, i, e[q]);
          }
        }
      }
    }
    if (p.flags & kOutRowVec) {
      // element-major, rows contiguous: four rows per float4
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const int i = i0 + row(p, 4 * h);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (e[q] < 0) continue;
          float* o = rw.out + e[q] * p.so_e + i;
          if (i + 3 < p.I) {
            *reinterpret_cast<float4*>(o) =
                make_float4(acc[4 * h][q], acc[4 * h + 1][q],
                            acc[4 * h + 2][q], acc[4 * h + 3][q]);
          } else {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              if (i + r < p.I) o[r] = acc[4 * h + r][q];
            }
          }
        }
      }
      return;
    }
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int i = i0 + row(p, a);
      if (i >= p.I) continue;
      if (!UK && (p.flags & kOutVec)) {
        // dof-major, elements contiguous: four elements per float4
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (e[4 * h] < 0) continue;
          *reinterpret_cast<float4*>(rw.out + i * p.so_i + e[4 * h]) =
              make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2],
                          acc[a][4 * h + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (e[q] >= 0) rw.out[i * p.so_i + e[q] * p.so_e] = acc[a][q];
        }
      }
    }
  }
};

template <int TM, bool FUSE, bool UK>
__global__ void __launch_bounds__(kThreads, 2)
probe_apply_f32_kernel(const __grid_constant__ ApplyArgs p) {
  extern __shared__ __align__(16) float pa_smem[];
  __shared__ Table table;
  F32Tile<TM, FUSE, UK> tile;
  const int tid = threadIdx.x;
  if (p.rg % 8 == 0) {
    // warps of 8 row groups x 4 element groups: a float4 read of R or u
    // covers 128 or 64 bytes, one wavefront
    const int wr = p.rg / 8, w = tid >> 5, lane = tid & 31;
    tile.rgi = (w % wr) * 8 + (lane & 7);
    tile.egi = (w / wr) * 4 + (lane >> 3);
  } else {
    tile.rgi = tid % p.rg;
    tile.egi = tid / p.rg;
  }
  tile.active = tile.egi < p.neg;
  walk<false>(p, p.row[blockIdx.y], pa_smem, table, tile);
}

// A warp's MT x 16 elements by NT x 8 rows of the 3x kernel's tile; WR
// warps along the rows, 8 / WR along the elements
template <int NT, int WR>
struct X3Tile {
  static constexpr int MT = 2;
  float acc[MT][NT][4];
  float jv[MT][2];  // the weight of the fresh fragments: J_b[s, e] at S > 1
  int cur_s;
  int gid, tig, mb, nb;

  __device__ __forceinline__ void begin(const ApplyArgs&, const RowPtrs&,
                                        const Item&) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][j][q] = 0.f;
      }
      jv[m][0] = jv[m][1] = 1.f;
    }
    cur_s = -1;
  }

  // one k-step of 8 j's: acc += jv * (u (MT x 16 by 8) @ R^T (8 by NT x 8))
  __device__ __forceinline__ void step(const float* rh, const float* rl,
                                       const float* us, int sr, int uk,
                                       int ul) {
    // A (m = element, k = j): (gid, tig), (gid + 8, tig), (gid, tig + 4),
    // (gid + 8, tig + 4), split once for every n tile
    float ahi[MT][4], alo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a_ = us + tig * uk + (mb + 16 * m + gid) * ul;
      const float a[4] = {a_[0], a_[8 * ul], a_[4 * uk], a_[4 * uk + 8 * ul]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ahi[m][q] = tf32_round(a[q]);
        alo[m][q] = tf32_round(a[q] - ahi[m][q]);
      }
    }
    // two n tiles at a time: B (k = j, n = row): (tig, gid), (tig + 4,
    // gid), already split; lo*hi, hi*lo, hi*hi (the small terms first) into
    // fresh fragments, each pass over every (element, row) tile before the
    // next; then added to the sums in f32 (times the weight: an FMA with 1
    // is the addition)
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += 2) {
      float bhi[2][2], blo[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int off = (tig + 4 * h) * sr + nb + 8 * (j0 + j) + gid;
          bhi[j][h] = j0 + j < NT ? rh[off] : 0.f;
          blo[j][h] = j0 + j < NT ? rl[off] : 0.f;
        }
      }
      float d[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) d[m][j][q] = 0.f;
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j0 + j < NT) mma_tf32(d[m][j], alo[m], bhi[j][0], bhi[j][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j0 + j < NT) mma_tf32(d[m][j], ahi[m], blo[j][0], blo[j][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j0 + j < NT) mma_tf32(d[m][j], ahi[m], bhi[j][0], bhi[j][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j0 + j >= NT) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[m][j0 + j][q] =
                fmaf(jv[m][q >> 1], d[m][j][q], acc[m][j0 + j][q]);
          }
        }
      }
    }
  }

  __device__ __forceinline__ long long elem_of(const ApplyArgs& p,
                                               const Item& it, int m,
                                               int h) const {
    return elem(p, it.eb, it.e0, it.l0 + mb + 16 * m + gid + 8 * h);
  }

  __device__ __forceinline__ void chunk(const ApplyArgs& p, const RowPtrs& rw,
                                        const Item& it, const float* stage,
                                        int s, int kc, bool last) {
    if (p.S > 1 && s != cur_s) {  // the weights J_b[s, e] of s's chunks
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long e = elem_of(p, it, m, h);
          jv[m][h] = e >= 0 ? __ldg(rw.J + s * p.sj_s + e * p.sj_e) : 0.f;
        }
      }
      cur_s = s;
    }
    const float* rh = stage;
    const float* rl = stage + kKC * p.sr;
    const float* us = stage + 2 * kKC * p.sr;
    // the k-steps of 8 this chunk holds j's for (zeros past K)
    step(rh, rl, us, p.sr, p.uk, p.ul);
    if (p.K - kc * kKC > 8) {
      step(rh + 8 * p.sr, rl + 8 * p.sr, us + 8 * p.uk, p.sr, p.uk, p.ul);
    }
  }

  // C fragment (m x n): (gid, 2 tig), (gid, 2 tig + 1), (gid + 8, 2 tig),
  // (gid + 8, 2 tig + 1); written straight from the registers
  __device__ __forceinline__ void end(const ApplyArgs& p, const RowPtrs& rw,
                                      const Item& it) {
    const int i0 = it.ti * p.bi + nb;
    const bool has_j = p.S == 1 && (p.flags & kHasJ);
    const bool has_sigma = (p.flags & kHasSigma) != 0;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long e = elem_of(p, it, m, h);
        if (e < 0) continue;
        const float w = has_j ? __ldg(rw.J + e * p.sj_e) : 1.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = i0 + 8 * j + 2 * tig + c;
            if (i >= p.I) continue;
            float v = acc[m][j][2 * h + c];
            if (has_j) v = w * v;
            if (has_sigma) v *= sigma_at(p, rw.sigma, i, e);
            rw.out[i * p.so_i + e * p.so_e] = v;
          }
        }
      }
    }
  }
};

template <int NT, int WR>
__global__ void __launch_bounds__(kThreads, 2)
probe_apply_3xtf32_kernel(const __grid_constant__ ApplyArgs p) {
  extern __shared__ __align__(16) float pa_smem[];
  __shared__ Table table;
  X3Tile<NT, WR> tile;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int WE = 8 / WR;
  tile.gid = lane >> 2;
  tile.tig = lane & 3;
  tile.mb = (warp % WE) * 16 * X3Tile<NT, WR>::MT;
  tile.nb = (warp / WE) * 8 * NT;
  walk<true>(p, p.row[blockIdx.y], pa_smem, table, tile);
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

using KernelFn = void (*)(ApplyArgs);

// Blocks of `kernel` that fit on one SM with `smem` bytes of dynamic
// shared memory, asked of the runtime once per (kernel, smem); the kernel's
// allowance of dynamic shared memory only ever grows, to the most any of
// its launches needs
int blocks_per_sm(KernelFn kernel, size_t smem, int* per_sm) {
  struct Entry {
    KernelFn kernel;
    size_t smem;
    int per_sm;
  };
  static Entry cache[64];
  static int used = 0;
  size_t allowed = 0;
  for (int k = 0; k < used; ++k) {
    if (cache[k].kernel != kernel) continue;
    if (cache[k].smem == smem) {
      *per_sm = cache[k].per_sm;
      return 0;
    }
    allowed = cache[k].smem > allowed ? cache[k].smem : allowed;
  }
  cudaError_t err = cudaSuccess;
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (used < 64) cache[used++] = Entry{kernel, smem, *per_sm};
  return 0;
}

int sm_count(int* sms) {
  static int cache[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && cache[dev] > 0) {
    *sms = cache[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) cache[dev] = *sms;
  return 0;
}

// Launch `kernel` persistently: as many blocks per row as fit on the card
// at once, at most one per item.
int launch(KernelFn kernel, const ApplyArgs& p, int nrows, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(kStages) * p.stage * sizeof(float);
  int per_sm = 0, sms = 0;
  int err = blocks_per_sm(kernel, smem, &per_sm);
  if (!err) err = sm_count(&sms);
  if (err) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = (static_cast<long long>(per_sm) * sms + nrows - 1) /
                     nrows;
  if (blocks > p.nitems) blocks = p.nitems;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(nrows)),
           kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

KernelFn f32_kernel(int I, bool fuse, bool uk) {
  if (fuse) {
    return uk ? &probe_apply_f32_kernel<4, true, true>
              : &probe_apply_f32_kernel<4, true, false>;
  }
  if (I <= 64) {
    return uk ? &probe_apply_f32_kernel<4, false, true>
              : &probe_apply_f32_kernel<4, false, false>;
  }
  return uk ? &probe_apply_f32_kernel<8, false, true>
            : &probe_apply_f32_kernel<8, false, false>;
}

KernelFn x3_kernel(int I) {
  if (I > 64) {
    switch (x3_tile(I).bi / 16) {
      case 5: return &probe_apply_3xtf32_kernel<5, 2>;
      case 6: return &probe_apply_3xtf32_kernel<6, 2>;
      case 7: return &probe_apply_3xtf32_kernel<7, 2>;
      default: return &probe_apply_3xtf32_kernel<8, 2>;
    }
  }
  switch ((I + 7) / 8) {
    case 1: return &probe_apply_3xtf32_kernel<1, 1>;
    case 2: return &probe_apply_3xtf32_kernel<2, 1>;
    case 3: return &probe_apply_3xtf32_kernel<3, 1>;
    case 4: return &probe_apply_3xtf32_kernel<4, 1>;
    case 5: return &probe_apply_3xtf32_kernel<5, 1>;
    case 6: return &probe_apply_3xtf32_kernel<6, 1>;
    case 7: return &probe_apply_3xtf32_kernel<7, 1>;
    default: return &probe_apply_3xtf32_kernel<8, 1>;
  }
}

// Checks the arguments and fills the kernel's (RT, RTlo and ranges are set
// by the caller).  Returns 0 or cudaErrorInvalidValue.
int prepare(ApplyArgs* p, bool split, int nrows, void* const* us,
            void* const* Js, void* const* sigmas, void* const* outs,
            const void* R, int S, int I, int K, const long long* strides,
            int I2, long long run, int runs, int n, int flags) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nrows < 1 || nrows > kMaxRows || S < 1 || S > kMaxS || I < 1 ||
      I > kMaxDim || K < 1 || K > kMaxDim || I2 < 1 || run < 1 ||
      runs < 1 || n < 1 || R == nullptr) {
    return bad;
  }
  *p = ApplyArgs{};
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
  flags &= ~(kOutRowVec | kUKVec);
  if (split) flags &= ~kOutVec;
  const bool vec_e = n % 4 == 0 && run % 4 == 0;
  bool row_vec = !split && (flags & kOutElemMajor) && p->so_i == 1 &&
                 p->so_e % 4 == 0;
  bool uk_vec = (flags & kUKFast) && K % 4 == 0 && p->su_e % 4 == 0;
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
    if ((flags & kUKFast) && p->su_k != 1) return bad;
    if ((flags & kOutVec) &&
        !(vec_e && p->so_e == 1 && p->so_i % 4 == 0 && aligned16(outs[b]))) {
      return bad;
    }
    row_vec = row_vec && aligned16(outs[b]);
    uk_vec = uk_vec && aligned16(us[b]);
  }
  if (!(flags & kHasJ) && S != 1) return bad;
  p->flags = flags | (row_vec ? kOutRowVec : 0) | (uk_vec ? kUKVec : 0);
  const Tile tile = split ? x3_tile(I) : f32_tile(I, S > 1);
  p->bi = tile.bi;
  p->be = tile.be;
  p->rg = tile.rg;
  p->neg = tile.neg;
  // B fragments read tig * sr + gid: no conflict at 8 mod 32; A fragments
  // likewise at su 8 mod 32, or gid * kUP + tig j-fast
  p->sr = pitch(tile.bi, split ? 8 : 4);
  p->su = uk_vec ? kUP : pitch(tile.be, split ? 8 : 4);
  p->uk = uk_vec ? 1 : p->su;
  p->ul = uk_vec ? kUP : 1;
  p->fuse = !split && S > 1;
  p->stage = (split ? 2 : p->fuse ? S : 1) * kKC * p->sr +
             (uk_vec ? tile.be * kUP : kKC * p->su);
  const long long total = static_cast<long long>(runs) * n;
  if (total > 0x7fffffffLL) return bad;
  p->nsub = static_cast<int>((total + tile.be - 1) / tile.be);
  p->tiles_i = (I + tile.bi - 1) / tile.bi;
  p->ip = p->tiles_i * tile.bi;
  p->ncb = (K + kPreCols - 1) / kPreCols;
  const long long nb = (run + n - 1) / n;
  const long long nitems = nb * p->nsub * p->tiles_i;
  if (nitems > 0x7fffffffLL - 65536LL * kMaxRows) return bad;
  p->nitems = static_cast<int>(nitems);
  return 0;
}

// The pre-pass, then the kernel: the least and greatest j of R's nonzeros
// per (s, row tile, column block) into `ranges` (at least 2 S tiles_i ncb
// ints: all the least, then all the greatest), R j-major into `planes` (at
// least S K ip floats; at 3x its split, 2 S K ip: hi, lo).
int apply(bool split, int nrows, void* const* us, void* const* Js,
          void* const* sigmas, void* const* outs, const void* R, int S, int I,
          int K, const long long* strides, int I2, long long run, int runs,
          int n, int flags, void* ranges, int ranges_len, void* planes,
          long long planes_len, void* stream) {
  ApplyArgs p;
  int err = prepare(&p, split, nrows, us, Js, sigmas, outs, R, S, I, K,
                    strides, I2, run, runs, n, flags);
  if (err) return err;
  const long long plane = static_cast<long long>(S) * K * p.ip;
  if (ranges == nullptr || ranges_len < 2 * S * p.tiles_i * p.ncb ||
      planes == nullptr || planes_len < (split ? 2 : 1) * plane) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* rt = static_cast<float*>(planes);
  float* rt_lo = split ? rt + plane : nullptr;
  probe_apply_ranges<<<dim3(static_cast<unsigned>(p.tiles_i),
                            static_cast<unsigned>(S),
                            static_cast<unsigned>(p.ncb)),
                       kThreads, 0, s>>>(static_cast<const float*>(R), I, K,
                                         p.bi, p.tiles_i, p.ip,
                                         static_cast<int*>(ranges), rt,
                                         rt_lo);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  p.ranges = static_cast<const int*>(ranges);
  p.RT = rt;
  p.RTlo = rt_lo;
  KernelFn kernel = split ? x3_kernel(I)
                          : f32_kernel(I, S > 1, (p.flags & kUKVec) != 0);
  return launch(kernel, p, nrows, s);
}

}  // namespace

extern "C" {

int probe_apply_max_rows() { return kMaxRows; }

int probe_apply_max_s() { return kMaxS; }

int probe_apply_max_dim() { return kMaxDim; }

// the rows per tile and elements per sub-tile of the kernel (split: 3x)
// for R (S, I, K)
int probe_apply_tile_rows(int I, int split, int S) {
  return split ? x3_tile(I).bi : f32_tile(I, S > 1).bi;
}

int probe_apply_tile_elems(int I, int split, int S) {
  return split ? x3_tile(I).be : f32_tile(I, S > 1).be;
}

// nrows rows, each with u, J (when flags has kHasJ), sigma (when flags has
// kHasSigma) and out pointers; R (S, I, K) contiguous; strides: u (k, e),
// J (s, e), sigma (i / I2, i % I2, e), out (i, e), in elements; an element
// block takes n elements from each of `runs` runs of `run` elements;
// scratch for the pre-pass: `ranges` (ranges_len int32: 2 S tiles ceil(K /
// 32)) and `planes` (planes_len floats: S K tiles rows).  Launches the
// pre-pass and the kernel; returns the CUDA error of either launch (0 on
// success).
int probe_apply_f32(int nrows, void* const* us, void* const* Js,
                    void* const* sigmas, void* const* outs, const void* R,
                    int S, int I, int K, const long long* strides, int I2,
                    long long run, int runs, int n, int flags, void* ranges,
                    int ranges_len, void* planes, long long planes_len,
                    void* stream) {
  return apply(false, nrows, us, Js, sigmas, outs, R, S, I, K, strides, I2,
               run, runs, n, flags, ranges, ranges_len, planes, planes_len,
               stream);
}

// the same, the dot in three TF32 passes; `planes` holds R's split (2 S K
// tiles rows floats: hi, lo)
int probe_apply_3xtf32(int nrows, void* const* us, void* const* Js,
                       void* const* sigmas, void* const* outs, const void* R,
                       int S, int I, int K, const long long* strides, int I2,
                       long long run, int runs, int n, int flags,
                       void* ranges, int ranges_len, void* planes,
                       long long planes_len, void* stream) {
  return apply(true, nrows, us, Js, sigmas, outs, R, S, I, K, strides, I2,
               run, runs, n, flags, ranges, ranges_len, planes, planes_len,
               stream);
}

}  // extern "C"
