// long_reduce_f32: the batched-einsum rows whose long axis is contracted.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) when its grid axis is contracted.  There the
// grid runs in order ("arbitrary" semantics, :1024), each step adds its
// block's value into the resident output (:911-921) and the padded last
// block is masked (:876-900).  For every planned row (ops/dg_rows.py::
// plan_long_reduce_row) this kernel computes
//
//     out[p?, q?, c?] = sum_e sum_{c, if contracted} A[e, p?, c?] * B[e, q?, c?]
//
// where A and B are the row's streamed operands over the long axis e with at
// most one short letter each: A's output letter p, B's output letter q, or a
// letter c that is contracted or (shared by both) an output letter.  B may be
// absent (taken as 1).  This covers the energy ej,ej->, the per-letter sums
// ej,ej->j and the Gram matrix ei,ej->ij, in either stored layout.
//
// What bounds it on an H100: bytes for the energy and ej,ej->j (2 FMAs per
// 8 bytes read); the Gram matrix at 35 x 35 does 1225 FMAs per 280 bytes,
// 8.75 flop per byte, below the fp32 ridge (about 20) but close enough that
// shared-memory loads decide its time unless each loaded value feeds
// several FMAs.
//
// Design.  Thread blocks run in parallel and in no order, so nothing carries
// from one block to the next:
// * block b takes the contiguous range [b * block_long, (b + 1) * block_long)
//   of e; the tail mask is the bound e < E;
// * it stages tiles of te elements of A and of B (te chosen by the caller so
//   that two buffers fit the block's shared memory) with
//   coalesced reads (e fastest for dof-major storage, the short letter
//   fastest for element-major), each element's row padded to an odd pitch,
//   so the 32 threads of a warp reading one column hit 32 banks; B is not
//   staged again when it is A (the energy);
// * the copies are asynchronous (cp.async) into two buffers: the next
//   tile's copies are in flight while the block sums this one, and they
//   hold no registers;
// * its threads own lanes (output entry o, group g): group g of an entry sums
//   every G-th element of a tile, G = 256 / O for O <= 256 output entries; a
//   lane's tile sum is added to its register accumulator once per tile;
// * an outer product (A's letter p and B's letter q both in the output, the
//   Gram matrix) runs long_reduce_outer instead: a thread owns a 4 x 4 tile
//   of (p, q) entries and a group g, and per element loads 4 values of A and
//   4 of B for 16 FMAs (the lanes above load 2 values per FMA); it takes up
//   to 256 such tiles (P and Q up to 64);
// * the block sums the G groups of each entry with a pairwise tree in shared
//   memory and writes one partial per entry to a (nblocks, O) workspace;
// * a second launch sums each entry's partials across blocks: 32 threads per
//   entry each sum every 32nd partial in block order, then a pairwise tree.
// There are no float atomics: every addition has a fixed place, so the
// result is the same from run to run.  Float32 throughout; the longest
// serial chain of additions is a lane's tile sum (te * K / G terms), then the
// tiles of one block, then nblocks / 32 partials.  At E = 1M and 1,000,003
// (chip_smoke.py phase 12, on an H100) the error against float64 is at most
// 2.7e-8 (energy), 8.9e-8 (ej,ej->j) and 1.2e-7 (Gram) of the sum of the
// terms' magnitudes; the plain version's (torch.matmul) 3.3e-7, 1.6e-6 and
// 7.2e-7.
//
// Staged through registers instead, a tile's loads are not in flight while
// the block sums, and the staging registers cut the blocks per SM: on an
// H100 SXM at 700 W that design took the energy at E = 1M 1.7x as long as
// the two buffers do (PERF.md, chip_smoke.py phase 12).
//
// All rows of a batched einsum run in the same two launches: blockIdx.y is
// the row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;            // threads per block, first launch
constexpr int kMaxRows = 8;
constexpr int kSumX = 32, kSumY = 32;    // second launch: entries x groups

enum Role { kNone = 0, kOut = 1, kShared = 2 };

struct Operand {
  const float* ptr;    // nullptr: an absent B, the value 1
  long long s_e, s_r;  // element strides of e and of the short letter
  int role, len;       // Role; the short letter's length (1 without one)
};

struct Row {
  Operand a, b;
  float* out;
  long long so_p, so_q, so_c;  // output strides (0 where absent)
};

struct Rows {
  Row row[kMaxRows];
};

struct Shape {
  int P, Q, C;      // A's output letter, B's, the shared or contracted letter
  int c_batch;      // 1: c is an output letter, 0: contracted
  int O, K, G;      // output entries, contracted c values, groups per entry
  int tiles, ntq;   // long_reduce_outer: 4 x 4 tiles of (p, q), across q
  long long E;
  int block_long, te;
  int b_staged;     // 0: B absent or the same view as A in every row
};

__host__ __device__ inline int odd_pitch(int r) { return r | 1; }

__host__ __device__ inline int column(const Operand& x, int pq, int c) {
  return x.role == kOut ? pq : (x.role == kShared ? c : 0);
}

// one float from device to shared memory, asynchronously (cp.async)
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one of this thread's committed copy groups is pending
__device__ __forceinline__ void copy_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// tile[el * pitch + r] = X[e0 + el, r] for el < n <= kThreads, copied
// asynchronously with coalesced reads
__device__ void stage(const Operand& x, float* tile, long long e0, int n) {
  const int R = x.len, pitch = odd_pitch(R);
  if (x.s_e == 1 || R == 1) {
    // e fastest (dof-major): thread el copies its element's R values
    const int el = threadIdx.x;
    if (el >= n) return;
    const float* src = x.ptr + (e0 + el) * x.s_e;
    for (int r = 0; r < R; ++r) {
      copy_async(tile + el * pitch + r, src + r * x.s_r);
    }
    return;
  }
  // the short letter fastest: walk the flat index k = el * R + r
  const int del = kThreads / R, dr = kThreads % R;
  int el = threadIdx.x / R, r = threadIdx.x % R;
  for (int k = threadIdx.x; k < n * R; k += kThreads) {
    copy_async(tile + el * pitch + r, x.ptr + (e0 + el) * x.s_e + r * x.s_r);
    el += del;
    r += dr;
    if (r >= R) {
      r -= R;
      ++el;
    }
  }
}

// Runs body(tile_a, tile_b, n) on the block's range of e in tiles of te
// elements, staged in two buffers: the copies of the next tile are in
// flight while body reads this one.  Every thread commits one copy group
// per tile, so that the group counts stay uniform.  Ends with a barrier:
// shared memory is free for the caller.
template <typename Body>
__device__ void for_each_tile(const Row& rw, const Shape& sh, float* smem,
                              Body body) {
  const int pa = odd_pitch(rw.a.len);
  const int buf_floats =
      sh.te * (pa + (sh.b_staged ? odd_pitch(rw.b.len) : 0));
  const long long e_begin = static_cast<long long>(blockIdx.x) * sh.block_long;
  const long long e_end = min(sh.E, e_begin + sh.block_long);
  auto count = [&](long long e0) {
    return static_cast<int>(min(static_cast<long long>(sh.te), e_end - e0));
  };
  auto issue = [&](long long e0, int buf) {
    float* t = smem + buf * buf_floats;
    stage(rw.a, t, e0, count(e0));
    if (sh.b_staged) stage(rw.b, t + sh.te * pa, e0, count(e0));
  };
  issue(e_begin, 0);
  copy_commit();
  int buf = 0;
  for (long long e0 = e_begin; e0 < e_end; e0 += sh.te, buf ^= 1) {
    if (e0 + sh.te < e_end) issue(e0 + sh.te, buf ^ 1);
    copy_commit();
    copy_wait_one();   // this thread's copies of this tile landed
    __syncthreads();   // everyone's
    const float* t = smem + buf * buf_floats;
    body(t, sh.b_staged ? t + sh.te * pa : t, count(e0));
    __syncthreads();   // this buffer is consumed before it is staged again
  }
}

// The block's partials: red[g * O + o] holds group g's sum of entry o; the
// G groups are summed by a pairwise tree and the O sums written to the
// block's row of the workspace.
__device__ void write_partials(float* red, const Shape& sh, float* partial) {
  __syncthreads();
  for (int width = sh.G; width > 1;) {
    const int half = (width + 1) / 2;
    for (int k = threadIdx.x; k < (width - half) * sh.O; k += kThreads) {
      red[k] += red[k + half * sh.O];
    }
    width = half;
    __syncthreads();
  }
  float* dst = partial +
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) * sh.O;
  for (int o = threadIdx.x; o < sh.O; o += kThreads) dst[o] = red[o];
}

// One output entry per lane: thread t owns entry t % O in group t / O,
// which takes every G-th element of a staged tile.
__global__ void __launch_bounds__(kThreads)
long_reduce_blocks(const Rows rows, const Shape sh, float* partial) {
  extern __shared__ float smem[];
  const Row& rw = rows.row[blockIdx.y];
  const int pa = odd_pitch(rw.a.len);
  const int pb = sh.b_staged ? odd_pitch(rw.b.len) : pa;
  const bool has_b = rw.b.ptr != nullptr;
  const int Cb = sh.c_batch ? sh.C : 1;
  const int L = sh.G * sh.O;
  const int a_step = (!sh.c_batch && rw.a.role == kShared) ? 1 : 0;
  const int b_step = (!sh.c_batch && rw.b.role == kShared) ? 1 : 0;
  const int o = threadIdx.x % sh.O, grp = threadIdx.x / sh.O;
  const int cb = o % Cb, pq = o / Cb;
  const int a0 = column(rw.a, pq / sh.Q, cb);
  const int b0 = column(rw.b, pq % sh.Q, cb);
  float acc = 0.f;

  for_each_tile(rw, sh, smem, [&](const float* tile_a, const float* tile_b,
                                  int n) {
    if (threadIdx.x >= L) return;
    if (sh.K == 1) {
      // one product per element (ej,ej->j): four independent sums over
      // group grp's elements, then their sum
      const int G = sh.G;
      const float* ra = tile_a + a0;
      const float* rb = tile_b + b0;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int el = grp;
      for (; el + 3 * G < n; el += 4 * G) {
        s0 = fmaf(ra[el * pa], has_b ? rb[el * pb] : 1.f, s0);
        s1 = fmaf(ra[(el + G) * pa], has_b ? rb[(el + G) * pb] : 1.f, s1);
        s2 = fmaf(ra[(el + 2 * G) * pa], has_b ? rb[(el + 2 * G) * pb] : 1.f,
                  s2);
        s3 = fmaf(ra[(el + 3 * G) * pa], has_b ? rb[(el + 3 * G) * pb] : 1.f,
                  s3);
      }
      for (; el < n; el += G) {
        s0 = fmaf(ra[el * pa], has_b ? rb[el * pb] : 1.f, s0);
      }
      acc += (s0 + s1) + (s2 + s3);
      return;
    }
    // a contracted c: K products per element
    float part = 0.f;
    for (int el = grp; el < n; el += sh.G) {
      const float* ra = tile_a + el * pa + a0;
      const float* rb = tile_b + el * pb + b0;
#pragma unroll 8
      for (int k = 0; k < sh.K; ++k) {
        part = fmaf(ra[k * a_step], has_b ? rb[k * b_step] : 1.f, part);
      }
    }
    acc += part;
  });

  float* red = smem;
  if (threadIdx.x < L) red[threadIdx.x] = acc;
  write_partials(red, sh, partial);
}

// long_reduce_outer: out[p, q] = sum_e A[e, p] * B[e, q].  Thread t owns
// the kTile x kTile entries of tile t % tiles (tiles run across q first) in
// group t / tiles, which takes every G-th element of a staged tile; entries
// past P or Q load a valid column and are never stored.
constexpr int kTile = 4;

__global__ void __launch_bounds__(kThreads)
long_reduce_outer(const Rows rows, const Shape sh, float* partial) {
  extern __shared__ float smem[];
  const Row& rw = rows.row[blockIdx.y];
  const int pa = odd_pitch(rw.a.len);
  const int pb = sh.b_staged ? odd_pitch(rw.b.len) : pa;
  const int tile = threadIdx.x % sh.tiles, grp = threadIdx.x / sh.tiles;
  const int p0 = (tile / sh.ntq) * kTile, q0 = (tile % sh.ntq) * kTile;
  int ia[kTile], ib[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    ia[k] = min(p0 + k, sh.P - 1);
    ib[k] = min(q0 + k, sh.Q - 1);
  }
  float acc[kTile][kTile] = {};

  for_each_tile(rw, sh, smem, [&](const float* tile_a, const float* tile_b,
                                  int n) {
    if (grp >= sh.G) return;
    float part[kTile][kTile] = {};
    for (int el = grp; el < n; el += sh.G) {
      float va[kTile], vb[kTile];
#pragma unroll
      for (int k = 0; k < kTile; ++k) {
        va[k] = tile_a[el * pa + ia[k]];
        vb[k] = tile_b[el * pb + ib[k]];
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          part[i][j] = fmaf(va[i], vb[j], part[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[i][j] += part[i][j];
    }
  });

  float* red = smem;
  if (grp < sh.G) {
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (p0 + i < sh.P && q0 + j < sh.Q) {
          red[grp * sh.O + (p0 + i) * sh.Q + q0 + j] = acc[i][j];
        }
      }
    }
  }
  write_partials(red, sh, partial);
}

__global__ void __launch_bounds__(kSumX * kSumY)
long_reduce_sum(const Rows rows, const Shape sh, const float* partial,
                int nblocks) {
  __shared__ float red[kSumY][kSumX + 1];
  const Row& rw = rows.row[blockIdx.y];
  const int o = blockIdx.x * kSumX + threadIdx.x;
  float s = 0.f;
  if (o < sh.O) {
    const float* src =
        partial + static_cast<size_t>(blockIdx.y) * nblocks * sh.O + o;
    for (int b = threadIdx.y; b < nblocks; b += kSumY) {
      s += src[static_cast<size_t>(b) * sh.O];
    }
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  for (int half = kSumY / 2; half > 0; half /= 2) {
    if (threadIdx.y < half) {
      red[threadIdx.y][threadIdx.x] += red[threadIdx.y + half][threadIdx.x];
    }
    __syncthreads();
  }
  if (threadIdx.y == 0 && o < sh.O) {
    const int Cb = sh.c_batch ? sh.C : 1;
    const int cb = o % Cb, pq = o / Cb;
    rw.out[(pq / sh.Q) * rw.so_p + (pq % sh.Q) * rw.so_q + cb * rw.so_c] =
        red[0][threadIdx.x];
  }
}

int role_len(int role, int out_len, int C) {
  return role == kOut ? out_len : (role == kShared ? C : 1);
}

}  // namespace

extern "C" {

int long_reduce_f32_max_rows() { return kMaxRows; }

// ptrs: nrows x {a, b (may be null), out}; strides: nrows x {a: e, r; b: e,
// r; out: p, q, c} in elements; roles: {a, b} (0 none, 1 output letter,
// 2 shared letter); te: elements of e per staged tile, 1 to 256, so that
// two buffers fit in shared memory; b_staged: 0 when B is absent or the
// same view as A in every row; workspace: nrows * ceil(E / block_long) * O
// floats.  Returns the CUDA error of the launches (0 on success).
int long_reduce_f32(int nrows, void* const* ptrs, const long long* strides,
                    const int* roles, int P, int Q, int C, int c_batch,
                    long long E, int block_long, int te, int b_staged,
                    void* workspace, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || P < 1 || Q < 1 || C < 1 || E < 1 ||
      block_long < 1 || te < 1 || te > kThreads || workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows rows;
  Shape sh;
  sh.P = P;
  sh.Q = Q;
  sh.C = C;
  sh.c_batch = c_batch ? 1 : 0;
  sh.O = P * Q * (c_batch ? C : 1);
  sh.K = c_batch ? 1 : C;
  sh.G = sh.O <= kThreads ? kThreads / sh.O : 1;
  sh.E = E;
  sh.block_long = block_long;
  sh.te = te;
  const bool has_b = ptrs[1] != nullptr;
  sh.b_staged = has_b && b_staged;
  for (int r = 0; r < nrows; ++r) {
    Row& rw = rows.row[r];
    const long long* st = strides + 7 * r;
    rw.a = {static_cast<const float*>(ptrs[3 * r + 0]), st[0], st[1],
            roles[0], role_len(roles[0], P, C)};
    rw.b = {static_cast<const float*>(ptrs[3 * r + 1]), st[2], st[3],
            roles[1], role_len(roles[1], Q, C)};
    rw.out = static_cast<float*>(ptrs[3 * r + 2]);
    rw.so_p = st[4];
    rw.so_q = st[5];
    rw.so_c = st[6];
    if (rw.a.ptr == nullptr || rw.out == nullptr ||
        (rw.b.ptr != nullptr) != has_b) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  // an outer product runs long_reduce_outer (at most kThreads 4 x 4 tiles),
  // every other row long_reduce_blocks (at most kThreads output entries)
  sh.ntq = (Q + kTile - 1) / kTile;
  const int tiles = (P + kTile - 1) / kTile * sh.ntq;
  const bool outer = has_b && roles[0] == kOut && roles[1] == kOut;
  sh.tiles = outer ? tiles : 0;
  if (outer) sh.G = kThreads / tiles;
  const long long nblocks = (E + block_long - 1) / block_long;
  if ((outer ? tiles : sh.O) > kThreads || nblocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int pa = odd_pitch(rows.row[0].a.len);
  const int pb = sh.b_staged ? odd_pitch(rows.row[0].b.len) : 0;
  const int tile_floats = 2 * sh.te * (pa + pb);   // two buffers
  const int red_floats = sh.G * sh.O;
  const size_t smem = sizeof(float) *
      static_cast<size_t>(tile_floats > red_floats ? tile_floats : red_floats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(workspace);
  const dim3 grid(static_cast<unsigned>(nblocks), static_cast<unsigned>(nrows));
  if (outer) {
    long_reduce_outer<<<grid, kThreads, smem, s>>>(rows, sh, partial);
  } else {
    long_reduce_blocks<<<grid, kThreads, smem, s>>>(rows, sh, partial);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  long_reduce_sum<<<dim3(static_cast<unsigned>((sh.O + kSumX - 1) / kSumX),
                         static_cast<unsigned>(nrows)),
                    dim3(kSumX, kSumY), 0, s>>>(rows, sh, partial,
                                                static_cast<int>(nblocks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
