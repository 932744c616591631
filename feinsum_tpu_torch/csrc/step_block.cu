// step_block_f32: K1's general step algebra.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) on the programs no row family of this package
// takes: there every schedule step of an einsum runs on a block of its grid
// letter e (row_result, :812-887, through ops/kernel_lowering.py::
// lower_step), intermediates stay in VMEM, and a contracted e accumulates
// across the grid (:888-921).  The host plans the steps (ops/step_block.py)
// and builds, per row, int64 offset tables (ops/kernels.py::
// step_block_tables); this kernel runs them:
//
//     result[o, e] = sum_c prod_k operand_k[out_k[o] + sum_k[c] + e * es_k]
//
// for every step, output entry o and contracted entry c, the steps in the
// schedule's order.
//
// Design.  Thread blocks run in parallel and in no order:
// * block b takes the elements [b * block_long, (b + 1) * block_long) of e,
//   blockIdx.y the row; the tail mask is the bound e < E.  Without a grid
//   (a concrete einsum whose longest output letter is under 2048) E = 1 and
//   every step is "free";
// * the residents (operands without e) are staged once per block in shared
//   memory by a flat copy of their storage, so the host's offsets address
//   them there; steps without e ("free") run once per block after them;
// * the block walks its elements in sub-tiles of te.  Each streamed input's
//   sub-tile is copied into shared memory by cp.async, 4 bytes per thread
//   and copy, [entry][element] when the input stores e at stride 1, else
//   [element][entry], rows at an odd pitch; two buffers, so that the next
//   sub-tile's copies run under this one's steps;
// * a dense step (two operands whose letters split into M, N, K and batch
//   letters, e aside) runs as register tiles: each thread keeps RM x RN
//   results of one element (entries m = tm + tM * r, n = tn + tN * c, so
//   that a warp's rows fall in different banks) and loads RM + RN values
//   per k for RM * RN FMAs.  The demo ij,ejk->eik and each step of sum
//   factorization take this path;
// * a general step runs as threads over (element, output entry) through
//   its offset tables, each thread computing RT entries along an output
//   letter that one operand alone carries (the last one) and no streamed
//   input, so that the other operands' values are loaded once per term for
//   the RT entries (sum factorization in one step: i, carried by Ax);
// * consecutive threads take consecutive elements when the tensor that
//   dominates the traffic stores e at stride 1 (dof-major), else
//   consecutive entries or tiles;
// * a step's result that a later step reads stays in shared memory for the
//   sub-tile, a barrier between steps; the last step writes the row's output
//   in its stored layout through its offsets;
// * a last step that contracts e writes one partial per entry and block to
//   a workspace, and a second launch sums each entry's partials in block
//   order.  A general one keeps its partial sums in shared memory, each
//   owned by one thread.  A dense one, which must be the only step on the
//   elements (the Gram matrix ei,ej->ij), is a split-K product: each thread
//   keeps one register tile of one group of elements across all the block's
//   sub-tiles and writes it once, with one group straight to the
//   workspace; a result of more tiles than threads takes rounds of kThreads
//   tiles, each walking the block's elements again.  No float atomics: the
//   result is the same from run to run.
//
// What bounds it on an H100: a dense step's FMAs and shared-memory loads
// (RM * RN FMAs, four warp instructions per SM clock, against RM + RN loads,
// one wavefront per clock: even at 8 x 8 it is at most half the fp32 peak),
// the bytes of the streamed inputs and the output for the rest; the
// sub-tile's shared memory (the host picks te, ops/step_block.py::_pick_te)
// bounds the blocks per SM.  A general step of several contracted letters
// reads its tables per term.
//
// Float32 throughout; each entry's products are summed in the contracted
// entries' order, one fmaf per term.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kMaxSteps = 8;
constexpr int kMaxOps = 4;
constexpr int kMaxInputs = 8;
constexpr int kMaxRT = 8;
constexpr int kStepInts = 24, kStepTables = 18, kStageInts = 8;
constexpr int kSumX = 32, kSumY = 32;   // second launch: entries x groups
constexpr size_t kMaxSmemBytes = 232448;

enum Kind { kFree = 0, kElement = 1, kReduce = 2 };

struct Step {
  int kind, nops, n_out, n_sum;
  int src[kMaxOps];  // >= 0: the row's input slot; < 0: -1 - an earlier step
  int dst;           // float offset of the result in shared memory; -1: output
  int es;            // element stride of the result in shared memory
  int groups;        // kReduce: partial sums per output entry
  int affine;        // 1: at most one contracted letter, offsets c * stride
  int dense;         // 1: register tiles of rm x rn (the d tables)
  int rt, n_sub;     // general: entries per thread, entries per tile row
  int rm, rn, nM, nN, nK, nB, tM, tN;
  int dsm;           // dense: the int offset of its tables in shared memory
  long long t_out[kMaxOps + 1];  // tables of the entries: operands, result
  long long t_sum[kMaxOps];      // tables of the contracted entries, or
                                 // (affine) the contracted letter's strides
  long long d[9];    // dense: A_m, A_k, A_b, B_n, B_k, B_b, D_m, D_n, D_b
};

struct Row {
  const float* in[kMaxInputs];
  long long es[kMaxInputs];      // element stride of each input
  float* out;
  long long out_es;
};

// How an input is read: a resident staged once per block (res >= 0), a
// streamed input staged per sub-tile (buf >= 0, two buffers of buf_n floats,
// n entries per element at pitch, [entry][element] when efast, goff the
// table of its entries' offsets in the input, or with gaff their stride),
// or read where it lies.  in[ninputs] is the output's sub-tile, one buffer,
// which the last step writes and the block copies out.
struct Stage {
  int res, res_n, buf, buf_n, n, pitch, efast, gaff;
  long long goff;
};

struct Plan {
  Step step[kMaxSteps];
  Row row[kMaxRows];
  Stage in[kMaxInputs + 1];
  int nsteps, ninputs, te, elem_fastest, block_long, staged;
  long long E, row_len;
};

struct Operand {
  const float* base;
  long long es;
  const long long* out;
  const long long* sum;
  long long ss;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Operand k of a step for the current sub-tile: the address of its
// sub-tile's first element, its element stride, its tables.
__device__ __forceinline__ Operand resolve(const Plan& p, const Row& rw,
                                           const Step& st, int k,
                                           const long long* tab,
                                           const float* smem, long long e0,
                                           int parity) {
  Operand op;
  const int src = st.src[k];
  if (src >= 0) {
    const Stage& sg = p.in[src];
    if (sg.res >= 0) {
      op.base = smem + sg.res;
      op.es = 0;
    } else if (sg.buf >= 0) {
      op.base = smem + sg.buf + parity * sg.buf_n;
      op.es = sg.efast ? 1 : sg.pitch;
    } else {
      op.base = rw.in[src] + e0 * rw.es[src];
      op.es = rw.es[src];
    }
  } else {
    const Step& pr = p.step[-1 - src];
    op.base = smem + pr.dst;
    op.es = pr.kind == kElement ? pr.es : 0;
  }
  op.out = tab + st.t_out[k];
  op.sum = st.affine ? nullptr : tab + st.t_sum[k];
  op.ss = st.affine ? st.t_sum[k] : 0;
  return op;
}

// Copy the streamed inputs' sub-tile [e0, e0 + n) into buffer `parity`.
__device__ void stage_issue(const Plan& p, const Row& rw,
                            const long long* tab, float* smem, long long e0,
                            int n, int parity) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < p.ninputs; ++i) {
    const Stage& sg = p.in[i];
    if (sg.buf < 0) continue;
    float* buf = smem + sg.buf + parity * sg.buf_n;
    const long long es = rw.es[i];
    const float* src = rw.in[i] + e0 * es;
    const long long* go = tab + sg.goff;
    if (sg.efast) {
      for (int x = warp; x < sg.n; x += kWarps) {
        const float* s = src + (sg.gaff ? x * sg.goff : go[x]);
        float* d = buf + x * sg.pitch;
        for (int le = lane; le < n; le += 32) cp_async4(d + le, s + le);
      }
    } else if (sg.gaff) {
      for (int le = warp; le < n; le += kWarps) {
        const float* s = src + le * es;
        float* d = buf + le * sg.pitch;
#pragma unroll 4
        for (int x = lane; x < sg.n; x += 32) {
          cp_async4(d + x, s + x * sg.goff);
        }
      }
    } else {
      for (int le = warp; le < n; le += kWarps) {
        const float* s = src + le * es;
        float* d = buf + le * sg.pitch;
        for (int x = lane; x < sg.n; x += 32) cp_async4(d + x, s + go[x]);
      }
    }
  }
}

// Copy the output's sub-tile [e0, e0 + n) from shared memory to the row's
// output, consecutive threads on consecutive addresses.
__device__ void copy_out(const Plan& p, const Row& rw, const long long* tab,
                         const float* smem, long long e0, int n) {
  const Stage& sg = p.in[p.ninputs];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* buf = smem + sg.buf;
  float* out = rw.out + e0 * rw.out_es;
  const long long* go = tab + sg.goff;
  if (sg.efast) {
    for (int x = warp; x < sg.n; x += kWarps) {
      float* d = out + (sg.gaff ? x * sg.goff : go[x]);
      const float* s = buf + x * sg.pitch;
      for (int le = lane; le < n; le += 32) d[le] = s[le];
    }
    return;
  }
  for (int le = warp; le < n; le += kWarps) {
    float* d = out + le * rw.out_es;
    const float* s = buf + le * sg.pitch;
    for (int x = lane; x < sg.n; x += 32) {
      d[sg.gaff ? x * sg.goff : go[x]] = s[x];
    }
  }
}

// RT entries o + r * n_sub of element le: sum_c prod_k of operand k at its
// entry address plus its offset of c (a table, or c times its stride when
// the step contracts at most one letter), the terms in order of c.  The
// operands but the last are the same for the RT entries and loaded once.
template <int N, bool kAffine, int RT>
__device__ __forceinline__ void entry_tile(const Operand (&ops)[kMaxOps],
                                           int o, int n_sub, int le,
                                           int n_sum, float (&acc)[RT]) {
  const float* b[kMaxOps];
#pragma unroll
  for (int k = 0; k < kMaxOps; ++k) {
    b[k] = k < N ? ops[k].base + le * ops[k].es + ops[k].out[o] : nullptr;
  }
  long long ot[RT];
  ot[0] = 0;
#pragma unroll
  for (int r = 1; r < RT; ++r) {
    ot[r] = ops[N - 1].out[o + r * n_sub] - ops[N - 1].out[o];
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) acc[r] = 0.f;
  for (int c = 0; c < n_sum; ++c) {
    float prod = 1.f;
#pragma unroll
    for (int k = 0; k < N - 1; ++k) {
      float v;
      if (kAffine) {
        v = *b[k];
        b[k] += ops[k].ss;
      } else {
        v = b[k][ops[k].sum[c]];
      }
      prod = k == 0 ? v : prod * v;
    }
    const float* w = b[N - 1];
    if (kAffine) {
      b[N - 1] += ops[N - 1].ss;
    } else {
      w += ops[N - 1].sum[c];
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      acc[r] = N == 1 ? acc[r] + w[ot[r]] : fmaf(prod, w[ot[r]], acc[r]);
    }
  }
}

// A general free or element step over n elements of the sub-tile: its
// result entry o of element le goes to dst[le * des + dtab[o]].
template <int N, bool kAffine, int RT>
__device__ void element_step(const Operand (&ops)[kMaxOps], int n_sub,
                             int n_sum, int n, bool elem_fastest, float* dst,
                             long long des, const long long* dtab) {
  const int items = n_sub * n;
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    int o, le;
    if (elem_fastest) {
      le = idx % n;
      o = idx / n;
    } else {
      o = idx % n_sub;
      le = idx / n_sub;
    }
    float acc[RT];
    entry_tile<N, kAffine, RT>(ops, o, n_sub, le, n_sum, acc);
#pragma unroll
    for (int r = 0; r < RT; ++r) dst[le * des + dtab[o + r * n_sub]] = acc[r];
  }
}

// A general step that contracts e: each partial red[o + n_out * g] is owned
// by one thread (or warp) for the whole block, and group g sums its share of
// the sub-tile's elements into it.
template <int N, bool kAffine>
__device__ void reduce_step(const Operand (&ops)[kMaxOps], int n_out,
                            int n_sum, int n, bool elem_fastest, int groups,
                            float* red) {
  float acc[1];
  if (elem_fastest) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int pair = warp; pair < n_out * groups; pair += kWarps) {
      const int o = pair % n_out, g = pair / n_out;
      float part = 0.f;
      for (int le = g * 32 + lane; le < n; le += 32 * groups) {
        entry_tile<N, kAffine, 1>(ops, o, n_out, le, n_sum, acc);
        part += acc[0];
      }
#pragma unroll
      for (int d = 16; d > 0; d /= 2) {
        part += __shfl_xor_sync(0xffffffffu, part, d);
      }
      if (lane == 0) red[pair] += part;
    }
    return;
  }
  for (int l = threadIdx.x; l < n_out * groups; l += kThreads) {
    const int o = l % n_out, g = l / n_out;
    float part = 0.f;
    for (int le = g; le < n; le += groups) {
      entry_tile<N, kAffine, 1>(ops, o, n_out, le, n_sum, acc);
      part += acc[0];
    }
    red[l] += part;
  }
}

extern __shared__ float sb_smem[];

// The values of one k of a register tile: sm[a + oa[r]], sm[b + ob[c]]
template <int RM, int RN>
struct Frag {
  float a[RM], b[RN];

  __device__ __forceinline__ void load(int pa, int pb, const int (&oa)[RM],
                                       const int (&ob)[RN]) {
#pragma unroll
    for (int r = 0; r < RM; ++r) a[r] = sb_smem[pa + oa[r]];
#pragma unroll
    for (int c = 0; c < RN; ++c) b[c] = sb_smem[pb + ob[c]];
  }

  __device__ __forceinline__ void fma(float (&acc)[RM][RN]) const {
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
};

// acc[r][c] += sum over nk steps of sm[a + oa[r]] * sm[b + ob[c]], the
// offsets a, b advancing by da, db per step (or, with tables ak, bk, set
// to a + ak[k], b + bk[k]); the next step's values are loaded before this
// step's FMAs, so that the loads' latency runs under them
template <int RM, int RN>
__device__ __forceinline__ void dense_run(int a, int b, int da, int db,
                                          const int* ak, const int* bk,
                                          const int (&oa)[RM],
                                          const int (&ob)[RN], int nk,
                                          float (&acc)[RM][RN]) {
  if (nk < 1) return;
  Frag<RM, RN> cur, next;
  cur.load(ak ? a + ak[0] : a, bk ? b + bk[0] : b, oa, ob);
  for (int k = 1; k < nk; ++k) {
    a += da;
    b += db;
    next.load(ak ? a + ak[k] : a, bk ? b + bk[k] : b, oa, ob);
    cur.fma(acc);
    cur = next;
  }
  cur.fma(acc);
}

// A dense element step, both operands in shared memory (the planner makes
// a step dense only then): each tile of each element (and batch entry) goes
// to dst[le * des + D_b[b] + D_m[m] + D_n[n]].  Offsets in shared memory are
// 32-bit, so the loads are shared-memory loads.
template <int RM, int RN>
__device__ void dense_step(const Step& st, const Operand& A,
                           const Operand& B, int n, bool elem_fastest,
                           float* dst, long long des) {
  // the tables, staged once per block in shared memory as ints, in the
  // order A_m, A_k, A_b, B_n, B_k, B_b, D_m, D_n, D_b
  const int* Am = reinterpret_cast<const int*>(sb_smem) + st.dsm;
  const int* Ak = Am + st.nM;
  const int* Ab = Ak + st.nK;
  const int* Bn = Ab + st.nB;
  const int* Bk = Bn + st.nN;
  const int* Bb = Bk + st.nK;
  const int* Dm = Bb + st.nB;
  const int* Dn = Dm + st.nM;
  const int* Db = Dn + st.nN;
  const bool affine = st.affine != 0;
  const int sa = affine ? static_cast<int>(st.d[1]) : 0;
  const int sb = affine ? static_cast<int>(st.d[4]) : 0;
  const int a0 = static_cast<int>(A.base - sb_smem);
  const int b0 = static_cast<int>(B.base - sb_smem);
  const int ea = static_cast<int>(A.es), eb = static_cast<int>(B.es);
  const int tiles = st.tM * st.tN;
  const int items = n * st.nB;
  const int units = items * tiles;
  for (int u = threadIdx.x; u < units; u += kThreads) {
    int item, tile;
    if (elem_fastest) {
      item = u % items;
      tile = u / items;
    } else {
      tile = u % tiles;
      item = u / tiles;
    }
    const int tm = tile % st.tM, tn = tile / st.tM;
    int oa[RM], ob[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) oa[r] = Am[min(tm + st.tM * r, st.nM - 1)];
#pragma unroll
    for (int c = 0; c < RN; ++c) ob[c] = Bn[min(tn + st.tN * c, st.nN - 1)];
    float acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
    }
    const int le = item / st.nB, bb = item % st.nB;
    dense_run<RM, RN>(a0 + le * ea + Ab[bb], b0 + le * eb + Bb[bb], sa, sb,
                      affine ? nullptr : Ak, affine ? nullptr : Bk, oa, ob,
                      st.nK, acc);
    float* d = dst + le * des + Db[bb];
    int dn[RN];
#pragma unroll
    for (int c = 0; c < RN; ++c) dn[c] = Dn[min(tn + st.tN * c, st.nN - 1)];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = tm + st.tM * r;
      if (m >= st.nM) continue;
      float* dr = d + Dm[m];
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        if (tn + st.tN * c < st.nN) dr[dn[c]] = acc[r][c];
      }
    }
  }
}

// Walk the block's elements [e_begin, e_end) in sub-tiles: each streamed
// input's next sub-tile is copied under this one's work, and body(e0, n,
// parity) runs once its inputs are in shared memory.  The body ends with a
// barrier, so that the copies into its buffer wait for its readers.
template <class Body>
__device__ __forceinline__ void sub_tiles(const Plan& p, const Row& rw,
                                          const long long* tab, float* smem,
                                          long long e_begin, long long e_end,
                                          Body body) {
  if (p.staged && e_begin < e_end) {
    stage_issue(p, rw, tab, smem, e_begin,
                static_cast<int>(min(static_cast<long long>(p.te),
                                     e_end - e_begin)), 0);
    cp_commit();
  }
  int parity = 0;
  for (long long e0 = e_begin; e0 < e_end; e0 += p.te, parity ^= 1) {
    const int n = static_cast<int>(min(static_cast<long long>(p.te),
                                       e_end - e0));
    if (p.staged) {
      const long long next = e0 + p.te;
      if (next < e_end) {
        stage_issue(p, rw, tab, smem, next,
                    static_cast<int>(min(static_cast<long long>(p.te),
                                         e_end - next)), parity ^ 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
    }
    body(e0, n, parity);
  }
}

// The register tiles (RM, RN) the kernel is built for, ops/kernels.py::
// SB_TILES: RM, RN in {1, 2, 4, 8}, the edge of a result that no power of
// two divides clamped (min() above), and 5 x 5 and 7 x 1, which sum
// factorization on Q4 and ndof 35 take
#define SB_DENSE_ROW(RM)                                                    \
  SB_DENSE(RM, 1) SB_DENSE(RM, 2) SB_DENSE(RM, 4) SB_DENSE(RM, 8)
#define SB_DENSE_TILES                                                      \
  SB_DENSE_ROW(1) SB_DENSE_ROW(2) SB_DENSE_ROW(4) SB_DENSE_ROW(8)           \
  SB_DENSE(5, 5) SB_DENSE(7, 1)
#define SB_GENERAL_RT(N, A)                                                 \
  SB_ELEMENT(N, A, 1) SB_ELEMENT(N, A, 2) SB_ELEMENT(N, A, 3)               \
  SB_ELEMENT(N, A, 4) SB_ELEMENT(N, A, 5) SB_ELEMENT(N, A, 6)               \
  SB_ELEMENT(N, A, 7) SB_ELEMENT(N, A, 8)

// One step on n elements from e0 (a free step: n = 1, e0 = 0).  Not
// inlined: it holds every step instance, and its two call sites (the free
// steps, the sub-tiles' loop) would each compile them all.
__device__ __noinline__ void run_step(const Plan& p, const Row& rw, int s,
                                      const long long* tab, float* smem,
                                      long long e0, int n, int parity) {
  const Step& st = p.step[s];
  Operand ops[kMaxOps];
#pragma unroll
  for (int k = 0; k < kMaxOps; ++k) {
    ops[k] = resolve(p, rw, st, k < st.nops ? k : 0, tab, smem, e0, parity);
  }
  const bool ef = p.elem_fastest != 0;
  float* dst;
  long long des;
  if (st.kind == kReduce) {
    dst = smem + st.dst;
    des = 0;
  } else if (st.dst >= 0) {
    dst = smem + st.dst;
    des = st.kind == kElement ? st.es : 0;
  } else if (st.kind == kElement && p.in[p.ninputs].buf >= 0) {
    const Stage& so = p.in[p.ninputs];
    dst = smem + so.buf;
    des = so.efast ? 1 : so.pitch;
  } else {
    dst = rw.out + e0 * rw.out_es;
    des = rw.out_es;
  }
  if (st.dense) {
    switch (st.rm * 16 + st.rn) {
#define SB_DENSE(RM, RN)                                                    \
  case RM * 16 + RN:                                                        \
    dense_step<RM, RN>(st, ops[0], ops[1], n, ef, dst, des);                \
    break;
      SB_DENSE_TILES
#undef SB_DENSE
    }
    return;
  }
  if (st.kind == kReduce) {
    switch (st.nops * 2 + (st.affine ? 1 : 0)) {
#define SB_REDUCE(N, A)                                                     \
  case N * 2 + (A ? 1 : 0):                                                 \
    reduce_step<N, A>(ops, st.n_out, st.n_sum, n, ef, st.groups, dst);      \
    break;
      SB_REDUCE(1, false) SB_REDUCE(1, true)
      SB_REDUCE(2, false) SB_REDUCE(2, true)
      SB_REDUCE(3, false) SB_REDUCE(3, true)
      SB_REDUCE(4, false) SB_REDUCE(4, true)
#undef SB_REDUCE
    }
    return;
  }
  const long long* dtab = tab + st.t_out[st.nops];
  switch ((st.nops * 2 + (st.affine ? 1 : 0)) * 16 + st.rt) {
#define SB_ELEMENT(N, A, RT)                                                \
  case (N * 2 + (A ? 1 : 0)) * 16 + RT:                                     \
    element_step<N, A, RT>(ops, st.n_sub, st.n_sum, n, ef, dst, des, dtab); \
    break;
    SB_ELEMENT(1, false, 1) SB_ELEMENT(1, true, 1)
    SB_GENERAL_RT(2, false) SB_GENERAL_RT(2, true)
    SB_GENERAL_RT(3, false) SB_GENERAL_RT(3, true)
    SB_GENERAL_RT(4, false) SB_GENERAL_RT(4, true)
#undef SB_ELEMENT
  }
}

// A block whose only step on the elements is a dense reduce (a split-K
// product over them; the planner makes a reduce dense only then): each
// thread keeps one register tile of one group of elements across all the
// block's sub-tiles and writes it once: straight to the block's partials
// (out) with one group, else to its slot in shared memory.  A result of more
// tiles than threads takes rounds of kThreads tiles, each of which walks the
// block's elements again.
template <int RM, int RN>
__device__ void dense_reduce_block(const Plan& p, const Row& rw,
                                   const long long* tab, float* smem,
                                   long long e_begin, long long e_end,
                                   float* out) {
  const int ls = p.nsteps - 1;
  const Step& st = p.step[ls];
  const int* Am = reinterpret_cast<const int*>(sb_smem) + st.dsm;
  const int* Ak = Am + st.nM;
  const int* Bn = Ak + st.nK + st.nB;
  const int* Bk = Bn + st.nN;
  const int* Dm = Bk + st.nK + st.nB;
  const int* Dn = Dm + st.nM;
  const bool affine = st.affine != 0;
  const int sa = affine ? static_cast<int>(st.d[1]) : 0;
  const int sb = affine ? static_cast<int>(st.d[4]) : 0;
  const int tiles = st.tM * st.tN;
  const int units = tiles * st.groups;
  for (int u0 = 0; u0 < units; u0 += kThreads) {
    const bool active = u0 + static_cast<int>(threadIdx.x) < units;
    const int u = active ? u0 + static_cast<int>(threadIdx.x) : 0;
    const int tile = u % tiles, g = u / tiles;
    const int tm = tile % st.tM, tn = tile / st.tM;
    int oa[RM], ob[RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) oa[r] = Am[min(tm + st.tM * r, st.nM - 1)];
#pragma unroll
    for (int c = 0; c < RN; ++c) ob[c] = Bn[min(tn + st.tN * c, st.nN - 1)];
    float acc[RM][RN];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
#pragma unroll
      for (int c = 0; c < RN; ++c) acc[r][c] = 0.f;
    }
    sub_tiles(p, rw, tab, smem, e_begin, e_end,
              [&](long long e0, int n, int parity) {
      if (active) {
        const Operand A = resolve(p, rw, st, 0, tab, smem, e0, parity);
        const Operand B = resolve(p, rw, st, 1, tab, smem, e0, parity);
        const int ea = static_cast<int>(A.es), eb = static_cast<int>(B.es);
        const int a0 = static_cast<int>(A.base - sb_smem) + g * ea;
        const int b0 = static_cast<int>(B.base - sb_smem) + g * eb;
        // K = this group's elements of the sub-tile (and the other K
        // letters): for each k, the elements in order
        const int ne = g < n ? (n - 1 - g) / st.groups + 1 : 0;
        for (int k = 0; k < st.nK; ++k) {
          dense_run<RM, RN>(a0 + (affine ? k * sa : Ak[k]),
                            b0 + (affine ? k * sb : Bk[k]), st.groups * ea,
                            st.groups * eb, nullptr, nullptr, oa, ob, ne,
                            acc);
        }
      }
      __syncthreads();
    });
    if (!active) continue;
    float* d = st.groups == 1 ? out : smem + st.dst + g * st.n_out;
    int dn[RN];
#pragma unroll
    for (int c = 0; c < RN; ++c) dn[c] = Dn[min(tn + st.tN * c, st.nN - 1)];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int m = tm + st.tM * r;
      if (m >= st.nM) continue;
      float* dr = d + Dm[m];
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        if (tn + st.tN * c < st.nN) dr[dn[c]] = acc[r][c];
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
step_block_kernel(const __grid_constant__ Plan p,
                  const long long* __restrict__ tables, float* partial) {
  float* smem = sb_smem;
  const Row& rw = p.row[blockIdx.y];
  const long long* tab = tables + blockIdx.y * p.row_len;
  const Step& last = p.step[p.nsteps - 1];

  for (int i = 0; i < p.ninputs; ++i) {
    if (p.in[i].res < 0) continue;
    const float* src = rw.in[i];
    float* dst = smem + p.in[i].res;
    for (int k = threadIdx.x; k < p.in[i].res_n; k += kThreads) {
      dst[k] = src[k];
    }
  }
  if (last.kind == kReduce && last.dst >= 0) {
    for (int k = threadIdx.x; k < last.n_out * last.groups; k += kThreads) {
      smem[last.dst + k] = 0.f;
    }
  }
  for (int s = 0; s < p.nsteps; ++s) {
    const Step& st = p.step[s];
    if (!st.dense) continue;
    int* dst = reinterpret_cast<int*>(smem) + st.dsm;
    const int len = 2 * (st.nM + st.nN + st.nK) + 3 * st.nB;
    for (int k = threadIdx.x; k < len; k += kThreads) {
      dst[k] = static_cast<int>(tab[st.d[0] + k]);
    }
  }
  __syncthreads();
  for (int s = 0; s < p.nsteps; ++s) {
    if (p.step[s].kind != kFree) continue;
    run_step(p, rw, s, tab, smem, 0, 1, 0);
    __syncthreads();
  }

  const long long e_begin = static_cast<long long>(blockIdx.x) * p.block_long;
  const long long e_end = min(p.E, e_begin + p.block_long);
  float* part = partial == nullptr ? nullptr : partial +
      (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
          last.n_out;
  if (last.kind == kReduce && last.dense) {
    switch (last.rm * 16 + last.rn) {
#define SB_DENSE(RM, RN)                                                    \
  case RM * 16 + RN:                                                        \
    dense_reduce_block<RM, RN>(p, rw, tab, smem, e_begin, e_end, part);     \
    break;
      SB_DENSE_TILES
#undef SB_DENSE
    }
  } else {
    sub_tiles(p, rw, tab, smem, e_begin, e_end,
              [&](long long e0, int n, int parity) {
      for (int s = 0; s < p.nsteps; ++s) {
        if (p.step[s].kind == kFree) continue;
        run_step(p, rw, s, tab, smem, e0, n, parity);
        __syncthreads();
      }
      if (p.in[p.ninputs].buf >= 0) {
        copy_out(p, rw, tab, smem, e0, n);
        __syncthreads();
      }
    });
  }

  if (last.kind == kReduce && last.dst >= 0) {
    __syncthreads();
    for (int o = threadIdx.x; o < last.n_out; o += kThreads) {
      float t = 0.f;
      for (int g = 0; g < last.groups; ++g) {
        t += smem[last.dst + o + g * last.n_out];
      }
      part[o] = t;
    }
  }
}

// out[o] = the sum of the blocks' partials of entry o: 32 threads per entry
// each sum every 32nd partial in block order, then a pairwise tree.
__global__ void __launch_bounds__(kSumX * kSumY)
step_block_sum(const __grid_constant__ Plan p,
               const long long* __restrict__ tables, const float* partial,
               int nblocks) {
  __shared__ float red[kSumY][kSumX + 1];
  const Step& last = p.step[p.nsteps - 1];
  const Row& rw = p.row[blockIdx.y];
  const int o = blockIdx.x * kSumX + threadIdx.x;
  float s = 0.f;
  if (o < last.n_out) {
    const float* src =
        partial + static_cast<size_t>(blockIdx.y) * nblocks * last.n_out + o;
    for (int b = threadIdx.y; b < nblocks; b += kSumY) {
      s += src[static_cast<size_t>(b) * last.n_out];
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
  if (threadIdx.y == 0 && o < last.n_out) {
    const long long* dtab =
        tables + blockIdx.y * p.row_len + last.t_out[last.nops];
    rw.out[dtab[o]] = red[0][threadIdx.x];
  }
}

bool dense_tile_built(int rm, int rn) {
  bool built = false;
#define SB_DENSE(RM, RN) built |= rm == RM && rn == RN;
  SB_DENSE_TILES
#undef SB_DENSE
  return built;
}

}  // namespace

extern "C" {

int step_block_f32_max_rows() { return kMaxRows; }

// ptrs, es: nrows x (ninputs + 1) {the input views..., the output view} and
// their element strides (of e); steps_i: nsteps x {kind, nops, n_out, n_sum,
// src[4], dst, es, groups, affine, dense, rt, n_sub, rm, rn, nM, nN, nK, nB,
// tM, tN, dsm}; steps_t: nsteps x {t_out[5], t_sum[4], d[9]} (with affine,
// t_sum holds the contracted letter's strides); stage_i: (ninputs + 1) x
// {res, res_n, buf, buf_n, n, pitch, efast, gaff}, the last the output's
// sub-tile; stage_t: (ninputs + 1) x goff (with gaff, the entries'
// stride); tables: nrows x row_len int64 offsets on the card; smem_floats:
// shared memory per block; workspace: nrows * ceil(E / block_long) * n_out floats when the last step
// contracts e.  Returns the CUDA error of the launches (0 on success).
int step_block_f32(int nrows, int ninputs, void* const* ptrs,
                   const long long* es, int nsteps, const int* steps_i,
                   const long long* steps_t, const int* stage_i,
                   const long long* stage_t, const void* tables,
                   long long row_len, int te, int elem_fastest, long long E,
                   int block_long, int smem_floats, void* workspace,
                   void* stream) {
  if (nrows < 1 || nrows > kMaxRows || ninputs < 1 || ninputs > kMaxInputs ||
      nsteps < 1 || nsteps > kMaxSteps || te < 1 || E < 1 || block_long < 1 ||
      smem_floats < 0 || tables == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.nsteps = nsteps;
  p.ninputs = ninputs;
  p.te = te;
  p.elem_fastest = elem_fastest ? 1 : 0;
  p.block_long = block_long;
  p.E = E;
  p.row_len = row_len;
  p.staged = 0;
  for (int i = 0; i <= ninputs; ++i) {
    const int* gi = stage_i + kStageInts * i;
    Stage& sg = p.in[i];
    sg.res = gi[0];
    sg.res_n = gi[1];
    sg.buf = gi[2];
    sg.buf_n = gi[3];
    sg.n = gi[4];
    sg.pitch = gi[5];
    sg.efast = gi[6] ? 1 : 0;
    sg.gaff = gi[7] ? 1 : 0;
    sg.goff = stage_t[i];
    if (sg.buf >= 0) {
      const int span = sg.efast ? sg.n * sg.pitch : te * sg.pitch;
      const int buffers = i < ninputs ? 2 : 1;
      if (sg.res >= 0 || sg.n < 1 || span > sg.buf_n ||
          (sg.efast ? sg.pitch < te : sg.pitch < sg.n) ||
          sg.buf + static_cast<long long>(buffers) * sg.buf_n > smem_floats) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
      if (i < ninputs) p.staged = 1;
    } else if (i == ninputs && sg.res >= 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int s = 0; s < nsteps; ++s) {
    Step& st = p.step[s];
    const int* si = steps_i + kStepInts * s;
    const long long* stt = steps_t + kStepTables * s;
    st.kind = si[0];
    st.nops = si[1];
    st.n_out = si[2];
    st.n_sum = si[3];
    for (int k = 0; k < kMaxOps; ++k) st.src[k] = si[4 + k];
    st.dst = si[8];
    st.es = si[9];
    st.groups = si[10];
    st.affine = si[11] ? 1 : 0;
    st.dense = si[12] ? 1 : 0;
    st.rt = si[13];
    st.n_sub = si[14];
    st.rm = si[15];
    st.rn = si[16];
    st.nM = si[17];
    st.nN = si[18];
    st.nK = si[19];
    st.nB = si[20];
    st.tM = si[21];
    st.tN = si[22];
    st.dsm = si[23];
    for (int k = 0; k <= kMaxOps; ++k) st.t_out[k] = stt[k];
    for (int k = 0; k < kMaxOps; ++k) st.t_sum[k] = stt[kMaxOps + 1 + k];
    for (int k = 0; k < 9; ++k) st.d[k] = stt[2 * kMaxOps + 1 + k];
    if (st.nops < 1 || st.nops > kMaxOps || st.n_out < 1 || st.n_sum < 1 ||
        st.groups < 1 || st.kind < kFree || st.kind > kReduce ||
        (st.kind == kReduce && (s != nsteps - 1 || workspace == nullptr)) ||
        (s != nsteps - 1 && st.dst < 0) ||
        (st.kind == kReduce && st.dst < 0 &&
         !(st.dense && st.groups == 1))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (st.dense && st.kind == kReduce) {
      for (int k = 0; k < s; ++k) {
        if (p.step[k].kind != kFree) {
          return static_cast<int>(cudaErrorInvalidValue);
        }
      }
    }
    if (st.dense) {
      for (int k = 0; k < 2; ++k) {
        const int src = st.src[k];
        if (src >= 0 && src < ninputs && p.in[src].res < 0 &&
            p.in[src].buf < 0) {
          return static_cast<int>(cudaErrorInvalidValue);  // not in smem
        }
      }
      if (st.nops != 2 || st.kind == kFree ||
          !dense_tile_built(st.rm, st.rn) || st.nM < 1 || st.nN < 1 ||
          st.nK < 1 || st.nB < 1 || st.tM * st.rm < st.nM ||
          st.tN * st.rn < st.nN || st.nM * st.nN * st.nB != st.n_out ||
          st.dsm < 0 ||
          st.dsm + 2LL * (st.nM + st.nN + st.nK) + 3LL * st.nB >
              smem_floats ||
          (st.kind == kReduce && st.nB != 1)) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    } else if (st.rt < 1 || st.rt > kMaxRT || st.n_sub * st.rt != st.n_out ||
               (st.rt > 1 && (st.nops < 2 || st.kind != kElement))) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int k = 0; k < st.nops; ++k) {
      if (st.src[k] >= ninputs || -1 - st.src[k] >= s) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  for (int r = 0; r < nrows; ++r) {
    Row& rw = p.row[r];
    for (int i = 0; i < ninputs; ++i) {
      rw.in[i] = static_cast<const float*>(ptrs[(ninputs + 1) * r + i]);
      rw.es[i] = es[(ninputs + 1) * r + i];
      if (rw.in[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    }
    rw.out = static_cast<float*>(ptrs[(ninputs + 1) * r + ninputs]);
    rw.out_es = es[(ninputs + 1) * r + ninputs];
    if (rw.out == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(tables);
  float* partial = static_cast<float*>(workspace);
  step_block_kernel<<<dim3(static_cast<unsigned>(nblocks),
                           static_cast<unsigned>(nrows)),
                      kThreads, smem, s>>>(p, tab, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const Step& last = p.step[nsteps - 1];
  if (last.kind == kReduce) {
    step_block_sum<<<dim3(static_cast<unsigned>((last.n_out + kSumX - 1) /
                                                kSumX),
                          static_cast<unsigned>(nrows)),
                     dim3(kSumX, kSumY), 0, s>>>(p, tab, partial,
                                                 static_cast<int>(nblocks));
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // extern "C"
