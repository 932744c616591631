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
// The stream path, a kernel of its own (step_block_stream), for a table of
// one dense element step whose operands are both streamed, with no batch
// letter and a result over one operand's letters alone: per element
// out[m] = sum_k W[m, k] * x[k], W the operand that carries the result's
// letters, x the other, of NM x NK entries (each up to kStreamMax: the
// metric products of sum factorization, xrn,rn->xn and xrn,xn->rn, are 3 x
// 3).  The host takes it (ops/kernels.py::step_block_path) only when e lies
// at stride 1 and every pointer and entry stride on 16 bytes, and builds
// the step's dense tables with the tensors' own offsets.  Such a step does
// 2 NM NK flops for 4 (NM NK + NK + NM) bytes an element, so bytes bound
// it, and staging in shared memory only adds work: a thread takes four
// consecutive elements, loads every entry of them as one 16-byte load
// (ld.global.nc.v4) straight into registers, all NK + NM NK of them before
// its first FMA, sums in registers and stores each result entry with one
// 16-byte store; the blocks cover every group of four (up to kStreamBlocks
// a row, then each thread takes the next groups a grid apart).  No shared
// memory, no barrier, no table in the loop: the entries' offsets are
// computed once per thread.  The 3 x 3 instance holds 15 entries, 60
// floats, in registers (74 registers, no spill); the last E % 4 elements
// take one thread each.  On an H100 at 250M elements the 3 x 3 product
// streams at 3.16 TB/s with a block for every 256 groups, at 3.05 with a
// grid of only the blocks resident at once walking them.  The sums are
// the dense path's, term for term (fmaf is exact in its product, so the
// operands' order does not matter): its results are the dense path's bit
// for bit.
//
// The lanes path, a kernel of its own (step_block_lanes), for a table whose
// element steps are all dense products of two operands, at least one of
// them per element, each streamed input and each result but the last read
// by one step (ops/step_block.py::plan_lanes; the host takes it, ops/
// kernels.py::step_block_path, where e lies at stride 1 in every streamed
// input and the output, every pointer and entry stride on 16 bytes, E a
// multiple of 4).  In such a step (SeisSol's ADER derivatives, volume and
// flux terms, sum factorization on hexahedra) most of the work is a
// reference matrix (a resident) times an element's entries, and the block
// kernel's threads each take one element's register tile: every thread
// loads the same reference values again from shared memory, and both
// operands through per-entry offset tables, so that its FMAs wait on
// shared-memory wavefronts, and each sub-tile is staged by 4-byte copies
// through tables (the ADER cell's launches ran at 4-5 TFLOP/s, their
// staging alone 40-46% of their time).  Here a warp's 32 lanes take 32
// consecutive elements at the same tile coordinates: a per-element operand
// (the dofs, S, A, an earlier step's result) lies in shared memory as rows
// [entry][element] of the sub-tile, one conflict-free wavefront a row, and
// a resident, packed once a block as [batch][contracted][free] (its free
// entries padded to whole tiles), is the same for every lane: each
// contracted entry's RW values of it are RW / 4 16-byte broadcasts.  A lane
// keeps RX x RW results of its element in registers (RX rows of X, RW of W;
// SB_LANES_RES, SB_LANES_ELEM), so that a contracted entry costs RX + RW /
// 4 loads for RX RW FMAs (3 x 12: 6 for 36; two per-element operands, RX +
// RW), and the inner loop walks each operand by one stride, the contracted
// letters being the slowest of each region's rows.  Sub-tiles are 32 to 128
// elements.  Each streamed input's sub-tile is one TMA box (a tensor map
// over e and the region's letters, in the order of its rows, so that the
// box lands as the rows [row][element]; zeros past E) that thread 0
// issues, its bytes reported to an mbarrier that every thread waits on:
// the copies take no issue slot of the computing warps (16-byte cp.async
// from every thread, which stalled on the memory system, cost 11-34% of
// a warp's cycles; a bulk copy a row was slower still).  Two buffers where
// they fit, else one, refilled as soon as its reader (and any result laid
// over it) is done, so that the copies run under the later steps; results
// lie in shared memory, a region reused once its reader is done, and the
// last step writes the output from registers, 128 bytes a warp.  What
// bounds it on an H100: the FMAs against the loads' issue and wavefronts
// (four FMA warp instructions a clock an SM, one wavefront); then the
// sub-tile's shared memory, which bounds the blocks an SM: where one block
// fits (the ADER cell's first derivative, volume and flux, whose
// 540-float intermediates take 69 KB a 32-element sub-tile) a block has
// 512 threads, else 256, so that 16 warps share an SM either way.  On an
// H100 at E = 4M the ADER cell's six launches took about 44 ms against
// 204 on the block kernel, the three flop-heavy ones at 19-21 TFLOP/s;
// 38.7 with chained pairs (below).  The sums are the block kernel's, term
// for term: its results are the dense path's bit for bit.
//
// Chained pairs on the lanes path (lane_chain; ops/step_block.py::
// lane_chain_groups finds them, plan_lanes weighs them).  Where a resident
// x per-element step k feeds a per-element x per-element step k + 1 alone,
// and step k + 1 contracts all of step k's X letters first (the ADER
// derivatives' T[q, x, k] = sum_l I[l, q] K[x, k, l] then out[k, p] =
// sum_{q, x} T[q, x, k] S[x, q, p]; the flux's T1[q, f, m] then T2[f, m, p]
// = sum_q T1[q, f, m] A[f, q, p]), the per-element x per-element step was a
// short contraction (9 or 27 entries) over an operand the step before had
// just written to shared memory: 540 floats an element, 69 KB a 32-element
// sub-tile, written, a barrier, read back.  A chained unit takes a batch
// entry and RM of step k + 1's free entries on the first result's side
// (RM k rows, or RM m rows of one face f) and keeps in registers, for RQ
// of step k's X rows (q) at a time, the first result over its tile: RQ x
// RW, RW the tile's NKW contracted entries of W's side (x) times RM, read
// as RW / 4 broadcasts of a resident packed per tile; each of those
// entries is then one contracted entry of step k + 1, NN (all of p) rows
// of the per-element operand against RM x NN accumulators that also stay
// in registers (the (3, 12) tile of q and (x, 4 k): 36 + 36 accumulators).
// The first result never reaches shared memory, nor its barrier: the
// derivatives' shared memory falls from 91-221 KB a block to the two
// streamed regions, so that sub-tiles and blocks can grow.  A plan with
// chains runs its own kernel instance (CHAIN), which inlines its steps and
// pairs: as a second call out of the kernel the chained unit spilled, and
// made run_lane_step spill; its next entry's values are not loaded ahead
// (that spilled too), so the other warps hide the loads.  What bounds it
// on an H100: a unit is long and there are few of them (5-20 a 32-element
// sub-tile), so a round takes the busiest scheduler's units; then the
// resident half's FMAs against the X rows' and broadcasts' issue, as in
// an unchained step.  At E = 4M (chained / unchained plan, ms): derivative
// 0 7.18 / 9.66, 1 3.27 / 4.41, 2 2.03 / 2.07, 3 1.53 / 1.60, flux 14.58
// / 16.69; the first at 26.5 TFLOP/s.  The sums run in step k + 1's
// contracted order (the X rows', then the tile's NKW), each first-result
// entry in step k's: the block kernel's, term for term.
//
// A second kind of pair: step k has batch letters, which step k + 1
// contracts after step k's X letters (SeisSol's viscoelastic flux, whose
// schedule at 15 quantities is T0[q, f, m] = sum_n I[n, q] R[f, m, n],
// T1[q, f, k] = sum_m T0[q, f, m] L[f, k, m], batch f, then out[k, p] =
// sum_{q, f} T1[q, f, k] A[f, q, p]).  Unchained, T1 (1,260 floats an
// element) and its operands need 1,800 rows of regions at a step, 230 KB a
// 32-element sub-tile, more than a block has, and the launch ran on the
// block kernel at 2.4 TFLOP/s.  Chained, the unit's tile carries the batch:
// its NKW entries (the faces) each read X's rows at their own batch entry
// (RQ x NKW loads a contracted entry, XB in lane_chain), and only I, A and
// T0 hold regions: 1,395 rows, 196,608 bytes a block with the packed R and
// L.  So only 32-element sub-tiles fit, one 512-thread block an SM, and
// these instances (SB_LANE_CHAINS_BATCH) run in a kernel instance of their
// own (CHAIN 2), so that the other chains' code stays as it was.  What
// bounds it on an H100: a sub-tile has 35 / RM units for 16 warps, each a
// long run of X loads (four a broadcast of the resident) and FMAs; at RQ 3,
// RM 3 (12 units) 12 loads and 3 broadcasts a contracted entry for 36
// FMAs.  At E = 1M the flux took 4.93 ms against 47.69 on the block kernel
// (23.3 TFLOP/s, 35% of its bound; RQ 1 and RM 2-5, RQ 3 and RM 2:
// 5.58-6.99 ms).
//
// Float32 throughout; each entry's products are summed in the contracted
// entries' order, one fmaf per term.

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "tma_ring.cuh"

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
constexpr int kStreamMax = 3;   // the stream path's NM, NK at most
constexpr long long kStreamBlocks = 1 << 20;   // its blocks a row at most
enum Path { kBlockPath = 0, kStreamPath = 1 };

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

extern __shared__ __align__(128) float sb_smem[];

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

// The stream path's instances (NM, NK), each up to kStreamMax
#define SB_STREAM_ROW(NM) SB_STREAM(NM, 1) SB_STREAM(NM, 2) SB_STREAM(NM, 3)
#define SB_STREAM_SHAPES SB_STREAM_ROW(1) SB_STREAM_ROW(2) SB_STREAM_ROW(3)

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

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The stream path (the note above): the one step of row blockIdx.y,
// out[m] = sum_k W[m, k] * x[k] for every element, through its dense tables
// (A_m, A_k, A_b, B_n, B_k, B_b, D_m, D_n, D_b; K's as strides when
// affine), which hold the tensors' own offsets.  W is operand 0 when the
// step has no N letter (its rows are M), else operand 1 (its rows are N).
template <int NM, int NK>
__global__ void __launch_bounds__(kThreads)
step_block_stream(const __grid_constant__ Plan p,
                  const long long* __restrict__ tables) {
  const Row& rw = p.row[blockIdx.y];
  const long long* tab = tables + blockIdx.y * p.row_len;
  const Step& st = p.step[0];
  const bool wa = st.nN == 1;
  auto at = [&](int q, int i) { return tab[st.d[q] + i]; };
  auto kth = [&](int q, int k) {
    return st.affine ? k * st.d[q] : tab[st.d[q] + k];
  };
  long long ow[NM][NK], ox[NK], oo[NM];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    ox[k] = wa ? at(3, 0) + kth(4, k) + at(5, 0)
               : at(0, 0) + kth(1, k) + at(2, 0);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      ow[m][k] = wa ? at(0, m) + kth(1, k) + at(2, 0)
                    : at(3, m) + kth(4, k) + at(5, 0);
    }
  }
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    oo[m] = (wa ? at(6, m) + at(7, 0) : at(6, 0) + at(7, m)) + at(8, 0);
  }
  const float* W = rw.in[st.src[wa ? 0 : 1]];
  const float* X = rw.in[st.src[wa ? 1 : 0]];
  float* out = rw.out;
  const long long groups = p.E / 4;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = first; g < groups; g += step) {
    const long long e = 4 * g;
    float4 x[NK], w[NM][NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) x[k] = ldg4(X + ox[k] + e);
#pragma unroll
    for (int m = 0; m < NM; ++m) {
#pragma unroll
      for (int k = 0; k < NK; ++k) w[m][k] = ldg4(W + ow[m][k] + e);
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        acc.x = fmaf(w[m][k].x, x[k].x, acc.x);
        acc.y = fmaf(w[m][k].y, x[k].y, acc.y);
        acc.z = fmaf(w[m][k].z, x[k].z, acc.z);
        acc.w = fmaf(w[m][k].w, x[k].w, acc.w);
      }
      *reinterpret_cast<float4*>(out + oo[m] + e) = acc;
    }
  }
  const long long e = 4 * groups + first;   // the last E % 4 elements
  if (e < p.E) {
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        acc = fmaf(W[ow[m][k] + e], X[ox[k] + e], acc);
      }
      out[oo[m] + e] = acc;
    }
  }
}

// One launch of the stream path's NM x NK instance: a block per kThreads
// groups of four elements (one for the tail alone), at most kStreamBlocks a
// row, blockIdx.y the row.
template <int NM, int NK>
cudaError_t launch_stream(const Plan& p, const long long* tab, int nrows,
                          cudaStream_t s) {
  static_assert(NM <= kStreamMax && NK <= kStreamMax, "a stream instance");
  const long long blocks = std::max(
      1LL, std::min(kStreamBlocks, (p.E / 4 + kThreads - 1) / kThreads));
  step_block_stream<NM, NK><<<dim3(static_cast<unsigned>(blocks),
                                   static_cast<unsigned>(nrows)),
                              kThreads, 0, s>>>(p, tab);
  return cudaGetLastError();
}

// {{{ the lanes path (the note above)

constexpr int kLaneHead = 7, kLaneStepInts = 20, kLaneRegInts = 6;
constexpr int kLaneMaxRegions = kMaxInputs + kMaxSteps;
// the streamed regions a table (a TMA tensor map each, per row), the
// letters of one (a map's rank less the element axis), the entries of a
// letter (a box's dimension), and the static shared memory: an mbarrier
// per region and buffer
constexpr int kLaneMaxMaps = 4, kLaneMaxLetters = 4, kLaneMaxBox = 256;
constexpr int kLaneMapInts = 1 + 2 * kLaneMaxLetters;
constexpr int kLaneMaxTe = 128;

struct LaneStep {
  int xreg;          // X's region
  int wsrc;          // W's region, or (wres) the resident's input slot
  int wres, nx, nw, nb, nk, rx, rw, tx, tw;
  int xk, wk;        // contracted strides: rows of X (of W per element),
                     // floats of the packed resident
  int tab;           // int offset of its tables in shared memory
  int dst;           // the region of its result; -1: the output
  long long dg;      // the output's tables (X, W, batch) in the row's table
  int poff, pn;      // the packed resident in shared memory, its floats
  long long psrc;    // its gather offsets in the row's table
  int chain;         // 1: the first step of a chained pair, 2: the second
};

struct LaneRegion {
  int off, second, rows, slot;   // second: -1 or the second buffer
  int map;        // its tensor map (a streamed region), or -1
  int refill;     // one buffer: refilled after this step
};

struct LanePlan {
  LaneStep step[kMaxSteps];
  LaneRegion reg[kLaneMaxRegions];
  const float* in[kMaxRows][kMaxInputs];
  float* out[kMaxRows];
  int nsteps, nregs, te, dbl, n_ints, block_elems, threads;
  int rank[kLaneMaxMaps];   // each map's rank
  long long ints_src, E, row_len;
};

// Each row's streamed regions as TMA tensor maps: (e, its letters, the
// fastest first), a box of te elements by all of its rows, which lands in
// shared memory as the region's rows [row][element].
struct LaneMaps {
  CUtensorMap m[kMaxRows][kLaneMaxMaps];
};

__device__ __forceinline__ const float* lane_base(const LanePlan& p,
                                                  const float* smem, int r,
                                                  int parity) {
  const LaneRegion& g = p.reg[r];
  return smem + (parity && g.second >= 0 ? g.second : g.off);
}

// region r's box at element e0 into buffer `buf` (a box past E filled with
// zeros), its bytes reported to the buffer's mbarrier: one TMA copy, by
// the calling thread, after its fence orders the block's earlier accesses
// of the buffer before it
__device__ void lane_fill(const LanePlan& p, const CUtensorMap* maps,
                          float* smem, unsigned long long* bars, int r,
                          long long e0, int buf) {
  const LaneRegion& g = p.reg[r];
  float* dst = const_cast<float*>(lane_base(p, smem, r, buf));
  unsigned long long* bar = bars + 2 * g.map + buf;
  const CUtensorMap* map = maps + g.map;
  const int c0 = static_cast<int>(e0);
  fence_proxy_async();
  bar_expect(bar, static_cast<unsigned>(g.rows * p.te * sizeof(float)));
  const unsigned d = smem_addr(dst), b = smem_addr(bar);
  switch (p.rank[g.map]) {
    case 1:
      asm volatile(
          "cp.async.bulk.tensor.1d.shared::cluster.global.tile"
          ".mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];\n"
          ::"r"(d), "l"(map), "r"(c0), "r"(b) : "memory");
      break;
    case 2:
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
          ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
          ::"r"(d), "l"(map), "r"(c0), "r"(0), "r"(b) : "memory");
      break;
    case 3:
      asm volatile(
          "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
          ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %3}], [%4];\n"
          ::"r"(d), "l"(map), "r"(c0), "r"(0), "r"(b) : "memory");
      break;
    case 4:
      asm volatile(
          "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
          ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %3, %3}],"
          " [%4];\n"
          ::"r"(d), "l"(map), "r"(c0), "r"(0), "r"(b) : "memory");
      break;
    default:
      asm volatile(
          "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
          ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %3, %3, %3}],"
          " [%4];\n"
          ::"r"(d), "l"(map), "r"(c0), "r"(0), "r"(b) : "memory");
      break;
  }
}

// acc[r][c] += sum_k X_r[k] W_c[k]: X_r a per-element row (its pointer
// advancing xkt floats a k), W a resident's RW consecutive floats (wk a k)
// read as RW / 4 broadcasts; the next k's values are loaded before this
// k's FMAs
template <int RX, int RW>
__device__ __forceinline__ void lanes_run_res(const float* (&xp)[RX],
                                              const float* wp, int xkt,
                                              int wk, int nk,
                                              float (&acc)[RX][RW]) {
  constexpr int RV = RW / 4;
  float a[RX];
  float4 w[RV];
#pragma unroll
  for (int r = 0; r < RX; ++r) a[r] = *xp[r];
#pragma unroll
  for (int c = 0; c < RV; ++c) w[c] = reinterpret_cast<const float4*>(wp)[c];
  for (int k = 1; k < nk; ++k) {
    float an[RX];
    float4 wn[RV];
    wp += wk;
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      xp[r] += xkt;
      an[r] = *xp[r];
    }
#pragma unroll
    for (int c = 0; c < RV; ++c) {
      wn[c] = reinterpret_cast<const float4*>(wp)[c];
    }
#pragma unroll
    for (int r = 0; r < RX; ++r) {
#pragma unroll
      for (int c = 0; c < RV; ++c) {
        acc[r][4 * c] = fmaf(a[r], w[c].x, acc[r][4 * c]);
        acc[r][4 * c + 1] = fmaf(a[r], w[c].y, acc[r][4 * c + 1]);
        acc[r][4 * c + 2] = fmaf(a[r], w[c].z, acc[r][4 * c + 2]);
        acc[r][4 * c + 3] = fmaf(a[r], w[c].w, acc[r][4 * c + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < RX; ++r) a[r] = an[r];
#pragma unroll
    for (int c = 0; c < RV; ++c) w[c] = wn[c];
  }
#pragma unroll
  for (int r = 0; r < RX; ++r) {
#pragma unroll
    for (int c = 0; c < RV; ++c) {
      acc[r][4 * c] = fmaf(a[r], w[c].x, acc[r][4 * c]);
      acc[r][4 * c + 1] = fmaf(a[r], w[c].y, acc[r][4 * c + 1]);
      acc[r][4 * c + 2] = fmaf(a[r], w[c].z, acc[r][4 * c + 2]);
      acc[r][4 * c + 3] = fmaf(a[r], w[c].w, acc[r][4 * c + 3]);
    }
  }
}

// the same with W per element too: RW rows, wkt floats a k
template <int RX, int RW>
__device__ __forceinline__ void lanes_run_elem(const float* (&xp)[RX],
                                               const float* (&wq)[RW],
                                               int xkt, int wkt, int nk,
                                               float (&acc)[RX][RW]) {
  float a[RX], w[RW];
#pragma unroll
  for (int r = 0; r < RX; ++r) a[r] = *xp[r];
#pragma unroll
  for (int c = 0; c < RW; ++c) w[c] = *wq[c];
  for (int k = 1; k < nk; ++k) {
    float an[RX], wn[RW];
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      xp[r] += xkt;
      an[r] = *xp[r];
    }
#pragma unroll
    for (int c = 0; c < RW; ++c) {
      wq[c] += wkt;
      wn[c] = *wq[c];
    }
#pragma unroll
    for (int r = 0; r < RX; ++r) {
#pragma unroll
      for (int c = 0; c < RW; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < RX; ++r) a[r] = an[r];
#pragma unroll
    for (int c = 0; c < RW; ++c) w[c] = wn[c];
  }
#pragma unroll
  for (int r = 0; r < RX; ++r) {
#pragma unroll
    for (int c = 0; c < RW; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
  }
}

// One step on the sub-tile [e0, e0 + n): warp w takes the units w, w +
// kWarps, ... (a unit: a batch entry, an X tile, a W tile and 32 of the
// sub-tile's elements, one a lane).  Its tables in shared memory: X's
// rows over its entries and the batch, W's (per element; a resident's
// packed offset per batch entry), the result's rows; the output's as
// int64 offsets in the row's table.
template <int RX, int RW, bool WRES, int NT>
__device__ void lane_step(const LanePlan& p, const LaneStep st,
                          const long long* __restrict__ tab, float* smem,
                          float* __restrict__ out, long long e0, int n,
                          int parity) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int te = p.te, G = te / 32;
  const int* Xx = reinterpret_cast<const int*>(smem) + st.tab;
  const int* Xb = Xx + st.nx;
  const int* Ww = Xb + st.nb;
  const int* Wb = Ww + (WRES ? 0 : st.nw);
  const int* Dx = Wb + st.nb;
  const int* Dw = Dx + st.nx;
  const int* Db = Dw + st.nw;
  const float* X = lane_base(p, smem, st.xreg, parity);
  const float* W = WRES ? smem + st.poff : lane_base(p, smem, st.wsrc,
                                                      parity);
  const int xkt = st.xk * te, wkt = WRES ? st.wk : st.wk * te;
  const int units = st.nb * st.tx * st.tw * G;
  float* const D0 = st.dst >= 0 ? smem + p.reg[st.dst].off : nullptr;
  for (int u = warp; u < units; u += NT / 32) {
    int t = u;
    const int g = t % G;
    t /= G;
    const int ti = t % st.tx;
    t /= st.tx;
    const int wi = t % st.tw, b = t / st.tw;
    const int col = g * 32 + lane;
    const float* xp[RX];
#pragma unroll
    for (int r = 0; r < RX; ++r) {
      const int x = min(ti * RX + r, st.nx - 1);
      xp[r] = X + (Xx[x] + Xb[b]) * te + col;
    }
    float acc[RX][RW];
#pragma unroll
    for (int r = 0; r < RX; ++r) {
#pragma unroll
      for (int c = 0; c < RW; ++c) acc[r][c] = 0.f;
    }
    if constexpr (WRES) {
      lanes_run_res<RX, RW>(xp, W + Wb[b] + wi * RW, xkt, wkt, st.nk, acc);
    } else {
      const float* wq[RW];
#pragma unroll
      for (int c = 0; c < RW; ++c) {
        const int w = min(wi * RW + c, st.nw - 1);
        wq[c] = W + (Ww[w] + Wb[b]) * te + col;
      }
      lanes_run_elem<RX, RW>(xp, wq, xkt, wkt, st.nk, acc);
    }
    if (st.dst >= 0) {
      float* D = D0 + col;
      int dw[RW];
#pragma unroll
      for (int c = 0; c < RW; ++c) dw[c] = Dw[min(wi * RW + c, st.nw - 1)];
#pragma unroll
      for (int r = 0; r < RX; ++r) {
        const int x = ti * RX + r;
        if (x >= st.nx) continue;
        const int dr = Dx[x] + Db[b];
#pragma unroll
        for (int c = 0; c < RW; ++c) {
          if (wi * RW + c < st.nw) D[(dr + dw[c]) * te] = acc[r][c];
        }
      }
    } else if (col < n) {
      const long long* dg = tab + st.dg;
      long long dw[RW];
#pragma unroll
      for (int c = 0; c < RW; ++c) {
        dw[c] = dg[st.nx + min(wi * RW + c, st.nw - 1)];
      }
      const long long ob = dg[st.nx + st.nw + b] + e0 + col;
#pragma unroll
      for (int r = 0; r < RX; ++r) {
        const int x = ti * RX + r;
        if (x >= st.nx) continue;
        const long long dr = dg[x] + ob;
#pragma unroll
        for (int c = 0; c < RW; ++c) {
          if (wi * RW + c < st.nw) out[dr + dw[c]] = acc[r][c];
        }
      }
    }
  }
}

// The lanes path's register tiles (RX, RW), ops/kernels.py::SB_LANE_TILES
// (a resident W, RW a multiple of 4) and SB_LANE_TILES_ELEM (W per element)
#define SB_LANES_RES                                                         \
  SB_LANE(1, 4, true) SB_LANE(1, 8, true) SB_LANE(1, 12, true)               \
  SB_LANE(1, 16, true) SB_LANE(2, 4, true) SB_LANE(2, 8, true)               \
  SB_LANE(2, 12, true) SB_LANE(2, 16, true) SB_LANE(3, 4, true)              \
  SB_LANE(3, 8, true) SB_LANE(3, 12, true) SB_LANE(3, 16, true)              \
  SB_LANE(4, 4, true) SB_LANE(4, 8, true) SB_LANE(4, 12, true)               \
  SB_LANE(5, 4, true) SB_LANE(5, 8, true) SB_LANE(6, 4, true)                \
  SB_LANE(6, 8, true) SB_LANE(8, 4, true) SB_LANE(9, 4, true)
#define SB_LANES_ELEM                                                        \
  SB_LANE(1, 1, false) SB_LANE(1, 4, false) SB_LANE(1, 9, false)             \
  SB_LANE(2, 4, false) SB_LANE(2, 5, false) SB_LANE(2, 9, false)             \
  SB_LANE(3, 3, false) SB_LANE(3, 4, false) SB_LANE(3, 5, false)             \
  SB_LANE(3, 9, false) SB_LANE(4, 4, false) SB_LANE(4, 5, false)             \
  SB_LANE(4, 9, false) SB_LANE(5, 5, false) SB_LANE(5, 9, false)

// A chained first step's tile over RQ of its X rows where the tile carries
// the step's batch (lane_chain's XB): for each contracted entry, each tile
// entry kw's RQ rows of X at its own batch entry (xb[kw] floats past xo)
// and the tile's RW / 4 broadcasts of the resident, acc[r][kw RM + j] += X
// of (r, kw) times W's j of kw (the padding's columns the last entry's)
template <int RQ, int NKW, int RM, int RW, int TE>
__device__ __forceinline__ void lane_chain_rows_xb(int xo, int wo,
                                                   const int (&xb)[NKW],
                                                   int xkt, int wk, int nk,
                                                   float (&acc)[RQ][RW]) {
  constexpr int RV = RW / 4;
  for (int k = 0; k < nk; ++k) {
    float xv[RQ][NKW];
    float4 wv[RV];
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
#pragma unroll
      for (int kw = 0; kw < NKW; ++kw) {
        xv[r][kw] = sb_smem[xo + xb[kw] + r * TE];
      }
    }
#pragma unroll
    for (int v = 0; v < RV; ++v) {
      wv[v] = reinterpret_cast<const float4*>(sb_smem + wo)[v];
    }
    xo += xkt;
    wo += wk;
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
#pragma unroll
      for (int v = 0; v < RV; ++v) {
        const float w4[4] = {wv[v].x, wv[v].y, wv[v].z, wv[v].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * v + i;
          const int kw = j / RM < NKW ? j / RM : NKW - 1;
          acc[r][j] = fmaf(xv[r][kw], w4[i], acc[r][j]);
        }
      }
    }
  }
}

// A chained pair (ops/step_block.py::plan_lanes): steps s and s + 1, a the
// first (X per element, W a resident packed per unit tile) and c the second
// (X its per-element operand Y, W the first's result), as one step of
// units, each a batch entry b of c, RM of c's free entries on the first
// result's side (a tile of RW floats of the packed resident: c's NKW
// contracted entries on W's side times the RM) and 32 of the sub-tile's
// elements, one a lane.  For every RQ of a's X rows the unit accumulates the
// first result over its tile in registers (RQ x RW, RW / 4 broadcasts a
// contracted entry), then takes each of those entries as one of c's
// contracted entries, in c's order (the X rows', then the tile's NKW): NN
// rows of Y, NN x RM FMAs into c's tile.  Only c's result is written, to its
// region or to the output; the first result never reaches shared memory.
// Each entry is summed in the order of the block kernel's, term for term.
// The sub-tile (32 G elements) is a template parameter and a's X rows and
// c's Y rows of one contracted entry are consecutive (the host checks), so
// that every row of a load is an immediate offset of one shared-memory
// address (sb_smem, 32-bit).  XB: a has batch letters, which c contracts
// (the tile carries them): each of the tile's NKW entries reads X's rows at
// its own batch entry (a's batch table holds them, a.nb = NKW), RQ x NKW
// loads a contracted entry.
template <int RQ, int NKW, int RM, int NN, int G, int NT, bool XB>
__device__ __forceinline__ void lane_chain(const LanePlan& p, int s,
                            const long long* __restrict__ tab,
                            float* __restrict__ out, long long e0, int n,
                            int parity) {
  constexpr int TE = 32 * G, RW = (NKW * RM + 3) / 4 * 4, RV = RW / 4;
  const LaneStep& a = p.step[s];
  const LaneStep& c = p.step[s + 1];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // XB: X's rows of each tile entry, floats past its first row
  [[maybe_unused]] int xb[NKW];
  if constexpr (XB) {
    const int* Xb = reinterpret_cast<const int*>(sb_smem) + a.tab + a.nx;
#pragma unroll
    for (int kw = 0; kw < NKW; ++kw) xb[kw] = Xb[kw] * TE;
  }
  const int* Yb = reinterpret_cast<const int*>(sb_smem) + c.tab + c.nx;
  const int* Dx = Yb + 2 * c.nb + c.nw;
  const int* Dw = Dx + c.nx;
  const int* Db = Dw + c.nw;
  const LaneRegion& xg = p.reg[a.xreg];
  const LaneRegion& yg = p.reg[c.xreg];
  const int X = parity && xg.second >= 0 ? xg.second : xg.off;
  const int Y = parity && yg.second >= 0 ? yg.second : yg.off;
  const int xkt = a.xk * TE, ykt = c.xk * TE, wk = a.wk, nk = a.nk;
  const int units = c.nb * c.tw * G;
  for (int u = warp; u < units; u += NT / 32) {
    int t = u;
    const int g = t % G;
    t /= G;
    const int mt = t % c.tw, b = t / c.tw;
    const int col = g * 32 + lane;
    const int w0 = a.poff + (b * c.tw + mt) * RW;
    const int y0 = Y + Yb[b] * TE + col;
    float o[NN][RM];
#pragma unroll
    for (int i = 0; i < NN; ++i) {
#pragma unroll
      for (int j = 0; j < RM; ++j) o[i][j] = 0.f;
    }
    for (int q0 = 0; q0 < a.nx; q0 += RQ) {
      float acc[RQ][RW];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
#pragma unroll
        for (int j = 0; j < RW; ++j) acc[r][j] = 0.f;
      }
      int xo = X + q0 * TE + col, wo = w0;
      if constexpr (XB) {
        lane_chain_rows_xb<RQ, NKW, RM, RW, TE>(xo, wo, xb, xkt, wk, nk,
                                                acc);
      } else {
        for (int k = 0; k < nk; ++k) {
          float xv[RQ];
          float4 wv[RV];
#pragma unroll
          for (int r = 0; r < RQ; ++r) xv[r] = sb_smem[xo + r * TE];
#pragma unroll
          for (int v = 0; v < RV; ++v) {
            wv[v] = reinterpret_cast<const float4*>(sb_smem + wo)[v];
          }
          xo += xkt;
          wo += wk;
#pragma unroll
          for (int r = 0; r < RQ; ++r) {
#pragma unroll
            for (int v = 0; v < RV; ++v) {
              acc[r][4 * v] = fmaf(xv[r], wv[v].x, acc[r][4 * v]);
              acc[r][4 * v + 1] = fmaf(xv[r], wv[v].y, acc[r][4 * v + 1]);
              acc[r][4 * v + 2] = fmaf(xv[r], wv[v].z, acc[r][4 * v + 2]);
              acc[r][4 * v + 3] = fmaf(xv[r], wv[v].w, acc[r][4 * v + 3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
#pragma unroll
        for (int kw = 0; kw < NKW; ++kw) {
          const int yo = y0 + ((q0 + r) * NKW + kw) * ykt;
          float y[NN];
#pragma unroll
          for (int i = 0; i < NN; ++i) y[i] = sb_smem[yo + i * TE];
#pragma unroll
          for (int i = 0; i < NN; ++i) {
#pragma unroll
            for (int j = 0; j < RM; ++j) {
              o[i][j] = fmaf(acc[r][kw * RM + j], y[i], o[i][j]);
            }
          }
        }
      }
    }
    if (c.dst >= 0) {
      const int d0 = p.reg[c.dst].off + Db[b] * TE + col;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int w = mt * RM + j;
        if (w >= c.nw) continue;
        const int dw = d0 + Dw[w] * TE;
#pragma unroll
        for (int i = 0; i < NN; ++i) sb_smem[dw + Dx[i] * TE] = o[i][j];
      }
    } else if (col < n) {
      const long long* dg = tab + c.dg;
      const long long ob = dg[c.nx + c.nw + b] + e0 + col;
#pragma unroll
      for (int j = 0; j < RM; ++j) {
        const int w = mt * RM + j;
        if (w >= c.nw) continue;
        const long long dw = dg[c.nx + w] + ob;
#pragma unroll
        for (int i = 0; i < NN; ++i) out[dg[i] + dw] = o[i][j];
      }
    }
  }
}

// The chained pairs' instances (RQ, NKW, RM, NN), ops/kernels.py::
// SB_LANE_CHAINS, each at the four sub-tiles, and those whose tile carries
// the first step's batch, SB_LANE_CHAINS_BATCH, at 32-element sub-tiles
// alone (the only ones whose regions fit)
#define SB_LANE_CHAINS                                                      \
  SB_LANE_CHAIN(3, 3, 4, 9) SB_LANE_CHAIN(9, 3, 1, 9)                        \
  SB_LANE_CHAIN(9, 1, 4, 9)
#define SB_LANE_CHAINS_BATCH SB_LANE_CHAIN_BATCH(3, 4, 3, 15)

__host__ __device__ constexpr int lane_chain_key(int rq, int nkw, int rm,
                                                 int nn, int g) {
  return (((rq * 16 + nkw) * 16 + rm) * 16 + nn) * 8 + g;
}

// XB: the instances whose tile carries the first step's batch
template <int NT, bool XB>
__device__ __forceinline__ void run_lane_chain(const LanePlan& p, int s,
                                               const long long* tab,
                                               float* out, long long e0,
                                               int n, int parity) {
  const LaneStep& a = p.step[s];
  const LaneStep& c = p.step[s + 1];
#define SB_LANE_CHAIN_G(RQ, NKW, RM, NN, G)                                 \
  case lane_chain_key(RQ, NKW, RM, NN, G):                                  \
    lane_chain<RQ, NKW, RM, NN, G, NT, XB>(p, s, tab, out, e0, n, parity);  \
    break;
#define SB_LANE_CHAIN(RQ, NKW, RM, NN)                                      \
  SB_LANE_CHAIN_G(RQ, NKW, RM, NN, 1) SB_LANE_CHAIN_G(RQ, NKW, RM, NN, 2)    \
  SB_LANE_CHAIN_G(RQ, NKW, RM, NN, 3) SB_LANE_CHAIN_G(RQ, NKW, RM, NN, 4)
#define SB_LANE_CHAIN_BATCH(RQ, NKW, RM, NN)                                \
  SB_LANE_CHAIN_G(RQ, NKW, RM, NN, 1)
  if constexpr (XB) {
    switch (lane_chain_key(a.rx, c.nk / a.nx, c.rw, c.nx, p.te / 32)) {
      SB_LANE_CHAINS_BATCH
    }
  } else {
    switch (lane_chain_key(a.rx, c.nk / a.nx, c.rw, c.nx, p.te / 32)) {
      SB_LANE_CHAINS
    }
  }
#undef SB_LANE_CHAIN_BATCH
#undef SB_LANE_CHAIN
#undef SB_LANE_CHAIN_G
}

// one unchained step: its tile's instance
template <int NT>
__device__ __forceinline__ void lane_step_any(const LanePlan& p, int s,
                                              const long long* tab,
                                              float* smem, float* out,
                                              long long e0, int n,
                                              int parity) {
  const LaneStep st = p.step[s];
  switch ((st.wres ? 1024 : 0) + st.rx * 32 + st.rw) {
#define SB_LANE(RX, RW, R)                                                   \
  case (R ? 1024 : 0) + RX * 32 + RW:                                        \
    lane_step<RX, RW, R, NT>(p, st, tab, smem, out, e0, n, parity);          \
    break;
    SB_LANES_RES SB_LANES_ELEM
#undef SB_LANE
  }
}

template <int NT>
__device__ __noinline__ void run_lane_step(const LanePlan& p, int s,
                                           const long long* tab,
                                           float* smem, float* out,
                                           long long e0, int n, int parity) {
  lane_step_any<NT>(p, s, tab, smem, out, e0, n, parity);
}

// NT threads a block: 256 where two blocks fit an SM, 512 where one does
// (the planner's choice), 128 registers a thread either way; CHAIN: 1 a
// plan with chained pairs, each run at its first step, its steps and pairs
// inlined into the kernel (a call out of it would take registers from the
// callee, and the chained units need all of them), 2 the same with pairs
// whose tile carries the first step's batch (SB_LANE_CHAINS_BATCH, an
// instance of its own at 512 threads, so that the others' code stays as
// it was); 0 a plan without chains, which calls run_lane_step for each
// step
template <int NT, int CHAIN>
__global__ void __launch_bounds__(NT, 512 / NT)
step_block_lanes(const __grid_constant__ LanePlan p,
                 const __grid_constant__ LaneMaps maps,
                 const long long* __restrict__ tables) {
  float* smem = sb_smem;
  const int row = blockIdx.y;
  const long long* tab = tables + row * p.row_len;
  const float* const* in = p.in[row];
  float* out = p.out[row];
  int* ints = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < p.n_ints; i += NT) {
    ints[i] = static_cast<int>(tab[p.ints_src + i]);
  }
  for (int s = 0; s < p.nsteps; ++s) {
    const LaneStep& st = p.step[s];
    if (!st.wres) continue;
    const float* src = in[st.wsrc];
    const long long* g = tab + st.psrc;
    for (int i = threadIdx.x; i < st.pn; i += NT) {
      const long long o = g[i];
      smem[st.poff + i] = o >= 0 ? src[o] : 0.f;
    }
  }
  // thread 0 issues every region's box and an mbarrier per region and
  // buffer reports it landed; every thread waits on it
  __shared__ unsigned long long bars[2 * kLaneMaxMaps];
  const CUtensorMap* rmaps = maps.m[row];
  if (threadIdx.x == 0) {
    for (int j = 0; j < 2 * kLaneMaxMaps; ++j) bar_init(&bars[j], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int te = p.te;
  const long long e_begin = static_cast<long long>(blockIdx.x) *
                            p.block_elems;
  const long long e_end = min(p.E, e_begin + p.block_elems);
  if (threadIdx.x == 0) {
    for (int r = 0; r < p.nregs; ++r) {
      if (p.reg[r].map >= 0) lane_fill(p, rmaps, smem, bars, r, e_begin, 0);
    }
  }
  int parity = 0;
  unsigned phase = 0;   // bit j: the phase of mbarrier j to wait for next
  for (long long e0 = e_begin; e0 < e_end; e0 += te) {
    const int n = static_cast<int>(min(static_cast<long long>(te),
                                       e_end - e0));
    const long long next = e0 + te;
    if (p.dbl && next < e_end && threadIdx.x == 0) {
      for (int r = 0; r < p.nregs; ++r) {
        if (p.reg[r].map >= 0) {
          lane_fill(p, rmaps, smem, bars, r, next, parity ^ 1);
        }
      }
    }
    for (int r = 0; r < p.nregs; ++r) {
      if (p.reg[r].map < 0) continue;
      const int j = 2 * p.reg[r].map + (p.dbl ? parity : 0);
      bar_wait(&bars[j], (phase >> j) & 1u);
      phase ^= 1u << j;
    }
    for (int s = 0; s < p.nsteps; ++s) {
      if constexpr (CHAIN != 0) {
        // a chained pair runs at its first step; its refills at both
        if (p.step[s].chain == 1) {
          run_lane_chain<NT, CHAIN == 2>(p, s, tab, out, e0, n, parity);
        } else if (p.step[s].chain == 0) {
          lane_step_any<NT>(p, s, tab, smem, out, e0, n, parity);
        }
        if (p.step[s].chain != 2) __syncthreads();
      } else {
        run_lane_step<NT>(p, s, tab, smem, out, e0, n, parity);
        __syncthreads();
      }
      if (!p.dbl && next < e_end && threadIdx.x == 0) {
        for (int r = 0; r < p.nregs; ++r) {
          if (p.reg[r].map >= 0 && p.reg[r].refill == s) {
            lane_fill(p, rmaps, smem, bars, r, next, 0);
          }
        }
      }
    }
    if (p.dbl) parity ^= 1;
  }
}

template <int NT, int CHAIN>
cudaError_t launch_lanes(const LanePlan& p, const LaneMaps& maps,
                         const void* tables, long long nblocks, int nrows,
                         size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_block_lanes<NT, CHAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  step_block_lanes<NT, CHAIN><<<dim3(static_cast<unsigned>(nblocks),
                              static_cast<unsigned>(nrows)),
                         NT, smem, static_cast<cudaStream_t>(stream)>>>(
      p, maps, static_cast<const long long*>(tables));
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up through the runtime (no link to libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled lane_encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* q = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &q, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &q, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(q);
    }
  }
  return fn;
}

// region map: {rank, then per letter, fastest first, its entries and its
// stride in floats}: the map over (e, the letters) of a box of te elements
// by every entry
bool lane_map(CUtensorMap* map, const float* base, long long E, int te,
              const long long* d) {
  const EncodeTiled encode = lane_encoder();
  const int rank = static_cast<int>(d[0]);
  if (!encode || rank < 1 || rank > 1 + kLaneMaxLetters) return false;
  cuuint64_t dims[5] = {static_cast<cuuint64_t>(E)}, strides[4];
  cuuint32_t box[5] = {static_cast<cuuint32_t>(te)}, step[5];
  for (int i = 0; i < rank; ++i) step[i] = 1;
  for (int i = 1; i < rank; ++i) {
    const long long len = d[2 * i - 1], st = d[2 * i];
    if (len < 1 || len > kLaneMaxBox || st < 1 || st % 4) return false;
    dims[i] = static_cast<cuuint64_t>(len);
    box[i] = static_cast<cuuint32_t>(len);
    strides[i - 1] = static_cast<cuuint64_t>(st) * sizeof(float);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<float*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool lane_tile_built(int rx, int rw, bool res) {
  bool built = false;
#define SB_LANE(RX, RW, R) built |= rx == RX && rw == RW && res == R;
  SB_LANES_RES SB_LANES_ELEM
#undef SB_LANE
  return built;
}

// whether steps a and c (its next) are a chained pair the kernel runs at
// sub-tiles of te elements: an instance of SB_LANE_CHAINS (a without batch
// entries) or, at te 32, of SB_LANE_CHAINS_BATCH (a's batch entries the
// tile's NKW), a's X rows whole chunks of RQ, a resident W of one tile a
// unit (c's batch entries times its tiles of RM free entries), c's X per
// element over all its NN free entries, and a writing nothing
bool lane_chain_ok(const LaneStep& a, const LaneStep& c, int te) {
  if (a.chain != 1 || c.chain != 2 || !a.wres || c.wres || a.nb < 1 ||
      a.dst >= 0 || a.nx < 1 || c.nk % a.nx || a.tx * a.rx != a.nx ||
      c.tx != 1 || c.rx != c.nx || a.tw != c.nb * c.tw) {
    return false;
  }
  const int nkw = c.nk / a.nx;
  bool built = false;
#define SB_LANE_CHAIN(RQ, NKW, RM, NN)                                      \
  built |= a.nb == 1 && a.rx == RQ && nkw == NKW && c.rw == RM &&            \
           c.nx == NN && a.rw == (NKW * RM + 3) / 4 * 4;
#define SB_LANE_CHAIN_BATCH(RQ, NKW, RM, NN)                                \
  built |= a.nb > 1 && a.nb == nkw && te == 32 && a.rx == RQ &&              \
           nkw == NKW && c.rw == RM && c.nx == NN &&                         \
           a.rw == (NKW * RM + 3) / 4 * 4;
  SB_LANE_CHAINS SB_LANE_CHAINS_BATCH
#undef SB_LANE_CHAIN_BATCH
#undef SB_LANE_CHAIN
  return built;
}

// }}}

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
// shared memory per block; path: 0 the block kernel, 1 the stream path
// (ops/kernels.py::step_block_path chose it; its tables hold the tensors'
// own offsets); workspace: nrows * ceil(E / block_long) * n_out floats when
// the last step contracts e.  Returns the CUDA error of the launches (0 on
// success).
int step_block_f32(int nrows, int ninputs, void* const* ptrs,
                   const long long* es, int nsteps, const int* steps_i,
                   const long long* steps_t, const int* stage_i,
                   const long long* stage_t, const void* tables,
                   long long row_len, int te, int elem_fastest, long long E,
                   int block_long, int smem_floats, int path,
                   void* workspace, void* stream) {
  if (nrows < 1 || nrows > kMaxRows || ninputs < 1 || ninputs > kMaxInputs ||
      nsteps < 1 || nsteps > kMaxSteps || te < 1 || E < 1 || block_long < 1 ||
      smem_floats < 0 || tables == nullptr ||
      (path != kBlockPath && path != kStreamPath)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool streamed = path == kStreamPath;
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
      for (int k = 0; k < 2 && !streamed; ++k) {
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
          (!streamed &&
           (st.dsm < 0 ||
            st.dsm + 2LL * (st.nM + st.nN + st.nK) + 3LL * st.nB >
                smem_floats)) ||
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* tab = static_cast<const long long*>(tables);
  if (streamed) {
    const Step& st = p.step[0];
    if (nsteps != 1 || !st.dense || st.kind != kElement || st.nB != 1 ||
        (st.nM != 1 && st.nN != 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch ((st.nN == 1 ? st.nM : st.nN) * 16 + st.nK) {
#define SB_STREAM(NM, NK)                                                   \
  case NM * 16 + NK:                                                        \
    return static_cast<int>(launch_stream<NM, NK>(p, tab, nrows, s));
      SB_STREAM_SHAPES
#undef SB_STREAM
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        step_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long nblocks = (E + block_long - 1) / block_long;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
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

// The lanes path (ops/kernels.py::step_block_path chose it): ptrs as
// step_block_f32's; meta: the header {steps, regions, te, two buffers, the
// ints of the tables, their offset in a row's table, threads a block},
// then per step
// {X's region, W's region or resident slot, W resident, X, W, batch and
// contracted entries, RX, RW, X and W tiles, X's and W's contracted
// strides, its tables' int offset in shared memory, its result's region or
// -1, the output tables' offset, the packed resident's float offset, its
// floats, its gather offsets' offset}, then per region {float offset, the
// second buffer's or -1, rows, input slot or -1, its tensor map or -1,
// refill step or -1} (ops/kernels.py::step_block_lanes_tables); mapd: per
// row and map {rank, then per letter, the fastest first, its entries and
// its stride in floats};
// tables: nrows x row_len int64 on the card; block_elems: elements a
// block, a multiple of te.  Returns the CUDA error of the launch.
int step_block_lanes_f32(int nrows, int ninputs, void* const* ptrs,
                         const int* meta, int nmeta, const long long* mapd,
                         const void* tables, long long row_len, long long E,
                         int block_elems, int smem_floats, void* stream) {
  const auto bad = static_cast<int>(cudaErrorInvalidValue);
  if (nrows < 1 || nrows > kMaxRows || ninputs < 1 ||
      ninputs > kMaxInputs || nmeta < kLaneHead || tables == nullptr ||
      E < 1 || E % 4 || smem_floats < 0 ||
      sizeof(float) * static_cast<size_t>(smem_floats) > kMaxSmemBytes) {
    return bad;
  }
  LanePlan p;
  p.nsteps = meta[0];
  p.nregs = meta[1];
  p.te = meta[2];
  p.dbl = meta[3] ? 1 : 0;
  p.n_ints = meta[4];
  p.ints_src = meta[5];
  p.threads = meta[6];
  int nmaps = 0;
  p.E = E;
  p.row_len = row_len;
  p.block_elems = block_elems;
  if (p.nsteps < 1 || p.nsteps > kMaxSteps || p.nregs < 1 ||
      p.nregs > kLaneMaxRegions || p.te < 32 || p.te > kLaneMaxTe ||
      (p.threads != 256 && p.threads != 512) ||
      p.te % 32 || block_elems < p.te || block_elems % p.te ||
      nmeta != kLaneHead + kLaneStepInts * p.nsteps +
                   kLaneRegInts * p.nregs ||
      p.n_ints < 0 || p.n_ints > smem_floats || p.ints_src < 0 ||
      p.ints_src + p.n_ints > row_len) {
    return bad;
  }
  const int* rm = meta + kLaneHead + kLaneStepInts * p.nsteps;
  for (int r = 0; r < p.nregs; ++r) {
    const int* ri = rm + kLaneRegInts * r;
    LaneRegion& g = p.reg[r];
    g.off = ri[0];
    g.second = ri[1];
    g.rows = ri[2];
    g.slot = ri[3];
    g.map = ri[4];
    g.refill = ri[5];
    const long long span = static_cast<long long>(g.rows) * p.te;
    if (g.rows < 1 || g.off < p.n_ints || g.off % 4 ||
        g.off + span > smem_floats || g.slot >= ninputs || g.off % 32 ||
        (g.slot >= 0) != (g.map >= 0) || g.map >= kLaneMaxMaps ||
        (g.second >= 0 && (g.slot < 0 || g.second % 4 ||
                           g.second < g.off + span ||
                           g.second + span > smem_floats)) ||
        (g.second >= 0 && g.second % 32) ||
        (g.slot >= 0 && !p.dbl && (g.refill < 0 || g.refill >= p.nsteps))) {
      return bad;
    }
    if (g.map >= 0) nmaps = std::max(nmaps, g.map + 1);
  }
  if (mapd == nullptr && nmaps > 0) return bad;
  for (int s = 0; s < p.nsteps; ++s) {
    const int* si = meta + kLaneHead + kLaneStepInts * s;
    LaneStep& st = p.step[s];
    st.xreg = si[0];
    st.wsrc = si[1];
    st.wres = si[2] ? 1 : 0;
    st.nx = si[3];
    st.nw = si[4];
    st.nb = si[5];
    st.nk = si[6];
    st.rx = si[7];
    st.rw = si[8];
    st.tx = si[9];
    st.tw = si[10];
    st.xk = si[11];
    st.wk = si[12];
    st.tab = si[13];
    st.dst = si[14];
    st.dg = si[15];
    st.poff = si[16];
    st.pn = si[17];
    st.psrc = si[18];
    st.chain = si[19];
    const bool last = s == p.nsteps - 1;
    const int ints = 2 * st.nx + st.nw + 3 * st.nb + (st.wres ? 0 : st.nw);
    if (st.nx < 1 || st.nw < 1 || st.nb < 1 || st.nk < 1 ||
        st.chain < 0 || st.chain > 2 ||
        (st.chain == 2 ? s == 0 || !lane_chain_ok(p.step[s - 1], st, p.te)
                       : st.chain == 0 &&
                             !lane_tile_built(st.rx, st.rw, st.wres)) ||
        st.tx * st.rx < st.nx ||
        st.tw * st.rw < st.nw || st.xreg < 0 || st.xreg >= p.nregs ||
        st.tab < 0 || st.tab + ints > p.n_ints ||
        last != (st.dst < 0 && st.chain != 1) || st.dst >= p.nregs ||
        (last && (st.dg < 0 || st.dg + st.nx + st.nw + st.nb > row_len)) ||
        (st.wres ? (st.wsrc < 0 || st.wsrc >= ninputs || st.poff % 4 ||
                    st.wk % 4 || st.poff < p.n_ints ||
                    st.pn != (st.chain == 1 ? 1 : st.nb) * st.nk * st.tw *
                                 st.rw ||
                    st.poff + st.pn > smem_floats || st.psrc < 0 ||
                    st.psrc + st.pn > row_len)
                 : st.chain != 2 && (st.wsrc < 0 || st.wsrc >= p.nregs))) {
      return bad;
    }
  }
  for (int s = 0; s < p.nsteps; ++s) {
    if (p.step[s].chain == 1 &&
        (s + 1 == p.nsteps || p.step[s + 1].chain != 2)) {
      return bad;
    }
  }
  LaneMaps maps = {};   // the launch's maps, passed by value
  for (int r = 0; r < nrows; ++r) {
    for (int i = 0; i < ninputs; ++i) {
      p.in[r][i] = static_cast<const float*>(ptrs[(ninputs + 1) * r + i]);
      if (p.in[r][i] == nullptr) return bad;
    }
    p.out[r] = static_cast<float*>(ptrs[(ninputs + 1) * r + ninputs]);
    if (p.out[r] == nullptr) return bad;
    for (int g = 0; g < p.nregs; ++g) {
      const LaneRegion& rg = p.reg[g];
      if (rg.map < 0) continue;
      const long long* d = mapd + kLaneMapInts * (nmaps * r + rg.map);
      p.rank[rg.map] = static_cast<int>(d[0]);
      long long rows = 1;
      for (int i = 1; i < d[0]; ++i) rows *= d[2 * i - 1];
      if (rows != rg.rows ||
          !lane_map(&maps.m[r][rg.map], p.in[r][rg.slot], E, p.te, d)) {
        return bad;
      }
    }
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats);
  const long long nblocks = (E + block_elems - 1) / block_elems;
  if (nblocks > 0x7fffffffLL) return bad;
  // the kind of chained pairs: 0 none, 1 SB_LANE_CHAINS, 2
  // SB_LANE_CHAINS_BATCH (every pair of one kind; 2 at 512 threads alone)
  int chained = 0;
  for (int s = 0; s < p.nsteps; ++s) {
    if (p.step[s].chain != 1) continue;
    const int kind = p.step[s].nb > 1 ? 2 : 1;
    if (chained != 0 && chained != kind) return bad;
    chained = kind;
  }
  if (chained == 2 && p.threads != 512) return bad;
  cudaError_t err;
  if (chained == 2) {
    err = launch_lanes<512, 2>(p, maps, tables, nblocks, nrows, smem, stream);
  } else if (p.threads == 512) {
    err = chained ? launch_lanes<512, 1>(p, maps, tables, nblocks, nrows,
                                         smem, stream)
                  : launch_lanes<512, 0>(p, maps, tables, nblocks, nrows,
                                         smem, stream);
  } else {
    err = chained ? launch_lanes<256, 1>(p, maps, tables, nblocks, nrows,
                                         smem, stream)
                  : launch_lanes<256, 0>(p, maps, tables, nblocks, nrows,
                                         smem, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"
