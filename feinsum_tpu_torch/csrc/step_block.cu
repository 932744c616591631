// step_block_f32: K1's general step algebra.
//
// Replaces the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// build_pallas_executable (K1) on the programs no row family of this package
// takes: there every schedule step of a one-long-axis einsum runs on a block
// of the long axis e (row_result, :812-887, through ops/kernel_lowering.py::
// lower_step), intermediates stay in VMEM, and a contracted e accumulates
// across the grid (:888-921).  The host plans the steps
// (ops/step_block.py) and builds, per row, int64 offset tables
// (ops/kernels.py::step_block_tables); this kernel runs them:
//
//     result[o, e] = sum_c prod_k operand_k[out_k[o] + sum_k[c] + e * es_k]
//
// for every step, output entry o and contracted entry c, the steps in the
// schedule's order.
//
// Design.  Thread blocks run in parallel and in no order:
// * block b takes the elements [b * block_long, (b + 1) * block_long) of e,
//   blockIdx.y the row; the tail mask is the bound e < E;
// * the residents (operands without e) are staged once per block in shared
//   memory by a flat copy of their storage, so the host's offsets address
//   them there; steps without e ("free") run once per block after them;
// * the block walks its elements in sub-tiles of te; each step runs as
//   threads over (element, output entry), consecutive threads on
//   consecutive elements when the dominant tensor stores e at stride 1
//   (dof-major), else on consecutive entries (the entries ordered by the
//   strides, so that the reads and writes coalesce either way);
// * a step's result that a later step reads stays in shared memory for the
//   sub-tile ([entry][element] or [element][entry]), a barrier between
//   steps; the last step writes the row's output in its stored layout
//   through its offsets;
// * a last step that contracts e keeps partial sums in shared memory, each
//   owned by one thread (or one warp, its lanes on consecutive elements,
//   summed by a shuffle tree), writes one partial per entry and block to a
//   workspace, and a second launch sums each entry's partials in block
//   order.  No float atomics: the result is the same from run to run.
//
// What bounds it on an H100: bytes for most programs (a DG-like step does
// a few flops per byte of its streamed operand); the demo ij,ejk->eik at
// ndof 35 does 35 FMAs per output entry, 8.75 flop per byte.  In this simple
// design each term loads its operands (the host sizes a sub-tile so that
// its streamed data stays in L1, and a step that contracts at most one
// letter walks its operands by stride, without a table), and the sum over
// the contracted entries is one dependent chain: it waits on the loads'
// latency at 16 warps per SM, 5-8x above the bound on the demo and sum
// factorization (PERF.md).  Unrolling the chain 4-fold was slower on the
// card.  Register tiling over entries and elements is later work.
//
// Float32 throughout; the products are summed in the contracted entries'
// order, one fmaf per term.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kMaxSteps = 8;
constexpr int kMaxOps = 4;
constexpr int kMaxInputs = 8;
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
  long long t_out[kMaxOps + 1];  // tables of the entries: operands, result
  long long t_sum[kMaxOps];      // tables of the contracted entries, or
                                 // (affine) the contracted letter's strides
};

struct Row {
  const float* in[kMaxInputs];
  long long es[kMaxInputs];      // element stride of each input
  float* out;
  long long out_es;
};

struct Plan {
  Step step[kMaxSteps];
  Row row[kMaxRows];
  int stage[kMaxInputs];         // float offset of a staged input; -1: streamed
  int stage_n[kMaxInputs];       // its floats
  int nsteps, ninputs, te, elem_fastest, block_long;
  long long E, row_len;
};

// One operand of a step for the current sub-tile: the address of its
// sub-tile's first element, its element stride, its table of the entries,
// and its table of the contracted entries or (affine) their stride.
struct Operand {
  const float* base;
  long long es;
  const long long* out;
  const long long* sum;
  long long ss;
};

__device__ __forceinline__ Operand resolve(const Plan& p, const Row& rw,
                                           const Step& st, int k,
                                           const long long* tab,
                                           const float* smem, long long e0) {
  Operand op;
  const int src = st.src[k];
  if (src >= 0) {
    if (p.stage[src] >= 0) {
      op.base = smem + p.stage[src];
      op.es = 0;
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

// The entry o of element le of the sub-tile: sum_c prod_k of operand k at
// its entry address plus its offset of c (a table, or c times its stride
// when the step contracts at most one letter), the terms in order of c.
template <int N, bool kAffine>
__device__ __forceinline__ float entry(const Operand (&ops)[kMaxOps], int o,
                                       int le, int n_sum) {
  const float* b[kMaxOps];
#pragma unroll
  for (int k = 0; k < kMaxOps; ++k) {
    b[k] = k < N ? ops[k].base + le * ops[k].es + ops[k].out[o] : nullptr;
  }
  float acc = 0.f;
  for (int c = 0; c < n_sum; ++c) {
    float v[kMaxOps];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (kAffine) {
        v[k] = *b[k];
        b[k] += ops[k].ss;
      } else {
        v[k] = b[k][ops[k].sum[c]];
      }
    }
    if (N == 1) {
      acc += v[0];
    } else {
      float prod = v[0];
#pragma unroll
      for (int k = 1; k < N - 1; ++k) prod *= v[k];
      acc = fmaf(prod, v[N - 1], acc);
    }
  }
  return acc;
}

// A free or element step over n elements of the sub-tile: its result entry
// o of element le goes to dst[le * des + dtab[o]].
template <int N, bool kAffine>
__device__ void element_step(const Operand (&ops)[kMaxOps], int n_out,
                             int n_sum, int n, bool elem_fastest, float* dst,
                             long long des, const long long* dtab) {
  const int items = n_out * n;
  for (int idx = threadIdx.x; idx < items; idx += kThreads) {
    int o, le;
    if (elem_fastest) {
      le = idx % n;
      o = idx / n;
    } else {
      o = idx % n_out;
      le = idx / n_out;
    }
    dst[le * des + dtab[o]] = entry<N, kAffine>(ops, o, le, n_sum);
  }
}

// A step that contracts e: each partial red[o + n_out * g] is owned by one
// thread (or warp) for the whole block, and group g sums its share of the
// sub-tile's elements into it.
template <int N, bool kAffine>
__device__ void reduce_step(const Operand (&ops)[kMaxOps], int n_out,
                            int n_sum, int n, bool elem_fastest, int groups,
                            float* red) {
  if (elem_fastest) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int pair = warp; pair < n_out * groups; pair += kWarps) {
      const int o = pair % n_out, g = pair / n_out;
      float part = 0.f;
      for (int le = g * 32 + lane; le < n; le += 32 * groups) {
        part += entry<N, kAffine>(ops, o, le, n_sum);
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
      part += entry<N, kAffine>(ops, o, le, n_sum);
    }
    red[l] += part;
  }
}

__device__ void run_step(const Plan& p, const Row& rw, int s,
                         const long long* tab, float* smem, long long e0,
                         int n) {
  const Step& st = p.step[s];
  Operand ops[kMaxOps];
#pragma unroll
  for (int k = 0; k < kMaxOps; ++k) {
    ops[k] = resolve(p, rw, st, k < st.nops ? k : 0, tab, smem, e0);
  }
  const bool ef = p.elem_fastest != 0;
  if (st.kind == kReduce) {
    float* red = smem + st.dst;
    const int code = st.nops * 2 + (st.affine ? 1 : 0);
    switch (code) {
#define SB_REDUCE(N, A)                                                  \
  case N * 2 + (A ? 1 : 0):                                              \
    reduce_step<N, A>(ops, st.n_out, st.n_sum, n, ef, st.groups, red);   \
    break;
      SB_REDUCE(1, false) SB_REDUCE(1, true)
      SB_REDUCE(2, false) SB_REDUCE(2, true)
      SB_REDUCE(3, false) SB_REDUCE(3, true)
      SB_REDUCE(4, false) SB_REDUCE(4, true)
#undef SB_REDUCE
    }
    return;
  }
  float* dst;
  long long des;
  if (st.dst >= 0) {
    dst = smem + st.dst;
    des = st.kind == kElement ? st.es : 0;
  } else {
    dst = rw.out + e0 * rw.out_es;
    des = rw.out_es;
  }
  const long long* dtab = tab + st.t_out[st.nops];
  const int code = st.nops * 2 + (st.affine ? 1 : 0);
  switch (code) {
#define SB_ELEMENT(N, A)                                                 \
  case N * 2 + (A ? 1 : 0):                                              \
    element_step<N, A>(ops, st.n_out, st.n_sum, n, ef, dst, des, dtab);  \
    break;
    SB_ELEMENT(1, false) SB_ELEMENT(1, true)
    SB_ELEMENT(2, false) SB_ELEMENT(2, true)
    SB_ELEMENT(3, false) SB_ELEMENT(3, true)
    SB_ELEMENT(4, false) SB_ELEMENT(4, true)
#undef SB_ELEMENT
  }
}

__global__ void __launch_bounds__(kThreads)
step_block_kernel(const Plan p, const long long* __restrict__ tables,
                  float* partial) {
  extern __shared__ float smem[];
  const Row& rw = p.row[blockIdx.y];
  const long long* tab = tables + blockIdx.y * p.row_len;
  const Step& last = p.step[p.nsteps - 1];

  for (int i = 0; i < p.ninputs; ++i) {
    if (p.stage[i] < 0) continue;
    const float* src = rw.in[i];
    float* dst = smem + p.stage[i];
    for (int k = threadIdx.x; k < p.stage_n[i]; k += kThreads) dst[k] = src[k];
  }
  if (last.kind == kReduce) {
    for (int k = threadIdx.x; k < last.n_out * last.groups; k += kThreads) {
      smem[last.dst + k] = 0.f;
    }
  }
  __syncthreads();
  for (int s = 0; s < p.nsteps; ++s) {
    if (p.step[s].kind != kFree) continue;
    run_step(p, rw, s, tab, smem, 0, 1);
    __syncthreads();
  }

  const long long e_begin = static_cast<long long>(blockIdx.x) * p.block_long;
  const long long e_end = min(p.E, e_begin + p.block_long);
  for (long long e0 = e_begin; e0 < e_end; e0 += p.te) {
    const int n = static_cast<int>(min(static_cast<long long>(p.te),
                                       e_end - e0));
    for (int s = 0; s < p.nsteps; ++s) {
      if (p.step[s].kind == kFree) continue;
      run_step(p, rw, s, tab, smem, e0, n);
      __syncthreads();
    }
  }

  if (last.kind == kReduce) {
    float* dst = partial +
        (static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x) *
            last.n_out;
    for (int o = threadIdx.x; o < last.n_out; o += kThreads) {
      float t = 0.f;
      for (int g = 0; g < last.groups; ++g) {
        t += smem[last.dst + o + g * last.n_out];
      }
      dst[o] = t;
    }
  }
}

// out[o] = the sum of the blocks' partials of entry o: 32 threads per entry
// each sum every 32nd partial in block order, then a pairwise tree.
__global__ void __launch_bounds__(kSumX * kSumY)
step_block_sum(const Plan p, const long long* __restrict__ tables,
               const float* partial, int nblocks) {
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

}  // namespace

extern "C" {

int step_block_f32_max_rows() { return kMaxRows; }

// ptrs, es: nrows x (ninputs + 1) {the input views..., the output view} and
// their element strides (of e); steps_i: nsteps x {kind, nops, n_out, n_sum,
// src[4], dst, es, groups, affine}; steps_t: nsteps x {t_out[5], t_sum[4]}
// (with affine, t_sum holds the contracted letter's strides); stage:
// ninputs x {float offset in shared memory or -1, floats}; tables: nrows x
// row_len int64 offsets on the card; smem_floats: shared memory per block;
// workspace: nrows * ceil(E / block_long) * n_out floats when the last step
// contracts e.  Returns the CUDA error of the launches (0 on success).
int step_block_f32(int nrows, int ninputs, void* const* ptrs,
                   const long long* es, int nsteps, const int* steps_i,
                   const long long* steps_t, const int* stage,
                   const void* tables, long long row_len, int te,
                   int elem_fastest, long long E, int block_long,
                   int smem_floats, void* workspace, void* stream) {
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
  for (int i = 0; i < ninputs; ++i) {
    p.stage[i] = stage[2 * i];
    p.stage_n[i] = stage[2 * i + 1];
  }
  for (int s = 0; s < nsteps; ++s) {
    Step& st = p.step[s];
    const int* si = steps_i + 12 * s;
    const long long* stt = steps_t + 9 * s;
    st.kind = si[0];
    st.nops = si[1];
    st.n_out = si[2];
    st.n_sum = si[3];
    for (int k = 0; k < kMaxOps; ++k) st.src[k] = si[4 + k];
    st.dst = si[8];
    st.es = si[9];
    st.groups = si[10];
    st.affine = si[11] ? 1 : 0;
    for (int k = 0; k <= kMaxOps; ++k) st.t_out[k] = stt[k];
    for (int k = 0; k < kMaxOps; ++k) st.t_sum[k] = stt[kMaxOps + 1 + k];
    if (st.nops < 1 || st.nops > kMaxOps || st.n_out < 1 || st.n_sum < 1 ||
        st.groups < 1 || st.kind < kFree || st.kind > kReduce ||
        (st.kind == kReduce && (s != nsteps - 1 || workspace == nullptr)) ||
        (s != nsteps - 1 && st.dst < 0)) {
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
