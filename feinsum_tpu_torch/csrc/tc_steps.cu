// tc_steps_f32: K2's multi-step dense schedules.
//
// Replaces the step loop of the TPU kernel feinsum_tpu/ops/pallas_emitter.py::
// _build_multigrid (K2, :268; the loop :387-425 through ops/
// kernel_lowering.py::lower_step) on every program with a tuple grid_index
// that tc_grid_f32 does not take: schedules of any number of steps, steps of
// one, two or more operands, step subscripts that rename letters, blocks on
// any grid letter.  There each grid cell evaluates the whole schedule on its
// blocks of the operands, intermediates in VMEM, and writes its tile of the
// output once.  The host plans the cells and steps (ops/tc_steps.py) and
// builds int32 offset tables from the strides of the views; this kernel
// runs them:
//
//     result[o] = sum_c prod_k operand_k[base_k + out_k[o] + sum_k[c]]
//
// for every step and output entry o of the cell, the steps in the
// schedule's order.
//
// Design.  One thread block per cell; blocks run in parallel and in no
// order:
// * the block decomposes its index into the grid letters' cell indices (the
//   last grid letter fastest) and adds each one's block times its stride to
//   every operand's and the output's base;
// * each step runs as threads over its output entries, consecutive threads
//   on consecutive entries in the order of the step's reference tensor
//   (ordered by the host so that reads and writes coalesce), each summing
//   its contracted entries in order, one fmaf per term; a step that
//   contracts at most one letter walks its operands by stride, without a
//   table;
// * einsum operands are read where they lie, in global memory through L1
//   and L2 (an operand no grid letter slices is shared by every cell and
//   stays in L2), never staged whole;
// * a step's result that a later step reads stays in shared memory, laid
//   out contiguous in its entries' order; the host reuses the room of an
//   intermediate once its last reader has run; a barrier between steps;
// * the last step writes the cell's tile of the output in its stored layout
//   through its offsets: each output element once, no atomics.
//
// What bounds it on an H100: each term loads its operands (L1 or shared
// memory) and the sum over the contracted entries is one dependent chain,
// so this simple design is bound by load latency and issue, far above the
// bytes or FLOP bound of a dense step (PERF.md).  Register tiling,
// mma.sync / wgmma for dense steps and TMA are later work.
//
// Float32 throughout.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 8;
constexpr int kMaxOps = 6;
constexpr int kMaxInputs = 8;
constexpr int kMaxGrid = 8;
constexpr size_t kMaxSmemBytes = 232448;

struct Step {
  int nops, n_out, n_sum, affine;
  int src[kMaxOps];  // >= 0: an einsum operand; < 0: -1 - an earlier step
  int dst;           // float offset of the result in shared memory; -1: output
  int t_out[kMaxOps + 1];  // tables of the entries: operands, then the result
  int t_sum[kMaxOps];      // tables of the contracted entries, or (affine)
                           // the contracted letter's strides
};

struct Plan {
  Step step[kMaxSteps];
  const float* in[kMaxInputs];
  float* out;
  long long count[kMaxGrid];                      // cells per grid letter
  long long gstride[kMaxGrid][kMaxInputs + 1];    // block * stride: inputs,
                                                  // then the output
  int nsteps, ninputs, ngrid;
};

// Entries o of one step: sum_c prod_k ptr[k][otab[k][o] + offset of c].
template <int N, bool kAffine>
__device__ void run_step(const float* const (&ptr)[kMaxOps],
                         const Step& st, const int* __restrict__ tab,
                         float* dst, const int* __restrict__ dtab) {
  for (int o = threadIdx.x; o < st.n_out; o += blockDim.x) {
    const float* b[N];
#pragma unroll
    for (int k = 0; k < N; ++k) b[k] = ptr[k] + tab[st.t_out[k] + o];
    float acc = 0.f;
    for (int c = 0; c < st.n_sum; ++c) {
      float v[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (kAffine) {
          v[k] = *b[k];
          b[k] += st.t_sum[k];
        } else {
          v[k] = b[k][tab[st.t_sum[k] + c]];
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
    dst[dtab[o]] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
tc_steps_kernel(const Plan p, const int* __restrict__ tab) {
  extern __shared__ float smem[];
  long long base[kMaxInputs + 1];
  for (int t = 0; t <= p.ninputs; ++t) base[t] = 0;
  long long cell = blockIdx.x;
  for (int g = p.ngrid - 1; g >= 0; --g) {
    const long long idx = cell % p.count[g];
    cell /= p.count[g];
    for (int t = 0; t < p.ninputs; ++t) base[t] += idx * p.gstride[g][t];
    base[p.ninputs] += idx * p.gstride[g][kMaxInputs];
  }
  for (int s = 0; s < p.nsteps; ++s) {
    const Step& st = p.step[s];
    const float* ptr[kMaxOps];
#pragma unroll
    for (int k = 0; k < kMaxOps; ++k) {
      const int src = k < st.nops ? st.src[k] : st.src[0];
      ptr[k] = src >= 0 ? p.in[src] + base[src]
                        : smem + p.step[-1 - src].dst;
    }
    float* dst = st.dst >= 0 ? smem + st.dst : p.out + base[p.ninputs];
    const int* dtab = tab + st.t_out[st.nops];
    const int code = st.nops * 2 + (st.affine ? 1 : 0);
    switch (code) {
#define TS_STEP(N, A)                               \
  case N * 2 + (A ? 1 : 0):                         \
    run_step<N, A>(ptr, st, tab, dst, dtab);        \
    break;
      TS_STEP(1, false) TS_STEP(1, true)
      TS_STEP(2, false) TS_STEP(2, true)
      TS_STEP(3, false) TS_STEP(3, true)
      TS_STEP(4, false) TS_STEP(4, true)
      TS_STEP(5, false) TS_STEP(5, true)
      TS_STEP(6, false) TS_STEP(6, true)
#undef TS_STEP
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// in_ptrs: the ninputs input views; out: the output view; steps_i: nsteps x
// {nops, n_out, n_sum, affine, src[6], dst}; steps_t: nsteps x {t_out[7],
// t_sum[6]}; grid: ngrid x {count, block * stride of each input, of the
// output}; tables: the int32 offset tables on the card; ncells: the product
// of the counts; threads: per block (a multiple of 32, at most 256);
// smem_floats: shared memory per block.  Returns the CUDA error of the
// launch (0 on success).
int tc_steps_f32(int ninputs, void* const* in_ptrs, void* out, int nsteps,
                 const int* steps_i, const int* steps_t, int ngrid,
                 const long long* grid, const void* tables, long long ncells,
                 int threads, int smem_floats, void* stream) {
  if (ninputs < 1 || ninputs > kMaxInputs || nsteps < 1 ||
      nsteps > kMaxSteps || ngrid < 1 || ngrid > kMaxGrid || ncells < 1 ||
      ncells > 0x7fffffffLL || threads < 32 || threads > kThreads ||
      threads % 32 || smem_floats < 0 || tables == nullptr ||
      out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats);
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  p.nsteps = nsteps;
  p.ninputs = ninputs;
  p.ngrid = ngrid;
  p.out = static_cast<float*>(out);
  for (int i = 0; i < ninputs; ++i) {
    p.in[i] = static_cast<const float*>(in_ptrs[i]);
    if (p.in[i] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  long long cells = 1;
  for (int g = 0; g < ngrid; ++g) {
    const long long* row = grid + g * (ninputs + 2);
    p.count[g] = row[0];
    if (p.count[g] < 1) return static_cast<int>(cudaErrorInvalidValue);
    cells *= p.count[g];
    for (int t = 0; t < ninputs; ++t) p.gstride[g][t] = row[1 + t];
    p.gstride[g][kMaxInputs] = row[1 + ninputs];
  }
  if (cells != ncells) return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < nsteps; ++s) {
    Step& st = p.step[s];
    const int* si = steps_i + (5 + kMaxOps) * s;
    const int* stt = steps_t + (2 * kMaxOps + 1) * s;
    st.nops = si[0];
    st.n_out = si[1];
    st.n_sum = si[2];
    st.affine = si[3] ? 1 : 0;
    for (int k = 0; k < kMaxOps; ++k) st.src[k] = si[4 + k];
    st.dst = si[4 + kMaxOps];
    for (int k = 0; k <= kMaxOps; ++k) st.t_out[k] = stt[k];
    for (int k = 0; k < kMaxOps; ++k) st.t_sum[k] = stt[kMaxOps + 1 + k];
    if (st.nops < 1 || st.nops > kMaxOps || st.n_out < 1 || st.n_sum < 1 ||
        (s != nsteps - 1 && (st.dst < 0 || st.dst >= smem_floats)) ||
        (s == nsteps - 1 && st.dst >= 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    for (int k = 0; k < st.nops; ++k) {
      if (st.src[k] >= ninputs || -1 - st.src[k] >= s) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tc_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tc_steps_kernel<<<static_cast<unsigned>(ncells), threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      p, static_cast<const int*>(tables));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
