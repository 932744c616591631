// step_update and pairs_split: a model step's state update, and the split
// of a float64 state into float32 hi/lo pairs, each in one pass.
//
// Replaces the PyTorch glue of the model steps (models/wave.py,
// models/maxwell.py), which ran one kernel per operation and wrote a
// full-size temporary each time:
//
// * wave, float32: div_v = vx + vy + vz, u + dt * (div_v + lift), and
//   v + dt * grad_u (two adds, an add, a scale, an add; a scale, an add);
// * Maxwell, float32: rows[2k] - rows[2k+1] for k = 0, 1, 2, their
//   torch.stack, the scale and the add, once for E and once for H;
// * the same at float64 on pair storage, where each einsum output (a
//   float32 hi/lo pair) was first combined into a float64 temporary
//   (combine_pairs), and the state was split into pairs in two passes
//   (split_to_pairs: hi, then the remainder from the float64 value and hi).
//
// step_update computes, for each of up to kMaxGroups groups,
//
//     out = base + dt * (((s0 t0 + s1 t1) + s2 t2) + s3 t3)
//
// over one to kMaxTerms terms with signs s_k = +-1, where every operand is
// a (rows, E) view with unit stride along E and any row stride, or a
// (rows / inner, inner, E) view with any two row strides (the rows of a
// slice such as t[:, :9] of a (35, 15, E) tensor).  A group is one state
// tensor written (wave's u or v[x]) or one component of a field
// (Maxwell's E[k], whose rows 2k and 2k+1 are separate tensors; the
// viscoelastic ADER element's mechanism m).  A group may carry a weight
// w[e], one float an element (the relaxation frequency of a mechanism):
//
//     out = base + dt * (w * (((s0 t0 + s1 t1) + s2 t2) + s3 t3))
//
// in the float32 storage alone.  In
// the float32 storage base, terms and out are float32; on pairs base and
// out are float64 and each term is a float32 (hi, lo) pair whose planes may
// lie any distance apart, read as (double)hi + (double)lo.  The models'
// plain per-step route keeps PyTorch's glue (ops.kernels.step_update_plain)
// and comes here for neither.  pairs_split writes hi = rn_f32(x) and
// lo = rn_f32(x - (double)hi) in one pass over a contiguous float64 tensor.
//
// Arithmetic.  Every operation is an explicit round-to-nearest intrinsic
// (__fadd_rn, __fmul_rn, __dadd_rn, ...), in the order the PyTorch glue
// ran them, with dt rounded to float32 in the float32 storage as PyTorch
// rounds its scalar there: no multiply and add is contracted into an FMA,
// so the new state is the PyTorch glue's bit for bit, and a chained run's
// states are those of the steps it replaces.
//
// What bounds it on an H100: bytes.  Each element reads its base and terms
// once and writes its output once, with one add per term and one multiply,
// so the design only has to stream: each thread moves four elements per
// step, 16 bytes per float32 access (a float4; two double2 for a float64
// base or output), a thread block per row and chunk of a row (blockIdx.y
// is the group's row), and a scalar path where a pointer or row stride is
// not on 16 bytes, or for the last E % 4 elements of a row (pairs_split:
// of the tensor).  Bytes an
// element and step, read and written:
//
// * wave3d_p4 (float32, ndof 35): v 3 x 35 x 12 (v, grad, out), u 35 x 24
//   (u, three div rows, the lift, out): 2,100 bytes, 21.0 GB at E = 10M;
// * maxwell3d_p4 (float32): per field 3 x 35 x 16 (base, two rows, out),
//   3,360 bytes for E and H, 26.9 GB at E = 8M;
// * wave3d_p4_f64 (float64 on pairs): v 105 x 24 (v, the grad pair, out),
//   u 35 x 48 (u, three div pairs, the lift pair, out), 4,200 bytes, and
//   the splits of u and v, 140 x 16, 2,240 bytes: 25.8 GB at E = 4M;
// * seissol_viscoelastic_o5 (float32, 12 passes, rows at two strides, the
//   relaxations weighted): 16,890 floats read and written an element,
//   67.6 GB at E = 1M.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxGroups = 3;
constexpr int kMaxTerms = 4;
constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

struct UpdateGroup {
  const void* base;             // (rows, E): float or double
  void* out;                    // (rows, E), of the base's type
  const float* hi[kMaxTerms];   // each term (rows, E): float32, or on
  const float* lo[kMaxTerms];   // pairs its hi and lo planes
  const float* weight;          // (E,): the group's weight, or null
  // row r lies at (r / inner) * outer + (r % inner) * row
  long long base_row, out_row, term_row[kMaxTerms];
  long long base_outer, out_outer, term_outer[kMaxTerms];
};

struct UpdateArgs {
  UpdateGroup group[kMaxGroups];
  int rows;
  int inner;                    // rows at the inner stride (rows: one)
  long long E;
  int neg;                      // bit k: term k is subtracted
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// A pair's float64 value.
__device__ __forceinline__ double pair(float hi, float lo) {
  return __dadd_rn(static_cast<double>(hi), static_cast<double>(lo));
}

// One element of a term: a float32 value, or on pairs (T double) the
// pair's float64 value.
template <typename T>
__device__ __forceinline__ T term_at(const float* hi, const float* lo,
                                     long long e) {
  if constexpr (sizeof(T) == 8) {
    return pair(hi[e], lo[e]);
  } else {
    return hi[e];
  }
}

// The update of one element from its terms t[0..K), with the group's
// weight w where W.
template <typename T, int K, bool W>
__device__ __forceinline__ T update(T base, const T (&t)[K], T dt, int neg,
                                    T w) {
  T acc = (neg & 1) ? -t[0] : t[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = add_rn(acc, (neg >> k & 1) ? -t[k] : t[k]);
  if constexpr (W) acc = mul_rn(w, acc);
  return add_rn(base, mul_rn(dt, acc));
}

__device__ __forceinline__ float4 load4(const float* p, long long c) {
  return reinterpret_cast<const float4*>(p)[c];
}

__device__ __forceinline__ void load_base4(const float* p, long long c,
                                           float (&b)[4]) {
  const float4 v = load4(p, c);
  b[0] = v.x;
  b[1] = v.y;
  b[2] = v.z;
  b[3] = v.w;
}
__device__ __forceinline__ void load_base4(const double* p, long long c,
                                           double (&b)[4]) {
  const double2 v0 = reinterpret_cast<const double2*>(p)[2 * c];
  const double2 v1 = reinterpret_cast<const double2*>(p)[2 * c + 1];
  b[0] = v0.x;
  b[1] = v0.y;
  b[2] = v1.x;
  b[3] = v1.y;
}

// Four consecutive elements of a term from 16-byte loads.
__device__ __forceinline__ void term4(const float* hi, const float*,
                                      long long c, float (&t)[4]) {
  load_base4(hi, c, t);
}
__device__ __forceinline__ void term4(const float* hi, const float* lo,
                                      long long c, double (&t)[4]) {
  const float4 h = load4(hi, c);
  const float4 l = load4(lo, c);
  t[0] = pair(h.x, l.x);
  t[1] = pair(h.y, l.y);
  t[2] = pair(h.z, l.z);
  t[3] = pair(h.w, l.w);
}

__device__ __forceinline__ void store4(float* p, long long c,
                                       const float (&o)[4]) {
  reinterpret_cast<float4*>(p)[c] = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(double* p, long long c,
                                       const double (&o)[4]) {
  reinterpret_cast<double2*>(p)[2 * c] = make_double2(o[0], o[1]);
  reinterpret_cast<double2*>(p)[2 * c + 1] = make_double2(o[2], o[3]);
}

// T: the base's type, float (float32 terms) or double (pair terms); K
// terms; kVec: every row of every operand (and the weight) starts on 16
// bytes, so whole chunks of four elements move as vectors and only a row's
// last E % 4 elements go one by one; W: the groups carry weights (float32
// storage).
template <typename T, int K, bool kVec, bool W>
__global__ void __launch_bounds__(kThreads)
step_update_kernel(const UpdateArgs a, const T dt) {
  const int g = blockIdx.y / a.rows;
  const int r = blockIdx.y - g * a.rows;
  const long long r1 = r / a.inner, r2 = r - r1 * a.inner;
  const UpdateGroup& grp = a.group[g];
  const T* base = static_cast<const T*>(grp.base) + r1 * grp.base_outer +
                  r2 * grp.base_row;
  T* out = static_cast<T*>(grp.out) + r1 * grp.out_outer + r2 * grp.out_row;
  const T* weight = reinterpret_cast<const T*>(grp.weight);
  const float* hi[K];
  const float* lo[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const long long off = r1 * grp.term_outer[k] + r2 * grp.term_row[k];
    hi[k] = grp.hi[k] + off;
    lo[k] = sizeof(T) == 8 ? grp.lo[k] + off : nullptr;
  }
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long tail = 0;
  if constexpr (kVec) {
    const long long n4 = a.E / 4;
    for (long long c = first; c < n4; c += step) {
      T t[K][4];
      T b[4], o[4], w[4] = {};
#pragma unroll
      for (int k = 0; k < K; ++k) term4(hi[k], lo[k], c, t[k]);
      load_base4(base, c, b);
      if constexpr (W) load_base4(weight, c, w);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        T tq[K];
#pragma unroll
        for (int k = 0; k < K; ++k) tq[k] = t[k][q];
        o[q] = update<T, K, W>(b[q], tq, dt, a.neg, w[q]);
      }
      store4(out, c, o);
    }
    tail = 4 * n4;
  }
  for (long long e = tail + first; e < a.E; e += step) {
    T t[K];
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = term_at<T>(hi[k], lo[k], e);
    out[e] = update<T, K, W>(base[e], t, dt, a.neg, W ? weight[e] : T(0));
  }
}

__device__ __forceinline__ void split1(double x, float& h, float& l) {
  h = __double2float_rn(x);
  l = __double2float_rn(__dsub_rn(x, static_cast<double>(h)));
}

// x: n float64 values; hi, lo: the pair's planes.  kVec: all three start on
// 16 bytes, so whole chunks of four move as vectors and the last n % 4
// values one by one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
pairs_split_kernel(const double* x, float* hi, float* lo, long long n) {
  const long long first = static_cast<long long>(blockIdx.x) * kThreads +
                          threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  long long tail = 0;
  if constexpr (kVec) {
    const long long n4 = n / 4;
    for (long long c = first; c < n4; c += step) {
      double b[4];
      float h[4], l[4];
      load_base4(x, c, b);
#pragma unroll
      for (int q = 0; q < 4; ++q) split1(b[q], h[q], l[q]);
      store4(hi, c, h);
      store4(lo, c, l);
    }
    tail = 4 * n4;
  }
  for (long long e = tail + first; e < n; e += step) {
    split1(x[e], hi[e], lo[e]);
  }
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Whether each of `rows` rows, `inner` of them at row stride `row` and
// those runs at stride `outer` (elements of `size` bytes) from pointer p,
// starts on 16 bytes.
bool rows_on16(const void* p, long long row, long long outer, int rows,
               int inner, int size) {
  return on16(p) && (inner == 1 || (row * size) % 16 == 0) &&
         (rows == inner || (outer * size) % 16 == 0);
}

// (blocks along E, rows): chunks of four elements over kThreads threads,
// at most kMaxBlocks blocks in all.
dim3 grid_of(long long E, int nrows) {
  long long per_row = (E / 4 + (E % 4 != 0) + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocks / nrows > 0 ? kMaxBlocks / nrows : 1;
  if (per_row > cap) per_row = cap;
  return dim3(static_cast<unsigned>(per_row), static_cast<unsigned>(nrows));
}

template <typename T, int K, bool W>
void launch_update(const UpdateArgs& a, double dt, bool vec, dim3 grid,
                   cudaStream_t s) {
  const T d = static_cast<T>(dt);
  if (vec) {
    step_update_kernel<T, K, true, W><<<grid, kThreads, 0, s>>>(a, d);
  } else {
    step_update_kernel<T, K, false, W><<<grid, kThreads, 0, s>>>(a, d);
  }
}

template <typename T, bool W>
void launch_update(const UpdateArgs& a, int nterms, double dt, bool vec,
                   dim3 grid, cudaStream_t s) {
  switch (nterms) {
    case 1: launch_update<T, 1, W>(a, dt, vec, grid, s); break;
    case 2: launch_update<T, 2, W>(a, dt, vec, grid, s); break;
    case 3: launch_update<T, 3, W>(a, dt, vec, grid, s); break;
    default: launch_update<T, 4, W>(a, dt, vec, grid, s); break;
  }
}

}  // namespace

extern "C" {

int step_update_max_groups() { return kMaxGroups; }

int step_update_max_terms() { return kMaxTerms; }

// pairs: 0 float32, 1 float64 on pairs; rows: a group's rows, inner of
// them at the row stride and those runs at the outer one (inner = rows:
// one row stride); ptrs: ngroups x {base, out, term[kMaxTerms],
// lo[kMaxTerms], weight} (a term's float32 values or a pair's hi plane,
// then the lo planes, ignored but on pairs; the group's weight, E floats,
// null for none: all groups weighted or none, float32 storage alone);
// strides: ngroups x {base, out, term[kMaxTerms]} row strides, then the
// same outer strides, in elements; bit k of neg: term k is subtracted.
// Returns the CUDA error of the launch (0 on success).
int step_update(int pairs, int ngroups, int nterms, int rows, int inner,
                long long E, void* const* ptrs, const long long* strides,
                int neg, double dt, void* stream) {
  if (pairs < 0 || pairs > 1 || ngroups < 1 || ngroups > kMaxGroups ||
      nterms < 1 || nterms > kMaxTerms || rows < 1 || E < 1 ||
      inner < 1 || rows % inner != 0 ||
      static_cast<long long>(ngroups) * rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int kPtrs = 3 + 2 * kMaxTerms, kStrides = 2 * (2 + kMaxTerms);
  const bool weighted = ptrs[kPtrs - 1] != nullptr;
  const int size = pairs ? 8 : 4;
  UpdateArgs a;
  a.rows = rows;
  a.inner = inner;
  a.E = E;
  a.neg = neg;
  bool vec = true;
  for (int g = 0; g < ngroups; ++g) {
    UpdateGroup& grp = a.group[g];
    void* const* p = ptrs + g * kPtrs;
    const long long* st = strides + g * kStrides;
    const long long* outer = st + 2 + kMaxTerms;
    grp.base = p[0];
    grp.out = p[1];
    grp.weight = static_cast<const float*>(p[kPtrs - 1]);
    if ((grp.weight != nullptr) != weighted || (weighted && pairs)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    grp.base_row = st[0];
    grp.out_row = st[1];
    grp.base_outer = outer[0];
    grp.out_outer = outer[1];
    vec = vec && rows_on16(p[0], st[0], outer[0], rows, inner, size) &&
          rows_on16(p[1], st[1], outer[1], rows, inner, size) &&
          (!weighted || on16(grp.weight));
    for (int k = 0; k < kMaxTerms; ++k) {
      grp.hi[k] = static_cast<const float*>(p[2 + k]);
      grp.lo[k] = static_cast<const float*>(p[2 + kMaxTerms + k]);
      grp.term_row[k] = st[2 + k];
      grp.term_outer[k] = outer[2 + k];
      if (k < nterms) {
        vec = vec &&
              rows_on16(p[2 + k], st[2 + k], outer[2 + k], rows, inner, 4) &&
              (!pairs || rows_on16(p[2 + kMaxTerms + k], st[2 + k],
                                   outer[2 + k], rows, inner, 4));
      }
    }
  }
  const dim3 grid = grid_of(E, ngroups * rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (pairs) {
    launch_update<double, false>(a, nterms, dt, vec, grid, s);
  } else if (weighted) {
    launch_update<float, true>(a, nterms, dt, vec, grid, s);
  } else {
    launch_update<float, false>(a, nterms, dt, vec, grid, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: n contiguous float64 values; hi, lo: the pair's two float32 planes of
// n each.  Returns the CUDA error of the launch (0 on success).
int pairs_split(long long n, const void* x, void* hi, void* lo,
                void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const double* xp = static_cast<const double*>(x);
  float* h = static_cast<float*>(hi);
  float* l = static_cast<float*>(lo);
  const dim3 grid = grid_of(n, 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (on16(x) && on16(hi) && on16(lo)) {
    pairs_split_kernel<true><<<grid, kThreads, 0, s>>>(xp, h, l, n);
  } else {
    pairs_split_kernel<false><<<grid, kThreads, 0, s>>>(xp, h, l, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
