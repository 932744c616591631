// probe_stream_f32: the streaming probe, out = alpha * a (* b), over a
// strided logical shape of up to three axes.
//
// Replaces the TPU probes' streaming kernels, hand-written Pallas kernels
// that measured how a v5e streams one layout or another:
//
// * scripts/tpu_layout_probe.py:75 (copy y = a * b over (35, E), blocks
//   (35, 32768); the docstring's layouts A-C are the same bytes);
// * scripts/tpu_fold_probe.py:84 and :96 (the same copy dof-major (35, E)
//   and folded (35, 8, E / 8));
// * scripts/tpu_lane_reshape_probe.py:52, kernels A (out = 2 x) and B
//   (out = x viewed (rows, g, d) times j[rows, g] broadcast over d).
//
// Each operand is given by its element strides over the logical shape
// (n0, n1, n2); a stride of 0 broadcasts.  The output is new and
// contiguous.  The host (ops/probe_kernels.py) merges axes that every
// tensor walks contiguously and picks one of three paths:
//
// * flat4: the output, and every operand laid out as it is (`mask`), move
//   as float4 over the flat index; any other operand (a broadcast j, say)
//   is read per element at its coordinates, found by multiply-high
//   division, so a row of any width (d = 10, 35) streams whole;
// * tile: an operand whose own stride-1 axis is axis 1 while the output's
//   is axis 2 (the transposing copy (E, 35) -> (35, E) and back) goes
//   through a shared-memory tile of TT x TF elements, TT or TF the whole
//   axis when it has at most 64 (so 35 is one tile, not 32 + 3): it is
//   read with the lanes along axis 1 and written with the lanes along axis
//   2, and where a tile covers a whole short axis its side in device memory
//   is one contiguous span, so both sides move whole lines; each thread
//   keeps 8 of its tile loads in flight before it stores them to the tile;
// * scalar: one float per thread and step (a ragged or misaligned flat
//   length).
//
// What bounds it on an H100: bytes.  A stream reads each operand once and
// writes the output once with one multiply per element per operand, far
// below the card's ridge, so the design only has to keep enough loads in
// flight and each warp's accesses whole: 16 bytes per thread, whole
// 128-byte lines per warp, and for the transposing copy the shared tile in
// place of a strided gather or scatter.  (The first design took 32 x 32
// tiles: 35 split into 32 + 3, and the transposing copy ran at 0.97 TB/s;
// the second loaded one element per thread at a time: 1.54 TB/s; PERF.md
// section 6.)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOps = 2;
constexpr int kTileMax = 64;            // a tile's longest side
constexpr int kTileSmall = 32;          // its shorter side when both axes
                                        // are long
constexpr long long kMaxBlocks = 1 << 20;
constexpr int kBatch = 8;               // tile loads a thread keeps in flight

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift: d's
// magic number m and shift s are made on the host (the round-up method, as
// PyTorch's IntDivider), so the per-element index arithmetic of a stream
// costs no division
struct FastDiv {
  unsigned d, m, s;
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned divide(unsigned n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

struct StreamArgs {
  const float* in[kMaxOps];
  float* out;
  long long n[3];            // logical extents; axis 2 is the output's
  long long os[3];           // output strides
  long long is[kMaxOps][3];  // operand strides
  FastDiv div2, div1;        // by n[2] and n[1] (tile: by TT and TF)
  int nops;
  float alpha;
};

// operand o's element at flat (row-major) index k of the logical shape
__device__ __forceinline__ float at_flat(const StreamArgs& p, int o,
                                         unsigned k) {
  const unsigned rest = divide(k, p.div2);
  const unsigned c0 = divide(rest, p.div1);
  const long long c1 = rest - c0 * p.div1.d;
  const long long c2 = k - rest * p.div2.d;
  return __ldg(p.in[o] + c0 * p.is[o][0] + c1 * p.is[o][1] +
               c2 * p.is[o][2]);
}

// This thread's first index, end and step over [0, work): the per-block
// range [b * per_block, (b + 1) * per_block) when per_block > 0, else a
// grid-stride loop over all of it.  work < 2^31.
struct Range {
  unsigned first, end, step;
};

__device__ inline Range thread_range(unsigned work, unsigned per_block) {
  if (per_block > 0) {
    const unsigned b = blockIdx.x * per_block;
    const unsigned end = per_block < work - b ? b + per_block : work;
    return {b + threadIdx.x, end, kThreads};
  }
  return {blockIdx.x * kThreads + threadIdx.x, work, gridDim.x * kThreads};
}

// work float4s of the contiguous output; operand o as float4 when bit o of
// mask is set
__global__ void __launch_bounds__(kThreads)
probe_stream_flat4(const StreamArgs p, const int mask, const unsigned work,
                   const unsigned per_block) {
  const Range r = thread_range(work, per_block);
  for (unsigned k = r.first; k < r.end; k += r.step) {
    const unsigned e0 = 4 * k;
    float v[4] = {p.alpha, p.alpha, p.alpha, p.alpha};
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o) {
      if (o < p.nops) {
        if ((mask >> o) & 1) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(p.in[o]) +
                                 k);
          v[0] *= w.x;
          v[1] *= w.y;
          v[2] *= w.z;
          v[3] *= w.w;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] *= at_flat(p, o, e0 + q);
        }
      }
    }
    reinterpret_cast<float4*>(p.out)[k] = make_float4(v[0], v[1], v[2],
                                                      v[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
probe_stream_scalar(const StreamArgs p, const unsigned work,
                    const unsigned per_block) {
  const Range r = thread_range(work, per_block);
  for (unsigned k = r.first; k < r.end; k += r.step) {
    float v = p.alpha;
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o) {
      if (o < p.nops) v *= at_flat(p, o, k);
    }
    p.out[k] = v;
  }
}

// A block owns one TT x TF tile of axes (1, 2) and walks axis 0; the tile
// index runs fastest over axis 1.  Operand o goes through the shared tile
// when bit o of mask is set (its stride on axis 1 is 1); the others are
// read as the output is written.  div1 divides by TT, div2 by TF.
__global__ void __launch_bounds__(kThreads)
probe_stream_tile(const StreamArgs p, const int mask,
                  const long long tiles_1) {
  // [f][t], pitch TT | 1 (odd): no bank conflicts on either side
  __shared__ float tile[kMaxOps][kTileMax * (kTileMax + 1)];
  const unsigned tt = p.div1.d;
  const unsigned tf = p.div2.d;
  const unsigned pitch = tt | 1;
  const long long t0 = (blockIdx.x % tiles_1) * tt;
  const long long f0 = (blockIdx.x / tiles_1) * tf;
  for (long long c0 = blockIdx.y; c0 < p.n[0]; c0 += gridDim.y) {
#pragma unroll
    for (int o = 0; o < kMaxOps; ++o) {
      if (o < p.nops && ((mask >> o) & 1)) {
        const float* a = p.in[o] + c0 * p.is[o][0];
        // kBatch loads in flight per thread, then their stores to the tile
        for (unsigned base = threadIdx.x; base < tt * tf;
             base += kBatch * kThreads) {
          float v[kBatch];
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const unsigned idx = base + b * kThreads;
            const unsigned f = divide(idx, p.div1);
            const unsigned t = idx - f * tt;
            v[b] = idx < tt * tf && t0 + t < p.n[1] && f0 + f < p.n[2]
                       ? __ldg(a + (t0 + t) * p.is[o][1] +
                               (f0 + f) * p.is[o][2])
                       : 0.f;
          }
#pragma unroll
          for (int b = 0; b < kBatch; ++b) {
            const unsigned idx = base + b * kThreads;
            const unsigned f = divide(idx, p.div1);
            if (idx < tt * tf) tile[o][f * pitch + idx - f * tt] = v[b];
          }
        }
      }
    }
    __syncthreads();
    for (unsigned idx = threadIdx.x; idx < tt * tf; idx += kThreads) {
      const unsigned t = divide(idx, p.div2);
      const unsigned f = idx - t * tf;
      if (t0 + t < p.n[1] && f0 + f < p.n[2]) {
        float v = p.alpha;
#pragma unroll
        for (int o = 0; o < kMaxOps; ++o) {
          if (o < p.nops) {
            v *= ((mask >> o) & 1)
                     ? tile[o][f * pitch + t]
                     : __ldg(p.in[o] + c0 * p.is[o][0] +
                             (t0 + t) * p.is[o][1] + (f0 + f) * p.is[o][2]);
          }
        }
        p.out[c0 * p.os[0] + (t0 + t) * p.os[1] + (f0 + f) * p.os[2]] = v;
      }
    }
    __syncthreads();
  }
}

bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// whether strides walk the shape n row-major and densely (axes of extent 1
// take any stride)
bool row_major(const long long* strides, const long long* n) {
  long long expected = 1;
  for (int a = 2; a >= 0; --a) {
    if (n[a] > 1 && strides[a] != expected) return false;
    expected *= n[a];
  }
  return true;
}

}  // namespace

extern "C" {

// mode: 0 scalar, 1 flat4, 2 tile.  ins: nops operand pointers;
// in_strides: nops x 3 element strides; out_strides and n: 3 each (flat4
// and scalar: the output row-major over n).  mask: the operands
// read as float4 (flat4) or staged in the tile (tile).  per_block: floats
// per thread block on the flat4 and scalar paths (0: one float4 or float
// per thread).  At most 2^31 - 1 elements.  Returns the CUDA error of the
// launch (0 on success); cudaErrorInvalidValue for arguments the path does
// not take.
int probe_stream_f32(int nops, void* const* ins, const long long* in_strides,
                     void* out, const long long* out_strides,
                     const long long* n, float alpha, int mode, int mask,
                     long long per_block, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (nops < 1 || nops > kMaxOps || per_block < 0 || out == nullptr ||
      mask < 0 || mask >= (1 << nops)) {
    return bad;
  }
  StreamArgs p{};
  p.nops = nops;
  p.alpha = alpha;
  p.out = static_cast<float*>(out);
  for (int a = 0; a < 3; ++a) {
    p.n[a] = n[a];
    p.os[a] = out_strides[a];
    if (n[a] < 1) return bad;
  }
  for (int o = 0; o < kMaxOps; ++o) {
    p.in[o] = o < nops ? static_cast<const float*>(ins[o]) : nullptr;
    for (int a = 0; a < 3; ++a) {
      p.is[o][a] = o < nops ? in_strides[o * 3 + a] : 0;
    }
  }
  const long long total = n[0] * n[1] * n[2];
  if (total > 0x7fffffffLL || per_block > 0x7fffffffLL) return bad;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    const long long tt = n[1] <= kTileMax ? n[1]
                         : n[2] <= kTileMax ? kTileMax : kTileSmall;
    const long long tf = n[2] <= kTileMax ? n[2] : kTileMax;
    const long long tiles_1 = (n[1] + tt - 1) / tt;
    const long long tiles = tiles_1 * ((n[2] + tf - 1) / tf);
    if (tiles > 0x7fffffffLL || mask < 1) return bad;
    p.div1 = make_div(static_cast<unsigned>(tt));
    p.div2 = make_div(static_cast<unsigned>(tf));
    const dim3 grid(static_cast<unsigned>(tiles),
                    static_cast<unsigned>(n[0] < 65535 ? n[0] : 65535));
    probe_stream_tile<<<grid, kThreads, 0, s>>>(p, mask, tiles_1);
    return static_cast<int>(cudaGetLastError());
  }
  if (!row_major(p.os, p.n)) return bad;  // flat4 and scalar: flat output
  p.div1 = make_div(static_cast<unsigned>(n[1]));
  p.div2 = make_div(static_cast<unsigned>(n[2]));
  long long work = total;
  long long pb = per_block;
  if (mode == 1) {
    if (total % 4 != 0 || per_block % 4 != 0 || !aligned16(out)) return bad;
    for (int o = 0; o < nops; ++o) {
      if (((mask >> o) & 1) &&
          !(aligned16(p.in[o]) && row_major(p.is[o], p.n))) {
        return bad;
      }
    }
    work = total / 4;
    pb = per_block / 4;
  } else if (mode != 0) {
    return bad;
  }
  long long nblocks;
  if (pb > 0) {
    nblocks = (work + pb - 1) / pb;
  } else {
    nblocks = (work + kThreads - 1) / kThreads;
    if (nblocks > kMaxBlocks) nblocks = kMaxBlocks;
  }
  const unsigned w = static_cast<unsigned>(work);
  const unsigned b = static_cast<unsigned>(pb);
  if (mode == 1) {
    probe_stream_flat4<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
        p, mask, w, b);
  } else {
    probe_stream_scalar<<<static_cast<unsigned>(nblocks), kThreads, 0, s>>>(
        p, w, b);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
