"""
The hand-written CUDA kernels, their plain PyTorch versions and their launch
counters.

The first two replace the TPU kernel ``feinsum_tpu/ops/pallas_emitter.py::
build_pallas_executable`` (K1 in ROADMAP.md), which computes all rows of a
batched einsum in one fused kernel gridded over the long element axis:

* ``dg_rows_f32`` (``csrc/dg_rows.cu``) — the contraction rows,
  ``out[x, i, e] = Σ_s F[x, s, e] Σ_j R[s, i, j] u[s?, j, e]`` as planned by
  :mod:`~feinsum_tpu_torch.ops.dg_rows`.  On an H100 such a row sits near
  the fp32 CUDA-core ridge (about 20 flop per byte); the simple design is
  bound by shared-memory loads, and the source's header says what the
  design does about it.
* ``ew_product_f32`` (``csrc/ew_product.cu``) — the contraction-free rows,
  an elementwise product of same-layout operands.  It is bound by HBM
  bytes; the design streams 16 bytes per thread and step.
* ``row_reduce_f32`` (``csrc/row_reduce.cu``) — the rows with no ``i``
  output axis, ``out[e] = Σ_j w[j] u[e, j]`` (vecmat; rowsum without
  ``w``), as planned by :func:`~feinsum_tpu_torch.ops.dg_rows.
  plan_reduce_row`.  Bound by HBM bytes.

* ``long_reduce_f32`` (``csrc/long_reduce.cu``) — the rows whose long axis
  is contracted (the reference accumulates them across its grid steps),
  ``out[p?, q?, c?] = Σ_e Σ_c A[e, p?, c?] B[e, q?, c?]`` as planned by
  :func:`~feinsum_tpu_torch.ops.dg_rows.plan_long_reduce_row`: per-block
  partials in a workspace, summed across blocks by a second launch in a
  fixed order.  Bound by HBM bytes on the energy ``ej,ej->``.

``ew_flat_f32`` launches ``ew_product_f32`` on the flatten route of 1-D
operands with ``block_long`` elements per thread block: the port of
``feinsum_tpu/ops/pallas_emitter.py::_try_build_flat_elementwise`` (K3).
Its launches count apart from the copy row's.

The third replaces ``feinsum_tpu/ops/dd_emitter.py::build_dd_executable``
(K4), the same DG rows in float64 on (2, ...) float32 hi/lo pair storage:

* ``dd_rows`` (``csrc/dd_rows.cu``) — loads each pair as a float64 and
  computes the row in native FP64 on the card (the TPU has no FP64 units and
  used pair arithmetic); the source's header says what bounds it.

The fourth replaces ``feinsum_tpu/ops/pallas_emitter.py::_build_multigrid``
(K2), the dense tensor-contraction kernel gridded over output letters:

* ``tc_grid_f32`` (``csrc/tc_grid.cu``) — one contraction step
  ``C[c] = Σ A[a] B[b]`` (:class:`TCStep`), the output written once, in
  place, in its stored layout, through offset tables built here on the
  host once per operand strides.

Two more run a schedule whose precision is ``"bf16_3x"`` (the reference's
3-pass split dot, ``feinsum_tpu/ops/kernel_lowering.py::_dot_bf16_3x``) on
Hopper's TF32 tensor cores: each f32 operand splits into ``hi =
tf32_round(x)`` and ``lo = tf32_round(x - hi)``, and a dot is ``lo·hi +
hi·lo + hi·hi`` (:func:`tf32_split`, :func:`einsum_3x`):

* ``dg_rows_3xtf32`` (``csrc/dg_rows_3x.cu``) — ``dg_rows_f32``'s rows with
  the j-dot on ``mma.sync`` m16n8k8 TF32 (K1 at ``bf16_3x``);
* ``tc_grid_3xtf32`` (``csrc/tc_grid_3x.cu``) — ``tc_grid_f32``'s steps,
  tables and tiles with the tile's inner product on the same MMAs (K2 at
  ``bf16_3x``).

The last runs K1's schedule of a packed DG program (the lane-pack rewrite,
``tuning/impls/_common.py::rewrite_lane_pack_dg``; its plan is
:mod:`~feinsum_tpu_torch.ops.lane_pack`'s):

* ``lane_pack_dg_f32`` (``csrc/lane_pack_dg.cu``) — ``V = u'·T`` and ``W =
  J'·EXP`` as tiled dots over the kron-expanded T and the 0/1 EXP, and
  ``out[o] = Σ V[m]·W[w]`` over the terms of :class:`LanePackDGShape`; V
  and W stay in registers.  At ``bf16_3x`` the two dots take the 3xTF32
  split on the CUDA cores (``lane_pack_dg_3xtf32``, counted apart).

And one runs K1's general step algebra, every schedule step of a program
that no row family above takes (a step table of
:mod:`~feinsum_tpu_torch.ops.step_block`):

* ``step_block_f32`` (``csrc/step_block.cu``) — per thread block of the
  grid letter, the residents staged in shared memory and each streamed
  input's sub-tile copied there by ``cp.async`` (two buffers); a dense step
  as register tiles of RM x RN results per thread, any other as threads
  over (element, RT output entries), each summing its contracted entries
  through offset tables built here (:func:`step_block_tables`); results
  between steps stay in shared memory; a contracted long axis ends in
  per-block partials (a dense one as a split-K product) summed by a second
  launch in a fixed order.

And one runs K2's whole schedule, every step of a dense program with a
tuple ``grid_index`` that ``tc_grid_f32`` does not take (a cell table of
:mod:`~feinsum_tpu_torch.ops.tc_steps`):

* ``tc_steps_f32`` (``csrc/tc_steps.cu``) — one thread block per grid cell,
  each step as threads over its output entries, each summing its contracted
  entries through int32 offset tables built on the host
  (:func:`~feinsum_tpu_torch.ops.tc_steps.tc_steps_tables`); intermediates
  stay in shared memory; the last step writes the cell's tile of the output
  in its stored layout.

A wrapper launches its kernel for CUDA tensors and raises on anything it
cannot take; it runs the plain version only for tensors that lie on the
CPU.  There is no fallback from a CUDA tensor to the plain version.  Each
launch adds one to :data:`launch_counts`, so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..diagnostics import InvalidParameterError

# shared memory a Hopper thread block can use (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232_448
# register-array bounds of csrc/dg_rows.cu and csrc/dd_rows.cu (kMaxX, kMaxS)
MAX_X = MAX_S = 4
# threads per block of csrc/dd_rows.cu and csrc/dg_rows.cu (kThreads)
DD_THREADS = DG_THREADS = 128
# csrc/dg_rows_3x.cu: elements per warp tile (kTE: one m16 tile) and warps
# per block (kWarps)
DG3X_ELEMENTS = 16
DG3X_WARPS = 4
# the most j values csrc/row_reduce.cu takes (kMaxJ: w in shared memory)
MAX_REDUCE_J = 8192
# csrc/long_reduce.cu: threads per block (kThreads), which bounds a row's
# output entries, or its 4 x 4 tiles of an outer product, and a staged tile;
# the shared memory per block its staged tiles fill (48 KB, in floats)
LR_THREADS = 256
LR_SMEM_FLOATS = 12 * 1024
# csrc/lane_pack_dg.cu: threads per block (kThreads), k per staged chunk
# (kKC), and the most T slices, W slices, outputs and terms a program has
# (kMaxM, kMaxW, kMaxOut, kMaxTerms)
LP_THREADS = 256
LP_KC = 16
LP_MAX_M = 4
LP_MAX_W = 16
LP_MAX_OUT = 4
LP_MAX_TERMS = 16
# csrc/step_block.cu: threads per block (kThreads); the most steps, operands
# per step and operands per row a launch takes (kMaxSteps, kMaxOps,
# kMaxInputs); the most short letters per step (the offset tables' size,
# ops/step_block.py); the most elements per sub-tile; the register tiles
# (RM, RN) of a dense step the kernel is built for (the SB_DENSE cases);
# the shared memory of one SM and the blocks its registers hold
# (__launch_bounds__), which bound the blocks that run on it
SB_THREADS = 256
SB_MAX_STEPS = 8
SB_MAX_OPS = 4
SB_MAX_INPUTS = 8
SB_MAX_LETTERS = 8
SB_MAX_TE = 256
SB_TILES = tuple((rm, rn) for rm in (1, 2, 4, 8)
                 for rn in (1, 2, 4, 8)) + ((5, 5), (7, 1))
SB_SM_SMEM_BYTES = 233_472
SB_SM_BLOCKS = 2
# the ints and table offsets per step, and the ints per input, of a launch
SB_STEP_INTS = 24
SB_STEP_TABLES = 18
SB_STAGE_INTS = 8

# csrc/tc_steps.cu: threads per block (kThreads, the most; the planner
# takes fewer for a narrow cell); the most steps, operands per step,
# operands per row and grid letters a launch takes (kMaxSteps, kMaxOps,
# kMaxInputs, kMaxGrid); the most letters per step and offset-table entries
# of a cell the planner builds (ops/tc_steps.py)
TS_THREADS = 256
TS_MAX_STEPS = 8
TS_MAX_OPS = 6
TS_MAX_INPUTS = 8
TS_MAX_GRID = 8
TS_MAX_LETTERS = 16
TS_MAX_TABLE = 2 ** 26

# launches by kernel (the probe kernels of ``ops/probe_kernels.py`` too); a
# ``bf16_3x`` row planned onto a kernel with no 3x variant
# (``ew_product_f32``, ``ew_flat_f32``, ``row_reduce_f32``,
# ``long_reduce_f32``, ``step_block_f32``, ``tc_steps_f32``, ``dd_rows``)
# runs it in f32 and counts under its name
launch_counts = {"dg_rows_f32": 0, "ew_product_f32": 0, "ew_flat_f32": 0,
                 "row_reduce_f32": 0, "long_reduce_f32": 0, "dd_rows": 0,
                 "tc_grid_f32": 0, "dg_rows_3xtf32": 0, "tc_grid_3xtf32": 0,
                 "lane_pack_dg_f32": 0, "lane_pack_dg_3xtf32": 0,
                 "step_block_f32": 0, "tc_steps_f32": 0,
                 "probe_stream_f32": 0, "probe_apply_f32": 0,
                 "probe_apply_3xtf32": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _is_dense_permutation(t: torch.Tensor) -> bool:
    """Whether *t* is a permutation of a contiguous tensor, up to size-1
    and broadcast (stride-0) axes: the layouts the kernels are written
    for."""
    expected = 1
    for stride, size in sorted((st, sz) for st, sz in zip(t.stride(),
                                                            t.shape)
                               if sz > 1 and st != 0):
        if stride != expected:
            return False
        expected *= size
    return True


def _check_operand(name: str, t: torch.Tensor, device: torch.device,
                   shape: tuple) -> None:
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise InvalidParameterError(f"{name}: dtype {t.dtype}, the kernels"
                                    " take float32 (or float32 pairs) only")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not _is_dense_permutation(t):
        raise ValueError(f"{name}: strides {t.stride()} are not a"
                         " permutation of a contiguous layout")


def _stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _chunks(seq: Sequence, n: int):
    for k in range(0, len(seq), n):
        yield seq[k:k + n]


# {{{ the 3xTF32 split

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """*x* (float32) rounded to TF32, 10 explicit mantissa bits: to nearest,
    ties away from zero, on the bit pattern, as ``cvt.rna.tf32.f32`` rounds
    (and as the 3x kernels do); the low 13 bits of the result are zero.  A
    value that rounds past the largest float becomes an infinity;
    infinities and NaN pass unchanged."""
    finite = torch.isfinite(x)
    bits = torch.where(finite, x, 0.0).view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(finite, rounded, x)


def tf32_split(x: torch.Tensor) -> tuple:
    """``(hi, lo)``: ``hi = tf32_round(x)`` and ``lo = tf32_round(x -
    hi)``, so that ``x = hi + lo`` to about 2**-22 of ``|x|``."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def einsum_split(subscripts: str, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """The two-operand ``torch.einsum`` in three passes over the TF32
    split, ``lo·hi + hi·lo + hi·hi`` (the small terms first), each pass a
    full-f32 ``torch.einsum``: a product of two TF32 values is exact in f32,
    so this is the 3x kernels' arithmetic up to the order of the sums."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    return (torch.einsum(subscripts, al, bh) + torch.einsum(subscripts, ah, bl)
            + torch.einsum(subscripts, ah, bh))


def einsum_3x(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with every contraction of two float32 operands in
    three TF32 passes (:func:`einsum_split`): the ``bf16_3x`` meaning of a
    plain-route step.  Several operands are contracted pairwise, at each
    turn the pair whose result is smallest (a pair that contracts a letter
    first); a pair that contracts nothing, a single operand's sums and
    operands of other types run as plain ``torch.einsum``."""
    ins, out = subscripts.replace(" ", "").split("->")
    terms = list(zip(ins.split(","), operands))
    while len(terms) > 1:
        best = None
        for p in range(len(terms)):
            for q in range(p + 1, len(terms)):
                rest = set(out).union(*(set(s) for k, (s, _) in
                                        enumerate(terms) if k not in (p, q)))
                (sp, tp), (sq, tq) = terms[p], terms[q]
                keep = "".join(dict.fromkeys(c for c in sp + sq if c in rest))
                length = dict(zip(sp, tp.shape)) | dict(zip(sq, tq.shape))
                size = int(np.prod([length[c] for c in keep], dtype=np.int64))
                summed = len(set(sp + sq) - set(keep))
                if best is None or (size, -summed) < best[0]:
                    best = ((size, -summed), p, q, keep, summed)
        _, p, q, keep, summed = best
        (sp, tp), (sq, tq) = terms[p], terms[q]
        pair = f"{sp},{sq}->{keep}"
        if summed and tp.dtype == tq.dtype == torch.float32:
            val = einsum_split(pair, tp, tq)
        else:
            val = torch.einsum(pair, tp, tq)
        terms = [t for k, t in enumerate(terms) if k not in (p, q)]
        terms.append((keep, val))
    ((s, t),) = terms
    return torch.einsum(f"{s}->{out}", t)

# }}}


# {{{ dg_rows_f32

@dataclass(frozen=True)
class DGRow:
    """One planned row's operands as views in role order: ``u`` (S_u, J, E)
    with S_u 1 or S, ``R`` (S, I, J), ``F`` (X, S, E) or ``None`` (factor
    1, X = 1)."""

    u: torch.Tensor
    R: torch.Tensor
    F: Optional[torch.Tensor]


def dg_rows_smem_bytes(S: int, I: int, J: int, u_has_s: bool) -> int:
    """Shared memory one block of ``dg_rows_f32`` needs, in bytes: R (i
    padded to a multiple of 4) and one u column per thread (the formula of
    ``csrc/dg_rows.cu``)."""
    return 4 * (S * J * (-(-I // 4) * 4)
                + (S if u_has_s else 1) * J * DG_THREADS)


def _dg_dims(rows: Sequence[DGRow]) -> tuple:
    """(X, S, I, J, E, u_has_s, has_f), checked equal across rows."""
    r0 = rows[0]
    S, I, J = r0.R.shape
    E = r0.u.shape[2]
    X = 1 if r0.F is None else r0.F.shape[0]
    u_has_s = r0.u.shape[0] == S and S > 1
    has_f = r0.F is not None
    device = r0.u.device
    if X > MAX_X or S > MAX_S:
        raise InvalidParameterError(
            f"dg_rows_f32 takes at most {MAX_X} x and {MAX_S} s values,"
            f" got X={X} S={S}")
    for k, row in enumerate(rows):
        if (row.F is not None) != has_f:
            raise ValueError("rows disagree on the streamed factor F")
        _check_operand(f"row {k} u", row.u, device,
                       (S if u_has_s else 1, J, E))
        _check_operand(f"row {k} R", row.R, device, (S, I, J))
        if has_f:
            _check_operand(f"row {k} F", row.F, device, (X, S, E))
    return X, S, I, J, E, u_has_s, has_f


def dg_rows_3x_smem_bytes(X: int, S: int, I: int, J: int,
                          u_has_s: bool) -> int:
    """Shared memory one block of ``dg_rows_3xtf32`` needs, in bytes: R
    split into hi and lo (i and j padded to multiples of 8, 16 floats per
    tile of 8 j and 16 more per row when those tiles are even in number),
    and per warp two tiles of u and of F (16 elements each) and an output
    tile (the formula of ``csrc/dg_rows_3x.cu``)."""
    def pad8(n):
        return -(-n // 8) * 8
    kt = pad8(J) // 8
    r_pitch = 16 * kt + (16 if kt % 2 == 0 else 0)
    te = DG3X_ELEMENTS
    per_warp = (2 * (S if u_has_s else 1) * pad8(J) * (te + 8)
                + 2 * X * S * te + X * pad8(I) * (te + 4))
    return 4 * (S * pad8(I) * r_pitch + DG3X_WARPS * per_warp)


def _dg_plain(rows: Sequence[DGRow], out_order: tuple, matmul) -> list:
    outs = []
    for row in rows:
        t = matmul(row.R, row.u)                            # (S, I, E)
        if row.F is None:
            val = t.sum(0, keepdim=True)                    # (1, I, E)
        else:
            val = torch.einsum("xse,sie->xie", row.F, t)
        outs.append(val.permute(*out_order).contiguous())
    return outs


def dg_rows_plain(rows: Sequence[DGRow], out_order: tuple = (0, 1, 2)
                  ) -> list:
    """The plain PyTorch version of ``dg_rows_f32``: per row,
    ``t = R @ u`` over j, then ``Σ_s F t``; outputs contiguous in the
    stored order *out_order* (a permutation of the (X, I, E) axes)."""
    return _dg_plain(rows, out_order, torch.matmul)


def dg_rows_3x_plain(rows: Sequence[DGRow], out_order: tuple = (0, 1, 2)
                     ) -> list:
    """The plain PyTorch version of ``dg_rows_3xtf32``: ``dg_rows_plain``
    with the j-dot ``t = R @ u`` in three passes over the TF32 split
    (:func:`einsum_split`); ``Σ_s F t`` in f32."""
    return _dg_plain(rows, out_order, lambda R, u: einsum_split(
        "sij,sje->sie", R, u.expand(R.shape[0], *u.shape[1:])))


def dg_rows_f32(rows: Sequence[DGRow], *, block_long: int,
                out_order: tuple = (0, 1, 2),
                one_launch: bool = True) -> list:
    """Fused DG rows: each row's ``out[x, i, e]``, allocated contiguous in
    the stored order *out_order* (a permutation of the (X, I, E) axes).
    All rows go in one launch (up to the kernel's row limit per launch)
    unless *one_launch* is false; *block_long* elements per thread block."""
    return _dg_launch("dg_rows_f32", rows, block_long, out_order, one_launch)


def dg_rows_3xtf32(rows: Sequence[DGRow], *, block_long: int,
                   out_order: tuple = (0, 1, 2),
                   one_launch: bool = True) -> list:
    """``dg_rows_f32``'s rows with the j-dot in three TF32 passes on the
    tensor cores (``csrc/dg_rows_3x.cu``): the ``bf16_3x`` precision; the
    same arguments and outputs."""
    return _dg_launch("dg_rows_3xtf32", rows, block_long, out_order,
                      one_launch)


def _dg_launch(name: str, rows: Sequence[DGRow], block_long: int,
               out_order: tuple, one_launch: bool) -> list:
    """Launch ``dg_rows_f32`` or ``dg_rows_3xtf32`` (*name*; the plain
    version for CPU tensors)."""
    if not rows:
        return []
    X, S, I, J, E, u_has_s, has_f = _dg_dims(rows)
    device = rows[0].u.device
    if sorted(out_order) != [0, 1, 2]:
        raise ValueError(f"out_order {out_order} is not a permutation of 3")
    if device.type == "cpu":
        return (dg_rows_3x_plain if name == "dg_rows_3xtf32"
                else dg_rows_plain)(rows, out_order)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")

    from ._build import load_library
    lib = load_library()
    if name == "dg_rows_3xtf32":
        smem = lib.dg_rows_3xtf32_smem_bytes(X, S, I, J, int(u_has_s))
    else:
        smem = lib.dg_rows_f32_smem_bytes(S, I, J, int(u_has_s))
    if smem > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"{name} needs {smem} bytes of shared memory per block;"
            f" an H100 block has {MAX_SMEM_BYTES}")
    dims = (X, I, E)
    inverse = tuple(sorted(range(3), key=lambda k: out_order[k]))
    outs = [torch.empty(tuple(dims[k] for k in out_order),
                        dtype=torch.float32, device=device) for _ in rows]
    per_launch = getattr(lib, f"{name}_max_rows")() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            ptrs = (ctypes.c_void_p * (4 * len(idx)))()
            strides = (ctypes.c_int64 * (12 * len(idx)))()
            for n, k in enumerate(idx):
                row, out = rows[k], outs[k].permute(*inverse)
                f_ptr = row.F.data_ptr() if has_f else None
                ptrs[4 * n:4 * n + 4] = [row.u.data_ptr(), row.R.data_ptr(),
                                         f_ptr, out.data_ptr()]
                f_strides = row.F.stride() if has_f else (0, 0, 0)
                strides[12 * n:12 * n + 12] = [
                    *row.u.stride(), *row.R.stride(), *f_strides,
                    *out.stride()]
            err = getattr(lib, name)(len(idx), ptrs, strides, X, S, I, J, E,
                                     int(u_has_s), int(block_long),
                                     _stream_of(device))
            if err:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")
            launch_counts[name] += 1
    return outs

# }}}


# {{{ ew_product_f32

def _ew_check(rows: Sequence[Sequence[torch.Tensor]]) -> torch.Size:
    shape = rows[0][0].shape
    device = rows[0][0].device
    nops = len(rows[0])
    for k, row in enumerate(rows):
        if len(row) != nops:
            raise ValueError("rows differ in their number of operands")
        for o, t in enumerate(row):
            _check_operand(f"row {k} operand {o}", t, device, tuple(shape))
            if not t.is_contiguous():
                raise ValueError(f"row {k} operand {o} is not contiguous")
    return shape


def ew_product_plain(rows: Sequence[Sequence[torch.Tensor]]) -> list:
    """The plain PyTorch version of ``ew_product_f32`` (fresh outputs, as
    the kernel's, even for a single operand)."""
    return [functools.reduce(torch.mul, row) if len(row) > 1
            else row[0].clone() for row in rows]


def _ew_launch(rows: Sequence[Sequence[torch.Tensor]], block_long: int,
               one_launch: bool, counter: str) -> list:
    shape = _ew_check(rows)
    device = rows[0][0].device
    if device.type == "cpu":
        return ew_product_plain(rows)
    if device.type != "cuda":
        raise ValueError(f"ew_product_f32: no kernel for device {device}")

    from ._build import load_library
    lib = load_library()
    nops = len(rows[0])
    if nops > lib.ew_product_f32_max_ops():
        raise InvalidParameterError(
            f"ew_product_f32 takes at most {lib.ew_product_f32_max_ops()}"
            f" operands, got {nops}")
    n = rows[0][0].numel()
    outs = [torch.empty(shape, dtype=torch.float32, device=device)
            for _ in rows]
    per_launch = lib.ew_product_f32_max_rows() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            ins = (ctypes.c_void_p * (nops * len(idx)))(
                *[t.data_ptr() for k in idx for t in rows[k]])
            out_ptrs = (ctypes.c_void_p * len(idx))(
                *[outs[k].data_ptr() for k in idx])
            err = lib.ew_product_f32(len(idx), nops, ins, out_ptrs, n,
                                     block_long, _stream_of(device))
            if err:
                raise RuntimeError(f"ew_product_f32 launch failed: CUDA"
                                   f" error {err}")
            launch_counts[counter] += 1
    return outs


def ew_product_f32(rows: Sequence[Sequence[torch.Tensor]], *,
                   one_launch: bool = True) -> list:
    """Elementwise product of each row's same-shape contiguous operands; all
    rows in one launch (up to the kernel's row limit) unless *one_launch*
    is false.  The kernel's threads stride over the whole array."""
    if not rows:
        return []
    return _ew_launch(rows, 0, one_launch, "ew_product_f32")


def ew_flat_f32(rows: Sequence[Sequence[torch.Tensor]], *, block_long: int,
                one_launch: bool = True) -> list:
    """The flatten route (K3's port): ``ew_product_f32`` on each row's
    1-D operands with *block_long* consecutive elements per thread block;
    counted under ``ew_flat_f32``."""
    if not rows:
        return []
    if any(t.ndim != 1 for row in rows for t in row):
        raise ValueError("ew_flat_f32 takes 1-D operands")
    if block_long < 1:
        raise InvalidParameterError(
            f"block_long must be positive, got {block_long}")
    return _ew_launch(rows, int(block_long), one_launch, "ew_flat_f32")

# }}}


# {{{ row_reduce_f32

@dataclass(frozen=True)
class ReduceRow:
    """One planned no-``i`` row's operands as views in role order: ``u``
    (E, J) through any strides, ``w`` (J,) or ``None`` (weight 1)."""

    u: torch.Tensor
    w: Optional[torch.Tensor]


def row_reduce_plain(rows: Sequence[ReduceRow]) -> list:
    """The plain PyTorch version of ``row_reduce_f32``: per row ``u @ w``,
    or ``u.sum(1)`` without ``w``; contiguous (E,) outputs."""
    return [(row.u.sum(1) if row.w is None else row.u @ row.w).contiguous()
            for row in rows]


def row_reduce_f32(rows: Sequence[ReduceRow], *, block_long: int,
                   one_launch: bool = True) -> list:
    """Each row's ``out[e] = Σ_j w[j] u[e, j]`` as a contiguous (E,) tensor;
    all rows in one launch (up to the kernel's row limit) unless
    *one_launch* is false; *block_long* elements per thread block."""
    if not rows:
        return []
    E, J = rows[0].u.shape
    device = rows[0].u.device
    has_w = rows[0].w is not None
    for k, row in enumerate(rows):
        if (row.w is not None) != has_w:
            raise ValueError("rows disagree on the weight w")
        _check_operand(f"row {k} u", row.u, device, (E, J))
        if has_w:
            _check_operand(f"row {k} w", row.w, device, (J,))
            if not row.w.is_contiguous():
                raise ValueError(f"row {k} w is not contiguous")
    if device.type == "cpu":
        return row_reduce_plain(rows)
    if device.type != "cuda":
        raise ValueError(f"row_reduce_f32: no kernel for device {device}")

    if J > MAX_REDUCE_J:
        raise InvalidParameterError(
            f"row_reduce_f32 takes at most {MAX_REDUCE_J} values of j, got"
            f" {J}")
    from ._build import load_library
    lib = load_library()
    outs = [torch.empty((E,), dtype=torch.float32, device=device)
            for _ in rows]
    per_launch = lib.row_reduce_f32_max_rows() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            ptrs = (ctypes.c_void_p * (3 * len(idx)))()
            strides = (ctypes.c_int64 * (2 * len(idx)))()
            for n, k in enumerate(idx):
                row = rows[k]
                ptrs[3 * n:3 * n + 3] = [
                    row.u.data_ptr(), row.w.data_ptr() if has_w else None,
                    outs[k].data_ptr()]
                strides[2 * n:2 * n + 2] = list(row.u.stride())
            err = lib.row_reduce_f32(len(idx), ptrs, strides, J, E,
                                     int(block_long), _stream_of(device))
            if err:
                raise RuntimeError(f"row_reduce_f32 launch failed: CUDA"
                                   f" error {err}")
            launch_counts["row_reduce_f32"] += 1
    return outs

# }}}


# {{{ long_reduce_f32

@dataclass(frozen=True)
class LongReduceShape:
    """The letters of a contracted-long-axis row for ``long_reduce_f32``:
    the role of A's short letter (``"p"``, an output letter; ``"c"``, the
    shared or contracted letter; ``None``: A has none), of B's (``"q"``,
    ``"c"`` or ``None``), the lengths ``P``, ``Q``, ``C`` (1 where absent),
    whether ``c`` is an output letter (``c_batch``) and the output's stored
    axes, each ``"p"``, ``"q"`` or ``"c"``."""

    a_role: Optional[str]
    b_role: Optional[str]
    P: int
    Q: int
    C: int
    c_batch: bool
    out_axes: tuple

    def length(self, role: Optional[str]) -> int:
        return {"p": self.P, "q": self.Q, "c": self.C, None: 1}[role]

    @property
    def out_shape(self) -> tuple:
        return tuple(self.length(r) for r in self.out_axes)

    @property
    def entries(self) -> int:
        return self.P * self.Q * (self.C if self.c_batch else 1)


@dataclass(frozen=True)
class LongReduceRow:
    """One planned row's operands as (E, R) views in role order: ``a`` over
    (e, A's short letter), ``b`` over (e, B's) or ``None`` (the value 1);
    R is 1 for an operand with no short letter."""

    a: torch.Tensor
    b: Optional[torch.Tensor]


def long_reduce_tile(ra: int, rb: int) -> int:
    """Elements of e per staged tile of ``long_reduce_f32`` for short
    letters of lengths *ra* and *rb* (``rb = 0``: B is not staged): two
    buffers of the rows, each padded to the kernel's odd pitch, fill at most
    48 KB, at most 256 elements, a multiple of 32 above 32; 0 when not one
    element fits."""
    per = (ra | 1) + ((rb | 1) if rb > 0 else 0)
    te = min(LR_SMEM_FLOATS // 2 // per, LR_THREADS)
    return te - te % 32 if te > 32 else te


def long_reduce_limit(shape: LongReduceShape) -> Optional[str]:
    """Why ``long_reduce_f32`` does not take a row by its count of output
    entries (an outer product, the Gram matrix, of more than 256 4 x 4
    tiles, any other row of more than 256 entries), or ``None``: such rows
    go to ``step_block_f32``."""
    if shape.a_role == "p" and shape.b_role == "q":
        tiles = -(-shape.P // 4) * -(-shape.Q // 4)
        if tiles > LR_THREADS:
            return (f"long_reduce_f32 takes an outer product of at most"
                    f" {LR_THREADS} 4 x 4 tiles of output entries, the row"
                    f" has {tiles}")
    elif shape.entries > LR_THREADS:
        return (f"long_reduce_f32 takes at most {LR_THREADS} output entries,"
                f" the row has {shape.entries}")
    return None


def check_long_reduce_shape(shape: LongReduceShape) -> None:
    """Raise :class:`InvalidParameterError` for a row ``long_reduce_f32``
    does not take: too many output entries (:func:`long_reduce_limit`), or
    short letters too long for one staged element's rows."""
    limit = long_reduce_limit(shape)
    if limit is not None:
        raise InvalidParameterError(limit)
    ra = shape.length(shape.a_role)
    rb = shape.length(shape.b_role) if shape.b_role is not None else 1
    if long_reduce_tile(ra, rb) < 1:
        raise InvalidParameterError(
            f"long_reduce_f32 cannot stage short letters of lengths {ra} and"
            f" {rb} in shared memory")


def _long_reduce_dims(rows: Sequence[LongReduceRow],
                      shape: LongReduceShape) -> tuple:
    """(E, has_b), with every operand checked."""
    E = rows[0].a.shape[0]
    device = rows[0].a.device
    has_b = rows[0].b is not None
    if shape.a_role not in ("p", "c", None) \
            or shape.b_role not in ("q", "c", None):
        raise ValueError(f"roles {shape.a_role!r}, {shape.b_role!r}: A's is"
                         " 'p', 'c' or None, B's 'q', 'c' or None")
    if shape.b_role is not None and not has_b:
        raise ValueError("B has a role but no operand")
    if sorted(shape.out_axes) != sorted(
            [r for r in ("p", "q") if r in (shape.a_role, shape.b_role)]
            + (["c"] if shape.c_batch else [])):
        raise ValueError(f"output axes {shape.out_axes} do not match the"
                         " roles")
    if shape.c_batch and not (shape.a_role == shape.b_role == "c"):
        raise ValueError("an output letter c must be shared by A and B")
    for k, row in enumerate(rows):
        if (row.b is not None) != has_b:
            raise ValueError("rows disagree on the operand B")
        _check_operand(f"row {k} a", row.a, device,
                       (E, shape.length(shape.a_role)))
        if has_b:
            _check_operand(f"row {k} b", row.b, device,
                           (E, shape.length(shape.b_role)))
    return E, has_b


def long_reduce_plain(rows: Sequence[LongReduceRow],
                      shape: LongReduceShape) -> list:
    """The plain PyTorch version of ``long_reduce_f32``, step by step in
    float32: each operand as (E, P or Q, C) (broadcast where it lacks the
    letter), then one product over e (and c, when contracted) by
    ``torch.matmul``; outputs contiguous in the stored axis order."""
    E, has_b = _long_reduce_dims(rows, shape)
    Cb = shape.C if shape.c_batch else 1

    def as3(t, role):
        """(E, R) -> (E, P or Q or 1, C), broadcast where it lacks a
        letter; the absent B is the value 1."""
        if t is None:
            return torch.ones((), dtype=torch.float32,
                              device=rows[0].a.device).expand(E, 1, shape.C)
        if role == "c":
            return t[:, None, :].expand(E, 1, shape.C)
        return t[:, :, None].expand(E, t.shape[1], shape.C)

    outs = []
    for row in rows:
        A = as3(row.a, shape.a_role)                     # (E, P, C)
        B = as3(row.b, shape.b_role)                     # (E, Q, C)
        if shape.c_batch:
            full = torch.matmul(A.permute(2, 1, 0), B.permute(2, 0, 1))
            full = full.permute(1, 2, 0)                 # (P, Q, C)
        else:
            A2 = A.permute(1, 0, 2).reshape(A.shape[1], E * shape.C)
            B2 = B.permute(1, 0, 2).reshape(B.shape[1], E * shape.C)
            full = torch.matmul(A2, B2.T)[:, :, None]    # (P, Q, 1)
        full = full.expand(shape.P, shape.Q, Cb)
        axes = {"p": 0, "q": 1, "c": 2}
        order = [axes[r] for r in shape.out_axes]
        rest = [k for k in range(3) if k not in order]
        outs.append(full.permute(*order, *rest).reshape(
            shape.out_shape).contiguous())
    return outs


def long_reduce_f32(rows: Sequence[LongReduceRow], shape: LongReduceShape,
                    *, block_long: int, one_launch: bool = True) -> list:
    """Each row's sum over the contracted long axis (:class:`LongReduceShape`)
    as a contiguous tensor in the output's stored axis order.  All rows go
    in one pair of launches (up to the kernel's row limit) unless
    *one_launch* is false; *block_long* elements of e per thread block."""
    if not rows:
        return []
    E, has_b = _long_reduce_dims(rows, shape)
    device = rows[0].a.device
    if device.type == "cpu":
        return long_reduce_plain(rows, shape)
    if device.type != "cuda":
        raise ValueError(f"long_reduce_f32: no kernel for device {device}")
    check_long_reduce_shape(shape)
    if block_long < 1:
        raise InvalidParameterError(
            f"block_long must be positive, got {block_long}")

    from ._build import load_library
    lib = load_library()
    roles = {None: 0, "p": 1, "q": 1, "c": 2}
    role_arr = (ctypes.c_int * 2)(roles[shape.a_role],
                                  roles[shape.b_role if has_b else None])
    nblocks = -(-E // int(block_long))
    # B is staged unless it is A itself in every row (the energy)
    b_staged = has_b and not all(
        r.b.data_ptr() == r.a.data_ptr() and r.b.stride() == r.a.stride()
        and r.b.shape == r.a.shape for r in rows)
    te = long_reduce_tile(shape.length(shape.a_role),
                          shape.length(shape.b_role) if b_staged else 0)
    outs = [torch.empty(shape.out_shape, dtype=torch.float32, device=device)
            for _ in rows]
    per_launch = lib.long_reduce_f32_max_rows() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            work = torch.empty(len(idx) * nblocks * shape.entries,
                               dtype=torch.float32, device=device)
            ptrs = (ctypes.c_void_p * (3 * len(idx)))()
            strides = (ctypes.c_int64 * (7 * len(idx)))()
            for n, k in enumerate(idx):
                row, out = rows[k], outs[k]
                out_stride = dict(zip(shape.out_axes, out.stride()))
                ptrs[3 * n:3 * n + 3] = [
                    row.a.data_ptr(), row.b.data_ptr() if has_b else None,
                    out.data_ptr()]
                b_strides = row.b.stride() if has_b else (0, 0)
                strides[7 * n:7 * n + 7] = [
                    *row.a.stride(), *b_strides,
                    *(out_stride.get(r, 0) for r in ("p", "q", "c"))]
            err = lib.long_reduce_f32(
                len(idx), ptrs, strides, role_arr, shape.P, shape.Q,
                shape.C, int(shape.c_batch), E, int(block_long), te,
                int(b_staged), ctypes.c_void_p(work.data_ptr()),
                _stream_of(device))
            if err:
                raise RuntimeError(f"long_reduce_f32 launch failed: CUDA"
                                   f" error {err}")
            launch_counts["long_reduce_f32"] += 1
    return outs

# }}}


# {{{ dd_rows

@dataclass(frozen=True)
class DDRow:
    """One planned fp64 row's operands as (2, ...) float32 hi/lo pair views
    in role order: ``u`` (2, S_u, J, E) with S_u 1 or S, ``R`` (2, S, I, J),
    ``F`` (2, X, S, E) or ``None`` (factor 1, X = 1)."""

    u: torch.Tensor
    R: torch.Tensor
    F: Optional[torch.Tensor]


def dd_rows_smem_bytes(S: int, I: int, J: int, u_has_s: bool) -> int:
    """Shared memory one block of ``dd_rows`` needs, in bytes: R as double
    (i padded to a multiple of 4) and one double u column per thread (the
    formula of ``csrc/dd_rows.cu``)."""
    return 8 * (S * J * (-(-I // 4) * 4)
                + (S if u_has_s else 1) * J * DD_THREADS)


def _dd_dims(rows: Sequence[DDRow]) -> tuple:
    """(X, S, I, J, E, u_has_s, has_f), checked equal across rows."""
    r0 = rows[0]
    for k, row in enumerate(rows):
        for role in ("u", "R", "F"):
            t = getattr(row, role)
            if t is not None and (t.ndim != 4 or t.shape[0] != 2):
                raise ValueError(f"row {k} {role}: shape {tuple(t.shape)}"
                                 " is not a (2, ., ., .) pair tensor")
    _, S, I, J = r0.R.shape
    E = r0.u.shape[3]
    X = 1 if r0.F is None else r0.F.shape[1]
    u_has_s = r0.u.shape[1] == S and S > 1
    has_f = r0.F is not None
    device = r0.u.device
    if X > MAX_X or S > MAX_S:
        raise InvalidParameterError(
            f"dd_rows takes at most {MAX_X} x and {MAX_S} s values,"
            f" got X={X} S={S}")
    for k, row in enumerate(rows):
        if (row.F is not None) != has_f:
            raise ValueError("rows disagree on the streamed factor F")
        _check_operand(f"row {k} u", row.u, device,
                       (2, S if u_has_s else 1, J, E))
        _check_operand(f"row {k} R", row.R, device, (2, S, I, J))
        if has_f:
            _check_operand(f"row {k} F", row.F, device, (2, X, S, E))
    return X, S, I, J, E, u_has_s, has_f


def dd_rows_plain(rows: Sequence[DDRow]) -> list:
    """The plain PyTorch version of ``dd_rows``: per row, the pairs
    recombined to float64, ``t = R @ u`` over j and ``Σ_s F t`` in float64,
    then split back into (2, X, I, E) pairs."""
    from .dd_emitter import combine_pairs, split_to_pairs
    outs = []
    for row in rows:
        t = torch.matmul(combine_pairs(row.R), combine_pairs(row.u))
        if row.F is None:
            val = t.sum(0, keepdim=True)                    # (1, I, E)
        else:
            val = torch.einsum("xse,sie->xie", combine_pairs(row.F), t)
        outs.append(split_to_pairs(val))
    return outs


def dd_rows(rows: Sequence[DDRow], *, block_long: int,
            one_launch: bool = True) -> list:
    """Fused fp64 DG rows on pair storage: each row's ``out[x, i, e]`` as a
    contiguous (2, X, I, E) float32 hi/lo pair tensor.  All rows go in one
    launch (up to the kernel's row limit per launch) unless *one_launch* is
    false; *block_long* elements per thread block."""
    if not rows:
        return []
    X, S, I, J, E, u_has_s, has_f = _dd_dims(rows)
    device = rows[0].u.device
    if device.type == "cpu":
        return dd_rows_plain(rows)
    if device.type != "cuda":
        raise ValueError(f"dd_rows: no kernel for device {device}")

    from ._build import load_library
    lib = load_library()
    smem = lib.dd_rows_smem_bytes(S, I, J, int(u_has_s))
    if smem > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"dd_rows needs {smem} bytes of shared memory per block; an"
            f" H100 block has {MAX_SMEM_BYTES}")
    outs = [torch.empty((2, X, I, E), dtype=torch.float32, device=device)
            for _ in rows]
    per_launch = lib.dd_rows_max_rows() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            ptrs = (ctypes.c_void_p * (4 * len(idx)))()
            strides = (ctypes.c_int64 * (16 * len(idx)))()
            for n, k in enumerate(idx):
                row, out = rows[k], outs[k]
                f_ptr = row.F.data_ptr() if has_f else None
                ptrs[4 * n:4 * n + 4] = [row.u.data_ptr(), row.R.data_ptr(),
                                         f_ptr, out.data_ptr()]
                f_strides = row.F.stride() if has_f else (0, 0, 0, 0)
                strides[16 * n:16 * n + 16] = [
                    *row.u.stride(), *row.R.stride(), *f_strides,
                    *out.stride()]
            err = lib.dd_rows(len(idx), ptrs, strides, X, S, I, J, E,
                              int(u_has_s), int(block_long),
                              _stream_of(device))
            if err:
                raise RuntimeError(f"dd_rows launch failed: CUDA error"
                                   f" {err}")
            launch_counts["dd_rows"] += 1
    return outs

# }}}


# {{{ tc_grid_f32

# (rows, columns) of a thread block's output tile, by variant
# (csrc/tc_grid.cu kTM, kTN: 16 x 16 threads, TM x TN outputs each)
TC_TILES = ((128, 128), (64, 64), (128, 32), (32, 128))
TC_MAX_BLOCKS = 2 ** 31 - 1     # gridDim.x
TC_SMS = 132                    # SMs of an H100 SXM


@dataclass(frozen=True)
class TCStep:
    """One dense contraction step ``C[c] = Σ A[a] B[b]`` in stored letters:
    ``a``, ``b`` and ``c`` name the axes of the stored operands and of the
    stored output, ``lengths`` gives ``(letter, length)`` pairs, ``grid`` the
    ``(letter, block)`` pairs the CUDA grid walks (a cell holds *block*
    consecutive indices of the letter) and ``grid_m`` the output letter that
    runs fastest along the tile's rows (``None``: ``A`` gives the rows)."""

    a: tuple
    b: tuple
    c: tuple
    lengths: tuple
    grid: tuple = ()
    grid_m: Optional[str] = None


@dataclass(frozen=True)
class TCShape:
    """A :class:`TCStep` classified for ``tc_grid_f32``: whether ``B`` is the
    row operand (``swap``), the in-cell row, column and contracted letters
    (extent > 1) with their in-cell extents, the cells as ``(letter, block,
    count)``, the sizes ``Mc x Nc`` per cell, ``K`` and ``ncells``, and the
    tile variant."""

    swap: bool
    m: tuple
    n: tuple
    k: tuple
    extent: tuple
    cells: tuple
    Mc: int
    Nc: int
    K: int
    ncells: int
    variant: int


def _pick_tile(Mc: int, Nc: int, ncells: int) -> int:
    """The tile variant: the largest tile (8 x 8 per thread, balanced
    between shared-memory loads and FMAs) unless another pads the cell's
    Mc x Nc output by at least 15% less; a 64 x 64 tile when the large one
    leaves fewer than two blocks per SM."""
    def tiles(v):
        bm, bn = TC_TILES[v]
        return -(-Mc // bm) * -(-Nc // bn)

    def padded(v):
        return tiles(v) * TC_TILES[v][0] * TC_TILES[v][1]
    v = min(range(len(TC_TILES)),
            key=lambda v: (padded(v) * (1.0 if v == 0 else 1.15), v))
    if v == 0 and ncells * tiles(0) < 2 * TC_SMS:
        v = 1
    return v


@functools.lru_cache(maxsize=256)
def tc_classify(step: TCStep) -> TCShape:
    """Classify *step*'s letters for ``tc_grid_f32``; raises
    :class:`InvalidParameterError` for what the kernel does not take."""
    lengths = dict(step.lengths)
    a, b, c = set(step.a), set(step.b), set(step.c)
    for name, letters in (("A", step.a), ("B", step.b), ("C", step.c)):
        if len(set(letters)) != len(letters):
            raise InvalidParameterError(
                f"tc_grid_f32: {name} repeats a letter ({letters})")
    private = (a ^ b) - c
    if private:
        raise InvalidParameterError(
            f"tc_grid_f32: letters {sorted(private)} are contracted within"
            " one operand")
    if not c <= a | b:
        raise InvalidParameterError("tc_grid_f32: an output letter is in"
                                    " neither operand")
    blocks = dict(step.grid)
    for l, blk in step.grid:
        if l not in c:
            raise InvalidParameterError(
                f"tc_grid_f32: grid letter {l!r} must be an output letter")
        if blk < 1 or lengths[l] % blk:
            raise InvalidParameterError(
                f"grid block {blk} does not divide {l}={lengths[l]}")
        if l in a and l in b and blk > 1:
            raise InvalidParameterError(
                f"tc_grid_f32: batch letter {l!r} is walked one index per"
                f" cell; block {blk} > 1")
    # batch letters are walked by the grid, one index per cell
    grid = list(step.grid) + [(l, 1) for l in step.c
                              if l in a and l in b and l not in blocks]
    extent = {l: (dict(grid)[l] if l in dict(grid) else lengths[l])
              for l in a | b}
    swap = step.grid_m is not None and step.grid_m not in a
    if step.grid_m is not None:
        if step.grid_m not in c:
            raise InvalidParameterError(
                f"grid_m {step.grid_m!r} must be an output letter")
        if extent[step.grid_m] <= 1:
            raise InvalidParameterError(
                f"grid_m {step.grid_m!r} has in-cell extent"
                f" {extent[step.grid_m]}; block it or leave it ungridded")
    rows, cols = (b, a) if swap else (a, b)

    def in_cell(letters):
        return tuple(sorted(l for l in letters if extent[l] > 1))
    m = in_cell((rows & c) - cols)
    n = in_cell((cols & c) - rows)
    k = in_cell((a & b) - c)
    size = {key: int(np.prod([extent[l] for l in v], dtype=np.int64))
            for key, v in (("m", m), ("n", n), ("k", k))}
    cells = tuple((l, blk, lengths[l] // blk) for l, blk in grid)
    ncells = int(np.prod([cnt for _, _, cnt in cells], dtype=np.int64))
    if max(size.values()) > 2 ** 31 - 1:
        raise InvalidParameterError(
            f"tc_grid_f32: a cell's rows, columns or K exceed 2**31 ({size})")
    variant = _pick_tile(size["m"], size["n"], ncells)
    bm, bn = TC_TILES[variant]
    if ncells * -(-size["m"] // bm) * -(-size["n"] // bn) > TC_MAX_BLOCKS:
        raise InvalidParameterError(
            "tc_grid_f32: the launch exceeds the CUDA grid's 2**31 - 1"
            " blocks")
    return TCShape(swap=swap, m=m, n=n, k=k,
                   extent=tuple(sorted(extent.items())), cells=cells,
                   Mc=size["m"], Nc=size["n"], K=size["k"], ncells=ncells,
                   variant=variant)


def _offsets(letters: tuple, extent: dict, strides: Sequence[dict]) -> list:
    """Per tensor, the int64 offsets of the flattened index over *letters*
    (the first letter fastest)."""
    offs = [np.zeros(1, dtype=np.int64) for _ in strides]
    for l in reversed(letters):
        idx = np.arange(extent[l], dtype=np.int64)
        offs = [(o[:, None] + idx[None, :] * st.get(l, 0)).ravel()
                for o, st in zip(offs, strides)]
    return offs


@functools.lru_cache(maxsize=32)
def tc_tables(step: TCStep, a_strides: tuple, b_strides: tuple,
              c_strides: tuple) -> tuple:
    """``(tables, flags)`` of ``tc_grid_f32`` for operands and an output
    with these strides (elements per axis, in stored letter order): the
    offset tables in the order ``csrc/tc_grid.cu`` reads them (int32 when
    every offset and the output fit, else int64), and the kernel's
    flags.  Each side's letters are ordered fastest first by
    the strides of its larger tensor (the row side's, or the output's),
    ``grid_m`` first on the row side; the contracted letters by the larger
    operand's strides."""
    shape = tc_classify(step)
    lengths = dict(step.lengths)
    extent = dict(shape.extent)
    sa, sb, sc = (dict(zip(letters, st)) for letters, st in (
        (step.a, a_strides), (step.b, b_strides), (step.c, c_strides)))
    if shape.swap:
        sa, sb = sb, sa
        na, nb = step.b, step.a
    else:
        na, nb = step.a, step.b

    def numel(letters):
        return int(np.prod([lengths[l] for l in letters], dtype=np.int64))

    def order(letters, by):
        return tuple(sorted(letters, key=lambda l: (by.get(l, 0), l)))
    m = order(shape.m, sa if numel(na) > numel(step.c) else sc)
    if step.grid_m in m:
        m = (step.grid_m,) + tuple(l for l in m if l != step.grid_m)
    n = order(shape.n, sb if numel(nb) > numel(step.c) else sc)
    k = order(shape.k, sa if numel(na) >= numel(nb) else sb)

    def fastest(letters, st):
        return st[letters[0]] if letters else np.inf
    flags = ((1 if fastest(k, sa) < fastest(m, sa) else 0)
             | (2 if fastest(k, sb) < fastest(n, sb) else 0)
             | (4 if fastest(m, sc) < fastest(n, sc) else 0))
    am, cm = _offsets(m, extent, (sa, sc))
    bn, cn = _offsets(n, extent, (sb, sc))
    ak, bk = _offsets(k, extent, (sa, sb))
    bases = [np.zeros(1, dtype=np.int64) for _ in range(3)]
    for l, blk, count in reversed(shape.cells):
        idx = np.arange(count, dtype=np.int64) * blk
        bases = [(o[:, None] + idx[None, :] * st.get(l, 0)).ravel()
                 for o, st in zip(bases, (sa, sb, sc))]
    tables = np.concatenate([am, cm, bn, cn, ak, bk, *bases])
    if int(tables.max()) < 2 ** 31 - 1 and numel(step.c) < 2 ** 31:
        # int32 offsets: fewer registers and integer instructions
        tables, flags = tables.astype(np.int32), flags | 8
    return tables, flags


@functools.lru_cache(maxsize=32)
def _tc_device_tables(step: TCStep, a_strides: tuple, b_strides: tuple,
                      c_strides: tuple, device: torch.device) -> tuple:
    tables, flags = tc_tables(step, a_strides, b_strides, c_strides)
    return torch.from_numpy(tables).to(device), flags


def tc_grid_plain(A: torch.Tensor, B: torch.Tensor, step: TCStep
                  ) -> torch.Tensor:
    """The plain PyTorch version of ``tc_grid_f32``: ``torch.einsum`` on the
    stored operands (their letters are their axes), the result contiguous in
    the output's stored layout."""
    subs = f"{''.join(step.a)},{''.join(step.b)}->{''.join(step.c)}"
    return torch.einsum(subs, A, B).contiguous()


def tc_grid_3x_plain(A: torch.Tensor, B: torch.Tensor, step: TCStep
                     ) -> torch.Tensor:
    """The plain PyTorch version of ``tc_grid_3xtf32``: ``tc_grid_plain``
    in three passes over the TF32 split (:func:`einsum_split`)."""
    subs = f"{''.join(step.a)},{''.join(step.b)}->{''.join(step.c)}"
    return einsum_split(subs, A, B).contiguous()


def tc_grid_f32(A: torch.Tensor, B: torch.Tensor, step: TCStep
                ) -> torch.Tensor:
    """``C[c] = Σ A[a] B[b]`` for one :class:`TCStep`, ``C`` allocated
    contiguous in the output's stored letter order ``step.c``."""
    return _tc_launch("tc_grid_f32", A, B, step)


def tc_grid_3xtf32(A: torch.Tensor, B: torch.Tensor, step: TCStep
                   ) -> torch.Tensor:
    """``tc_grid_f32``'s step with the tile's inner product in three TF32
    passes on the tensor cores (``csrc/tc_grid_3x.cu``): the ``bf16_3x``
    precision; the same tables, tiles and output."""
    return _tc_launch("tc_grid_3xtf32", A, B, step)


def _tc_launch(name: str, A: torch.Tensor, B: torch.Tensor, step: TCStep
               ) -> torch.Tensor:
    """Launch ``tc_grid_f32`` or ``tc_grid_3xtf32`` (*name*; the plain
    version for CPU tensors)."""
    lengths = dict(step.lengths)
    device = A.device
    _check_operand("A", A, device, tuple(lengths[l] for l in step.a))
    _check_operand("B", B, device, tuple(lengths[l] for l in step.b))
    shape = tc_classify(step)
    if device.type == "cpu":
        return (tc_grid_3x_plain if name == "tc_grid_3xtf32"
                else tc_grid_plain)(A, B, step)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")

    from ._build import load_library
    lib = load_library()
    C = torch.empty(tuple(lengths[l] for l in step.c), dtype=torch.float32,
                    device=device)
    tables, flags = _tc_device_tables(step, tuple(A.stride()),
                                      tuple(B.stride()), tuple(C.stride()),
                                      device)
    rows, cols = (B, A) if shape.swap else (A, B)
    with torch.cuda.device(device):
        err = getattr(lib, name)(rows.data_ptr(), cols.data_ptr(),
                                 C.data_ptr(), tables.data_ptr(), shape.Mc,
                                 shape.Nc, shape.K, shape.ncells, flags,
                                 shape.variant, _stream_of(device))
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launch_counts[name] += 1
    return C

# }}}


# {{{ lane_pack_dg_f32

@dataclass(frozen=True)
class LanePackDGRow:
    """One packed DG row's operands as views in role order, each with one
    (flattened) leading axis: ``u`` (NU, E, GJ), ``T`` (M, GI, GJ), ``J``
    (NJ, E, PK) and ``EXP`` (NX, PK, GI); E counts packed rows."""

    u: torch.Tensor
    T: torch.Tensor
    J: torch.Tensor
    EXP: torch.Tensor


@dataclass(frozen=True)
class LanePackDGShape:
    """The index maps of a packed DG program: for each T slice m the u
    slice it contracts (``u_of_m``), for each W slice w the J and EXP
    slices (``j_of_w``, ``exp_of_w``), the terms ``(m, w, o)`` of ``out[o]
    += V[m] · W[w]`` ordered by m, the number of output slices ``n_out``
    and the packed output width ``gi``."""

    u_of_m: tuple
    j_of_w: tuple
    exp_of_w: tuple
    pairs: tuple
    n_out: int
    gi: int


def lane_pack_dg_tile(gi: int) -> tuple:
    """``(packed rows, output lanes)`` of one block's tile of
    ``lane_pack_dg_f32``: 64 x 64, or 128 x 32 when the packed output has
    at most 32 lanes (the kernel's variants; 256 threads, 4 x 4 outputs
    each)."""
    return (128, 32) if gi <= 32 else (64, 64)


def lane_pack_dg_smem_bytes(gi: int, split: bool = False) -> int:
    """Shared memory one block of ``lane_pack_dg_f32`` needs, in bytes: one
    k chunk of the row tile and of the lane tile, each padded by 4 floats
    per k, twice over (hi and lo) at ``bf16_3x`` (the formula of
    ``csrc/lane_pack_dg.cu``).  It does not grow with g·d: the kernel walks
    the contracted lanes in chunks of ``LP_KC``."""
    te, ti = lane_pack_dg_tile(gi)
    return 4 * (2 if split else 1) * LP_KC * ((te + 4) + (ti + 4))


def check_lane_pack_dg_shape(shape: LanePackDGShape, split: bool = False
                             ) -> None:
    """Raise :class:`InvalidParameterError` for a packed DG program
    ``lane_pack_dg_f32`` does not take: more T slices, W slices, output
    slices or terms than its register arrays hold, or a tile over the
    shared memory of a block."""
    for what, n, cap in (("T slices", len(shape.u_of_m), LP_MAX_M),
                         ("W slices", len(shape.j_of_w), LP_MAX_W),
                         ("output slices", shape.n_out, LP_MAX_OUT),
                         ("terms", len(shape.pairs), LP_MAX_TERMS)):
        if n > cap:
            raise InvalidParameterError(
                f"lane_pack_dg_f32 takes at most {cap} {what}, the program"
                f" has {n}")
    smem = lane_pack_dg_smem_bytes(shape.gi, split)
    if smem > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"lane_pack_dg_f32 needs {smem} bytes of shared memory per"
            f" block; a Hopper block has {MAX_SMEM_BYTES}")


def _lp_dims(rows: Sequence[LanePackDGRow], shape: LanePackDGShape
             ) -> tuple:
    """(E, GI, GJ, PK), with every operand and the index maps checked."""
    r0 = rows[0]
    NU, E, GJ = r0.u.shape
    M, GI, _ = r0.T.shape
    NJ, _, PK = r0.J.shape
    NX = r0.EXP.shape[0]
    device = r0.u.device
    nw = len(shape.j_of_w)
    if (len(shape.u_of_m) != M or len(shape.exp_of_w) != nw
            or shape.gi != GI
            or not all(0 <= k < NU for k in shape.u_of_m)
            or not all(0 <= k < NJ for k in shape.j_of_w)
            or not all(0 <= k < NX for k in shape.exp_of_w)
            or not all(0 <= m < M and 0 <= w < nw and 0 <= o < shape.n_out
                       for m, w, o in shape.pairs)
            or list(shape.pairs) != sorted(shape.pairs)):
        raise ValueError(f"index maps {shape} do not match the operands"
                         f" (NU={NU}, M={M}, NJ={NJ}, NX={NX}, GI={GI})")
    for k, row in enumerate(rows):
        _check_operand(f"row {k} u", row.u, device, (NU, E, GJ))
        _check_operand(f"row {k} T", row.T, device, (M, GI, GJ))
        _check_operand(f"row {k} J", row.J, device, (NJ, E, PK))
        _check_operand(f"row {k} EXP", row.EXP, device, (NX, PK, GI))
    return E, GI, GJ, PK


def _lp_plain(rows: Sequence[LanePackDGRow], shape: LanePackDGShape,
              out_order: tuple, contract) -> list:
    outs = []
    for row in rows:
        V = contract("mej,mij->mei", row.u[list(shape.u_of_m)], row.T)
        W = contract("wek,wki->wei", row.J[list(shape.j_of_w)],
                     row.EXP[list(shape.exp_of_w)])
        out = torch.stack([
            sum(V[m] * W[w] for m, w, oo in shape.pairs if oo == o)
            for o in range(shape.n_out)])
        outs.append(out.permute(*out_order).contiguous())
    return outs


def lane_pack_dg_plain(rows: Sequence[LanePackDGRow],
                       shape: LanePackDGShape, out_order: tuple = (0, 1, 2)
                       ) -> list:
    """The plain PyTorch version of ``lane_pack_dg_f32``: per row the three
    steps, ``V = u'·T`` and ``W = J'·EXP`` by ``torch.einsum``, then
    ``out[o] = Σ V[m] W[w]`` over the terms; outputs contiguous in the
    stored order *out_order* (a permutation of the (n_out, E, GI) axes)."""
    return _lp_plain(rows, shape, out_order, torch.einsum)


def lane_pack_dg_3x_plain(rows: Sequence[LanePackDGRow],
                          shape: LanePackDGShape,
                          out_order: tuple = (0, 1, 2)) -> list:
    """The plain PyTorch version of ``lane_pack_dg_3xtf32``:
    ``lane_pack_dg_plain`` with both dots in three passes over the TF32
    split (:func:`einsum_split`); the sum of the terms in f32."""
    return _lp_plain(rows, shape, out_order, einsum_split)


def lane_pack_dg_f32(rows: Sequence[LanePackDGRow], shape: LanePackDGShape,
                     *, block_long: int, out_order: tuple = (0, 1, 2),
                     one_launch: bool = True) -> list:
    """Packed DG rows (K1's lane-pack schedule): each row's ``out[o, e,
    gi]``, allocated contiguous in the stored order *out_order*.  All rows
    go in one launch (up to the kernel's row limit) unless *one_launch* is
    false; a thread block covers *block_long* packed rows (rounded up to
    its tile) of one tile of output lanes."""
    return _lp_launch("lane_pack_dg_f32", rows, shape, block_long,
                      out_order, one_launch)


def lane_pack_dg_3xtf32(rows: Sequence[LanePackDGRow],
                        shape: LanePackDGShape, *, block_long: int,
                        out_order: tuple = (0, 1, 2),
                        one_launch: bool = True) -> list:
    """``lane_pack_dg_f32`` with both dots in three passes over the TF32
    split (``lo·hi + hi·lo + hi·hi``, on the CUDA cores: the products of
    TF32 halves are exact in f32): the ``bf16_3x`` precision; the same
    arguments and outputs."""
    return _lp_launch("lane_pack_dg_3xtf32", rows, shape, block_long,
                      out_order, one_launch)


def _lp_launch(name: str, rows: Sequence[LanePackDGRow],
               shape: LanePackDGShape, block_long: int, out_order: tuple,
               one_launch: bool) -> list:
    """Launch ``lane_pack_dg_f32`` or its 3x variant (*name*; the plain
    version for CPU tensors)."""
    if not rows:
        return []
    E, GI, GJ, PK = _lp_dims(rows, shape)
    device = rows[0].u.device
    split = name == "lane_pack_dg_3xtf32"
    if sorted(out_order) != [0, 1, 2]:
        raise ValueError(f"out_order {out_order} is not a permutation of 3")
    if device.type == "cpu":
        return (lane_pack_dg_3x_plain if split else lane_pack_dg_plain)(
            rows, shape, out_order)
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    check_lane_pack_dg_shape(shape, split)
    if block_long < 1:
        raise InvalidParameterError(
            f"block_long must be positive, got {block_long}")

    from ._build import load_library
    lib = load_library()
    M, NW, NO = len(shape.u_of_m), len(shape.j_of_w), shape.n_out
    dims = (NO, E, GI)
    inverse = tuple(sorted(range(3), key=lambda k: out_order[k]))
    outs = [torch.empty(tuple(dims[k] for k in out_order),
                        dtype=torch.float32, device=device) for _ in rows]
    pairs = (ctypes.c_int * (3 * len(shape.pairs)))(
        *[v for term in shape.pairs for v in term])
    n_off = 2 * M + 2 * NW + NO
    per_launch = lib.lane_pack_dg_max_rows() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            ptrs = (ctypes.c_void_p * (5 * len(idx)))()
            strides = (ctypes.c_int64 * (10 * len(idx)))()
            offsets = (ctypes.c_int64 * (n_off * len(idx)))()
            for n, k in enumerate(idx):
                row, out = rows[k], outs[k].permute(*inverse)
                ptrs[5 * n:5 * n + 5] = [
                    row.u.data_ptr(), row.T.data_ptr(), row.J.data_ptr(),
                    row.EXP.data_ptr(), out.data_ptr()]
                strides[10 * n:10 * n + 10] = [
                    *row.u.stride()[1:], *row.T.stride()[1:],
                    *row.J.stride()[1:], *row.EXP.stride()[1:],
                    *out.stride()[1:]]
                offsets[n_off * n:n_off * (n + 1)] = [
                    *(k_ * row.u.stride(0) for k_ in shape.u_of_m),
                    *(m * row.T.stride(0) for m in range(M)),
                    *(k_ * row.J.stride(0) for k_ in shape.j_of_w),
                    *(k_ * row.EXP.stride(0) for k_ in shape.exp_of_w),
                    *(o * out.stride(0) for o in range(NO))]
            err = getattr(lib, name)(
                len(idx), ptrs, strides, offsets, pairs, M, NW, NO,
                len(shape.pairs), E, GI, GJ, PK, int(block_long),
                _stream_of(device))
            if err:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")
            launch_counts[name] += 1
    return outs

# }}}


# {{{ step_block_f32

_SB_KIND = {"free": 0, "element": 1, "reduce": 2}


def _sb_strides(letters: tuple, strides, el: str) -> tuple:
    """``(stride per short letter, stride of the long axis)`` of a tensor
    whose axes carry *letters*; a letter on several axes (a diagonal) sums
    their strides."""
    per: dict = {}
    es = 0
    for ix, st in zip(letters, strides):
        if ix == el:
            es += int(st)
        else:
            per[ix] = per.get(ix, 0) + int(st)
    return per, es


def _sb_offsets(order: tuple, length: dict, strides: dict) -> np.ndarray:
    """The int64 offsets of the entries over *order* (slowest first, the
    last letter fastest) in a tensor with *strides* per letter."""
    off = np.zeros(1, dtype=np.int64)
    for ix in order:
        idx = np.arange(length[ix], dtype=np.int64) * strides.get(ix, 0)
        off = (off[:, None] + idx[None, :]).ravel()
    return off


def _sb_order(letters, ref: dict) -> tuple:
    """*letters* slowest first: by descending stride in the reference
    tensor *ref*, the letters it lacks first, ties in the given order."""
    return tuple(sorted(letters, key=lambda ix: -ref.get(ix, np.inf)))


def _sb_reference(table, k: int, in_strides: tuple, out_st: tuple) -> dict:
    """Strides per letter of step *k*'s reference tensor, which orders its
    entries: the row's output for the last step, else the step's streamed
    input with the most entries ({} when it reads none)."""
    if k == len(table.steps) - 1:
        return out_st[0]
    step = table.steps[k]
    best, best_n = {}, 0
    for (kind, x), letters in zip(step.operands, step.letters):
        if kind != "in" or table.el not in table.inputs[x]:
            continue
        n = int(np.prod([table.length[ix] for ix in set(letters)
                         if ix != table.el], dtype=np.int64))
        if n > best_n:
            best = _sb_strides(letters, in_strides[x], table.el)[0]
            best_n = n
    return best


def step_block_mode(table, in_strides: tuple, out_strides: tuple) -> bool:
    """Whether ``step_block_f32``'s threads take consecutive elements
    (element-fastest) rather than consecutive output entries: so when the
    tensor that dominates the traffic, the row's output (its input with the
    most entries for a contracted long axis), has the long axis at stride
    1 (dof-major storage)."""
    last = table.steps[-1]
    if last.kind != "reduce":
        _, es = _sb_strides(last.out, out_strides, table.el)
        return es == 1
    streamed = [(int(np.prod([table.length[ix] for ix in letters
                              if ix != table.el], dtype=np.int64)), s)
                for s, letters in enumerate(table.inputs)
                if table.el in letters]
    _, slot = max(streamed, key=lambda ns: (ns[0], -ns[1]))
    return _sb_strides(table.inputs[slot], in_strides[slot], table.el)[1] == 1


def _sb_sub_tile(letters: tuple, strides, el: str, length: dict,
                 te: int) -> tuple:
    """How a tensor over *letters* with these strides is held per sub-tile
    in shared memory: ``(strides per letter there, compact order, entries,
    pitch, element-fastest)``: its entries in the order of its own strides,
    [entry][element] with an odd pitch of at least *te* when it stores the
    long axis at stride 1, else [element][entry] with an odd pitch of at
    least its entries."""
    per, es = _sb_strides(letters, strides, el)
    order = _sb_order(per, per)
    n = int(np.prod([length[ix] for ix in order], dtype=np.int64))
    efast = es == 1
    pitch = (te | 1) if efast else (n | 1)
    compact, stride = {}, 1
    for ix in reversed(order):
        compact[ix] = stride * (pitch if efast else 1)
        stride *= length[ix]
    return compact, order, n, pitch, efast


def _sb_entries(order: tuple, length: dict, per: dict) -> tuple:
    """``(affine, offsets)`` of the entries over *order* in a tensor with
    strides *per*: their stride when they are evenly spaced, else their
    offsets."""
    off = _sb_offsets(order, length, per)
    step = int(off[1] - off[0]) if len(off) > 1 else 0
    if np.array_equal(off, np.arange(len(off), dtype=np.int64) * step):
        return True, step
    return False, off


@functools.lru_cache(maxsize=64)
def step_block_tables(table, in_strides: tuple, out_strides: tuple,
                      elem_fastest: bool) -> tuple:
    """``(tables, steps_i, steps_t, stage_i, stage_t)`` of
    ``step_block_f32`` for one row whose input views and output view have
    these strides (elements per axis, in the order of ``table.inputs`` and
    of the last step's ``out``).

    ``tables`` (int64) holds the offset tables.  A general step has each
    operand's offsets of the step's output entries, the result's, then each
    operand's offsets of the contracted entries (none when it contracts at
    most one letter, "affine": its offsets are c times the letter's
    stride); its entries run with its tile letter slowest, so that entry
    ``o + r * n_out / RT`` is a thread's r-th, and the operand that carries
    the tile letter goes last.  A dense step has A's offsets over M, K and
    B, B's over N, K and B (K's as strides when it is at most one letter,
    affine), and the result's over M, N and B (over the reduce step's
    partial sums for a contracted long axis, whose result-entry table maps
    them to the output).  A staged input's offsets
    are those of its copy in shared memory (:func:`_sb_staged`), whose
    table gives each entry's offset in the input.

    ``steps_i`` gives per step (kind, operands, output entries, contracted
    entries, the four operand sources, the result's float offset in shared
    memory, its element stride there, the groups of a reduce step, affine,
    mode (1: dense), RT, entries per tile row, RM, RN, M, N, K and B
    entries, M and N tiles, the int offset of a dense step's tables in
    shared memory, where the kernel stages them), ``steps_t`` the table
    offsets (the general
    operands' and result's entry tables, their contracted tables or
    strides, then the dense tables A_m, A_k, A_b, B_n, B_k, B_b, D_m, D_n,
    D_b).  ``stage_i`` per input, then for the output's sub-tile (resident
    offset and floats, staged buffer offset and floats, entries, pitch,
    element-fastest, evenly spaced entries) and ``stage_t`` its entries'
    table offset, or their stride when evenly spaced.  A result held in shared memory
    is laid out [entry][element] (element-fastest threads) or
    [element][entry], at an odd pitch; a step's entries and contracted
    entries run in the order of its reference tensor's strides
    (:func:`_sb_reference`), the smallest stride fastest."""
    el, length = table.el, table.length
    te = table.te
    last = len(table.steps) - 1
    out_st = _sb_strides(table.steps[last].out, out_strides, el)
    layout: dict = {}        # step -> (strides per letter, element stride)
    chunks, steps_i, steps_t = [], [], []
    cursor = 0

    def add(arr) -> int:
        nonlocal cursor
        arr = np.asarray(arr, dtype=np.int64)
        chunks.append(arr)
        cursor += len(arr)
        return cursor - len(arr)

    def entries(order, per):
        affine, off = _sb_entries(order, length, per)
        return int(affine), off if affine else add(off)

    axis_strides, stage_i, stage_t = [], [], []
    for slot, letters in enumerate(table.inputs):
        n_res = (0 if table.stage[slot] < 0 else int(np.prod(
            [length[ix] for ix in letters], dtype=np.int64)))
        if not table.sin or table.sin[slot] < 0:
            axis_strides.append(in_strides[slot])
            stage_i.append([table.stage[slot], n_res, -1, 0, 0, 0, 0, 0])
            stage_t.append(0)
            continue
        compact, order, n, pitch, efast = _sb_sub_tile(
            letters, in_strides[slot], el, length, te)
        axis_strides.append(tuple((1 if efast else pitch) if ix == el
                                  else compact[ix] for ix in letters))
        gaff, goff = entries(order, _sb_strides(letters, in_strides[slot],
                                                el)[0])
        stage_i.append([table.stage[slot], n_res, table.sin[slot],
                        table.sin_floats[slot], n, pitch, int(efast), gaff])
        stage_t.append(goff)
    if table.sout >= 0:
        compact, order, n, pitch, efast = _sb_sub_tile(
            table.steps[last].out, out_strides, el, length, te)
        out_sub = compact
        gaff, goff = entries(order, out_st[0])
        stage_i.append([-1, 0, table.sout, table.sout_floats, n, pitch,
                        int(efast), gaff])
        stage_t.append(goff)
    else:
        stage_i.append([-1, 0, -1, 0, 0, 0, 0, 0])
        stage_t.append(0)

    for k, step in enumerate(table.steps):
        ref = _sb_reference(table, k, in_strides, out_st)
        out_order = _sb_order([ix for ix in step.out if ix != el], ref)
        if step.tile_letter is not None:
            out_order = (step.tile_letter,) + tuple(
                ix for ix in out_order if ix != step.tile_letter)
        sum_order = _sb_order(table.summed(step), ref)
        n_out = table.n_out(step)
        op_strides = []
        for (kind, x), letters in zip(step.operands, step.letters):
            if kind == "in":
                src_strides = axis_strides[x]
            else:
                prod_per, _ = layout[x]
                src_strides = [prod_per.get(ix, 0) if ix != el else 0
                               for ix in table.steps[x].out]
            op_strides.append(_sb_strides(letters, src_strides, el)[0])
        compact, stride = {}, 1
        for ix in reversed(out_order):
            compact[ix] = stride
            stride *= length[ix]
        if k == last and table.sout >= 0:
            dst_per, es = out_sub, 0
        elif k == last:
            dst_per, es = out_st[0], 0
        elif step.kind == "element":
            pitch = (te | 1) if elem_fastest else (n_out | 1)
            dst_per = {ix: c * (pitch if elem_fastest else 1)
                       for ix, c in compact.items()}
            es = 1 if elem_fastest else pitch
            layout[k] = (dst_per, es)
        else:
            dst_per, es = compact, 0
            layout[k] = (dst_per, es)
        nops = len(step.operands)
        order = list(range(nops))
        if step.tile_letter is not None:
            (carrier,) = [q for q in order
                          if step.tile_letter in step.letters[q]]
            order = [q for q in order if q != carrier] + [carrier]
        rt = step.tile[0] if step.mode == "general" else 1
        dense = [0] * 9
        dims = [0] * 8
        if step.mode == "dense":
            M, N, K, B = step.split
            res = compact if step.kind == "reduce" else dst_per
            M = _sb_order(M, res)
            N = _sb_order(N, res)
            sa, sb = op_strides
            affine = len(K) <= 1
            within = [_sb_offsets(g, length, st) for g, st in (
                (M, sa), (K, sa), (B, sa), (N, sb), (K, sb), (B, sb))] + [
                _sb_offsets(g, length, res) for g in (M, N, B)]
            if max(int(np.abs(w).max()) for w in within) >= 2 ** 31:
                raise InvalidParameterError(
                    "step_block_f32: a dense step's offsets within an"
                    " element exceed 32 bits")
            dense = [add(w) for w in within]
            if affine:
                dense[1] = sa.get(K[0], 0) if K else 0
                dense[4] = sb.get(K[0], 0) if K else 0
            rm, rn = step.tile
            nm, nn = (int(np.prod([length[ix] for ix in g], dtype=np.int64))
                      for g in (M, N))
            dims = [rm, rn, nm, nn,
                    int(np.prod([length[ix] for ix in K], dtype=np.int64)),
                    int(np.prod([length[ix] for ix in B], dtype=np.int64)),
                    -(-nm // rm), -(-nn // rn)]
            t_out = [0] * nops + [add(_sb_offsets(
                out_order, length, out_st[0] if k == last else dst_per))]
            t_sum = [0] * nops
        else:
            t_out = [add(_sb_offsets(out_order, length, op_strides[q]))
                     for q in order]
            t_out.append(add(_sb_offsets(out_order, length, dst_per)))
            affine = len(sum_order) <= 1
            if affine:
                t_sum = [op_strides[q].get(sum_order[0], 0) if sum_order
                         else 0 for q in order]
            else:
                t_sum = [add(_sb_offsets(sum_order, length, op_strides[q]))
                         for q in order]
        if step.kind == "reduce" and step.mode == "dense":
            groups = max(1, SB_THREADS // (dims[6] * dims[7]))
        elif step.kind == "reduce":
            groups = max(1, (SB_THREADS // 32 if elem_fastest else SB_THREADS)
                         // n_out)
        else:
            groups = 1
        src = [step.operands[q][1] if step.operands[q][0] == "in"
               else -1 - step.operands[q][1] for q in order]
        steps_i.append([_SB_KIND[step.kind], nops, n_out, table.n_sum(step),
                        *(src + [0] * (SB_MAX_OPS - nops)), step.dst, es,
                        groups, int(affine), int(step.mode == "dense"), rt,
                        n_out // rt, *dims, step.dsm])
        steps_t.append([*t_out, *([0] * (SB_MAX_OPS - nops)),
                        *t_sum, *([0] * (SB_MAX_OPS - nops)), *dense])
    tables = np.concatenate(chunks) if chunks else np.zeros(1, np.int64)
    return tables, steps_i, steps_t, stage_i, stage_t


def _sb_view_strides(rows, outs) -> tuple:
    return tuple((tuple(tuple(t.stride()) for t in row), tuple(out.stride()))
                 for row, out in zip(rows, outs))


@functools.lru_cache(maxsize=32)
def _sb_device_tables(table, row_strides: tuple, elem_fastest: bool,
                      device: torch.device) -> tuple:
    """The rows' tables end to end on *device*, and ``(steps_i, steps_t,
    stage_i, stage_t, row_len)`` (equal across rows: the tables' offsets
    depend on the shapes alone)."""
    per_row = [step_block_tables(table, ins, out, elem_fastest)
               for ins, out in row_strides]
    tables = np.concatenate([t[0] for t in per_row])
    _, steps_i, steps_t, stage_i, stage_t = per_row[0]
    return (torch.from_numpy(tables).to(device), steps_i, steps_t, stage_i,
            stage_t, len(per_row[0][0]))


def _sb_check(rows, table) -> int:
    """The grid letter's length (1 without a grid: the whole program is one
    block of one element), with every operand checked against the table's
    letters and lengths."""
    el, length = table.el, table.length
    for k, row in enumerate(rows):
        if len(row) != len(table.inputs):
            raise ValueError(f"row {k} has {len(row)} operands, the table"
                             f" {len(table.inputs)}")
    device = rows[0][0].device
    s0 = next((s for s, letters in enumerate(table.inputs) if el in letters),
              None)
    E = 1 if s0 is None else rows[0][s0].shape[table.inputs[s0].index(el)]
    for k, row in enumerate(rows):
        for s, (t, letters) in enumerate(zip(row, table.inputs)):
            _check_operand(f"row {k} operand {s}", t, device,
                           tuple(E if ix == el else length[ix]
                                 for ix in letters))
    return E


def _sb_block_partials(vals: list, subs: list, out: tuple, el: str, E: int,
                       block_long: int) -> torch.Tensor:
    """A step that contracts the long axis as the kernel computes it: the
    axis zero-padded to whole blocks of *block_long* (the tail mask), one
    partial per block, then the partials summed in block order."""
    nb = -(-E // block_long)
    pad = nb * block_long - E
    used = set("".join(subs)) | set(out)
    blk = next(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
               if c not in used)
    ops, new_subs = [], []
    for t, s in zip(vals, subs):
        if el not in s:
            ops.append(t)
            new_subs.append(s)
            continue
        pos = s.index(el)
        if pad:
            shape = list(t.shape)
            shape[pos] = pad
            t = torch.cat([t, t.new_zeros(shape)], dim=pos)
        ops.append(t.reshape(*t.shape[:pos], nb, block_long,
                             *t.shape[pos + 1:]))
        new_subs.append(s[:pos] + blk + s[pos:])
    partials = torch.einsum(",".join(new_subs) + "->" + blk + "".join(out),
                            *ops)
    return partials.sum(0)


def step_block_plain(rows, table, block_long: int) -> list:
    """The plain PyTorch version of ``step_block_f32``: per row the same
    step table, one ``torch.einsum`` per step over the whole long axis; a
    step that contracts the long axis sums per-block partials (the tail
    zero-padded) in block order; outputs contiguous in the stored order."""
    E = _sb_check(rows, table)
    last = len(table.steps) - 1
    outs = []
    for ops in rows:
        env: dict = {}
        for k, step in enumerate(table.steps):
            vals = [ops[x] if kind == "in" else env[x]
                    for kind, x in step.operands]
            subs = ["".join(letters) for letters in step.letters]
            out = table.stored_out if k == last else step.out
            if step.kind == "reduce":
                env[k] = _sb_block_partials(vals, subs, out, table.el, E,
                                            int(block_long))
            else:
                env[k] = torch.einsum(",".join(subs) + "->" + "".join(out),
                                      *vals)
        outs.append(env[last].contiguous())
    return outs


def _is_flat(t: torch.Tensor) -> bool:
    """Whether *t* fills its storage span exactly (a permutation of a
    contiguous tensor without broadcast axes): the kernel stages a resident
    by a flat copy of that span."""
    return 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride())) \
        == t.numel()


def step_block_f32(rows, table, *, block_long: int,
                   one_launch: bool = True) -> list:
    """Each row's output of the step table *table*
    (:class:`~feinsum_tpu_torch.ops.step_block.StepTable`) from its input
    views (one per slot, axes in the order of ``table.inputs``), allocated
    contiguous in the stored order ``table.stored_out``.  All rows go in
    one launch (two for a contracted long axis; up to the kernel's row
    limit) unless *one_launch* is false; *block_long* elements per thread
    block."""
    if not rows:
        return []
    E = _sb_check(rows, table)
    device = rows[0][0].device
    if device.type == "cpu":
        return step_block_plain(rows, table, block_long)
    if device.type != "cuda":
        raise ValueError(f"step_block_f32: no kernel for device {device}")
    if block_long < 1:
        raise InvalidParameterError(
            f"block_long must be positive, got {block_long}")
    if table.smem_bytes > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"step_block_f32 needs {table.smem_bytes} bytes of shared memory"
            f" per block; an H100 block has {MAX_SMEM_BYTES}")

    from ._build import load_library
    lib = load_library()
    el, length = table.el, table.length
    last = table.steps[-1]
    out_shape = tuple(E if ix == el else length[ix] for ix in table.stored_out)
    perm = [table.stored_out.index(ix) for ix in last.out]
    outs = [torch.empty(out_shape, dtype=torch.float32, device=device)
            for _ in rows]
    views = [o.permute(tuple(perm)) for o in outs]
    rows = [[t if table.stage[s] < 0 or _is_flat(t) else t.contiguous()
             for s, t in enumerate(row)] for row in rows]
    elem_fastest = step_block_mode(
        table, tuple(tuple(t.stride()) for t in rows[0]),
        tuple(views[0].stride()))
    ni, ns = len(table.inputs), len(table.steps)
    nblocks = -(-E // int(block_long))
    per_launch = lib.step_block_f32_max_rows() if one_launch else 1
    with torch.cuda.device(device):
        for idx in _chunks(range(len(rows)), per_launch):
            tables, steps_i, steps_t, stage_i, stage_t, row_len = \
                _sb_device_tables(
                table, _sb_view_strides([rows[k] for k in idx],
                                        [views[k] for k in idx]),
                elem_fastest, device)
            ptrs = (ctypes.c_void_p * ((ni + 1) * len(idx)))()
            es = (ctypes.c_int64 * ((ni + 1) * len(idx)))()
            for n, k in enumerate(idx):
                ptrs[(ni + 1) * n:(ni + 1) * (n + 1)] = [
                    *(t.data_ptr() for t in rows[k]), views[k].data_ptr()]
                es[(ni + 1) * n:(ni + 1) * (n + 1)] = [
                    *(_sb_strides(letters, t.stride(), el)[1]
                      for letters, t in zip(table.inputs, rows[k])),
                    _sb_strides(last.out, views[k].stride(), el)[1]]
            work = None
            if last.kind == "reduce":
                work = torch.empty(len(idx) * nblocks * table.n_out(last),
                                   dtype=torch.float32, device=device)
            err = lib.step_block_f32(
                len(idx), ni, ptrs, es, ns,
                (ctypes.c_int * (SB_STEP_INTS * ns))(
                    *[v for s in steps_i for v in s]),
                (ctypes.c_int64 * (SB_STEP_TABLES * ns))(
                    *[v for s in steps_t for v in s]),
                (ctypes.c_int * (SB_STAGE_INTS * (ni + 1)))(
                    *[v for s in stage_i for v in s]),
                (ctypes.c_int64 * (ni + 1))(*stage_t),
                ctypes.c_void_p(tables.data_ptr()), row_len,
                table.te, int(elem_fastest), E, int(block_long),
                table.smem_floats,
                ctypes.c_void_p(None if work is None else work.data_ptr()),
                _stream_of(device))
            if err:
                raise RuntimeError(f"step_block_f32 launch failed: CUDA error"
                                   f" {err}")
            launch_counts["step_block_f32"] += 1
    return outs

# }}}


# {{{ tc_steps_f32

def _ts_check(ops, table) -> torch.device:
    """The device of *ops*, each checked against the table's logical letters
    and lengths."""
    if len(ops) != len(table.inputs):
        raise ValueError(f"{len(ops)} operands, the table has"
                         f" {len(table.inputs)}")
    device = ops[0].device
    length = table.length
    for k, (t, letters) in enumerate(zip(ops, table.inputs)):
        _check_operand(f"operand {k}", t, device,
                       tuple(length[ix] for ix in letters))
    return device


def tc_steps_plain(ops, table) -> torch.Tensor:
    """The plain PyTorch version of ``tc_steps_f32``: the table's steps as
    full-fp32 ``torch.einsum`` calls over the operands' views (their logical
    letters are their axes), the last step into the output's stored letter
    order, the result contiguous."""
    from ..codegen.program import check_full_fp32_matmul
    check_full_fp32_matmul()
    _ts_check(ops, table)
    env: list = []
    last = len(table.steps) - 1
    for k, step in enumerate(table.steps):
        vals = [ops[x] if kind == "in" else env[x]
                for kind, x in step.operands]
        out = table.stored_out if k == last else step.out
        env.append(torch.einsum(
            ",".join("".join(s) for s in step.letters) + "->"
            + "".join(out), *vals))
    return env[last].contiguous()


@functools.lru_cache(maxsize=32)
def _ts_device_tables(table, in_strides: tuple, out_strides: tuple,
                      device: torch.device) -> tuple:
    from .tc_steps import tc_steps_tables
    tables, steps_i, steps_t, grid = tc_steps_tables(table, in_strides,
                                                     out_strides)
    return torch.from_numpy(tables).to(device), steps_i, steps_t, grid


def tc_steps_f32(ops, table) -> torch.Tensor:
    """The output of the cell table *table*
    (:class:`~feinsum_tpu_torch.ops.tc_steps.TCStepsTable`) for one row
    from its operands (one per einsum position, axes in the logical order
    ``table.inputs``; views of the stored tensors), allocated contiguous in
    the stored order ``table.stored_out``: one launch, one thread block per
    cell."""
    device = _ts_check(ops, table)
    if device.type == "cpu":
        return tc_steps_plain(ops, table)
    if device.type != "cuda":
        raise ValueError(f"tc_steps_f32: no kernel for device {device}")
    if table.smem_bytes > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"tc_steps_f32 needs {table.smem_bytes} bytes of shared memory"
            f" per block; an H100 block has {MAX_SMEM_BYTES}")

    from ._build import load_library
    lib = load_library()
    length = table.length
    out = torch.empty(tuple(length[ix] for ix in table.stored_out),
                      dtype=torch.float32, device=device)
    view = out.permute(tuple(table.stored_out.index(ix) for ix in table.out))
    tables, steps_i, steps_t, grid = _ts_device_tables(
        table, tuple(tuple(t.stride()) for t in ops), tuple(view.stride()),
        device)
    ns = len(table.steps)
    with torch.cuda.device(device):
        err = lib.tc_steps_f32(
            len(ops), (ctypes.c_void_p * len(ops))(*[t.data_ptr()
                                                    for t in ops]),
            view.data_ptr(), ns,
            (ctypes.c_int * (ns * (5 + TS_MAX_OPS)))(
                *[v for s in steps_i for v in s]),
            (ctypes.c_int * (ns * (2 * TS_MAX_OPS + 1)))(
                *[v for s in steps_t for v in s]),
            len(grid), (ctypes.c_int64 * sum(map(len, grid)))(
                *[v for g in grid for v in g]),
            ctypes.c_void_p(tables.data_ptr()), table.ncells, table.threads,
            table.smem_floats, _stream_of(device))
    if err:
        raise RuntimeError(f"tc_steps_f32 launch failed: CUDA error {err}")
    launch_counts["tc_steps_f32"] += 1
    return out

# }}}
