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
# the most j values csrc/row_reduce.cu takes (kMaxJ: w in shared memory)
MAX_REDUCE_J = 8192

launch_counts = {"dg_rows_f32": 0, "ew_product_f32": 0, "ew_flat_f32": 0,
                 "row_reduce_f32": 0, "dd_rows": 0, "tc_grid_f32": 0}


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


def dg_rows_plain(rows: Sequence[DGRow], out_order: tuple = (0, 1, 2)
                  ) -> list:
    """The plain PyTorch version of ``dg_rows_f32``: per row,
    ``t = R @ u`` over j, then ``Σ_s F t``; outputs contiguous in the
    stored order *out_order* (a permutation of the (X, I, E) axes)."""
    outs = []
    for row in rows:
        t = torch.matmul(row.R, row.u)                      # (S, I, E)
        if row.F is None:
            val = t.sum(0, keepdim=True)                    # (1, I, E)
        else:
            val = torch.einsum("xse,sie->xie", row.F, t)
        outs.append(val.permute(*out_order).contiguous())
    return outs


def dg_rows_f32(rows: Sequence[DGRow], *, block_long: int,
                out_order: tuple = (0, 1, 2),
                one_launch: bool = True) -> list:
    """Fused DG rows: each row's ``out[x, i, e]``, allocated contiguous in
    the stored order *out_order* (a permutation of the (X, I, E) axes).
    All rows go in one launch (up to the kernel's row limit per launch)
    unless *one_launch* is false; *block_long* elements per thread block."""
    if not rows:
        return []
    X, S, I, J, E, u_has_s, has_f = _dg_dims(rows)
    device = rows[0].u.device
    if sorted(out_order) != [0, 1, 2]:
        raise ValueError(f"out_order {out_order} is not a permutation of 3")
    if device.type == "cpu":
        return dg_rows_plain(rows, out_order)
    if device.type != "cuda":
        raise ValueError(f"dg_rows_f32: no kernel for device {device}")

    from ._build import load_library
    lib = load_library()
    smem = lib.dg_rows_f32_smem_bytes(S, I, J, int(u_has_s))
    if smem > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"dg_rows_f32 needs {smem} bytes of shared memory per block;"
            f" an H100 block has {MAX_SMEM_BYTES}")
    dims = (X, I, E)
    inverse = tuple(sorted(range(3), key=lambda k: out_order[k]))
    outs = [torch.empty(tuple(dims[k] for k in out_order),
                        dtype=torch.float32, device=device) for _ in rows]
    per_launch = lib.dg_rows_f32_max_rows() if one_launch else 1
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
            err = lib.dg_rows_f32(len(idx), ptrs, strides, X, S, I, J, E,
                                  int(u_has_s), int(block_long),
                                  _stream_of(device))
            if err:
                raise RuntimeError(f"dg_rows_f32 launch failed: CUDA error"
                                   f" {err}")
            launch_counts["dg_rows_f32"] += 1
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


def tc_grid_f32(A: torch.Tensor, B: torch.Tensor, step: TCStep
                ) -> torch.Tensor:
    """``C[c] = Σ A[a] B[b]`` for one :class:`TCStep`, ``C`` allocated
    contiguous in the output's stored letter order ``step.c``."""
    lengths = dict(step.lengths)
    device = A.device
    _check_operand("A", A, device, tuple(lengths[l] for l in step.a))
    _check_operand("B", B, device, tuple(lengths[l] for l in step.b))
    shape = tc_classify(step)
    if device.type == "cpu":
        return tc_grid_plain(A, B, step)
    if device.type != "cuda":
        raise ValueError(f"tc_grid_f32: no kernel for device {device}")

    from ._build import load_library
    lib = load_library()
    C = torch.empty(tuple(lengths[l] for l in step.c), dtype=torch.float32,
                    device=device)
    tables, flags = _tc_device_tables(step, tuple(A.stride()),
                                      tuple(B.stride()), tuple(C.stride()),
                                      device)
    rows, cols = (B, A) if shape.swap else (A, B)
    with torch.cuda.device(device):
        err = lib.tc_grid_f32(rows.data_ptr(), cols.data_ptr(),
                              C.data_ptr(), tables.data_ptr(), shape.Mc,
                              shape.Nc, shape.K, shape.ncells, flags,
                              shape.variant, _stream_of(device))
    if err:
        raise RuntimeError(f"tc_grid_f32 launch failed: CUDA error {err}")
    launch_counts["tc_grid_f32"] += 1
    return C

# }}}
