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

The third replaces ``feinsum_tpu/ops/dd_emitter.py::build_dd_executable``
(K4), the same DG rows in float64 on (2, ...) float32 hi/lo pair storage:

* ``dd_rows`` (``csrc/dd_rows.cu``) — loads each pair as a float64 and
  computes the row in native FP64 on the card (the TPU has no FP64 units and
  used pair arithmetic); the source's header says what bounds it.

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

import torch

from ..diagnostics import InvalidParameterError

# shared memory a Hopper thread block can use (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232_448
# register-array bounds of csrc/dg_rows.cu and csrc/dd_rows.cu (kMaxX, kMaxS)
MAX_X = MAX_S = 4
# threads per block of csrc/dd_rows.cu (kThreads)
DD_THREADS = 128

launch_counts = {"dg_rows_f32": 0, "ew_product_f32": 0, "dd_rows": 0}


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


def ew_product_f32(rows: Sequence[Sequence[torch.Tensor]], *,
                   one_launch: bool = True) -> list:
    """Elementwise product of each row's same-shape contiguous operands; all
    rows in one launch (up to the kernel's row limit) unless *one_launch*
    is false."""
    if not rows:
        return []
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
                                     _stream_of(device))
            if err:
                raise RuntimeError(f"ew_product_f32 launch failed: CUDA"
                                   f" error {err}")
            launch_counts["ew_product_f32"] += 1
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
