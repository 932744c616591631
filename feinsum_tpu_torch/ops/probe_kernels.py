"""
The probe kernels, their plain PyTorch versions and their plans.

They replace the hand-written Pallas kernels of the TPU probes under
``scripts/`` (``tpu_layout_probe.py``, ``tpu_fold_probe*.py``,
``tpu_kron_probe.py``, ``tpu_lane_reshape_probe.py``: 28 ``pallas_call``
sites), which measured how a v5e streams and contracts DG-shaped data in one
layout or another.  :mod:`feinsum_tpu_torch.probes` asks the same questions
of the card through them.

* ``probe_stream_f32`` (``csrc/probe_stream.cu``) — ``out = alpha * a (*
  b)`` over a strided logical shape; stride 0 broadcasts.  It covers every
  copy layout, the lane-reshape probe's kernels A and B, and the transposing
  copy ``(E, 35) -> (35, E)`` (through a shared-memory tile).  Bound by
  bytes.  :func:`plan_stream` merges axes and picks the kernel's path.
* ``probe_apply_f32`` (``csrc/probe_apply.cu``) — for b <= 3 rows in one
  launch, ``out_b[i, e] = sigma(i, e) * Σ_s J_b[s, e] * Σ_j R[s, i, j] *
  u_b[j, e]`` over strided (row, element) views of u, J, sigma and out: the
  matvec in every storage, the kron matvec (``R = kron(D, I_8)``, ``sigma =
  jac``), the div (S = 3) and lane-reshape C and D (``R = K^T``).  R and u
  are tiled through shared memory, so R may be 2048 x 2048.  Each launch
  first runs a pre-pass that finds, per (s, row tile), the chunks of j
  holding R's nonzeros (:func:`probe_apply_ranges_plain`); the kernel
  multiplies only those, so a block-diagonal R costs its band.
* ``probe_apply_3xtf32`` — the same with the dot in three TF32
  tensor-core passes over the hi/lo split (the port's ``bf16_3x``,
  :func:`~feinsum_tpu_torch.ops.kernels.einsum_3x` in its plain version);
  its pre-pass also splits R once, into the planes
  :func:`~feinsum_tpu_torch.ops.kernels.tf32_split` gives.

Their wrappers run in the port's one launch frame,
:func:`~feinsum_tpu_torch.ops.kernels.launch_frame`.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..diagnostics import InvalidParameterError
from .kernels import einsum_3x, launch_frame, tf32_split

# csrc/probe_stream.cu: the most operands (kMaxOps), axes and elements of a
# stream
PS_MAX_OPS = 2
PS_MAX_AXES = 3
PS_MAX_ELEMENTS = 2 ** 31 - 1
# csrc/probe_apply.cu: rows per launch (kMaxRows), the most s (kMaxS), the
# most rows and j's of R (kMaxDim), j's per chunk (kKC), the default
# elements per block where no tile is given, and the flags
PA_MAX_ROWS = 3
PA_MAX_S = 3
PA_MAX_DIM = 2048
PA_KC = 16
PA_TE = 128
PA_PRE_COLS = 32   # the pre-pass's j's per block (kPreCols)
_U_VEC, _U_K_FAST, _OUT_ELEM_MAJOR, _OUT_VEC, _HAS_J, _HAS_SIGMA = (
    1, 2, 4, 8, 16, 32)

_STREAM_MODES = {"scalar": 0, "flat4": 1, "tile": 2}


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


# {{{ probe_stream_f32

@dataclass(frozen=True)
class StreamPlan:
    """How ``probe_stream_f32`` runs a stream: its path (``"flat4"``,
    ``"tile"`` or ``"scalar"``), the three kernel axes' extents, the
    output's and each operand's strides over them, the operands read as
    float4 (flat4) or staged in the shared tile (tile), as a bit mask, and
    the floats per thread block (0: one float4 or float per thread)."""

    mode: str
    shape: tuple
    out_strides: tuple
    in_strides: tuple
    mask: int
    per_block: int


def plan_stream(shape: Sequence[int], in_strides: Sequence[Sequence[int]],
                out_strides: Sequence[int], *, block_elems: int = 0,
                aligned: Optional[Sequence[bool]] = None) -> StreamPlan:
    """The plan of a stream over the logical *shape* from the operands' and
    the (contiguous) output's strides.  Axes of extent 1 are dropped and
    neighbours that every tensor walks contiguously are merged; at most
    three may remain.  An operand whose stride-1 axis is not the output's
    (the last) goes through the shared tile, that axis moved to the middle;
    else, where the flat length is a multiple of 4 and the output is
    16-byte aligned (*aligned*: the output's, then each operand's; all by
    default), ``flat4``, the operands laid out as the output is (and
    aligned) read as float4; else ``scalar``."""
    strides = [tuple(out_strides)] + [tuple(s) for s in in_strides]
    axes = []
    for a, n in enumerate(shape):
        if n == 1:
            continue
        st = [s[a] for s in strides]
        if axes and all(s0 == s * n for s0, s in zip(axes[-1][1], st)):
            axes[-1] = (axes[-1][0] * n, st)
        else:
            axes.append((n, st))
    if len(axes) > PS_MAX_AXES:
        raise InvalidParameterError(
            f"probe_stream_f32: the shape {tuple(shape)} with these strides"
            f" walks {len(axes)} axes; the kernel takes {PS_MAX_AXES}")
    if not axes:
        axes = [(1, [1] * len(strides))]
    aligned = list(aligned) if aligned is not None else [True] * len(strides)
    last = len(axes) - 1
    nops = len(strides) - 1
    tile = None
    for o in range(nops):
        own = [a for a, (_, s) in enumerate(axes) if s[o + 1] == 1]
        if axes[last][1][o + 1] not in (0, 1) and own:
            tile = own[0]
            break
    if tile is not None:
        order = [a for a in range(len(axes)) if a not in (tile, last)] + [
            tile, last]
        mask = sum(1 << o for o in range(nops)
                   if axes[tile][1][o + 1] == 1
                   and axes[last][1][o + 1] not in (0, 1))
        mode = "tile"
    else:
        order = list(range(len(axes)))
        total = int(np.prod([n for n, _ in axes]))
        flat = total % 4 == 0 and block_elems % 4 == 0 and aligned[0]
        mask = sum(1 << o for o in range(nops) if flat and aligned[o + 1]
                   and all(st[o + 1] == st[0] for _, st in axes))
        mode = "flat4" if flat else "scalar"
    picked = [axes[a] for a in order]
    picked = [(1, [0] * len(strides))] * (PS_MAX_AXES - len(picked)) + picked
    return StreamPlan(
        mode=mode, shape=tuple(n for n, _ in picked),
        out_strides=tuple(st[0] for _, st in picked),
        in_strides=tuple(tuple(st[o] for _, st in picked)
                         for o in range(1, len(strides))),
        mask=mask, per_block=0 if mode == "tile" else block_elems)


def _stream_check(ops: Sequence[torch.Tensor]) -> tuple:
    """``(shape, device)`` of a stream's operands, checked."""
    if not 1 <= len(ops) <= PS_MAX_OPS:
        raise InvalidParameterError(
            f"probe_stream_f32 takes 1 or {PS_MAX_OPS} operands, got"
            f" {len(ops)}")
    shape, device = tuple(ops[0].shape), ops[0].device
    for k, t in enumerate(ops):
        if t.dtype != torch.float32:
            raise InvalidParameterError(
                f"probe_stream_f32: operand {k} is {t.dtype}; it takes"
                " float32")
        if t.device != device:
            raise ValueError(f"operand {k} lies on {t.device}, operand 0 on"
                             f" {device}")
        if tuple(t.shape) != shape:
            raise ValueError(
                f"probe_stream_f32: mismatched storages: operand {k} has"
                f" the logical shape {tuple(t.shape)}, operand 0 {shape}"
                " (broadcast with expand)")
    return shape, device


def probe_stream_plain(ops: Sequence[torch.Tensor], *,
                       alpha: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version of ``probe_stream_f32``: ``alpha * a (*
    b)`` on the views, contiguous in the logical shape."""
    _stream_check(ops)
    out = alpha * ops[0]
    for t in ops[1:]:
        out = out * t
    return out.contiguous()


def probe_stream_f32(ops: Sequence[torch.Tensor], *, alpha: float = 1.0,
                     block_elems: int = 0) -> torch.Tensor:
    """``alpha * ops[0] (* ops[1])`` over the operands' common logical
    shape (views, stride 0 to broadcast), into a new contiguous tensor of
    that shape: one launch (:func:`plan_stream`).  *block_elems* floats per
    thread block (0: one float4 or float per thread; the tile path takes a
    tile of up to 64 x 64 per block)."""
    shape, device = _stream_check(ops)
    if block_elems < 0:
        raise InvalidParameterError(f"block_elems {block_elems} < 0")
    if ops[0].numel() > PS_MAX_ELEMENTS:
        raise InvalidParameterError(
            f"probe_stream_f32: {ops[0].numel()} elements; the kernel's"
            f" 32-bit index takes at most {PS_MAX_ELEMENTS}")

    def body(lib, launch):
        out = torch.empty(shape, dtype=torch.float32, device=device)
        plan = plan_stream(shape, [t.stride() for t in ops], out.stride(),
                           block_elems=block_elems,
                           aligned=[_aligned(t) for t in [out, *ops]])
        nops = len(ops)
        launch(lib.probe_stream_f32,
               nops, (ctypes.c_void_p * nops)(*[t.data_ptr() for t in ops]),
               (ctypes.c_int64 * (3 * nops))(*[s for st in plan.in_strides
                                               for s in st]),
               out.data_ptr(), (ctypes.c_int64 * 3)(*plan.out_strides),
               (ctypes.c_int64 * 3)(*plan.shape), float(alpha),
               _STREAM_MODES[plan.mode], plan.mask, plan.per_block)
        return out
    return launch_frame("probe_stream_f32", device,
                        lambda: probe_stream_plain(ops, alpha=alpha), body)

# }}}


# {{{ probe_apply_f32, probe_apply_3xtf32

@dataclass(frozen=True)
class ApplyRow:
    """One row of the contraction probe, views over the stored tensors:
    ``u`` (K, E), ``J`` (S, E) or ``None`` (factor 1; S = 1), ``sigma``
    (I1, I2, E) with I1 * I2 = I or ``None`` (factor 1)."""

    u: torch.Tensor
    J: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None


def apply_tile(I: int, split: bool, S: int = 1) -> tuple:
    """``(rows, elements)`` of the kernel's item for R (S, I, K): a row
    tile and an element sub-tile (``csrc/probe_apply.cu``'s ``f32_tile``
    and ``x3_tile``).  ``probe_apply_f32``: RG row groups of TM rows by 8
    elements per group of the 256 / RG threads (a multiple of 4, at most
    64): TM = 8 and RG 16, 12 or 8, whichever pads I least (the larger on
    a tie), where I > 64 at S = 1; else TM = 4 and row tiles of at most 64
    rows, as even as can be.  ``probe_apply_3xtf32`` (*split*): 8 ceil(I /
    8) rows by 256 elements up to I = 64, else even tiles of a multiple of
    16 rows, at most 128, by 128 elements."""
    if split:
        if I <= 64:
            return 8 * -(-I // 8), 256
        tiles = -(-I // 128)
        return 16 * -(-(-(-I // tiles)) // 16), 128
    if I > 64 and S == 1:      # TM = 8: 16, 12 or 8 row groups
        rg = min((16, 12, 8), key=lambda g: (-(-I // (8 * g)) * 8 * g, -g))
        return 8 * rg, 8 * min(64, 256 // rg // 4 * 4)
    tiles = -(-I // 64)
    rg = -(-(-(-I // tiles)) // 4)
    return 4 * rg, 8 * min(64, 256 // rg // 4 * 4)


def apply_geometry(E: int, runs: int, block_elems: int,
                   sub: int = PA_TE) -> tuple:
    """``(run, n)``: the elements per run and per run per element block when
    a block takes *block_elems* elements (0: one sub-tile of *sub*, the
    kernel's :func:`apply_tile`) from each of *runs* runs of ``E / runs``
    elements (runs = 1: a contiguous range; runs = 8 on the folded view:
    mapping I).  The kernel's items are (row tile, element block, sub-tile)
    and its persistent blocks walk them; the elements an item takes do not
    depend on the grid."""
    per = block_elems or sub
    if runs < 1 or E % runs:
        raise InvalidParameterError(
            f"probe_apply: E = {E} is not a multiple of runs = {runs}")
    if per < runs or per % runs:
        raise InvalidParameterError(
            f"probe_apply: {per} elements per block do not split into"
            f" {runs} runs")
    return E // runs, per // runs


def _apply_check(rows: Sequence[ApplyRow], R: torch.Tensor) -> tuple:
    """``(device, S, I, K, E)`` of the rows and R, checked."""
    if not 1 <= len(rows) <= PA_MAX_ROWS:
        raise InvalidParameterError(
            f"probe_apply: b = {len(rows)} rows; the kernel takes 1 to"
            f" {PA_MAX_ROWS} in one launch")
    if R.dim() != 3 or not R.is_contiguous():
        raise ValueError(f"probe_apply: R must be a contiguous (S, I, K)"
                         f" tensor, got shape {tuple(R.shape)} strides"
                         f" {R.stride()}")
    if R.dtype != torch.float32:
        raise InvalidParameterError(f"probe_apply: R is {R.dtype}; the kernel"
                                    " takes float32")
    S, I, K = R.shape
    if S > PA_MAX_S:
        raise InvalidParameterError(
            f"probe_apply: S = {S}; the kernel takes at most {PA_MAX_S}")
    if I > PA_MAX_DIM or K > PA_MAX_DIM:
        raise InvalidParameterError(
            f"probe_apply: R is {I} x {K}, over the kernel's limit of"
            f" {PA_MAX_DIM} rows and {PA_MAX_DIM} j's")
    device = R.device
    first = rows[0]
    E = first.u.shape[-1]

    def layout(row):
        return tuple(None if t is None else (tuple(t.shape), t.stride())
                     for t in (row.u, row.J, row.sigma))
    for b, row in enumerate(rows):
        for name, t in (("u", row.u), ("J", row.J), ("sigma", row.sigma)):
            if t is None:
                continue
            if t.dtype != torch.float32:
                raise InvalidParameterError(
                    f"probe_apply: row {b}'s {name} is {t.dtype}; the kernel"
                    " takes float32")
            if t.device != device:
                raise ValueError(f"probe_apply: row {b}'s {name} lies on"
                                 f" {t.device}, R on {device}")
        if layout(row) != layout(first):
            raise ValueError(
                f"probe_apply: mismatched storages: row {b}'s (shape,"
                f" strides) of u, J, sigma are {layout(row)}, row 0's"
                f" {layout(first)}")
    if tuple(first.u.shape) != (K, E):
        raise ValueError(f"probe_apply: u has the shape"
                         f" {tuple(first.u.shape)}, R's K = {K}")
    if first.J is None:
        if S != 1:
            raise InvalidParameterError(
                f"probe_apply: S = {S} needs J (S, E)")
    elif tuple(first.J.shape) != (S, E):
        raise ValueError(f"probe_apply: J has the shape"
                         f" {tuple(first.J.shape)}, want {(S, E)}")
    if first.sigma is not None:
        if first.sigma.dim() != 3 or first.sigma.shape[0] * \
                first.sigma.shape[1] != I or first.sigma.shape[2] != E:
            raise ValueError(f"probe_apply: sigma has the shape"
                             f" {tuple(first.sigma.shape)}, want (I1, I2,"
                             f" {E}) with I1 * I2 = {I}")
    return device, S, I, K, E


def _apply_plain(rows, R, out_elem_major, contract) -> list:
    from ..codegen.program import check_full_fp32_matmul
    check_full_fp32_matmul()
    _, S, I, K, E = _apply_check(rows, R)
    outs = []
    for row in rows:
        t = contract("sij,je->sie", R, row.u)
        if row.J is not None:
            t = t * row.J[:, None, :]
        v = t.sum(0)
        if row.sigma is not None:
            v = v * row.sigma.reshape(I, E)
        outs.append(v.t().contiguous().t() if out_elem_major
                    else v.contiguous())
    return outs


def probe_apply_plain(rows: Sequence[ApplyRow], R: torch.Tensor, *,
                      out_elem_major: bool = False) -> list:
    """The plain PyTorch version of ``probe_apply_f32``: per row
    ``torch.einsum("sij,je->sie", R, u)`` in full f32, times J summed over
    s, times sigma; each output (I, E), element-major in storage with
    *out_elem_major*."""
    return _apply_plain(rows, R, out_elem_major, torch.einsum)


def probe_apply_3x_plain(rows: Sequence[ApplyRow], R: torch.Tensor, *,
                         out_elem_major: bool = False) -> list:
    """``probe_apply_plain`` with the j-dot in three passes over the TF32
    split (:func:`~feinsum_tpu_torch.ops.kernels.einsum_3x`)."""
    return _apply_plain(rows, R, out_elem_major, einsum_3x)


def probe_apply_ranges_plain(R: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """The plain version of the kernels' pre-pass: an (S, tiles, 2) int32
    tensor, per s and tile of *tile_rows* rows of R the first chunk of
    ``PA_KC`` j's that holds a nonzero of R and one past the last, (0, 0)
    where there is none.  A NaN counts as nonzero, ±0 does not.  The kernel
    sums only these chunks: a chunk whose R is all ±0 adds exactly 0 to
    every finite sum (the one difference from the dense product is 0 * Inf
    where u holds an Inf: the logical einsum's 0, where the dense product
    gives NaN)."""
    S, I, K = R.shape
    tiles = -(-I // tile_rows)
    nz = torch.zeros(S, tiles * tile_rows, K, dtype=torch.bool,
                     device=R.device)
    nz[:, :I] = R != 0
    nk = -(-K // PA_KC)
    chunks = torch.zeros(S, tiles, nk * PA_KC, dtype=torch.bool,
                         device=R.device)
    chunks[..., :K] = nz.view(S, tiles, tile_rows, K).any(2)
    hit = chunks.view(S, tiles, nk, PA_KC).any(3)
    idx = torch.arange(nk, device=R.device)
    first = torch.where(hit, idx, nk).min(2).values
    last = torch.where(hit, idx, -1).max(2).values
    none = last < 0
    return torch.stack([torch.where(none, 0, first),
                        torch.where(none, 0, last + 1)], 2).to(torch.int32)


def apply_flags(rows: Sequence[ApplyRow], outs: Sequence[torch.Tensor],
                run: int, n: int, out_elem_major: bool) -> int:
    """The kernel's flags for these rows and outputs: 16-byte staging of u
    where its element axis is contiguous and every u is aligned, else the
    lanes along u's stride-1 axis; float4 stores of a dof-major output."""
    su_k, su_e = rows[0].u.stride()
    vec_e = n % 4 == 0 and run % 4 == 0
    flags = 0
    if vec_e and su_e == 1 and su_k % 4 == 0 and all(_aligned(r.u)
                                                     for r in rows):
        flags |= _U_VEC
    elif su_k == 1:
        flags |= _U_K_FAST
    if out_elem_major:
        flags |= _OUT_ELEM_MAJOR
    elif vec_e and outs[0].stride(0) % 4 == 0 and all(_aligned(o)
                                                       for o in outs):
        flags |= _OUT_VEC
    if rows[0].J is not None:
        flags |= _HAS_J
    if rows[0].sigma is not None:
        flags |= _HAS_SIGMA
    return flags


def _apply_launch(name: str, plain, rows, R, runs, block_elems,
                  out_elem_major, tables, split: bool = False) -> list:
    """Launch the kernel *name*, ``probe_apply_f32`` or (*split*) its 3x
    variant; *plain* for CPU tensors."""
    device, S, I, K, E = _apply_check(rows, R)
    tile_rows, sub = apply_tile(I, split, S)
    run, n = apply_geometry(E, runs, block_elems, sub)

    def on_cpu():
        if tables is not None:
            tables["ranges"] = probe_apply_ranges_plain(R, tile_rows)
            if split:
                tables["hi"], tables["lo"] = tf32_split(R)
            else:
                tables["R"] = R
        return plain(rows, R, out_elem_major=out_elem_major)

    def body(lib, launch):
        outs = [torch.empty((E, I), dtype=torch.float32, device=device).t()
                if out_elem_major
                else torch.empty((I, E), dtype=torch.float32, device=device)
                for _ in rows]
        flags = apply_flags(rows, outs, run, n, out_elem_major)
        first = rows[0]
        sigma = first.sigma
        strides = (*first.u.stride(),
                   *(first.J.stride() if first.J is not None else (0, 0)),
                   *(sigma.stride() if sigma is not None else (0, 0, 0)),
                   *outs[0].stride())
        I2 = sigma.shape[1] if sigma is not None else 1
        nb = len(rows)

        def ptrs(ts):
            return (ctypes.c_void_p * nb)(*[0 if t is None else t.data_ptr()
                                            for t in ts])
        # the pre-pass's scratch, one allocation: R j-major over whole row
        # tiles (at 3x its split, hi and lo), then the least and the greatest
        # j of R's nonzeros per (s, row tile, column block)
        tiles = -(-I // tile_rows)
        ncb = -(-K // PA_PRE_COLS)
        nplane = (2 if split else 1) * S * K * tiles * tile_rows
        scratch = torch.empty(nplane + 2 * S * tiles * ncb,
                              dtype=torch.float32, device=device)
        planes = scratch[:nplane].view(-1, S, K, tiles * tile_rows)
        ranges = scratch[nplane:].view(torch.int32)
        launch(getattr(lib, name),
               nb, ptrs([r.u for r in rows]), ptrs([r.J for r in rows]),
               ptrs([r.sigma for r in rows]), ptrs(outs),
               ctypes.c_void_p(R.data_ptr()), S, I, K,
               (ctypes.c_int64 * 9)(*strides), I2, run, runs, n, flags,
               ctypes.c_void_p(ranges.data_ptr()), ranges.numel(),
               ctypes.c_void_p(planes.data_ptr()), planes.numel())
        if tables is not None:
            # the kernel's range table from the pre-pass's least and greatest
            # j of R's nonzeros per (s, row tile, column block)
            part = ranges.view(2, S, tiles, ncb).long()
            mn, mx = part[0].min(2).values, part[1].max(2).values
            none = mx < 0
            tables["ranges"] = torch.stack([
                torch.where(none, 0, mn // PA_KC),
                torch.where(none, 0, mx // PA_KC + 1)], 2).to(torch.int32)
            rows_of = [p[:, :, :I].transpose(1, 2) for p in planes]
            if split:
                tables["hi"], tables["lo"] = rows_of
            else:
                tables["R"] = rows_of[0]
        return outs
    return launch_frame(name, device, on_cpu, body)


def probe_apply_f32(rows: Sequence[ApplyRow], R: torch.Tensor, *,
                    runs: int = 1, block_elems: int = 0,
                    out_elem_major: bool = False,
                    tables: Optional[dict] = None) -> list:
    """``out_b = sigma * Σ_s J_b[s] * (R[s] @ u_b)`` for each row, one
    launch (the pre-pass and the kernel): each output a new (I, E) tensor,
    dof-major in storage or, with *out_elem_major*, element-major.  An
    element block takes *block_elems* elements (0: one sub-tile of
    :func:`apply_tile`) from each of *runs* runs (:func:`apply_geometry`).
    Only the chunks of j that hold R's nonzeros are summed
    (:func:`probe_apply_ranges_plain`: exact for finite u).  *tables*, a
    dict, receives the pre-pass's range table (``"ranges"``) and its copy
    of R (``"R"``, an (S, I, K) view of the j-major scratch)."""
    return _apply_launch("probe_apply_f32", probe_apply_plain, rows, R, runs,
                         block_elems, out_elem_major, tables)


def probe_apply_3xtf32(rows: Sequence[ApplyRow], R: torch.Tensor, *,
                       runs: int = 1, block_elems: int = 0,
                       out_elem_major: bool = False,
                       tables: Optional[dict] = None) -> list:
    """``probe_apply_f32`` with the j-dot in three TF32 tensor-core passes
    over the hi/lo split (the port's ``bf16_3x``); R is split once, by the
    pre-pass (*tables* also receives the planes, ``"hi"`` and ``"lo"``)."""
    return _apply_launch("probe_apply_3xtf32", probe_apply_3x_plain, rows, R,
                         runs, block_elems, out_elem_major, tables,
                         split=True)

# }}}
