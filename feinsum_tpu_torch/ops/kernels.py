"""
The hand-written CUDA kernels, their plain PyTorch versions and their launch
counters.

The first two replace the TPU kernel ``feinsum_tpu/ops/pallas_emitter.py::
build_pallas_executable`` (K1 in ROADMAP.md), which computes all rows of a
batched einsum in one fused kernel gridded over the long element axis:

* ``dg_rows_f32`` (``csrc/dg_rows.cu``) — the contraction rows,
  ``out[x, i, e] = Σ_s F[x, s, e] Σ_j R[s, i, j] u[s?, j, e]`` as planned by
  :mod:`~feinsum_tpu_torch.ops.dg_rows`.  On an H100 such a row sits near
  the fp32 CUDA-core ridge (about 20 flop per byte).  Its tiled path keeps
  register tiles over (i, e) and stages u and F by TMA bulk copies in a
  ring; other stored layouts take its general path (:func:`dg_rows_path`).  The
  source's header says what bounds each row and what the design does
  about it.
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
  used pair arithmetic).  Its tiled path keeps register tiles over (i, e),
  stages u and F pairs by TMA tensor-map boxes in a ring and combines each
  pair once; other stored layouts take its general path
  (:func:`dd_rows_path`).
  The source's header says what bounds each row and what the design does
  about it.

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
  launch in a fixed order.  Its stream path (a kernel of its own, chosen by
  :func:`step_block_path`) runs a table of one element-local product over
  streamed operands on 16 bytes, such as a metric product per node, with
  16-byte loads straight into registers; its lanes path (another, chosen
  there too) a table of dense element steps on 16 bytes, such as the ADER
  element's and sum factorization's chains, with a warp's lanes on
  consecutive elements and the reference matrices read as broadcasts
  (:func:`step_block_lanes_tables`), a reference-matrix step and the
  per-element product that reads its result alone chained in one unit
  whose first result stays in registers.

And one runs K2's whole schedule, every step of a dense program with a
tuple ``grid_index`` that ``tc_grid_f32`` does not take (a cell table of
:mod:`~feinsum_tpu_torch.ops.tc_steps`):

* ``tc_steps_f32`` (``csrc/tc_steps.cu``) — one thread block per grid cell,
  each step as threads over its output entries, each summing its contracted
  entries through int32 offset tables built on the host
  (:func:`~feinsum_tpu_torch.ops.tc_steps.tc_steps_tables`); intermediates
  stay in shared memory; the last step writes the cell's tile of the output
  in its stored layout.

Two more serve the model steps (``models/wave.py``, ``models/maxwell.py``)
rather than an einsum:

* ``step_update`` (``csrc/step_update.cu``) — everything between the
  einsums' outputs and the new state, ``base + dt * (±t0 ± t1 ± ...)``,
  in one pass per state tensor written, float32 or float64 on the
  einsums' pair outputs, bit for bit the PyTorch glue it replaces (its
  plain version ``step_update_plain`` is what the models' plain per-step
  route runs);
* ``pairs_split`` — a float64 tensor split into its float32 hi/lo pair in
  one pass.

Every wrapper runs in one frame, :func:`launch_frame`: the plain version
for tensors on the CPU, the kernel for CUDA tensors (there is no fallback
from a CUDA tensor to the plain version), a refusal of any other device,
the span ``feinsum.kernel:<kernel>``, and per launch a span
``feinsum.launch:<kernel>.<path>`` (``.<path>`` for the kernels that
choose one) and one count in :data:`launch_counts` (and one under its path
in the kernel's path counter).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..diagnostics import InvalidParameterError

# shared memory a Hopper thread block can use (227 KB of the SM's 256 KB)
MAX_SMEM_BYTES = 232_448
# register-array bounds of csrc/dg_rows.cu and csrc/dd_rows.cu (kMaxX, kMaxS)
MAX_X = MAX_S = 4
# threads per block of csrc/dd_rows.cu's and csrc/dg_rows.cu's general
# paths (kThreads)
DD_THREADS = DG_THREADS = 128
# csrc/dg_rows.cu's tiled path: elements per tile (kTE); its ring's stages
# in the order tried, each with the most shared memory it may take
# (kTwoBlockSmem: two blocks to an SM; kOneBlockSmem)
DG_TILE_E = 128
DG_TILED_STAGES = tuple((n, 112 * 1024) for n in (4, 3, 2)) + tuple(
    (n, MAX_SMEM_BYTES - 64) for n in (3, 2))
# csrc/dd_rows.cu's tiled path: elements per tile (kTE); its ring's stages
# in the order tried, and the most shared memory its one block to an SM may
# take (kTiledSmem)
DD_TILE_E = 128
DD_TILED_STAGES = (4, 3, 2)
DD_TILED_SMEM_BYTES = MAX_SMEM_BYTES - 128
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
# csrc/step_block.cu: the stream path's instances, NM x NK entries an
# element, NM and NK up to kStreamMax
SB_STREAM_MAX = 3
# csrc/step_block.cu: the lanes path's register tiles (RX, RW), a lane's
# entries of X (its element's) and of W: a resident W, read by 16-byte
# broadcasts, takes RW a multiple of 4 (the SB_LANES_RES cases); a W per
# element, RW any (the SB_LANES_ELEM cases)
SB_LANE_TILES = ((1, 4), (1, 8), (1, 12), (1, 16), (2, 4), (2, 8), (2, 12),
                 (2, 16), (3, 4), (3, 8), (3, 12), (3, 16), (4, 4), (4, 8),
                 (4, 12), (5, 4), (5, 8), (6, 4), (6, 8), (8, 4), (9, 4))
SB_LANE_TILES_ELEM = ((1, 1), (1, 4), (1, 9), (2, 4), (2, 5), (2, 9),
                      (3, 3), (3, 4), (3, 5), (3, 9), (4, 4), (4, 5),
                      (4, 9), (5, 5), (5, 9))
# csrc/step_block.cu: the lanes path's chained pairs (the SB_LANE_CHAIN
# cases): (RQ, NKW, RM, NN), RQ rows of the first step's X at a time, NKW of
# the second step's contracted entries on W's side, RM of its free entries
# on the first result's side and NN on its per-element operand's
SB_LANE_CHAINS = ((3, 3, 4, 9), (9, 3, 1, 9), (9, 1, 4, 9))
# the chained pairs whose first step has batch letters that the second
# contracts, the tile's NKW entries each with X's rows at its own batch
# entry (the SB_LANE_CHAIN_BATCH cases, 32-element sub-tiles alone)
SB_LANE_CHAINS_BATCH = ((3, 4, 3, 15),)
# the threads of a lanes-path block (its kernel's instances); the streamed
# regions of a table, the letters of one and the entries of a letter (each
# region a TMA tensor map: kLaneMaxMaps, kLaneMaxLetters, kLaneMaxBox); its
# static shared memory (the maps' mbarriers, with the dynamic part's
# alignment)
SB_LANE_THREADS = (256, 512)
SB_LANE_MAX_MAPS = 4
SB_LANE_MAX_LETTERS = 4
SB_LANE_MAX_BOX = 256
SB_LANE_STATIC_BYTES = 128

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

# launches by kernel: the package's counter (``tracing.counters``)
launch_counts = tracing.counters["launches"]


def reset_launch_counts() -> None:
    """Zero the launch counts, ``dg_rows_f32``'s and ``dd_rows``'s
    launches by path and ``step_block_f32``'s by mode."""
    for name in launch_counts:
        launch_counts[name] = 0
    for counter in tracing.PATH_COUNTERS.values():
        for path in tracing.counters[counter]:
            tracing.counters[counter][path] = 0


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
                   shape: tuple, pair: bool = False) -> None:
    """Refuse *t* unless it lies on *device*, is float32 of *shape* and is
    a permutation of a contiguous layout; with *pair*, a (2, ...) hi/lo
    pair whose planes each are, any distance apart (a component's view of
    a pair tensor, ``v_pairs[:, x]``)."""
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise InvalidParameterError(f"{name}: dtype {t.dtype}, the kernels"
                                    " take float32 (or float32 pairs) only")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not _is_dense_permutation(t[0] if pair else t):
        raise ValueError(f"{name}: strides {t.stride()} are not a"
                         " permutation of a contiguous layout")


def _stream_of(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _check_block_long(block_long: int) -> None:
    if block_long < 1:
        raise InvalidParameterError(
            f"block_long must be positive, got {block_long}")


def _check_smem(name: str, nbytes: int) -> None:
    """Refuse a block of kernel *name* that needs more shared memory than
    a Hopper block has."""
    if nbytes > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"{name} needs {nbytes} bytes of shared memory per block; an"
            f" H100 block has {MAX_SMEM_BYTES}")


def _launch_rows(n: int, one_launch: bool, max_rows) -> list:
    """The indices of *n* rows in launches of at most ``max_rows()`` rows
    (a function of the library), or of one row without *one_launch*."""
    per = max_rows() if one_launch else 1
    return [range(k, min(k + per, n)) for k in range(0, n, per)]


def launch_frame(name: str, device: torch.device, plain, body):
    """The frame of every kernel wrapper: ``plain()`` for tensors on the
    CPU; on a CUDA device ``body(lib, launch)`` in the span
    ``feinsum.kernel:<name>`` and the device's context, *lib* the loaded
    library and ``launch`` :func:`launcher`'s; any other device raises
    :class:`ValueError`."""
    if device.type == "cpu":
        return plain()
    with tracing.span(f"feinsum.kernel:{name}"):
        if device.type != "cuda":
            raise ValueError(f"{name}: no kernel for device {device}")
        from ._build import load_library
        lib = load_library()
        with torch.cuda.device(device):
            return body(lib, launcher(name, device))


def launcher(name: str, device: torch.device):
    """``launch(entry, *args, path=None)``: one launch of the library
    function *entry* on the device's current stream, in the span
    ``feinsum.launch:<name>.<path>`` (``tracing.launch_span``), its
    return code checked, and the launch counted under *name* and, with a
    *path*, under that path in the kernel's path counter
    (``tracing.count_launch``)."""
    def launch(entry, *args, path=None) -> None:
        with tracing.launch_span(name, path):
            err = entry(*args, _stream_of(device))
        if err:
            raise RuntimeError(f"{name} launch failed: CUDA error {err}")
        tracing.count_launch(name, path)
    return launch


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
    """Shared memory one block of ``dg_rows_f32``'s general path needs, in
    bytes: R (i padded to a multiple of 4) and one u column per thread (the
    formula of ``csrc/dg_rows.cu``).  The kernel takes a shape when this
    fits in a Hopper block, whichever path runs it."""
    return 4 * (S * J * (-(-I // 4) * 4)
                + (S if u_has_s else 1) * J * DG_THREADS)


def dg_rows_tiled_smem_bytes(X: int, S: int, I: int, J: int,
                             u_has_s: bool, has_f: bool) -> int:
    """Shared memory one block of ``dg_rows_f32``'s tiled path needs, in
    bytes: R (i padded to a multiple of 4) and a ring of stages, each one
    tile of u (S_u x J) and F (X x S) over ``DG_TILE_E`` elements: the
    most stages (4, 3 or 2) with which two blocks fit on an SM, else the
    most (3 or 2) with which one block fits; 0 where no ring fits (the
    formula of ``csrc/dg_rows.cu``)."""
    r = S * J * (-(-I // 4) * 4)
    stage = ((S if u_has_s else 1) * J + (X * S if has_f else 0)) * DG_TILE_E
    for stages, limit in DG_TILED_STAGES:
        if 4 * (r + stages * stage) <= limit:
            return 4 * (r + stages * stage)
    return 0


def _tileable(t: torch.Tensor) -> bool:
    """Whether the tiled path can copy the (a, b, E) view *t* in 16-byte
    pieces: e at stride 1 and every row of it starting on 16 bytes."""
    (a, b, _), (sa, sb, se) = t.shape, t.stride()
    return (se == 1 and t.data_ptr() % 16 == 0 and (a == 1 or sa % 4 == 0)
            and (b == 1 or sb % 4 == 0))


def dg_rows_path(rows: Sequence[DGRow], *, block_long: int,
                 out_order: tuple = (0, 1, 2)) -> str:
    """The path a launch of ``dg_rows_f32`` on *rows* takes: ``"tiled"``
    where u, F and the output (allocated in the stored order *out_order*)
    store e at stride 1 with every row on 16 bytes, E and *block_long* are
    multiples of 4 and the ring fits in a block; else ``"general"``."""
    return _dg_path(rows, _dg_dims(rows), block_long, out_order)


def _dg_path(rows: Sequence[DGRow], dims: tuple, block_long: int,
             out_order: tuple) -> str:
    X, S, I, J, E, u_has_s, has_f = dims
    if (out_order[2] != 2 or E % 4 or block_long % 4
            or not dg_rows_tiled_smem_bytes(X, S, I, J, u_has_s, has_f)):
        return "general"
    for row in rows:
        if not _tileable(row.u) or (has_f and not _tileable(row.F)):
            return "general"
    return "tiled"


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
    unless *one_launch* is false; *block_long* elements per thread block
    (per block of elements on the tiled path, :func:`dg_rows_path`, where
    a thread block takes a run of whole blocks).  Each launch counts in
    ``tracing.counters["dg_rows_f32_path"]`` under its path, which names
    its span."""
    return _dg_launch("dg_rows_f32", dg_rows_plain, rows, block_long,
                      out_order, one_launch, tiled=True)


def dg_rows_3xtf32(rows: Sequence[DGRow], *, block_long: int,
                   out_order: tuple = (0, 1, 2),
                   one_launch: bool = True) -> list:
    """``dg_rows_f32``'s rows with the j-dot in three TF32 passes on the
    tensor cores (``csrc/dg_rows_3x.cu``): the ``bf16_3x`` precision; the
    same arguments and outputs."""
    return _dg_launch("dg_rows_3xtf32", dg_rows_3x_plain, rows, block_long,
                      out_order, one_launch)


def _dg_launch(name: str, plain, rows: Sequence[DGRow], block_long: int,
               out_order: tuple, one_launch: bool, tiled: bool = False
               ) -> list:
    """Launch the kernel *name*: ``dg_rows_f32`` (*tiled*: it chooses its
    path per launch) or ``dg_rows_3xtf32``; *plain* for CPU tensors."""
    if not rows:
        return []
    dims = X, S, I, J, E, u_has_s, has_f = _dg_dims(rows)
    device = rows[0].u.device
    if sorted(out_order) != [0, 1, 2]:
        raise ValueError(f"out_order {out_order} is not a permutation of 3")

    def body(lib, launch):
        if tiled:
            _check_smem(name, lib.dg_rows_f32_smem_bytes(S, I, J,
                                                         int(u_has_s)))
            path = _dg_path(rows, dims, block_long, out_order)
            path_args = (int(path == "tiled"),)
        else:
            _check_smem(name, lib.dg_rows_3xtf32_smem_bytes(
                X, S, I, J, int(u_has_s)))
            path, path_args = None, ()
        shape = (X, I, E)
        inverse = tuple(sorted(range(3), key=lambda a: out_order[a]))
        outs = [torch.empty(tuple(shape[a] for a in out_order),
                            dtype=torch.float32, device=device)
                for _ in rows]
        for idx in _launch_rows(len(rows), one_launch,
                                getattr(lib, f"{name}_max_rows")):
            ptrs = (ctypes.c_void_p * (4 * len(idx)))()
            strides = (ctypes.c_int64 * (12 * len(idx)))()
            for n, r in enumerate(idx):
                row, out = rows[r], outs[r].permute(*inverse)
                f_ptr = row.F.data_ptr() if has_f else None
                ptrs[4 * n:4 * n + 4] = [
                    row.u.data_ptr(), row.R.data_ptr(), f_ptr,
                    out.data_ptr()]
                f_strides = row.F.stride() if has_f else (0, 0, 0)
                strides[12 * n:12 * n + 12] = [
                    *row.u.stride(), *row.R.stride(), *f_strides,
                    *out.stride()]
            launch(getattr(lib, name), len(idx), ptrs, strides, X, S, I, J, E,
                   int(u_has_s), int(block_long), *path_args, path=path)
        return outs
    return launch_frame(name, device, lambda: plain(rows, out_order), body)

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

    def body(lib, launch):
        nops = len(rows[0])
        if nops > lib.ew_product_f32_max_ops():
            raise InvalidParameterError(
                f"ew_product_f32 takes at most {lib.ew_product_f32_max_ops()}"
                f" operands, got {nops}")
        n = rows[0][0].numel()
        outs = [torch.empty(shape, dtype=torch.float32, device=device)
                for _ in rows]
        for idx in _launch_rows(len(rows), one_launch,
                                lib.ew_product_f32_max_rows):
            ins = (ctypes.c_void_p * (nops * len(idx)))(
                *[t.data_ptr() for r in idx for t in rows[r]])
            out_ptrs = (ctypes.c_void_p * len(idx))(
                *[outs[r].data_ptr() for r in idx])
            launch(lib.ew_product_f32, len(idx), nops, ins, out_ptrs, n,
                   block_long)
        return outs
    return launch_frame(counter, device, lambda: ew_product_plain(rows), body)


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
    _check_block_long(block_long)
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

    def body(lib, launch):
        if J > MAX_REDUCE_J:
            raise InvalidParameterError(
                f"row_reduce_f32 takes at most {MAX_REDUCE_J} values of j, got"
                f" {J}")
        outs = [torch.empty((E,), dtype=torch.float32, device=device)
                for _ in rows]
        for idx in _launch_rows(len(rows), one_launch,
                                lib.row_reduce_f32_max_rows):
            ptrs = (ctypes.c_void_p * (3 * len(idx)))()
            strides = (ctypes.c_int64 * (2 * len(idx)))()
            for n, r in enumerate(idx):
                row = rows[r]
                ptrs[3 * n:3 * n + 3] = [
                    row.u.data_ptr(), row.w.data_ptr() if has_w else None,
                    outs[r].data_ptr()]
                strides[2 * n:2 * n + 2] = list(row.u.stride())
            launch(lib.row_reduce_f32, len(idx), ptrs, strides, J, E,
                   int(block_long))
        return outs
    return launch_frame("row_reduce_f32", device,
                        lambda: row_reduce_plain(rows), body)

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

    def body(lib, launch):
        check_long_reduce_shape(shape)
        _check_block_long(block_long)
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
        outs = [torch.empty(shape.out_shape, dtype=torch.float32,
                            device=device) for _ in rows]
        for idx in _launch_rows(len(rows), one_launch,
                                lib.long_reduce_f32_max_rows):
            work = torch.empty(len(idx) * nblocks * shape.entries,
                               dtype=torch.float32, device=device)
            ptrs = (ctypes.c_void_p * (3 * len(idx)))()
            strides = (ctypes.c_int64 * (7 * len(idx)))()
            for n, r in enumerate(idx):
                row, out = rows[r], outs[r]
                out_stride = dict(zip(shape.out_axes, out.stride()))
                ptrs[3 * n:3 * n + 3] = [
                    row.a.data_ptr(), row.b.data_ptr() if has_b else None,
                    out.data_ptr()]
                b_strides = row.b.stride() if has_b else (0, 0)
                strides[7 * n:7 * n + 7] = [
                    *row.a.stride(), *b_strides,
                    *(out_stride.get(a, 0) for a in ("p", "q", "c"))]
            launch(lib.long_reduce_f32, len(idx), ptrs, strides, role_arr,
                   shape.P, shape.Q, shape.C, int(shape.c_batch), E,
                   int(block_long), te, int(b_staged),
                   ctypes.c_void_p(work.data_ptr()))
        return outs
    return launch_frame("long_reduce_f32", device,
                        lambda: long_reduce_plain(rows, shape), body)

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


def dd_rows_tiled_smem_bytes(X: int, S: int, I: int, J: int,
                             u_has_s: bool, has_f: bool) -> int:
    """Shared memory one block of ``dd_rows``'s tiled path needs, in bytes:
    R as double (i padded to the register tile's i: 8 where the tile keeps
    one s, 6 where it keeps three, 4 otherwise; the face lift, u over s at
    X = 1, folds F into u and keeps one) and a ring of stages, each one
    tile of u (S_u x J) and F (X x S) rows over ``DD_TILE_E`` elements, 8
    bytes a pair: the most stages (4, 3 or 2) with which the one block to
    an SM fits; 0 where no ring fits (the formula of
    ``csrc/dd_rows.cu``)."""
    tile_s = 1 if u_has_s and X == 1 else S
    ib = {1: 8, 3: 6}.get(tile_s, 4)
    r = -(-I // ib) * ib * S * J
    stage = ((S if u_has_s else 1) * J + (X * S if has_f else 0)) * DD_TILE_E
    for stages in DD_TILED_STAGES:
        if 8 * (r + stages * stage) <= DD_TILED_SMEM_BYTES:
            return 8 * (r + stages * stage)
    return 0


def _pair_tileable(t: torch.Tensor) -> bool:
    """Whether the tiled path can copy the (2, a, b, E) pair view *t* by
    TMA boxes: e at stride 1, and every row of each plane and the distance
    between the planes on 16 bytes (no axis broadcast)."""
    (_, a, b, _), (sp, sa, sb, se) = t.shape, t.stride()
    return (se == 1 and t.data_ptr() % 16 == 0 and sp != 0 and sp % 4 == 0
            and (a == 1 or (sa != 0 and sa % 4 == 0))
            and (b == 1 or (sb != 0 and sb % 4 == 0)))


def dd_rows_path(rows: Sequence[DDRow], *, block_long: int) -> str:
    """The path a launch of ``dd_rows`` on *rows* takes: ``"tiled"`` where
    u and F store e at stride 1 with every row and pair plane on 16 bytes,
    E (below 2^31, a TMA coordinate) and *block_long* are multiples of 4
    and the ring fits in a block; else ``"general"``.  (The outputs are
    allocated contiguous.)"""
    return _dd_path(rows, _dd_dims(rows), block_long)


def _dd_path(rows: Sequence[DDRow], dims: tuple, block_long: int) -> str:
    X, S, I, J, E, u_has_s, has_f = dims
    if (E % 4 or block_long % 4 or E >= 2 ** 31
            or not dd_rows_tiled_smem_bytes(X, S, I, J, u_has_s, has_f)):
        return "general"
    for row in rows:
        if not _pair_tileable(row.u) or (has_f
                                         and not _pair_tileable(row.F)):
            return "general"
    return "tiled"


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
                       (2, S if u_has_s else 1, J, E), pair=True)
        _check_operand(f"row {k} R", row.R, device, (2, S, I, J),
                       pair=True)
        if has_f:
            _check_operand(f"row {k} F", row.F, device, (2, X, S, E),
                           pair=True)
    return X, S, I, J, E, u_has_s, has_f


def dd_rows_plain(rows: Sequence[DDRow]) -> list:
    """The plain PyTorch version of ``dd_rows``: per row, the pairs
    recombined to float64, ``t = R @ u`` over j and ``Σ_s F t`` in float64,
    then split back into (2, X, I, E) pairs."""
    from .dd_emitter import combine_pairs
    outs = []
    for row in rows:
        t = torch.matmul(combine_pairs(row.R), combine_pairs(row.u))
        if row.F is None:
            val = t.sum(0, keepdim=True)                    # (1, I, E)
        else:
            val = torch.einsum("xse,sie->xie", combine_pairs(row.F), t)
        outs.append(pairs_split_plain(val))
    return outs


def dd_rows(rows: Sequence[DDRow], *, block_long: int,
            one_launch: bool = True) -> list:
    """Fused fp64 DG rows on pair storage: each row's ``out[x, i, e]`` as a
    contiguous (2, X, I, E) float32 hi/lo pair tensor.  All rows go in one
    launch (up to the kernel's row limit per launch) unless *one_launch* is
    false; *block_long* elements per thread block (per block of elements on
    the tiled path, :func:`dd_rows_path`, where a thread block takes a run
    of whole blocks).  Each launch counts in
    ``tracing.counters["dd_rows_path"]`` under its path, which names its
    span."""
    if not rows:
        return []
    dims = X, S, I, J, E, u_has_s, has_f = _dd_dims(rows)
    device = rows[0].u.device

    def body(lib, launch):
        _check_smem("dd_rows", lib.dd_rows_smem_bytes(S, I, J, int(u_has_s)))
        path = _dd_path(rows, dims, block_long)
        outs = [torch.empty((2, X, I, E), dtype=torch.float32, device=device)
                for _ in rows]
        for idx in _launch_rows(len(rows), one_launch, lib.dd_rows_max_rows):
            ptrs = (ctypes.c_void_p * (4 * len(idx)))()
            strides = (ctypes.c_int64 * (16 * len(idx)))()
            for n, r in enumerate(idx):
                row, out = rows[r], outs[r]
                f_ptr = row.F.data_ptr() if has_f else None
                ptrs[4 * n:4 * n + 4] = [
                    row.u.data_ptr(), row.R.data_ptr(), f_ptr,
                    out.data_ptr()]
                f_strides = row.F.stride() if has_f else (0, 0, 0, 0)
                strides[16 * n:16 * n + 16] = [
                    *row.u.stride(), *row.R.stride(), *f_strides,
                    *out.stride()]
            launch(lib.dd_rows, len(idx), ptrs, strides, X, S, I, J, E,
                   int(u_has_s), int(block_long), int(path == "tiled"),
                   path=path)
        return outs
    return launch_frame("dd_rows", device, lambda: dd_rows_plain(rows), body)

# }}}


# {{{ step_update, pairs_split

# csrc/step_update.cu: groups of one launch (kMaxGroups), terms of a group
# (kMaxTerms), and the launch's rows over all groups (gridDim.y)
UPDATE_MAX_GROUPS = 3
UPDATE_MAX_TERMS = 4
UPDATE_MAX_ROWS = 65535


def _check_view(name: str, t, device: torch.device, dtype: torch.dtype,
                shape: tuple) -> None:
    """Refuse *t* unless it is a tensor on *device* of *dtype* and *shape*
    with unit stride along its last axis (E)."""
    if not isinstance(t, torch.Tensor):
        raise InvalidParameterError(f"{name}: {type(t).__name__}, expected"
                                    " a tensor")
    if t.device != device:
        raise InvalidParameterError(f"{name} lies on {t.device}, the base"
                                    f" on {device}")
    if t.dtype != dtype:
        raise InvalidParameterError(f"{name}: dtype {t.dtype}, expected"
                                    f" {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise InvalidParameterError(f"{name}: shape {tuple(t.shape)},"
                                    f" expected {tuple(shape)}")
    if shape[-1] > 1 and t.stride(-1) != 1:
        raise InvalidParameterError(f"{name}: stride {t.stride(-1)} along E,"
                                    " expected 1")


def _update_args(base: torch.Tensor, terms: Sequence, signs,
                 kernel: bool, weights=None) -> tuple:
    """``(signs, groups, pairs, weights)``, checked: per group its base and
    its terms as (R, E) or (R1, R2, E) views (a term (2, ...) on pairs);
    ``pairs`` when the base is float64 and its terms float32 pairs;
    ``weights`` one (E,) view per group, or ``None``.  *kernel*: refuse the
    storage the kernel does not take (float64 terms)."""
    signs = (1,) * len(terms) if signs is None else tuple(signs)
    if len(signs) != len(terms) or any(s not in (1, -1) for s in signs):
        raise InvalidParameterError(f"signs {signs}: one +1 or -1 per term"
                                    f" of {len(terms)}")
    if not isinstance(base, torch.Tensor) or base.dtype not in (
            torch.float32, torch.float64):
        raise InvalidParameterError(
            f"base: {getattr(base, 'dtype', type(base).__name__)}, expected"
            " float32 or float64 (on pairs)")
    if base.ndim not in (2, 3, 4):
        raise InvalidParameterError(
            f"base: shape {tuple(base.shape)}, expected (rows, E),"
            " (groups, rows, E) or (groups, rows, inner rows, E)")
    if not 1 <= len(terms) <= UPDATE_MAX_TERMS:
        raise InvalidParameterError(f"step_update takes 1 to"
                                    f" {UPDATE_MAX_TERMS} terms, got"
                                    f" {len(terms)}")
    bases = list(base.unbind(0)) if base.ndim >= 3 else [base]
    if len(bases) > UPDATE_MAX_GROUPS:
        raise InvalidParameterError(f"step_update takes at most"
                                    f" {UPDATE_MAX_GROUPS} groups, got"
                                    f" {len(bases)}")
    shape = tuple(bases[0].shape)
    if len(bases) * math.prod(shape[:-1]) > UPDATE_MAX_ROWS:
        raise InvalidParameterError(f"step_update takes at most"
                                    f" {UPDATE_MAX_ROWS} rows, got"
                                    f" {len(bases) * math.prod(shape[:-1])}")
    # per term, its view of each group: one view of a (R, E) base, a
    # sequence of one per group of a (G, ...) one
    per_group = []
    for k, t in enumerate(terms):
        if base.ndim == 2:
            per_group.append([t])
        elif not isinstance(t, (list, tuple)) or len(t) != len(bases):
            got = len(t) if isinstance(t, (list, tuple)) \
                else f"a {type(t).__name__}"
            raise InvalidParameterError(
                f"term {k}: {got}, expected a sequence of {len(bases)}"
                " tensors, one per group")
        else:
            per_group.append(list(t))
    pairs = base.dtype == torch.float64 and getattr(
        per_group[0][0], "dtype", None) == torch.float32
    if kernel and base.dtype == torch.float64 and not pairs:
        raise InvalidParameterError(
            "term 0: a float64 base takes its terms as float32 hi/lo pairs"
            " (step_update_plain takes float64 terms)")
    lead = (2,) if pairs else ()
    term_dtype = torch.float32 if pairs else base.dtype
    groups = []
    for g, b in enumerate(bases):
        suffix = f" of group {g}" if base.ndim >= 3 else ""
        _check_view("base" + suffix, b, base.device, base.dtype, shape)
        views = [ts[g] for ts in per_group]
        for k, v in enumerate(views):
            _check_view(f"term {k}{suffix}", v, base.device, term_dtype,
                        lead + shape)
        groups.append((b, views))
    if weights is not None:
        if pairs or base.dtype != torch.float32:
            raise InvalidParameterError(
                "weights: the float32 storage alone takes weights")
        if len(weights) != len(bases):
            raise InvalidParameterError(
                f"weights: {len(weights)}, expected one (E,) tensor per"
                f" group of {len(bases)}")
        weights = list(weights)
        for g, w in enumerate(weights):
            _check_view(f"weight of group {g}", w, base.device,
                        torch.float32, shape[-1:])
    return signs, groups, pairs, weights


def _update_plain(base: torch.Tensor, groups: list, dt: float, signs: tuple,
                  pairs: bool, weights=None) -> torch.Tensor:
    from .dd_emitter import combine_pairs
    outs = []
    for g, (b, views) in enumerate(groups):
        vals = [combine_pairs(v) if pairs else v for v in views]
        acc = -vals[0] if signs[0] < 0 else vals[0]
        for s, v in zip(signs[1:], vals[1:]):
            acc = acc - v if s < 0 else acc + v
        if weights is not None:
            acc = weights[g] * acc
        outs.append(b + dt * acc)
    return outs[0] if base.ndim == 2 else torch.stack(outs)


def _update_out(base: torch.Tensor, out) -> torch.Tensor:
    """The update's output: *out*, checked as the base is (its shape,
    dtype and device, unit stride along E, any row strides), or a new
    contiguous tensor."""
    if out is None:
        return torch.empty(base.shape, dtype=base.dtype, device=base.device)
    if isinstance(out, torch.Tensor) and out.ndim == base.ndim >= 3 \
            and out.shape == base.shape:
        for g, o in enumerate(out.unbind(0)):
            _check_view(f"out of group {g}", o, base.device, base.dtype,
                        base.shape[1:])
    else:
        _check_view("out", out, base.device, base.dtype, base.shape)
    return out


def step_update_plain(base: torch.Tensor, terms: Sequence, dt: float,
                      signs: Optional[Sequence[int]] = None,
                      out: Optional[torch.Tensor] = None,
                      weights=None) -> torch.Tensor:
    """The plain PyTorch version of ``step_update``, on any device: the
    glue the model steps ran before it, one PyTorch op at a time, with the
    same arguments and checks, and one storage more, base and terms
    float64 (the models' plain per-step route)."""
    signs, groups, pairs, weights = _update_args(base, terms, signs,
                                                 kernel=False,
                                                 weights=weights)
    result = _update_plain(base, groups, dt, signs, pairs, weights)
    if out is None:
        return result
    return _update_out(base, out).copy_(result)


def step_update(base: torch.Tensor, terms: Sequence, dt: float,
                signs: Optional[Sequence[int]] = None,
                out: Optional[torch.Tensor] = None,
                weights=None) -> torch.Tensor:
    """A model step's state update in one pass: ``base + dt * (((s0 t0 +
    s1 t1) + s2 t2) + s3 t3)`` over one to four *terms* with *signs* (+1
    or -1 each, all +1 by default), as a new contiguous tensor of the
    base's shape and dtype.

    *base* is (R, E), one group, with each term one tensor, or (G, R, E),
    G <= 3 groups updated in one launch, ``base[g]`` each, with each term
    a sequence of G tensors, one per group; or (G, R1, R2, E), groups
    whose R1 x R2 rows lie at two strides (the rows of a slice such as
    ``t[:, :9]`` of a (35, 15, E) tensor), each term's views of the same
    shape.  The storage follows the operands: base and terms float32, or
    a float64 base with each term a (2, ...) float32 hi/lo pair (a
    ``dd_rows`` output; its planes may lie any distance apart), read as
    ``hi + lo`` in float64 and counted in ``pair_bytes`` at 8 bytes an
    entry.  Every view needs unit stride along E; any row strides.  In
    the float32 storage *weights*, one (E,) tensor per group (a (G, E)
    tensor or a sequence), weight each element's sum: ``base + dt * (w *
    (...))``.  ``csrc/step_update.cu``'s header says why the result is the
    plain version's bit for bit.  *out*, a tensor of the base's shape and
    dtype (any row strides, such as rows of a larger tensor), takes the
    result in place of a new tensor."""
    signs, groups, pairs, weights = _update_args(base, terms, signs,
                                                 kernel=True,
                                                 weights=weights)
    if pairs:
        tracing.counters["pair_bytes"] += 8 * len(terms) * base.numel()

    def body(lib, launch):
        result = _update_out(base, out)
        shape = groups[0][0].shape
        R, E = math.prod(shape[:-1]), shape[-1]
        if R * E == 0:
            return result
        inner = shape[-2]
        K = UPDATE_MAX_TERMS
        n_ptrs, n_strides = 3 + 2 * K, 2 * (2 + K)
        ptrs = (ctypes.c_void_p * (len(groups) * n_ptrs))()
        strides = (ctypes.c_int64 * (len(groups) * n_strides))()

        def put(s: int, k: int, v: torch.Tensor) -> None:
            """Row and outer strides of view *v* into slot *k*."""
            strides[s + k] = v.stride(-2)
            strides[s + 2 + K + k] = v.stride(0) if v.ndim == 3 else 0
        for g, ((b, views), o) in enumerate(zip(
                groups, result.unbind(0) if base.ndim >= 3 else [result])):
            p, s = g * n_ptrs, g * n_strides
            ptrs[p], ptrs[p + 1] = b.data_ptr(), o.data_ptr()
            put(s, 0, b)
            put(s, 1, o)
            for t, v in enumerate(views):
                hi = v[0] if pairs else v
                ptrs[p + 2 + t] = hi.data_ptr()
                if pairs:
                    ptrs[p + 2 + K + t] = v[1].data_ptr()
                put(s, 2 + t, hi)
            if weights is not None:
                ptrs[p + n_ptrs - 1] = weights[g].data_ptr()
        neg = sum(1 << t for t, s in enumerate(signs) if s < 0)
        launch(lib.step_update, int(pairs), len(groups), len(terms), R,
               inner, E, ptrs, strides, neg, float(dt))
        return result
    return launch_frame("step_update", base.device,
                        lambda: step_update_plain(base, terms, dt, signs,
                                                  out=out, weights=weights),
                        body)


def pairs_split_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of ``pairs_split``, in two passes: the
    rounding, then the remainder computed in float64 (it is exact there)
    and rounded into the lo plane."""
    out = torch.empty((2, *x.shape), dtype=torch.float32, device=x.device)
    out[0].copy_(x)
    torch.sub(x, out[0], out=out[1])
    return out


def pairs_split(x: torch.Tensor) -> torch.Tensor:
    """*x* (float64, contiguous) as its (2, ...) float32 hi/lo pair, a new
    contiguous tensor: hi the float32 rounding of the value, lo that of
    the remainder, in one pass on the card."""
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float64:
        raise InvalidParameterError(
            f"x: {getattr(x, 'dtype', type(x).__name__)}, pairs_split takes"
            " float64")
    if not x.is_contiguous():
        raise InvalidParameterError(f"x: strides {x.stride()}, pairs_split"
                                    " takes a contiguous tensor")

    def body(lib, launch):
        out = torch.empty((2, *x.shape), dtype=torch.float32,
                          device=x.device)
        if x.numel() == 0:
            return out
        launch(lib.pairs_split, x.numel(), x.data_ptr(), out[0].data_ptr(),
               out[1].data_ptr())
        return out
    return launch_frame("pairs_split", x.device,
                        lambda: pairs_split_plain(x), body)

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
    return _tc_launch("tc_grid_f32", tc_grid_plain, A, B, step)


def tc_grid_3xtf32(A: torch.Tensor, B: torch.Tensor, step: TCStep
                   ) -> torch.Tensor:
    """``tc_grid_f32``'s step with the tile's inner product in three TF32
    passes on the tensor cores (``csrc/tc_grid_3x.cu``): the ``bf16_3x``
    precision; the same tables, tiles and output."""
    return _tc_launch("tc_grid_3xtf32", tc_grid_3x_plain, A, B, step)


def _tc_launch(name: str, plain, A: torch.Tensor, B: torch.Tensor,
               step: TCStep) -> torch.Tensor:
    """Launch the kernel *name*, ``tc_grid_f32`` or ``tc_grid_3xtf32``;
    *plain* for CPU tensors."""
    lengths = dict(step.lengths)
    device = A.device
    _check_operand("A", A, device, tuple(lengths[l] for l in step.a))
    _check_operand("B", B, device, tuple(lengths[l] for l in step.b))
    shape = tc_classify(step)

    def body(lib, launch):
        C = torch.empty(tuple(lengths[l] for l in step.c), dtype=torch.float32,
                        device=device)
        tables, flags = _tc_device_tables(step, tuple(A.stride()),
                                          tuple(B.stride()), tuple(C.stride()),
                                          device)
        rows, cols = (B, A) if shape.swap else (A, B)
        launch(getattr(lib, name), rows.data_ptr(), cols.data_ptr(),
               C.data_ptr(), tables.data_ptr(), shape.Mc, shape.Nc, shape.K,
               shape.ncells, flags, shape.variant)
        return C
    return launch_frame(name, device, lambda: plain(A, B, step), body)

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
    _check_smem("lane_pack_dg_f32", lane_pack_dg_smem_bytes(shape.gi, split))


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
    return _lp_launch("lane_pack_dg_f32", lane_pack_dg_plain, rows, shape,
                      block_long, out_order, one_launch)


def lane_pack_dg_3xtf32(rows: Sequence[LanePackDGRow],
                        shape: LanePackDGShape, *, block_long: int,
                        out_order: tuple = (0, 1, 2),
                        one_launch: bool = True) -> list:
    """``lane_pack_dg_f32`` with both dots in three passes over the TF32
    split (``lo·hi + hi·lo + hi·hi``, on the CUDA cores: the products of
    TF32 halves are exact in f32): the ``bf16_3x`` precision; the same
    arguments and outputs."""
    return _lp_launch("lane_pack_dg_3xtf32", lane_pack_dg_3x_plain, rows,
                      shape, block_long, out_order, one_launch, split=True)


def _lp_launch(name: str, plain, rows: Sequence[LanePackDGRow],
               shape: LanePackDGShape, block_long: int, out_order: tuple,
               one_launch: bool, split: bool = False) -> list:
    """Launch the kernel *name*, ``lane_pack_dg_f32`` or (*split*) its 3x
    variant; *plain* for CPU tensors."""
    if not rows:
        return []
    E, GI, GJ, PK = _lp_dims(rows, shape)
    device = rows[0].u.device
    if sorted(out_order) != [0, 1, 2]:
        raise ValueError(f"out_order {out_order} is not a permutation of 3")

    def body(lib, launch):
        check_lane_pack_dg_shape(shape, split)
        _check_block_long(block_long)
        M, NW, NO = len(shape.u_of_m), len(shape.j_of_w), shape.n_out
        dims = (NO, E, GI)
        inverse = tuple(sorted(range(3), key=lambda a: out_order[a]))
        outs = [torch.empty(tuple(dims[a] for a in out_order),
                            dtype=torch.float32, device=device) for _ in rows]
        pairs = (ctypes.c_int * (3 * len(shape.pairs)))(
            *[v for term in shape.pairs for v in term])
        n_off = 2 * M + 2 * NW + NO
        for idx in _launch_rows(len(rows), one_launch,
                                lib.lane_pack_dg_max_rows):
            ptrs = (ctypes.c_void_p * (5 * len(idx)))()
            strides = (ctypes.c_int64 * (10 * len(idx)))()
            offsets = (ctypes.c_int64 * (n_off * len(idx)))()
            for n, r in enumerate(idx):
                row, out = rows[r], outs[r].permute(*inverse)
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
            launch(getattr(lib, name), len(idx), ptrs, strides, offsets, pairs,
                   M, NW, NO, len(shape.pairs), E, GI, GJ, PK, int(block_long))
        return outs
    return launch_frame(name, device, lambda: plain(rows, shape, out_order),
                        body)

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


@functools.lru_cache(maxsize=64)
def _sb_stream_shape(table) -> Optional[tuple]:
    """``(NM, NK)`` of a table the stream path can run: one dense element
    step over two streamed inputs (no resident), with no batch letter and
    a result over one operand's letters alone (M, or N when M is empty),
    NM result entries and NK contracted entries an element, each up to
    ``SB_STREAM_MAX``; ``None`` for any other table."""
    if table.el is None or len(table.steps) != 1 \
            or any(table.el not in letters for letters in table.inputs):
        return None
    (step,) = table.steps
    if step.kind != "element" or step.mode != "dense":
        return None
    M, N, K, B = step.split
    if B or (M and N):
        return None
    length = table.length
    nm = math.prod(length[ix] for ix in M or N)
    nk = math.prod(length[ix] for ix in K)
    if nm > SB_STREAM_MAX or nk > SB_STREAM_MAX:
        return None
    return nm, nk


@functools.lru_cache(maxsize=64)
def _sb_lanes_plan(table):
    """The lanes-path plan of *table*
    (:func:`~feinsum_tpu_torch.ops.step_block.plan_lanes`), ``None`` where
    the path cannot run it."""
    from .step_block import plan_lanes
    return plan_lanes(table)


def step_block_path(table, in_strides: tuple, out_strides: tuple,
                    tensors) -> str:
    """The path a ``step_block_f32`` launch takes, its key in
    ``tracing.counters["step_block_mode"]``: ``"stream"`` when the stream
    path can run the table (:func:`_sb_stream_shape`), ``"lanes"`` when
    the lanes path can (:func:`_sb_lanes_plan`: every step dense, none
    that reduces; :mod:`~feinsum_tpu_torch.ops.step_block`), in either case
    only where the long letter lies at stride 1 in every streamed input
    (strides *in_strides*) and in the output view (*out_strides*), and
    every entry stride of those and every pointer of *tensors* (the
    launch's inputs and outputs) lies on 16 bytes, and for the lanes path
    the long axis's length is a multiple of 4; else the table's mode,
    ``"dense"`` or ``"general"`` (the block kernel).  The one place the
    choice is made: the C entry takes it as given."""
    if _sb_stream_shape(table) is not None:
        path = "stream"
    elif _sb_lanes_plan(table) is not None:
        path = "lanes"
    else:
        return table.mode
    el = table.el
    views = [*((letters, st) for letters, st in zip(table.inputs, in_strides)
               if el in letters), (table.steps[-1].out, out_strides)]
    for letters, strides in views:
        per, es = _sb_strides(letters, strides, el)
        if es != 1 or any(st % 4 for st in per.values()):
            return table.mode
    if any(t.data_ptr() % 16 for t in tensors):
        return table.mode
    if path == "lanes":
        slot = next(s for s, letters in enumerate(table.inputs)
                    if el in letters)
        if tensors[slot].shape[table.inputs[slot].index(el)] % 4:
            return table.mode
    return path


def _sb_row_strides(rows: tuple, length: dict) -> dict:
    """Strides per letter of a region whose rows run over *rows*, slowest
    first, compact."""
    per, stride = {}, 1
    for ix in reversed(rows):
        per[ix] = stride
        stride *= length[ix]
    return per


@functools.lru_cache(maxsize=64)
def step_block_lanes_tables(table, in_strides: tuple, out_strides: tuple,
                            plan=None) -> tuple:
    """``(meta, tables, maps)`` of the lanes path (``csrc/step_block.cu``,
    ``step_block_lanes``) for one row whose input views and output view
    have these strides, by *plan* (default :func:`_sb_lanes_plan`'s).

    ``tables`` (int64) holds each resident's gather offsets into its
    packed copy (-1: a zero of the padding), the last step's output
    offsets over X's, W's and the batch entries, and the ints for shared
    memory: each step's tables (X's rows over its free entries and the
    batch, W's likewise when it is per element, a resident W's packed
    offset per batch entry, the result's rows over X's, W's and the batch
    entries: in rows of an intermediate's region, zero for the last step).
    ``maps`` gives each streamed region's TMA tensor map: its rank (one
    more than its letters), then each letter's entries and stride in its
    input, the fastest row letter first, padded to ``SB_LANE_MAX_LETTERS``
    letters.

    ``meta`` (ints): the header (steps, regions, ``te``, two buffers, the
    ints of the tables and where they start in ``tables``, threads a
    block), then per step
    (X's region; W's region or the resident's input slot; W resident; X,
    W, batch and contracted entries; RX, RW; X and W tiles; X's
    contracted stride in rows, W's in rows or in floats of the packed
    resident; the int offset of its tables in shared memory; the region
    of its result, -1 for the output; the output tables' offset in
    ``tables``; the packed resident's float offset in shared memory, its
    floats and its gather table's offset in ``tables``; 1 for the first
    step of a chained pair, 2 for the second, else 0), then per region
    (float offset in shared memory, on 128 bytes, the second buffer's or
    -1, rows, the input slot or -1, its map or -1, and the step after
    which one buffer is refilled or -1).

    A chained pair's first step has no result tables (zeros) and packs its
    resident per tile of the pair's units: a batch entry of the second
    step and RM of its free entries on the first result's side, each
    tile's RW floats the second step's contracted entries on W's side
    times the RM entries (-1 past the last of them); its second step's X
    is its per-element operand, and its W, the first step's result, has no
    region (zeros in its tables).  Both steps' X rows over their free
    entries are consecutive (the kernel reads them at one offset).  Where
    the first step's tile carries its batch (``xb``), its batch table
    holds X's row offset of each of the tile's entries, and ``meta``'s
    batch entries are the tile's."""
    from .step_block import (_lane_table_ints, lane_chain_groups,
                             lane_region_base)
    if plan is None:
        plan = _sb_lanes_plan(table)
    el, length = table.el, table.length
    last = len(table.steps) - 1
    te = plan.te
    rows = dict(plan.rows)
    reg_index = {src: i for i, (src, _at, _r) in enumerate(plan.regions)}
    chunks: list = []
    cursor = 0

    def add(arr) -> int:
        nonlocal cursor
        arr = np.asarray(arr, dtype=np.int64).ravel()
        chunks.append(arr)
        cursor += len(arr)
        return cursor - len(arr)

    def count(letters) -> int:
        return int(np.prod([length[ix] for ix in letters], dtype=np.int64))

    # the consumer's row strides of each region, by the axis it names
    reader = {}
    for k, st in enumerate(table.steps):
        for q, src in enumerate(st.operands):
            reader[src] = (k, q)

    def region_strides(src, names) -> dict:
        """Row strides per letter of *names* (one per axis of region
        *src*, as the step at hand names them)."""
        k, q = reader[src]
        mine = _sb_row_strides(rows[src], length)
        return {n: mine[c] for n, c in zip(names, table.steps[k].letters[q])
                if c != el}

    # ints for shared memory, then per step its packing and output
    int_cursor = 0
    int_chunks = []
    step_meta = []
    n_ints = sum(_lane_table_ints(table, ls) for ls in plan.steps)
    packed_base = -(-n_ints // 4) * 4
    packed_cursor = packed_base
    for k, (st, ls) in enumerate(zip(table.steps, plan.steps)):
        xsrc, wsrc = st.operands[ls.x], st.operands[1 - ls.x]
        xnames, wnames = st.letters[ls.x], st.letters[1 - ls.x]
        # a chained first step whose tile carries the batch: X's rows of
        # each tile entry in place of the batch's
        nx, nw, nb, nk = (count(g) for g in (ls.xl, ls.wl, ls.xb or ls.bl,
                                             ls.kl))
        rx, rw = ls.tile
        tx, tw = -(-nx // rx), -(-nw // rw)
        xs = region_strides(xsrc, xnames)
        Xx = _sb_offsets(ls.xl, length, xs)
        Xb = _sb_offsets(ls.xb or ls.bl, length, xs)
        xk = xs[ls.kl[-1]] if ls.kl else 0
        packed = [-1, 0, 0]
        if ls.chain and not np.array_equal(Xx, np.arange(nx)):
            raise AssertionError("a chained step's X rows are not"
                                 " consecutive")
        if ls.chain == 1:
            # the pair's tiles: (batch entry, RM free entries) x (the
            # second step's contracted entries on W's side, RM)
            rm = plan.steps[k + 1].tile[1]
            groups = lane_chain_groups(table, k)
            per, _ = _sb_strides(wnames, in_strides[wsrc[1]], el)
            okw, ob, om = (_sb_offsets(g_, length, per) for g_ in groups)
            tm = -(-len(om) // rm)
            m = np.arange(tm)[:, None] * rm + np.arange(rm)[None, :]
            offs = (ob[:, None, None, None] + okw[None, None, :, None]
                    + om[np.minimum(m, len(om) - 1)][None, :, None, :])
            offs = np.where((m < len(om))[None, :, None, :], offs, -1)
            w = np.full((len(ob), tm, rw), -1, np.int64)
            w[:, :, :offs.shape[2] * rm] = offs.reshape(len(ob), tm, -1)
            w = w.ravel()
            if len(w) != ls.wt * rw:
                raise AssertionError("lanes chain tiles out of count")
            g = np.where(w[None, :] >= 0, _sb_offsets(ls.kl, length, per)
                         [:, None] + w[None, :], -1)
            Wb = np.zeros(nb, np.int64)
            Ww = np.zeros(0, np.int64)
            wk, wreg = len(w), wsrc[1]
            packed = [packed_cursor, g.size, add(g)]
            packed_cursor += g.size
        elif ls.chain == 2:
            # W is the chained first step's result, held in registers
            Ww, Wb = np.zeros(nw, np.int64), np.zeros(nb, np.int64)
            wk, wreg = 0, -1
        elif ls.wres:
            wpad = tw * rw
            Wb = np.arange(nb, dtype=np.int64) * nk * wpad
            Ww = np.zeros(0, np.int64)
            wk = wpad
            wreg = wsrc[1]
            per, _ = _sb_strides(wnames, in_strides[wreg], el)
            w = np.zeros(wpad, np.int64)
            w[:nw] = _sb_offsets(ls.wl, length, per)
            g = (_sb_offsets(ls.bl, length, per)[:, None, None]
                 + _sb_offsets(ls.kl, length, per)[None, :, None]
                 + w[None, None, :])
            g[..., nw:] = -1
            packed = [packed_cursor, g.size, add(g)]
            packed_cursor += g.size
        else:
            ws = region_strides(wsrc, wnames)
            Ww = _sb_offsets(ls.wl, length, ws)
            Wb = _sb_offsets(ls.bl, length, ws)
            wk = ws[ls.kl[-1]] if ls.kl else 0
            wreg = reg_index[wsrc]
        if k == last:
            out_per, _ = _sb_strides(st.out, out_strides, el)
            dg = add(np.concatenate([_sb_offsets(g_, length, out_per)
                                     for g_ in (ls.xl, ls.wl, ls.bl)]))
            Dx, Dw, Db = (np.zeros(count(g_), np.int64)
                          for g_ in (ls.xl, ls.wl, ls.bl))
            dst = -1
        elif ls.chain == 1:
            Dx, Dw, Db = (np.zeros(n_, np.int64) for n_ in (nx, nw, nb))
            dg = dst = -1
        else:
            ds = region_strides(("tmp", k), st.out)
            Dx, Dw, Db = (_sb_offsets(g_, length, ds)
                          for g_ in (ls.xl, ls.wl, ls.bl))
            dg = -1
            dst = reg_index[("tmp", k)]
        tabs = np.concatenate([Xx, Xb, Ww, Wb, Dx, Dw, Db])
        if len(tabs) != _lane_table_ints(table, ls):
            raise AssertionError("lanes tables out of count")
        int_chunks.append(tabs)
        step_meta.append([reg_index[xsrc], wreg, int(ls.wres), nx, nw, nb,
                          nk, rx, rw, tx, ls.wt or tw, int(xk), int(wk),
                          int_cursor, dst, dg, *packed, ls.chain])
        int_cursor += len(tabs)
    ints = np.concatenate(int_chunks) if int_chunks else np.zeros(0, np.int64)
    if int(np.abs(ints).max(initial=0)) >= 2 ** 31:
        raise InvalidParameterError(
            "step_block_f32: a lanes table's offsets exceed 32 bits")

    region_base = lane_region_base(n_ints, packed_cursor - packed_base)
    reg_meta, maps = [], []
    for src, at, refill in plan.regions:
        n = count(rows[src])
        off = region_base + at * te
        second = off + n * te if plan.double and src[0] == "in" else -1
        if src[0] == "in":
            per, _ = _sb_strides(table.inputs[src[1]], in_strides[src[1]],
                                 el)
            k, q = reader[src]
            names = dict(zip(table.steps[k].letters[q], table.inputs[src[1]]))
            # its TMA map: rank, then each letter's entries and stride,
            # the fastest row letter first
            desc = [1 + len(rows[src])]
            for c in reversed(rows[src]):
                desc += [length[c], per[names[c]]]
            desc += [0] * (1 + 2 * SB_LANE_MAX_LETTERS - len(desc))
            reg_meta.append([off, second, n, src[1], len(maps),
                             -1 if plan.double else refill])
            maps.append(desc)
        else:
            reg_meta.append([off, -1, n, -1, -1, -1])
    ints_src = add(ints)
    head = [len(table.steps), len(plan.regions), te, int(plan.double),
            n_ints, ints_src, plan.threads]
    meta = head + [v for m in step_meta for v in m] + [
        v for m in reg_meta for v in m]
    tables = np.concatenate(chunks) if chunks else np.zeros(1, np.int64)
    return tuple(meta), tables, tuple(v for d in maps for v in d)


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
                      elem_fastest: bool, stream: bool = False) -> tuple:
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
    (:func:`_sb_reference`), the smallest stride fastest.

    With *stream* (the stream path, :func:`step_block_path`) nothing is
    staged: every offset, the dense tables' too, is one in the tensors
    themselves, and may pass 32 bits."""
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
        if stream or not table.sin or table.sin[slot] < 0:
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
    staged_out = table.sout >= 0 and not stream
    if staged_out:
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
        if k == last and staged_out:
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
            if not stream and \
                    max(int(np.abs(w).max()) for w in within) >= 2 ** 31:
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
                      stream: bool, device: torch.device) -> tuple:
    """The rows' tables end to end on *device*, and ``(steps_i, steps_t,
    stage_i, stage_t, row_len)`` (equal across rows: the tables' offsets
    depend on the shapes alone)."""
    per_row = [step_block_tables(table, ins, out, elem_fastest, stream)
               for ins, out in row_strides]
    tables = np.concatenate([t[0] for t in per_row])
    _, steps_i, steps_t, stage_i, stage_t = per_row[0]
    return (torch.from_numpy(tables).to(device), steps_i, steps_t, stage_i,
            stage_t, len(per_row[0][0]))


@functools.lru_cache(maxsize=32)
def _sb_lanes_device_tables(table, row_strides: tuple, device: torch.device,
                            plan) -> tuple:
    """The lanes path's ``(meta, tables, row_len, maps)`` by *plan*: the
    rows' tables end to end on *device* (the meta equal across rows: it
    depends on the shapes alone) and their maps' descriptions end to end
    for the C entry."""
    per_row = [step_block_lanes_tables(table, ins, out, plan)
               for ins, out in row_strides]
    tables = np.concatenate([t[1] for t in per_row])
    maps = [v for t in per_row for v in t[2]]
    return (per_row[0][0], torch.from_numpy(tables).to(device),
            len(per_row[0][1]), (ctypes.c_int64 * max(1, len(maps)))(*maps))


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
                   one_launch: bool = True, _lanes_plan=None) -> list:
    """Each row's output of the step table *table*
    (:class:`~feinsum_tpu_torch.ops.step_block.StepTable`) from its input
    views (one per slot, axes in the order of ``table.inputs``), allocated
    contiguous in the stored order ``table.stored_out``.  All rows go in
    one launch (two for a contracted long axis; up to the kernel's row
    limit) unless *one_launch* is false; *block_long* elements per thread
    block.  Each launch counts under its path (:func:`step_block_path`:
    ``"stream"`` or ``"lanes"``, else the table's mode) in
    ``tracing.counters["step_block_mode"]``, and the path names its
    span; a lanes launch counts its chained pairs in
    ``tracing.counters["lane_chains"]``.  *_lanes_plan* replaces the lanes
    path's plan (:func:`_sb_lanes_plan`'s)."""
    if not rows:
        return []
    E = _sb_check(rows, table)
    device = rows[0][0].device

    def body(lib, launch):
        _check_block_long(block_long)
        _check_smem("step_block_f32", table.smem_bytes)
        el, length = table.el, table.length
        last = table.steps[-1]
        out_shape = tuple(E if ix == el else length[ix]
                          for ix in table.stored_out)
        perm = [table.stored_out.index(ix) for ix in last.out]
        outs = [torch.empty(out_shape, dtype=torch.float32, device=device)
                for _ in rows]
        views = [o.permute(tuple(perm)) for o in outs]
        ins = [[t if table.stage[s] < 0 or _is_flat(t) else t.contiguous()
                for s, t in enumerate(row)] for row in rows]
        elem_fastest = step_block_mode(
            table, tuple(tuple(t.stride()) for t in ins[0]),
            tuple(views[0].stride()))
        paths = {step_block_path(table, tuple(tuple(t.stride()) for t in row),
                                 tuple(view.stride()), (*row, view))
                 for row, view in zip(ins, views)}
        path = paths.pop() if len(paths) == 1 else table.mode
        stream = path == "stream"
        ni, ns = len(table.inputs), len(table.steps)
        nblocks = -(-E // int(block_long))
        for idx in _launch_rows(len(ins), one_launch,
                                lib.step_block_f32_max_rows):
            ptrs = (ctypes.c_void_p * ((ni + 1) * len(idx)))()
            for n, r in enumerate(idx):
                ptrs[(ni + 1) * n:(ni + 1) * (n + 1)] = [
                    *(t.data_ptr() for t in ins[r]), views[r].data_ptr()]
            if path == "lanes":
                plan = _lanes_plan or _sb_lanes_plan(table)
                meta, tables, row_len, maps = _sb_lanes_device_tables(
                    table, _sb_view_strides([ins[r] for r in idx],
                                            [views[r] for r in idx]),
                    device, plan)
                launch(lib.step_block_lanes_f32, len(idx), ni, ptrs,
                       (ctypes.c_int * len(meta))(*meta), len(meta), maps,
                       ctypes.c_void_p(tables.data_ptr()), row_len, E,
                       -(-int(block_long) // plan.te) * plan.te,
                       plan.smem_floats, path=path)
                tracing.counters["lane_chains"] += len(plan.chains)
                continue
            tables, steps_i, steps_t, stage_i, stage_t, row_len = \
                _sb_device_tables(
                table, _sb_view_strides([ins[r] for r in idx],
                                        [views[r] for r in idx]),
                elem_fastest, stream, device)
            es = (ctypes.c_int64 * ((ni + 1) * len(idx)))()
            for n, r in enumerate(idx):
                es[(ni + 1) * n:(ni + 1) * (n + 1)] = [
                    *(_sb_strides(letters, t.stride(), el)[1]
                      for letters, t in zip(table.inputs, ins[r])),
                    _sb_strides(last.out, views[r].stride(), el)[1]]
            work = None
            if last.kind == "reduce":
                work = torch.empty(len(idx) * nblocks * table.n_out(last),
                                   dtype=torch.float32, device=device)
            launch(lib.step_block_f32,
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
                   table.smem_floats, int(stream),
                   ctypes.c_void_p(None if work is None else work.data_ptr()),
                   path=path)
        return outs
    return launch_frame("step_block_f32", device,
                        lambda: step_block_plain(rows, table, block_long),
                        body)

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

    def body(lib, launch):
        _check_smem("tc_steps_f32", table.smem_bytes)
        length = table.length
        out = torch.empty(tuple(length[ix] for ix in table.stored_out),
                          dtype=torch.float32, device=device)
        view = out.permute(tuple(table.stored_out.index(ix)
                                 for ix in table.out))
        tables, steps_i, steps_t, grid = _ts_device_tables(
            table, tuple(tuple(t.stride()) for t in ops), tuple(view.stride()),
            device)
        ns = len(table.steps)
        launch(lib.tc_steps_f32,
               len(ops), (ctypes.c_void_p * len(ops))(*[t.data_ptr()
                                                       for t in ops]),
               view.data_ptr(), ns,
               (ctypes.c_int * (ns * (5 + TS_MAX_OPS)))(
                   *[v for s in steps_i for v in s]),
               (ctypes.c_int * (ns * (2 * TS_MAX_OPS + 1)))(
                   *[v for s in steps_t for v in s]),
               len(grid), (ctypes.c_int64 * sum(map(len, grid)))(
                   *[v for g in grid for v in g]),
               ctypes.c_void_p(tables.data_ptr()), table.ncells,
               table.threads, table.smem_floats)
        return out
    return launch_frame("tc_steps_f32", device,
                        lambda: tc_steps_plain(ops, table), body)

# }}}
