"""
Second transform space of dense tensor contractions on the hand-written
kernels (the port of K2): a CUDA grid over the leading ``n_grid`` output
letters with per-letter blocks, and an explicit row letter.  One step of
two operands runs on ``tc_grid_f32``, any other schedule per cell on
``tc_steps_f32`` (``ops/tc_emitter.py``).

The file name, parameters and descriptor fields are those of
``feinsum_tpu``'s space, so each of its facts binds and replays here.  The
search space declares only what changes the launched kernel on Hopper:

* ``n_grid``: the grid letters (how many leading output letters the CUDA
  grid walks);
* ``blk0_idx``, ``blk1_idx``: the blocks of the first two grid letters (a
  divisor of the length, by index), which set each cell's M x N shape, the
  tile shape and the number of cells;
* ``m_pos``: ``grid_m``, the output letter whose operand gives the tile's
  rows and which runs fastest along them (the access order of that operand
  and of the output);
* ``precision_idx``: ``("default", "bf16_3x")``: ``tc_grid_f32`` in IEEE
  f32, or ``tc_grid_3xtf32``, the tile's inner product in three TF32
  tensor-core passes over an f32 hi/lo split (a ``tc_steps_f32`` program
  runs f32 at either);
* ``use_opt_path`` on an einsum of three or more operands only: the
  optimal-path schedule (a step per pair of operands, the terms it was
  chosen for) or the trivial one (one step over all operands).

Accepted and not searched, because they do not change the kernel:
``mstack`` (stacking output slices into the TPU MXU's M dimension; the
descriptor carries it and the kernels ignore it) and, on two operands,
``use_opt_path`` (the schedule is one step either way, and ``grid_m`` fixes
the row operand).

What changed for Hopper: the reference's VMEM guard, its unrolled-body
guard and its Mosaic refusals (a gridded letter among an operand's or the
output's last two stored dims; an operand carrying all of M, K and N) do not
bind a CUDA kernel that tiles every cell or keeps a cell's intermediates in
shared memory; the kernels' own limits take their place
(:func:`._common.guard_tc_grid`), and no ``vmem_limit_bytes`` is set.  The
stored layouts are the reference's: grid letters lead (free for a kernel
that takes a stride per letter) and each operand's dot axis (K, or N for a
K-free operand) trails, so the staged loads run along stride-1 k.
"""

from __future__ import annotations

from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu_torch.contraction_schedule import (
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.einsum import SizeParam
from feinsum_tpu_torch.tuning import BoolParameter, IntParameter, \
    transform_param
from feinsum_tpu_torch.tuning.impls._common import fp32_precision, \
    guard_tc_grid

_PRECISIONS = ("default", "bf16_3x")


def _max_grid_axes(e) -> int:
    return max(1, len(e.out_idx_set) - 2)


def _divisors(n: int) -> list:
    return [d for d in range(1, n + 1) if n % d == 0]


@transform_param("n_grid", lambda e: IntParameter(1, _max_grid_axes(e)))
@transform_param("blk0_idx", lambda e: IntParameter(0, 9))
@transform_param("blk1_idx", lambda e: IntParameter(0, 9))
@transform_param("m_pos",
                 lambda e: IntParameter(0, len(e.out_idx_set) - 1))
@transform_param("precision_idx", lambda e: IntParameter(0, 1))
@transform_param("use_opt_path",
                 lambda e: BoolParameter() if e.n > 2 else None)
def transform(program, n_grid, blk0_idx, blk1_idx, m_pos, precision_idx,
              mstack=False, use_opt_path=False):
    e = program.einsum
    if e.b != 1 or e.all_size_params or len(e.out_idx_set) < 3:
        raise InvalidParameterError(
            "tc_pallas_v1 expects a dense single-row contraction with a"
            " rank>=3 output (rank-2 GEMMs belong to XLA)")
    if any(isinstance(ln, SizeParam) for ln in
           e.index_to_dim_length.values()):
        raise InvalidParameterError("concrete axes only")
    precision = fp32_precision(_PRECISIONS[precision_idx])
    lengths = {ix: int(ln) for ix, ln in e.index_to_dim_length.items()}

    n_grid = min(int(n_grid), _max_grid_axes(e))
    grid_letters = tuple(e.out_idx_set[:n_grid])

    # per-grid-letter blocks for the first two grid letters (divisor grid)
    grid_blocks = []
    for i, idx in enumerate((blk0_idx, blk1_idx)):
        if i >= len(grid_letters):
            break
        divs = _divisors(lengths[grid_letters[i]])
        blk = divs[min(int(idx), len(divs) - 1)]
        if blk > 1:
            grid_blocks.append((grid_letters[i], blk))
    blocks = dict(grid_blocks)

    cell_len = {ix: (blocks.get(ix, 1) if ix in grid_letters else ln)
                for ix, ln in lengths.items()}

    m = e.out_idx_set[int(m_pos)]
    if cell_len[m] <= 1:
        raise InvalidParameterError(
            f"M letter {m!r} has in-cell extent {cell_len[m]}")
    # the N letter the reference's lowering picks (the largest in-cell
    # output letter besides m that is not gridded) and the K letter (the
    # largest contracted letter): they place each operand's trailing axes
    n_pool = [l for l in e.out_idx_set
              if l != m and l not in grid_letters and cell_len[l] > 1]
    if not n_pool:
        raise InvalidParameterError("no lane-axis candidate besides M")
    n = max(n_pool, key=lambda l: cell_len[l])
    contracted = [l for l in lengths if l not in e.out_idx_set]
    if not contracted:
        raise InvalidParameterError("pure expansions belong to tc_gemm_v0")
    k = max(contracted, key=lambda l: lengths[l])

    # the reference's stored orders: grid letters lead, then the unrolled
    # letters, then M (unless gridded), then the operand's dot axis (K, or N
    # for a K-free operand) trailing
    arg_layouts = []
    for pos, idx_set in enumerate(e.in_idx_sets):
        letters = tuple(idx_set)
        trailing = [l for l in (m,) if l in letters
                    and l not in grid_letters]
        second = (k if k in letters else (n if n in letters else None))
        if second is not None:
            trailing.append(second)
        if k in letters and n in letters and m not in trailing:
            trailing = [k, n]
        lead = [l for l in grid_letters if l in letters
                and l not in trailing]
        mid = [l for l in letters
               if l not in trailing and l not in lead]
        perm = tuple(letters.index(l) for l in lead + mid + trailing)
        if perm != tuple(range(len(letters))):
            arg_layouts.append((e.args[0][pos].name, perm))

    schedule = (get_opt_einsum_contraction_schedule(e) if use_opt_path
                else get_trivial_contraction_schedule(e))
    out = program.copy(
        schedule=schedule,
        descriptor=ScheduleDescriptor(
            backend="pallas",
            grid_index=grid_letters,
            grid_blocks=tuple(grid_blocks),
            grid_m=m,
            mstack=bool(mstack),
            arg_layouts=tuple(arg_layouts),
            precision=precision,
            dimension_semantics="parallel"))
    guard_tc_grid(out)
    return out
