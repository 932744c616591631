"""
Transform space of dense tensor contractions on the hand-written kernels
(the port of K2): a CUDA grid over the leading ``n_grid`` output letters,
one cell per index combination, each cell's output written in place in the
stored layout, by ``tc_grid_f32`` (one step of two operands, tiled) or
``tc_steps_f32`` (any other schedule, step by step per cell).

The file name, parameters and descriptor fields are those of
``feinsum_tpu``'s space, so its facts bind and replay here.  ``n_grid``
sets the grid letters; ``use_opt_path`` picks the optimal-path or trivial
schedule (on two operands one step either way, the optimal path listing
the operands in another order, which swaps the tile's row and column
operands; on more, a step per pair against one step over all);
``precision_idx`` indexes ``("default", "bf16_3x")``: ``tc_grid_f32``, or
``tc_grid_3xtf32`` (three TF32 tensor-core passes).

What changed for Hopper: the reference's VMEM guard, its unroll guard and
its Mosaic last-two-dims refusal (an operand with fewer than two
non-gridded axes) do not bind a CUDA kernel that tiles every cell; the
kernel's own limits take their place (:func:`._common.guard_tc_grid`).  The
stored layouts are the reference's (grid letters leading): a permutation
costs the kernel nothing, since it takes a stride per letter.
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


@transform_param("n_grid", lambda e: IntParameter(1, _max_grid_axes(e)))
@transform_param("precision_idx", lambda e: IntParameter(0, 1))
@transform_param("use_opt_path", lambda e: BoolParameter())
def transform(program, n_grid, precision_idx, use_opt_path):
    e = program.einsum
    if e.b != 1 or e.all_size_params or len(e.out_idx_set) < 3:
        raise InvalidParameterError(
            "tc_pallas_v0 expects a dense single-row contraction with a"
            " rank>=3 output (rank-2 GEMMs belong to XLA)")
    if any(isinstance(ln, SizeParam) for ln in
           e.index_to_dim_length.values()):
        raise InvalidParameterError("concrete axes only")
    precision = fp32_precision(_PRECISIONS[precision_idx])
    n_grid = min(int(n_grid), _max_grid_axes(e))
    grid_letters = tuple(e.out_idx_set[:n_grid])

    # the reference's storage: gridded letters lead in every operand
    arg_layouts = []
    for pos, idx_set in enumerate(e.in_idx_sets):
        if not any(l in grid_letters for l in idx_set):
            continue
        non_grid = [l for l in idx_set if l not in grid_letters]
        perm = tuple([idx_set.index(l) for l in idx_set
                      if l in grid_letters]
                     + [idx_set.index(l) for l in non_grid])
        if perm != tuple(range(len(idx_set))):
            arg_layouts.append((e.args[0][pos].name, perm))

    schedule = (get_opt_einsum_contraction_schedule(e) if use_opt_path
                else get_trivial_contraction_schedule(e))
    out = program.copy(
        schedule=schedule,
        descriptor=ScheduleDescriptor(
            backend="pallas",
            grid_index=grid_letters,
            arg_layouts=tuple(arg_layouts),
            precision=precision,
            dimension_semantics="parallel"))
    guard_tc_grid(out)
    return out
