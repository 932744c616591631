"""
Tensor-contraction emitter: lower a program whose descriptor has a tuple
``grid_index`` onto ``tc_grid_f32``.

The port of ``feinsum_tpu/ops/pallas_emitter.py::_build_multigrid`` (K2).
It keeps the reference's checks: the grid letters must be concrete output
letters, each ``grid_blocks`` entry must name a grid letter and divide its
length, ``grid_m`` must be an output letter with in-cell extent > 1, and
``fold_long``, ``preblock_args`` and ``flatten`` are refused.  The kernel
takes one contraction step of two operands: a schedule with more steps (a
dense contraction of more than two operands) raises
:class:`InvalidParameterError` (ROADMAP.md queue 1 item 4, multi-step dense
schedules on K2).  Each row of a batched einsum is one launch.  At
``precision="bf16_3x"`` the step runs on ``tc_grid_3xtf32``, the same
tables and tiles with the inner product in three TF32 tensor-core passes;
a failed build or launch raises, as for ``tc_grid_f32``.  The
executable takes and returns tensors in the descriptor's stored layouts;
CPU tensors run the kernel's plain version.
"""

from __future__ import annotations

from ..contraction_schedule import EinsumOperand
from ..diagnostics import InvalidParameterError
from ..einsum import SizeParam
from ..codegen.descriptor import is_split
from .cuda_emitter import KernelPlan
from .kernels import (
    TCStep,
    tc_classify,
    tc_grid_3x_plain,
    tc_grid_3xtf32,
    tc_grid_f32,
    tc_grid_plain,
)
from .layouts import stored_arg_layouts, stored_out_letters


def _check_program(program) -> tuple:
    """The reference's checks of a multi-axis grid; returns the step's two
    operand positions."""
    e = program.einsum
    desc = program.descriptor
    for l in desc.grid_index:
        if l not in e.out_idx_set:
            raise InvalidParameterError(
                f"multi-axis grid letter {l!r} must be an output axis")
        if isinstance(e.index_to_dim_length[l], SizeParam):
            raise InvalidParameterError(
                "multi-axis grids require concrete axes")
    if desc.fold_long > 1 or desc.preblock_args or desc.flatten:
        raise InvalidParameterError(
            "multi-axis grids do not compose with fold/preblock/flatten")
    # block sizes and grid_m are checked on the step (kernels.tc_classify)
    for l, _ in desc.grid_blocks:
        if l not in desc.grid_index:
            raise InvalidParameterError(
                f"grid_blocks letter {l!r} is not a grid letter")
    bad = {str(dt) for dt in e.arg_to_dtype.values()} - {"float32"}
    if bad:
        raise InvalidParameterError(
            f"tc_grid_f32 takes float32 only, got {sorted(bad)}")
    sched = program.schedule
    if sched.nsteps != 1 or len(sched.arguments[0]) != 2 or not all(
            isinstance(a, EinsumOperand) for a in sched.arguments[0]):
        raise InvalidParameterError(
            "tc_grid_f32 runs one contraction step of two operands; dense"
            f" schedules with {sched.nsteps} steps are not ported yet"
            " (ROADMAP queue 1 item 4: multi-step dense schedules on K2)")
    positions = tuple(a.position for a in sched.arguments[0])
    ins, out = sched.subscripts[0].replace(" ", "").split("->")
    if ins.split(",") != ["".join(e.in_idx_sets[p]) for p in positions] \
            or out != "".join(e.out_idx_set):
        raise InvalidParameterError(
            f"tc_grid_f32: step {sched.subscripts[0]!r} renames the"
            " einsum's letters")
    return positions


def tc_step(program, index_to_length: dict) -> tuple:
    """``(step, positions)``: *program*'s contraction step in stored
    letters (:class:`~feinsum_tpu_torch.ops.kernels.TCStep`) and the einsum
    positions of its operands ``A`` and ``B``; raises
    :class:`InvalidParameterError` for what ``tc_grid_f32`` does not
    carry."""
    e = program.einsum
    desc = program.descriptor
    lengths = {ix: int(ln) for ix, ln in index_to_length.items()}
    pos_a, pos_b = _check_program(program)
    stored = stored_arg_layouts(program)
    blocks = {l: int(blk) for l, blk in desc.grid_blocks}
    step = TCStep(
        a=stored[e.args[0][pos_a].name], b=stored[e.args[0][pos_b].name],
        c=stored_out_letters(program), lengths=tuple(sorted(lengths.items())),
        grid=tuple((l, blocks.get(l, 1)) for l in desc.grid_index),
        grid_m=desc.grid_m)
    tc_classify(step)          # the kernel's own refusals, on any device
    return step, (pos_a, pos_b)


def plan_tc_launch(program, index_to_length: dict) -> KernelPlan:
    """Plan *program* (a tuple ``grid_index``) onto ``tc_grid_f32``, or
    ``tc_grid_3xtf32`` at ``bf16_3x``; raises
    :class:`InvalidParameterError` for what the kernel does not carry."""
    e = program.einsum
    lengths = {ix: int(ln) for ix, ln in index_to_length.items()}
    step, (pos_a, pos_b) = tc_step(program, lengths)
    stored = stored_arg_layouts(program)
    names = [(row[pos_a].name, row[pos_b].name) for row in e.args]
    stored_shapes = {name: tuple(lengths[ix] for ix in idx)
                     for name, idx in stored.items()}

    def operands(arrays_by_name: dict) -> list:
        for name, shape in stored_shapes.items():
            if name not in arrays_by_name:
                raise ValueError(f"missing argument {name!r}")
            if tuple(arrays_by_name[name].shape) != shape:
                raise ValueError(
                    f"argument {name!r}: shape"
                    f" {tuple(arrays_by_name[name].shape)}, stored layout"
                    f" {stored[name]} needs {shape}")
        return [(arrays_by_name[a], arrays_by_name[b]) for a, b in names]

    kernel, launch, plain = (
        ("tc_grid_3xtf32", tc_grid_3xtf32, tc_grid_3x_plain)
        if is_split(program.descriptor)
        else ("tc_grid_f32", tc_grid_f32, tc_grid_plain))
    return KernelPlan(
        kernel=kernel, operands=operands,
        run=lambda rows: [launch(A, B, step) for A, B in rows],
        plain=lambda rows: [plain(A, B, step) for A, B in rows])


def build_tc_executable(program, index_to_length: dict):
    """Compile *program* onto ``tc_grid_f32``; returns ``fn(arrays_by_name)
    -> tuple`` of the b row outputs in the stored output layout."""
    plan = plan_tc_launch(program, index_to_length)

    def fn(arrays_by_name: dict):
        return tuple(plan.run(plan.operands(arrays_by_name)))
    return fn
