"""
Tensor-contraction emitter: lower a program whose descriptor has a tuple
``grid_index`` onto ``tc_grid_f32`` or ``tc_steps_f32``.

The port of ``feinsum_tpu/ops/pallas_emitter.py::_build_multigrid`` (K2).
It keeps the reference's checks: the grid letters must be concrete output
letters, each ``grid_blocks`` entry must name a grid letter and divide its
length, ``grid_m`` must be an output letter with in-cell extent > 1, and
``fold_long``, ``preblock_args`` and ``flatten`` are refused.  Float32
only.  Two kernels share the programs:

* one step of two einsum operands in the einsum's own letters (the TCCG
  rows), with no letter contracted within one operand and no block on a
  batch letter, runs on ``tc_grid_f32``: each cell's output tiled as an
  M x N matrix; at ``precision="bf16_3x"`` on ``tc_grid_3xtf32``, the same
  tables and tiles with the inner product in three TF32 tensor-core passes;
* every other program (several steps, a step of one or of three or more
  operands, steps that rename letters, blocks on a batch letter) runs its
  schedule per cell on ``tc_steps_f32`` (:mod:`~feinsum_tpu_torch.ops.
  tc_steps`), intermediates in shared memory; at ``bf16_3x`` in f32, as
  ``step_block_f32`` does.  ``grid_m`` and ``mstack`` move nothing there.

Each row of a batched einsum is one launch.  A failed build or launch
raises; nothing falls back to a plain version.  The executable takes and
returns tensors in the descriptor's stored layouts; CPU tensors run the
kernels' plain versions.
"""

from __future__ import annotations

from typing import Optional

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
    tc_steps_f32,
    tc_steps_plain,
)
from .layouts import stored_arg_layouts, stored_out_letters
from .tc_steps import plan_tc_steps


def _check_program(program, lengths: dict) -> None:
    """The reference's checks of a multi-axis grid, for either kernel."""
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
    blocks = dict(desc.grid_blocks)
    for l, blk in desc.grid_blocks:
        if l not in desc.grid_index:
            raise InvalidParameterError(
                f"grid_blocks letter {l!r} is not a grid letter")
        if blk < 1 or lengths[l] % blk:
            raise InvalidParameterError(
                f"grid block {blk} does not divide {l}={lengths[l]}")
    m = desc.grid_m
    if m is not None:
        if m not in e.out_idx_set:
            raise InvalidParameterError(
                f"grid_m {m!r} must be an output axis")
        extent = blocks.get(m, 1) if m in desc.grid_index else lengths[m]
        if extent <= 1:
            raise InvalidParameterError(
                f"grid_m {m!r} has in-cell extent {extent}; block it or"
                " leave it ungridded")
    bad = {str(dt) for dt in e.arg_to_dtype.values()} - {"float32"}
    if bad:
        raise InvalidParameterError(
            f"the contraction kernels take float32 only, got {sorted(bad)}")


def _grid_positions(program) -> Optional[tuple]:
    """The einsum positions of the operands ``A`` and ``B`` when *program*
    is ``tc_grid_f32``'s: one step of two einsum operands in the einsum's
    own letters, no letter contracted within one operand and no block on a
    batch letter; else ``None``."""
    e = program.einsum
    sched = program.schedule
    if sched.nsteps != 1 or len(sched.arguments[0]) != 2 or not all(
            isinstance(a, EinsumOperand) for a in sched.arguments[0]):
        return None
    positions = tuple(a.position for a in sched.arguments[0])
    ins, out = sched.subscripts[0].replace(" ", "").split("->")
    a, b = (e.in_idx_sets[p] for p in positions)
    if ins.split(",") != ["".join(a), "".join(b)] \
            or out != "".join(e.out_idx_set):
        return None
    if (set(a) ^ set(b)) - set(out):
        return None
    if any(blk > 1 and l in a and l in b
           for l, blk in program.descriptor.grid_blocks):
        return None
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
    _check_program(program, lengths)
    positions = _grid_positions(program)
    if positions is None:
        raise InvalidParameterError(
            "tc_grid_f32 runs one step of two einsum operands in the"
            f" einsum's letters, not {program.schedule.subscripts}"
            " (tc_steps_f32 runs the others)")
    pos_a, pos_b = positions
    stored = stored_arg_layouts(program)
    blocks = {l: int(blk) for l, blk in desc.grid_blocks}
    step = TCStep(
        a=stored[e.args[0][pos_a].name], b=stored[e.args[0][pos_b].name],
        c=stored_out_letters(program), lengths=tuple(sorted(lengths.items())),
        grid=tuple((l, blocks.get(l, 1)) for l in desc.grid_index),
        grid_m=desc.grid_m)
    tc_classify(step)          # the kernel's own refusals, on any device
    return step, (pos_a, pos_b)


def _stored_check(program, lengths: dict):
    """``check(arrays_by_name)``: raises ``ValueError`` for a missing
    argument or one whose shape is not its stored layout's."""
    stored = stored_arg_layouts(program)
    shapes = {name: tuple(lengths[ix] for ix in idx)
              for name, idx in stored.items()}

    def check(arrays_by_name: dict) -> None:
        for name, shape in shapes.items():
            if name not in arrays_by_name:
                raise ValueError(f"missing argument {name!r}")
            if tuple(arrays_by_name[name].shape) != shape:
                raise ValueError(
                    f"argument {name!r}: shape"
                    f" {tuple(arrays_by_name[name].shape)}, stored layout"
                    f" {stored[name]} needs {shape}")
    return check


def _plan_steps(program, lengths: dict) -> KernelPlan:
    """*program* onto ``tc_steps_f32``: its cell table
    (``ops/tc_steps.py``), each operand a view of its stored tensor in the
    einsum's logical letter order, one launch per row."""
    e = program.einsum
    _check_program(program, lengths)
    table = plan_tc_steps(program, lengths)
    stored = stored_arg_layouts(program)
    check = _stored_check(program, lengths)

    def operands(arrays_by_name: dict) -> list:
        check(arrays_by_name)
        return [[arrays_by_name[a.name].permute(tuple(
                    stored[a.name].index(ix) for ix in idx))
                 for a, idx in zip(row, e.in_idx_sets)] for row in e.args]

    return KernelPlan(
        kernel="tc_steps_f32", operands=operands,
        run=lambda rows: [tc_steps_f32(ops, table) for ops in rows],
        plain=lambda rows: [tc_steps_plain(ops, table) for ops in rows])


def plan_tc_launch(program, index_to_length: dict) -> KernelPlan:
    """Plan *program* (a tuple ``grid_index``) onto ``tc_grid_f32`` (or
    ``tc_grid_3xtf32`` at ``bf16_3x``) when it is one step of two einsum
    operands in the einsum's letters, else onto ``tc_steps_f32``; raises
    :class:`InvalidParameterError` for what the kernels do not carry."""
    e = program.einsum
    lengths = {ix: int(ln) for ix, ln in index_to_length.items()}
    if _grid_positions(program) is None:
        return _plan_steps(program, lengths)
    step, (pos_a, pos_b) = tc_step(program, lengths)
    names = [(row[pos_a].name, row[pos_b].name) for row in e.args]
    check = _stored_check(program, lengths)

    def operands(arrays_by_name: dict) -> list:
        check(arrays_by_name)
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
    """Compile *program* onto ``tc_grid_f32`` or ``tc_steps_f32``; returns
    ``fn(arrays_by_name) -> tuple`` of the b row outputs in the stored
    output layout."""
    plan = plan_tc_launch(program, index_to_length)

    def fn(arrays_by_name: dict):
        return tuple(plan.run(plan.operands(arrays_by_name)))
    return fn
