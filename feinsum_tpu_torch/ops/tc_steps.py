"""
The cell planner of ``tc_steps_f32``: read a dense program with a tuple
``grid_index`` into a cell table.

``tc_steps_f32`` runs K2's whole schedule, the step loop of
``feinsum_tpu/ops/pallas_emitter.py::_build_multigrid`` (``:387-425``,
through ``ops/kernel_lowering.py::lower_step``): per grid cell every
schedule step in order, each step's result the next steps' operand, the
intermediates kept in the cell's VMEM there and in the thread block's
shared memory here, the last step written once into the cell's tile of the
output in its stored layout.  ``ops/tc_emitter.py`` sends it every tuple
``grid_index`` program that ``tc_grid_f32`` (one step of two einsum
operands in the einsum's own letters) does not take.

A cell holds ``block`` consecutive indices of each grid letter (its
``grid_blocks`` entry, default 1); the other letters run whole.  A step's
letters take the in-cell extents of the axes they name, and a step may name
an axis by another letter than the einsum or the producing step does, as
the reference renames its operands' letters (``:404-411``).  The schedule
is honoured step by step: each step's entries are a product of its factors
summed over its own contracted letters, so the kernel does the terms the
schedule was chosen for (on sum factorization ``ai,bj,ck,eabc->eijk``,
3 * 5**4 per element where one step would take 5**6).

Grid letters are output letters, so no step may contract one: a cell's
result is its tile of the output, with no accumulation across cells.
:func:`plan_tc_steps` checks this on each step (a renamed grid letter keeps
its origin), sizes the intermediates in shared memory (an intermediate's
room is reused once its last reader has run) and raises
:class:`InvalidParameterError` naming the limit a program exceeds: steps,
operands per step, letters per step or shared memory.
:func:`tc_steps_tables` builds on the host, from the strides of the views
the kernel receives, each step's int32 offset tables and the cells' base
strides.  This module is framework-free apart from the planner's input, a
program.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod

import numpy as np

from ..diagnostics import InvalidParameterError
from .kernels import (
    MAX_SMEM_BYTES,
    TS_MAX_GRID,
    TS_MAX_INPUTS,
    TS_MAX_LETTERS,
    TS_MAX_OPS,
    TS_MAX_STEPS,
    TS_MAX_TABLE,
    TS_THREADS,
    _sb_offsets,
    _sb_order,
)
from .layouts import stored_out_letters
from .step_block import operand_axes, read_schedule


@dataclass(frozen=True)
class TSStep:
    """One schedule step of a cell table: ``operands`` are ``("in",
    position)`` or ``("tmp", k)``; ``letters`` the step's letters for each
    operand's axes (an einsum operand's in its logical order, a result's in
    its producer's ``out`` order); ``out`` the result's letters;
    ``extent`` the ``(letter, in-cell extent)`` pairs of the step's
    letters; ``dst`` the float offset of the result in shared memory, -1
    for the output."""

    operands: tuple
    letters: tuple
    out: tuple
    extent: tuple
    dst: int

    @property
    def length(self) -> dict:
        return dict(self.extent)

    @property
    def summed(self) -> tuple:
        """The step's contracted letters, in order of appearance."""
        seen = dict.fromkeys(ix for s in self.letters for ix in s)
        return tuple(ix for ix in seen if ix not in self.out)

    @property
    def n_out(self) -> int:
        return prod(self.length[ix] for ix in self.out)

    @property
    def n_sum(self) -> int:
        return prod(self.length[ix] for ix in self.summed)


@dataclass(frozen=True)
class TCStepsTable:
    """A program planned for ``tc_steps_f32``: the einsum operands' logical
    letters (``inputs``, by position), the output's logical and stored
    letters, the einsum's lengths, the cells as ``(letter, block, count)``
    (the last grid letter fastest), the steps, the floats of shared memory
    a cell needs and the threads per block."""

    inputs: tuple
    out: tuple
    stored_out: tuple
    lengths: tuple
    grid: tuple
    steps: tuple
    smem_floats: int
    threads: int

    @property
    def length(self) -> dict:
        return dict(self.lengths)

    @property
    def ncells(self) -> int:
        return prod(count for _, _, count in self.grid)

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_floats

    def terms(self) -> int:
        """Products the kernel sums over all cells: the schedule's work."""
        return self.ncells * sum(st.n_out * st.n_sum for st in self.steps)


def _allocate(sizes: dict, live: dict) -> tuple:
    """Float offsets of the intermediates *sizes* (step -> floats) in shared
    memory, each live over the steps ``live[k] = (first, last)``: the
    lowest offset that overlaps no intermediate live at the same time.
    Returns ``(offsets, floats)``."""
    placed: list = []
    offsets: dict = {}
    for k in sorted(sizes):
        lo, hi = live[k]
        busy = sorted((off, off + n) for j, off, n in placed
                      if live[j][0] <= hi and lo <= live[j][1])
        off = 0
        for a, b in busy:
            if off + sizes[k] <= a:
                break
            off = max(off, b)
        offsets[k] = off
        placed.append((k, off, sizes[k]))
    return offsets, max((off + n for _, off, n in placed), default=0)


def plan_tc_steps(program, index_to_length: dict) -> TCStepsTable:
    """The cell table of *program* (a tuple ``grid_index`` that passed the
    reference's checks, ``ops/tc_emitter.py``) for ``tc_steps_f32``; raises
    :class:`InvalidParameterError` naming the limit the program exceeds or
    the step that breaks the grid."""
    e = program.einsum
    desc = program.descriptor
    sched = program.schedule
    lengths = {ix: int(index_to_length[ix]) for ix in e.index_to_dim_length}
    grid_letters = tuple(desc.grid_index)
    blocks = {ix: int(blk) for ix, blk in desc.grid_blocks}
    if len(grid_letters) > TS_MAX_GRID:
        raise InvalidParameterError(
            f"tc_steps_f32 takes at most {TS_MAX_GRID} grid letters, the"
            f" program has {len(grid_letters)}")
    if e.n > TS_MAX_INPUTS:
        raise InvalidParameterError(
            f"tc_steps_f32 takes at most {TS_MAX_INPUTS} operands per row,"
            f" the einsum has {e.n}")
    if sched.nsteps > TS_MAX_STEPS:
        raise InvalidParameterError(
            f"tc_steps_f32 takes at most {TS_MAX_STEPS} steps, the schedule"
            f" has {sched.nsteps}")
    grid = tuple((ix, blocks.get(ix, 1), lengths[ix] // blocks.get(ix, 1))
                 for ix in grid_letters)
    if prod(count for _, _, count in grid) > 2 ** 31 - 1:
        raise InvalidParameterError(
            "tc_steps_f32: the cells exceed the CUDA grid's 2**31 - 1"
            " blocks")
    cell = {ix: (blocks.get(ix, 1) if ix in grid_letters else n)
            for ix, n in lengths.items()}
    inputs = tuple(tuple(idx) for idx in e.in_idx_sets)
    read = read_schedule(sched, inputs, "tc_steps_f32", TS_MAX_OPS)

    # per step, each result letter's in-cell extent and grid origin (the
    # grid letter its axis walks, or None)
    made: list = []
    drafts: list = []
    for st in read:
        extent: dict = {}
        origin: dict = {}
        for op, s in zip(st.operands, st.letters):
            axes = operand_axes(read, inputs, op)
            for ix, ax in zip(s, axes):
                if op[0] == "in":
                    n, org = cell[ax], (ax if ax in grid_letters else None)
                else:
                    n, org = made[op[1]][ax]
                if extent.setdefault(ix, n) != n \
                        or origin.setdefault(ix, org) != org:
                    raise InvalidParameterError(
                        f"tc_steps_f32: step {st.subs!r} gives letter"
                        f" {ix!r} two different axes")
        if len(set(st.out)) != len(st.out):
            raise InvalidParameterError(
                f"tc_steps_f32: step {st.subs!r} repeats an output letter")
        lost = [ix for ix in extent if ix not in st.out and origin[ix]]
        if lost:
            raise InvalidParameterError(
                f"tc_steps_f32: step {st.subs!r} contracts grid letter"
                f" {origin[lost[0]]!r}; a cell holds a tile of the output")
        if len(extent) > TS_MAX_LETTERS:
            raise InvalidParameterError(
                f"tc_steps_f32 takes at most {TS_MAX_LETTERS} letters per"
                f" step, step {st.subs!r} has {len(extent)}")
        made.append({ix: (extent[ix], origin[ix]) for ix in st.out})
        drafts.append(tuple(sorted(extent.items())))
    last = read[-1]
    if sorted(last.out) != sorted(e.out_idx_set) or any(
            made[-1][ix][1] != (ix if ix in grid_letters else None)
            for ix in last.out):
        raise InvalidParameterError(
            f"tc_steps_f32: the last step's output {last.out} is not the"
            f" einsum's {tuple(e.out_idx_set)}")

    # shared memory: each intermediate from its step to its last reader
    nlast = len(read) - 1
    sizes = {k: prod(dict(drafts[k])[ix] for ix in st.out)
             for k, st in enumerate(read) if k != nlast}
    live = {k: (k, max([j for j, later in enumerate(read)
                        if ("tmp", k) in later.operands], default=k))
            for k in sizes}
    offsets, floats = _allocate(sizes, live)
    if 4 * floats > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"tc_steps_f32 needs {4 * floats} bytes of shared memory per"
            f" cell for the schedule's intermediates; a Hopper block has"
            f" {MAX_SMEM_BYTES}")
    steps = tuple(TSStep(operands=st.operands, letters=st.letters,
                         out=st.out, extent=drafts[k],
                         dst=offsets.get(k, -1))
                  for k, st in enumerate(read))
    widest = max(st.n_out for st in steps)
    threads = min(TS_THREADS, 32 * -(-widest // 32))
    table = TCStepsTable(
        inputs=inputs, out=tuple(e.out_idx_set),
        stored_out=tuple(stored_out_letters(program)),
        lengths=tuple(sorted(lengths.items())), grid=grid, steps=steps,
        smem_floats=floats, threads=threads)
    entries = sum(st.n_out * (len(st.operands) + 1)
                  + (st.n_sum * len(st.operands) if len(st.summed) > 1
                     else 0) for st in steps)
    if entries > TS_MAX_TABLE:
        raise InvalidParameterError(
            f"tc_steps_f32's offset tables of a cell would hold {entries}"
            f" entries; at most {TS_MAX_TABLE} (grid or block the output"
            " further)")
    return table


def _letter_strides(letters, axis_strides) -> dict:
    """Stride per letter of a tensor whose axes carry *letters* and have
    *axis_strides*; a letter on several axes (a diagonal) sums them."""
    out: dict = {}
    for ix, st in zip(letters, axis_strides):
        out[ix] = out.get(ix, 0) + int(st)
    return out


def tc_steps_tables(table: TCStepsTable, in_strides: tuple,
                    out_strides: tuple) -> tuple:
    """``(tables, steps_i, steps_t, grid)`` of ``tc_steps_f32`` for input
    views and an output view with these strides (elements per axis, the
    inputs' in their logical letter order ``table.inputs``, the output's in
    ``table.out``).

    ``tables`` (int32) holds per step each operand's offsets of the step's
    output entries, the result's, then each operand's offsets of the
    contracted entries (none for a step that contracts at most one letter,
    "affine": its offsets are c times the letter's stride); ``steps_i``
    gives per step (operands, output entries, contracted entries, affine,
    the operand sources padded to ``TS_MAX_OPS``, the result's float offset
    in shared memory or -1); ``steps_t`` per step the table offsets (the
    operands' and the result's entry tables, then the operands' contracted
    tables, or their strides of the contracted letter when affine);
    ``grid`` per grid letter its count of cells and each input's and the
    output's stride times the block.  A step's entries run in the order of
    its reference tensor's strides, the smallest stride fastest: the
    output for the last step, else its einsum operand with the most
    in-cell entries (else its first operand); an intermediate is laid out
    contiguous in that order.  Raises :class:`InvalidParameterError` when
    a cell's offsets do not fit in int32."""
    in_st = [_letter_strides(letters, st)
             for letters, st in zip(table.inputs, in_strides)]
    out_st = _letter_strides(table.out, out_strides)
    nlast = len(table.steps) - 1
    made: list = []          # per step, its result's stride per letter
    chunks, steps_i, steps_t = [], [], []
    cursor = 0

    def add(arr: np.ndarray) -> int:
        nonlocal cursor
        chunks.append(arr)
        cursor += len(arr)
        return cursor - len(arr)

    for k, step in enumerate(table.steps):
        length = step.length
        ops = []
        for (kind, x), letters in zip(step.operands, step.letters):
            if kind == "in":
                per = [in_st[x][ax] for ax in table.inputs[x]]
            else:
                per = [made[x][ax] for ax in table.steps[x].out]
            ops.append(_letter_strides(letters, per))
        sizes = [prod(length[ix] for ix in set(s)) for s in step.letters]
        ins = [q for q, (kind, _) in enumerate(step.operands) if kind == "in"]
        if k == nlast:
            ref = {ix: out_st[ix] for ix in step.out}
        else:
            ref = ops[max(ins, key=lambda q: sizes[q])] if ins else ops[0]
        out_order = _sb_order(step.out, ref)
        if k == nlast:
            dst = ref
        else:
            dst, stride = {}, 1
            for ix in reversed(out_order):
                dst[ix] = stride
                stride *= length[ix]
        made.append(dst)
        carriers = [q for q, s in enumerate(step.letters)
                    if set(s) & set(step.summed)]
        sum_ref = ops[max(carriers, key=lambda q: sizes[q])] \
            if carriers else {}
        sum_order = _sb_order(step.summed, sum_ref)
        t_out = [add(_sb_offsets(out_order, length, st)) for st in ops]
        t_out.append(add(_sb_offsets(out_order, length, dst)))
        affine = len(sum_order) <= 1
        if affine:
            t_sum = [st.get(sum_order[0], 0) if sum_order else 0
                     for st in ops]
        else:
            t_sum = [add(_sb_offsets(sum_order, length, st)) for st in ops]
        nops = len(step.operands)
        pad = [0] * (TS_MAX_OPS - nops)
        src = [x if kind == "in" else -1 - x for kind, x in step.operands]
        steps_i.append([nops, step.n_out, step.n_sum, int(affine),
                        *src, *pad, step.dst])
        steps_t.append([*t_out, *pad, *t_sum, *pad])
    tables = np.concatenate(chunks)
    if int(np.abs(tables).max(initial=0)) > 2 ** 31 - 1 or any(
            abs(v) > 2 ** 31 - 1 for row in steps_t for v in row):
        raise InvalidParameterError(
            "tc_steps_f32: a cell's offsets exceed the int32 tables")
    grid = [[count] + [blk * st.get(ix, 0) for st in in_st]
            + [blk * out_st[ix]] for ix, blk, count in table.grid]
    return tables.astype(np.int32), steps_i, steps_t, grid
