"""
The step planner of ``step_block_f32``: read a program's schedule into a
step table.

``step_block_f32`` runs K1's general step algebra, the part of
``feinsum_tpu/ops/pallas_emitter.py::build_pallas_executable`` that
evaluates every schedule step of a one-long-axis einsum on a block of the
long axis (``row_result``, ``:812-887``, through ``ops/kernel_lowering.py::
lower_step``).  The CUDA emitter sends it the programs that no row family
takes by structure (``ops/cuda_emitter.py``).  This module is
framework-free apart from the planner's input, a program.

The schedule is honoured step by step, as the reference's ``row_result``
does: each step is one product summed over its contracted letters, and its
result is the next steps' operand.  Summing over every contracted letter at
once would change the work the schedule was chosen for (on sum
factorization ``ai,bj,ck,eabc->eijk``, 5**6 terms per element against the
three-step schedule's 3 * 5**4).

A step is of one of three kinds:

* ``"element"``: its result carries the long axis e.  The kernel computes it
  for a sub-tile of ``te`` elements at a time; a result that a later step
  reads is held in shared memory, one entry per element of the sub-tile;
  the last step's result is the row's output, written in its stored layout.
* ``"reduce"``: its operands carry e and its result does not (a contracted
  long axis, ``ej,j->``, ``ei,ej->ij``).  It must be the last step.  Each
  thread block sums its elements into per-block partials, which a second
  launch sums in a fixed order: the reference accumulates across its grid
  steps instead (``:888-921``).
* ``"free"``: no operand carries e, transitively (a resident-only step that
  ``descriptor.hoist_resident_steps`` did not hoist).  The kernel computes
  it once per thread block, as the reference does once per grid step.

Operands without e (residents) are staged in shared memory once per block.
A sub-tile's streamed inputs and output are kept within 96 KB, so that a
step's terms reread them from L1.  The shared memory of a block is the
staged residents, the results of the free steps, a reduce step's partial
sums and the intermediate results of a sub-tile of elements: the
counterpart of the reference's
``schedule_intermediates_vmem_bytes`` / ``estimate_block_vmem_bytes``
(``:91-185``).  :func:`plan_step_block` picks the largest sub-tile that
fits and raises :class:`InvalidParameterError` naming the limit a program
exceeds: steps, operands per step, operands per row, letters per step, or
shared memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod

from ..contraction_schedule import EinsumOperand
from ..diagnostics import InvalidParameterError
from ..einsum import SizeParam
from .kernels import (
    MAX_SMEM_BYTES,
    SB_L1_TARGET,
    SB_MAX_INPUTS,
    SB_MAX_LETTERS,
    SB_MAX_OPS,
    SB_MAX_STEPS,
    SB_MAX_TE,
    SB_SMEM_TARGET,
    SB_THREADS,
)
from .layouts import stored_out_letters


@dataclass(frozen=True)
class SBStep:
    """One schedule step of a step table.  ``operands`` are ``("in",
    slot)`` (the row's input *slot*) or ``("tmp", k)`` (step k's result);
    ``letters`` gives each operand's letters, one per axis in the operand's
    axis order (an input's is its einsum subscript, a result's the order of
    its producer's ``out``); ``out`` is the result's letters; ``dst`` the
    float offset of the result in shared memory, -1 for the row's output.
    """

    kind: str
    operands: tuple
    letters: tuple
    out: tuple
    dst: int


@dataclass(frozen=True)
class StepTable:
    """A program planned for ``step_block_f32``: the long letter ``el``,
    the lengths of the other letters, each input slot's letters (the axis
    order of the view the kernel reads, the einsum's own), the float offset
    of each staged (resident) input in shared memory (-1: streamed), the
    steps, the output's stored letters, the elements per sub-tile ``te``
    and the floats of shared memory one block needs."""

    el: str
    lengths: tuple
    inputs: tuple
    stage: tuple
    steps: tuple
    stored_out: tuple
    te: int
    smem_floats: int

    @property
    def length(self) -> dict:
        return dict(self.lengths)

    def n_out(self, step: SBStep) -> int:
        """Entries of the step's result per element."""
        return prod(self.length[ix] for ix in step.out if ix != self.el)

    def summed(self, step: SBStep) -> tuple:
        """The step's contracted short letters, in order of appearance."""
        seen = dict.fromkeys(ix for letters in step.letters for ix in letters)
        return tuple(ix for ix in seen
                     if ix != self.el and ix not in step.out)

    def n_sum(self, step: SBStep) -> int:
        return prod(self.length[ix] for ix in self.summed(step))

    @property
    def smem_bytes(self) -> int:
        return 4 * self.smem_floats


@dataclass(frozen=True)
class ScheduleStep:
    """One step of a schedule as the kernels read it: ``operands`` are
    ``("in", position)`` (an einsum operand) or ``("tmp", k)`` (step k's
    result), ``letters`` the step's letters for each operand's axes, in the
    operand's axis order (an einsum operand's is its logical order, a
    result's the order of its producer's ``out``), and ``out`` the result's
    letters.  A step may name an axis by another letter than the einsum
    or the producing step does."""

    operands: tuple
    letters: tuple
    out: tuple
    subs: str


def read_schedule(schedule, inputs: tuple, kernel: str,
                  max_ops: int) -> tuple:
    """The steps of *schedule* (:class:`ScheduleStep`) over einsum operands
    whose letters are *inputs*; raises :class:`InvalidParameterError` (naming
    *kernel*) for a step of more than *max_ops* operands, an operand whose
    rank its subscript does not match, and an output letter that no operand
    of the step carries."""
    step_of: dict = {}
    steps: list = []
    for subs, name, args in zip(schedule.subscripts, schedule.result_names,
                                schedule.arguments):
        ins, out = subs.replace(" ", "").split("->")
        ins = ins.split(",")
        if len(args) > max_ops:
            raise InvalidParameterError(
                f"{kernel} takes at most {max_ops} operands per"
                f" step, step {subs!r} has {len(args)}")
        operands = tuple(("in", a.position) if isinstance(a, EinsumOperand)
                         else ("tmp", step_of[a.name]) for a in args)
        for op, s in zip(operands, ins):
            axes = operand_axes(steps, inputs, op)
            if len(s) != len(axes):
                raise InvalidParameterError(
                    f"{kernel}: step {subs!r} gives an operand of rank"
                    f" {len(axes)} the subscript {s!r}")
        if not set(out) <= set("".join(ins)):
            raise InvalidParameterError(
                f"{kernel}: step {subs!r} has an output letter that no"
                " operand carries")
        step_of[name] = len(steps)
        steps.append(ScheduleStep(operands=operands,
                                  letters=tuple(tuple(s) for s in ins),
                                  out=tuple(out), subs=subs))
    return tuple(steps)


def operand_axes(steps, inputs: tuple, operand: tuple) -> tuple:
    """The letters of *operand*'s axes where it is made: an einsum
    operand's own, a result's its step's ``out``."""
    kind, x = operand
    return tuple(inputs[x]) if kind == "in" else steps[x].out


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def plan_step_block(program, index_to_length: dict,
                    block_long: int = None) -> StepTable:
    """The step table of *program* (its schedule's steps, after any
    hoisting) for ``step_block_f32`` at *block_long* elements per thread
    block (default: the descriptor's); raises :class:`InvalidParameterError`
    naming the limit the program exceeds."""
    e = program.einsum
    sched = program.schedule
    if block_long is None:
        block_long = program.descriptor.block_long
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError(
            "step_block_f32 needs exactly one long (SizeParam) axis, found"
            f" {long_letters}")
    (el,) = long_letters
    if e.n > SB_MAX_INPUTS:
        raise InvalidParameterError(
            f"step_block_f32 takes at most {SB_MAX_INPUTS} operands per row,"
            f" the einsum has {e.n}")
    if sched.nsteps > SB_MAX_STEPS:
        raise InvalidParameterError(
            f"step_block_f32 takes at most {SB_MAX_STEPS} steps, the schedule"
            f" has {sched.nsteps}")
    inputs = tuple(tuple(idx) for idx in e.in_idx_sets)
    length = {ix: int(index_to_length[ix]) for ix in e.index_to_dim_length
              if ix != el}

    def bind(letter: str, axis_len, axis_is_long: bool) -> None:
        """Record *letter*'s length from an operand axis, checking that the
        long axis keeps its letter and the lengths agree."""
        if (letter == el) != axis_is_long:
            raise InvalidParameterError(
                f"step_block_f32: a step renames the long axis {el!r}")
        if letter == el:
            return
        if length.setdefault(letter, axis_len) != axis_len:
            raise InvalidParameterError(
                f"step_block_f32: letter {letter!r} has lengths"
                f" {length[letter]} and {axis_len} in the schedule")

    carries: list = []
    drafts: list = []
    read = read_schedule(sched, inputs, "step_block_f32", SB_MAX_OPS)
    for st in read:
        carry = False
        for op, s in zip(st.operands, st.letters):
            axes = operand_axes(read, inputs, op)
            carry |= el in axes if op[0] == "in" else carries[op[1]]
            for ix, ax in zip(s, axes):
                bind(ix, length.get(ax), ax == el)
        used = {ix for s in st.letters for ix in s}
        short = used - {el}
        if len(short) > SB_MAX_LETTERS:
            raise InvalidParameterError(
                f"step_block_f32 takes at most {SB_MAX_LETTERS} letters per"
                f" step besides the long axis, step {st.subs!r} has"
                f" {len(short)}")
        if not carry:
            kind = "free"
        elif el in st.out:
            kind = "element"
        else:
            kind = "reduce"
        carries.append(carry)
        drafts.append((kind, st.operands, st.out, st.letters, st.subs))

    last = len(drafts) - 1
    for k, (kind, _ops, out, _letters, subs) in enumerate(drafts):
        if kind == "reduce" and k != last:
            raise InvalidParameterError(
                f"step_block_f32: step {subs!r} contracts the long axis"
                " before the last step")
    if drafts[last][0] == "free":
        raise InvalidParameterError(
            "step_block_f32: no step of the schedule carries the long axis")
    if set(drafts[last][2]) != set(e.out_idx_set):
        raise InvalidParameterError(
            f"step_block_f32: the last step's output {drafts[last][2]} is"
            f" not the einsum's {tuple(e.out_idx_set)}")

    def n_out(out) -> int:
        return prod(length[ix] for ix in out if ix != el)

    # shared memory: staged residents, free results, the reduce step's
    # partial sums, then the element steps' results per sub-tile
    offset = 0
    stage = []
    for slot, axes in enumerate(inputs):
        if el in axes:
            stage.append(-1)
            continue
        stage.append(offset)
        offset += prod(length[ix] for ix in axes)
    fixed_dst: dict = {}
    for k, (kind, _ops, out, _letters, _subs) in enumerate(drafts):
        if kind == "free":
            fixed_dst[k] = offset
            offset += n_out(out)
        elif kind == "reduce":
            fixed_dst[k] = offset
            n = n_out(out)
            offset += n * max(1, SB_THREADS // n)
    per_te = [(k, n_out(out)) for k, (kind, _o, out, _l, _s)
              in enumerate(drafts) if kind == "element" and k != last]
    per_elem = sum(n for _, n in per_te)

    def floats(te: int) -> int:
        return offset + te * per_elem

    # the sub-tile's streamed inputs and output within L1, so that the
    # terms of a step reread them there
    streamed = sum(prod(length[ix] for ix in axes if ix != el)
                   for axes in inputs if el in axes)
    if drafts[last][0] == "element":
        streamed += n_out(drafts[last][2])
    l1_te = max(1, SB_L1_TARGET // (4 * streamed))
    cap = min(SB_MAX_TE if per_elem else 8 * SB_MAX_TE,
              _next_pow2(block_long), 1 << (l1_te.bit_length() - 1))
    te = cap
    while te > 1 and 4 * floats(te) > SB_SMEM_TARGET:
        te //= 2
    if 4 * floats(te) > SB_SMEM_TARGET:
        te = cap
        while te > 1 and 4 * floats(te) > MAX_SMEM_BYTES:
            te //= 2
    if 4 * floats(te) > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"step_block_f32 needs {4 * floats(te)} bytes of shared memory"
            f" per block (staged residents and the steps' results of one"
            f" element); a Hopper block has {MAX_SMEM_BYTES}")
    dst = dict(fixed_dst)
    cursor = offset
    for k, n in per_te:
        dst[k] = cursor
        cursor += te * n
    steps = tuple(
        SBStep(kind=kind, operands=ops, letters=letters, out=out,
               dst=dst.get(k, -1))
        for k, (kind, ops, out, letters, _subs) in enumerate(drafts))
    return StepTable(
        el=el, lengths=tuple(sorted(length.items())), inputs=inputs,
        stage=tuple(stage), steps=steps,
        stored_out=tuple(stored_out_letters(program)), te=te,
        smem_floats=floats(te))
