"""
The step planner of ``step_block_f32``: read a program's schedule into a
step table.

``step_block_f32`` runs K1's general step algebra, the part of
``feinsum_tpu/ops/pallas_emitter.py::build_pallas_executable`` that
evaluates every schedule step of an einsum on a block of its grid letter
(``row_result``, ``:812-887``, through ``ops/kernel_lowering.py::
lower_step``).  The CUDA emitter sends it the programs that no row family
takes by structure (``ops/cuda_emitter.py``).  This module is
framework-free apart from the planner's input, a program.

The grid letter e is the reference's (``ops/cuda_emitter.py::
pick_grid_index``): any letter a descriptor names, a long letter, or a
concrete one; every other letter, a long one too, is a short letter at its
bound length.  Without a grid (a concrete einsum whose longest output
letter is under 2048) the program is one block of one element: every step
is "free".

The schedule is honoured step by step, as the reference's ``row_result``
does: each step is one product summed over its contracted letters, and its
result is the next steps' operand.  Summing over every contracted letter at
once would change the work the schedule was chosen for (on sum
factorization ``ai,bj,ck,eabc->eijk``, 5**6 terms per element against the
three-step schedule's 3 * 5**4).

A step is of one of three kinds:

* ``"element"``: its result carries e.  The kernel computes it for a
  sub-tile of ``te`` elements at a time; a result that a later step reads
  is held in shared memory, one entry per element of the sub-tile; the last
  step's result is the row's output, written in its stored layout.
* ``"reduce"``: its operands carry e and its result does not (a contracted
  long axis, ``ej,j->``, ``ei,ej->ij``).  It must be the last step.  Each
  thread block sums its elements into per-block partials, which a second
  launch sums in a fixed order: the reference accumulates across its grid
  steps instead (``:888-921``).
* ``"free"``: no operand carries e, transitively (a resident-only step that
  ``descriptor.hoist_resident_steps`` did not hoist).  The kernel computes
  it once per thread block, as the reference does once per grid step.

and runs in one of two modes (:class:`SBStep`): ``"dense"``, a product of
two operands whose letters split into M, N, K and batch letters
(:func:`dense_split`; the demo ``ij,ejk->eik``, each step of sum
factorization, the Gram matrix's split-K reduce, a reduce being dense only
as the one step on the elements), as register tiles of RM x
RN results per thread (of ``SB_TILES``, chosen by :func:`step_cost`); or
``"general"``, through
offset tables, RT entries per thread along an output letter that one
operand alone carries and no streamed input.

Operands without e (residents) are staged in shared memory once per block;
each streamed input's sub-tile is staged there in two buffers (the next
sub-tile's copies run under this one's steps).  The shared memory of a
block is the staged residents, the results of the free steps, a reduce
step's partial sums, and per sub-tile the streamed inputs' buffers and the
element steps' results: the counterpart of the reference's
``schedule_intermediates_vmem_bytes`` / ``estimate_block_vmem_bytes``
(``:91-185``).  :func:`plan_step_block` picks the sub-tile by a model of
the steps' time (:func:`_pick_te`) among those that fit, and raises
:class:`InvalidParameterError` naming the limit a program exceeds: steps,
operands per step, operands per row, letters per step
(``SB_MAX_LETTERS``), or shared memory (a resident larger than a block
holds, such as an operand without the grid letter at a long length).
These refusals are rulings: the reference holds the same operands whole
in VMEM, and a Hopper block's 227 KB holds less.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from math import prod
from typing import Optional

from ..contraction_schedule import EinsumOperand
from ..diagnostics import InvalidParameterError
from .kernels import (
    MAX_SMEM_BYTES,
    SB_MAX_INPUTS,
    SB_MAX_LETTERS,
    SB_MAX_OPS,
    SB_MAX_STEPS,
    SB_MAX_TE,
    SB_SM_BLOCKS,
    SB_SM_SMEM_BYTES,
    SB_THREADS,
    SB_TILES,
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

    ``mode`` is ``"dense"`` for a product of two operands whose letters
    split into M, N, K and batch letters (``split``, :func:`dense_split`),
    which threads compute as register tiles of ``tile`` = (RM, RN) entries,
    or ``"general"``, which threads compute through offset tables, each
    ``tile`` = (RT,) entries along ``tile_letter`` (an output letter that
    one operand alone carries, and no streamed one; ``None`` when RT = 1).
    A dense step's offset tables are staged in shared memory at ``dsm``
    (:func:`dense_table_floats` of them)."""

    kind: str
    operands: tuple
    letters: tuple
    out: tuple
    dst: int
    mode: str = "general"
    tile: tuple = (1,)
    tile_letter: Optional[str] = None
    split: Optional[tuple] = None
    dsm: int = -1


@dataclass(frozen=True)
class StepTable:
    """A program planned for ``step_block_f32``: the long letter ``el``,
    the lengths of the other letters, each input slot's letters (the axis
    order of the view the kernel reads, the einsum's own), the float offset
    of each staged (resident) input in shared memory (-1: streamed), the
    steps, the output's stored letters, the elements per sub-tile ``te``
    and the floats of shared memory one block needs.  ``sin`` gives each
    streamed input's first buffer in shared memory (-1: read where it lies,
    without staging), ``sin_floats`` the floats of each of its two
    buffers (:func:`region_floats`); ``sout`` the output's sub-tile in
    shared memory, which the last step writes and the block copies out
    (-1: the last step writes the output), ``sout_floats`` its floats."""

    el: Optional[str]
    lengths: tuple
    inputs: tuple
    stage: tuple
    steps: tuple
    stored_out: tuple
    te: int
    smem_floats: int
    sin: tuple = ()
    sin_floats: tuple = ()
    sout: int = -1
    sout_floats: int = 0

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


def plan_step_block(program, index_to_length: dict,
                    block_long: int = None) -> StepTable:
    """The step table of *program* (its schedule's steps, after any
    hoisting) for ``step_block_f32`` at *block_long* elements per thread
    block (default: the descriptor's); raises :class:`InvalidParameterError`
    naming the limit the program exceeds."""
    from .cuda_emitter import grid_letter
    e = program.einsum
    sched = program.schedule
    if block_long is None:
        block_long = program.descriptor.block_long
    el = grid_letter(program, index_to_length)
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
    if drafts[last][0] == "free" and el is not None:
        raise InvalidParameterError(
            "step_block_f32: no step of the schedule carries the long axis")
    if set(drafts[last][2]) != set(e.out_idx_set):
        raise InvalidParameterError(
            f"step_block_f32: the last step's output {drafts[last][2]} is"
            f" not the einsum's {tuple(e.out_idx_set)}")

    def n_out(out) -> int:
        return prod(length[ix] for ix in out if ix != el)

    streamed = [slot for slot, axes in enumerate(inputs) if el in axes]
    # shared memory: staged residents, free results, the reduce step's
    # partial sums, then per sub-tile the streamed inputs' two buffers
    # and the element steps' results
    stage = []
    res_floats = 0
    for slot, axes in enumerate(inputs):
        if el in axes:
            stage.append(-1)
            continue
        stage.append(res_floats)
        res_floats += prod(length[ix] for ix in axes)
    sin_n = [prod(length[ix] for ix in inputs[slot] if ix != el)
             for slot in streamed]

    span = 1 if el is None else max(1, min(int(block_long),
                                           int(index_to_length[el])))
    cap = min(SB_MAX_TE, span)

    # a reduce step is dense only as the one step on the elements: the
    # kernel keeps its register tiles across a block's sub-tiles
    lone = all(d[0] == "free" for d in drafts[:last])

    def layout(dense_ok: bool, last_dense: bool = True) -> tuple:
        """(steps, fixed offsets, floats at the start of the sub-tile
        regions, the element steps' results per element)."""
        steps = [_tiled_step(kind, ops, out, letters, el, length, streamed,
                             (dense_ok or not any(
                                 k == "in" and x in streamed
                                 for k, x in ops))
                             and (last_dense or j != last)
                             and (kind != "reduce" or lone), cap)
                 for j, (kind, ops, out, letters, _subs)
                 in enumerate(drafts)]
        offset, fixed = res_floats, {}
        for k, st in enumerate(steps):
            if st.kind == "free" and k != last:
                fixed[k] = offset
                offset += n_out(st.out)
            elif st.kind == "reduce" and not (
                    st.mode == "dense" and _reduce_groups(st, length, el) == 1):
                fixed[k] = offset
                offset += n_out(st.out) * _reduce_groups(st, length, el)
            if st.mode == "dense":
                steps[k] = replace(st, dsm=offset)
                offset += dense_table_floats(st, length)
        per_te = [(k, n_out(st.out)) for k, st in enumerate(steps)
                  if st.kind == "element" and k != last]
        return steps, fixed, offset, per_te

    out_n = n_out(drafts[last][2]) if drafts[last][0] == "element" else 0

    def floats(te: int, staged: bool, offset: int, per_te: list,
               out: bool) -> int:
        return (offset + sum(region_floats(te, n) for _, n in per_te)
                + (2 * sum(region_floats(te, n) for n in sin_n)
                   if staged else 0)
                + (region_floats(te, out_n) if out else 0))

    # the streamed inputs' sub-tiles are staged where two buffers of one
    # element fit; a dense step reads its operands in shared memory only
    steps, fixed_dst, offset, per_te = layout(True)
    staged = (bool(streamed)
              and 4 * floats(1, True, offset, per_te, False)
              <= MAX_SMEM_BYTES
              and all(len(set(inputs[x])) == len(inputs[x])
                      for x in streamed))
    if not staged:
        steps, fixed_dst, offset, per_te = layout(False)
    # the last element step writes the output's sub-tile in shared memory,
    # copied out by consecutive threads, where it fits
    out = bool(out_n) and 4 * floats(1, staged, offset, per_te, True) \
        <= MAX_SMEM_BYTES
    if not out and steps[last].mode == "dense" \
            and out_n * int(index_to_length[el]) >= 2 ** 31:
        # a dense step's offsets are 32-bit: the last one writes a large
        # output where it lies only through the general tables
        steps, fixed_dst, offset, per_te = layout(staged, last_dense=False)
    te, steps = _pick_te(steps, length, el, cap, span,
                         lambda t: floats(t, staged, offset, per_te, out))
    need = 4 * floats(te, staged, offset, per_te, out)
    if need > MAX_SMEM_BYTES:
        raise InvalidParameterError(
            f"step_block_f32 needs {need} bytes of shared memory per block"
            f" (staged residents and the steps' results of one element); a"
            f" Hopper block has {MAX_SMEM_BYTES}")
    dst = dict(fixed_dst)
    cursor = offset
    for k, n in per_te:
        dst[k] = cursor
        cursor += region_floats(te, n)
    sin = [-1] * len(inputs)
    sin_floats = [0] * len(inputs)
    if staged:
        for slot, n in zip(streamed, sin_n):
            sin[slot] = cursor
            sin_floats[slot] = region_floats(te, n)
            cursor += 2 * sin_floats[slot]
    sout = cursor if out else -1
    steps = tuple(replace(st, dst=dst.get(k, -1))
                  for k, st in enumerate(steps))
    return StepTable(
        el=el, lengths=tuple(sorted(length.items())), inputs=inputs,
        stage=tuple(stage), steps=steps,
        stored_out=tuple(stored_out_letters(program)), te=te,
        smem_floats=need // 4, sin=tuple(sin), sin_floats=tuple(sin_floats),
        sout=sout, sout_floats=region_floats(te, out_n) if out else 0)


def dense_table_floats(step: SBStep, length: dict) -> int:
    """Shared memory of a dense step's offset tables, one int each: A's
    over M, K and B, B's over N, K and B, the result's over M, N and B."""
    M, N, K, B = (_count(g, length) for g in step.split)
    return 2 * (M + N + K) + 3 * B


def region_floats(te: int, n: int) -> int:
    """Floats of a sub-tile's region of *n* entries per element in shared
    memory: [entry][element] or [element][entry], its rows padded to an
    odd pitch (``te | 1`` or ``n | 1``) so that threads on neighbouring
    rows hit other banks."""
    return (te + 1) * (n + 1)


def dense_split(letters: tuple, out: tuple, el: Optional[str]):
    """``(M, N, K, B)`` of a step of two operands whose letters split so,
    the long letter *el* set aside: M in operand 0 and the output only, N
    in operand 1 and the output only, K in both and contracted, B in both
    and kept (batch); ``None`` for any other step (one operand or three, a
    letter twice in an operand or in the output, a letter that one operand
    alone contracts)."""
    if len(letters) != 2:
        return None
    l0, l1 = (tuple(ix for ix in x if ix != el) for x in letters)
    o = tuple(ix for ix in out if ix != el)
    if len(set(l0)) != len(l0) or len(set(l1)) != len(l1) \
            or len(set(o)) != len(o):
        return None
    s0, s1, so = set(l0), set(l1), set(o)
    M = tuple(ix for ix in o if ix in s0 and ix not in s1)
    N = tuple(ix for ix in o if ix in s1 and ix not in s0)
    B = tuple(ix for ix in o if ix in s0 and ix in s1)
    K = tuple(ix for ix in l0 if ix in s1 and ix not in so)
    if s0 | s1 != set(M) | set(N) | set(B) | set(K):
        return None
    return M, N, K, B


def _count(letters: tuple, length: dict) -> int:
    return prod(length[ix] for ix in letters)


def _reduce_groups(step: SBStep, length: dict, el) -> int:
    """Threads that split a reduce step's elements per output entry (or
    per register tile of a dense one)."""
    if step.mode == "dense":
        M, N, _K, _B = step.split
        rm, rn = step.tile
        tiles = -(-_count(M, length) // rm) * -(-_count(N, length) // rn)
        return max(1, SB_THREADS // tiles)
    n = prod(length[ix] for ix in step.out if ix != el)
    return max(1, SB_THREADS // n)


def _tiled_step(kind, ops, out, letters, el, length, streamed,
                dense_ok: bool, te: int) -> SBStep:
    """The step with its thread tiling: dense register tiles where its
    letters split (:func:`dense_split`; element and reduce steps) and
    *dense_ok* (its operands lie in shared memory), the tile of
    ``SB_TILES`` that :func:`step_cost` puts least on a sub-tile of *te*
    elements (:func:`_pick_te` picks an element step's again with its
    sub-tile), else general entries, RT of them per thread along an output
    letter that one operand alone carries and no streamed input (the
    largest RT <= 8 that divides its length)."""
    step = SBStep(kind=kind, operands=ops, letters=letters, out=out, dst=-1)
    if kind == "free":
        return step
    split = dense_split(letters, out, el) if dense_ok else None
    if split is not None:
        step = replace(step, mode="dense", split=split)
        return min((replace(step, tile=t) for t in SB_TILES),
                   key=lambda c: step_cost(c, length, el, te, SB_SM_BLOCKS))
    if kind != "element" or len(ops) < 2:
        return step
    carried = [set(x) for x in letters]
    best = (1, None)
    for ix in out:
        if ix == el:
            continue
        owners = [k for k, x in enumerate(carried) if ix in x]
        if len(owners) != 1:
            continue
        kind_k, x = ops[owners[0]]
        if kind_k == "in" and x in streamed:
            continue
        rt = max(r for r in range(1, 9) if length[ix] % r == 0)
        if rt > best[0]:
            best = (rt, ix)
    if best[1] is None:
        return step
    return replace(step, tile=(best[0],), tile_letter=best[1])


# the model's per-thread instructions of one sub-tile's fixed work (barriers,
# the staging loops, the step dispatch), and the busy threads per SM below
# which a thread's instructions issue slower (two blocks of 256)
SB_SUB_TILE_COST = 500
SB_BUSY_THREADS = 512


def step_work(step: SBStep, length: dict, el, n: int) -> tuple:
    """``(units, instructions per unit)`` of one step on a sub-tile of *n*
    elements, in a model of the kernel's threads: a dense unit is a
    register tile, RM * RN FMAs and RM + RN loads per k and its writes; a
    general unit RT entries, the operands' loads per term."""
    if n <= 0 or step.kind == "free":
        return 0, 0
    if step.mode == "dense":
        M, N, K, B = step.split
        rm, rn = step.tile
        tiles = -(-_count(M, length) // rm) * -(-_count(N, length) // rn)
        per_k = rm * rn + rm + rn + 4
        nk = _count(K, length)
        if step.kind == "reduce":
            groups = max(1, SB_THREADS // tiles)
            return tiles * groups, -(-n // groups) * nk * per_k
        return n * _count(B, length) * tiles, nk * per_k + 2 * rm * rn
    n_out = prod(length[ix] for ix in step.out if ix != el)
    n_sum = prod(length[ix] for ix in dict.fromkeys(
        ix for x in step.letters for ix in x)
        if ix != el and ix not in step.out)
    (rt,) = step.tile
    per = n_sum * (len(step.operands) + rt + 2)
    if step.kind == "reduce":
        groups = max(1, SB_THREADS // n_out)
        return n_out * groups, -(-n // groups) * per
    return n * n_out // rt, per + 2 * rt


def step_cost(step: SBStep, length: dict, el, n: int, blocks: int) -> float:
    """The model's time, in SM clocks, of one step on a sub-tile of *n*
    elements while *blocks* blocks share the SM: each round of
    ``SB_THREADS`` units issues its instructions on the SM's four
    schedulers, as if ``SB_BUSY_THREADS`` threads were busy when fewer are
    (their latency is not hidden; a dense reduce's 8 x 8 tiles need half
    as many).  A dense reduce of more tiles than threads takes rounds of
    ``SB_THREADS`` tiles, each walking the block's elements again."""
    units, per = step_work(step, length, el, n)
    if not units:
        return 0.0
    rounds = -(-units // SB_THREADS)
    warps = blocks * -(-min(units, SB_THREADS) // 32)
    need = (SB_BUSY_THREADS // 64 if step.mode == "dense"
            and step.kind == "reduce" else SB_BUSY_THREADS // 32)
    return rounds * per * max(warps, need) / 4


def _pick_te(steps, length: dict, el, cap: int, block_long: int,
             floats) -> tuple:
    """``(te, steps)``: the elements per sub-tile and each dense element
    step's register tile (of ``SB_TILES``) whose sub-tiles take a block's
    *block_long* elements in the least modelled time (:func:`step_cost`,
    ``SB_SUB_TILE_COST`` per sub-tile), the blocks per SM being what the
    shared memory ``floats(te)`` lets run; ties go to the smaller shared
    memory.  ``(1, steps)`` when no te fits (the caller refuses)."""
    def tiled(st, te, blocks):
        if st.mode != "dense" or st.kind != "element":
            return st
        return min((replace(st, tile=t) for t in SB_TILES),
                   key=lambda c: step_cost(c, length, el, te, blocks))

    best, best_key = (1, list(steps)), None
    for te in range(1, cap + 1):
        need = 4 * floats(te)
        if need > MAX_SMEM_BYTES:
            break
        blocks = max(1, min(SB_SM_BLOCKS, SB_SM_SMEM_BYTES // (need + 1024)))
        cand = [tiled(st, te, blocks) for st in steps]

        def sub_tile(n):
            return (sum(step_cost(st, length, el, n, blocks) for st in cand)
                    + SB_SUB_TILE_COST * blocks * SB_THREADS // 128)
        full, rem = divmod(block_long, te)
        t = (full * sub_tile(te) + (sub_tile(rem) if rem else 0)) / blocks
        key = (round(t, 3), need)
        if best_key is None or key < best_key:
            best, best_key = (te, cand), key
    return best
