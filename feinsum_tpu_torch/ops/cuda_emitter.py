"""
CUDA emitter: lower an :class:`EinsumProgram` onto the hand-written kernels.

The port of ``feinsum_tpu/ops/pallas_emitter.py::build_pallas_executable``
(K1) and of its flatten route ``_try_build_flat_elementwise`` (K3).  Where
K1 runs every schedule step inside one Pallas kernel gridded over blocks of
its grid letter, this emitter plans each row of the batched einsum and
launches a kernel that computes the row's value directly, all rows in one
launch.  The grid letter is the reference's (:func:`pick_grid_index`): the
descriptor's ``grid_index``, else the unique long (``SizeParam``) letter,
else an output one of several, else on a concrete einsum its longest
output letter when that is at least 2048 long, else none (one block):

* schedule steps that read no long-axis operand, transitively, are hoisted
  (``descriptor.hoist_resident_steps``, the reference's ``:690-784``): each
  is evaluated once per call by ``torch.einsum`` on the card, rows whose
  hoisted steps read the same operands share one result, and the rows are
  planned on the einsum in which each hoisted result replaces the operands
  it consumed (:func:`hoist_resident_steps`);
* ``descriptor.flatten`` takes what K3 takes: a single-step,
  contraction-free program of 1-D operands that all carry the output's
  subscript, with no stored layouts; it runs ``ew_flat_f32`` (the
  ``ew_product_f32`` kernel, ``block_long`` elements per thread block);
* a contraction-free row whose operands share the output's stored layout
  goes to ``ew_product_f32``;
* a row whose long axis is contracted goes to ``long_reduce_f32``
  (``ops/dg_rows.py::plan_long_reduce_row``): the reference's accumulation
  across grid steps with its tail mask;
* a row whose output is the long axis alone goes to ``row_reduce_f32``
  (``ops/dg_rows.py::plan_reduce_row``);
* a matvec whose resident carries every output letter but the long axis
  (the face restriction ``fji,ei->fej``) goes to ``dg_rows_f32`` with the
  merged output letters as its ``i`` (``ops/dg_rows.py::
  plan_restrict_row``);
* a row in the DG family (``ops/dg_rows.py::plan_row``) goes to
  ``dg_rows_f32``, and so do the lane-packed matvec and vecmat (plain
  matvecs over g·d, their resident the kron-expanded one); a plain matvec
  whose resident exceeds that kernel's shared memory (a packed one at g·d
  = 640, the ``tc_gemm_v0`` rows of a large resident factor) goes to
  ``probe_apply_f32``, which streams R through a ring of chunks
  (:func:`apply_route`);
* a lane-packed DG program (four operands J', EXP, T, u' in the rewrite's
  three-step schedule, ``ops/lane_pack.py::plan_lane_pack_dg``) goes to
  ``lane_pack_dg_f32``;
* every other program goes to ``step_block_f32``, K1's general step
  algebra (:func:`row_family` is ``None``): its schedule step by step, as
  the reference runs it (``ops/step_block.py``).  These are the rows whose
  output is not (x?, e, i) (the demo ``ij,ejk->eik``, sum factorization
  ``ai,bj,ck,eabc->eijk``), contraction-free rows whose operands do not
  share the output's stored layout (``ej,e->ej``), a contracted long axis
  with a resident operand (``ej,j->``), two short letters per operand, or
  more output entries than ``long_reduce_f32`` takes (the Gram matrix
  above 64 x 64), batch rows that plan differently, and programs without
  a grid or with a long letter besides the grid letter.

A row family takes a program by its structure alone: a program that one
plans keeps that family's kernel, and that kernel's refusals (its shared
memory, a restriction row's stored layouts) stay refusals.

At ``precision="bf16_3x"`` the rows that go to ``dg_rows_f32`` (DG rows and
restriction rows) go to its 3xTF32 variant ``dg_rows_3xtf32`` instead: the
j-dot in three TF32 tensor-core passes (``probe_apply_3xtf32`` for a wide
resident); a packed DG program goes to
``lane_pack_dg_3xtf32``, both dots split.  The other kernels have no 3x
variant, since the reference applies the split only to its dots; a
``bf16_3x`` row planned onto one of them (``step_block_f32`` too) runs it
in f32 and counts under its name in ``kernels.launch_counts``.

What no kernel takes raises :class:`InvalidParameterError` naming the
limit.  The executable takes and returns tensors in the descriptor's
stored layouts; CPU tensors run the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..codegen.descriptor import is_split
from ..contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
)
from ..diagnostics import InvalidParameterError
from ..einsum import Array, BatchedEinsum, SizeParam
from .dg_rows import (
    plan_long_reduce_row,
    plan_reduce_row,
    plan_restrict_row,
    plan_row,
    resident_carries_outputs,
)
from .kernels import (
    MAX_SMEM_BYTES,
    DGRow,
    LanePackDGRow,
    LongReduceRow,
    LongReduceShape,
    ReduceRow,
    check_long_reduce_shape,
    dg_rows_3x_plain,
    dg_rows_3x_smem_bytes,
    dg_rows_3xtf32,
    dg_rows_f32,
    dg_rows_plain,
    dg_rows_smem_bytes,
    ew_flat_f32,
    ew_product_f32,
    ew_product_plain,
    lane_pack_dg_3x_plain,
    lane_pack_dg_3xtf32,
    lane_pack_dg_f32,
    lane_pack_dg_plain,
    long_reduce_f32,
    long_reduce_plain,
    long_reduce_limit,
    row_reduce_f32,
    row_reduce_plain,
    step_block_f32,
    step_block_plain,
)
from .lane_pack import (
    EXP_POS,
    J_POS,
    T_POS,
    U_POS,
    lane_pack_dg_shape,
    plan_lane_pack_dg,
)
from .layouts import stored_arg_layouts, stored_out_letters
from .probe_kernels import (
    PA_MAX_DIM,
    ApplyRow,
    probe_apply_3x_plain,
    probe_apply_3xtf32,
    probe_apply_f32,
    probe_apply_plain,
)
from .step_block import plan_step_block


def _role_view(t, stored: tuple, roles: tuple):
    """View of *t* (axes named by *stored*) with axes in *roles* order; a
    ``None`` role is a new size-1 axis."""
    present = [ix for ix in roles if ix is not None]
    if sorted(present) != sorted(stored):
        raise InvalidParameterError(
            f"stored axes {stored} do not match the kernel roles {roles}")
    v = t.permute(*[stored.index(ix) for ix in present])
    for pos, ix in enumerate(roles):
        if ix is None:
            v = v.unsqueeze(pos)
    return v


def pick_grid_index(program, index_to_length: dict) -> Optional[str]:
    """The letter the fused route grids over, as the reference chooses it
    (``feinsum_tpu/ops/pallas_emitter.py::_pick_grid_index``): the
    descriptor's ``grid_index``; else the unique long (``SizeParam``)
    letter; else, with several, the first that is an output letter (its
    blocks are independent), or the first; else, on a fully concrete
    einsum, its longest output letter when that is at least 2048 long, and
    ``None`` (no grid: one block) otherwise."""
    desc = program.descriptor
    e = program.einsum
    if desc.grid_index is not None:
        return desc.grid_index
    params = [ix for ix, ln in e.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if len(params) == 1:
        return params[0]
    if len(params) > 1:
        out_params = [ix for ix in e.out_idx_set if ix in params]
        return (out_params or params)[0]
    candidates = sorted(e.out_idx_set, key=lambda ix: -index_to_length[ix])
    if candidates and index_to_length[candidates[0]] >= 2 * 1024:
        return candidates[0]
    return None


def grid_letter(program, index_to_length: Optional[dict] = None
                ) -> Optional[str]:
    """:func:`pick_grid_index` of *program*, checked to name a letter of its
    einsum; the lengths default to the einsum's concrete ones (all that a
    fully concrete einsum's choice reads)."""
    e = program.einsum
    if index_to_length is None:
        index_to_length = {ix: int(ln) for ix, ln
                           in e.index_to_dim_length.items()
                           if not isinstance(ln, SizeParam)}
    el = pick_grid_index(program, index_to_length)
    if el is not None and el not in e.index_to_dim_length:
        raise InvalidParameterError(
            f"grid_index {el!r} names no letter of the einsum"
            f" {e.get_subscripts()}")
    return el


def _family_letter(program, index_to_length: dict) -> Optional[str]:
    """The grid letter when the row families can take the program on it:
    every other letter is concrete (the families classify rows by one long
    letter); else ``None``, and the program goes to ``step_block_f32``."""
    el = grid_letter(program, index_to_length)
    if el is None or any(isinstance(ln, SizeParam) and ix != el for ix, ln
                         in program.einsum.index_to_dim_length.items()):
        return None
    return el


def _check_routable(program, lengths: dict) -> None:
    """Refuse what the fused route does not carry."""
    e = program.einsum
    bad = {str(dt) for dt in e.arg_to_dtype.values()} - {"float32"}
    if bad:
        raise InvalidParameterError(
            f"the fused CUDA route takes float32 only, got {sorted(bad)}"
            " (float64 runs on pair storage: descriptor.dd_pairs)")
    el = grid_letter(program, lengths)
    if el is not None and lengths[el] < 1:
        raise InvalidParameterError(f"grid axis length {lengths[el]} < 1")


def _check_flat(program) -> None:
    """K3's conditions (the reference's ``_try_build_flat_elementwise``
    and its caller's message)."""
    e = program.einsum
    desc = program.descriptor
    out = tuple(e.out_idx_set)
    if (program.schedule.nsteps != 1 or e.sum_indices
            or any(tuple(s) != out for s in e.in_idx_sets)
            or desc.arg_layouts or desc.out_layout or len(out) != 1):
        raise InvalidParameterError(
            "flatten=True requires a single-step, contraction-free program"
            " whose operands all share the output subscript")


def _check_long_axis_kept(program, lengths: dict) -> None:
    """The reference's rule (``pallas_emitter.py:607-613``): a contracted
    long axis over more than one block refuses ``"parallel"`` semantics,
    since the reference accumulates across its grid steps.  The port sums
    the blocks' partials in a second launch (``long_reduce_f32``), so the
    rule is kept for parity, not for a race."""
    e = program.einsum
    el = grid_letter(program, lengths)
    desc = program.descriptor
    if el is not None and el not in e.out_idx_set \
            and lengths[el] > desc.block_long \
            and desc.dimension_semantics == "parallel":
        raise InvalidParameterError(
            "cannot use 'parallel' grid semantics when the grid axis is"
            " contracted (the kernel accumulates across grid steps)")


# {{{ hoisted resident-only steps

@dataclass(frozen=True)
class HostStep:
    """One hoisted step evaluated once per call: ``result`` =
    ``torch.einsum(subscripts, *operands)``, each operand ``("arg", name)``
    (a logical einsum operand) or ``("host", result)`` (an earlier hoisted
    result)."""

    result: str
    subscripts: str
    operands: tuple


def hoist_resident_steps(program) -> tuple:
    """``(program', host_steps)``: with ``descriptor.hoist_resident_steps``,
    every schedule step but the last whose operands carry no grid letter
    (:func:`grid_letter`), transitively, is hoisted, as in the reference
    (no step is, without a grid).  Rows whose hoisted steps read the same
    operands share one result (``_host<k>``, in the step's output letters),
    and ``program'`` is the program over the einsum in which each hoisted
    result replaces the operands it consumed, its schedule the steps that
    stay in the kernel (the last step and those it reads), each hoisted
    result read as an operand.  The row families plan on that einsum alone;
    ``step_block_f32`` runs the steps.  Without hoisted steps: ``(program,
    ())``."""
    e = program.einsum
    sched = program.schedule
    if not program.descriptor.hoist_resident_steps:
        return program, ()
    el = grid_letter(program)
    if el is None:
        return program, ()
    steps = list(zip(sched.subscripts, sched.result_names, sched.arguments))
    carries: dict = {}
    for _, name, args in steps:
        carries[name] = any(
            el in e.in_idx_sets[a.position] if isinstance(a, EinsumOperand)
            else carries[a.name] for a in args)
    hoisted = {name for _, name, _ in steps[:-1] if not carries[name]}
    if not hoisted:
        return program, ()
    step_of = {name: (subs.replace(" ", ""), args)
               for subs, name, args in steps}

    def leaves(args):
        for a in args:
            if isinstance(a, EinsumOperand):
                yield ("arg", a.position)
            elif a.name in hoisted:
                yield ("host", a.name)
            else:
                yield from leaves(step_of[a.name][1])
    kernel_leaves = list(leaves(steps[-1][2]))
    positions = [x for kind, x in kernel_leaves if kind == "arg"]
    if len(set(positions)) != len(positions):
        raise InvalidParameterError(
            "the schedule reads an operand twice; it is not a contraction"
            " tree")

    def letters(name):
        return step_of[name][0].split("->")[1]

    host_steps: list = []
    slot_of_key: dict = {}
    rows = []
    for r in range(e.b):
        value_of: dict = {}       # step name -> ("arg"/"host", name)
        for subs, name, args in steps:
            if name not in hoisted:
                continue
            refs = tuple(("arg", e.args[r][a.position].name)
                         if isinstance(a, EinsumOperand) else value_of[a.name]
                         for a in args)
            ins = [e.in_idx_sets[a.position] if isinstance(a, EinsumOperand)
                   else letters(a.name) for a in args]
            key = (step_of[name][0], refs)
            if key not in slot_of_key:
                slot_of_key[key] = slot = f"_host{len(slot_of_key)}"
                host_steps.append(HostStep(
                    slot, ",".join("".join(s) for s in ins) + "->"
                    + letters(name), refs))
            value_of[name] = ("host", slot_of_key[key])
        row = []
        for kind, x in kernel_leaves:
            if kind == "arg":
                row.append(e.args[r][x])
                continue
            row.append(Array(
                name=value_of[x][1],
                shape=tuple(int(e.index_to_dim_length[ix])
                            for ix in letters(x)),
                dtype=np.result_type(*e.arg_to_dtype.values())))
        rows.append(tuple(row))
    in_idx_sets = tuple(tuple(e.in_idx_sets[x]) if kind == "arg"
                        else tuple(letters(x)) for kind, x in kernel_leaves)
    kept = {a.name for row in rows for a in row}
    derived = BatchedEinsum(out_idx_set=tuple(e.out_idx_set),
                            in_idx_sets=in_idx_sets, args=tuple(rows))
    desc = program.descriptor.copy(
        arg_layouts=tuple((n, p) for n, p in program.descriptor.arg_layouts
                          if n in kept))
    return (program.copy(einsum=derived, descriptor=desc,
                         schedule=_kernel_schedule(steps, hoisted,
                                                   kernel_leaves)),
            tuple(host_steps))


def _kernel_schedule(steps: list, hoisted: set, kernel_leaves: list
                     ) -> ContractionSchedule:
    """The steps that stay in the kernel, in the schedule's order: the last
    and every step it reads that is not hoisted, with each operand an
    operand of the derived einsum (its position among *kernel_leaves*) or
    an earlier kernel step's result."""
    pos_of = {leaf: p for p, leaf in enumerate(kernel_leaves)}
    by_name = {name: args for _, name, args in steps}
    reached: set = set()

    def visit(name):
        reached.add(name)
        for a in by_name[name]:
            if isinstance(a, IntermediateResult) and a.name not in hoisted \
                    and a.name not in reached:
                visit(a.name)
    visit(steps[-1][1])
    subs, names, arguments = [], [], []
    for sub, name, args in steps:
        if name not in reached:
            continue
        subs.append(sub)
        names.append(name)
        arguments.append(tuple(
            EinsumOperand(pos_of[("arg", a.position)])
            if isinstance(a, EinsumOperand)
            else EinsumOperand(pos_of[("host", a.name)])
            if a.name in hoisted else a for a in args))
    return ContractionSchedule(tuple(subs), tuple(names), tuple(arguments))


def _host_values(program, host_steps: tuple, arrays_by_name: dict) -> dict:
    """The hoisted results, by name, from the stored arrays (each logical
    operand is a view of its stored tensor)."""
    perms = program.descriptor.arg_layouts_map
    vals: dict = {}
    for step in host_steps:
        ops = []
        for kind, name in step.operands:
            if kind == "host":
                ops.append(vals[name])
                continue
            t = arrays_by_name[name]
            if name in perms:
                t = t.permute(*(int(i) for i in np.argsort(perms[name])))
            ops.append(t)
        vals[step.result] = torch.einsum(step.subscripts, *ops).contiguous()
    return vals

# }}}


def _is_pure_product(program) -> bool:
    e = program.einsum
    out = tuple(e.out_idx_set)
    if e.sum_indices or any(tuple(s) != out for s in e.in_idx_sets):
        return False
    stored = stored_arg_layouts(program)
    return all(stored[name] == stored_out_letters(program)
               for name in e.all_args)


@dataclass(frozen=True)
class KernelPlan:
    """A program planned onto one kernel.  ``operands(arrays_by_name)``
    gives the kernel wrapper's rows; ``run(rows)`` launches the kernel (the
    plain version for CPU tensors) and ``plain(rows)`` runs the plain
    version; both return the b outputs in the stored output layout.  At
    ``bf16_3x`` the DG kernel is ``dg_rows_3xtf32``; a kernel with no 3x
    variant runs in f32, as its name in ``kernel`` says."""

    kernel: str
    operands: Callable
    run: Callable
    plain: Callable


def plan_cuda_launch(program, index_to_length: dict) -> KernelPlan:
    """Plan *program* onto the CUDA kernels; raises
    :class:`InvalidParameterError` for what they do not carry."""
    lengths = dict(index_to_length)
    _check_routable(program, lengths)
    desc = program.descriptor
    one_launch = desc.multiple_results_in_one_kernel
    if desc.flatten:
        _check_flat(program)
        e = program.einsum
        return KernelPlan(
            kernel="ew_flat_f32",
            operands=lambda arrays: [[arrays[a.name] for a in row]
                                     for row in e.args],
            run=lambda rows: ew_flat_f32(rows, block_long=desc.block_long,
                                         one_launch=one_launch),
            plain=ew_product_plain)
    _check_long_axis_kept(program, lengths)
    kernel_program, host_steps = hoist_resident_steps(program)
    plan = _plan_rows(kernel_program, lengths)
    if not host_steps:
        return plan

    def operands(arrays_by_name: dict) -> list:
        return plan.operands({**arrays_by_name, **_host_values(
            program, host_steps, arrays_by_name)})
    return KernelPlan(kernel=plan.kernel, operands=operands, run=plan.run,
                      plain=plan.plain)


def _dg_plans(e: BatchedEinsum, el: str) -> Optional[list]:
    """The rows' DG plans (:func:`~.dg_rows.plan_row`) over the long letter
    *el* when every row is in the family and all plan alike, else
    ``None``."""
    try:
        plans = [plan_row(e, r, el) for r in range(e.b)]
    except InvalidParameterError:
        return None
    p0 = plans[0]
    if any((p.x_letter, p.s_letter, p.i_letter, p.j_letter, p.u_has_s,
            p.F is None) != (p0.x_letter, p0.s_letter, p0.i_letter,
                             p0.j_letter, p0.u_has_s, p0.F is None)
           for p in plans):
        return None
    return plans


def row_family(program, index_to_length: dict) -> Optional[str]:
    """The row family that takes *program* (without hoisted steps) by its
    structure on its grid letter (:func:`grid_letter`): ``"lane_pack_dg"``,
    ``"ew_product"``, ``"long_reduce"``, ``"row_reduce"``, ``"restrict"``
    or ``"dg"``; ``None`` when none does, and the program goes to
    ``step_block_f32``.  The families classify rows by one long letter: a
    program without a grid, or with a long (``SizeParam``) letter other
    than its grid letter, goes to ``step_block_f32``.  Structure is the
    einsum's letters and ``long_reduce_f32``'s count of output entries; a
    family's limits on shared memory, and a restriction row's stored
    layouts, are its kernel's refusals, not another route (a DG matvec
    whose resident is wider than ``dg_rows_f32``'s shared memory goes to
    ``probe_apply_f32``, whose ring streams it: :func:`apply_route`)."""
    e = program.einsum
    el = _family_letter(program, index_to_length)
    if el is None:
        return None
    if program.descriptor.lane_pack > 1 and e.n == 4:
        return "lane_pack_dg"
    if _is_pure_product(program):
        return "ew_product"
    if not e.sum_indices:
        return None
    if el not in e.out_idx_set:
        try:
            _, shape = long_reduce_shape(program, index_to_length,
                                         check=False)
        except InvalidParameterError:
            return None
        return "long_reduce" if long_reduce_limit(shape) is None else None
    if len(e.out_idx_set) == 1:
        try:
            for r in range(e.b):
                plan_reduce_row(e, r, el)
        except InvalidParameterError:
            return None
        return "row_reduce"
    if resident_carries_outputs(e, el):
        stored = stored_arg_layouts(program)
        out_letters = stored_out_letters(program)
        (pos,) = [p for p in range(e.n) if el not in e.in_idx_sets[p]]
        try:
            for r in range(e.b):
                plan_restrict_row(e, r, stored[e.args[r][pos].name],
                                  out_letters, check_layout=False, el=el)
        except InvalidParameterError:
            return None
        return "restrict"
    return None if _dg_plans(e, el) is None else "dg"


def _plan_rows(program, lengths: dict) -> KernelPlan:
    """Plan the rows of a program without hoisted steps onto the kernel of
    its row family, or onto ``step_block_f32``."""
    e = program.einsum
    desc = program.descriptor
    stored = stored_arg_layouts(program)
    out_letters = stored_out_letters(program)
    stored_shapes = {name: tuple(lengths[ix] for ix in idx)
                     for name, idx in stored.items()}
    one_launch = desc.multiple_results_in_one_kernel

    def checked(arrays_by_name: dict) -> dict:
        for name, shape in stored_shapes.items():
            if name not in arrays_by_name:
                raise ValueError(f"missing argument {name!r}")
            if tuple(arrays_by_name[name].shape) != shape:
                raise ValueError(
                    f"argument {name!r}: shape"
                    f" {tuple(arrays_by_name[name].shape)}, stored layout"
                    f" {stored[name]} needs {shape}")
        return arrays_by_name

    family = row_family(program, lengths)
    if family is None:
        return _plan_step_block(program, lengths, checked)
    el = grid_letter(program, lengths)
    if family == "lane_pack_dg":
        return _plan_lane_pack_dg(program, lengths, checked)
    if family == "ew_product":
        return KernelPlan(
            kernel="ew_product_f32",
            operands=lambda arrays: [[checked(arrays)[a.name] for a in row]
                                     for row in e.args],
            run=lambda rows: ew_product_f32(rows, one_launch=one_launch),
            plain=ew_product_plain)
    if family == "long_reduce":
        return _plan_long_reduce(program, lengths, checked, el)
    if family == "row_reduce":
        reduce_plans = [plan_reduce_row(e, r, el) for r in range(e.b)]
        j = reduce_plans[0].j_letter

        def reduce_operands(arrays_by_name: dict) -> list:
            arrays = checked(arrays_by_name)
            return [ReduceRow(
                u=_role_view(arrays[p.u.name], stored[p.u.name], (el, j)),
                w=arrays[p.w.name] if p.w is not None else None)
                for p in reduce_plans]
        return KernelPlan(
            kernel="row_reduce_f32", operands=reduce_operands,
            run=lambda rows: row_reduce_f32(rows, block_long=desc.block_long,
                                            one_launch=one_launch),
            plain=row_reduce_plain)
    if family == "restrict":
        return _plan_restrict(program, lengths, checked, el)

    plans = _dg_plans(e, el)
    if apply_route(plans[0], lengths, is_split(desc)):
        return _plan_apply(program, checked, plans)
    p0 = plans[0]
    x, s, i, j = p0.x_letter, p0.s_letter, p0.i_letter, p0.j_letter
    S = lengths[s] if s is not None else 1
    u_roles = (s if p0.u_has_s else None, j, el)
    r_roles = (s, i, j)
    f_roles = (x if x is not None and x in p0.f_idx else None,
               s if s is not None and s in p0.f_idx else None, el)
    f_shape = (lengths[x] if x is not None else 1, S, lengths[el])
    role_of = {x: 0, i: 1, el: 2}
    out_order = ((0,) if x is None else ()) + tuple(role_of[ix]
                                                    for ix in out_letters)

    def dg_operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)
        rows = []
        for p in plans:
            F = None
            if p.F is not None:
                F = _role_view(arrays[p.F.name], stored[p.F.name],
                               f_roles).expand(*f_shape)
            rows.append(DGRow(
                u=_role_view(arrays[p.u.name], stored[p.u.name], u_roles),
                R=_role_view(arrays[p.R.name], stored[p.R.name], r_roles),
                F=F))
        return rows

    def stored_outputs(outs: list) -> list:
        # without an x letter the (1, ...) leading axis is dropped (a view)
        return [o[0] if x is None else o for o in outs]

    kernel, launch, plain = _dg_kernel(desc)
    return KernelPlan(
        kernel=kernel, operands=dg_operands,
        run=lambda rows: stored_outputs(launch(
            rows, out_order=out_order, block_long=desc.block_long,
            one_launch=one_launch)),
        plain=lambda rows: stored_outputs(plain(rows, out_order)))


def apply_route(plan, lengths: dict, split: bool) -> bool:
    """Whether a DG row goes to ``probe_apply_f32`` (``probe_apply_3xtf32``
    with *split*) instead of ``dg_rows_f32``: a plain matvec ``out[e, i] =
    Σ_j R[i, j] u[e, j]`` (no s, x or streamed factor) whose resident is
    wider than a Hopper block of the DG kernel holds (the packed matvecs
    and vecmats with a kron-expanded resident, the ``tc_gemm_v0`` rows with
    a large resident factor), and at most ``PA_MAX_DIM`` on each side:
    ``probe_apply`` streams R through a ring of chunks."""
    if plan.x_letter is not None or plan.s_letter is not None \
            or plan.F is not None or plan.u_has_s:
        return False
    I, J = int(lengths[plan.i_letter]), int(lengths[plan.j_letter])
    need = (dg_rows_3x_smem_bytes(1, 1, I, J, False) if split
            else dg_rows_smem_bytes(1, I, J, False))
    return need > MAX_SMEM_BYTES and I <= PA_MAX_DIM and J <= PA_MAX_DIM


def _plan_apply(program, checked: Callable, plans: list) -> KernelPlan:
    """A wide-resident matvec onto ``probe_apply_f32`` (its 3x variant at
    ``bf16_3x``): u as a (j, e) view, R as a contiguous (1, i, j) copy, one
    launch per row; the (i, e) output stored dof-major, or element-major as
    the transpose of a contiguous (e, i) tensor."""
    desc = program.descriptor
    stored = stored_arg_layouts(program)
    out_letters = stored_out_letters(program)
    p0 = plans[0]
    el, i, j = p0.e_letter, p0.i_letter, p0.j_letter
    elem_major = out_letters.index(el) < out_letters.index(i)
    if is_split(desc):
        kernel, launch, plain = ("probe_apply_3xtf32", probe_apply_3xtf32,
                                 probe_apply_3x_plain)
    else:
        kernel, launch, plain = ("probe_apply_f32", probe_apply_f32,
                                 probe_apply_plain)

    def operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)
        return [(ApplyRow(u=_role_view(arrays[p.u.name], stored[p.u.name],
                                       (j, el))),
                 _role_view(arrays[p.R.name], stored[p.R.name],
                            (None, i, j)).contiguous()) for p in plans]

    def stored_output(o):
        return o.t() if elem_major else o

    return KernelPlan(
        kernel=kernel, operands=operands,
        run=lambda rows: [stored_output(launch(
            [row], R, out_elem_major=elem_major)[0]) for row, R in rows],
        plain=lambda rows: [stored_output(plain(
            [row], R, out_elem_major=elem_major)[0]) for row, R in rows])


def _dg_kernel(desc) -> tuple:
    """``(name, wrapper, plain version)`` of the DG row kernel for the
    descriptor's precision."""
    if is_split(desc):
        return "dg_rows_3xtf32", dg_rows_3xtf32, dg_rows_3x_plain
    return "dg_rows_f32", dg_rows_f32, dg_rows_plain


def long_reduce_shape(program, lengths: dict, check: bool = True,
                      el: Optional[str] = None) -> tuple:
    """``(row plans, LongReduceShape)`` of a program whose long axis (*el*,
    by default its grid letter) is contracted; raises
    :class:`InvalidParameterError` when its rows plan differently or, with
    *check*, ``long_reduce_f32`` does not take them."""
    e = program.einsum
    if el is None:
        el = grid_letter(program, lengths)
    plans = [plan_long_reduce_row(e, r, el) for r in range(e.b)]
    p0 = plans[0]
    key = (p0.a_letter, p0.b_letter, p0.p_letter, p0.q_letter, p0.c_letter,
           p0.c_batch, p0.b is None)
    if any((p.a_letter, p.b_letter, p.p_letter, p.q_letter, p.c_letter,
            p.c_batch, p.b is None) != key for p in plans):
        raise InvalidParameterError("rows of the batched einsum plan"
                                    " differently")
    role_of = {p0.p_letter: "p", p0.q_letter: "q", p0.c_letter: "c"}
    a_role, b_role = p0.roles
    shape = LongReduceShape(
        a_role=a_role, b_role=b_role,
        P=lengths[p0.p_letter] if p0.p_letter is not None else 1,
        Q=lengths[p0.q_letter] if p0.q_letter is not None else 1,
        C=lengths[p0.c_letter] if p0.c_letter is not None else 1,
        c_batch=p0.c_batch,
        out_axes=tuple(role_of[ix] for ix in stored_out_letters(program)))
    if check:
        check_long_reduce_shape(shape)
    return plans, shape


def _plan_long_reduce(program, lengths: dict, checked: Callable,
                      el: str) -> KernelPlan:
    """A contracted long axis onto ``long_reduce_f32``."""
    desc = program.descriptor
    stored = stored_arg_layouts(program)
    plans, shape = long_reduce_shape(program, lengths, el=el)

    def operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)
        return [LongReduceRow(
            a=_role_view(arrays[p.a.name], stored[p.a.name],
                         (el, p.a_letter)),
            b=None if p.b is None else _role_view(
                arrays[p.b.name], stored[p.b.name], (el, p.b_letter)))
            for p in plans]
    return KernelPlan(
        kernel="long_reduce_f32", operands=operands,
        run=lambda rows: long_reduce_f32(
            rows, shape, block_long=desc.block_long,
            one_launch=desc.multiple_results_in_one_kernel),
        plain=lambda rows: long_reduce_plain(rows, shape))


def _plan_restrict(program, lengths: dict, checked: Callable,
                   el: str) -> KernelPlan:
    """A matvec whose resident carries every output letter but e onto
    ``dg_rows_f32``: the merged output letters are the kernel's ``i``, as
    views of the stored resident and output (no copies)."""
    e = program.einsum
    desc = program.descriptor
    stored = stored_arg_layouts(program)
    out_letters = stored_out_letters(program)
    (pos,) = [p for p in range(e.n) if el not in e.in_idx_sets[p]]
    plans = [plan_restrict_row(e, r, stored[e.args[r][pos].name], out_letters,
                               el=el) for r in range(e.b)]
    j, merged = plans[0].j_letter, plans[0].merged
    I, J = int(np.prod([lengths[ix] for ix in merged])), lengths[j]
    out_order = ((0, 1, 2) if out_letters.index(merged[0])
                 < out_letters.index(el) else (0, 2, 1))
    out_shape = tuple(lengths[ix] for ix in out_letters)

    def r_view(t, letters):
        perm = [letters.index(ix) for ix in merged + (j,)]
        return t.permute(*perm).view(1, I, J)

    def operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)
        return [DGRow(
            u=_role_view(arrays[p.u.name], stored[p.u.name], (None, j, el)),
            R=r_view(arrays[p.R.name], stored[p.R.name]), F=None)
            for p in plans]

    def stored_outputs(outs: list) -> list:
        return [o[0].view(out_shape) for o in outs]
    kernel, launch, plain = _dg_kernel(desc)
    return KernelPlan(
        kernel=kernel, operands=operands,
        run=lambda rows: stored_outputs(launch(
            rows, out_order=out_order, block_long=desc.block_long,
            one_launch=desc.multiple_results_in_one_kernel)),
        plain=lambda rows: stored_outputs(plain(rows, out_order)))


def _plan_lane_pack_dg(program, lengths: dict, checked: Callable
                       ) -> KernelPlan:
    """A lane-packed DG program onto ``lane_pack_dg_f32`` (its 3x variant
    at ``bf16_3x``): each operand as a view in role order with its leading
    letters flattened into one axis, the output allocated in the stored
    order and viewed back in the stored letters."""
    e = program.einsum
    desc = program.descriptor
    p = plan_lane_pack_dg(e)
    split = is_split(desc)
    shape = lane_pack_dg_shape(e, split)
    stored = stored_arg_layouts(program)
    out_letters = stored_out_letters(program)
    el, i, j, pk = p.e_letter, p.i_letter, p.j_letter, p.pk_letter
    nchi = len(p.chi)
    if out_letters[:nchi] != p.chi:
        raise InvalidParameterError(
            f"lane_pack_dg_f32 writes the output letters {p.chi} leading;"
            f" the stored output is {out_letters}")
    out_order = (0,) + ((1, 2) if out_letters[nchi:] == (el, i) else (2, 1))
    out_shape = tuple(lengths[ix] for ix in out_letters)

    def lead_view(t, letters, lead, tail):
        v = _role_view(t, letters, lead + tail)
        return v.flatten(0, len(lead) - 1) if lead else v.unsqueeze(0)

    def operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)
        rows = []
        for row in e.args:
            views = [lead_view(arrays[a.name], stored[a.name], lead, tail)
                     for a, lead, tail in zip(
                         row, (p.lam_j, p.exp_lead, p.m, p.lam_u),
                         ((el, pk), (pk, i), (i, j), (el, j)))]
            rows.append(LanePackDGRow(u=views[U_POS], T=views[T_POS],
                                      J=views[J_POS], EXP=views[EXP_POS]))
        return rows

    def stored_outputs(outs: list) -> list:
        return [o.view(out_shape) for o in outs]

    if split:
        kernel, launch, plain = ("lane_pack_dg_3xtf32", lane_pack_dg_3xtf32,
                                 lane_pack_dg_3x_plain)
    else:
        kernel, launch, plain = ("lane_pack_dg_f32", lane_pack_dg_f32,
                                 lane_pack_dg_plain)
    return KernelPlan(
        kernel=kernel, operands=operands,
        run=lambda rows: stored_outputs(launch(
            rows, shape, block_long=desc.block_long, out_order=out_order,
            one_launch=desc.multiple_results_in_one_kernel)),
        plain=lambda rows: stored_outputs(plain(rows, shape, out_order)))


def _plan_step_block(program, lengths: dict, checked: Callable
                     ) -> KernelPlan:
    """Any other program onto ``step_block_f32``: its step table
    (``ops/step_block.py``), each operand a view of its stored tensor in
    the einsum's axis order, the output allocated in the stored order."""
    from ..codegen.program import _logical_arrays
    e = program.einsum
    desc = program.descriptor
    table = plan_step_block(program, lengths)

    def operands(arrays_by_name: dict) -> list:
        logical = _logical_arrays(program, checked(arrays_by_name))
        return [[logical[a.name] for a in row] for row in e.args]
    return KernelPlan(
        kernel="step_block_f32", operands=operands,
        run=lambda rows: step_block_f32(
            rows, table, block_long=desc.block_long,
            one_launch=desc.multiple_results_in_one_kernel),
        plain=lambda rows: step_block_plain(rows, table, desc.block_long))


def build_cuda_executable(program, index_to_length: dict):
    """Compile *program* onto the CUDA kernels; returns
    ``fn(arrays_by_name) -> tuple`` of the b row outputs in the stored
    output layout, like the plain backend."""
    plan = plan_cuda_launch(program, index_to_length)

    def fn(arrays_by_name: dict):
        return tuple(plan.run(plan.operands(arrays_by_name)))
    return fn
