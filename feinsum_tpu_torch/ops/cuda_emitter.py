"""
CUDA emitter: lower an :class:`EinsumProgram` onto the hand-written kernels.

The port of ``feinsum_tpu/ops/pallas_emitter.py::build_pallas_executable``
(K1) and of its flatten route ``_try_build_flat_elementwise`` (K3).  Where
K1 runs every schedule step inside one Pallas kernel gridded over blocks of
the long axis, this emitter plans each row of the batched einsum and
launches a kernel that computes the row's value directly, all rows in one
launch:

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
  matvecs over g·d, their resident the kron-expanded one);
* a lane-packed DG program (four operands J', EXP, T, u' in the rewrite's
  three-step schedule, ``ops/lane_pack.py::plan_lane_pack_dg``) goes to
  ``lane_pack_dg_f32``.

At ``precision="bf16_3x"`` the rows that go to ``dg_rows_f32`` (DG rows and
restriction rows) go to its 3xTF32 variant ``dg_rows_3xtf32`` instead: the
j-dot in three TF32 tensor-core passes; a packed DG program goes to
``lane_pack_dg_3xtf32``, both dots split.  The other kernels have no 3x
variant, since the reference applies the split only to its dots; a
``bf16_3x`` row planned onto one of them runs it in f32 and counts under
its name in ``kernels.launch_counts``.

Everything else raises :class:`InvalidParameterError` naming what is
missing.  The executable takes and returns tensors in the descriptor's
stored layouts; CPU tensors run the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..codegen.descriptor import is_split
from ..contraction_schedule import EinsumOperand, \
    get_trivial_contraction_schedule
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
    DGRow,
    LanePackDGRow,
    LongReduceRow,
    LongReduceShape,
    ReduceRow,
    check_long_reduce_shape,
    dg_rows_3x_plain,
    dg_rows_3xtf32,
    dg_rows_f32,
    dg_rows_plain,
    ew_flat_f32,
    ew_product_f32,
    ew_product_plain,
    lane_pack_dg_3x_plain,
    lane_pack_dg_3xtf32,
    lane_pack_dg_f32,
    lane_pack_dg_plain,
    long_reduce_f32,
    long_reduce_plain,
    row_reduce_f32,
    row_reduce_plain,
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


def _long_letter(e: BatchedEinsum) -> str:
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError(
            "the fused CUDA route needs exactly one long (SizeParam) axis,"
            f" found {long_letters}")
    return long_letters[0]


def _check_routable(program, lengths: dict) -> None:
    """Refuse what the fused route does not carry."""
    e = program.einsum
    desc = program.descriptor
    bad = {str(dt) for dt in e.arg_to_dtype.values()} - {"float32"}
    if bad:
        raise InvalidParameterError(
            f"the fused CUDA route takes float32 only, got {sorted(bad)}"
            " (float64 runs on pair storage: descriptor.dd_pairs)")
    el = _long_letter(e)
    if desc.grid_index not in (None, el):
        raise InvalidParameterError(
            f"grid_index {desc.grid_index!r} is not the long axis {el!r}")
    if lengths[el] < 1:
        raise InvalidParameterError(f"long axis length {lengths[el]} < 1")


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
    el = _long_letter(e)
    desc = program.descriptor
    if el not in e.out_idx_set and lengths[el] > desc.block_long \
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
    every schedule step but the last whose operands carry no long axis,
    transitively, is hoisted.  Rows whose hoisted steps read the same
    operands share one result (``_host<k>``, in the step's output letters),
    and ``program'`` is the single-step program over the einsum in which
    each hoisted result replaces the operands it consumed.  Without hoisted
    steps: ``(program, ())``."""
    e = program.einsum
    sched = program.schedule
    if not program.descriptor.hoist_resident_steps:
        return program, ()
    el = _long_letter(e)
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
                         schedule=get_trivial_contraction_schedule(derived)),
            tuple(host_steps))


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


def _plan_rows(program, lengths: dict) -> KernelPlan:
    """Plan the rows of a program without hoisted steps."""
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

    if desc.lane_pack > 1 and e.n == 4:
        return _plan_lane_pack_dg(program, lengths, checked)
    if _is_pure_product(program):
        return KernelPlan(
            kernel="ew_product_f32",
            operands=lambda arrays: [[checked(arrays)[a.name] for a in row]
                                     for row in e.args],
            run=lambda rows: ew_product_f32(rows, one_launch=one_launch),
            plain=ew_product_plain)
    if not e.sum_indices:
        raise InvalidParameterError(
            "a contraction-free row whose operands do not all share the"
            " output's stored layout has no fused CUDA kernel yet")

    if _long_letter(e) not in e.out_idx_set:
        return _plan_long_reduce(program, lengths, checked)

    if len(e.out_idx_set) == 1:
        reduce_plans = [plan_reduce_row(e, r) for r in range(e.b)]
        el, j = reduce_plans[0].e_letter, reduce_plans[0].j_letter

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

    if resident_carries_outputs(e):
        return _plan_restrict(program, lengths, checked)

    plans = [plan_row(e, r) for r in range(e.b)]
    p0 = plans[0]
    x, s, i, j, el = (p0.x_letter, p0.s_letter, p0.i_letter, p0.j_letter,
                      p0.e_letter)
    if any((p.x_letter, p.s_letter, p.i_letter, p.j_letter, p.u_has_s,
            p.F is None) != (x, s, i, j, p0.u_has_s, p0.F is None)
           for p in plans):
        raise InvalidParameterError("rows of the batched einsum plan"
                                    " differently")
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


def _dg_kernel(desc) -> tuple:
    """``(name, wrapper, plain version)`` of the DG row kernel for the
    descriptor's precision."""
    if is_split(desc):
        return "dg_rows_3xtf32", dg_rows_3xtf32, dg_rows_3x_plain
    return "dg_rows_f32", dg_rows_f32, dg_rows_plain


def long_reduce_shape(program, lengths: dict) -> tuple:
    """``(row plans, LongReduceShape)`` of a program whose long axis is
    contracted; raises :class:`InvalidParameterError` when its rows plan
    differently or ``long_reduce_f32`` does not take them."""
    e = program.einsum
    plans = [plan_long_reduce_row(e, r) for r in range(e.b)]
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
    check_long_reduce_shape(shape)
    return plans, shape


def _plan_long_reduce(program, lengths: dict, checked: Callable
                      ) -> KernelPlan:
    """A contracted long axis onto ``long_reduce_f32``."""
    desc = program.descriptor
    stored = stored_arg_layouts(program)
    plans, shape = long_reduce_shape(program, lengths)
    el = plans[0].e_letter

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


def _plan_restrict(program, lengths: dict, checked: Callable) -> KernelPlan:
    """A matvec whose resident carries every output letter but e onto
    ``dg_rows_f32``: the merged output letters are the kernel's ``i``, as
    views of the stored resident and output (no copies)."""
    e = program.einsum
    desc = program.descriptor
    stored = stored_arg_layouts(program)
    out_letters = stored_out_letters(program)
    (pos,) = [p for p in range(e.n) if _long_letter(e) not in e.in_idx_sets[p]]
    plans = [plan_restrict_row(e, r, stored[e.args[r][pos].name], out_letters)
             for r in range(e.b)]
    el, j, merged = plans[0].e_letter, plans[0].j_letter, plans[0].merged
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


def build_cuda_executable(program, index_to_length: dict):
    """Compile *program* onto the CUDA kernels; returns
    ``fn(arrays_by_name) -> tuple`` of the b row outputs in the stored
    output layout, like the plain backend."""
    plan = plan_cuda_launch(program, index_to_length)

    def fn(arrays_by_name: dict):
        return tuple(plan.run(plan.operands(arrays_by_name)))
    return fn
