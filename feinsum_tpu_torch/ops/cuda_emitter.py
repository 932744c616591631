"""
CUDA emitter: lower an :class:`EinsumProgram` onto the hand-written kernels.

The port of ``feinsum_tpu/ops/pallas_emitter.py::build_pallas_executable``
(K1) on the DG suite's path.  Where K1 runs every schedule step inside one
Pallas kernel gridded over blocks of the long axis, this emitter plans each
row of the batched einsum and launches a kernel that computes the row's
value directly, all rows in one launch:

* a row in the DG family (``ops/dg_rows.py``) goes to ``dg_rows_f32``;
* a contraction-free row whose operands share the output's stored layout
  goes to ``ew_product_f32``.

Everything else raises :class:`InvalidParameterError` naming the ROADMAP.md
item that will bring it.  The executable takes and returns tensors in the
descriptor's stored layouts; CPU tensors run the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..contraction_schedule import EinsumOperand
from ..diagnostics import InvalidParameterError
from ..einsum import SizeParam
from .dg_rows import plan_row
from .kernels import (
    DGRow,
    dg_rows_f32,
    dg_rows_plain,
    ew_product_f32,
    ew_product_plain,
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


def _check_routable(program, lengths: dict) -> None:
    """Refuse what the fused route does not carry."""
    e = program.einsum
    desc = program.descriptor
    bad = {str(dt) for dt in e.arg_to_dtype.values()} - {"float32"}
    if bad:
        raise InvalidParameterError(
            f"the fused CUDA route takes float32 only, got {sorted(bad)}"
            " (float64 runs on pair storage: descriptor.dd_pairs)")
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError(
            "the fused CUDA route needs exactly one long (SizeParam) axis,"
            f" found {long_letters}")
    el = long_letters[0]
    if desc.grid_index not in (None, el):
        raise InvalidParameterError(
            f"grid_index {desc.grid_index!r} is not the long axis {el!r}")
    if el not in e.out_idx_set:
        if desc.dimension_semantics == "parallel":
            raise InvalidParameterError(
                "cannot use 'parallel' grid semantics when the grid axis is"
                " contracted (the kernel accumulates across grid steps)")
        raise InvalidParameterError(
            "a contracted long axis (accumulation across blocks with a tail"
            " mask) is not ported yet (ROADMAP queue 2 K1 remainder)")
    carried: dict = {}
    for subs, name, step_args in zip(program.schedule.subscripts,
                                     program.schedule.result_names,
                                     program.schedule.arguments):
        carried[name] = any(
            el in e.in_idx_sets[a.position] if isinstance(a, EinsumOperand)
            else carried[a.name] for a in step_args)
        if not carried[name]:
            raise InvalidParameterError(
                f"schedule step {subs!r} reads no long-axis operand; hoisted"
                " resident-only steps are not ported yet (ROADMAP queue 2 K1"
                " remainder)")
    if lengths[el] < 1:
        raise InvalidParameterError(f"long axis length {lengths[el]} < 1")


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
    version; both return the b outputs in the stored output layout."""

    kernel: str
    operands: Callable
    run: Callable
    plain: Callable


def plan_cuda_launch(program, index_to_length: dict) -> KernelPlan:
    """Plan *program* onto the CUDA kernels; raises
    :class:`InvalidParameterError` for what they do not carry."""
    e = program.einsum
    desc = program.descriptor
    lengths = dict(index_to_length)
    _check_routable(program, lengths)
    stored = stored_arg_layouts(program)
    out_letters = stored_out_letters(program)
    stored_shapes = {name: tuple(lengths[ix] for ix in idx)
                     for name, idx in stored.items()}
    one_launch = desc.multiple_results_in_one_kernel

    def check_args(arrays_by_name: dict) -> None:
        for name, shape in stored_shapes.items():
            if name not in arrays_by_name:
                raise ValueError(f"missing argument {name!r}")
            if tuple(arrays_by_name[name].shape) != shape:
                raise ValueError(
                    f"argument {name!r}: shape"
                    f" {tuple(arrays_by_name[name].shape)}, stored layout"
                    f" {stored[name]} needs {shape}")

    if _is_pure_product(program):
        def ew_operands(arrays_by_name: dict) -> list:
            check_args(arrays_by_name)
            return [[arrays_by_name[a.name] for a in row] for row in e.args]
        return KernelPlan(
            kernel="ew_product_f32", operands=ew_operands,
            run=lambda rows: ew_product_f32(rows, one_launch=one_launch),
            plain=ew_product_plain)
    if not e.sum_indices:
        raise InvalidParameterError(
            "a contraction-free row whose operands do not all share the"
            " output's stored layout has no fused CUDA kernel yet")

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
        check_args(arrays_by_name)
        rows = []
        for p in plans:
            F = None
            if p.F is not None:
                F = _role_view(arrays_by_name[p.F.name], stored[p.F.name],
                               f_roles).expand(*f_shape)
            rows.append(DGRow(
                u=_role_view(arrays_by_name[p.u.name], stored[p.u.name],
                             u_roles),
                R=_role_view(arrays_by_name[p.R.name], stored[p.R.name],
                             r_roles),
                F=F))
        return rows

    def stored_outputs(outs: list) -> list:
        # without an x letter the (1, ...) leading axis is dropped (a view)
        return [o[0] if x is None else o for o in outs]

    return KernelPlan(
        kernel="dg_rows_f32", operands=dg_operands,
        run=lambda rows: stored_outputs(dg_rows_f32(
            rows, out_order=out_order, block_long=desc.block_long,
            one_launch=one_launch)),
        plain=lambda rows: stored_outputs(dg_rows_plain(rows, out_order)))


def build_cuda_executable(program, index_to_length: dict):
    """Compile *program* onto the CUDA kernels; returns
    ``fn(arrays_by_name) -> tuple`` of the b row outputs in the stored
    output layout, like the plain backend."""
    plan = plan_cuda_launch(program, index_to_length)

    def fn(arrays_by_name: dict):
        return tuple(plan.run(plan.operands(arrays_by_name)))
    return fn
