"""
The fp64 emitter: lower an :class:`EinsumProgram` whose descriptor sets
``dd_pairs`` onto the ``dd_rows`` kernel.

The port of ``feinsum_tpu/ops/dd_emitter.py::build_dd_executable`` (K4).
The storage contract is the reference's: every float64 operand and output is
stored as a (2, ...) float32 [hi, lo] pair with the pair axis leading
(:func:`split_to_pairs`; hi + lo is the float64 value), streamed operands
keep the long axis trailing, and the output is the dof-major rotate of the
logical output, (2, [x,] i, E).  Rows are planned by
:func:`~feinsum_tpu_torch.ops.dg_rows.plan_row` (the DG family
``out[x?, e, i] = Σ_s F[x?, s?, e] Σ_j R[s?, i, j] u[s?, e, j]``) and all
go to ``dd_rows`` in one launch; CPU tensors run its plain version.

Restriction rows, a matvec whose resident carries every output letter but
the long axis (the wave model's face restriction ``fji,ei->fej``), are
planned as on the float32 route (``cuda_emitter._plan_restrict``) by
:func:`~feinsum_tpu_torch.ops.dg_rows.plan_restrict_row`: the merged output
letters (f, j) are the kernel's ``i``, as views of the pair tensors, so the
resident is one (2, 1, F·Pf, P) matrix and the output (2, F, Pf, E) is the
kernel's (2, 1, F·Pf, E).  The merged letters must be adjacent and in the
same order in the stored resident and output, and the output stores the
long axis trailing; other orders raise, naming the order.

The float64 models (``models/wave.py``, ``models/maxwell.py``) take this
route by default: their steps split the float64 state into pairs at their
boundary (``models/common.py``, ``to_pairs``: ``kernels.pairs_split``) and
read the row outputs' pairs in their state update (``kernels.step_update``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..diagnostics import InvalidParameterError
from ..einsum import SizeParam
from .cuda_emitter import KernelPlan, _role_view
from .dg_rows import plan_restrict_row, plan_row, resident_carries_outputs
from .kernels import DDRow, dd_rows, dd_rows_plain, pairs_split
from .layouts import stored_arg_layouts, stored_out_letters


def split_to_pairs(arr):
    """A float64 array -> stacked (2, ...) float32 [hi, lo], hi the float32
    rounding of the value and lo that of the remainder (the bits of
    ``feinsum_tpu.ops.dd_emitter.split_to_pairs``).  Numpy or torch (a
    float64 tensor, :func:`~feinsum_tpu_torch.ops.kernels.pairs_split`)."""
    if isinstance(arr, np.ndarray):
        hi = arr.astype(np.float32)
        lo = (arr - hi.astype(np.float64)).astype(np.float32)
        return np.stack([hi, lo])
    # one pass on the card (``pairs_split``), the same bits as its plain
    # version's two on the CPU; another layout is made contiguous first
    return pairs_split(arr.contiguous())


def combine_pairs(arr):
    """(2, ...) float32 [hi, lo] pairs -> the float64 values hi + lo.
    Numpy or torch."""
    if isinstance(arr, np.ndarray):
        return arr[0].astype(np.float64) + arr[1].astype(np.float64)
    return arr[0].to(torch.float64, copy=True).add_(arr[1])


def _pair_role_view(t, stored: tuple, roles: tuple):
    """View of the pair tensor *t* (pair axis, then axes named by *stored*)
    with the pair axis first and the others in *roles* order; a ``None``
    role is a new size-1 axis (a strided view, no copy)."""
    return _role_view(t.movedim(0, -1), stored + ("pair",),
                      roles + ("pair",)).movedim(-1, 0)


def plan_dd_launch(program, index_to_length: dict) -> KernelPlan:
    """Plan *program* (``dd_pairs``) onto ``dd_rows``; raises
    :class:`InvalidParameterError` for what the kernel does not carry and
    for operands not stored by the pair contract."""
    e = program.einsum
    desc = program.descriptor
    lengths = dict(index_to_length)
    not_f64 = sorted({str(dt) for dt in e.arg_to_dtype.values()}
                     - {"float64"})
    if not_f64:
        raise InvalidParameterError(
            f"dd_pairs stores float64 operands as pairs; got {not_f64}")
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError("dd kernel needs exactly one long axis")
    el = long_letters[0]
    if lengths[el] < 1:
        raise InvalidParameterError(f"long axis length {lengths[el]} < 1")
    stored = stored_arg_layouts(program)
    for name in e.all_args:
        if el in stored[name] and stored[name][-1] != el:
            raise InvalidParameterError(
                f"dd kernel: streamed operand {name} must store the long"
                f" axis trailing (got {stored[name]})")
    pair_shapes = {name: (2,) + tuple(lengths[ix] for ix in idx)
                   for name, idx in stored.items()}

    def checked(arrays_by_name: dict) -> dict:
        for name, shape in pair_shapes.items():
            if name not in arrays_by_name:
                raise ValueError(f"missing argument {name!r}")
            if tuple(arrays_by_name[name].shape) != shape:
                raise InvalidParameterError(
                    f"dd kernel: {name} stored shape"
                    f" {tuple(arrays_by_name[name].shape)} != expected pair"
                    f" layout {shape}")
        return arrays_by_name

    if resident_carries_outputs(e, el):
        return _plan_dd_restrict(program, lengths, stored, checked, el)
    plans = [plan_row(e, r) for r in range(e.b)]
    p0 = plans[0]
    x, s, i, j = p0.x_letter, p0.s_letter, p0.i_letter, p0.j_letter
    if any((p.x_letter, p.s_letter, p.i_letter, p.j_letter, p.u_has_s,
            p.F is None) != (x, s, i, j, p0.u_has_s, p0.F is None)
           for p in plans):
        raise InvalidParameterError("rows of the batched einsum plan"
                                    " differently")
    want_out = (0, 2, 1) if x is not None else (1, 0)
    if tuple(desc.out_layout or ()) != want_out:
        raise InvalidParameterError(
            f"dd kernel: out_layout must be the dof-major rotate"
            f" {want_out} (got {desc.out_layout})")
    S = lengths[s] if s is not None else 1
    u_roles = (s if p0.u_has_s else None, j, el)
    r_roles = (s, i, j)
    f_roles = (x if x is not None and x in p0.f_idx else None,
               s if s is not None and s in p0.f_idx else None, el)
    f_shape = (2, lengths[x] if x is not None else 1, S, lengths[el])
    one_launch = desc.multiple_results_in_one_kernel

    def operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)

        def view(arg, roles):
            return _pair_role_view(arrays[arg.name], stored[arg.name], roles)
        return [DDRow(u=view(p.u, u_roles), R=view(p.R, r_roles),
                      F=(None if p.F is None
                         else view(p.F, f_roles).expand(*f_shape)))
                for p in plans]

    def stored_outputs(outs: list) -> list:
        # without an x letter the (2, 1, I, E) output drops its x axis
        return [o[:, 0] if x is None else o for o in outs]

    return KernelPlan(
        kernel="dd_rows", operands=operands,
        run=lambda rows: stored_outputs(dd_rows(
            rows, block_long=desc.block_long, one_launch=one_launch)),
        plain=lambda rows: stored_outputs(dd_rows_plain(rows)))


def _plan_dd_restrict(program, lengths: dict, stored: dict, checked,
                      el: str) -> KernelPlan:
    """A matvec whose resident carries every output letter but the long
    axis onto ``dd_rows``, as ``cuda_emitter._plan_restrict`` plans it onto
    ``dg_rows_f32``: the merged output letters are the kernel's ``i``, as
    views of the stored pair resident and output (no copies)."""
    e = program.einsum
    desc = program.descriptor
    out_letters = stored_out_letters(program)
    if out_letters[-1] != el:
        raise InvalidParameterError(
            f"dd kernel: restriction rows store the long axis trailing in"
            f" the output (got {out_letters})")
    (pos,) = [p for p in range(e.n) if el not in e.in_idx_sets[p]]
    plans = [plan_restrict_row(e, r, stored[e.args[r][pos].name], out_letters,
                               el=el) for r in range(e.b)]
    j, merged = plans[0].j_letter, plans[0].merged
    I, J = int(np.prod([lengths[ix] for ix in merged])), lengths[j]
    out_shape = (2,) + tuple(lengths[ix] for ix in out_letters)

    def r_view(t, letters):
        perm = [1 + letters.index(ix) for ix in merged + (j,)]
        return t.permute(0, *perm).view(2, 1, I, J)

    def operands(arrays_by_name: dict) -> list:
        arrays = checked(arrays_by_name)
        return [DDRow(u=_pair_role_view(arrays[p.u.name], stored[p.u.name],
                                        (None, j, el)),
                      R=r_view(arrays[p.R.name], stored[p.R.name]), F=None)
                for p in plans]

    def stored_outputs(outs: list) -> list:
        return [o.view(out_shape) for o in outs]
    return KernelPlan(
        kernel="dd_rows", operands=operands,
        run=lambda rows: stored_outputs(dd_rows(
            rows, block_long=desc.block_long,
            one_launch=desc.multiple_results_in_one_kernel)),
        plain=lambda rows: stored_outputs(dd_rows_plain(rows)))


def build_dd_executable(program, index_to_length: dict):
    """Compile *program* onto ``dd_rows``; returns ``fn(arrays_by_name) ->
    tuple`` of the b row outputs as (2, [x,] i, E) float32 pairs, from
    operands stored as pairs (:func:`~feinsum_tpu_torch.measure.
    apply_layouts`)."""
    plan = plan_dd_launch(program, index_to_length)

    def fn(arrays_by_name: dict):
        return tuple(plan.run(plan.operands(arrays_by_name)))
    return fn
