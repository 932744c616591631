"""
The lane-pack rewrites on the card: their resident operands and the plan of
a packed DG program.

A lane-pack rewrite (``tuning/impls/_common.py::rewrite_lane_pack`` and
``rewrite_lane_pack_dg``, the reference's) stores g consecutive elements in
one packed row.  The streamed operands' packing is a free view
(:func:`~feinsum_tpu_torch.measure.apply_layouts`); the residents are
built here, on the card, once per call (:func:`expand_residents`):

* each ``descriptor.kron_args`` operand, transposed by its perm, becomes
  the block-diagonal ``kron(I_g, R[m])`` over its last two axes (a vector x
  becomes ``kron(I_g, x[:, None])``);
* each ``descriptor.lane_pack_expand`` entry is a 0/1 expansion matrix:
  ``(name, "P", g, d, dtype)`` gives P[a, f·d + k] = (a == f), shape
  (g, g·d); ``(name, "A", g, s, d, dtype)`` gives A[t, a·s + u, f·d + k] =
  (a == f)(u == t), shape (s, g·s, g·d).

A packed matvec or vecmat is a plain matvec over g·d and is planned as any
DG row.  A packed DG program has four operands, ``J'``, ``EXP``, ``T`` and
``u'`` in that order, and the three-step schedule

    V[m..., e, gi]     = Σ_gj u'[lam_u..., e, gj] · T[m..., gi, gj]
    W[w..., e, gi]     = Σ_pk J'[lam_j..., e, pk] · EXP[s?, pk, gi]
    out[chi..., e, gi] = Σ over the shared letters not in chi of V · W

where W's leading letters ``w`` are EXP's ``s`` (variant A, div's J (e, s))
or J's ``lam_j`` (variant B).  :func:`plan_lane_pack_dg` reads these
letters off the rewritten einsum and :func:`lane_pack_dg_shape` turns them
into the index maps of ``lane_pack_dg_f32``
(:class:`~feinsum_tpu_torch.ops.kernels.LanePackDGShape`).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from ..diagnostics import InvalidParameterError
from ..einsum import BatchedEinsum, SizeParam


def _kron_eye(a: torch.Tensor, g: int) -> torch.Tensor:
    """``kron(I_g, a[m])`` over the last two axes of *a*, batched over the
    leading ones: (m..., d_i, d_j) -> (m..., g·d_i, g·d_j)."""
    eye = torch.eye(g, dtype=a.dtype, device=a.device)
    t = torch.einsum("ab,...ij->...aibj", eye, a)
    return t.reshape(*a.shape[:-2], g * a.shape[-2], g * a.shape[-1])


def _expansion_matrix(entry: tuple, device) -> torch.Tensor:
    """The 0/1 matrix of one ``descriptor.lane_pack_expand`` entry."""
    from ..codegen.program import torch_dtype
    kind = entry[1]
    if kind == "P":
        _name, _kind, g, d, dt = entry
        p = torch.eye(g, dtype=torch_dtype(dt), device=device)
        return p[:, :, None].expand(g, g, d).reshape(g, g * d)
    if kind == "A":
        _name, _kind, g, s, d, dt = entry
        eye_g = torch.eye(g, dtype=torch_dtype(dt), device=device)
        eye_s = torch.eye(s, dtype=torch_dtype(dt), device=device)
        # [t, a, u, f, k] = (a == f)(u == t)
        a5 = eye_s.T[:, None, :, None, None] * eye_g[None, :, None, :, None]
        return a5.expand(s, g, s, g, d).reshape(s, g * s, g * d)
    raise InvalidParameterError(f"lane_pack_expand entry {entry!r}: unknown"
                                f" kind {kind!r}")


def expand_residents(program, arrays: dict) -> dict:
    """*arrays* (the stored operands) with each ``kron_args`` resident
    expanded and each ``lane_pack_expand`` matrix added, on the device of
    the operands: the arguments the rewritten program's kernels read.  A
    kron-expanded resident must be stored in its logical axis order."""
    desc = program.descriptor
    g = desc.lane_pack
    out = dict(arrays)
    layouts = desc.arg_layouts_map
    for entry in desc.kron_args:
        name, perm = entry if isinstance(entry, tuple) else (entry, None)
        stored = layouts.get(name)
        if stored is not None and tuple(stored) != tuple(range(len(stored))):
            raise InvalidParameterError(
                f"kron_args resident {name!r} has a stored permutation"
                f" {layouts[name]}; it is expanded in its logical order")
        a = out[name]
        if perm is not None:
            a = a.permute(*(int(p) for p in perm))
        if a.ndim == 1:
            a = a[:, None]
        out[name] = _kron_eye(a, g).contiguous()
    device = next(iter(arrays.values())).device
    for entry in desc.lane_pack_expand:
        out[entry[0]] = _expansion_matrix(entry, device)
    return out


@dataclass(frozen=True)
class LanePackDGPlan:
    """The letters of a packed DG program (:func:`plan_lane_pack_dg`): the
    long axis ``e``, the packed output and contracted lanes ``i`` and
    ``j``, J's packed lanes ``pk``; T's leading letters ``m``, u's
    ``lam_u``, J's ``lam_j``, EXP's ``exp_lead`` (variant A: ``(s,)``,
    variant B: none), W's ``w_lead`` (``exp_lead`` in variant A, ``lam_j``
    in B) and the output's ``chi``."""

    e_letter: str
    i_letter: str
    j_letter: str
    pk_letter: str
    m: tuple
    lam_u: tuple
    lam_j: tuple
    exp_lead: tuple
    w_lead: tuple
    chi: tuple
    variant: str


# operand positions of a packed DG program (rewrite_lane_pack_dg)
J_POS, EXP_POS, T_POS, U_POS = range(4)


def plan_lane_pack_dg(e: BatchedEinsum) -> LanePackDGPlan:
    """Read the structure of a packed DG program's einsum, whose operands
    are ``J'``, ``EXP``, ``T``, ``u'`` with subscripts ``(lam_j..., e,
    pk)``, ``(s?, pk, i)``, ``(m..., i, j)``, ``(lam_u..., e, j)`` and
    output ``(chi..., e, i)``; raises :class:`InvalidParameterError` for
    any other einsum, naming what does not fit."""
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if e.n != 4 or len(long_letters) != 1:
        raise InvalidParameterError(
            "a packed DG program has four operands (J', EXP, T, u') and one"
            f" long axis; got {e.n} operands, long axes {long_letters}")
    el = long_letters[0]
    j_s, x_s, t_s, u_s = (tuple(s) for s in e.in_idx_sets)
    out = tuple(e.out_idx_set)
    if len(out) < 2 or out[-2] != el:
        raise InvalidParameterError(
            f"a packed DG program's output ends in (e, i), got {out}")
    i = out[-1]
    if len(t_s) < 2 or t_s[-2] != i or len(u_s) < 2 or u_s[-2] != el \
            or u_s[-1] != t_s[-1]:
        raise InvalidParameterError(
            f"a packed DG program's T is (m..., i, j) and u' (lam_u..., e,"
            f" j); got {t_s} and {u_s}")
    j = t_s[-1]
    if len(j_s) < 2 or j_s[-2] != el or len(x_s) < 2 \
            or x_s[-2:] != (j_s[-1], i):
        raise InvalidParameterError(
            f"a packed DG program's J' is (lam_j..., e, pk) and EXP (s?, pk,"
            f" i); got {j_s} and {x_s}")
    pk = j_s[-1]
    m, lam_u, lam_j, exp_lead, chi = t_s[:-2], u_s[:-2], j_s[:-2], \
        x_s[:-2], out[:-2]
    if exp_lead:
        variant, w_lead = "A", exp_lead
        if lam_j or len(exp_lead) != 1:
            raise InvalidParameterError(
                f"variant A (EXP (s, pk, i)) takes J' (e, pk); got {j_s}")
    else:
        variant, w_lead = "B", lam_j
    if not set(lam_u) <= set(m) or not set(chi) <= set(m) | set(w_lead) \
            or el in m + w_lead + chi:
        raise InvalidParameterError(
            f"a packed DG program's u' letters {lam_u} lie in T's {m} and"
            f" its output letters {chi} in T's or W's {w_lead}")
    return LanePackDGPlan(e_letter=el, i_letter=i, j_letter=j, pk_letter=pk,
                          m=m, lam_u=lam_u, lam_j=lam_j, exp_lead=exp_lead,
                          w_lead=w_lead, chi=chi, variant=variant)


def lane_pack_dg_shape(e: BatchedEinsum, split: bool = False):
    """The index maps of ``lane_pack_dg_f32`` (``lane_pack_dg_3xtf32`` with
    *split*) for a packed DG program's einsum
    (:class:`~feinsum_tpu_torch.ops.kernels.LanePackDGShape`): every
    assignment of T's and W's leading letters is one term ``out[o] +=
    V[m] · W[w]``; the terms are ordered by m, so that the kernel computes
    each V once.  Raises :class:`InvalidParameterError` for a program the
    kernel does not take (:func:`~feinsum_tpu_torch.ops.kernels.
    check_lane_pack_dg_shape`)."""
    from .kernels import LanePackDGShape, check_lane_pack_dg_shape

    p = plan_lane_pack_dg(e)
    lengths = {ix: int(ln) for ix, ln in e.index_to_dim_length.items()
               if not isinstance(ln, SizeParam)}
    letters = tuple(dict.fromkeys(p.m + p.w_lead + p.chi))

    def ravel(group: tuple, assign: dict) -> int:
        return int(np.ravel_multi_index(
            tuple(assign[ix] for ix in group),
            tuple(lengths[ix] for ix in group))) if group else 0

    def count(group: tuple) -> int:
        return int(np.prod([lengths[ix] for ix in group], dtype=np.int64))

    u_of_m = [0] * count(p.m)
    j_of_w = [0] * count(p.w_lead)
    exp_of_w = [0] * count(p.w_lead)
    pairs = []
    for values in itertools.product(*(range(lengths[ix])
                                      for ix in letters)):
        assign = dict(zip(letters, values))
        mv, wv = ravel(p.m, assign), ravel(p.w_lead, assign)
        u_of_m[mv] = ravel(p.lam_u, assign)
        j_of_w[wv] = ravel(p.lam_j, assign)
        exp_of_w[wv] = ravel(p.exp_lead, assign)
        pairs.append((mv, wv, ravel(p.chi, assign)))
    shape = LanePackDGShape(
        u_of_m=tuple(u_of_m), j_of_w=tuple(j_of_w),
        exp_of_w=tuple(exp_of_w), pairs=tuple(sorted(pairs)),
        n_out=count(p.chi), gi=lengths[p.i_letter])
    check_lane_pack_dg_shape(shape, split)
    return shape
