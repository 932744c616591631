"""
The DG row planner: classify one row of a batched einsum as

    out[x?, e, i] = Σ_s F[x?, s?, e] · Σ_j R[s?, i, j] · u[s?, e, j]

Framework-free.  The same classification as ``feinsum_tpu.ops.dd_emitter.
_recognize_row`` (the family of the reference's ``xre_rij_xej_to_ei*``,
``e_ij_ej_to_ei*``, ``xre_rij_ej_to_xei*`` and ``ijf_fe_fej_to_ei*`` rows):

* ``u`` is the streamed dof operand (e, j), possibly carrying ``s``
  (face-mass's flux);
* ``R`` is the single resident operand over {s?, i, j};
* ``F`` is an optional streamed factor over any subset of {x, s} plus e
  (div's Jacobian (e, s), grad's (x, s, e), mass's (e,));
* ``x`` is an extra output axis carried only by F (grad).

For div-like rows (two (e, letter) streams, both letters contracted — the
sum is symmetric in (s, j)) the longer letter becomes j, the inner dot.
The fused CUDA kernel ``dg_rows_f32`` computes exactly this family, and
the fp64 kernel ``dd_rows`` the same family in float64.

Rows whose output is the long axis alone (vecmat ``ej,j->e``, rowsum
``ej->e``) have no ``i`` and no resident matrix: :func:`plan_reduce_row`
classifies them as ``out[e] = Σ_j w[j] · u[e, j]`` for ``row_reduce_f32``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..diagnostics import InvalidParameterError
from ..einsum import Array, BatchedEinsum, SizeParam


@dataclass(frozen=True)
class RowPlan:
    """One batch row classified for the DG row kernels.  ``*_idx`` are the
    operands' logical index letters; ``F`` is ``None`` when the row has no
    streamed factor (matvec)."""

    u: Array
    u_idx: tuple
    R: Array
    r_idx: tuple
    F: Optional[Array]
    f_idx: tuple
    e_letter: str
    i_letter: str
    j_letter: str
    s_letter: Optional[str]
    x_letter: Optional[str]
    u_has_s: bool


def plan_row(e: BatchedEinsum, row: int) -> RowPlan:
    """Classify batch row *row* of *e*; raises
    :class:`InvalidParameterError` outside the family."""
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError("DG rows need exactly one long axis")
    el = long_letters[0]
    out = tuple(e.out_idx_set)
    if len(out) == 2 and out[0] == el:
        x_letter, i = None, out[1]
    elif len(out) == 3 and out[1] == el:
        x_letter, i = out[0], out[2]
    else:
        raise InvalidParameterError(
            "DG rows expect output (e, i) or (x, e, i) with the long axis"
            " before i")
    streams, resident = [], []
    for arg, idx in zip(e.args[row], e.in_idx_sets):
        idx = tuple(idx)
        (streams if el in idx else resident).append((arg, idx))
    if len(resident) != 1:
        raise InvalidParameterError(
            "DG rows need exactly one resident operand")
    R, r_idx = resident[0]
    if i not in r_idx or el in r_idx or len(r_idx) > 3 \
            or (x_letter is not None and x_letter in r_idx):
        raise InvalidParameterError(
            "DG rows: the resident operand must be (s?, i, j)")
    contracted = [ix for ix in r_idx if ix != i]
    if not 1 <= len(contracted) <= 2 or not 1 <= len(streams) <= 2:
        raise InvalidParameterError(
            "DG rows: unsupported operand structure (want the DG"
            " matvec/mass/div/grad/curl/face family)")

    def free(op):
        return set(op[1]) - {el}

    if len(streams) == 1:
        u_op, f_op = streams[0], None
    elif x_letter is not None:
        # grad: the factor is the operand carrying x
        withx = [op for op in streams if x_letter in op[1]]
        if len(withx) != 1:
            raise InvalidParameterError(
                "DG rows: the extra output axis must come from exactly one"
                " streamed factor")
        f_op = withx[0]
        u_op = streams[1 - streams.index(f_op)]
    elif any(not free(op) for op in streams):
        # mass/curl: a bare (e,) factor
        f_op = next(op for op in streams if not free(op))
        u_op = streams[1 - streams.index(f_op)]
    elif any(free(a) < free(b) for a in streams for b in streams):
        # face: flux (s, e, j) carries a superset of Fj (s, e)
        u_op = max(streams, key=lambda op: len(free(op)))
        f_op = streams[1 - streams.index(u_op)]
    elif all(len(free(op)) == 1 for op in streams) \
            and {next(iter(free(op))) for op in streams} == set(contracted):
        # div: symmetric in (s, j) — the longer letter is j (the inner dot)
        a, b = streams
        la, lb = next(iter(free(a))), next(iter(free(b)))
        if int(e.index_to_dim_length[la]) >= int(e.index_to_dim_length[lb]):
            u_op, f_op = a, b
        else:
            u_op, f_op = b, a
    else:
        raise InvalidParameterError(
            "DG rows: unsupported operand structure (want the DG"
            " matvec/mass/div/grad/curl/face family)")

    j_cands = [ix for ix in free(u_op)
               if ix in contracted
               and (f_op is None or ix not in f_op[1])]
    if len(j_cands) != 1:
        raise InvalidParameterError(
            "DG rows: cannot identify the inner dot axis")
    j_letter = j_cands[0]
    s_cands = [ix for ix in contracted if ix != j_letter]
    s_letter = s_cands[0] if s_cands else None
    # every letter must now be accounted for
    u_extra = free(u_op) - {j_letter, s_letter}
    f_extra = (free(f_op) - {x_letter, s_letter}) if f_op else set()
    if u_extra or f_extra:
        raise InvalidParameterError(
            f"DG rows: unrecognized operand axes {u_extra | f_extra}")
    if x_letter is not None and (f_op is None or x_letter not in f_op[1]):
        raise InvalidParameterError(
            "DG rows: the extra output axis must be carried by the streamed"
            " factor")
    return RowPlan(
        u=u_op[0], u_idx=u_op[1], R=R, r_idx=r_idx,
        F=f_op[0] if f_op else None, f_idx=f_op[1] if f_op else (),
        e_letter=el, i_letter=i, j_letter=j_letter, s_letter=s_letter,
        x_letter=x_letter, u_has_s=s_letter in u_op[1])


@dataclass(frozen=True)
class ReduceRowPlan:
    """One batch row classified for ``row_reduce_f32``: the streamed ``u``
    over (e, j) and the optional resident weight ``w`` over (j,)."""

    u: Array
    u_idx: tuple
    w: Optional[Array]
    e_letter: str
    j_letter: str


def plan_reduce_row(e: BatchedEinsum, row: int) -> ReduceRowPlan:
    """Classify batch row *row* of *e* as ``out[e] = Σ_j w[j] u[e, j]``;
    raises :class:`InvalidParameterError` outside that family."""
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1 or tuple(e.out_idx_set) != (long_letters[0],):
        raise InvalidParameterError(
            "reduce rows need the output to be the long axis alone")
    el = long_letters[0]
    streams, resident = [], []
    for arg, idx in zip(e.args[row], e.in_idx_sets):
        (streams if el in idx else resident).append((arg, tuple(idx)))
    if len(streams) != 1 or len(streams[0][1]) != 2:
        raise InvalidParameterError(
            "reduce rows need one streamed (e, j) operand")
    u, u_idx = streams[0]
    (j,) = [ix for ix in u_idx if ix != el]
    if len(resident) > 1 or (resident and resident[0][1] != (j,)):
        raise InvalidParameterError(
            "reduce rows take at most one resident (j,) weight")
    return ReduceRowPlan(u=u, u_idx=u_idx,
                         w=resident[0][0] if resident else None,
                         e_letter=el, j_letter=j)
