"""
TTGT (transpose-transpose-GEMM-transpose) transform space of dense
2-operand tensor contractions on the plain route.

The file name and parameters are those of ``feinsum_tpu``'s space, so its
facts bind here.  The choices are the operands' and the output's stored
permutations (``arg_layouts``, ``out_layout``; ``perm_*`` index the
permutations of each rank in ``itertools.permutations`` order) and the
precision (``bf16_3x``: three full-fp32 passes over the TF32 split).  The operand permutations are archived
relative to CANONICAL operand positions (``autotune`` canonicalizes first)
and are routed onto the user's operand positions through
:func:`~feinsum_tpu_torch.canonicalization.canonical_operand_positions`,
and the layouts name the transformed program's own operands.
"""

from __future__ import annotations

import itertools
import math

from feinsum_tpu_torch.canonicalization import canonical_operand_positions
from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu_torch.contraction_schedule import \
    get_trivial_contraction_schedule
from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.tuning import IntParameter, transform_param
from feinsum_tpu_torch.tuning.impls._common import fp32_precision

_PRECISIONS = ("default", "highest", "bf16_3x")


def _perm(ndim: int, idx: int):
    perms = list(itertools.permutations(range(ndim)))
    return perms[idx % len(perms)]


def _natural_out_perm(e, pos_a, pos_b, pa, pb):
    """The output permutation in GEMM-natural order for the chosen operand
    layouts: the lhs free axes (in stored order), then the rhs free axes."""
    a_idx = [e.in_idx_sets[pos_a][p] for p in pa]
    b_idx = [e.in_idx_sets[pos_b][p] for p in pb]
    out_set = set(e.out_idx_set)
    natural = ([ix for ix in a_idx if ix in out_set]
               + [ix for ix in b_idx if ix in out_set
                  and ix not in a_idx])
    return tuple(e.out_idx_set.index(ix) for ix in natural)


def _canon_rank(e, slot):
    """Rank of the operand at CANONICAL position *slot*: the spaces are
    sized against the positions the transform applies permutations to."""
    if e.n <= slot:
        return 1
    return len(e.in_idx_sets[canonical_operand_positions(e)[slot]])


@transform_param("perm_a", lambda e: IntParameter(
    0, math.factorial(_canon_rank(e, 0)) - 1))
@transform_param("perm_b", lambda e: IntParameter(
    0, math.factorial(_canon_rank(e, 1)) - 1))
@transform_param("perm_out", lambda e: IntParameter(
    0, math.factorial(len(e.out_idx_set)) - 1))
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("natural_out", lambda e: IntParameter(0, 1))
def transform(program, perm_a, perm_b, perm_out, precision_idx,
              natural_out=0):
    e = program.einsum
    if e.n != 2 or e.b != 1 or e.all_size_params:
        raise InvalidParameterError(
            "ttgt_v0 expects a dense 2-operand single-row contraction")
    pos_a, pos_b = canonical_operand_positions(e)
    pa = _perm(len(e.in_idx_sets[pos_a]), perm_a)
    pb = _perm(len(e.in_idx_sets[pos_b]), perm_b)
    layouts = (
        (e.args[0][pos_a].name, pa),
        (e.args[0][pos_b].name, pb),
    )
    if natural_out:
        out_perm = _natural_out_perm(e, pos_a, pos_b, pa, pb)
    else:
        out_perm = _perm(len(e.out_idx_set), perm_out)
    return program.copy(
        schedule=get_trivial_contraction_schedule(e),
        descriptor=ScheduleDescriptor(
            backend="xla",
            precision=fp32_precision(_PRECISIONS[precision_idx]),
            arg_layouts=layouts,
            out_layout=out_perm))
