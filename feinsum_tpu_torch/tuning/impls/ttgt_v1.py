"""
TTGT transform space, v1: the layout permutations as structured
:class:`~feinsum_tpu_torch.tuning.PermutationParameter` knobs (a mutation
swaps two axes), on the plain route.

The file name and parameters are those of ``feinsum_tpu``'s space, so its
facts bind here; the rules are those of ``ttgt_v0`` (canonical-relative
operand permutations, ``bf16_3x`` as three passes over the TF32 split).
"""

from __future__ import annotations

from feinsum_tpu_torch.canonicalization import canonical_operand_positions
from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu_torch.contraction_schedule import \
    get_trivial_contraction_schedule
from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.tuning import (
    IntParameter,
    PermutationParameter,
    transform_param,
)
from feinsum_tpu_torch.tuning.impls._common import fp32_precision
from feinsum_tpu_torch.tuning.impls.ttgt_v0 import _canon_rank, \
    _natural_out_perm

_PRECISIONS = ("default", "highest", "bf16_3x")


@transform_param("layout_a",
                 lambda e: PermutationParameter(_canon_rank(e, 0)))
@transform_param("layout_b",
                 lambda e: PermutationParameter(_canon_rank(e, 1)))
@transform_param("layout_out",
                 lambda e: PermutationParameter(len(e.out_idx_set)))
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("natural_out", lambda e: IntParameter(0, 1))
def transform(program, layout_a, layout_b, layout_out, precision_idx,
              natural_out=0):
    e = program.einsum
    if e.n != 2 or e.b != 1 or e.all_size_params:
        raise InvalidParameterError(
            "ttgt_v1 expects a dense 2-operand single-row contraction")
    pos_a, pos_b = canonical_operand_positions(e)
    pa = tuple(int(p) for p in layout_a)
    pb = tuple(int(p) for p in layout_b)
    if len(pa) != len(e.in_idx_sets[pos_a]) \
            or len(pb) != len(e.in_idx_sets[pos_b]):
        raise InvalidParameterError(
            "ttgt_v1: permutation rank does not match the operand")
    layouts = (
        (e.args[0][pos_a].name, pa),
        (e.args[0][pos_b].name, pb),
    )
    if natural_out:
        out_perm = _natural_out_perm(e, pos_a, pos_b, pa, pb)
    else:
        out_perm = tuple(int(p) for p in layout_out)
    return program.copy(
        schedule=get_trivial_contraction_schedule(e),
        descriptor=ScheduleDescriptor(
            backend="xla",
            precision=fp32_precision(_PRECISIONS[precision_idx]),
            arg_layouts=layouts,
            out_layout=out_perm))
