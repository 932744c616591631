"""
Algebraic schedule rewrites, as in ``feinsum_tpu.algebraic``: the subset
that the DG spaces' ``jfold`` knob needs.

:func:`extract_multiplicative_terms_in_sum_reduction_as_subst` names the
product of some operands (with their private reduction indices summed
away) as an explicit first schedule step.  It returns a rescheduled program
and leaves the einsum untouched.
"""

from __future__ import annotations

from typing import Sequence

from .codegen.program import EinsumProgram
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
)
from .einsum import BatchedEinsum


def _step_for_positions(einsum: BatchedEinsum, positions: Sequence[int]
                        ) -> tuple:
    """``(subscripts, result letters)`` of the step contracting the operands
    at *positions*: the result keeps every index that the remaining
    operands or the output use."""
    used_elsewhere = set(einsum.out_idx_set)
    for j in range(einsum.n):
        if j not in positions:
            used_elsewhere |= set(einsum.in_idx_sets[j])
    in_subs = ["".join(einsum.in_idx_sets[j]) for j in positions]
    step_letters = []
    for s in in_subs:
        for letter in s:
            if letter not in step_letters:
                step_letters.append(letter)
    out_sub = "".join(c for c in step_letters if c in used_elsewhere)
    return f"{','.join(in_subs)}->{out_sub}", out_sub


def extract_multiplicative_terms_in_sum_reduction_as_subst(
        program: EinsumProgram, positions: Sequence[int], *,
        tmp_name: str = "_fe_tmp_hoist") -> EinsumProgram:
    """Reschedule so that the product of the operands at *positions*
    becomes an explicit first step, then one step contracts it with the
    rest (the schedule of ``feinsum_tpu.algebraic``'s function of the same
    name)."""
    e = program.einsum
    positions = sorted(positions)
    if not positions or not all(0 <= p < e.n for p in positions):
        raise ValueError(f"invalid operand positions {positions}")
    if len(positions) == e.n:
        raise ValueError("cannot hoist every operand")

    step1_subs, tmp_sub = _step_for_positions(e, positions)
    rest = [j for j in range(e.n) if j not in positions]
    in2 = [tmp_sub] + ["".join(e.in_idx_sets[j]) for j in rest]
    step2_subs = f"{','.join(in2)}->{''.join(e.out_idx_set)}"
    return program.copy(schedule=ContractionSchedule(
        subscripts=(step1_subs, step2_subs),
        result_names=(tmp_name, "_fe_out"),
        arguments=(tuple(EinsumOperand(p) for p in positions),
                   (IntermediateResult(tmp_name),)
                   + tuple(EinsumOperand(j) for j in rest))))
