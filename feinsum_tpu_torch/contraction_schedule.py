"""
Multi-step contraction schedules for a batched einsum.

A :class:`ContractionSchedule` decomposes each row's einsum into a sequence of
steps, each with its own subscripts and operand list (original operands or
earlier intermediates).  The trivial schedule has one step; the "optimal"
schedule follows the cheapest pairwise contraction path with parametric dims
treated as very long (reference: ``feinsum/contraction_schedule.py:62-178``).

The path search is this module's own: an exhaustive depth-first search over
pairwise contractions that reproduces ``opt_einsum.contract_path(...,
optimize="optimal", use_blas=False)`` step for step, so the port needs no
``opt_einsum`` at run time.  Its cost is exponential in the operand count;
the einsums this package schedules have at most four operands.
"""

from __future__ import annotations

import bisect
import itertools
import math
from dataclasses import dataclass
from typing import Union

from .einsum import BatchedEinsum, SizeParam

FALLBACK_LONG_DIM_LENGTH = 1_000_000


@dataclass(frozen=True)
class EinsumOperand:
    """Reference to the *i*-th original operand position of the einsum."""

    position: int


@dataclass(frozen=True)
class IntermediateResult:
    """Reference to the result of an earlier schedule step, by name."""

    name: str


ArgumentT = Union[EinsumOperand, IntermediateResult]


@dataclass(frozen=True)
class ContractionSchedule:
    """Per-step: a subscript string (explicit ``->``), a result name, and the
    argument references consumed by that step.  The final step's result name
    is the einsum output."""

    subscripts: tuple
    result_names: tuple
    arguments: tuple

    def __post_init__(self) -> None:
        if not (len(self.subscripts) == len(self.result_names)
                == len(self.arguments)):
            raise ValueError("subscripts, result_names and arguments differ"
                             " in length")
        for subs, args in zip(self.subscripts, self.arguments):
            n_in = len(subs.split("->")[0].split(","))
            if n_in != len(args):
                raise ValueError(
                    f"step '{subs}' expects {n_in} args, got {len(args)}")

    @property
    def nsteps(self) -> int:
        return len(self.subscripts)


def get_trivial_contraction_schedule(einsum: BatchedEinsum
                                     ) -> ContractionSchedule:
    """Single-step schedule computing the whole contraction at once."""
    subs = ",".join("".join(s) for s in einsum.in_idx_sets)
    out = "".join(einsum.out_idx_set)
    return ContractionSchedule(
        subscripts=(f"{subs}->{out}",),
        result_names=("_fe_out",),
        arguments=(tuple(EinsumOperand(i) for i in range(einsum.n)),),
    )


# {{{ optimal pairwise path (opt_einsum's "optimal" algorithm)

def _flop_count(indices, inner: bool, num_terms: int, sizes: dict) -> int:
    factor = max(1, num_terms - 1) + (1 if inner else 0)
    return math.prod(sizes[ix] for ix in indices) * factor


def _optimal_ssa_path(inputs: tuple, output: frozenset, sizes: dict) -> tuple:
    """Depth-first search over every order of pairwise contractions, pruned
    by the best total found so far; the first path reaching the minimum
    wins ties.  Ids are static-single-assignment: an intermediate gets the
    next free id.  Like opt_einsum, the (k12, cost) of a pair is cached on
    the pair's index sets alone."""
    best = {"flops": math.inf, "path": (tuple(range(len(inputs))),)}
    cache: dict = {}

    def visit(path, remaining, inputs, flops):
        if len(remaining) == 1:
            best["flops"], best["path"] = flops, path
            return
        for i, j in itertools.combinations(sorted(remaining), 2):
            key = (inputs[i], inputs[j])
            if key not in cache:
                either = inputs[i] | inputs[j]
                shared = inputs[i] & inputs[j]
                keep = frozenset.union(
                    output, *(inputs[k] for k in remaining - {i, j}))
                cache[key] = (either & keep,
                              _flop_count(either, bool(shared - keep), 2,
                                          sizes))
            k12, cost = cache[key]
            if flops + cost >= best["flops"]:
                continue
            visit(path + ((i, j),), (remaining - {i, j}) | {len(inputs)},
                  inputs + (k12,), flops + cost)

    visit((), frozenset(range(len(inputs))), tuple(inputs), 0)
    return best["path"]


def _ssa_to_linear(ssa_path: tuple) -> list:
    """SSA ids -> positions in the shrinking operand list (contracted
    operands are removed, the result is appended)."""
    n = sum(map(len, ssa_path)) - len(ssa_path) + 1
    ids = list(range(n))
    path = []
    ssa = n
    for scon in ssa_path:
        con = sorted(bisect.bisect_left(ids, s) for s in scon)
        for j in reversed(con):
            ids.pop(j)
        ids.append(ssa)
        path.append(tuple(con))
        ssa += 1
    return path


def optimal_contraction_list(subscripts: str, sizes: dict) -> list:
    """``[(positions, step_subscripts), ...]`` of the cheapest pairwise path
    for *subscripts* (explicit ``->``) with index lengths *sizes*.
    ``positions`` index the current operand list in descending order and
    ``step_subscripts`` is the step's einsum, as in opt_einsum's
    ``PathInfo.contraction_list``."""
    in_spec, out_spec = subscripts.replace(" ", "").split("->")
    input_list = in_spec.split(",")
    input_sets = [frozenset(s) for s in input_list]
    output_set = frozenset(out_spec)
    if len(input_list) <= 2:
        path = [tuple(range(len(input_list)))]
    else:
        path = _ssa_to_linear(
            _optimal_ssa_path(tuple(input_sets), output_set, sizes))

    steps = []
    for k, inds in enumerate(path):
        inds = tuple(sorted(inds, reverse=True))
        picked = [input_sets[i] for i in inds]
        for i in inds:
            input_sets.pop(i)
        contracted = frozenset.union(*picked)
        new_result = output_set.union(*input_sets) & contracted
        input_sets.append(new_result)
        tmp_inputs = [input_list.pop(i) for i in inds]
        if k == len(path) - 1:
            idx_result = out_spec
        else:
            # the order a tensordot would produce (first appearance)
            joined = "".join(tmp_inputs)
            idx_result = "".join(sorted(new_result, key=joined.find))
        input_list.append(idx_result)
        steps.append((inds, ",".join(tmp_inputs) + "->" + idx_result))
    return steps

# }}}


def get_opt_einsum_contraction_schedule(
        einsum: BatchedEinsum, *,
        long_dim_length: int = FALLBACK_LONG_DIM_LENGTH
) -> ContractionSchedule:
    """Schedule following the lowest-flop pairwise contraction path (the
    path ``opt_einsum.contract_path(..., optimize="optimal",
    use_blas=False)`` finds); parametric dims are treated as
    *long_dim_length*-long while costing the path."""
    sizes = {ix: (long_dim_length if isinstance(ln, SizeParam) else int(ln))
             for ix, ln in einsum.index_to_dim_length.items()}
    subs = (",".join("".join(s) for s in einsum.in_idx_sets)
            + "->" + "".join(einsum.out_idx_set))

    operands: list = [EinsumOperand(i) for i in range(einsum.n)]
    subscripts: list = []
    result_names: list = []
    arguments: list = []
    steps = optimal_contraction_list(subs, sizes)
    for k, (inds, step_subs) in enumerate(steps):
        step_args = tuple(operands[i] for i in inds)
        for i in inds:          # descending: pops stay valid
            operands.pop(i)
        name = "_fe_out" if k == len(steps) - 1 else f"_fe_tmp_{k}"
        operands.append(IntermediateResult(name))
        subscripts.append(step_subs)
        result_names.append(name)
        arguments.append(step_args)
    return ContractionSchedule(tuple(subscripts), tuple(result_names),
                               tuple(arguments))
