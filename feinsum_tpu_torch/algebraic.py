"""
Algebraic rewrites, as in ``feinsum_tpu.algebraic``.

On programs (the einsum is left untouched, the schedule changes):

* :func:`extract_multiplicative_terms_in_sum_reduction_as_subst` names the
  product of some operands (with their private reduction indices summed
  away) as an explicit first schedule step (the DG spaces' ``jfold``);
* :func:`hoist_invariant_multiplicative_terms_in_sum_reduction` hoists a
  reduction's separable factor (explicit positions, or the optimal path);
* :func:`hoist_cses` deduplicates identical schedule steps.

On a user's traced function (:mod:`torch.fx`), the analog of the
reference's jaxpr pass: :func:`hoist_cses_in_graph` collapses the graph's
nodes that compute the same value, and :func:`hoist_cses_in_fn` returns a
callable that evaluates each repeated subexpression once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .codegen.program import EinsumProgram
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
    get_opt_einsum_contraction_schedule,
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


def hoist_invariant_multiplicative_terms_in_sum_reduction(
        program: EinsumProgram,
        invariant_positions: Optional[Sequence[int]] = None
) -> EinsumProgram:
    """Hoist the reduction's separable factor: with *invariant_positions*
    those operands' product becomes the first step; otherwise the
    optimal-path multi-step schedule, which makes the same factorization."""
    if invariant_positions is not None:
        return extract_multiplicative_terms_in_sum_reduction_as_subst(
            program, invariant_positions)
    return program.copy(
        schedule=get_opt_einsum_contraction_schedule(program.einsum))


def hoist_cses(program: EinsumProgram) -> EinsumProgram:
    """Deduplicate identical schedule steps: each distinct computation runs
    once and later steps read the first occurrence."""
    sched = program.schedule
    seen: dict = {}
    alias: dict = {}
    subscripts, result_names, arguments = [], [], []
    for subs, name, step_args in zip(sched.subscripts, sched.result_names,
                                     sched.arguments):
        resolved = tuple(
            IntermediateResult(alias.get(a.name, a.name))
            if isinstance(a, IntermediateResult) else a
            for a in step_args)
        key = (subs, resolved)
        if key in seen and name != "_fe_out":
            alias[name] = seen[key]
            continue
        seen.setdefault(key, name)
        subscripts.append(subs)
        result_names.append(name)
        arguments.append(resolved)
    if len(subscripts) == sched.nsteps:
        return program
    return program.copy(schedule=ContractionSchedule(
        subscripts=tuple(subscripts), result_names=tuple(result_names),
        arguments=tuple(arguments)))


# calls whose result is not a function of their arguments alone
_RANDOM = {"rand", "randn", "randint", "rand_like", "randn_like",
           "randint_like", "randperm", "bernoulli", "multinomial", "normal",
           "dropout", "empty", "empty_like", "uniform_", "normal_"}


def _impure(node) -> bool:
    name = getattr(node.target, "__name__", node.target)
    return (node.is_impure() or not isinstance(name, str)
            or name in _RANDOM or name.endswith("_"))


def _freeze(x, canon: dict):
    """A hashable key of a node argument, with nodes replaced by their
    canonical node."""
    if isinstance(x, torch.fx.Node):
        return ("node", id(canon.get(x, x)))
    if isinstance(x, dict):
        return ("dict",) + tuple(sorted((k, _freeze(v, canon))
                                        for k, v in x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_freeze(v, canon) for v in x)
    if isinstance(x, slice):
        return ("slice", _freeze(x.start, canon), _freeze(x.stop, canon),
                _freeze(x.step, canon))
    if isinstance(x, torch.Tensor):
        return ("tensor", id(x))              # a tensor literal: no merging
    try:
        hash(x)
    except TypeError:
        return ("unhashable", id(x))
    return (type(x).__name__, x)


def hoist_cses_in_graph(gm: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """Hash-cons the graph of a traced function: call nodes computing the
    same value (the same operation on the same, canonicalized, arguments)
    collapse to the first, and every use is rewired to it; ``get_attr``
    nodes of one constant merge the same way.  The graph's other nodes are
    kept: placeholders, the output, calls into submodules, and impure or
    random calls (in-place updates, ``rand``...).

    The expression-level analog of the reference's user-kernel CSE
    (``hoist_cses_in_jaxpr``): tracing does not deduplicate, so a user
    computing ``2*J + 1`` as the operand of two einsum calls makes two
    chains; one is left, which shrinks the matcher's backward slices and the
    consumer path's epilogue replays.  Returns *gm*, recompiled when a node
    was removed."""
    graph = gm.graph
    canon: dict = {}
    seen: dict = {}
    removed = False
    for node in list(graph.nodes):
        if node.op not in ("call_function", "call_method", "get_attr") \
                or (node.op != "get_attr" and _impure(node)):
            continue
        key = (node.op, node.target if node.op != "call_function"
               else id(node.target), _freeze(node.args, canon),
               _freeze(dict(node.kwargs), canon))
        prev = seen.get(key)
        if prev is None:
            seen[key] = node
            continue
        node.replace_all_uses_with(prev)
        canon[node] = prev
        graph.erase_node(node)
        removed = True
    if removed:
        graph.lint()
        gm.recompile()
    return gm


def hoist_cses_in_fn(fn, example_args):
    """A callable computing exactly what *fn* computes, with repeated
    subexpressions evaluated once: *fn* traced by ``torch.fx`` and
    deduplicated by :func:`hoist_cses_in_graph`.  *example_args* are
    accepted for the reference's signature; the trace is symbolic."""
    del example_args
    return hoist_cses_in_graph(torch.fx.symbolic_trace(fn))
