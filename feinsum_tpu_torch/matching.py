"""
Matcher: infer the :class:`BatchedEinsum` a torch computation evaluates.

The port of ``feinsum_tpu.matching``.  Where the reference traces a JAX
callable to a jaxpr, this one traces a torch callable with
``torch.fx.symbolic_trace`` and records every value's shape and dtype with
``torch.fx.passes.shape_prop.ShapeProp`` on the example arguments.  A
``torch.einsum`` call stays one graph node with its subscripts.  Index
labels are unified (union-find) over the grammar's operations:

* ``torch.einsum``; ``@``/``matmul``/``mm``/``bmm`` (equal batch shapes);
* tensor ``*`` (with broadcasting: an operand's size-1 axis stays private
  and is summed over its one value); ``sum`` over axes;
* ``permute``/``transpose``/``.T``/``.t()``/``.mT``; ``unsqueeze``,
  ``expand``/``broadcast_to`` (new and stretched axes get fresh labels);
* ``+``/``-``/``neg`` between einsum values (a sum of instructions);
* ``*`` and ``/`` by a rank-0 factor (a literal joins the instruction's
  ``scale``, a traced scalar its ``scale_vars``);
* ``.to(dtype)``, ``.float()``, ``.double()``, ``.contiguous()``,
  ``.clone()`` (no structural change).

Each input axis gets a fresh label; the final classes become index
letters.  Axes at least ``long_dim_length`` long become
:class:`SizeParam`\\ s, as in the reference.

**The operand-expression seam.**  A value feeding a product or reduction
that was produced outside the grammar (``2 * J + 1``, ``exp(u)``, an
indexing), or is itself a sum, becomes an **opaque operand** named
``expr<k>``; captured constants (``get_attr`` nodes) are opaque operands
too.  ``name_map`` maps a real operand name to its input position and an
expression operand to the tuple of input positions its subtree reads.

A traced function may be a sum of einsums: each maximal product/reduction
subtree is an *instruction*, ``insn_match`` selects among them, and outputs
computed outside the grammar (``tanh(einsum)``) leave their einsum values as
frontier instructions (the epilogue seam), all as in the reference.

Forms ``torch.fx`` cannot carry raise :class:`EinsumMatchError`: a function
whose control flow depends on tensor values (``symbolic_trace`` refuses it),
``matmul`` with broadcast batch axes, an einsum with ``...`` or a repeated
letter within one operand (these last are opaque, as the reference's
lowering makes them).
"""

from __future__ import annotations

import builtins
import inspect
import operator
import string
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from .canonicalization import (
    get_substitution_mapping_between_isomorphic_batched_einsums,
)
from .diagnostics import EinsumMatchError
from .einsum import BatchedEinsum
from .make_einsum import array as make_array, batched_einsum

DEFAULT_LONG_DIM_LENGTH = 500


class _Labels:
    """Union-find over axis labels."""

    def __init__(self) -> None:
        self.parent: list = []

    def fresh(self) -> int:
        self.parent.append(len(self.parent))
        return len(self.parent) - 1

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def unify(self, a: int, b: int) -> None:
        a, b = self.find(a), self.find(b)
        if a != b:
            self.parent[max(a, b)] = min(a, b)

    def copy(self) -> "_Labels":
        out = _Labels()
        out.parent = list(self.parent)
        return out


class _Term:
    """A labeled tensor value in the dataflow: the operand uses it reaches
    back to, the product/contraction structure so far, and the accumulated
    scalar factor.  ``scale`` holds the sign and literal part; traced rank-0
    factors are ``(node, exponent)`` pairs in ``scale_atoms`` (+1 for
    ``x * s``, -1 for ``x / s``)."""

    def __init__(self, labels, operands, contracted, scale=1.0,
                 scale_atoms=()):
        self.labels = tuple(labels)
        self.operands = tuple(operands)      # (source_index, axis labels)
        self.contracted = frozenset(contracted)
        self.scale = scale
        self.scale_atoms = tuple(scale_atoms)

    def with_(self, **changes) -> "_Term":
        fields = dict(labels=self.labels, operands=self.operands,
                      contracted=self.contracted, scale=self.scale,
                      scale_atoms=self.scale_atoms)
        fields.update(changes)
        return _Term(**fields)


class _Sum:
    """A sum of einsum terms sharing the value's axes."""

    def __init__(self, terms):
        self.terms = tuple(terms)


class _Opaque:
    """A value produced outside the einsum grammar: a candidate operand
    expression.  ``deps`` = the input positions its subtree reads;
    ``reason`` explains why it left the grammar."""

    def __init__(self, shape, deps, reason=None):
        self.shape = tuple(shape)
        self.deps = frozenset(deps)
        self.reason = reason


@dataclass(frozen=True)
class _Source:
    """One einsum operand source: a traced input (``origin`` = its int
    position), or an opaque expression / captured constant (``origin`` =
    tuple of the input positions feeding it; ``()`` for constants).
    ``var`` is the producing graph node for expression sources (None for
    traced inputs): :mod:`feinsum_tpu_torch.apply` evaluates the graph's
    backward slice at it."""

    name: str
    shape: tuple
    dtype: np.dtype
    labels: tuple
    origin: Union[int, tuple]
    var: object = None


def _as_terms(val) -> tuple:
    return val.terms if isinstance(val, _Sum) else (val,)


def _mul_scale(a, b):
    return None if (a is None or b is None) else a * b


@dataclass(frozen=True)
class InsnInfo:
    """What ``insn_match`` predicates see about one matched instruction (one
    addend of one traced output): the output it contributes to, its
    position among that output's addends, the argument names of the
    operands it reads (expression operands as ``expr<k>``) and the
    accumulated scalar factor.

    ``scale`` is the product of the instruction's sign and its scalar
    literal factors; ``scale_vars`` holds the graph nodes of traced rank-0
    factors, with ``scale_var_pows`` giving each one's exponent (+1 for
    ``x * s``, -1 for ``x / s``).  A matched einsum evaluates the
    instruction *without* these factors; re-evaluating ``fn`` from matched
    einsums must re-apply them (``compile_fn_with_archive`` does)."""

    out_index: int
    term_index: int
    arg_names: tuple
    flat_index: int
    scale: Optional[float] = 1.0
    scale_vars: tuple = ()
    scale_var_pows: tuple = ()


InsnMatchT = Union[int, tuple, Callable[[InsnInfo], bool], None]


@dataclass(frozen=True)
class Traced:
    """A traced function: the graph module (after :func:`~feinsum_tpu_torch.
    algebraic.hoist_cses_in_graph`), the output's pytree spec and its flat
    leaves (graph nodes or constants)."""

    gm: torch.fx.GraphModule
    out_spec: object
    out_leaves: tuple


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch dtype."""
    return torch.empty(0, dtype=dtype).numpy().dtype


def node_shape(node) -> tuple:
    """The traced value's shape (``()`` for a non-tensor value)."""
    meta = node.meta.get("tensor_meta") if isinstance(
        node, torch.fx.Node) else None
    return tuple(int(s) for s in meta.shape) if hasattr(meta, "shape") \
        else ()


def node_dtype(node) -> Optional[torch.dtype]:
    """The traced value's torch dtype, or None for a non-tensor value."""
    meta = node.meta.get("tensor_meta")
    return meta.dtype if hasattr(meta, "dtype") else None


def get_attr_value(gm, target: str):
    obj = gm
    for part in target.split("."):
        obj = getattr(obj, part)
    return obj


def _trace(fn: Callable, example_args) -> Traced:
    """Trace *fn* on *example_args*: ``symbolic_trace``, the graph-level CSE,
    then ``ShapeProp`` (which runs *fn* once on the example arguments)."""
    from torch.fx.passes.shape_prop import ShapeProp
    from torch.utils._pytree import tree_flatten

    from .algebraic import hoist_cses_in_graph

    try:
        gm = torch.fx.symbolic_trace(fn)
    except Exception as exc:  # noqa: BLE001 - fx raises many kinds
        raise EinsumMatchError(
            f"torch.fx.symbolic_trace cannot trace the function"
            f" ({type(exc).__name__}: {exc})") from exc
    gm = hoist_cses_in_graph(gm)
    ShapeProp(gm).propagate(*example_args)
    (out_node,) = [n for n in gm.graph.nodes if n.op == "output"]
    leaves, spec = tree_flatten(out_node.args[0])
    return Traced(gm, spec, tuple(leaves))


# {{{ the graph's operations in the grammar's terms

_MATMUL = {operator.matmul, torch.matmul, torch.mm, torch.bmm}
_MUL = {operator.mul, torch.mul, torch.multiply}
_DIV = {operator.truediv, torch.div, torch.true_divide, torch.divide}
_ADD = {operator.add, torch.add}
_SUB = {operator.sub, torch.sub, torch.subtract}
_NEG = {operator.neg, torch.neg, torch.negative}
_METHODS = {"matmul": "matmul", "mm": "matmul", "bmm": "matmul",
            "mul": "mul", "multiply": "mul", "div": "div",
            "true_divide": "div", "divide": "div", "add": "add",
            "sub": "sub", "subtract": "sub", "neg": "neg",
            "negative": "neg", "sum": "sum", "permute": "permute",
            "transpose": "transpose", "swapaxes": "transpose", "t": "t",
            "unsqueeze": "unsqueeze", "expand": "broadcast",
            "expand_as": "broadcast", "broadcast_to": "broadcast",
            "to": "convert", "float": "convert", "double": "convert",
            "contiguous": "convert", "clone": "convert"}


def _classify(node) -> tuple:
    """``(primitive, inputs, params)`` of a call node in the grammar's
    terms; ``("opaque", (), None)`` for anything else."""
    t, args, kw = node.target, node.args, dict(node.kwargs)
    opaque = ("opaque", (), None)
    if node.op == "call_function":
        if t is torch.einsum:
            if kw or not isinstance(args[0], str):
                return opaque
            ops = args[1:]
            if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
                ops = tuple(ops[0])
            return "einsum", tuple(ops), {"eq": args[0]}
        if t is builtins.getattr and args[1] in ("T", "mT"):
            return args[1], (args[0],), None
        prim = ("matmul" if t in _MATMUL else "mul" if t in _MUL
                else "div" if t in _DIV else "add" if t in _ADD
                else "sub" if t in _SUB else "neg" if t in _NEG
                else "sum" if t is torch.sum
                else "permute" if t is torch.permute
                else "transpose" if t in (torch.transpose, torch.swapaxes)
                else "t" if t is torch.t
                else "unsqueeze" if t is torch.unsqueeze
                else "broadcast" if t is torch.broadcast_to else None)
    elif node.op == "call_method":
        prim = _METHODS.get(t)
    else:
        return opaque
    if prim is None:
        return opaque
    if prim in ("mul", "div", "add", "sub", "matmul"):
        if kw or len(args) != 2:
            return opaque     # alpha=, rounding_mode=, out=
        return prim, tuple(args), None
    if prim in ("neg", "t", "convert"):
        if prim == "convert" and (kw or any(
                isinstance(a, torch.fx.Node) for a in args[1:])):
            return opaque     # .to(other_tensor), .to(device=...)
        if prim != "convert" and (kw or len(args) != 1):
            return opaque
        return prim, (args[0],), None
    if prim == "sum":
        if set(kw) - {"dim", "keepdim"} or len(args) > 3:
            return opaque     # dtype=
        dim = kw.get("dim", args[1] if len(args) > 1 else None)
        keepdim = kw.get("keepdim", args[2] if len(args) > 2 else False)
        return "sum", (args[0],), {"dim": dim, "keepdim": bool(keepdim)}
    if prim == "permute":
        if kw:
            return opaque
        dims = args[1:]
        if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
            dims = tuple(dims[0])
        return "permute", (args[0],), {"dims": tuple(dims)}
    if prim == "transpose":
        if kw or len(args) != 3:
            return opaque
        return "transpose", (args[0],), {"dims": (args[1], args[2])}
    if prim == "unsqueeze":
        dim = kw.get("dim", args[1] if len(args) > 1 else None)
        if dim is None or set(kw) - {"dim"}:
            return opaque
        return "unsqueeze", (args[0],), {"dim": dim}
    if prim == "broadcast":
        if kw:
            return opaque
        return "broadcast", (args[0],), None
    return opaque

# }}}


def _collect_instructions(fn: Callable, example_args: Sequence, *,
                          arg_names: Optional[Sequence] = None,
                          epilogue: bool = False) -> tuple:
    """Trace *fn* and walk its graph under the (extended) einsum grammar.

    Returns ``(traced, labels, sources, arg_names, out_sums)`` where
    ``traced`` is the :class:`Traced` function, ``sources`` the
    operand-source table (traced inputs first, then opaque expression
    operands) and ``out_sums[k]`` the tuple of einsum instructions
    (:class:`_Term`) whose sum the k-th output computes.

    With ``epilogue=True``, outputs computed outside the grammar do not
    reject: the einsum values feeding them become extra instruction slots
    past the outputs, and a sixth element ``(epi_out, frontier)`` says how
    to rebuild those outputs: ``epi_out`` maps the output index to
    ``("var", node)`` or ``("lit", value)``, ``frontier`` maps each cut
    node to its slot in ``out_sums``."""
    if arg_names is None:
        try:
            sig = inspect.signature(fn)
            arg_names = [p.name for p in sig.parameters.values()
                         if p.kind in (p.POSITIONAL_ONLY,
                                       p.POSITIONAL_OR_KEYWORD)]
        except (TypeError, ValueError):
            arg_names = []
    if len(arg_names) < len(example_args):
        arg_names = list(arg_names) + [
            f"arg{i}" for i in range(len(arg_names), len(example_args))]
    arg_names = list(arg_names)

    traced = _trace(fn, example_args)
    graph = traced.gm.graph
    nodes = list(graph.nodes)
    placeholders = [n for n in nodes if n.op == "placeholder"]

    labels = _Labels()
    env: dict = {}
    sources: list = []
    taken = set(arg_names)

    def add_source(name, shape, dtype, origin, var=None) -> int:
        axis_labels = tuple(labels.fresh() for _ in shape)
        sources.append(_Source(name, tuple(int(s) for s in shape),
                               np.dtype(dtype), axis_labels, origin, var))
        return len(sources) - 1

    def fresh_expr_name() -> str:
        k = 0
        while f"expr{k}" in taken:
            k += 1
        taken.add(f"expr{k}")
        return f"expr{k}"

    def dtype_of(node, example=None) -> np.dtype:
        dt = node_dtype(node)
        if dt is not None:
            return numpy_dtype(dt)
        return np.asarray(example if example is not None else 0.0).dtype

    for i, node in enumerate(placeholders):
        example = example_args[i] if i < len(example_args) else None
        idx = add_source(arg_names[i], node_shape(node),
                         dtype_of(node, example), i)
        env[node] = _Term(sources[idx].labels,
                          [(idx, sources[idx].labels)], ())

    def is_literal(atom) -> bool:
        return not isinstance(atom, torch.fx.Node)

    def is_scalar_literal(atom) -> bool:
        return isinstance(atom, (int, float)) and not isinstance(atom, bool)

    def rank0(atom) -> bool:
        return is_scalar_literal(atom) or (
            not is_literal(atom) and node_shape(atom) == ())

    def deps_of(val) -> frozenset:
        if isinstance(val, _Opaque):
            return val.deps
        deps: set = set()
        for t in _as_terms(val):
            for idx, _ls in t.operands:
                origin = sources[idx].origin
                deps.update((origin,) if isinstance(origin, int) else origin)
        return frozenset(deps)

    def node_deps(node) -> frozenset:
        deps: set = set()
        for iv in node.all_input_nodes:
            deps |= deps_of(env[iv])
        return frozenset(deps)

    expr_memo: dict = {}

    def materialize(atom) -> _Term:
        """The seam: a non-term value (opaque subtree, sum feeding a
        product) becomes a single-operand term backed by a fresh
        ``expr<k>`` source, once per producing node."""
        if is_literal(atom):
            raise EinsumMatchError(
                f"literal {atom!r} is not part of the einsum grammar")
        val = env[atom]
        if isinstance(val, _Term):
            return val
        if atom in expr_memo:
            return expr_memo[atom]
        idx = add_source(fresh_expr_name(), node_shape(atom), dtype_of(atom),
                         tuple(sorted(deps_of(val))), atom)
        t = _Term(sources[idx].labels, [(idx, sources[idx].labels)], ())
        expr_memo[atom] = t
        return t

    def map_terms(val, f):
        terms = tuple(f(t) for t in _as_terms(val))
        return terms[0] if len(terms) == 1 else _Sum(terms)

    def mark_opaque(node, reason=None):
        env[node] = _Opaque(node_shape(node), node_deps(node), reason)

    def structural(node, x, f_term):
        """Unary shape/dtype operations: part of the term on a grammar value,
        part of the operand expression on an opaque one."""
        if is_literal(x):
            mark_opaque(node)
            return
        val = env[x]
        if isinstance(val, _Opaque):
            env[node] = _Opaque(node_shape(node), val.deps)
        else:
            env[node] = map_terms(val, f_term)

    def broadcast_labels(t: _Term, in_shape: tuple, out_shape: tuple):
        """*t*'s labels broadcast to *out_shape*: new leading axes and
        stretched size-1 axes get fresh labels."""
        pad = len(out_shape) - len(in_shape)
        return [labels.fresh() if k < pad or in_shape[k - pad]
                != out_shape[k] else t.labels[k - pad]
                for k in range(len(out_shape))]

    def contract(node, terms, in_subs, out_sub):
        """The product of *terms* with per-operand letters *in_subs*,
        summed to *out_sub* (einsum semantics)."""
        letter_label: dict = {}
        for t, sub in zip(terms, in_subs):
            for lbl, letter in zip(t.labels, sub):
                if letter in letter_label:
                    labels.unify(letter_label[letter], lbl)
                else:
                    letter_label[letter] = lbl
        contracted = set()
        scale, atoms, operands = 1.0, (), ()
        for t in terms:
            contracted |= set(t.contracted)
            scale = _mul_scale(scale, t.scale)
            atoms += t.scale_atoms
            operands += t.operands
        contracted |= {letter_label[c] for c in letter_label
                       if c not in out_sub}
        env[node] = _Term([letter_label[c] for c in out_sub], operands,
                          contracted, scale, atoms)

    for node in nodes:
        if node.op in ("placeholder", "output"):
            continue
        if node.op == "get_attr":
            # a captured constant: an opaque operand with no input deps
            env[node] = _Opaque(node_shape(node), ())
            continue
        prim, ins, params = _classify(node)
        if prim == "einsum":
            eq = params["eq"].replace(" ", "")
            if "..." in eq:
                mark_opaque(node, "einsum with '...'")
                continue
            lhs, _, out_sub = eq.partition("->")
            in_subs = lhs.split(",")
            if "->" not in eq:
                once = [c for c in lhs.replace(",", "")
                        if lhs.replace(",", "").count(c) == 1]
                out_sub = "".join(sorted(once))
            if any(len(set(s)) != len(s) for s in in_subs) \
                    or len(in_subs) != len(ins):
                mark_opaque(node, "einsum with a repeated index in one"
                            " operand")
                continue
            contract(node, [materialize(x) for x in ins], in_subs, out_sub)
        elif prim == "matmul":
            a, b = (materialize(x) for x in ins)
            ra, rb = len(a.labels), len(b.labels)
            if ra == 0 or rb == 0:
                mark_opaque(node)
                continue
            sa = string.ascii_letters[:ra]
            sb = list(string.ascii_letters[ra:ra + rb])
            if rb == 1:
                sb = [sa[-1]]
                out = sa[:-1]
            elif ra == 1:
                sb[-2] = sa[0]
                out = "".join(sb[:-2]) + sb[-1]
            else:
                if ra != rb or node_shape(ins[0])[:-2] \
                        != node_shape(ins[1])[:-2]:
                    raise EinsumMatchError(
                        "matmul with broadcast batch axes is outside the"
                        " einsum grammar; broadcast explicitly")
                sb[:-2] = list(sa[:-2])
                sb[-2] = sa[-1]
                out = sa[:-1] + sb[-1]
            contract(node, [a, b], [sa, "".join(sb)], out)
        elif prim in ("mul", "div"):
            sides = [rank0(v) for v in ins]
            if any(sides):
                if prim == "div" and sides[0]:
                    mark_opaque(node)   # scalar / tensor, scalar / scalar
                    continue
                lit = [is_scalar_literal(v) and s for v, s in zip(ins, sides)]
                pick = (lit.index(True) if any(lit) and prim != "div"
                        else sides.index(True))
                s_atom, other = ins[pick], ins[1 - pick]
                if is_literal(other):
                    mark_opaque(node, reason="scalar constant arithmetic")
                    continue
                factor = None
                if is_scalar_literal(s_atom):
                    factor = (1.0 / s_atom) if prim == "div" else s_atom
                val = env[other]
                if isinstance(val, _Opaque):
                    env[node] = _Opaque(
                        node_shape(node), val.deps | (
                            frozenset() if is_literal(s_atom)
                            else deps_of(env[s_atom])))
                elif factor is None:
                    exp = -1 if prim == "div" else 1
                    env[node] = map_terms(val, lambda t: t.with_(
                        scale_atoms=t.scale_atoms + ((s_atom, exp),)))
                else:
                    env[node] = map_terms(val, lambda t: t.with_(
                        scale=_mul_scale(t.scale, factor)))
                continue
            if prim == "div":
                mark_opaque(node)       # tensor / tensor
                continue
            a, b = (materialize(x) for x in ins)
            out_shape = node_shape(node)
            n = len(out_shape)
            out_labels = []
            for k in range(n):
                cands = []
                for t, x in ((a, ins[0]), (b, ins[1])):
                    shape = node_shape(x)
                    pos = k - (n - len(shape))
                    if pos >= 0 and shape[pos] == out_shape[k]:
                        cands.append(t.labels[pos])
                for lbl in cands[1:]:
                    labels.unify(cands[0], lbl)
                out_labels.append(cands[0])
            env[node] = _Term(out_labels, a.operands + b.operands,
                              set(a.contracted) | set(b.contracted),
                              _mul_scale(a.scale, b.scale),
                              a.scale_atoms + b.scale_atoms)
        elif prim in ("add", "sub"):
            def is_scalar_offset(v):
                if is_scalar_literal(v):
                    return True
                if is_literal(v):
                    return False
                return (node_shape(v) == ()
                        and isinstance(env.get(v), _Opaque))

            if any(is_scalar_offset(v) for v in ins) \
                    or any(is_literal(v) for v in ins):
                mark_opaque(node, reason=(
                    f"'{prim}' with a scalar offset is outside the einsum"
                    f" grammar (only sums of einsum terms are matched)"))
                continue
            out_shape = node_shape(node)
            addends = []
            for k, v in enumerate(ins):
                val = materialize(v) if isinstance(env[v], _Opaque) \
                    else env[v]
                terms = _as_terms(val)
                if node_shape(v) != out_shape:
                    terms = tuple(t.with_(labels=broadcast_labels(
                        t, node_shape(v), out_shape)) for t in terms)
                if k == 1 and prim == "sub":
                    terms = tuple(t.with_(scale=_mul_scale(t.scale, -1.0))
                                  for t in terms)
                addends.extend(terms)
            for t in addends[1:]:
                for la, lb in zip(addends[0].labels, t.labels):
                    labels.unify(la, lb)
            env[node] = _Sum(addends)
        elif prim == "sum":
            x = ins[0]
            if is_literal(x):
                mark_opaque(node)
                continue
            rank = len(node_shape(x))
            dim = params["dim"]
            dims = (range(rank) if dim is None or dim == ()
                    else [dim] if isinstance(dim, int) else list(dim))
            axes = {int(d) % rank for d in dims} if rank else set()
            val = env[x]
            if isinstance(val, _Opaque):
                val = materialize(x)

            def reduce(t, axes=axes, keep=params["keepdim"]):
                kept = [labels.fresh() if d in axes else lbl
                        for d, lbl in enumerate(t.labels)
                        if keep or d not in axes]
                return t.with_(labels=kept, contracted=set(t.contracted)
                               | {t.labels[d] for d in axes})
            env[node] = map_terms(val, reduce)
        elif prim in ("permute", "transpose", "t", "T", "mT"):
            rank = len(node_shape(ins[0]))
            if prim == "permute":
                perm = [int(d) % rank for d in params["dims"]]
            else:
                perm = list(range(rank))
                if prim == "transpose":
                    d0, d1 = (int(d) % rank for d in params["dims"])
                elif prim == "mT":
                    d0, d1 = rank - 2, rank - 1
                else:
                    d0, d1 = 0, max(rank - 1, 0)
                if prim == "T":
                    perm = perm[::-1]
                elif rank >= 2:
                    perm[d0], perm[d1] = perm[d1], perm[d0]
            structural(node, ins[0], lambda t, perm=perm: t.with_(
                labels=[t.labels[p] for p in perm]))
        elif prim == "unsqueeze":
            d = int(params["dim"]) % (len(node_shape(ins[0])) + 1)
            structural(node, ins[0], lambda t, d=d: t.with_(
                labels=t.labels[:d] + (labels.fresh(),) + t.labels[d:]))
        elif prim == "broadcast":
            in_shape, out_shape = node_shape(ins[0]), node_shape(node)
            structural(node, ins[0], lambda t: t.with_(
                labels=broadcast_labels(t, in_shape, out_shape)))
        elif prim == "neg":
            structural(node, ins[0], lambda t: t.with_(
                scale=_mul_scale(t.scale, -1.0)))
        elif prim == "convert":
            structural(node, ins[0], lambda t: t)
        else:
            mark_opaque(node)

    out_sums = []
    epi_out: dict = {}
    first_opaque = None
    for k, leaf in enumerate(traced.out_leaves):
        if not isinstance(leaf, torch.fx.Node):
            if not epilogue:
                raise EinsumMatchError(
                    f"traced output {k} is a constant, not an einsum")
            epi_out[k] = ("lit", leaf)
            out_sums.append(())
            continue
        val = env[leaf]
        if isinstance(val, _Opaque):
            msg = (
                f"traced output {k} is computed entirely by operations"
                f" outside the batched-einsum grammar (no product/reduction"
                f" structure to match)"
                + (f": {val.reason}" if val.reason else ""))
            if not epilogue:
                raise EinsumMatchError(msg)
            if first_opaque is None:
                first_opaque = msg
            epi_out[k] = ("var", leaf)
            out_sums.append(())
            continue
        out_sums.append(_as_terms(val))

    # the epilogue seam: backward-slice from each opaque output and cut at
    # the nodes holding a nontrivial einsum value (frontier instructions)
    frontier: dict = {}
    if epi_out:
        def is_frontier(node):
            val = env.get(node)
            if isinstance(val, _Sum):
                return True
            # trivial single-operand terms are cheaper replayed raw
            return (isinstance(val, _Term)
                    and (bool(val.contracted) or len(val.operands) > 1))

        needed = {v for kind, v in epi_out.values() if kind == "var"}
        fvars: list = []
        for node in reversed(nodes):
            if node not in needed:
                continue
            for iv in node.all_input_nodes:
                if iv.op in ("placeholder", "get_attr"):
                    continue
                if is_frontier(iv):
                    if iv not in fvars:
                        fvars.append(iv)
                else:
                    needed.add(iv)
        # a frontier value that is also a direct traced output reuses that
        # output's slot
        direct_slot = {v: k for k, v in enumerate(traced.out_leaves)
                       if isinstance(v, torch.fx.Node) and k not in epi_out}
        for iv in fvars:
            if iv in direct_slot:
                frontier[iv] = direct_slot[iv]
            else:
                frontier[iv] = len(out_sums)
                out_sums.append(_as_terms(env[iv]))
        if first_opaque is not None and not any(out_sums):
            raise EinsumMatchError(first_opaque)

    ret = traced, labels, sources, arg_names, out_sums
    return ret + ((epi_out, frontier),) if epilogue else ret


def _insn_infos(out_sums, sources) -> list:
    infos, flat = [], 0
    for oi, terms in enumerate(out_sums):
        for ti, term in enumerate(terms):
            names = tuple(dict.fromkeys(
                sources[idx].name for idx, _ in term.operands))
            infos.append(InsnInfo(oi, ti, names, flat, term.scale,
                                  tuple(a for a, _p in term.scale_atoms),
                                  tuple(p for _a, p in term.scale_atoms)))
            flat += 1
    return infos


def _select_instructions(out_sums, sources, insn_match) -> list:
    """Resolve *insn_match* to the list of selected instruction terms."""
    insns = [(oi, ti, term)
             for oi, terms in enumerate(out_sums)
             for ti, term in enumerate(terms)]
    if insn_match is None:
        multi = [oi for oi, terms in enumerate(out_sums) if len(terms) > 1]
        if multi:
            raise EinsumMatchError(
                f"traced output(s) {multi} are sums of "
                f"{[len(t) for t in out_sums]} einsum instructions; pass "
                f"insn_match= to select — a flat instruction index, an "
                f"(out_index, term_index) pair, or a predicate over "
                f"InsnInfo (see get_matched_einsums to enumerate them)")
        return insns
    infos = _insn_infos(out_sums, sources)
    if callable(insn_match):
        selected = [insn for insn, info in zip(insns, infos)
                    if insn_match(info)]
    elif isinstance(insn_match, tuple):
        selected = [insn for insn, info in zip(insns, infos)
                    if (info.out_index, info.term_index) == tuple(insn_match)]
    else:
        selected = [insn for insn, info in zip(insns, infos)
                    if info.flat_index == int(insn_match)]
    if not selected:
        raise EinsumMatchError(
            f"insn_match={insn_match!r} selected no instruction out of "
            f"{[(i.out_index, i.term_index, i.arg_names) for i in infos]}")
    return selected


def _assemble_matched_einsum(labels, sources, selected, *,
                             long_dim_length: int) -> tuple:
    """Build ``(einsum, name_map)`` from selected instruction rows.  Only
    multi-row selections mutate the shared union-find (batch-row
    unification); single-row assembly is read-only."""
    rows = [term for _oi, _ti, term in selected]

    for row in rows[1:]:
        if len(row.labels) != len(rows[0].labels):
            raise EinsumMatchError("batch rows have different output ranks")
        for la, lb in zip(rows[0].labels, row.labels):
            labels.unify(la, lb)
        if len(row.operands) != len(rows[0].operands):
            raise EinsumMatchError(
                "batch rows use different operand counts")
        for (_, ls0), (_, lsk) in zip(rows[0].operands, row.operands):
            if len(ls0) != len(lsk):
                raise EinsumMatchError(
                    "batch rows disagree on operand ranks")
            for la, lb in zip(ls0, lsk):
                labels.unify(la, lb)

    class_size: dict = {}
    for src in sources:
        for lbl, size in zip(src.labels, src.shape):
            root = labels.find(lbl)
            if class_size.setdefault(root, size) != size:
                raise EinsumMatchError(
                    "unified axes have inconsistent lengths — not a valid"
                    " batched einsum")

    letter_of: dict = {}
    taken = {src.name for src in sources}
    letter_pool = iter(c for c in string.ascii_lowercase if c not in taken)

    def letter(lbl: int) -> str:
        root = labels.find(lbl)
        if root not in letter_of:
            try:
                letter_of[root] = next(letter_pool)
            except StopIteration:
                raise EinsumMatchError("more than 26 distinct indices")
        return letter_of[root]

    out_subs = ["".join(letter(l) for l in row.labels) for row in rows]
    if len(set(out_subs)) != 1:
        raise EinsumMatchError(
            f"batch rows disagree on output subscripts: {out_subs}")
    for row in rows:
        if len(set(labels.find(l) for l in row.labels)) != len(row.labels):
            raise EinsumMatchError("output repeats an index")
        op_roots = {labels.find(l) for _idx, ls in row.operands for l in ls}
        orphans = [letter(l) for l in row.labels
                   if labels.find(l) not in op_roots]
        if orphans:
            raise EinsumMatchError(
                f"output ax{'es' if len(orphans) > 1 else 'is'} {orphans} "
                f"come(s) from a broadcast, not from any operand — "
                f"broadcast-created output axes are outside the einsum "
                f"grammar")

    row_ops = [[(idx, "".join(letter(l) for l in ls))
                for idx, ls in row.operands] for row in rows]
    n = len(row_ops[0])
    if any(len(ops) != n for ops in row_ops):
        raise EinsumMatchError("batch rows use different operand counts")
    for j in range(n):
        if len({ops[j][1] for ops in row_ops}) != 1:
            raise EinsumMatchError(
                f"batch rows disagree on operand {j} subscripts")

    def length_of(lbl: int, size: int):
        if size >= long_dim_length:
            return f"N{letter(lbl)}_"
        return int(size)

    arrays = [[make_array(sources[idx].name,
                          [length_of(l, s) for l, s in zip(
                              sources[idx].labels, sources[idx].shape)],
                          sources[idx].dtype)
               for idx, _subs in ops] for ops in row_ops]
    in_spec = ",".join(ops_j[1] for ops_j in row_ops[0])
    einsum = batched_einsum(f"{in_spec}->{out_subs[0]}", arrays)
    used = sorted({idx for row in rows for idx, _ in row.operands})
    name_map = {sources[i].name: sources[i].origin for i in used}
    return einsum, name_map


def get_a_matched_einsum(
        fn: Callable, example_args: Sequence, *,
        long_dim_length: int = DEFAULT_LONG_DIM_LENGTH,
        arg_names: Optional[Sequence] = None,
        insn_match: InsnMatchT = None) -> tuple:
    """Match the traced *fn* against the batched-einsum grammar.

    Returns ``(einsum, name_map)`` where the einsum's operand names are
    *fn*'s parameter names, or ``expr<k>`` for operands that are arbitrary
    expressions or captured constants, and ``name_map`` maps them to input
    positions (``int`` for parameters, a tuple of feeding positions for
    expressions).  If *fn* computes a sum of einsums, *insn_match* selects
    the instruction(s): a flat instruction index, an ``(out_index,
    term_index)`` pair, or a predicate over :class:`InsnInfo`; several
    selected instructions must form batch rows of one einsum.  Einsums
    inside a non-grammar epilogue (``tanh(einsum)``) match too, as frontier
    instructions."""
    _traced, labels, sources, _names, out_sums, _epi = (
        _collect_instructions(fn, example_args, arg_names=arg_names,
                              epilogue=True))
    selected = _select_instructions(out_sums, sources, insn_match)
    return _assemble_matched_einsum(labels, sources, selected,
                                    long_dim_length=long_dim_length)


def get_matched_einsums(
        fn: Callable, example_args: Sequence, *,
        long_dim_length: int = DEFAULT_LONG_DIM_LENGTH,
        arg_names: Optional[Sequence] = None) -> list:
    """Match every einsum instruction of *fn* separately: a list of
    ``(einsum, name_map, InsnInfo)`` triples, one per addend per output
    (frontier instructions of an epilogue included, with ``out_index`` at
    or past the number of outputs).  *fn* is traced once.  Each einsum
    computes its instruction without the instruction's scalar factors:
    re-apply :attr:`InsnInfo.scale` and the traced factors of
    :attr:`InsnInfo.scale_vars` before summing matched einsums back into
    *fn*'s value."""
    _traced, labels, sources, _names, out_sums, _epi = _collect_instructions(
        fn, example_args, arg_names=arg_names, epilogue=True)
    infos = _insn_infos(out_sums, sources)
    insns = [(oi, ti, term)
             for oi, terms in enumerate(out_sums)
             for ti, term in enumerate(terms)]
    out = []
    for info, insn in zip(infos, insns):
        einsum, name_map = _assemble_matched_einsum(
            labels, sources, [insn], long_dim_length=long_dim_length)
        out.append((einsum, name_map, info))
    return out


def match_fn_to_einsum(fn: Callable, example_args: Sequence,
                       ref_einsum: BatchedEinsum, *,
                       long_dim_length: int = DEFAULT_LONG_DIM_LENGTH,
                       insn_match: InsnMatchT = None) -> dict:
    """Map *ref_einsum*'s entity names onto the names used by *fn*
    (*insn_match* selects a sub-instruction of a composite *fn*)."""
    matched, _ = get_a_matched_einsum(
        fn, example_args, long_dim_length=long_dim_length,
        insn_match=insn_match)
    return get_substitution_mapping_between_isomorphic_batched_einsums(
        ref_einsum, matched)


# the reference's aliases
identify_as_einsum = get_a_matched_einsum
match_t_unit_to_einsum = match_fn_to_einsum


def get_call_ids(fn: Callable, example_args: Sequence) -> frozenset:
    """The operand names a matched callable consumes."""
    einsum, name_map = get_a_matched_einsum(fn, example_args)
    return frozenset(name_map)


def abstract_long_axes(einsum: BatchedEinsum, *,
                       long_dim_length: int = DEFAULT_LONG_DIM_LENGTH
                       ) -> BatchedEinsum:
    """Promote every concrete axis >= *long_dim_length* to a
    :class:`SizeParam` (named ``N<index>_``), so concrete user shapes match
    parametric archive entries."""
    lengths = einsum.index_to_dim_length
    promote = {ix for ix, ln in lengths.items()
               if isinstance(ln, (int, np.integer)) and ln >= long_dim_length}
    if not promote:
        return einsum
    args = [[make_array(arg.name,
                        [f"N{ix}_" if ix in promote else ln
                         for ix, ln in zip(idx_set, arg.shape)],
                        arg.dtype)
             for arg, idx_set in zip(row, einsum.in_idx_sets)]
            for row in einsum.args]
    subs = (",".join("".join(s) for s in einsum.in_idx_sets)
            + "->" + "".join(einsum.out_idx_set))
    return batched_einsum(subs, args)


def map_names(ref_einsum: BatchedEinsum, user_einsum: BatchedEinsum) -> dict:
    """Substitution map ref names -> user names (for applying an archived,
    canonically-named transform to a user's program)."""
    return get_substitution_mapping_between_isomorphic_batched_einsums(
        ref_einsum, user_einsum)
