"""
Core IR: immutable batched-einsum expressions.

A :class:`BatchedEinsum` records ``b`` einsums that share one subscript string,
each consuming ``n`` operand arrays.  Axis lengths may be concrete integers or
symbolic :class:`SizeParam`\\ s ("infinitely long" axes, e.g. the element axis of a
DG discretization) — the parametric axis is the one a CUDA kernel splits
across thread blocks.

Framework-free: the same IR as ``feinsum_tpu.einsum`` (and the reference's
``feinsum/einsum.py:27-387`` in kaushikcfd/feinsum), so programs carry across
between the two packages field for field.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, replace
from functools import cached_property, reduce
from typing import Union

import numpy as np

IntegralT = Union[int, np.integer]
INT_CLASSES = (int, np.integer)


@dataclass(frozen=True)
class SizeParam:
    """A symbolic (parametric) axis length, identified by name."""

    name: str

    def __repr__(self) -> str:
        return f"SizeParam({self.name!r})"


ShapeComponentT = Union[IntegralT, SizeParam]
ShapeT = tuple  # tuple[ShapeComponentT, ...]


@dataclass(frozen=True)
class Array:
    """A named, typed, multidimensional array operand.

    :attr name: operand name (unique within a :class:`BatchedEinsum`).
    :attr shape: per-axis lengths; each entry an int or a :class:`SizeParam`.
    :attr dtype: numpy dtype of the array's elements.
    """

    name: str
    shape: ShapeT
    dtype: np.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def copy(self, *, name=None, shape=None, dtype=None) -> "Array":
        return replace(
            self,
            name=self.name if name is None else name,
            shape=self.shape if shape is None else tuple(shape),
            dtype=self.dtype if dtype is None else np.dtype(dtype),
        )


@dataclass(frozen=True)
class EinsumAxisAccess:
    """Abstract base for how an einsum index is accessed."""

    def __post_init__(self) -> None:
        if type(self) is EinsumAxisAccess:
            raise TypeError("EinsumAxisAccess is abstract; use FreeAxis or "
                            "SummationAxis.")


@dataclass(frozen=True)
class FreeAxis(EinsumAxisAccess):
    """An index that appears in the output, at position :attr:`output_index`."""

    output_index: int


@dataclass(frozen=True)
class SummationAxis(EinsumAxisAccess):
    """A contracted ("dummy") index, numbered by first appearance."""

    index: int


_SINGLE_LETTER = re.compile(r"^[a-z]$")


@dataclass(frozen=True)
class BatchedEinsum:
    """A batch of ``b`` einsums sharing one subscript with ``n`` operands each.

    :attr out_idx_set: output subscript letters, in order.
    :attr in_idx_sets: per-operand-position subscript letters.
    :attr args: ``b x n`` matrix of :class:`Array` operands.  Rows may share
        operands; the same name must always denote the same (shape, dtype).
    """

    out_idx_set: tuple
    in_idx_sets: tuple
    args: tuple

    def __post_init__(self) -> None:
        if not all(isinstance(ix, str) and _SINGLE_LETTER.match(ix)
                   for ix in self.out_idx_set):
            raise AssertionError(
                "output subscripts (right of '->') must be single"
                " letters")
        if not all(isinstance(ix, str) and _SINGLE_LETTER.match(ix)
                   for idx_set in self.in_idx_sets for ix in idx_set):
            raise AssertionError(
                "input subscripts (left of '->') must be single"
                " letters")
        all_in = reduce(frozenset.union,
                        (frozenset(s) for s in self.in_idx_sets), frozenset())
        if not frozenset(self.out_idx_set) <= all_in:
            raise AssertionError(
                "Obtained an out index which is not present in the input"
                " indices.")
        if not all(len(row) == len(self.in_idx_sets) for row in self.args):
            raise AssertionError(
                "Mismatch in #operands between subscript expression and input"
                " arrays.")
        for row in self.args:
            for arg, idx_set in zip(row, self.in_idx_sets):
                if arg.ndim != len(idx_set):
                    raise AssertionError(
                        "Dimensionality of input operands do not match the"
                        " provided subscripts.")
        # trigger consistency checks
        _ = self.arg_to_dtype
        _ = self.arg_to_shape
        _ = self.index_to_dim_length
        n_names = (len(self.all_args) + len(self.all_indices)
                   + len(self.all_size_params))
        pooled = (self.all_args | self.all_indices
                  | {p.name for p in self.all_size_params})
        if n_names != len(pooled):
            raise AssertionError(
                "Must use different names for arguments, indices, and size"
                " params.")

    # -- derived structure ------------------------------------------------

    @cached_property
    def b(self) -> int:
        """Number of einsums in the batch."""
        return len(self.args)

    @cached_property
    def n(self) -> int:
        """Number of operands of each einsum in the batch."""
        return len(self.in_idx_sets)

    @cached_property
    def index_to_dim_length(self) -> dict:
        """Map index letter -> axis length (int or :class:`SizeParam`)."""
        out: dict = {}
        for row in self.args:
            for arg, idx_set in zip(row, self.in_idx_sets):
                if len(arg.shape) != len(idx_set):
                    raise AssertionError("shape/subscript rank mismatch")
                for axis_len, ix in zip(arg.shape, idx_set):
                    if out.setdefault(ix, axis_len) != axis_len:
                        raise AssertionError(
                            "Shape mismatch for indices across the arguments.")
        return out

    @cached_property
    def shape(self) -> ShapeT:
        """Shape of each output of the batched einsum."""
        return tuple(self.index_to_dim_length[ix] for ix in self.out_idx_set)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def get_subscripts(self) -> str:
        """The einsum subscript string, e.g. ``"xre,rij,ej -> xei"``."""
        ins = ",".join("".join(s) for s in self.in_idx_sets)
        return f"{ins} -> {''.join(self.out_idx_set)}"

    @cached_property
    def arg_to_shape(self) -> dict:
        out: dict = {}
        for row in self.args:
            for arg in row:
                if out.setdefault(arg.name, arg.shape) != arg.shape:
                    raise AssertionError(
                        f"Inconsistent shapes for arg {arg.name}.")
        return out

    @cached_property
    def arg_to_dtype(self) -> dict:
        out: dict = {}
        for row in self.args:
            for arg in row:
                if out.setdefault(arg.name, arg.dtype) != arg.dtype:
                    raise AssertionError(
                        f"Inconsistent dtypes for arg {arg.name}.")
        return out

    @cached_property
    def index_to_access_descr(self) -> dict:
        out: dict = {}
        for pos, ix in enumerate(self.out_idx_set):
            out[ix] = FreeAxis(pos)
        i_redn = 0
        for idx_set in self.in_idx_sets:
            for ix in idx_set:
                if ix not in out:
                    out[ix] = SummationAxis(i_redn)
                    i_redn += 1
        return out

    @cached_property
    def sum_indices(self) -> tuple:
        """Contraction index letters, ordered by first appearance."""
        sums = {ix: acc.index for ix, acc in self.index_to_access_descr.items()
                if isinstance(acc, SummationAxis)}
        return tuple(sorted(sums, key=lambda ix: sums[ix]))

    @cached_property
    def all_args(self) -> frozenset:
        return frozenset(self.arg_to_shape)

    @cached_property
    def all_indices(self) -> frozenset:
        return frozenset(self.index_to_dim_length)

    @cached_property
    def all_size_params(self) -> frozenset:
        return frozenset(v for v in self.index_to_dim_length.values()
                         if isinstance(v, SizeParam))

    def copy(self, *, out_idx_set=None, in_idx_sets=None, args=None
             ) -> "BatchedEinsum":
        return replace(
            self,
            out_idx_set=(self.out_idx_set if out_idx_set is None
                         else tuple(out_idx_set)),
            in_idx_sets=(self.in_idx_sets if in_idx_sets is None
                         else tuple(tuple(s) for s in in_idx_sets)),
            args=(self.args if args is None
                  else tuple(tuple(r) for r in args)),
        )

    # -- pretty printing ---------------------------------------------------

    def __str__(self) -> str:
        def _len_str(v):
            return v.name if isinstance(v, SizeParam) else str(v)

        domain = " and ".join(
            f"0 <= {ix} < {_len_str(ln)}"
            for ix, ln in sorted(self.index_to_dim_length.items()))
        dtypes = "\n".join(
            f"{name}: {dt}"
            for name, dt in sorted(self.arg_to_dtype.items()))
        out_names = ["_fe_out"] + [f"_fe_out_{i}" for i in range(self.b - 1)]
        joined_sums = "{" + ", ".join(self.sum_indices) + "}"
        joined_out = ", ".join(self.out_idx_set)
        lines = []
        for out_name, row in zip(out_names, self.args):
            rhs = " x ".join(
                f"{arg.name}[{', '.join(idx_set)}]"
                for idx_set, arg in zip(self.in_idx_sets, row))
            lines.append(
                f"  {out_name}[{joined_out}] <- Sum_{joined_sums} {rhs}")
        stmts = "\n".join(lines)
        bar = "-" * 75
        return (f"{bar}\nDOMAINS:\n{{ [{', '.join(sorted(self.all_indices))}]"
                f" : {domain} }}\n{bar}\nData-types:\n{dtypes}\n{bar}\n"
                f"for {','.join(self.out_idx_set)}\n{stmts}\nend\n{bar}")
