"""
numpy-like constructors for :class:`~feinsum_tpu_torch.einsum.BatchedEinsum`.

Parity: ``feinsum/make_einsum.py:55-159`` (explicit ``->`` required, no
ellipsis/broadcasting, str shape components become :class:`SizeParam`).
"""

from __future__ import annotations

import re
from collections.abc import Iterable, Sequence
from typing import Any

import numpy as np

from .einsum import INT_CLASSES, Array, BatchedEinsum, SizeParam


def _preprocess_component(s: Any):
    if isinstance(s, str):
        return SizeParam(s)
    if isinstance(s, SizeParam):
        return s
    if isinstance(s, INT_CLASSES) and s >= 0:
        return int(s)
    raise ValueError(f"Cannot infer shape component '{s}'.")


def _preprocess_shape(shape: Any):
    if isinstance(shape, str) or not isinstance(shape, Iterable):
        shape = (shape,)
    return tuple(_preprocess_component(d) for d in shape)


def array(name: str, shape: Any, dtype: Any = "float64") -> Array:
    """Construct an :class:`Array` operand; str shape entries become
    :class:`SizeParam`\\ s."""
    return Array(name=name, shape=_preprocess_shape(shape),
                 dtype=np.dtype(dtype))


_INDEX_TOKEN = re.compile(r"\s*([a-zA-Z]|\.\.\.)\s*")


def _parse_subscript(subscript: str, *, is_output: bool) -> tuple:
    indices: list = []
    pos = 0
    s = subscript.strip()
    while pos < len(s):
        m = _INDEX_TOKEN.match(s, pos)
        if not m:
            raise ValueError(
                f"Cannot parse '{s[pos:]}' in provided einsum '{subscript}'.")
        tok = m.group(1)
        if tok == "...":
            raise NotImplementedError(
                "Broadcasting in einsums not supported")
        indices.append(tok)
        pos = m.end()
    if is_output and len(set(indices)) != len(indices):
        raise ValueError(
            f"Used an index more than once to refer to the output axis in"
            f" '{subscript}'")
    return tuple(indices)


def batched_einsum(subscripts: str, args: Sequence) -> BatchedEinsum:
    """Build a :class:`BatchedEinsum` from a numpy-style subscript string and a
    ``b x n`` nested sequence of :class:`Array` operands."""
    if "->" not in subscripts:
        raise ValueError(
            "subscripts must contain an explicit '->' output spec;"
            " numpy's implicit mode is unsupported here")
    in_spec, out_spec = subscripts.split("->")
    out_idx_set = _parse_subscript(out_spec, is_output=True)
    in_idx_sets = tuple(_parse_subscript(s, is_output=False)
                        for s in in_spec.split(","))
    try:
        return BatchedEinsum(out_idx_set, in_idx_sets,
                             tuple(tuple(row) for row in args))
    except AssertionError as exc:
        raise TypeError(str(exc)) from exc


def einsum(subscripts: str, *operands: Array) -> BatchedEinsum:
    """Single-row (b=1) :func:`batched_einsum`."""
    return batched_einsum(subscripts, [operands])
