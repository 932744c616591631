"""
Misc helpers and the TCCG tensor-contraction benchmark suite, as in
``feinsum_tpu.utils``.

The TCCG table is the public 48-contraction suite of the COGENT paper
(CGO'19) and the TCCG benchmark collection: each entry is
``"out-inA-inB"`` and the axis lengths of ``a, b, c, ...`` in order.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..einsum import BatchedEinsum, SizeParam, SummationAxis


def is_any_redn_dim_parametric(einsum: BatchedEinsum) -> bool:
    """True iff any contracted axis has a :class:`SizeParam` length."""
    return any(
        isinstance(einsum.index_to_dim_length[ix], SizeParam)
        for ix, acc in einsum.index_to_access_descr.items()
        if isinstance(acc, SummationAxis))


def get_n_redn_dim(einsum: BatchedEinsum) -> int:
    """Number of contracted indices."""
    return len(einsum.sum_indices)


class IndexNameGenerator:
    """Yields fresh single-letter index names, skipping a forbidden set.

    >>> gen = IndexNameGenerator(frozenset({"a", "c"}))
    >>> gen(), gen(), gen()
    ('b', 'd', 'e')
    """

    def __init__(self, forbidden: frozenset = frozenset()) -> None:
        self.forbidden = frozenset(forbidden)
        self._count = 0

    def __call__(self) -> str:
        while True:
            if self._count >= 26:
                raise RuntimeError("Ran out of single-letter index names.")
            name = chr(ord("a") + self._count)
            self._count += 1
            if name not in self.forbidden:
                return name


# {{{ TCCG benchmark suite (48 entries: "out-inA-inB", axis lengths)

_TCCG_CASES = (
    ("abc-bda-dc", "312 312 24 312"),
    ("abc-dca-bd", "312 24 296 312"),
    ("abcd-dbea-ec", "72 72 24 72 72"),
    ("abcd-deca-be", "72 24 72 72 72"),
    ("abcd-ebad-ce", "72 72 24 72 72"),
    ("abcde-efbad-cf", "48 32 24 32 48 32"),
    ("abcde-ecbfa-fd", "48 32 32 24 48 48"),
    ("abcde-efcad-bf", "48 24 32 32 48 32"),
    ("abcd-ea-ebcd", "72 72 72 72 72"),
    ("abcd-eb-aecd", "72 72 72 72 72"),
    ("abcd-ec-abed", "72 72 72 72 72"),
    ("ab-ac-cb", "5136 5120 5136"),
    ("ab-acd-dbc", "312 296 296 312"),
    ("ab-cad-dcb", "312 296 312 312"),
    ("abc-acd-db", "312 296 296 312"),
    ("abc-ad-bdc", "312 312 296 296"),
    ("abc-adc-bd", "312 312 296 296"),
    ("abc-adc-db", "312 296 296 312"),
    ("abc-adec-ebd", "72 72 72 72 72"),
    ("abcd-aebf-dfce", "72 72 72 72 72 72"),
    ("abcd-aebf-fdec", "72 72 72 72 72 72"),
    ("abcd-aecf-bfde", "72 72 72 72 72 72"),
    ("abcd-aecf-fbed", "72 72 72 72 72 72"),
    ("abcd-aedf-bfce", "72 72 72 72 72 72"),
    ("abcd-aedf-fbec", "72 72 72 72 72 72"),
    ("abcd-aefb-fdce", "72 72 72 72 72 72"),
    ("abcd-aefc-fbed", "72 72 72 72 72 72"),
    ("abcd-eafb-fdec", "72 72 72 72 72 72"),
    ("abcd-eafc-bfde", "72 72 72 72 72 72"),
    ("abcd-eafd-fbec", "72 72 72 72 72 72"),
    ("abcdef-dega-gfbc", "24 16 16 24 16 16 24"),
    ("abcdef-degb-gfac", "24 16 16 24 16 16 24"),
    ("abcdef-degc-gfab", "24 16 16 24 16 16 24"),
    ("abcdef-dfga-gebc", "24 16 16 24 16 16 24"),
    ("abcdef-dfgb-geac", "24 16 16 24 16 16 24"),
    ("abcdef-dfgc-geab", "24 16 16 24 16 16 24"),
    ("abcdef-efga-gdbc", "24 16 16 16 24 16 24"),
    ("abcdef-efgb-gdac", "24 16 16 16 24 16 24"),
    ("abcdef-efgc-gdab", "24 16 16 16 24 16 24"),
    ("abcdef-gdab-efgc", "24 16 16 16 24 16 24"),
    ("abcdef-gdac-efgb", "24 16 16 16 24 16 24"),
    ("abcdef-gdbc-efga", "24 16 16 16 24 16 24"),
    ("abcdef-geab-dfgc", "24 16 16 24 16 16 24"),
    ("abcdef-geac-dfgb", "24 16 16 24 16 16 24"),
    ("abcdef-gebc-dfga", "24 16 16 24 16 16 24"),
    ("abcdef-gfab-degc", "24 16 16 24 16 16 24"),
    ("abcdef-gfac-degb", "24 16 16 24 16 16 24"),
    ("abcdef-gfbc-dega", "24 16 16 24 16 16 24"),
)


def get_tccg_benchmark(i: int, dtype: Any = np.float64) -> BatchedEinsum:
    """The *i*-th (1-based) TCCG tensor contraction as a
    :class:`BatchedEinsum` with operands ``A`` and ``B``."""
    if not (1 <= i <= 48):
        raise ValueError(f"i must be in the set {{1, 2, .., 48}}. Got {i = }.")
    from ..make_einsum import array, einsum

    subscript, lens = _TCCG_CASES[i - 1]
    output, in_a, in_b = subscript.split("-")
    axis_lens = {chr(97 + k): int(v) for k, v in enumerate(lens.split())}
    return einsum(
        f"{in_a},{in_b}->{output}",
        array("A", [axis_lens[ix] for ix in in_a], dtype),
        array("B", [axis_lens[ix] for ix in in_b], dtype),
    )

# }}}
