"""Shared helpers of the transform spaces."""

from __future__ import annotations

from ...diagnostics import InvalidParameterError
from ...einsum import SizeParam


def long_axis_of(einsum) -> str:
    """The einsum's one parametric (long) index letter."""
    params = [ix for ix, ln in einsum.index_to_dim_length.items()
              if isinstance(ln, SizeParam)]
    if len(params) != 1:
        raise InvalidParameterError(
            f"schedule space expects exactly one parametric axis, found"
            f" {params}")
    return params[0]


def resolve_block(log2_block: int, blkc128: int = 0) -> int:
    """Elements of the long axis per thread block from the space's params:
    ``1024 * blkc128`` when ``blkc128 > 0``, else ``2 ** log2_block`` (the
    encoding of ``feinsum_tpu``'s spaces, so their facts bind here)."""
    return 1024 * int(blkc128) if blkc128 else 2 ** int(log2_block)


def guard_smem(einsum) -> None:
    """Raise :class:`InvalidParameterError` when one thread block of
    ``dd_rows`` would need more shared memory than a Hopper block has
    (227 KB): the analog of ``feinsum_tpu``'s VMEM guard.  The demand
    depends on the row shape only (R and one u column per thread are
    staged), not on the block length."""
    from ...ops.dg_rows import plan_row
    from ...ops.kernels import MAX_SMEM_BYTES, dd_rows_smem_bytes

    lengths = einsum.index_to_dim_length
    for row in range(einsum.b):
        p = plan_row(einsum, row)
        S = int(lengths[p.s_letter]) if p.s_letter is not None else 1
        need = dd_rows_smem_bytes(S, int(lengths[p.i_letter]),
                                  int(lengths[p.j_letter]), p.u_has_s)
        if need > MAX_SMEM_BYTES:
            raise InvalidParameterError(
                f"dd_rows needs {need} bytes of shared memory per block;"
                f" a Hopper block has {MAX_SMEM_BYTES}")
