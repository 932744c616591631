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


def fp32_precision(name: str) -> str:
    """A space's precision choice, checked: the full-fp32 names pass and
    ``"bf16_3x"`` (the TPU's 3-pass bf16 dot) raises
    :class:`InvalidParameterError` when the transform is bound, since the
    port runs IEEE fp32 and has no 3-pass split (ROADMAP: a 3xTF32 meaning
    for ``bf16_3x``)."""
    from ...codegen.descriptor import FP32_PRECISIONS
    if name not in FP32_PRECISIONS:
        raise InvalidParameterError(
            f"precision {name!r}: the port runs full fp32 only"
            f" {FP32_PRECISIONS}")
    return name


def resolve_block(log2_block: int, blkc128: int = 0) -> int:
    """Elements of the long axis per thread block from the space's params:
    ``1024 * blkc128`` when ``blkc128 > 0``, else ``2 ** log2_block`` (the
    encoding of ``feinsum_tpu``'s spaces, so their facts bind here)."""
    return 1024 * int(blkc128) if blkc128 else 2 ** int(log2_block)


def guard_smem(einsum, kernel: str = "dd_rows") -> None:
    """Raise :class:`InvalidParameterError` when one thread block of the DG
    row kernel *kernel* (``"dd_rows"`` or ``"dg_rows_f32"``) would need more
    shared memory than a Hopper block has (227 KB): the analog of
    ``feinsum_tpu``'s VMEM guard.  The demand depends on the row shape only
    (R and one u column per thread are staged), not on the block length."""
    from ...ops.dg_rows import plan_row
    from ...ops.kernels import MAX_SMEM_BYTES, dd_rows_smem_bytes, \
        dg_rows_smem_bytes

    smem_bytes = {"dd_rows": dd_rows_smem_bytes,
                  "dg_rows_f32": dg_rows_smem_bytes}[kernel]
    lengths = einsum.index_to_dim_length
    for row in range(einsum.b):
        p = plan_row(einsum, row)
        S = int(lengths[p.s_letter]) if p.s_letter is not None else 1
        need = smem_bytes(S, int(lengths[p.i_letter]),
                          int(lengths[p.j_letter]), p.u_has_s)
        if need > MAX_SMEM_BYTES:
            raise InvalidParameterError(
                f"{kernel} needs {need} bytes of shared memory per block;"
                f" a Hopper block has {MAX_SMEM_BYTES}")


def guard_tc_grid(program) -> None:
    """Raise :class:`InvalidParameterError` when ``tc_grid_f32`` cannot take
    *program* (a tuple ``grid_index``): the Hopper kernel's own limits in
    place of ``feinsum_tpu``'s VMEM and Mosaic guards.  The kernel needs no
    shared memory or unrolling that grows with the cell (it tiles every
    cell), so what it refuses is structural (see
    :func:`~feinsum_tpu_torch.ops.kernels.tc_classify`) or a launch of more
    than 2**31 - 1 blocks."""
    from ...codegen.program import get_index_lengths
    from ...ops.tc_emitter import plan_tc_launch

    plan_tc_launch(program, get_index_lengths(program.einsum, 1))


def fused_pallas_program(program, *, block_long: int,
                         parallel_grid: bool = True, dofmajor: bool = False,
                         fold: bool = False, precision_3x: bool = False):
    """The subset of ``feinsum_tpu``'s core DG schedule that
    ``tc_gemm_v0`` reaches: the trivial schedule on the fused DG kernels
    (``backend="pallas"``), *block_long* elements per thread block,
    *parallel_grid* as ``dimension_semantics`` and *dofmajor* layouts.
    ``fold`` (the TPU's fold-8 storage) and ``precision_3x`` (the TPU's
    3-pass bf16 dot) raise."""
    from ...contraction_schedule import get_trivial_contraction_schedule
    from ...ops.layouts import dofmajor_layouts

    if fold:
        raise InvalidParameterError(
            "fold: the TPU's fold-8 storage has no Hopper meaning")
    if precision_3x:
        raise InvalidParameterError(
            "precision bf16_3x: the port runs full fp32 (no 3-pass split)")
    e = program.einsum
    layouts, out_perm = dofmajor_layouts(e) if dofmajor else ((), None)
    return program.copy(
        schedule=get_trivial_contraction_schedule(e)).with_descriptor(
        backend="pallas",
        block_long=block_long,
        dimension_semantics="parallel" if parallel_grid else "arbitrary",
        arg_layouts=layouts, out_layout=out_perm)
