"""
Transform space of the fp64 DG family on the ``dd_rows`` kernel
(``csrc/dd_rows.cu``): operands stored as (2, ...) float32 hi/lo pairs,
the row computed in native FP64 on the card and held to the 1e-12 oracle.

The file name is that of ``feinsum_tpu``'s space, so an archived fact's
``transform_id`` binds here.  The searched parameters are those with a
meaning on Hopper: ``log2_block`` and ``blkc128`` both give ``block_long``,
the elements of the long axis per thread block (``2 ** log2_block``, or
``1024 * blkc128`` when that is positive).  The transform also takes the
reference's other two parameters at their defaults, so that the
reference's facts bind and replay:

* ``parallel_grid`` sets ``dimension_semantics``; thread blocks always run
  in parallel, so it moves nothing on the card;
* ``vmem_idx`` chose the TPU's VMEM cap.  It is accepted and ignored, and the
  descriptor carries no ``vmem_limit_bytes``: a Hopper block's shared
  memory is what the kernel needs (:func:`._common.guard_smem` refuses rows
  over 227 KB), not a cap a transform sets.
"""

from __future__ import annotations

from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.ops.dg_rows import plan_row
from feinsum_tpu_torch.ops.layouts import dofmajor_layouts
from feinsum_tpu_torch.tuning import IntParameter, transform_param
from feinsum_tpu_torch.tuning.impls._common import guard_smem, resolve_block


@transform_param("log2_block", lambda e: IntParameter(8, 15))
@transform_param("blkc128", lambda e: IntParameter(0, 16))
def transform(program, log2_block, blkc128=0, *, parallel_grid=True,
              vmem_idx=2):
    del vmem_idx     # a TPU VMEM cap; see the module docstring
    e = program.einsum
    if any(dt != "float64" for dt in e.arg_to_dtype.values()):
        raise InvalidParameterError(
            "dd_pallas_v0 is the fp64 space (use the f32 DG spaces"
            " otherwise)")
    for row in range(e.b):
        plan_row(e, row)          # raises outside the DG family
    guard_smem(e)
    layouts, out_perm = dofmajor_layouts(e)
    return program.with_descriptor(
        backend="pallas",
        dd_pairs=True,
        block_long=resolve_block(log2_block, blkc128),
        arg_layouts=layouts,
        out_layout=out_perm,
        dimension_semantics="parallel" if parallel_grid else "arbitrary")
