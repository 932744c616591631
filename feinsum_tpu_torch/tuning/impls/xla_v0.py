"""
Transform space of any batched einsum on the plain route: one
``torch.einsum`` per schedule step, with a tunable contraction order,
precision and chunking of the long axis.

The file name and parameters are those of ``feinsum_tpu``'s space, so its
facts bind here.  ``precision_idx`` indexes ``("default", "highest",
"bf16_3x")`` as in the reference: the first two are both full fp32 (or
float64) on the port, and ``bf16_3x`` (the TPU's 3-pass bf16 dot) runs each
step that contracts two float32 operands in three full-fp32 passes over the
TF32 hi/lo split (:func:`~feinsum_tpu_torch.ops.kernels.einsum_3x`).
``log2_chunk > 0`` runs the schedule chunk by chunk over ``2 **
log2_chunk`` elements of the long axis (``descriptor.xla_block_long``),
which bounds the footprint of the intermediates.
"""

from __future__ import annotations

from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu_torch.contraction_schedule import (
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from feinsum_tpu_torch.tuning import BoolParameter, IntParameter, \
    transform_param
from feinsum_tpu_torch.tuning.impls._common import fp32_precision

_PRECISIONS = ("default", "highest", "bf16_3x")


@transform_param("use_opt_path", lambda e: BoolParameter())
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@transform_param("log2_chunk", lambda e: IntParameter(0, 17))
def transform(program, use_opt_path, precision_idx, log2_chunk=0):
    e = program.einsum
    schedule = (get_opt_einsum_contraction_schedule(e) if use_opt_path
                else get_trivial_contraction_schedule(e))
    return program.copy(
        schedule=schedule,
        descriptor=ScheduleDescriptor(
            backend="xla",
            precision=fp32_precision(_PRECISIONS[precision_idx]),
            xla_block_long=(1 << log2_chunk) if log2_chunk else None))
