"""
Transform space of dense 2-operand tensor contractions (the TCCG suite) on
the plain route: one ``torch.einsum`` per schedule step (cuBLAS on the card,
in full fp32), with a tunable contraction order and precision.

The file name and parameters are those of ``feinsum_tpu``'s space, so its
facts bind here.  ``precision_idx`` indexes ``("default", "highest",
"bf16_3x")`` as in the reference: the first two are both full fp32 on the
port, and ``bf16_3x`` (the TPU's 3-pass bf16 dot) runs each step's product
in three full-fp32 passes over the TF32 hi/lo split
(:func:`~feinsum_tpu_torch.ops.kernels.einsum_3x`).
"""

from __future__ import annotations

from feinsum_tpu_torch.codegen.descriptor import ScheduleDescriptor
from feinsum_tpu_torch.contraction_schedule import (
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from feinsum_tpu_torch.diagnostics import InvalidParameterError
from feinsum_tpu_torch.tuning import BoolParameter, IntParameter, \
    einsum_arg, transform_param
from feinsum_tpu_torch.tuning.impls._common import fp32_precision

_PRECISIONS = ("default", "highest", "bf16_3x")


def _is_tensor_contraction(einsum) -> bool:
    # 2 operands, everything dense and concrete
    return einsum.n == 2 and einsum.b == 1 and not einsum.all_size_params


@transform_param("use_opt_path", lambda e: BoolParameter())
@transform_param("precision_idx",
                 lambda e: IntParameter(0, len(_PRECISIONS) - 1))
@einsum_arg("is_tc", _is_tensor_contraction)
def transform(program, is_tc, use_opt_path, precision_idx):
    if not is_tc:
        raise InvalidParameterError(
            "tc_xla_v0 expects a dense 2-operand single-row contraction")
    e = program.einsum
    schedule = (get_opt_einsum_contraction_schedule(e) if use_opt_path
                else get_trivial_contraction_schedule(e))
    return program.copy(
        schedule=schedule,
        descriptor=ScheduleDescriptor(
            backend="xla",
            precision=fp32_precision(_PRECISIONS[precision_idx])))
