"""
feinsum_tpu_torch — the batched-einsum library of ``feinsum_tpu`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).

This first slice carries the DG suite's main path: build a batched einsum in
the IR, schedule it (optimal pairwise path), lay it out dof-major, validate
it against the numpy oracle, and run it through the fused CUDA kernels
(``ops/cuda_emitter.py``).  Public names are those of ``feinsum_tpu``.  The
package imports ``torch`` and never ``jax`` or ``feinsum_tpu``.
"""

from .codegen import (
    EinsumProgram,
    ScheduleDescriptor,
    build_executable,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from .diagnostics import (
    EinsumMatchError,
    EinsumTunitMatchError,
    InvalidParameterError,
    NoDevicePeaksInfoError,
    NoFactInDatabaseError,
    TransformValidationError,
)
from .einsum import (
    Array,
    BatchedEinsum,
    EinsumAxisAccess,
    FreeAxis,
    SizeParam,
    SummationAxis,
)
from .make_einsum import array, batched_einsum, einsum
from .measure import (
    apply_layouts,
    get_footprint_gbytes,
    get_giga_op_map,
    get_roofline_flop_rate,
    validate_batched_einsum_transform,
)
from .ops.layouts import unpack_output

__version__ = "0.1.0"

__all__ = (
    "Array",
    "BatchedEinsum",
    "ContractionSchedule",
    "EinsumAxisAccess",
    "EinsumMatchError",
    "EinsumOperand",
    "EinsumProgram",
    "EinsumTunitMatchError",
    "FreeAxis",
    "IntermediateResult",
    "InvalidParameterError",
    "NoDevicePeaksInfoError",
    "NoFactInDatabaseError",
    "ScheduleDescriptor",
    "SizeParam",
    "SummationAxis",
    "TransformValidationError",
    "apply_layouts",
    "array",
    "batched_einsum",
    "build_executable",
    "einsum",
    "generate_program",
    "generate_program_with_opt_einsum_schedule",
    "get_footprint_gbytes",
    "get_giga_op_map",
    "get_opt_einsum_contraction_schedule",
    "get_roofline_flop_rate",
    "get_trivial_contraction_schedule",
    "unpack_output",
    "validate_batched_einsum_transform",
)
