"""
Lowering: (BatchedEinsum, ContractionSchedule, ScheduleDescriptor) -> a
callable on torch tensors.  The descriptor is data interpreted by two
backends, named as in ``feinsum_tpu.codegen``:

* ``xla``    — each schedule step becomes a ``torch.einsum`` (the plain
               route).  Always available; the CPU path.
* ``pallas`` — hand-written CUDA kernels: the fused DG rows, every row of
               the batched einsum in one launch (``ops/cuda_emitter``), or,
               with a tuple ``grid_index``, the dense tensor contraction
               (``ops/tc_emitter``).
"""

from .descriptor import ScheduleDescriptor
from .program import (
    EinsumProgram,
    build_executable,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)

__all__ = (
    "EinsumProgram",
    "ScheduleDescriptor",
    "build_executable",
    "generate_program",
    "generate_program_with_opt_einsum_schedule",
)
