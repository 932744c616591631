"""
Carry programs and data across from the JAX package (or any object with the
same plain fields), without importing it.

:func:`program_from_reference` rebuilds this package's
:class:`~feinsum_tpu_torch.codegen.program.EinsumProgram` from a reference
program's einsum (operand names, shapes, dtypes, index sets), schedule
(subscripts, result names, argument references) and descriptor fields.
Attributes are read by name (duck typing).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cl_utils import default_device
from .codegen.descriptor import ScheduleDescriptor
from .codegen.program import EinsumProgram
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
)
from .einsum import Array, BatchedEinsum, SizeParam


def _shape_entry(d):
    if isinstance(d, (int, np.integer)):
        return int(d)
    return SizeParam(str(d.name))


def einsum_from_reference(ref_einsum) -> BatchedEinsum:
    return BatchedEinsum(
        out_idx_set=tuple(ref_einsum.out_idx_set),
        in_idx_sets=tuple(tuple(s) for s in ref_einsum.in_idx_sets),
        args=tuple(
            tuple(Array(name=str(a.name),
                        shape=tuple(_shape_entry(d) for d in a.shape),
                        dtype=np.dtype(a.dtype))
                  for a in row)
            for row in ref_einsum.args))


def _argument_from_reference(a):
    if hasattr(a, "position"):
        return EinsumOperand(int(a.position))
    return IntermediateResult(str(a.name))


def schedule_from_reference(ref_schedule) -> ContractionSchedule:
    return ContractionSchedule(
        subscripts=tuple(ref_schedule.subscripts),
        result_names=tuple(ref_schedule.result_names),
        arguments=tuple(tuple(_argument_from_reference(a) for a in step)
                        for step in ref_schedule.arguments))


def descriptor_from_reference(ref_desc) -> ScheduleDescriptor:
    """Every field this package's descriptor has, read off *ref_desc* by
    name (a missing attribute keeps the default)."""
    defaults = ScheduleDescriptor()
    return ScheduleDescriptor(**{
        f.name: getattr(ref_desc, f.name, getattr(defaults, f.name))
        for f in dataclasses.fields(ScheduleDescriptor)})


def program_from_reference(ref_program) -> EinsumProgram:
    return EinsumProgram(
        einsum=einsum_from_reference(ref_program.einsum),
        schedule=schedule_from_reference(ref_program.schedule),
        descriptor=descriptor_from_reference(ref_program.descriptor))


def arrays_from_numpy(arrays: dict, device=None) -> dict:
    """``{name: numpy array}`` -> ``{name: tensor on device}`` (the same
    values; C-contiguous).  *device* defaults to the current CUDA card
    (:func:`~feinsum_tpu_torch.cl_utils.default_device`)."""
    device = default_device(device, caller="arrays_from_numpy")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}
