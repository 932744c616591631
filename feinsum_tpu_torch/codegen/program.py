"""
EinsumProgram: the transformable kernel object.

An immutable (einsum, schedule, descriptor) triple, as in
``feinsum_tpu.codegen.program``.  A ``TransformT`` maps a program to a
program (usually only touching the descriptor/schedule);
:func:`build_executable` interprets the result into a callable on torch
tensors.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Optional

import numpy as np
import torch

from .. import tracing
from ..contraction_schedule import (
    FALLBACK_LONG_DIM_LENGTH,
    ContractionSchedule,
    EinsumOperand,
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from ..diagnostics import InvalidParameterError
from ..einsum import BatchedEinsum, SizeParam
from .descriptor import ScheduleDescriptor, check_supported, is_split


@dataclass(frozen=True)
class EinsumProgram:
    """An executable description of a batched einsum: what to compute
    (einsum), in which algebraic steps (schedule), and how to map it onto the
    device (descriptor)."""

    einsum: BatchedEinsum
    schedule: ContractionSchedule
    descriptor: ScheduleDescriptor

    def copy(self, **changes) -> "EinsumProgram":
        return replace(self, **changes)

    def with_descriptor(self, **changes) -> "EinsumProgram":
        return replace(self, descriptor=self.descriptor.copy(**changes))


def generate_program(einsum: BatchedEinsum,
                     schedule: Optional[ContractionSchedule] = None,
                     descriptor: Optional[ScheduleDescriptor] = None
                     ) -> EinsumProgram:
    """Default program: trivial schedule, plain (``"xla"``) backend."""
    return EinsumProgram(
        einsum=einsum,
        schedule=schedule or get_trivial_contraction_schedule(einsum),
        descriptor=descriptor or ScheduleDescriptor(),
    )


def generate_program_with_opt_einsum_schedule(
        einsum: BatchedEinsum, *,
        descriptor: Optional[ScheduleDescriptor] = None,
        long_dim_length: int = FALLBACK_LONG_DIM_LENGTH) -> EinsumProgram:
    """Program with the optimal pairwise contraction path (see
    :func:`~feinsum_tpu_torch.contraction_schedule.
    get_opt_einsum_contraction_schedule`)."""
    return EinsumProgram(
        einsum=einsum,
        schedule=get_opt_einsum_contraction_schedule(
            einsum, long_dim_length=long_dim_length),
        descriptor=descriptor or ScheduleDescriptor(),
    )


TransformT = Callable[[EinsumProgram], EinsumProgram]


def get_index_lengths(einsum: BatchedEinsum, long_dim_length: int) -> dict:
    """Concrete index -> length map with SizeParams bound to
    *long_dim_length*."""
    return {
        ix: long_dim_length if isinstance(ln, SizeParam) else int(ln)
        for ix, ln in einsum.index_to_dim_length.items()}


def output_dtype(einsum: BatchedEinsum, row: int) -> np.dtype:
    """dtype of batch-row *row*'s output: numpy promotion of its operands."""
    return np.result_type(*[arg.dtype for arg in einsum.args[row]])


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def check_full_fp32_matmul() -> None:
    """The plain route's float32 products must run in IEEE fp32: TF32 keeps
    10 mantissa bits and fails the 2e-5 oracle.  PyTorch's defaults are
    full fp32; this refuses a process that turned TF32 on."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise InvalidParameterError(
            "TF32 matmul is enabled (torch.backends.cuda.matmul.allow_tf32"
            " or float32_matmul_precision); the float32 oracle needs it off")


def _logical_arrays(program: EinsumProgram, arrays_by_name: dict) -> dict:
    """Undo the descriptor's argument permutations to recover logical axes
    (strided views, no copies)."""
    out = dict(arrays_by_name)
    for name, perm in program.descriptor.arg_layouts_map.items():
        out[name] = out[name].permute(*(int(i) for i in np.argsort(perm)))
    return out


def _xla_row(program: EinsumProgram, row: int, logical: dict):
    """One batch row's schedule, one ``torch.einsum`` per step, delivered in
    the descriptor's stored output layout (contiguous).  At ``bf16_3x`` each
    step contracts its float32 operands in three TF32 passes
    (:func:`~feinsum_tpu_torch.ops.kernels.einsum_3x`)."""
    e = program.einsum
    env: dict = {}
    result = None
    if is_split(program.descriptor):
        from ..ops.kernels import einsum_3x as einsum
    else:
        einsum = torch.einsum
    for subs, name, step_args in zip(program.schedule.subscripts,
                                     program.schedule.result_names,
                                     program.schedule.arguments):
        ins = [logical[e.args[row][a.position].name]
               if isinstance(a, EinsumOperand) else env[a.name]
               for a in step_args]
        env[name] = result = einsum(subs.replace(" ", ""), *ins)
    result = result.to(torch_dtype(output_dtype(e, row)))
    if program.descriptor.out_layout is not None:
        result = result.permute(*(int(p) for p
                                  in program.descriptor.out_layout))
    return result.contiguous()


def _xla_chunked_fn(program: EinsumProgram, index_to_length: dict,
                    blk: int):
    """The plain route chunk by chunk (``descriptor.xla_block_long``): each
    chunk of *blk* elements of the long axis runs the whole schedule on
    slices of the long-axis operands, and its rows are written into
    preallocated outputs in the stored layout.  The reference pads the last
    chunk to *blk* and drops the padded rows; here the last chunk is
    shorter, which gives the same outputs."""
    e = program.einsum
    desc = program.descriptor
    long_letters = [ix for ix, ln in e.index_to_dim_length.items()
                    if isinstance(ln, SizeParam)]
    if len(long_letters) != 1:
        raise InvalidParameterError(
            "xla_block_long needs exactly one parametric long axis")
    if desc.pre_layouts:
        raise InvalidParameterError(
            "xla_block_long composes with neither fold_long nor pre_layouts")
    (letter,) = long_letters
    if letter not in e.out_idx_set:
        raise InvalidParameterError(
            "xla_block_long needs the long axis in the output")
    length = int(index_to_length[letter])
    blk = min(blk, length)
    axis_of = {a.name: tuple(idx).index(letter)
               for row in e.args for a, idx in zip(row, e.in_idx_sets)
               if letter in idx}
    out_letters = (tuple(e.out_idx_set[p] for p in desc.out_layout)
                   if desc.out_layout is not None else tuple(e.out_idx_set))
    p_out = out_letters.index(letter)
    out_shape = tuple(int(index_to_length[ix]) for ix in out_letters)

    def fn(arrays_by_name: dict):
        check_full_fp32_matmul()
        logical = _logical_arrays(program, arrays_by_name)
        device = next(iter(logical.values())).device
        outs = [torch.empty(out_shape, device=device,
                            dtype=torch_dtype(output_dtype(e, r)))
                for r in range(e.b)]
        for start in range(0, length, blk):
            stop = min(start + blk, length)
            chunk = {name: (t.narrow(axis_of[name], start, stop - start)
                            if name in axis_of else t)
                     for name, t in logical.items()}
            for r, out in enumerate(outs):
                out.narrow(p_out, start, stop - start).copy_(
                    _xla_row(program, r, chunk))
        return tuple(outs)

    return fn


@functools.lru_cache(maxsize=512)
def _build_executable_cached(program: EinsumProgram, lengths_key: tuple,
                             device: Optional[torch.device]):
    """A build (the set-up span ``feinsum.executable.build``)."""
    with tracing.setup("feinsum.executable.build"):
        return _executable(program, lengths_key, device)


def _executable(program: EinsumProgram, lengths_key: tuple,
                device: Optional[torch.device]):
    check_supported(program.descriptor)
    if program.descriptor.kron_args or program.descriptor.lane_pack_expand:
        # the lane-pack contract: residents arrive in their logical shape
        # and are expanded on the operands' device once per call, on every
        # route; callers never pass the expansion matrices
        from ..ops.lane_pack import expand_residents
        packed = _executable(
            program.with_descriptor(kron_args=(), lane_pack_expand=()),
            lengths_key, device)

        def expanded(arrays_by_name: dict):
            return packed(expand_residents(program, arrays_by_name))
        return expanded
    if program.descriptor.dd_pairs:
        from ..ops.dd_emitter import build_dd_executable
        inner = build_dd_executable(program, dict(lengths_key))
    elif program.descriptor.backend == "pallas" \
            and isinstance(program.descriptor.grid_index, tuple):
        from ..ops.tc_emitter import build_tc_executable
        inner = build_tc_executable(program, dict(lengths_key))
    elif program.descriptor.backend == "pallas":
        from ..ops.cuda_emitter import build_cuda_executable
        inner = build_cuda_executable(program, dict(lengths_key))
    elif program.descriptor.xla_block_long is not None:
        inner = _xla_chunked_fn(program, dict(lengths_key),
                                int(program.descriptor.xla_block_long))
    else:
        def inner(arrays_by_name: dict):
            check_full_fp32_matmul()
            logical = _logical_arrays(program, arrays_by_name)
            return tuple(_xla_row(program, r, logical)
                         for r in range(program.einsum.b))

    if device is None:
        return inner

    def on_device(arrays_by_name: dict):
        for name, arr in arrays_by_name.items():
            if arr.device != device:
                raise ValueError(f"argument {name!r} lies on {arr.device};"
                                 f" the executable was built for {device}")
        return inner(arrays_by_name)

    return on_device


def stored_lengths(program: EinsumProgram, index_to_length: dict) -> dict:
    """The index lengths *program*'s kernels see for the caller's
    *index_to_length*: ``bind_lengths`` override, the long axis stretched
    by ``rowcat`` and then divided by ``lane_pack``; raises
    :class:`InvalidParameterError` when g does not divide it."""
    desc = program.descriptor
    out = dict(index_to_length)
    for ix, ln in desc.bind_lengths:
        out[ix] = int(ln)
    for ix, ln in program.einsum.index_to_dim_length.items():
        if not isinstance(ln, SizeParam):
            continue
        out[ix] *= desc.rowcat
        if out[ix] % desc.lane_pack:
            raise InvalidParameterError(
                f"lane_pack={desc.lane_pack} requires the long axis length"
                f" ({out[ix]}) divisible by it")
        out[ix] //= desc.lane_pack
    return out


def build_executable(program: EinsumProgram, *,
                     long_dim_length: int = 100_000,
                     index_to_length: Optional[dict] = None,
                     device=None, name: Optional[str] = None):
    """Compile *program* into ``fn(arrays_by_name: dict) -> tuple`` returning
    the b row outputs as tensors in the stored output layout.  The arguments
    are tensors in the stored layout (:func:`~feinsum_tpu_torch.measure.
    apply_layouts`).  With *device*, the executable refuses tensors that lie
    elsewhere.  Executables are cached on (program, lengths, device).  The
    descriptor's ``bind_lengths`` override the caller's lengths: they fix
    the axes of a rewritten program to the original einsum's, a
    row-concatenation rewrite (``descriptor.rowcat`` = b) stretches the long
    axis b-fold (its rows lie end to end) and a lane-pack rewrite
    (``descriptor.lane_pack`` = g) divides it by g, in that order
    (:func:`stored_lengths`).  Each call of the executable is the span
    ``feinsum.exec:<name>``, ``feinsum.exec:<subscripts>`` without a
    *name*; the name is no part of the cache's key, so callers of one
    program share its build under their own names."""
    if index_to_length is None:
        index_to_length = get_index_lengths(program.einsum, long_dim_length)
    lengths_key = tuple(sorted(stored_lengths(program,
                                              index_to_length).items()))
    dev = None
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    fn = _build_executable_cached(program, lengths_key, dev)
    span = f"feinsum.exec:{name or program.einsum.get_subscripts()}"

    def executable(arrays_by_name: dict):
        with tracing.span(span):
            return fn(arrays_by_name)

    return executable
