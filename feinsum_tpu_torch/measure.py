"""
Measurement and validation harness.

* random input generation (numpy ``default_rng(seed)``, then ``.to(device)``)
  and the stored-layout packing of :func:`apply_layouts`;
* validation of a transformed program against the ``numpy.einsum`` oracle
  at dtype-dependent tolerances (the rule of ``feinsum_tpu.measure``);
* flop polynomials per dtype from the contraction schedule, footprint and
  write bytes, and the roofline rate from ``data/device_info.py``;
* :func:`timeit_cuda`: CUDA-event timing on the card, median of many
  launches, with the L2 cache flushed between launches when the working set
  would otherwise stay in it;
* :func:`timeit`, the tuner's timer: validate a transform, then time it on
  the device it is given.  On a CUDA device that is :func:`timeit_cuda`; on
  the CPU it is the host clock, and the tuner records such a time under the
  device key ``"cpu"``, never under a card's.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import numpy as np
import torch

from .cl_utils import default_device
from .codegen.program import (
    EinsumProgram,
    TransformT,
    build_executable,
    generate_program,
    get_index_lengths,
    output_dtype,
)
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    get_opt_einsum_contraction_schedule,
)
from .data.device_info import DEV_TO_PEAK_BW, DEV_TO_PEAK_GFLOPS, \
    get_device_key
from .diagnostics import NoDevicePeaksInfoError, TransformValidationError
from .einsum import BatchedEinsum, SizeParam

DTYPE_TO_RTOL = {
    np.dtype("float16"): 1e-2,
    np.dtype("float32"): 2e-5,
    np.dtype("float64"): 1e-12,
    np.dtype("complex64"): 2e-5,
    np.dtype("complex128"): 1e-12,
}

L2_BYTES = 50 * 1024 * 1024   # H100 L2 cache
WARMUP_REPS = 3                # untimed calls before timeit_cuda measures
TIMED_REPS = 20                # timed launches whose median timeit_cuda takes
VALIDATION_LENGTH = 100        # long-axis length at which timeit validates


# {{{ inputs

def generate_input_arrays(einsum: BatchedEinsum, *, long_dim_length: int,
                          seed: int = 0, device=None,
                          as_numpy: bool = False) -> dict:
    """Random inputs for every distinct operand in its logical shape: the
    same numbers as ``feinsum_tpu.measure.generate_input_arrays`` for the
    same seed, as tensors on *device* (default: the current CUDA card; it
    raises without one unless ``device="cpu"``), or numpy arrays with
    *as_numpy*.  Storage layouts are applied by :func:`apply_layouts`."""
    lengths = get_index_lengths(einsum, long_dim_length)
    rng = np.random.default_rng(seed)
    out = {}
    arg_to_idx = {}
    for args_row in einsum.args:
        for arg, idx_set in zip(args_row, einsum.in_idx_sets):
            arg_to_idx[arg.name] = idx_set
    for name in einsum.arg_to_shape:
        shape = tuple(lengths[ix] for ix in arg_to_idx[name])
        dtype = einsum.arg_to_dtype[name]
        if dtype.kind == "c":
            base = (rng.random(shape) + 1j * rng.random(shape))
        elif dtype.kind in "iu":
            base = rng.integers(0, 8, size=shape)
        else:
            base = rng.random(shape)
        out[name] = np.asarray(base, dtype=dtype)
    if as_numpy:
        return out
    device = default_device(device, caller="generate_input_arrays")
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def apply_layouts(program: EinsumProgram, arrays: dict) -> dict:
    """Pack logical (einsum-shaped) tensors into *program*'s stored layout,
    in the reference's order: first each ``rowcat_args`` group, the rows'
    streamed operands stacked end to end along their leading long axis
    into the rewritten program's operand, then each ``pre_layouts``
    grouping (a
    rewritten program's operands, e.g. a tensor-contraction operand stored
    as a GEMM-natural 2D matrix, :func:`~feinsum_tpu_torch.ops.layouts.
    apply_nested_layout`), then each ``arg_layouts`` permutation, both
    materialised (``.contiguous()``), so the stored layout is the memory
    layout; under ``dd_pairs`` every float64 operand is then split into
    (2, ...) float32 [hi, lo] pairs
    (:func:`~feinsum_tpu_torch.ops.dd_emitter.split_to_pairs`).  Numpy
    arrays are accepted and returned as C-contiguous numpy arrays."""
    from .ops.layouts import apply_nested_layout

    out = dict(arrays)
    for new_name, olds in program.descriptor.rowcat_args:
        stack = [out.pop(n) for n in olds]
        out[new_name] = (np.concatenate(stack, axis=0)
                         if isinstance(stack[0], np.ndarray)
                         else torch.cat(stack, dim=0))
    for name, nested in program.descriptor.pre_layouts:
        out[name] = apply_nested_layout(out[name], nested)
    for name, perm in program.descriptor.arg_layouts_map.items():
        perm = tuple(int(p) for p in perm)
        arr = out[name]
        if isinstance(arr, np.ndarray):
            out[name] = np.ascontiguousarray(arr.transpose(perm))
        else:
            out[name] = arr.permute(*perm).contiguous()
    if program.descriptor.dd_pairs:
        from .ops.dd_emitter import split_to_pairs
        for name, arr in out.items():
            if arr.dtype in (np.float64, torch.float64):
                out[name] = split_to_pairs(arr)
    return out

# }}}


# {{{ flop counting

_COMPLEX_WEIGHTS = {"mul": 6, "add": 2}
_REAL_WEIGHTS = {"mul": 1, "add": 1}


def _length_expr(length):
    import sympy
    if isinstance(length, SizeParam):
        return sympy.Symbol(length.name)
    return sympy.Integer(int(length))


def get_giga_op_map(einsum: BatchedEinsum,
                    schedule: Optional[ContractionSchedule] = None) -> dict:
    """dtype-name -> sympy expression of 1e-9 * flops, counting over all b
    rows of *schedule* (default: the optimal-path schedule, the reference's
    convention).  Per step: |domain| * ((n_terms - 1) muls + 1 add when
    contracted), complex-weighted mul=6/add=2."""
    import sympy

    if schedule is None:
        schedule = get_opt_einsum_contraction_schedule(einsum)
    lengths = einsum.index_to_dim_length
    totals: dict = {}
    for row in range(einsum.b):
        env_dtype: dict = {}
        for subs, name, step_args in zip(schedule.subscripts,
                                         schedule.result_names,
                                         schedule.arguments):
            in_specs, out_spec = subs.replace(" ", "").split("->")
            in_specs = in_specs.split(",")
            dts = [einsum.args[row][a.position].dtype
                   if isinstance(a, EinsumOperand) else env_dtype[a.name]
                   for a in step_args]
            dt = np.result_type(*dts)
            env_dtype[name] = dt

            all_idx = set("".join(in_specs))
            contracted = all_idx - set(out_spec)
            domain = sympy.Integer(1)
            for ix in sorted(all_idx):
                domain = domain * _length_expr(lengths[ix])
            w = _COMPLEX_WEIGHTS if dt.kind == "c" else _REAL_WEIGHTS
            ops = domain * ((len(step_args) - 1) * w["mul"]
                            + (w["add"] if contracted else 0))
            if ops != 0:
                totals[dt.name] = totals.get(dt.name, sympy.Integer(0)) + ops
    return {k: v / sympy.Integer(10**9) for k, v in totals.items()}


def evaluate_giga_op_map(giga_op_map: dict, long_dim_length: int) -> dict:
    """Evaluate each polynomial at every SizeParam == long_dim_length."""
    return {k: float(expr.subs({s: long_dim_length
                                for s in expr.free_symbols}))
            for k, expr in giga_op_map.items()}


def get_footprint_gbytes(einsum: BatchedEinsum, *, long_dim_length: int
                         ) -> float:
    """Ideal device-memory traffic: every distinct operand read once and
    every output written once (a fused kernel materialises no
    intermediates)."""
    lengths = get_index_lengths(einsum, long_dim_length)
    arg_to_idx = {}
    for args_row in einsum.args:
        for arg, idx_set in zip(args_row, einsum.in_idx_sets):
            arg_to_idx[arg.name] = idx_set
    nbytes = 0
    for name in einsum.all_args:
        size = 1
        for ix in arg_to_idx[name]:
            size *= lengths[ix]
        nbytes += size * einsum.arg_to_dtype[name].itemsize
    return nbytes * 1e-9 + get_write_gbytes(
        einsum, long_dim_length=long_dim_length)


def get_write_gbytes(einsum: BatchedEinsum, *,
                     long_dim_length: int) -> float:
    """Output bytes only (written once)."""
    lengths = get_index_lengths(einsum, long_dim_length)
    out_size = 1
    for ix in einsum.out_idx_set:
        out_size *= lengths[ix]
    return sum(out_size * output_dtype(einsum, row).itemsize
               for row in range(einsum.b)) * 1e-9


def get_roofline_flop_rate(einsum: BatchedEinsum, device_name, *,
                           long_dim_length: int = 100_000,
                           ignore_unknown_device: bool = False
                           ) -> Optional[float]:
    """Roofline GOp/s: total flops / max(compute time, memory time) from
    the static device peaks.  *device_name* is a device-table key, a device
    name or a ``torch.device``."""
    key = get_device_key(device_name)
    if key not in DEV_TO_PEAK_GFLOPS or key not in DEV_TO_PEAK_BW:
        if ignore_unknown_device:
            return None
        raise NoDevicePeaksInfoError(
            f"No peak flops/bandwidth info for device '{key}'. Known:"
            f" {sorted(DEV_TO_PEAK_GFLOPS)}")
    gops = evaluate_giga_op_map(get_giga_op_map(einsum), long_dim_length)
    t_compute = 0.0
    for dtype_name, g in gops.items():
        peaks = DEV_TO_PEAK_GFLOPS[key]
        if dtype_name not in peaks:
            if ignore_unknown_device:
                return None
            raise NoDevicePeaksInfoError(
                f"No {dtype_name} peak recorded for '{key}'.")
        t_compute += g / peaks[dtype_name]
    t_mem = get_footprint_gbytes(
        einsum, long_dim_length=long_dim_length) / DEV_TO_PEAK_BW[key]
    return sum(gops.values()) / max(t_compute, t_mem)

# }}}


# {{{ validation

def _numpy_oracle(einsum: BatchedEinsum, np_arrays: dict) -> list:
    subs = (",".join("".join(s) for s in einsum.in_idx_sets)
            + "->" + "".join(einsum.out_idx_set))
    return [np.einsum(subs, *[np_arrays[arg.name] for arg in row],
                      optimize="optimal")
            for row in einsum.args]


def validate_batched_einsum_transform(
        einsum: BatchedEinsum, transform: Optional[TransformT], *,
        long_dim_length: int = 100, seed: int = 0,
        rtol: Optional[float] = None, device="cpu") -> None:
    """Run the transformed program on *device* and compare against
    numpy.einsum; raises :class:`TransformValidationError` on mismatch
    (the rule of ``feinsum_tpu.measure.validate_batched_einsum_transform``:
    ``allclose`` at the dtype's rtol with atol = rtol * max|ref|)."""
    program = generate_program(einsum)
    if transform is not None:
        program = transform(program)
        if not isinstance(program, EinsumProgram):
            raise TypeError("transform must return an EinsumProgram")

    np_arrays = generate_input_arrays(einsum, long_dim_length=long_dim_length,
                                      seed=seed, as_numpy=True)
    expected = _numpy_oracle(einsum, np_arrays)
    dev_arrays = {k: torch.from_numpy(v).to(device)
                  for k, v in apply_layouts(program, np_arrays).items()}
    fn = build_executable(program, long_dim_length=long_dim_length,
                          device=device)
    results = fn(dev_arrays)
    if program.descriptor.rowcat > 1:
        # one output: the rows' outputs end to end along the long axis
        (el,) = [ix for ix, ln in einsum.index_to_dim_length.items()
                 if isinstance(ln, SizeParam)]
        expected = [np.concatenate(expected,
                                   axis=list(einsum.out_idx_set).index(el))]
    if len(results) != len(expected):
        raise TransformValidationError(
            f"expected {len(expected)} outputs, got {len(results)}")
    out_layout = program.descriptor.out_layout
    pre_out = program.descriptor.pre_out_layout
    for r, (got, ref) in enumerate(zip(results, expected)):
        got = got.cpu().numpy()
        if program.descriptor.dd_pairs:
            from .ops.dd_emitter import combine_pairs
            got = combine_pairs(got)
        if pre_out is not None:
            # a rewritten program's output is grouped (e.g. GEMM-natural 2D)
            from .ops.layouts import apply_nested_layout
            ref = apply_nested_layout(ref, pre_out)
        if out_layout is not None:
            ref = np.transpose(ref, tuple(int(p) for p in out_layout))
        tol = rtol if rtol is not None else DTYPE_TO_RTOL.get(
            np.dtype(output_dtype(einsum, r)), 1e-2)
        scale = float(np.max(np.abs(ref))) or 1.0
        if got.shape != ref.shape:
            raise TransformValidationError(
                f"row {r}: shape {got.shape} != expected {ref.shape}")
        if not np.allclose(got.astype(np.float64) if got.dtype.kind != "c"
                           else got, ref, rtol=tol, atol=tol * scale):
            err = float(np.max(np.abs(got - ref)))
            raise TransformValidationError(
                f"row {r}: max abs error {err:.3e} exceeds tolerance"
                f" rtol={tol} (scale {scale:.3e})")

# }}}


# {{{ timing

def _working_set_bytes(arrays: dict, outs) -> int:
    return (sum(t.numel() * t.element_size() for t in arrays.values())
            + sum(t.numel() * t.element_size() for t in outs))


def timeit_cuda(fn, arrays: dict) -> float:
    """Median milliseconds of one ``fn(arrays)`` on the card, each of
    ``TIMED_REPS`` launches timed by its own pair of CUDA events after
    ``WARMUP_REPS`` untimed calls.  When inputs and outputs fit in the
    50 MB L2 cache, a 2 x L2-sized buffer is rewritten before each timed
    launch, so every launch starts cold, as a caller that streams through
    long-axis data would find it.  Raises if the arrays are not on a CUDA
    device: there is no host-clock fallback."""
    devices = {t.device for t in arrays.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise RuntimeError(f"timeit_cuda needs CUDA tensors, got {devices}")
    device = next(iter(devices))
    outs = None
    for _ in range(WARMUP_REPS):
        outs = fn(arrays)
    torch.cuda.synchronize(device)
    scratch = (torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=device)
               if _working_set_bytes(arrays, outs) < L2_BYTES else None)
    pairs = []
    for _ in range(TIMED_REPS):
        if scratch is not None:
            scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(arrays)
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize(device)
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def _timeit_in_graph(fn, arrays: dict, *,
                     min_work_seconds: float = 0.2) -> float:
    """Seconds per call of ``fn(arrays)`` as a caller pays it (the consumer
    path's shootout): on the card the median of :func:`timeit_cuda`; on the
    CPU the host clock's median over calls, repeated until
    *min_work_seconds* have passed (at least ``TIMED_REPS`` calls)."""
    if {t.device.type for t in arrays.values()} == {"cuda"}:
        return timeit_cuda(fn, arrays) * 1e-3
    for _ in range(WARMUP_REPS):
        fn(arrays)
    times, start = [], time.perf_counter()
    while len(times) < TIMED_REPS \
            or time.perf_counter() - start < min_work_seconds:
        t0 = time.perf_counter()
        fn(arrays)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def timeit(einsum: BatchedEinsum, *, transform: Optional[TransformT] = None,
           long_dim_length: int = 100_000, device=None) -> float:
    """Seconds per call of the transformed program on *device*: validate it
    against the numpy oracle there at ``VALIDATION_LENGTH``, then
    time it on seeded inputs at *long_dim_length* in its stored layout.
    *device* is a CUDA device (``None``: the current card), timed by
    :func:`timeit_cuda`, or the CPU, timed by the host clock (the median of
    ``TIMED_REPS`` calls after ``WARMUP_REPS``; CPU kernels are
    synchronous)."""
    device = default_device(device, caller="timeit")
    validate_batched_einsum_transform(
        einsum, transform, long_dim_length=VALIDATION_LENGTH, device=device)
    program = generate_program(einsum)
    if transform is not None:
        program = transform(program)
    arrays = apply_layouts(program, generate_input_arrays(
        einsum, long_dim_length=long_dim_length, device=device))
    fn = build_executable(program, long_dim_length=long_dim_length,
                          device=device)
    if device.type == "cuda":
        return timeit_cuda(fn, arrays) * 1e-3
    if device.type != "cpu":
        raise RuntimeError(f"timeit: no timer for device {device}")
    for _ in range(WARMUP_REPS):
        fn(arrays)
    times = []
    for _ in range(TIMED_REPS):
        t0 = time.perf_counter()
        fn(arrays)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)

# }}}
