#!/usr/bin/env python3
"""Drive feinsum_tpu_torch's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero before the final line:

1. check for a CUDA card, print its name and power limit (nvidia-smi), and
   build the CUDA kernels from ``feinsum_tpu_torch/csrc/`` (nvcc, sm_90a);
2. compare each kernel with its plain PyTorch version on the card, at a
   small shape and at the suite's full shapes (E = 1M), within 2e-5 of
   max|plain| (the float32 oracle's rule);
3. reset the launch counters and run the main path for the six DG-suite
   rows: validate against the numpy oracle on the card at E = 2000, then
   apply_layouts -> build_executable -> run at E = 1M; read the counters;
4. check the E = 1M outputs (finite, stored shape, equal to the plain
   per-step route within 2e-5) and time the kernel route, the kernels'
   plain versions and the plain per-step route (CUDA events, median of 20
   launches), each against the card's data-sheet roofline;
5. compare the fp64 kernel ``dd_rows`` with its plain version on the card
   for the four fp64 DG rows (grad, div, mass, face-mass at ndof 35), at
   E = 777 and E = 1M, within 1e-12 of max|plain| on the float64 values;
6. the archive path for the same rows: autotune the ``dd_pallas_v0`` space
   on the card into a fresh archive under ``build/`` (a few points per row,
   timed at E = 1M) and print the facts recorded; reset the launch counters;
   take each row through ``candidate_transforms`` (the archived champion
   must win), validate it on the card at E = 2000, replay it
   (apply_layouts -> build_executable -> ``dd_rows``) at E = 1M and read the
   counters; check each output against the plain per-step float64 route
   within 1e-12, and time the kernel route, ``dd_rows_plain`` and the
   per-step route against the card's FP64 roofline;
7. compare the tensor-contraction kernel ``tc_grid_f32`` with its plain
   version ``tc_grid_plain`` on the card within 2e-5 of max|plain|: the five
   rank >= 3 rows of the TCCG sample at their published sizes, two small
   ragged contractions (M, N and K not multiples of any tile), and stored
   permutations of both operands and of the output;
8. the TCCG archive path: autotune the ``tc_pallas_v1`` space on the card
   for each of the five rows into a fresh archive under ``build/`` (two
   seed points of ``suite.TCCG_SEEDS`` and one more) and print the facts; reset the launch
   counters; take each row through ``candidate_transforms`` (the archived
   champion must win), validate it on the card against the numpy oracle,
   replay it (apply_layouts -> build_executable -> ``tc_grid_f32``) and read
   the counters; check each output against the plain per-step route
   (``tc_xla_v0``) within 2e-5, and time the kernel route,
   ``tc_grid_plain`` and the per-step route (cuBLAS through
   ``torch.einsum``) against the card's fp32 roofline.  The sixth row,
   the rank-2 GEMM tccg_12, runs and is timed on the plain route alone;
9. compare the kernels of the f32 DG archive path with their plain versions
   on the card within 2e-5 of max|plain|: ``row_reduce_f32`` on vecmat and
   rowsum at E = 777 and E = 1M in the dof-major and the element-major
   layout, the flatten route ``ew_flat_f32`` on scale_flat at E = 777 and
   at its full length (35 * 2**20), and ``dg_rows_f32`` on curl with its
   hoisted ``R = sum_r D``; time ``row_reduce_f32`` at E = 1M and E = 2**23
   against its byte bound and print the device idle share of those calls;
10. the f32 DG archive path: autotune each of the six suite rows, the ten
   extended rows and scale_flat in its space (``suite.F32_SPACES``, the
   seeds of ``suite.f32_seed_configs`` first) on the card into a fresh
   archive under ``build/`` and print the facts; reset the launch
   counters; take each row through ``candidate_transforms`` (the archived
   champion must win), validate it on the card at E = 2000, replay it at
   E = 1M (scale_flat at its full length) and read the counters; check
   each output against the plain per-step route within 2e-5, and time the
   kernel route, the kernel's plain version and the per-step route;
11. curl's ``prereduce`` point against its default point, timed in turns;
12. ``long_reduce_f32`` (a contracted long axis) against
   ``long_reduce_plain`` and a float64 ``torch.einsum`` on the energy
   ``ej,ej->``, ``ej,ej->j`` and the Gram matrix ``ei,ej->ij`` at E = 1M and
   a ragged E = 1,000,003, ndof 35, in both stored layouts, within 2e-5 of
   the sum of the terms' magnitudes; timed at E = 1M, with the kernel's
   device idle share;
13. the consumer flow of ``examples/compile_user_rhs.py`` at its size
   (E = 100,000): the H100's relayout rates; the div (b = 3), lift and
   energy classes tuned into a fresh archive under ``build/``;
   ``compile_fn_with_archive`` on ``suite.user_rhs`` and
   ``suite.user_rhs_limited``; each plan's kernel (one b = 3 div plan on
   ``dg_rows_f32``, the energy on ``long_reduce_f32``, every plan an
   archived kernel program); outputs against the plain torch function
   within 2e-5; cold and warm time per call;
14. the wave model at E = 500,000 and Maxwell at E = 65,536 (ndof 35) with
   the default schedules: the face restriction on ``dg_rows_f32`` against
   its plain version, 5 steps each against the per-step route within
   2e-5, then ms per step and Gdof/s.

The last lines are the card line, one JSON object of per-kernel results
(each kernel's time, its plain version's, the bound of the data-sheet
roofline for the same work and one PyTorch call's for the same function),
and ``{"ok": true, "device": {...}}``.  The times of ``dg_rows_f32`` and
``ew_product_f32`` are phase 4's rows, those of ``row_reduce_f32`` and
``ew_flat_f32`` phase 10's, ``long_reduce_f32``'s phase 12's; launches are
counted over the main path (phase 3), the archive replays (phases 6, 8,
10), the consumer flow's calls (phase 13) and one step of each model
(phase 14).  It imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent
E_FULL = 1_000_000
E_VALIDATE = 2000
E_SMALL = 777          # not a multiple of the block or of 4: ragged edges
RTOL = 2e-5
RTOL_F64 = 1e-12
TUNE_POINTS = 4        # measured points per fp64 row (autotune test_limit)
# two block lengths the tuner measures first, then random draws
TUNE_SEEDS = [{"log2_block": 9, "blkc128": 0},
              {"log2_block": 10, "blkc128": 0}]
TC_TUNE_POINTS = 3     # measured points per TCCG row (autotune test_limit)
F32_TUNE_POINTS = 3    # measured points per f32 archive row (at most)
E_REDUCE_LONG = 2 ** 23   # row_reduce_f32's second timing length
F32_KERNELS = ("dg_rows_f32", "ew_product_f32")
REPLACES = {"dg_rows_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "long_reduce_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "ew_product_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "ew_flat_f32": "feinsum_tpu/ops/pallas_emitter.py:187",
            "row_reduce_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "dd_rows": "feinsum_tpu/ops/dd_emitter.py:233",
            "tc_grid_f32": "feinsum_tpu/ops/pallas_emitter.py:268"}
SOURCES = {"dg_rows_f32": "feinsum_tpu_torch/csrc/dg_rows.cu",
           "ew_product_f32": "feinsum_tpu_torch/csrc/ew_product.cu",
           "ew_flat_f32": "feinsum_tpu_torch/csrc/ew_product.cu",
           "row_reduce_f32": "feinsum_tpu_torch/csrc/row_reduce.cu",
           "long_reduce_f32": "feinsum_tpu_torch/csrc/long_reduce.cu",
           "dd_rows": "feinsum_tpu_torch/csrc/dd_rows.cu",
           "tc_grid_f32": "feinsum_tpu_torch/csrc/tc_grid.cu"}
# the data-sheet peaks of the roofline bound (NVIDIA H100 SXM at 700 W)
PEAK_BYTES_PER_MS = 3.35e9
PEAK_OPS_PER_MS = {"float32": 67e9, "float64": 34e9}


class SmokeFailure(Exception):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def max_err(got, want) -> tuple:
    """(max |got - want|, that over max |want|), in float64."""
    got = got.double()
    want = want.double()
    if got.shape != want.shape:
        raise SmokeFailure(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(got.isfinite().all()):
        raise SmokeFailure("non-finite output")
    abs_err = float((got - want).abs().max())
    scale = float(want.abs().max()) or 1.0
    return abs_err, abs_err / scale


def row_bound(e, length: int, program=None) -> tuple:
    """``(bytes ms, operations ms)`` of one row: its bytes (each operand
    read once, each output written once) over the peak memory rate, and
    its operations over the peak rate of their type: the optimal pairwise
    schedule's count, or *program*'s schedule's where that is smaller
    (curl's pre-reduced ``R``); the roofline bound is the larger."""
    from feinsum_tpu_torch.measure import evaluate_giga_op_map, \
        get_footprint_gbytes, get_giga_op_map
    t_bytes = get_footprint_gbytes(e, long_dim_length=length) * 1e9 \
        / PEAK_BYTES_PER_MS
    schedules = [None]
    if program is not None and program.einsum == e:
        schedules.append(program.schedule)
    t_ops = min(sum(g * 1e9 / PEAK_OPS_PER_MS[dt] for dt, g in
                    evaluate_giga_op_map(get_giga_op_map(e, schedule),
                                         length).items())
                for schedule in schedules)
    return t_bytes, t_ops


def bound_text(e, length: int, program=None) -> str:
    t_bytes, t_ops = row_bound(e, length, program)
    return (f"bound {max(t_bytes, t_ops):.4f} ms"
            f" ({'bytes' if t_bytes >= t_ops else 'operations'})")


class KernelStats:
    """Per kernel: summed kernel, plain-version and library-call ms, and
    the summed data-sheet bound of the same work."""

    def __init__(self):
        self.rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                         "bytes_ms": 0.0, "ops_ms": 0.0, "bound_ms": 0.0}
                     for k in SOURCES}

    def add(self, kernel: str, e, length: int, ms: float, plain_ms: float,
            library_ms=None, program=None) -> None:
        """One row's times, and its bound (:func:`row_bound`)."""
        t_bytes, t_ops = row_bound(e, length, program)
        row = self.rows[kernel]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] = (None if library_ms is None
                             or row["library_ms"] is None
                             else row["library_ms"] + library_ms)
        row["bytes_ms"] += t_bytes
        row["ops_ms"] += t_ops
        row["bound_ms"] += max(t_bytes, t_ops)

    def entry(self, kernel: str, launches: int, worst: float) -> dict:
        row = self.rows[kernel]
        return {"name": kernel, "route": "cuda", "source": SOURCES[kernel],
                "replaces": REPLACES[kernel], "launches": launches,
                "max_abs_err": worst, "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                             else "operations"),
                "library_ms": row["library_ms"]}


def library_call(program):
    """One ``torch.einsum`` per row on the stored operands, computing the
    row's whole function: the PyTorch call the kernels are held to."""
    import torch

    from feinsum_tpu_torch.ops.layouts import stored_arg_layouts, \
        stored_out_letters

    e = program.einsum
    stored = stored_arg_layouts(program)
    subs = (",".join("".join(stored[a.name]) for a in e.args[0]) + "->"
            + "".join(stored_out_letters(program)))

    def call(arrays):
        return [torch.einsum(subs, *[arrays[a.name] for a in row])
                for row in e.args]
    return call


def timed_in_turns(routes: dict, arrays_of: dict) -> dict:
    """ms of each route, timed in turns (each route, then each again in
    reverse order), each the mean of its two medians."""
    from feinsum_tpu_torch.measure import timeit_cuda
    order = list(routes)
    times = {k: [] for k in order}
    for k in order + order[::-1]:
        times[k].append(timeit_cuda(routes[k], arrays_of[k]))
    return times


def main() -> int:
    if not (HERE / "feinsum_tpu_torch" / "csrc").is_dir():
        raise SmokeFailure(f"no feinsum_tpu_torch/csrc beside {__file__}:"
                           " run from a checkout of the repository")
    sys.path.insert(0, str(HERE))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    card = card_line()
    log(card)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"torch {torch.__version__} cuda {torch.version.cuda};"
        f" {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise SmokeFailure("TF32 matmul is on; the float32 oracle needs it"
                           " off")

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import (
        apply_layouts, evaluate_giga_op_map, generate_input_arrays,
        get_giga_op_map, timeit_cuda)
    from feinsum_tpu_torch.ops import _build, kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.layouts import stored_out_letters
    from feinsum_tpu_torch.suite import default_transform, suite

    # phase 1: build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] kernels loaded in {time.perf_counter() - t0:.2f} s"
        f" (nvcc {_build.build_info['seconds']:.2f} s)"
        f" -> {_build.library_path().name}")
    for line in _build.build_info["log"].splitlines():
        if any(w in line for w in ("registers", "spill", "entry function")):
            log("[build]", line.strip())

    rows = suite()
    programs = {name: default_transform(e)(ft.generate_program(e))
                for name, e in rows}

    def inputs(name, e, length, seed=0):
        return apply_layouts(programs[name], generate_input_arrays(
            e, long_dim_length=length, seed=seed, device=dev))

    # phase 2: each kernel against its plain version on the card
    worst = {k: 0.0 for k in SOURCES}
    for length in (E_SMALL, E_FULL):
        for name, e in rows:
            plan = plan_cuda_launch(programs[name],
                                    get_index_lengths(e, length))
            operands = plan.operands(inputs(name, e, length, seed=1))
            got = plan.run(operands)
            want = plan.plain(operands)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                abs_err, rel = max_err(g, w)
                worst[plan.kernel] = max(worst[plan.kernel], abs_err)
                ok = rel <= RTOL
                log(f"[compare] {plan.kernel} {name} E={length}:"
                    f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                    f" max|plain| (tolerance {RTOL}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"{plan.kernel} disagrees with its"
                                       f" plain version on {name}")
            del operands, got, want

    # phase 3: the main path, counted
    kernels.reset_launch_counts()
    runs = {}
    for name, e in rows:
        transform = default_transform(e)
        ft.validate_batched_einsum_transform(
            e, transform, long_dim_length=E_VALIDATE, device=dev)
        program = transform(ft.generate_program(e))
        arrays = apply_layouts(program, generate_input_arrays(
            e, long_dim_length=E_FULL, device=dev))
        fn = ft.build_executable(program, long_dim_length=E_FULL, device=dev)
        outs = fn(arrays)
        torch.cuda.synchronize()
        runs[name] = (program, arrays, fn, outs)
        log(f"[main] {name}: validated on {dev} at E={E_VALIDATE}, ran at"
            f" E={E_FULL}: outputs {[tuple(o.shape) for o in outs]}")
    launches = dict(kernels.launch_counts)
    log(f"[main] launch counts over the main path: {launches}")
    for kernel in F32_KERNELS:
        if launches[kernel] < 1:
            raise SmokeFailure(f"{kernel} was not launched on the main path")

    # phase 4: check the outputs, then time
    power = card.split(",")[-1].strip()
    label = f"[{torch.cuda.get_device_name(0)}, power limit {power}]"
    stats = KernelStats()
    for name, e in rows:
        program, arrays, fn, outs = runs.pop(name)
        xla = ft.build_executable(program.with_descriptor(backend="xla"),
                                  long_dim_length=E_FULL, device=dev)
        for got, want in zip(outs, xla(arrays)):
            want_shape = tuple(
                get_index_lengths(e, E_FULL)[ix]
                for ix in stored_out_letters(program))
            if tuple(got.shape) != want_shape:
                raise SmokeFailure(f"{name}: output shape {tuple(got.shape)}"
                                   f" != {want_shape}")
            _, rel = max_err(got, want)
            if rel > RTOL:
                raise SmokeFailure(f"{name}: E={E_FULL} output differs from"
                                   f" the plain route by {rel:.2e}")
        del outs
        plan = plan_cuda_launch(program, get_index_lengths(e, E_FULL))

        def plain(a, plan=plan):
            return plan.plain(plan.operands(a))

        # in turns: plain, kernel, kernel, plain (and the per-step route
        # and the library call around them)
        library = library_call(program)
        t_lib = [timeit_cuda(library, arrays)]
        t_xla = [timeit_cuda(xla, arrays)]
        t_plain = [timeit_cuda(plain, arrays)]
        t_kern = [timeit_cuda(fn, arrays), timeit_cuda(fn, arrays)]
        t_plain.append(timeit_cuda(plain, arrays))
        t_xla.append(timeit_cuda(xla, arrays))
        t_lib.append(timeit_cuda(library, arrays))
        gops = sum(evaluate_giga_op_map(get_giga_op_map(e), E_FULL).values())
        roof = ft.get_roofline_flop_rate(e, dev, long_dim_length=E_FULL,
                                         ignore_unknown_device=True)
        log(f"[time] {name} E={E_FULL} {bound_text(e, E_FULL)}")
        for route, ts in (("kernel " + plan.kernel, t_kern),
                          ("plain version", t_plain),
                          ("plain per-step route", t_xla),
                          ("library call (torch.einsum)", t_lib)):
            ms = sum(ts) / len(ts)
            rate = gops / (ms * 1e-3)
            share = (f"{100 * rate / roof:.1f}% of roofline"
                     f" ({roof:.0f} GOp/s)" if roof else "roofline unknown")
            log(f"[time] {name} E={E_FULL} {route}: {ms:.4f} ms"
                f" (runs {', '.join(f'{t:.4f}' for t in ts)}),"
                f" {rate:.1f} GOp/s, {share} {label}")
        stats.add(plan.kernel, e, E_FULL, sum(t_kern) / len(t_kern),
                  sum(t_plain) / len(t_plain), sum(t_lib) / len(t_lib))
        del arrays
        torch.cuda.empty_cache()

    log(f"[phase] 1-4 (build, f32 kernels, main path, times):"
        f" {time.perf_counter() - t0:.1f} s")
    t_phase = time.perf_counter()
    worst["dd_rows"] = fp64_kernel_check(dev)
    launches["dd_rows"] = fp64_archive_path(dev, label, stats)
    log(f"[phase] 5-6 (fp64): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    worst["tc_grid_f32"] = tc_kernel_check(dev)
    launches["tc_grid_f32"] = tccg_archive_path(dev, label, stats)
    log(f"[phase] 7-8 (TCCG): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    worst.update(f32_kernel_check(dev, label, worst))
    log(f"[phase] 9 (f32 kernels): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for k, n in f32_archive_path(dev, label, stats).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 10 (f32 archive path):"
        f" {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    curl_prereduce_comparison(dev, label)
    log(f"[phase] 11 (curl prereduce): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    worst["long_reduce_f32"] = long_reduce_check(dev, label, stats)
    log(f"[phase] 12 (long_reduce_f32): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for k, n in consumer_flow(dev, label).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 13 (consumer flow): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for k, n in models_full_width(dev, label).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 14 (models): {time.perf_counter() - t_phase:.1f} s;"
        f" all phases {time.perf_counter() - t0:.1f} s")

    entries = [stats.entry(k, launches[k], worst[k]) for k in SOURCES]
    for entry in entries:
        times = [entry[k] for k in ("ms", "plain_ms", "bound_ms")]
        if entry["library_ms"] is not None:
            times.append(entry["library_ms"])
        if not all(math.isfinite(v) and v > 0 for v in times):
            raise SmokeFailure(f"{entry['name']}: no time measured")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def fp64_kernel_check(dev) -> float:
    """Phase 5: ``dd_rows`` against ``dd_rows_plain`` on the four fp64
    rows at E_SMALL and E_FULL; returns the largest absolute error on the
    float64 values."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.dd_emitter import combine_pairs, \
        plan_dd_launch
    from feinsum_tpu_torch.suite import fp64_suite
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    space = get_transform_func_from_module_path("dd_pallas_v0")
    worst = 0.0
    for length in (E_SMALL, E_FULL):
        for name, e in fp64_suite():
            program = space.bind_args(e, log2_block=9)(ft.generate_program(e))
            plan = plan_dd_launch(program, get_index_lengths(e, length))
            operands = plan.operands(apply_layouts(
                program, generate_input_arrays(e, long_dim_length=length,
                                               seed=1, device=dev)))
            got = plan.run(operands)
            want = plan.plain(operands)
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                abs_err, rel = max_err(combine_pairs(g), combine_pairs(w))
                worst = max(worst, abs_err)
                ok = rel <= RTOL_F64
                log(f"[compare] dd_rows {name} E={length}:"
                    f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                    f" max|plain| (tolerance {RTOL_F64})"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"dd_rows disagrees with its plain"
                                       f" version on {name}")
            del operands, got, want
    return worst


def fp64_archive_path(dev, label: str, stats: KernelStats) -> int:
    """Phase 6: tune, record, replay and time the fp64 rows; returns the
    dd_rows launches of the replays and adds the times to *stats*."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.data.device_info import get_device_key
    from feinsum_tpu_torch.measure import (
        apply_layouts, evaluate_giga_op_map, generate_input_arrays,
        get_giga_op_map, timeit_cuda)
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.dd_emitter import plan_dd_launch
    from feinsum_tpu_torch.suite import (candidate_transforms,
                                         default_transform, fp64_suite)

    db = HERE / "build" / "chip_smoke" / "archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    key = get_device_key(dev)
    rows = fp64_suite()
    for name, e in rows:
        t0 = time.perf_counter()
        ft.autotune(e, "dd_pallas_v0", db_path=str(db), device=dev,
                    long_dim_length=E_FULL, test_limit=TUNE_POINTS,
                    seed_configs=TUNE_SEEDS)
        facts = ft.query(e, dev, db_path=str(db))
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t0:.1f} s")
        for q in facts:
            log(f"[tune]   {q.device_name} {q.transform_id}"
                f" {dict(q.transform_params)}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms,"
                f" {q.total_giga_op_rate:.1f} GOp/s {label}")
        if len(facts) != TUNE_POINTS or any(q.device_name != key
                                            for q in facts):
            raise SmokeFailure(f"{name}: expected {TUNE_POINTS} facts"
                               f" under {key}")

    kernels.reset_launch_counts()
    runs = {}
    for name, e in rows:
        winner = next(candidate_transforms(name, e, db_path=str(db),
                                           device=dev))
        log(f"[replay] {winner.label}")
        if winner.fact is None or winner.fact.transform_id \
                != "dd_pallas_v0.py":
            raise SmokeFailure(f"{name}: the winner is not an archived"
                               " dd_pallas_v0.py fact")
        ft.validate_batched_einsum_transform(
            e, winner.transform, long_dim_length=E_VALIDATE, device=dev)
        program = winner.transform(ft.generate_program(e))
        logical = generate_input_arrays(e, long_dim_length=E_FULL,
                                        device=dev)
        arrays = apply_layouts(program, logical)
        fn = ft.build_executable(program, long_dim_length=E_FULL,
                                 device=dev)
        before = kernels.launch_counts["dd_rows"]
        outs = fn(arrays)
        torch.cuda.synchronize()
        if kernels.launch_counts["dd_rows"] <= before:
            raise SmokeFailure(f"{name}: the replay did not launch dd_rows")
        runs[name] = (program, logical, arrays, fn, outs)
        log(f"[replay] {name}: validated on {dev} at E={E_VALIDATE}, ran"
            f" at E={E_FULL}: outputs {[tuple(o.shape) for o in outs]}")
    launches = kernels.launch_counts["dd_rows"]
    log(f"[replay] launch counts over the replays:"
        f" {dict(kernels.launch_counts)}")

    for name, e in rows:
        program, logical, arrays, fn, outs = runs.pop(name)
        xla = ft.build_executable(
            default_transform(e)(ft.generate_program(e)),
            long_dim_length=E_FULL, device=dev)
        for got, want in zip(outs, xla(logical)):
            got = ft.unpack_output(program, got, tuple(want.shape))
            _, rel = max_err(got, want)
            log(f"[check] {name} E={E_FULL}: max|replay-per-step| ="
                f" {rel:.2e} of max|per-step| (tolerance {RTOL_F64})")
            if rel > RTOL_F64:
                raise SmokeFailure(f"{name}: E={E_FULL} output differs from"
                                   f" the plain per-step route by {rel:.2e}")
        del outs
        plan = plan_dd_launch(program, get_index_lengths(e, E_FULL))

        def plain(a, plan=plan):
            return plan.plain(plan.operands(a))

        t_xla = [timeit_cuda(xla, logical)]
        t_plain = [timeit_cuda(plain, arrays)]
        t_kern = [timeit_cuda(fn, arrays), timeit_cuda(fn, arrays)]
        t_plain.append(timeit_cuda(plain, arrays))
        t_xla.append(timeit_cuda(xla, logical))
        gops = sum(evaluate_giga_op_map(get_giga_op_map(e), E_FULL).values())
        roof = ft.get_roofline_flop_rate(e, dev, long_dim_length=E_FULL,
                                         ignore_unknown_device=True)
        for route, ts in (("kernel dd_rows", t_kern),
                          ("plain version", t_plain),
                          ("plain per-step route", t_xla)):
            ms = sum(ts) / len(ts)
            rate = gops / (ms * 1e-3)
            share = (f"{100 * rate / roof:.1f}% of the fp64 roofline"
                     f" ({roof:.0f} GOp/s)" if roof else "roofline unknown")
            log(f"[time] {name} E={E_FULL} {route}: {ms:.4f} ms"
                f" (runs {', '.join(f'{t:.4f}' for t in ts)}),"
                f" {rate:.1f} GOp/s, {share} {label}")
        # no one PyTorch call computes a float64 row on pair storage
        stats.add("dd_rows", e, E_FULL, sum(t_kern) / len(t_kern),
                  sum(t_plain) / len(t_plain))
        del logical, arrays
        torch.cuda.empty_cache()
    return launches


def _tc_seed(name: str, k: int) -> dict:
    from feinsum_tpu_torch.suite import TCCG_SEEDS
    return {**TCCG_SEEDS[name][k], "precision_idx": 0}


def tc_kernel_check(dev) -> float:
    """Phase 7: ``tc_grid_f32`` against ``tc_grid_plain`` on the TCCG rows
    at full size, on small ragged contractions and on stored permutations;
    returns the largest absolute error."""
    import numpy as np
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.tc_emitter import tc_step
    from feinsum_tpu_torch.suite import tccg_suite
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    cases = []       # (label, step, A, B)
    for name, e in tccg_suite():
        if len(e.out_idx_set) < 3:
            continue
        program = v1.bind_args(e, **_tc_seed(name, 0))(ft.generate_program(e))
        step, (pa, pb) = tc_step(program, get_index_lengths(e, 1))
        arrays = apply_layouts(program, generate_input_arrays(
            e, long_dim_length=1, seed=1, device=dev))
        A, B = (arrays[e.args[0][p].name] for p in (pa, pb))
        cases.append((name, step, A, B))
        if name == "tccg_35":
            # every stored axis order reversed: operands and output
            rev = [tuple(reversed(x)) for x in (step.a, step.b, step.c)]
            cases.append((name + " reversed layouts",
                          replace(step, a=rev[0], b=rev[1], c=rev[2]),
                          A.permute(*reversed(range(A.ndim))).contiguous(),
                          B.permute(*reversed(range(B.ndim))).contiguous()))
    rng = np.random.default_rng(2)
    for label, (a, b, c, lengths, grid, grid_m) in (
            ("ragged gemm", ("ij", "jk", "ki", dict(i=1000, j=333, k=700),
                             (), None)),
            ("ragged tccg_35 shape",
             ("dfgb", "geac", "fecbda",
              dict(a=7, b=13, c=5, d=27, e=9, f=17, g=19), (("a", 7),),
              "e"))):
        step = kernels.TCStep(a=tuple(a), b=tuple(b), c=tuple(c),
                              lengths=tuple(sorted(lengths.items())),
                              grid=grid, grid_m=grid_m)
        A, B = (torch.from_numpy(rng.random([lengths[x] for x in lt],
                                            dtype=np.float32)).to(dev)
                for lt in (a, b))
        cases.append((label, step, A, B))
    worst = 0.0
    for label, step, A, B in cases:
        got = kernels.tc_grid_f32(A, B, step)
        want = kernels.tc_grid_plain(A, B, step)
        torch.cuda.synchronize()
        abs_err, rel = max_err(got, want)
        worst = max(worst, abs_err)
        ok = rel <= RTOL and got.is_contiguous()
        shape = kernels.tc_classify(step)
        log(f"[compare] tc_grid_f32 {label} {''.join(step.a)},"
            f"{''.join(step.b)}->{''.join(step.c)} (Mc {shape.Mc}, Nc"
            f" {shape.Nc}, K {shape.K}, {shape.ncells} cells, tile"
            f" {kernels.TC_TILES[shape.variant]}): max|kernel-plain|"
            f" {abs_err:.3e} = {rel:.2e} of max|plain| (tolerance {RTOL})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"tc_grid_f32 disagrees with its plain"
                               f" version on {label}")
        del got, want
    return worst


def tccg_archive_path(dev, label: str, stats: KernelStats) -> int:
    """Phase 8: tune, record, replay and time the TCCG rows; returns the
    tc_grid_f32 launches of the replays and adds the times to *stats*
    (the plain version ``tc_grid_plain`` is one ``torch.einsum`` call, so
    it is also the library call)."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.data.device_info import get_device_key
    from feinsum_tpu_torch.measure import apply_layouts, \
        evaluate_giga_op_map, generate_input_arrays, get_giga_op_map, \
        timeit_cuda
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
    from feinsum_tpu_torch.suite import candidate_transforms, tccg_suite
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    db = HERE / "build" / "chip_smoke" / "tc_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    key = get_device_key(dev)
    rows = tccg_suite()
    tc_rows = [(name, e) for name, e in rows if len(e.out_idx_set) >= 3]
    for name, e in tc_rows:
        t0 = time.perf_counter()
        ft.autotune(e, "tc_pallas_v1", db_path=str(db), device=dev,
                    test_limit=TC_TUNE_POINTS,
                    seed_configs=[_tc_seed(name, k) for k in (0, 1)])
        facts = ft.query(e, dev, db_path=str(db))
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t0:.1f} s")
        for q in facts:
            log(f"[tune]   {q.device_name} {q.transform_id}"
                f" {dict(q.transform_params)}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms,"
                f" {q.total_giga_op_rate:.1f} GOp/s {label}")
        if len(facts) != TC_TUNE_POINTS or any(q.device_name != key
                                               for q in facts):
            raise SmokeFailure(f"{name}: expected {TC_TUNE_POINTS} facts"
                               f" under {key}")

    per_step = get_transform_func_from_module_path("tc_xla_v0")
    kernels.reset_launch_counts()
    runs = {}
    for name, e in tc_rows:
        winner = next(candidate_transforms(name, e, db_path=str(db),
                                           device=dev))
        log(f"[replay] {winner.label}")
        if winner.fact is None or winner.fact.transform_id \
                != "tc_pallas_v1.py":
            raise SmokeFailure(f"{name}: the winner is not an archived"
                               " tc_pallas_v1.py fact")
        ft.validate_batched_einsum_transform(e, winner.transform,
                                             device=dev)
        program = winner.transform(ft.generate_program(e))
        logical = generate_input_arrays(e, long_dim_length=1, device=dev)
        arrays = apply_layouts(program, logical)
        fn = ft.build_executable(program, device=dev)
        before = kernels.launch_counts["tc_grid_f32"]
        outs = fn(arrays)
        torch.cuda.synchronize()
        if kernels.launch_counts["tc_grid_f32"] <= before:
            raise SmokeFailure(f"{name}: the replay did not launch"
                               " tc_grid_f32")
        runs[name] = (program, logical, arrays, fn, outs)
        log(f"[replay] {name}: validated on {dev}, ran at full size:"
            f" outputs {[tuple(o.shape) for o in outs]}")
    launches = kernels.launch_counts["tc_grid_f32"]
    log(f"[replay] launch counts over the replays:"
        f" {dict(kernels.launch_counts)}")

    for name, e in rows:
        xla = ft.build_executable(per_step.bind_args(
            e, use_opt_path=True, precision_idx=0)(ft.generate_program(e)),
            device=dev)
        gops = sum(evaluate_giga_op_map(get_giga_op_map(e), 1).values())
        roof = ft.get_roofline_flop_rate(e, dev, ignore_unknown_device=True)
        if name not in runs:
            # the rank-2 GEMM: the plain route only, as in the reference
            ft.validate_batched_einsum_transform(
                e, per_step.bind_args(e, use_opt_path=True, precision_idx=0),
                device=dev)
            logical = generate_input_arrays(e, long_dim_length=1, device=dev)
            routes = (("plain per-step route (no kernel: a rank-2 GEMM)",
                       [timeit_cuda(xla, logical),
                        timeit_cuda(xla, logical)]),)
        else:
            program, logical, arrays, fn, outs = runs.pop(name)
            for got, want in zip(outs, xla(logical)):
                got = ft.unpack_output(program, got, tuple(want.shape))
                _, rel = max_err(got, want)
                log(f"[check] {name}: max|replay-per-step| = {rel:.2e} of"
                    f" max|per-step| (tolerance {RTOL})")
                if rel > RTOL:
                    raise SmokeFailure(f"{name}: output differs from the"
                                       f" plain per-step route by {rel:.2e}")
            del outs
            plan = plan_tc_launch(program, get_index_lengths(e, 1))

            def plain(a, plan=plan):
                return plan.plain(plan.operands(a))

            t_xla = [timeit_cuda(xla, logical)]
            t_plain = [timeit_cuda(plain, arrays)]
            t_kern = [timeit_cuda(fn, arrays), timeit_cuda(fn, arrays)]
            t_plain.append(timeit_cuda(plain, arrays))
            t_xla.append(timeit_cuda(xla, logical))
            routes = (("kernel tc_grid_f32", t_kern),
                      ("plain version", t_plain),
                      ("plain per-step route", t_xla))
            stats.add("tc_grid_f32", e, 1, sum(t_kern) / len(t_kern),
                      sum(t_plain) / len(t_plain),
                      sum(t_plain) / len(t_plain))
            del arrays
        for route, ts in routes:
            ms = sum(ts) / len(ts)
            rate = gops / (ms * 1e-3)
            share = (f"{100 * rate / roof:.1f}% of the fp32 roofline"
                     f" ({roof:.0f} GOp/s)" if roof else "roofline unknown")
            log(f"[time] {name} {e.get_subscripts()} {route}: {ms:.4f} ms"
                f" (runs {', '.join(f'{t:.4f}' for t in ts)}),"
                f" {rate:.1f} GOp/s, {share} {label}")
        del logical
        torch.cuda.empty_cache()
    return launches


def f32_kernel_check(dev, label: str, worst: dict) -> dict:
    """Phase 9: ``row_reduce_f32``, ``ew_flat_f32`` and the hoisted curl
    on ``dg_rows_f32`` against their plain versions; times
    ``row_reduce_f32`` at E_FULL and E_REDUCE_LONG with its byte bound and
    idle share.  Returns the largest absolute errors by kernel (the
    ``dg_rows_f32`` entry of *worst* included)."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.suite import (SCALE_FLAT_LENGTH, default_transform,
                                         extended_suite, make_scale_flat,
                                         space_point)
    from feinsum_tpu_torch.tools.profile_suite import report
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    ext = dict(extended_suite())
    cases = []      # (label, einsum, program, lengths)
    for name in ("vecmat_ndof35", "rowsum_ndof35"):
        e = ext[name]
        dof = default_transform(e)(ft.generate_program(e))
        for layout, program in (
                ("dof-major", dof),
                ("element-major",
                 dof.with_descriptor(arg_layouts=(), out_layout=None))):
            for length in (E_SMALL, E_FULL):
                cases.append((f"{name} {layout}", e, program, length))
    flat = make_scale_flat()
    flat_prog = get_transform_func_from_module_path("elementwise_v1") \
        .bind_args(flat, **space_point("elementwise_v1", flat,
                                       flatten=True))(ft.generate_program(flat))
    for length in (E_SMALL, SCALE_FLAT_LENGTH):
        cases.append(("scale_flat flatten", flat, flat_prog, length))
    curl = ext["dg_curl_ndof35"]
    curl_prog = get_transform_func_from_module_path("curl_3d_v0").bind_args(
        curl, **space_point("curl_3d_v0", curl, prereduce=True))(
        ft.generate_program(curl))
    for length in (E_SMALL, E_FULL):
        cases.append(("dg_curl_ndof35 prereduce, R hoisted", curl,
                      curl_prog, length))

    out = {"row_reduce_f32": 0.0, "ew_flat_f32": 0.0,
           "dg_rows_f32": worst["dg_rows_f32"]}
    for case, e, program, length in cases:
        plan = plan_cuda_launch(program, get_index_lengths(e, length))
        operands = plan.operands(apply_layouts(program, generate_input_arrays(
            e, long_dim_length=length, seed=1, device=dev)))
        got = plan.run(operands)
        want = plan.plain(operands)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            abs_err, rel = max_err(g, w)
            out[plan.kernel] = max(out[plan.kernel], abs_err)
            ok = rel <= RTOL
            log(f"[compare] {plan.kernel} {case} E={length}:"
                f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                f" max|plain| (tolerance {RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"{plan.kernel} disagrees with its plain"
                                   f" version on {case}")
        del operands, got, want

    # row_reduce_f32 against its byte bound, and the device's idle share;
    # one set of inputs per row and length serves both layouts
    for length in (E_FULL, E_REDUCE_LONG):
        for name in ("vecmat_ndof35", "rowsum_ndof35"):
            e = ext[name]
            logical = generate_input_arrays(e, long_dim_length=length,
                                            device=dev)
            for case, _, program, _ in cases[:8:2]:
                if not case.startswith(name):
                    continue
                arrays = apply_layouts(program, logical)
                fn = ft.build_executable(program, long_dim_length=length,
                                         device=dev)
                plan = plan_cuda_launch(program, get_index_lengths(e, length))
                times = timed_in_turns(
                    {"kernel": fn,
                     "plain": lambda a, plan=plan: plan.plain(
                         plan.operands(a)),
                     "library": library_call(program)},
                    {k: arrays for k in ("kernel", "plain", "library")})
                log(f"[time] row_reduce_f32 {case} E={length}: kernel"
                    f" {sum(times['kernel']) / 2:.4f} ms, plain version"
                    f" {sum(times['plain']) / 2:.4f} ms, library call"
                    f" {sum(times['library']) / 2:.4f} ms,"
                    f" {bound_text(e, length)} (runs {times}) {label}")
                report(f"row_reduce_f32 {case} E={length}", "kernel", fn,
                       arrays)
                del arrays
            del logical
            torch.cuda.empty_cache()
    return out


def f32_archive_path(dev, label: str, stats: KernelStats) -> dict:
    """Phase 10: tune, record, replay and time the f32 rows; returns the
    launches by kernel over the replays, and adds the times of
    ``row_reduce_f32`` (vecmat, rowsum) and ``ew_flat_f32`` (scale_flat)
    to *stats*."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import (
        generate_program_with_opt_einsum_schedule, get_index_lengths)
    from feinsum_tpu_torch.data.device_info import get_device_key
    from feinsum_tpu_torch.measure import apply_layouts, \
        evaluate_giga_op_map, generate_input_arrays, get_giga_op_map
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.suite import (F32_SPACES, SCALE_FLAT_LENGTH,
                                         candidate_transforms,
                                         f32_rows, f32_seed_configs)

    db = HERE / "build" / "chip_smoke" / "f32_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    key = get_device_key(dev)
    rows = f32_rows()
    length_of = {name: SCALE_FLAT_LENGTH if name == "scale_flat" else E_FULL
                 for name, _ in rows}
    for name, e in rows:
        t0 = time.perf_counter()
        ft.autotune(e, F32_SPACES[name], db_path=str(db), device=dev,
                    long_dim_length=length_of[name],
                    test_limit=F32_TUNE_POINTS,
                    seed_configs=f32_seed_configs(name, e))
        facts = ft.query(e, dev, db_path=str(db))
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t0:.1f} s")
        for q in facts:
            log(f"[tune]   {q.device_name} {q.transform_id}"
                f" {dict(q.transform_params)}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms,"
                f" {q.total_giga_op_rate:.1f} GOp/s {label}")
        if not 1 <= len(facts) <= F32_TUNE_POINTS \
                or any(q.device_name != key for q in facts):
            raise SmokeFailure(f"{name}: expected 1 to {F32_TUNE_POINTS}"
                               f" facts under {key}")

    kernels.reset_launch_counts()
    runs = {}
    for name, e in rows:
        winner = next(candidate_transforms(name, e, db_path=str(db),
                                           device=dev))
        log(f"[replay] {winner.label}")
        if winner.fact is None or winner.fact.transform_id \
                != F32_SPACES[name] + ".py":
            raise SmokeFailure(f"{name}: the winner is not an archived"
                               f" {F32_SPACES[name]}.py fact")
        ft.validate_batched_einsum_transform(
            e, winner.transform, long_dim_length=E_VALIDATE, device=dev)
        program = winner.transform(ft.generate_program(e))
        length = length_of[name]
        logical = generate_input_arrays(e, long_dim_length=length,
                                        device=dev)
        arrays = apply_layouts(program, logical)
        fn = ft.build_executable(program, long_dim_length=length,
                                 device=dev)
        before = dict(kernels.launch_counts)
        outs = fn(arrays)
        torch.cuda.synchronize()
        if kernels.launch_counts == before:
            raise SmokeFailure(f"{name}: the replay launched no kernel")
        runs[name] = (program, logical, arrays, fn, outs)
        log(f"[replay] {name}: validated on {dev} at E={E_VALIDATE}, ran"
            f" at E={length}: outputs {[tuple(o.shape) for o in outs]}")
    launches = {k: kernels.launch_counts[k] for k in (
        "dg_rows_f32", "ew_product_f32", "ew_flat_f32", "row_reduce_f32")}
    log(f"[replay] launch counts over the replays:"
        f" {dict(kernels.launch_counts)}")
    for k, n in launches.items():
        if n < 1:
            raise SmokeFailure(f"{k} was not launched on the f32 archive"
                               " path")

    for name, e in rows:
        program, logical, arrays, fn, outs = runs.pop(name)
        length = length_of[name]
        per_step = ft.build_executable(
            generate_program_with_opt_einsum_schedule(e),
            long_dim_length=length, device=dev)
        wants = per_step(logical)
        if program.descriptor.rowcat > 1:
            # one output: the rows stacked along the long axis
            outs = list(ft.unpack_output(program, outs[0],
                                         tuple(wants[0].shape)))
        else:
            outs = [ft.unpack_output(program, o, tuple(w.shape))
                    for o, w in zip(outs, wants)]
        for got, want in zip(outs, wants):
            _, rel = max_err(got, want)
            log(f"[check] {name} E={length}: max|replay-per-step| ="
                f" {rel:.2e} of max|per-step| (tolerance {RTOL})")
            if rel > RTOL:
                raise SmokeFailure(f"{name}: E={length} output differs from"
                                   f" the plain per-step route by {rel:.2e}")
        del outs, wants
        plan = plan_cuda_launch(program, get_index_lengths(
            program.einsum, length * program.descriptor.rowcat))
        times = timed_in_turns(
            {"kernel": fn,
             "plain": lambda a, plan=plan: plan.plain(plan.operands(a)),
             "per-step": per_step,
             "library": library_call(program)},
            {"kernel": arrays, "plain": arrays, "per-step": logical,
             "library": arrays})
        gops = sum(evaluate_giga_op_map(get_giga_op_map(e), length).values())
        roof = ft.get_roofline_flop_rate(e, dev, long_dim_length=length,
                                         ignore_unknown_device=True)
        log(f"[time] {name} E={length} {bound_text(e, length, program)}")
        for route, ts in (("kernel " + plan.kernel, times["kernel"]),
                          ("plain version", times["plain"]),
                          ("plain per-step route", times["per-step"]),
                          ("library call (torch.einsum)", times["library"])):
            ms = sum(ts) / len(ts)
            rate = gops / (ms * 1e-3)
            share = (f"{100 * rate / roof:.1f}% of roofline"
                     f" ({roof:.0f} GOp/s)" if roof else "roofline unknown")
            log(f"[time] {name} E={length} {route}: {ms:.4f} ms"
                f" (runs {', '.join(f'{t:.4f}' for t in ts)}),"
                f" {rate:.1f} GOp/s, {share} {label}")
        if plan.kernel in ("row_reduce_f32", "ew_flat_f32"):
            stats.add(plan.kernel, e, length, sum(times["kernel"]) / 2,
                      sum(times["plain"]) / 2, sum(times["library"]) / 2,
                      program)
        del logical, arrays
        torch.cuda.empty_cache()
    return launches


def curl_prereduce_comparison(dev, label: str) -> None:
    """Phase 11: curl at its ``prereduce`` point (``R = sum_r D`` hoisted,
    one S = 1 launch) and at its default point (S = 3), timed in turns."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.measure import apply_layouts, generate_input_arrays
    from feinsum_tpu_torch.suite import extended_suite, space_point
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    e = dict(extended_suite())["dg_curl_ndof35"]
    space = get_transform_func_from_module_path("curl_3d_v0")
    logical = generate_input_arrays(e, long_dim_length=E_FULL, device=dev)
    fns, arrays = {}, {}
    for point, knobs in (("default", {}), ("prereduce", {"prereduce": True})):
        program = space.bind_args(e, **space_point("curl_3d_v0", e, **knobs))(
            ft.generate_program(e))
        arrays[point] = apply_layouts(program, logical)
        fns[point] = ft.build_executable(program, long_dim_length=E_FULL,
                                         device=dev)
    outs = {k: fns[k](arrays[k]) for k in fns}
    for a, b in zip(outs["default"], outs["prereduce"]):
        _, rel = max_err(b, a)
        if rel > RTOL:
            raise SmokeFailure(f"curl prereduce differs from the default"
                               f" point by {rel:.2e}")
    times = timed_in_turns(fns, arrays)
    log(f"[curl] E={E_FULL} default point {sum(times['default']) / 2:.4f}"
        f" ms, prereduce point {sum(times['prereduce']) / 2:.4f} ms"
        f" (runs {times}) {label}")
    del logical, arrays
    torch.cuda.empty_cache()


# phase 12's einsums: (name, subscripts, operand names); "u" twice is one
# tensor read by both operands, as in the energy
LONG_REDUCE_CASES = (("energy", "ej,ej->", ("u", "u")),
                     ("per-letter sum", "ej,ej->j", ("u", "v")),
                     ("Gram", "ei,ej->ij", ("u", "v")))
E_RAGGED = 1_000_003
LONG_REDUCE_BLOCK = 512


def long_reduce_einsum(subs: str, names: tuple, ndof: int = 35):
    import feinsum_tpu_torch as ft
    ins = subs.split("->")[0].split(",")
    return ft.einsum(subs, *[ft.array(n, ("E",) + (ndof,) * (len(s) - 1),
                                       "float32")
                             for n, s in zip(names, ins)])


def long_reduce_check(dev, label: str, stats: KernelStats) -> float:
    """Phase 12: ``long_reduce_f32`` against ``long_reduce_plain`` and a
    float64 ``torch.einsum`` on the energy, the per-letter sum and the Gram
    matrix at E = 1M and a ragged E = 1,000,003, ndof 35, in the dof-major
    and the element-major layout; the error of each against float64 within
    2e-5 of the sum of the terms' magnitudes.  Times the three at E = 1M
    dof-major (kernel, plain version, ``torch.einsum`` on the stored
    operands) into *stats*, and prints the kernel's device-busy time and
    idle share.  Returns the largest |kernel - plain|."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.layouts import dofmajor_layouts, \
        stored_arg_layouts, stored_out_letters
    from feinsum_tpu_torch.tools.profile_suite import report

    worst = 0.0
    for name, subs, names in LONG_REDUCE_CASES:
        e = long_reduce_einsum(subs, names)
        layouts, out_layout = dofmajor_layouts(e)
        base = ft.generate_program(e).with_descriptor(
            backend="pallas", block_long=LONG_REDUCE_BLOCK,
            dimension_semantics="arbitrary")
        for layout, program in (
                ("dof-major", base.with_descriptor(arg_layouts=layouts,
                                                   out_layout=out_layout)),
                ("element-major", base)):
            stored = stored_arg_layouts(program)
            f64_subs = (",".join("".join(stored[a.name]) for a in e.args[0])
                        + "->" + "".join(stored_out_letters(program)))
            for length in (E_FULL, E_RAGGED):
                arrays = apply_layouts(program, generate_input_arrays(
                    e, long_dim_length=length, seed=3, device=dev))
                plan = plan_cuda_launch(program, get_index_lengths(e, length))
                operands = plan.operands(arrays)
                (got,) = plan.run(operands)
                (want,) = plan.plain(operands)
                ops64 = [arrays[a.name].double() for a in e.args[0]]
                ref = torch.einsum(f64_subs, *ops64)
                mag = torch.einsum(f64_subs, *[t.abs() for t in ops64])
                torch.cuda.synchronize()
                abs_err, _ = max_err(got, want)
                worst = max(worst, abs_err)
                rel = {k: float(((v.double() - ref).abs() / mag).max())
                       for k, v in (("kernel", got), ("plain", want))}
                ok = plan.kernel == "long_reduce_f32" and all(
                    r <= RTOL for r in rel.values())
                log(f"[compare] long_reduce_f32 {name} {subs} {layout}"
                    f" E={length}: max|kernel-plain| {abs_err:.3e}; error"
                    f" against float64 / sum|terms|: kernel"
                    f" {rel['kernel']:.2e}, plain {rel['plain']:.2e}"
                    f" (tolerance {RTOL}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"long_reduce_f32 fails on {name}"
                                       f" {layout} E={length}")
                if length == E_FULL and layout == "dof-major":
                    fn = ft.build_executable(program, long_dim_length=length,
                                             device=dev)
                    times = timed_in_turns(
                        {"kernel": fn,
                         "plain": lambda a, plan=plan: plan.plain(
                             plan.operands(a)),
                         "library": library_call(program)},
                        {k: arrays for k in ("kernel", "plain", "library")})
                    ms = {k: sum(v) / 2 for k, v in times.items()}
                    log(f"[time] long_reduce_f32 {name} {subs} E={length}:"
                        f" kernel {ms['kernel']:.4f} ms, plain version"
                        f" {ms['plain']:.4f} ms, torch.einsum"
                        f" {ms['library']:.4f} ms, {bound_text(e, length)}"
                        f" (runs {times}) {label}")
                    stats.add("long_reduce_f32", e, length, ms["kernel"],
                              ms["plain"], ms["library"])
                    report(f"long_reduce_f32 {name} E={length}", "kernel",
                           fn, arrays)
                del arrays, operands, got, want, ops64, ref, mag
                torch.cuda.empty_cache()
    return worst


def relayout_rates(dev, label: str) -> dict:
    """The H100's rates of the two in-graph relayouts the consumer path
    pays (``apply._RETILE_GBPS``, ``apply._STREAM_GBPS``): a permute copy of
    an (E, 35) float32 tensor into (35, E) and a contiguous ``torch.cat`` of
    three of them, at E = 1M; each rate is twice the bytes (read and
    written) over the CUDA-event time."""
    import torch

    from feinsum_tpu_torch.measure import timeit_cuda

    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand((E_FULL, 35), generator=gen, device=dev)
          for _ in range(3)]
    arrays = {f"x{k}": x for k, x in enumerate(xs)}
    t_perm = timeit_cuda(lambda a: a["x0"].permute(1, 0).contiguous(),
                         arrays)
    t_cat = timeit_cuda(lambda a: torch.cat([a["x0"], a["x1"], a["x2"]]),
                        arrays)
    nbytes = xs[0].numel() * 4
    rates = {"retile": 2 * nbytes / (t_perm * 1e-3) / 1e9,
             "stream": 2 * 3 * nbytes / (t_cat * 1e-3) / 1e9}
    log(f"[relayout] E={E_FULL} ndof 35: permute copy {t_perm:.4f} ms"
        f" = {rates['retile']:.1f} GB/s, torch.cat of three {t_cat:.4f} ms"
        f" = {rates['stream']:.1f} GB/s {label}")
    del xs, arrays
    torch.cuda.empty_cache()
    return rates


CONSUMER_TUNE_POINTS = 2   # measured points per consumer row
CONSUMER_LONG_DIM = 1000   # compile_user_rhs.py's long_dim_length
MODEL_STEPS = 5            # checked steps per model
MODEL_TIMED_STEPS = 20


def consumer_flow(dev, label: str) -> dict:
    """Phase 13: ``examples/compile_user_rhs.py``'s flow at its own size
    (E = 100,000, ndof 35, 4 faces x 15): the relayout rates; autotune of
    the div (b = 3), lift and energy classes into a fresh archive under
    ``build/``; ``compile_fn_with_archive`` on the torch ``user_rhs`` and
    ``user_rhs_limited`` (no shootout: the archived kernels must serve every
    plan); each plan and the kernel it goes to; the outputs against the
    plain torch function within 2e-5 of max|ref|; cold and warm time per
    call.  Returns the launches of the compiled calls by kernel, counted
    from 0."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import suite as S
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.data.device_info import get_device_key
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch

    relayout_rates(dev, label)
    E = S.CONSUMER_SIZES["E"]
    db = HERE / "build" / "chip_smoke" / "consumer_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    key = get_device_key(dev)
    sizes = {k: S.CONSUMER_SIZES[k] for k in ("ndof", "nf", "nfdof")}
    for name, e in S.consumer_rows(**sizes):
        space = S.CONSUMER_SPACES[name]
        seeds = [S.space_point(space, e), S.space_point(space, e,
                                                        dofmajor=False)]
        t0 = time.perf_counter()
        ft.autotune(e, space, db_path=str(db), device=dev,
                    long_dim_length=E, test_limit=CONSUMER_TUNE_POINTS,
                    seed_configs=seeds)
        facts = ft.query(e, dev, db_path=str(db))
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t0:.1f} s")
        for q in facts:
            log(f"[tune]   {q.device_name} {q.transform_id}"
                f" {dict(q.transform_params)}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms,"
                f" {q.total_giga_op_rate:.1f} GOp/s {label}")
        if not facts or any(q.device_name != key for q in facts):
            raise SmokeFailure(f"{name}: no facts under {key}")

    args = S.consumer_args(E=E, **sizes, device=dev)
    launches = {k: 0 for k in kernels.launch_counts}
    for fn in (S.user_rhs, S.user_rhs_limited):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn2 = ft.compile_fn_with_archive(
            fn, args, db_path=str(db), long_dim_length=CONSUMER_LONG_DIM,
            shootout=False)
        kernels.reset_launch_counts()
        got = fn2(*args)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        for k, n in kernels.launch_counts.items():
            launches[k] += n
        plan_kernels = []
        for infos, einsum, program in fn2.plans:
            if program.descriptor.backend != "pallas":
                raise SmokeFailure(f"{fn.__name__}: the plan of"
                                   f" {einsum.get_subscripts()} is not an"
                                   " archived kernel program")
            kernel = plan_cuda_launch(program, get_index_lengths(
                program.einsum, E * program.descriptor.rowcat)).kernel
            plan_kernels.append((einsum, kernel))
            log(f"[consumer] {fn.__name__}: plan"
                f" {einsum.get_subscripts():24s} b={einsum.b}"
                f" insns={[i.flat_index for i in infos]}"
                f" scales={[i.scale for i in infos]}"
                f" scale_vars={[len(i.scale_vars) for i in infos]}"
                f" -> {kernel} (block {program.descriptor.block_long},"
                f" layouts {dict(program.descriptor.arg_layouts)})")
        if not any(e.b == 3 and k == "dg_rows_f32" for e, k in plan_kernels):
            raise SmokeFailure(f"{fn.__name__}: the div instructions do not"
                               " form one b = 3 plan on dg_rows_f32")
        if fn is S.user_rhs_limited and not any(
                k == "long_reduce_f32" for _, k in plan_kernels):
            raise SmokeFailure("the energy plan does not run"
                               " long_reduce_f32")
        want = fn(*args)
        torch.cuda.synchronize()
        for g, w in zip(_tensors(got), _tensors(want)):
            _, rel = max_err(g, w)
            log(f"[consumer] {fn.__name__}: output {tuple(g.shape)},"
                f" max|compiled-plain| = {rel:.2e} of max|plain|"
                f" (tolerance {RTOL})")
            if rel > RTOL:
                raise SmokeFailure(f"{fn.__name__}: the compiled output"
                                   f" differs from the plain function by"
                                   f" {rel:.2e}")
        arrays = {"dt": args[0]}
        times = timed_in_turns(
            {"compiled": lambda a: _tensors(fn2(*args)),
             "plain": lambda a: _tensors(fn(*args))},
            {"compiled": arrays, "plain": arrays})
        log(f"[consumer] {fn.__name__} E={E}: cold (plans, spot checks,"
            f" first call) {cold:.3f} s; warm per call: compiled"
            f" {sum(times['compiled']) / 2:.4f} ms, plain torch function"
            f" {sum(times['plain']) / 2:.4f} ms (runs {times}) {label}")
        del got, want
    # what the automatic shootout serves (the plans above are pinned)
    fn3 = ft.compile_fn_with_archive(
        S.user_rhs_limited, args, db_path=str(db),
        long_dim_length=CONSUMER_LONG_DIM)
    log(f"[consumer] with the automatic shootout: "
        f"{[(e.get_subscripts(), p.descriptor.backend) for _, e, p in fn3.plans]}")
    del args, fn3
    torch.cuda.empty_cache()
    log(f"[consumer] launch counts over the compiled calls: {launches}")
    for k in ("dg_rows_f32", "long_reduce_f32"):
        if launches[k] < 1:
            raise SmokeFailure(f"{k} was not launched by the consumer flow")
    return launches


def _tensors(x) -> tuple:
    """The tensors of an output: a tensor, a tuple of them or a dict."""
    if isinstance(x, dict):
        return tuple(x.values())
    return tuple(x) if isinstance(x, (tuple, list)) else (x,)


def _step_check(name, step, plain_step, state, geom, n_elements, ndof,
                label, also=None) -> None:
    """MODEL_STEPS steps of *step*, each against *plain_step* from the same
    state within RTOL of max|plain|; then ms per step (CUDA events over
    MODEL_TIMED_STEPS chained steps), in turns with the plain step and the
    steps of *also* (label -> step)."""
    import torch

    for k in range(MODEL_STEPS):
        nxt = step(state, geom)
        want = plain_step(state, geom)
        rels = {f: max_err(nxt[f], want[f])[1] for f in nxt}
        log(f"[model] {name} step {k}: max rel diff to the per-step route"
            f" {max(rels.values()):.2e} (tolerance {RTOL})")
        if max(rels.values()) > RTOL:
            raise SmokeFailure(f"{name} step {k}: the kernel route differs"
                               f" from the per-step route by {rels}")
        state = nxt
        del want

    def chained(fn):
        def run(_):
            st = state
            for _ in range(MODEL_TIMED_STEPS):
                st = fn(st, geom)
            return _tensors(st)
        return run
    routes = {"kernel": step, **(also or {}), "per-step route": plain_step}
    arrays = dict(state)
    times = timed_in_turns({k: chained(f) for k, f in routes.items()},
                           {k: arrays for k in routes})
    for route, ts in times.items():
        ms = sum(ts) / len(ts) / MODEL_TIMED_STEPS
        log(f"[model] {name} E={n_elements} ndof {ndof} {route}: {ms:.4f}"
            f" ms per step ({n_elements * ndof / (ms * 1e-3) / 1e9:.2f}"
            f" Gdof/s; {MODEL_TIMED_STEPS} chained steps, runs"
            f" {[round(t, 4) for t in ts]}) {label}")
    torch.cuda.synchronize()


def models_full_width(dev, label: str) -> dict:
    """Phase 14: the wave model at E = 500,000 (ndof 35, 4 x 15 face dofs)
    and Maxwell at E = 65,536 (ndof 35) with the default schedules
    (``db_path=None``, the reference's 4096 elements per block): the
    restriction row's kernel against its plain version, 5 steps each
    against the plain per-step route, and ms per step and Gdof/s, timed in
    turns with the per-step route and with the kernels at the suite's
    ``BLOCK_LONG``.  Returns the launches of one kernel step of each."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import suite as S
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch

    launches = {k: 0 for k in kernels.launch_counts}
    w = S.MODEL_SIZES["wave"]
    op = ft.WaveOperator3D(ndof=w["ndof"], nfacedof=w["nfacedof"],
                           nfaces=w["nfaces"], db_path=None)
    plain_op = ft.WaveOperator3D(ndof=w["ndof"], nfacedof=w["nfacedof"],
                                 nfaces=w["nfaces"], use_pallas=False)
    E = w["n_elements"]
    restrict = op.programs["restrict"]
    plan = plan_cuda_launch(restrict, get_index_lengths(restrict.einsum, E))
    if plan.kernel != "dg_rows_f32":
        raise SmokeFailure(f"the restriction row plans onto {plan.kernel}")
    operands = plan.operands(apply_layouts(restrict, generate_input_arrays(
        restrict.einsum, long_dim_length=E, seed=1, device=dev)))
    abs_err, rel = max_err(plan.run(operands)[0], plan.plain(operands)[0])
    log(f"[model] wave restriction {restrict.einsum.get_subscripts()}"
        f" -> {plan.kernel} (merged i = 60): max|kernel-plain|"
        f" {abs_err:.3e} = {rel:.2e} of max|plain| (tolerance {RTOL})")
    if rel > RTOL:
        raise SmokeFailure("dg_rows_f32 disagrees with its plain version on"
                           " the restriction row")
    del operands
    state, geom = ft.make_wave_state(E, ndof=w["ndof"],
                                     nfacedof=w["nfacedof"],
                                     nfaces=w["nfaces"], device=dev)
    kernels.reset_launch_counts()
    step = op.make_step(E)
    step(state, geom)
    torch.cuda.synchronize()
    for k, n in kernels.launch_counts.items():
        launches[k] += n
    alt = ft.WaveOperator3D(ndof=w["ndof"], nfacedof=w["nfacedof"],
                            nfaces=w["nfaces"], block_long=S.BLOCK_LONG)
    _step_check("wave", step, plain_op.make_step(E), state, geom, E,
                w["ndof"], label,
                also={f"kernel, block {S.BLOCK_LONG}": alt.make_step(E)})
    del state, geom
    torch.cuda.empty_cache()

    m = S.MODEL_SIZES["maxwell"]
    E = m["n_elements"]
    op = ft.MaxwellOperator3D(ndof=m["ndof"], db_path=None)
    plain_op = ft.MaxwellOperator3D(ndof=m["ndof"], use_pallas=False)
    state, geom = ft.make_maxwell_state(E, ndof=m["ndof"], device=dev)
    kernels.reset_launch_counts()
    step = op.make_step(E)
    step(state, geom)
    torch.cuda.synchronize()
    for k, n in kernels.launch_counts.items():
        launches[k] += n
    alt = ft.MaxwellOperator3D(ndof=m["ndof"], block_long=S.BLOCK_LONG)
    _step_check("maxwell", step, plain_op.make_step(E), state, geom, E,
                m["ndof"], label,
                also={f"kernel, block {S.BLOCK_LONG}": alt.make_step(E)})
    del state, geom
    torch.cuda.empty_cache()
    log(f"[model] launch counts over one step of each model: {launches}")
    if launches["dg_rows_f32"] < 1:
        raise SmokeFailure("the models launched no dg_rows_f32")
    return launches


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
