#!/usr/bin/env python3
"""Drive feinsum_tpu_torch's main path once on one NVIDIA GPU (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --split-only       # phases 1 and 15-17 alone
    python3 chip_smoke.py --lane-pack-only   # phases 1 and 18 alone
    python3 chip_smoke.py --step-only        # phases 1 and 19 alone
    python3 chip_smoke.py --tc-steps-only    # phases 1 and 20 alone
    python3 chip_smoke.py --probes-only      # phases 1 and 21 alone

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
   the default schedules (``suite.BLOCK_LONG`` elements per block): the
   face restriction on ``dg_rows_f32`` against its plain version, 5 steps
   each against the per-step route within 2e-5, then ms per step and
   Gdof/s, in turns with the reference's TPU block of 4096;
15. ``precision="bf16_3x"`` (three TF32 tensor-core passes over an f32
   hi/lo split): ``dg_rows_3xtf32`` against ``dg_rows_3x_plain`` on the
   five suite DG rows, the face restriction and curl with ``prereduce`` at
   E = 1M, ``tc_grid_3xtf32`` against ``tc_grid_3x_plain`` on the five
   rank >= 3 TCCG rows at their published sizes, each within 1e-6 of the
   sum of the terms' magnitudes (times sqrt(K / 64) for a contraction over
   K > 64: both are float32 sums), and each program against the numpy
   oracle on the card (E = 2000 for the DG rows, full size for TCCG);
   each suite and TCCG row's 3x kernel timed beside its f32 kernel, the
   plain version, ``torch.einsum`` in f32 and the bound;
16. the bf16_3x archive path: the five DG rows tuned with ``precision_3x``
   off and on, the TCCG rows in ``tc_pallas_v1`` with ``precision_idx`` 0
   and 1, into a fresh archive under ``build/``; counters reset; each row's
   champion replayed through ``candidate_transforms`` (which rows chose 3x
   is printed) and, where it is f32, the row's best bf16_3x fact
   (``sql_utils.retrieve`` with a filter), each against the plain per-step
   route within 2e-5; the four shipped ``tc_gemm_v0`` facts at bf16_3x whose
   resident factor exceeds ``dg_rows_3xtf32``'s shared memory, on
   ``probe_apply_3xtf32`` against its plain version and the numpy oracle,
   then counters set to 0, the four replayed through ``build_executable``
   and ``probe_apply_3xtf32`` read from the counters, then each timed in
   turns against its plain version and one ``torch.einsum``;
17. Maxwell at E = 65,536 built from an archive whose curl fact (a
   ``dg_div_v0.py`` point) sets ``precision_3x``, ``fold`` and
   ``preblock``: the model drops the storage knobs, its curl runs on
   ``dg_rows_3xtf32``; 5 steps against the per-step route, timed beside the
   f32 default;
18. the lane-pack path (``lane_pack_g``) at E = 1M on the rows of the
   shipped archive's lane-pack facts (div and grad at ndof 4, 10, 20,
   face-mass at 35/15, matvec at 20, vecmat at 35) and mass and curl at
   ndof 35: ``lane_pack_dg_f32`` and ``lane_pack_dg_3xtf32`` against their
   plain versions on the packed DG rows at g = 8 (2e-5 of max|plain|; the 3x
   within ``split_tolerance`` of the terms); counters reset; each of the
   104 shipped TPU lane-pack facts bound and replayed as an H100 program
   (95, the two champions among them, against the plain per-step route
   within 2e-5, the 25 whose kron resident exceeds ``dg_rows_f32``'s shared
   memory on ``probe_apply_f32``, also against its plain version and timed
   in turns against it and one ``torch.einsum``; 7 refused naming
   ``fold``, 2 ``mfold``);
   counters read; the rows tuned with ``lane_pack_g`` searched into a fresh
   archive under ``build/`` (which champions are packed); each packed point
   timed in turns against the row's unpacked champion and one
   ``torch.einsum`` of the logical einsum, beside the logical einsum's
   bound and the packed program's dense flops;
19. K1's general steps on ``step_block_f32``: the demo ``ij,ejk->eik`` at
   ndof 35 tuned in ``demo_transform_space`` (two points at E = 1M) into a
   fresh archive under ``build/``, its champion taken through
   ``candidate_transforms`` and ``retrieve``; sum factorization on Q4
   hexahedra ``ai,bj,ck,eabc->eijk`` (the three-step schedule and the
   trivial one step, and b = 2), ``ej,e->ej`` and ``ej,j->`` at ndof 35
   and the Gram matrix ``ei,ej->ij`` at ndof 120, built with
   ``fused_pallas_program``; each validated against the numpy oracle at
   E = 2000 and held against ``step_block_plain`` at E = 1M (the demo and
   ``ej,j->`` also at E = 1,000,003) within 2e-5 of the sum of the terms'
   magnitudes; counters reset; each replayed or built and run at E = 1M,
   ``step_block_f32`` read from the counters; each timed in turns against
   its plain version and one ``torch.einsum`` of the logical einsum, beside
   its bound; and K1's grid letter: the demo's champion applied to the
   demo's own spelling (its bound grid_index names i there), an einsum with
   two long letters, the demo fully concrete at E = 4096 (gridded over its
   longest output letter) and at 32 (no grid), each against the numpy
   oracle and ``step_block_plain`` and run once among the counted runs;
   the Gram matrix at ndof 165 (more register tiles than a block has
   threads) against the numpy oracle and ``step_block_plain``;
20. K2's multi-step dense schedules on ``tc_steps_f32``: the kernel against
   ``tc_steps_plain`` (2e-5 of max|plain|, and over the sum of the terms'
   magnitudes) on ragged extents (3, 5, 7), a block on a batch letter,
   stored permutations of the operands and the output, a b = 2 row and the
   trivial one-step schedule of four operands; the three rows of
   ``suite.tc_steps_suite()`` (sum factorization at E = 1M, the triple
   product at ndof 35 and E = 100,000, two operators on one mode) tuned in
   ``tc_pallas_v0`` and ``tc_pallas_v1`` (the seeds of
   ``suite.TC_STEPS_SEEDS``) into a fresh archive under ``build/``; each
   champion taken through ``candidate_transforms``, validated against the
   numpy oracle on the card (E = 2000 for the two rows with an element
   axis, two operators at full size); counters reset; each replayed at full
   size and ``tc_steps_f32`` read from the counters; each output held to
   ``tc_steps_plain`` within 2e-5; each timed in turns against its plain
   version and one ``torch.einsum`` of the whole einsum (sum factorization
   also on phase 19's ``step_block_f32`` route, E a long axis), beside its
   bound;
21. the TPU probes as Hopper probes (``feinsum_tpu_torch/probes/``):
   ``probe_stream_f32``, ``probe_apply_f32`` and ``probe_apply_3xtf32``
   against their plain versions at E = 777 (776 under the folded mapping
   I) and E = 2**20 on every storage (copies, both transposing copies, the
   matvec element-major, dof-major and folded, the div with b = 3, the
   kron matvec with jac, lane-reshape C at K = 640), f32 within 2e-5 of
   max|plain|, 3x within ``split_tolerance`` of the terms; counters reset;
   every case of the eight probe modules at its first block size (the
   kernels' defaults) driven once, the counters read; each case then
   checked against its plain version and timed in turns against it and one
   PyTorch call of the same function, beside its bound (the lane-reshape
   cases also as CUDA graphs, the device's time without the host's).

The last lines are the card line, one JSON object of per-kernel results
(each kernel's time, its plain version's, the bound of the data-sheet
roofline for the same work and one PyTorch call's for the same function;
``max_abs_err`` is the largest |kernel - plain| and ``max_err_over_terms``
the largest of that over the sum of the terms' magnitudes at the entry),
and ``{"ok": true, "device": {...}}``.  The times of ``dg_rows_f32`` and
``ew_product_f32`` are phase 4's rows, those of ``row_reduce_f32`` and
``ew_flat_f32`` phase 10's, ``long_reduce_f32``'s phase 12's, the 3x
kernels' phase 15's, the lane-pack kernels' phase 18's (g = 8, their
bound that of the logical einsum), ``step_block_f32``'s phase 19's,
``tc_steps_f32``'s phase 20's, the probe kernels' phase 21's (summed over
its cases); launches are counted over the main path (phase 3), the archive
replays (phases 6, 8, 10, 16, 18, 20), the consumer flow's calls (phase
13), one step of each model (phases 14, 17), phase 19's runs and phase
21's one drive of each probe case.  It imports no JAX.
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
SPLIT_KERNELS = ("dg_rows_3xtf32", "tc_grid_3xtf32")
# a 3x kernel against its plain version, over the sum of the terms'
# magnitudes: the same split summed in another order, both in float32, so
# for a contraction over K > 64 it grows as sqrt(K / 64), as the rounding of
# a float32 sum does (the plain version's alone reaches 1e-6 at K = 312)
RTOL_3X = 1e-6


def split_tolerance(K: int) -> float:
    return RTOL_3X * max(1.0, math.sqrt(K / 64))
REPLACES = {"dg_rows_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "dg_rows_3xtf32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "tc_grid_3xtf32": "feinsum_tpu/ops/pallas_emitter.py:268",
            "long_reduce_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "ew_product_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "ew_flat_f32": "feinsum_tpu/ops/pallas_emitter.py:187",
            "row_reduce_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "dd_rows": "feinsum_tpu/ops/dd_emitter.py:233",
            "tc_grid_f32": "feinsum_tpu/ops/pallas_emitter.py:268",
            "lane_pack_dg_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "lane_pack_dg_3xtf32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "step_block_f32": "feinsum_tpu/ops/pallas_emitter.py:464",
            "tc_steps_f32": "feinsum_tpu/ops/pallas_emitter.py:268",
            "probe_stream_f32": "scripts/tpu_layout_probe.py:75;"
                                " scripts/tpu_fold_probe.py:84, :96;"
                                " scripts/tpu_lane_reshape_probe.py:52 (A,"
                                " B)",
            "probe_apply_f32": "scripts/tpu_layout_probe.py:101, :119;"
                               " scripts/tpu_fold_probe.py:117, :162;"
                               " scripts/tpu_fold_probe2.py:102, :123,"
                               " :191; scripts/tpu_fold_probe3.py:95,"
                               " :109, :122, :158, :183;"
                               " scripts/tpu_fold_probe4.py:95, :110,"
                               " :144, :163; scripts/tpu_fold_probe5.py:87,"
                               " :102, :133, :151;"
                               " scripts/tpu_kron_probe.py:62, :90;"
                               " scripts/tpu_lane_reshape_probe.py:52 (C,"
                               " D)",
            "probe_apply_3xtf32": "scripts/tpu_fold_probe.py:162;"
                                  " scripts/tpu_fold_probe2.py:102, :123,"
                                  " :191; scripts/tpu_fold_probe4.py:95,"
                                  " :110, :144, :163, :201;"
                                  " scripts/tpu_fold_probe5.py:87, :102,"
                                  " :133, :151, :187;"
                                  " scripts/tpu_kron_probe.py:62"}
SOURCES = {"dg_rows_f32": "feinsum_tpu_torch/csrc/dg_rows.cu",
           "ew_product_f32": "feinsum_tpu_torch/csrc/ew_product.cu",
           "ew_flat_f32": "feinsum_tpu_torch/csrc/ew_product.cu",
           "row_reduce_f32": "feinsum_tpu_torch/csrc/row_reduce.cu",
           "long_reduce_f32": "feinsum_tpu_torch/csrc/long_reduce.cu",
           "dd_rows": "feinsum_tpu_torch/csrc/dd_rows.cu",
           "tc_grid_f32": "feinsum_tpu_torch/csrc/tc_grid.cu",
           "dg_rows_3xtf32": "feinsum_tpu_torch/csrc/dg_rows_3x.cu",
           "tc_grid_3xtf32": "feinsum_tpu_torch/csrc/tc_grid_3x.cu",
           "lane_pack_dg_f32": "feinsum_tpu_torch/csrc/lane_pack_dg.cu",
           "lane_pack_dg_3xtf32": "feinsum_tpu_torch/csrc/lane_pack_dg.cu",
           "step_block_f32": "feinsum_tpu_torch/csrc/step_block.cu",
           "tc_steps_f32": "feinsum_tpu_torch/csrc/tc_steps.cu",
           "probe_stream_f32": "feinsum_tpu_torch/csrc/probe_stream.cu",
           "probe_apply_f32": "feinsum_tpu_torch/csrc/probe_apply.cu",
           "probe_apply_3xtf32": "feinsum_tpu_torch/csrc/probe_apply.cu"}
# the data-sheet peaks of the roofline bound (NVIDIA H100 SXM at 700 W);
# TF32 on the tensor cores, dense
PEAK_BYTES_PER_MS = 3.35e9
PEAK_OPS_PER_MS = {"float32": 67e9, "float64": 34e9}
PEAK_TF32_OPS_PER_MS = 495e9
# per kernel: the largest |kernel - plain|, and that over the sum of the
# terms' magnitudes at the entry
ERRORS = {k: {"abs": 0.0, "terms": 0.0} for k in SOURCES}


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


def note_error(kernel: str, got, want, terms) -> float:
    """Record *got* against *want* for *kernel*: the largest |got - want|,
    and that over *terms*, the sum of the terms' magnitudes at each entry
    (the plain version on the operands' magnitudes); returns the latter."""
    got, want, terms = got.double(), want.double(), terms.double()
    diff = (got - want).abs()
    over = float((diff / terms.clamp_min(1e-300)).max())
    err = ERRORS[kernel]
    err["abs"] = max(err["abs"], float(diff.max()))
    err["terms"] = max(err["terms"], over)
    return over


def magnitudes(operands) -> list:
    """The kernel rows with every tensor replaced by its magnitude: a plain
    version run on them gives the sum of the terms' magnitudes at each
    output entry."""
    import torch
    from dataclasses import fields, is_dataclass

    def mag(row):
        if isinstance(row, torch.Tensor):
            return row.abs()
        if is_dataclass(row):
            return replace(row, **{
                f.name: getattr(row, f.name).abs() for f in fields(row)
                if isinstance(getattr(row, f.name), torch.Tensor)})
        return type(row)(mag(t) for t in row)
    return [mag(row) for row in operands]


def kernel_check(plan, operands, name: str, launches: dict) -> None:
    """*plan*'s kernel against its plain version on *operands* (a 3x kernel
    relative to the sum of the terms' magnitudes, its tolerance by K), the
    launch counters put back to *launches* afterwards, so that the
    comparison adds no launch to the path's."""
    import torch

    from feinsum_tpu_torch.ops import kernels
    got = plan.run(operands)
    want = plan.plain(operands)
    terms = plan.plain(magnitudes(operands))
    torch.cuda.synchronize()
    kernels.launch_counts.update(launches)
    split = plan.kernel.endswith("3xtf32")
    K = operands[0][1].shape[-1] if split else 0
    for g, w, t in zip(got, want, terms):
        _, rel = max_err(g, w)
        over = note_error(plan.kernel, g, w, t)
        tol = split_tolerance(K) if split else RTOL
        ok = (over if split else rel) <= tol
        log(f"[compare] {plan.kernel} {name}: max|kernel-plain| = {rel:.2e}"
            f" of max|plain|, {over:.2e} of the terms' magnitudes"
            f" (tolerance {tol:.2e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SmokeFailure(f"{plan.kernel} disagrees with its plain"
                               f" version on {name}")


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


def row_bound(e, length: int, program=None, precision: str = "default",
              padded_flops: float = 0.0) -> tuple:
    """``(bytes ms, operations ms)`` of one row: its bytes (each operand
    read once, each output written once) over the peak memory rate, and
    its operations over the peak rate of their type: the optimal pairwise
    schedule's count, or *program*'s schedule's where that is smaller
    (curl's pre-reduced ``R``); the roofline bound is the larger.  At
    ``precision="bf16_3x"`` the operations are the tensor cores' three
    TF32 passes over *padded_flops*, the dot's flops at the kernel's
    padded tile sizes (:func:`split_flops`)."""
    from feinsum_tpu_torch.measure import evaluate_giga_op_map, \
        get_footprint_gbytes, get_giga_op_map
    t_bytes = get_footprint_gbytes(e, long_dim_length=length) * 1e9 \
        / PEAK_BYTES_PER_MS
    if precision == "bf16_3x":
        return t_bytes, 3 * padded_flops / PEAK_TF32_OPS_PER_MS
    schedules = [None]
    if program is not None and program.einsum == e:
        schedules.append(program.schedule)
    t_ops = min(sum(g * 1e9 / PEAK_OPS_PER_MS[dt] for dt, g in
                    evaluate_giga_op_map(get_giga_op_map(e, schedule),
                                         length).items())
                for schedule in schedules)
    return t_bytes, t_ops


def split_flops(rows) -> float:
    """The flops of the 3x kernels' dots at their padded tile sizes: per
    DG row (``DGRow``) 2 S x pad8(I) x pad8(J) x E (an m16n8k8 tile over
    M = e, N = i, K = j; the x outputs share the dot), per TC step (a
    ``TCShape``) 2 pad16(Mc) x pad8(Nc) x pad8(K) per cell, per
    ``probe_apply`` row (``(ApplyRow, R)``) 2 pad8(I) x pad8(J) x E."""
    from feinsum_tpu_torch.ops.kernels import DGRow

    def pad(n, m):
        return -(-n // m) * m
    total = 0.0
    for row in rows:
        if isinstance(row, DGRow):
            S, I, J = row.R.shape
            total += 2.0 * S * pad(I, 8) * pad(J, 8) * row.u.shape[2]
        elif isinstance(row, tuple):
            u, R = row
            S, I, J = R.shape
            total += 2.0 * S * pad(I, 8) * pad(J, 8) * u.u.shape[-1]
        else:
            total += (2.0 * pad(row.Mc, 16) * pad(row.Nc, 8) * pad(row.K, 8)
                      * row.ncells)
    return total


def bound_text(e, length: int, program=None, precision: str = "default",
               padded_flops: float = 0.0) -> str:
    t_bytes, t_ops = row_bound(e, length, program, precision, padded_flops)
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
            library_ms=None, program=None, precision: str = "default",
            padded_flops: float = 0.0) -> None:
        """One row's times, and its bound (:func:`row_bound`)."""
        t_bytes, t_ops = row_bound(e, length, program, precision,
                                   padded_flops)
        row = self.rows[kernel]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] = (None if library_ms is None
                             or row["library_ms"] is None
                             else row["library_ms"] + library_ms)
        row["bytes_ms"] += t_bytes
        row["ops_ms"] += t_ops
        row["bound_ms"] += max(t_bytes, t_ops)

    def add_bound(self, kernel: str, ms: float, plain_ms: float,
                  library_ms, bytes_ms: float, ops_ms: float) -> None:
        """One case's times and its bound's two parts, as given."""
        row = self.rows[kernel]
        row["ms"] += ms
        row["plain_ms"] += plain_ms
        row["library_ms"] = (None if library_ms is None
                             or row["library_ms"] is None
                             else row["library_ms"] + library_ms)
        row["bytes_ms"] += bytes_ms
        row["ops_ms"] += ops_ms
        row["bound_ms"] += max(bytes_ms, ops_ms)

    def entry(self, kernel: str, launches: int) -> dict:
        row = self.rows[kernel]
        return {"name": kernel, "route": "cuda", "source": SOURCES[kernel],
                "replaces": REPLACES[kernel], "launches": launches,
                "max_abs_err": ERRORS[kernel]["abs"],
                "max_err_over_terms": ERRORS[kernel]["terms"],
                "ms": row["ms"],
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

    if "--split-only" in sys.argv[1:]:
        return split_only(dev, card)
    if "--lane-pack-only" in sys.argv[1:]:
        return lane_pack_only(dev, card)
    if "--step-only" in sys.argv[1:]:
        return step_only(dev, card)
    if "--tc-steps-only" in sys.argv[1:]:
        return tc_steps_only(dev, card)
    if "--probes-only" in sys.argv[1:]:
        return probes_only(dev, card)
    rows = suite()
    programs = {name: default_transform(e)(ft.generate_program(e))
                for name, e in rows}

    def inputs(name, e, length, seed=0):
        return apply_layouts(programs[name], generate_input_arrays(
            e, long_dim_length=length, seed=seed, device=dev))

    # phase 2: each kernel against its plain version on the card
    for length in (E_SMALL, E_FULL):
        for name, e in rows:
            plan = plan_cuda_launch(programs[name],
                                    get_index_lengths(e, length))
            operands = plan.operands(inputs(name, e, length, seed=1))
            got = plan.run(operands)
            want = plan.plain(operands)
            terms = plan.plain(magnitudes(operands))
            torch.cuda.synchronize()
            for g, w, t in zip(got, want, terms):
                abs_err, rel = max_err(g, w)
                over = note_error(plan.kernel, g, w, t)
                ok = rel <= RTOL
                log(f"[compare] {plan.kernel} {name} E={length}:"
                    f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                    f" max|plain| (tolerance {RTOL}), {over:.2e} of the"
                    f" terms' magnitudes {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"{plan.kernel} disagrees with its"
                                       f" plain version on {name}")
            del operands, got, want, terms

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
    fp64_kernel_check(dev)
    launches["dd_rows"] = fp64_archive_path(dev, label, stats)
    log(f"[phase] 5-6 (fp64): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    tc_kernel_check(dev)
    launches["tc_grid_f32"] = tccg_archive_path(dev, label, stats)
    log(f"[phase] 7-8 (TCCG): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    f32_kernel_check(dev, label)
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
    long_reduce_check(dev, label, stats)
    log(f"[phase] 12 (long_reduce_f32): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for k, n in consumer_flow(dev, label).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 13 (consumer flow): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for k, n in models_full_width(dev, label).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 14 (models): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    split_kernel_check(dev, label, stats)
    log(f"[phase] 15 (bf16_3x kernels): {time.perf_counter() - t_phase:.1f}"
        " s")
    t_phase = time.perf_counter()
    split_launches = {k: 0 for k in SPLIT_KERNELS}
    for k, n in split_archive_path(dev, label, stats).items():
        split_launches[k] = split_launches.get(k, 0) + n
    log(f"[phase] 16 (bf16_3x archive path):"
        f" {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    split_launches["dg_rows_3xtf32"] += maxwell_from_archive(dev, label)
    log(f"[phase] 17 (Maxwell at bf16_3x from an archive):"
        f" {time.perf_counter() - t_phase:.1f} s")
    for k, n in split_launches.items():
        if n < 1:
            raise SmokeFailure(f"{k} was not launched on the bf16_3x path")
        launches[k] = launches.get(k, 0) + n
    t_phase = time.perf_counter()
    for k, n in lane_pack_path(dev, label, stats).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 18 (lane-pack path): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    launches["step_block_f32"] = step_block_path(dev, label, stats)
    log(f"[phase] 19 (step_block_f32): {time.perf_counter() - t_phase:.1f}"
        " s")
    t_phase = time.perf_counter()
    launches["tc_steps_f32"] = tc_steps_path(dev, label, stats)
    log(f"[phase] 20 (tc_steps_f32): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    for k, n in probe_path(dev, label, stats).items():
        launches[k] = launches.get(k, 0) + n
    log(f"[phase] 21 (the probes): {time.perf_counter() - t_phase:.1f} s;"
        f" all phases {time.perf_counter() - t0:.1f} s")

    entries = [stats.entry(k, launches[k]) for k in SOURCES]
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


def split_only(dev, card: str) -> int:
    """Phases 15-17 alone, for work on the 3x kernels: their build report,
    checks and times, and their entries of the ``kernels`` line (launches
    from phases 16-17).  It prints no ``ok`` line."""
    import torch

    from feinsum_tpu_torch.ops import _build
    label = (f"[{torch.cuda.get_device_name(0)}, power limit"
             f" {card.split(',')[-1].strip()}]")
    lines = _build.build_info["log"].splitlines()
    for k, line in enumerate(lines):
        if "3xtf32" in line and "entry function" in line:
            for text in lines[k:k + 4]:
                log("[build]", text.strip())
    stats = KernelStats()
    t0 = time.perf_counter()
    split_kernel_check(dev, label, stats)
    launches = split_archive_path(dev, label, stats)
    launches["dg_rows_3xtf32"] += maxwell_from_archive(dev, label)
    log(f"[phase] 15-17: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [stats.entry(k, launches[k])
                                for k in SPLIT_KERNELS
                                + ("probe_apply_3xtf32",)]}))
    return 0


def lane_pack_only(dev, card: str) -> int:
    """Phase 18 alone, for work on the lane-pack path: its checks, tuning
    and times, and the lane-pack kernels' entries of the ``kernels`` line
    (launches from its replays).  It prints no ``ok`` line."""
    import torch
    label = (f"[{torch.cuda.get_device_name(0)}, power limit"
             f" {card.split(',')[-1].strip()}]")
    stats = KernelStats()
    t0 = time.perf_counter()
    launches = lane_pack_path(dev, label, stats)
    log(f"[phase] 18: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [stats.entry(k, launches[k])
                                for k in LP_KERNELS
                                + ("probe_apply_f32",)]}))
    return 0


def step_only(dev, card: str) -> int:
    """Phase 19 alone, for work on ``step_block_f32``: its build report,
    checks, launches and times, and its entry of the ``kernels`` line.  It
    prints no ``ok`` line."""
    import torch

    from feinsum_tpu_torch.ops import _build
    label = (f"[{torch.cuda.get_device_name(0)}, power limit"
             f" {card.split(',')[-1].strip()}]")
    lines = _build.build_info["log"].splitlines()
    for k, line in enumerate(lines):
        if "step_block" in line and "entry function" in line:
            for text in lines[k:k + 4]:
                log("[build]", text.strip())
    stats = KernelStats()
    t0 = time.perf_counter()
    launches = step_block_path(dev, label, stats)
    log(f"[phase] 19: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [stats.entry("step_block_f32", launches)]}))
    return 0


def tc_steps_only(dev, card: str) -> int:
    """Phase 20 alone, for work on ``tc_steps_f32``: its build report,
    checks, tuning, launches and times, and its entry of the ``kernels``
    line.  It prints no ``ok`` line."""
    import torch

    from feinsum_tpu_torch.ops import _build
    label = (f"[{torch.cuda.get_device_name(0)}, power limit"
             f" {card.split(',')[-1].strip()}]")
    lines = _build.build_info["log"].splitlines()
    for k, line in enumerate(lines):
        if "tc_steps" in line and "entry function" in line:
            for text in lines[k:k + 4]:
                log("[build]", text.strip())
    stats = KernelStats()
    t0 = time.perf_counter()
    launches = tc_steps_path(dev, label, stats)
    log(f"[phase] 20: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [stats.entry("tc_steps_f32", launches)]}))
    return 0


def probes_only(dev, card: str) -> int:
    """Phase 21 alone, for work on the probe kernels: their build report,
    checks, launches and times, and their entries of the ``kernels`` line.
    It prints no ``ok`` line."""
    import torch

    from feinsum_tpu_torch.ops import _build
    label = (f"[{torch.cuda.get_device_name(0)}, power limit"
             f" {card.split(',')[-1].strip()}]")
    lines = _build.build_info["log"].splitlines()
    for k, line in enumerate(lines):
        if "probe_" in line and "entry function" in line:
            for text in lines[k:k + 4]:
                log("[build]", text.strip())
    stats = KernelStats()
    t0 = time.perf_counter()
    launches = probe_path(dev, label, stats)
    log(f"[phase] 21: {time.perf_counter() - t0:.1f} s")
    log(card)
    log(json.dumps({"kernels": [stats.entry(k, launches[k])
                                for k in PROBE_KERNELS]}))
    return 0


def fp64_kernel_check(dev) -> None:
    """Phase 5: ``dd_rows`` against ``dd_rows_plain`` on the four fp64
    rows at E_SMALL and E_FULL, on the float64 values."""
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
    for length in (E_SMALL, E_FULL):
        for name, e in fp64_suite():
            program = space.bind_args(e, log2_block=9)(ft.generate_program(e))
            plan = plan_dd_launch(program, get_index_lengths(e, length))
            operands = plan.operands(apply_layouts(
                program, generate_input_arrays(e, long_dim_length=length,
                                               seed=1, device=dev)))
            got = plan.run(operands)
            want = plan.plain(operands)
            terms = plan.plain(magnitudes(operands))
            torch.cuda.synchronize()
            for g, w, t in zip(got, want, terms):
                g, w = combine_pairs(g), combine_pairs(w)
                abs_err, rel = max_err(g, w)
                over = note_error("dd_rows", g, w, combine_pairs(t).abs())
                ok = rel <= RTOL_F64
                log(f"[compare] dd_rows {name} E={length}:"
                    f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                    f" max|plain| (tolerance {RTOL_F64}), {over:.2e} of the"
                    f" terms' magnitudes {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"dd_rows disagrees with its plain"
                                       f" version on {name}")
            del operands, got, want, terms


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


def tc_kernel_check(dev) -> None:
    """Phase 7: ``tc_grid_f32`` against ``tc_grid_plain`` on the TCCG rows
    at full size, on small ragged contractions and on stored
    permutations."""
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
    for label, step, A, B in cases:
        got = kernels.tc_grid_f32(A, B, step)
        want = kernels.tc_grid_plain(A, B, step)
        terms = kernels.tc_grid_plain(A.abs(), B.abs(), step)
        torch.cuda.synchronize()
        abs_err, rel = max_err(got, want)
        note_error("tc_grid_f32", got, want, terms)
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
        del got, want, terms


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


def f32_kernel_check(dev, label: str) -> None:
    """Phase 9: ``row_reduce_f32``, ``ew_flat_f32`` and the hoisted curl
    on ``dg_rows_f32`` against their plain versions; times
    ``row_reduce_f32`` at E_FULL and E_REDUCE_LONG with its byte bound and
    idle share."""
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

    for case, e, program, length in cases:
        plan = plan_cuda_launch(program, get_index_lengths(e, length))
        operands = plan.operands(apply_layouts(program, generate_input_arrays(
            e, long_dim_length=length, seed=1, device=dev)))
        got = plan.run(operands)
        want = plan.plain(operands)
        terms = plan.plain(magnitudes(operands))
        torch.cuda.synchronize()
        for g, w, t in zip(got, want, terms):
            abs_err, rel = max_err(g, w)
            note_error(plan.kernel, g, w, t)
            ok = rel <= RTOL
            log(f"[compare] {plan.kernel} {case} E={length}:"
                f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                f" max|plain| (tolerance {RTOL}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"{plan.kernel} disagrees with its plain"
                                   f" version on {case}")
        del operands, got, want, terms

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


def long_reduce_check(dev, label: str, stats: KernelStats) -> None:
    """Phase 12: ``long_reduce_f32`` against ``long_reduce_plain`` and a
    float64 ``torch.einsum`` on the energy, the per-letter sum and the Gram
    matrix at E = 1M and a ragged E = 1,000,003, ndof 35, in the dof-major
    and the element-major layout; the error of each against float64 within
    2e-5 of the sum of the terms' magnitudes.  Times the three at E = 1M
    dof-major (kernel, plain version, ``torch.einsum`` on the stored
    operands) into *stats*, and prints the kernel's device-busy time and
    idle share."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.layouts import dofmajor_layouts, \
        stored_arg_layouts, stored_out_letters
    from feinsum_tpu_torch.tools.profile_suite import report

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
                note_error("long_reduce_f32", got, want, mag)
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


# the reference's (TPU) block length, timed beside the models' default
TPU_BLOCK_LONG = 4096


def models_full_width(dev, label: str) -> dict:
    """Phase 14: the wave model at E = 500,000 (ndof 35, 4 x 15 face dofs)
    and Maxwell at E = 65,536 (ndof 35) with the default schedules
    (``db_path=None``, ``suite.BLOCK_LONG`` elements per block): the
    restriction row's kernel against its plain version, 5 steps each
    against the plain per-step route, and ms per step and Gdof/s, timed in
    turns with the per-step route and with the kernels at the reference's
    4096 elements per block.  Returns the launches of one kernel step of
    each."""
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
                            nfaces=w["nfaces"], block_long=TPU_BLOCK_LONG)
    _step_check(f"wave (block {S.BLOCK_LONG})", step, plain_op.make_step(E),
                state, geom, E, w["ndof"], label,
                also={f"kernel, block {TPU_BLOCK_LONG}": alt.make_step(E)})
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
    alt = ft.MaxwellOperator3D(ndof=m["ndof"], block_long=TPU_BLOCK_LONG)
    _step_check(f"maxwell (block {S.BLOCK_LONG})", step,
                plain_op.make_step(E), state, geom, E, m["ndof"], label,
                also={f"kernel, block {TPU_BLOCK_LONG}": alt.make_step(E)})
    del state, geom
    torch.cuda.empty_cache()
    log(f"[model] launch counts over one step of each model: {launches}")
    if launches["dg_rows_f32"] < 1:
        raise SmokeFailure("the models launched no dg_rows_f32")
    return launches


def _restriction(ndof: int = 35, nfaces: int = 4, nfdof: int = 15):
    """The wave model's face restriction ``fji,ei->fej`` at its sizes."""
    import feinsum_tpu_torch as ft
    return ft.einsum("fji,ei->fej",
                     ft.array("R", (nfaces, nfdof, ndof), "float32"),
                     ft.array("u", ("E", ndof), "float32"))


def split_dg_rows() -> list:
    """Phase 15's DG rows: ``(name, einsum, transform at bf16_3x, timed)``
    for the five suite DG rows (timed), the face restriction and curl
    with ``prereduce``."""
    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.ops.layouts import dofmajor_layouts
    from feinsum_tpu_torch.suite import (default_transform, extended_suite,
                                         space_point, suite)
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    def at_3x(transform):
        return lambda p: transform(p).with_descriptor(precision="bf16_3x")
    rows = [(name, e, at_3x(default_transform(e)), True)
            for name, e in suite() if name != "copy_ndof35"]
    r = _restriction()
    layouts, out_layout = dofmajor_layouts(r)
    rows.append(("face restriction", r, at_3x(
        lambda p: p.with_descriptor(backend="pallas", block_long=512,
                                    arg_layouts=layouts,
                                    out_layout=out_layout)), False))
    curl = dict(extended_suite())["dg_curl_ndof35"]
    rows.append(("dg_curl_ndof35 prereduce", curl,
                 get_transform_func_from_module_path("curl_3d_v0").bind_args(
                     curl, **space_point("curl_3d_v0", curl, prereduce=True,
                                         precision_3x=True)), False))
    return rows


def split_kernel_check(dev, label: str, stats: KernelStats) -> None:
    """Phase 15: the 3x kernels against their plain versions within RTOL_3X
    of the terms' magnitudes and against the numpy oracle on the card;
    the timed rows' 3x kernel beside the f32 kernel, the plain version,
    ``torch.einsum`` in f32 and the bound, into *stats*."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch, tc_step
    from feinsum_tpu_torch.suite import tccg_suite
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    def check(kernel, name, got, want, terms, K):
        for g, w, t in zip(got, want, terms):
            over = note_error(kernel, g, w, t)
            ok = over <= split_tolerance(K)
            log(f"[compare] {kernel} {name}, K = {K}: max|kernel-plain| ="
                f" {over:.2e} of the terms' magnitudes (tolerance"
                f" {split_tolerance(K):.2e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"{kernel} disagrees with its plain"
                                   f" version on {name}")

    def timed(kernel, name, e, length, fns, arrays, padded):
        """fns: the 3x kernel's, the f32 kernel's, the plain version's and
        the library call's callables, timed in turns."""
        times = timed_in_turns(fns, {k: arrays for k in fns})
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        log(f"[time] {kernel} {name}: 3x kernel {ms['3x']:.4f} ms, f32"
            f" kernel {ms['f32']:.4f} ms, plain version {ms['plain']:.4f}"
            f" ms, torch.einsum (f32) {ms['library']:.4f} ms,"
            f" {bound_text(e, length, None, 'bf16_3x', padded)}"
            f" (runs {times}) {label}")
        stats.add(kernel, e, length, ms["3x"], ms["plain"], ms["library"],
                  None, "bf16_3x", padded)

    for name, e, transform, is_timed in split_dg_rows():
        ft.validate_batched_einsum_transform(
            e, transform, long_dim_length=E_VALIDATE, device=dev)
        program = transform(ft.generate_program(e))
        lengths = get_index_lengths(e, E_FULL)
        plan = plan_cuda_launch(program, lengths)
        if plan.kernel != "dg_rows_3xtf32":
            raise SmokeFailure(f"{name} at bf16_3x plans onto {plan.kernel}")
        arrays = apply_layouts(program, generate_input_arrays(
            e, long_dim_length=E_FULL, seed=1, device=dev))
        operands = plan.operands(arrays)
        got = plan.run(operands)
        want = plan.plain(operands)
        terms = plan.plain(magnitudes(operands))
        torch.cuda.synchronize()
        check("dg_rows_3xtf32", f"{name} E={E_FULL} (oracle at"
              f" E={E_VALIDATE}: ok)", got, want, terms,
              operands[0].R.shape[2])
        del got, want, terms, operands
        if is_timed:
            f32 = program.with_descriptor(precision="default")
            timed("dg_rows_3xtf32", f"{name} E={E_FULL}", e, E_FULL, {
                "3x": ft.build_executable(program, long_dim_length=E_FULL,
                                          device=dev),
                "f32": ft.build_executable(f32, long_dim_length=E_FULL,
                                           device=dev),
                "plain": lambda a, plan=plan: plan.plain(plan.operands(a)),
                "library": library_call(program)}, arrays,
                split_flops(plan.operands(arrays)))
        del arrays
        torch.cuda.empty_cache()

    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    for name, e in tccg_suite():
        if len(e.out_idx_set) < 3:
            continue
        point = {**_tc_seed(name, 0), "precision_idx": 1}
        ft.validate_batched_einsum_transform(e, v1.bind_args(e, **point),
                                             device=dev)
        program = v1.bind_args(e, **point)(ft.generate_program(e))
        step, (pa, pb) = tc_step(program, get_index_lengths(e, 1))
        arrays = apply_layouts(program, generate_input_arrays(
            e, long_dim_length=1, seed=1, device=dev))
        A, B = (arrays[e.args[0][p].name] for p in (pa, pb))
        got = kernels.tc_grid_3xtf32(A, B, step)
        want = kernels.tc_grid_3x_plain(A, B, step)
        terms = kernels.tc_grid_plain(A.abs(), B.abs(), step)
        torch.cuda.synchronize()
        check("tc_grid_3xtf32", f"{name} (oracle at full size: ok)", [got],
              [want], [terms], kernels.tc_classify(step).K)
        del got, want, terms
        plan = plan_tc_launch(program, get_index_lengths(e, 1))
        f32 = v1.bind_args(e, **_tc_seed(name, 0))(ft.generate_program(e))
        timed("tc_grid_3xtf32", name, e, 1, {
            "3x": ft.build_executable(program, device=dev),
            "f32": ft.build_executable(f32, device=dev),
            "plain": lambda a, plan=plan: plan.plain(plan.operands(a)),
            "library": library_call(program)}, arrays,
            split_flops([kernels.tc_classify(step)]))
        del arrays, A, B
        torch.cuda.empty_cache()


SPLIT_TUNE_POINTS = 2     # measured points per row: precision off and on


def _is_split_fact(q) -> bool:
    params = dict(q.transform_params)
    return bool(params.get("precision_3x")) or (
        q.transform_id == "tc_pallas_v1.py" and params["precision_idx"] == 1)


def split_archive_path(dev, label: str, stats: KernelStats) -> dict:
    """Phase 16: the five suite DG rows tuned in their spaces with
    ``precision_3x`` off and on, and the five rank >= 3 TCCG rows in
    ``tc_pallas_v1`` with ``precision_idx`` 0 and 1, into a fresh archive;
    counters reset; each row's champion replayed through the ladder and,
    where it is f32, the row's best bf16_3x fact, each checked against the
    plain per-step route; then the wide ``tc_gemm_v0`` facts
    (:func:`wide_gemm_facts`).  Returns the launches of the replays by
    kernel."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import sql_utils
    from feinsum_tpu_torch.codegen.program import \
        generate_program_with_opt_einsum_schedule
    from feinsum_tpu_torch.data.device_info import get_device_key
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.suite import (F32_SPACES, candidate_transforms,
                                         space_point, suite, tccg_suite)

    db = HERE / "build" / "chip_smoke" / "split_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    key = get_device_key(dev)
    rows = []     # (name, einsum, space, length, seeds)
    for name, e in suite():
        if name == "copy_ndof35":
            continue
        space = F32_SPACES[name]
        rows.append((name, e, space, E_FULL, [
            space_point(space, e), space_point(space, e, precision_3x=True)]))
    for name, e in tccg_suite():
        if len(e.out_idx_set) >= 3:
            rows.append((name, e, "tc_pallas_v1", 1, [
                _tc_seed(name, 0), {**_tc_seed(name, 0), "precision_idx": 1}]))
    for name, e, space, length, seeds in rows:
        t0 = time.perf_counter()
        ft.autotune(e, space, db_path=str(db), device=dev,
                    long_dim_length=length, test_limit=SPLIT_TUNE_POINTS,
                    seed_configs=seeds)
        facts = ft.query(e, dev, db_path=str(db))
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t0:.1f} s")
        for q in facts:
            log(f"[tune]   {q.device_name} {q.transform_id}"
                f" {dict(q.transform_params)}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms,"
                f" {q.total_giga_op_rate:.1f} GOp/s {label}")
        if len(facts) != SPLIT_TUNE_POINTS or any(
                q.device_name != key for q in facts) or sorted(
                _is_split_fact(q) for q in facts) != [False, True]:
            raise SmokeFailure(f"{name}: expected an f32 and a bf16_3x fact"
                               f" under {key}")

    kernels.reset_launch_counts()
    chose = {}
    for name, e, space, length, _ in rows:
        winner = next(candidate_transforms(name, e, db_path=str(db),
                                           device=dev))
        if winner.fact is None or winner.fact.transform_id != space + ".py":
            raise SmokeFailure(f"{name}: the winner is not an archived"
                               f" {space}.py fact")
        chose[name] = _is_split_fact(winner.fact)
        replays = [("champion", winner.transform)]
        if not chose[name]:
            replays.append(("best bf16_3x fact", sql_utils.retrieve(
                e, dev, db_path=str(db), filter_in=_is_split_fact)))
        logical = generate_input_arrays(e, long_dim_length=length,
                                        device=dev)
        per_step = ft.build_executable(
            generate_program_with_opt_einsum_schedule(e),
            long_dim_length=length, device=dev)(logical)
        for what, transform in replays:
            program = transform(ft.generate_program(e))
            outs = ft.build_executable(program, long_dim_length=length,
                                       device=dev)(
                apply_layouts(program, logical))
            torch.cuda.synchronize()
            for got, want in zip(outs, per_step):
                got = ft.unpack_output(program, got, tuple(want.shape))
                _, rel = max_err(got, want)
                log(f"[replay] {name} {what} (precision"
                    f" {program.descriptor.precision}): max|replay-per-step|"
                    f" = {rel:.2e} of max|per-step| (tolerance {RTOL})")
                if rel > RTOL:
                    raise SmokeFailure(f"{name}: the {what} differs from the"
                                       f" per-step route by {rel:.2e}")
            del outs
        del logical, per_step
        torch.cuda.empty_cache()
    log(f"[replay] champions that chose bf16_3x:"
        f" {sorted(k for k, v in chose.items() if v)}; f32:"
        f" {sorted(k for k, v in chose.items() if not v)} {label}")
    launches = {k: kernels.launch_counts[k] for k in SPLIT_KERNELS}
    log(f"[replay] launch counts over the bf16_3x replays:"
        f" {dict(kernels.launch_counts)}")
    launches["probe_apply_3xtf32"] = wide_gemm_facts(dev, label, stats)
    return launches


def wide_gemm_facts(dev, label: str, stats: KernelStats) -> int:
    """The shipped ``tc_gemm_v0`` facts at ``bf16_3x`` whose resident factor
    exceeds ``dg_rows_3xtf32``'s shared memory (a copy of the shipped
    archive, read through its device key), on ``probe_apply_3xtf32`` at
    their sizes.  There are four; these used to be refused.  Each is held
    to its plain version and, through ``validate_batched_einsum_transform``,
    to the numpy oracle (neither counted); then the counters are set to 0
    and the four are replayed through ``build_executable`` (the counted
    run), the counters put back; then each is timed in turns against its
    plain version and one ``torch.einsum`` of its einsum (into *stats*).
    Returns the launches of the counted run."""
    import shutil

    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import sql_utils
    from feinsum_tpu_torch.codegen.program import get_index_lengths, \
        stored_lengths
    from feinsum_tpu_torch.measure import apply_layouts, \
        generate_input_arrays
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch

    shipped = HERE / "build" / "chip_smoke" / "tpu_archive.sqlite"
    shipped.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(HERE / "feinsum_tpu" / "data"
                / "transform_archive_v1_tpu.sqlite", shipped)
    tpu = ft.FakeDevice("TPU_v5_lite")
    facts = []
    for e in sql_utils.get_timed_einsums_in_db(db_path=str(shipped)):
        for q in sql_utils.query(e, tpu, db_path=str(shipped),
                                 err_if_no_results=False):
            params = dict(q.transform_params)
            if q.transform_id != "tc_gemm_v0.py" \
                    or not params["backend_pallas"] or params["fold"] \
                    or params["precision_idx"] != 1:
                continue
            program = q.transform(ft.generate_program(e))
            plan = plan_cuda_launch(program, stored_lengths(
                program, get_index_lengths(program.einsum, 1)))
            if plan.kernel == "probe_apply_3xtf32":
                facts.append((f"tc_gemm_v0 {e.get_subscripts()} {params}",
                              e, q.transform, program, plan))
    if len(facts) != 4:
        raise SmokeFailure(f"{len(facts)} shipped tc_gemm_v0 facts ran on"
                           " probe_apply_3xtf32, expected 4")
    for name, e, transform, program, plan in facts:
        operands = plan.operands(apply_layouts(
            program, generate_input_arrays(e, long_dim_length=1,
                                           device=dev)))
        before = dict(kernels.launch_counts)
        kernel_check(plan, operands, name, launches=before)
        ft.validate_batched_einsum_transform(e, transform, device=dev)
        kernels.launch_counts.update(before)
        log(f"[replay] {name}: on {plan.kernel}, validated against the"
            " numpy oracle")

    # the counted run
    before = dict(kernels.launch_counts)
    kernels.reset_launch_counts()
    inputs = []
    for name, e, _, program, _ in facts:
        logical = device_inputs(e, 1, 0, dev)
        outs = ft.build_executable(program, long_dim_length=1, device=dev)(
            apply_layouts(program, logical))
        torch.cuda.synchronize()
        if not all(bool(o.isfinite().all()) for o in outs):
            raise SmokeFailure(f"{name}: non-finite output")
        inputs.append(logical)
        del outs
    counts = dict(kernels.launch_counts)
    kernels.launch_counts.update(before)
    log(f"[replay] launch counts over the wide tc_gemm_v0 replays: {counts}")
    launches = counts.pop("probe_apply_3xtf32")
    if launches < len(facts) or any(counts.values()):
        raise SmokeFailure(f"the wide tc_gemm_v0 replays ran {launches}"
                           f" probe_apply_3xtf32 launches and {counts}")

    # times, in turns (not counted)
    before = dict(kernels.launch_counts)
    for (name, e, _, program, plan), logical in zip(facts, inputs):
        arrays = apply_layouts(program, logical)
        operands = plan.operands(arrays)
        subs = e.get_subscripts().replace(" ", "")
        times = timed_in_turns({
            "kernel": lambda a, plan=plan, ops=operands: plan.run(ops),
            "plain": lambda a, plan=plan, ops=operands: plan.plain(ops),
            "library": lambda a, e=e, subs=subs: [
                torch.einsum(subs, *[a[x.name] for x in row])
                for row in e.args]},
            {"kernel": arrays, "plain": arrays, "library": logical})
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        padded = split_flops(operands)
        log(f"[time] {plan.kernel} {name}: kernel {ms['kernel']:.4f} ms,"
            f" plain version {ms['plain']:.4f} ms, torch.einsum (f32)"
            f" {ms['library']:.4f} ms,"
            f" {bound_text(e, 1, None, 'bf16_3x', padded)} (runs {times})"
            f" {label}")
        stats.add(plan.kernel, e, 1, ms["kernel"], ms["plain"],
                  ms["library"], None, "bf16_3x", padded)
        del arrays, operands
    kernels.launch_counts.update(before)
    del inputs
    torch.cuda.empty_cache()
    return launches


def maxwell_from_archive(dev, label: str) -> int:
    """Phase 17: Maxwell at its full size from an archive whose curl fact
    (a ``dg_div_v0.py`` point, timed on the card without its storage
    knobs) sets ``precision_3x``, ``fold`` and ``preblock``; the model
    drops the storage knobs and runs the curl on ``dg_rows_3xtf32``.  5
    steps against the per-step route, ms per step beside the f32 default.
    Returns the launches of one step."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import sql_utils
    from feinsum_tpu_torch import suite as S
    from feinsum_tpu_torch.measure import timeit
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    m = S.MODEL_SIZES["maxwell"]
    E = m["n_elements"]
    db = HERE / "build" / "chip_smoke" / "maxwell_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    plain_op = ft.MaxwellOperator3D(ndof=m["ndof"], use_pallas=False)
    curl = plain_op.curl_einsum
    params = {"log2_block": 9, "hoist": True, "parallel_grid": True,
              "dofmajor": True, "fold": True, "preblock": True,
              "precision_3x": True}
    runtime = timeit(curl, transform=get_transform_func_from_module_path(
        "dg_div_v0").bind_args(curl, **{**params, "fold": False,
                                        "preblock": False}),
        long_dim_length=E, device=dev)
    sql_utils.record_facts(curl, transform_id="dg_div_v0.py",
                           transform_params=params, runtime_in_sec=runtime,
                           device=dev, db_path=str(db), long_dim_length=E)
    op = ft.MaxwellOperator3D(ndof=m["ndof"], db_path=str(db), device=dev)
    desc = op.program.descriptor
    log(f"[model] maxwell from the archive: precision {desc.precision},"
        f" block {desc.block_long}, fold_long {desc.fold_long},"
        f" preblock_args {desc.preblock_args} (fact {params},"
        f" {runtime * 1e3:.4f} ms) {label}")
    if desc.precision != "bf16_3x" or desc.fold_long != 1 \
            or desc.preblock_args:
        raise SmokeFailure("the Maxwell model did not carry the fact's"
                           " precision or kept its storage knobs")
    state, geom = ft.make_maxwell_state(E, ndof=m["ndof"], device=dev)
    kernels.reset_launch_counts()
    step = op.make_step(E)
    step(state, geom)
    torch.cuda.synchronize()
    launches = kernels.launch_counts["dg_rows_3xtf32"]
    log(f"[model] launch counts over one step: {dict(kernels.launch_counts)}")
    _step_check("maxwell bf16_3x from the archive", step,
                plain_op.make_step(E), state, geom, E, m["ndof"], label,
                also={"kernel, f32 default": ft.MaxwellOperator3D(
                    ndof=m["ndof"]).make_step(E)})
    del state, geom
    torch.cuda.empty_cache()
    return launches


# phase 18's rows: the rows of the shipped archive's lane-pack facts (div
# and grad at ndof 4, 10 and 20, face-mass at 35/15, matvec at 20, vecmat
# at 35) and mass and curl at ndof 35, each with its space and the packed
# points (lane_pack_g) it tunes and times: the g the reference's guards
# admit (8-aligned lanes, at most 4096) whose resident fits a Hopper block
LP_KERNELS = ("lane_pack_dg_f32", "lane_pack_dg_3xtf32")
LP_TIMED_G = 3          # the packed point whose kernel times enter the line


def lane_pack_rows() -> list:
    """``(name, einsum, space, lane_pack_g values)`` of phase 18."""
    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import suite as S
    vecmat = ft.einsum("ej,j->e", ft.array("A", ("E", 35), "float32"),
                       ft.array("x", (35,), "float32"))
    dg = (3, 4, 5)
    return ([(f"dg_div_ndof{n}", S.make_div(n), "dg_div_v0", dg)
             for n in (4, 10, 20)]
            + [(f"dg_grad_ndof{n}", S.make_grad(n), "dg_grad_v0", dg)
               for n in (4, 10, 20)]
            + [("dg_face_mass", S.make_face_mass(), "face_mass_v0", dg),
               ("dg_mass_ndof35", S.make_mass(35), "mass_v0", dg),
               ("dg_curl_ndof35", S.make_curl(35), "curl_3d_v0", dg),
               ("matvec_ndof20", S.make_matvec(20), "mass_v0", (1, 2, 3)),
               ("vecmat_ndof35", vecmat, "mass_v0", (3,))])


def _packed_flops(program, length: int) -> float:
    """The packed program's own flops (its schedule's, dense kron dots
    included) at *length* elements."""
    from feinsum_tpu_torch.measure import evaluate_giga_op_map, \
        get_giga_op_map
    return 1e9 * sum(evaluate_giga_op_map(get_giga_op_map(
        program.einsum, program.schedule),
        length * program.descriptor.rowcat // program.descriptor.lane_pack
    ).values())


def lane_pack_path(dev, label: str, stats: KernelStats) -> dict:
    """Phase 18, the lane-pack path: (1) ``lane_pack_dg_f32`` and its 3x
    variant against their plain versions on the packed DG rows at E = 1M;
    (2) counters reset, every shipped TPU lane-pack fact (a copy of the
    shipped archive, read through its device key) bound and replayed as an
    H100 program at E = 1M, the two champions among them, each against the
    plain per-step route, or refused naming ``fold``, ``mfold`` or shared
    memory; (3) the rows tuned with ``lane_pack_g`` searched into a fresh
    archive, which rows chose a packed point; (4) each packed point timed
    in turns against the row's unpacked champion and one ``torch.einsum``
    of the logical einsum.  Adds the kernels' times at g = 8, and each
    wide fact's on ``probe_apply_f32`` (timed against its plain version and
    ``torch.einsum``), to *stats*; returns the launches of step (2) and of
    the champions' replays."""
    import shutil

    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import sql_utils
    from feinsum_tpu_torch.codegen.program import (
        generate_program_with_opt_einsum_schedule, get_index_lengths,
        stored_lengths)
    from feinsum_tpu_torch.measure import apply_layouts, \
        evaluate_giga_op_map, generate_input_arrays, get_giga_op_map
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import plan_cuda_launch
    from feinsum_tpu_torch.ops.lane_pack import expand_residents
    from feinsum_tpu_torch.suite import candidate_transforms, space_point
    from feinsum_tpu_torch.tuning import get_transform_func_from_module_path

    def program_of(space, e, **knobs):
        return get_transform_func_from_module_path(space).bind_args(
            e, **space_point(space, e, **knobs))(ft.generate_program(e))

    def planned(program, arrays):
        """(plan, kernel operands) of *program* on stored *arrays*."""
        plan = plan_cuda_launch(program, stored_lengths(
            program, get_index_lengths(program.einsum, E_FULL)))
        return plan, plan.operands(expand_residents(program, arrays))

    def per_step_check(name, e, program, logical, outs) -> float:
        """*outs* of *program* against the plain per-step route of *e*;
        the largest error over max|per-step|."""
        wants = ft.build_executable(
            generate_program_with_opt_einsum_schedule(e),
            long_dim_length=E_FULL, device=dev)(logical)
        if program.descriptor.rowcat > 1:
            outs = list(ft.unpack_output(program, outs[0],
                                         tuple(wants[0].shape)))
        else:
            outs = [ft.unpack_output(program, o, tuple(w.shape))
                    for o, w in zip(outs, wants)]
        worst = 0.0
        for got, want in zip(outs, wants):
            worst = max(worst, max_err(got, want)[1])
        if worst > RTOL:
            raise SmokeFailure(f"{name}: the packed replay differs from the"
                               f" per-step route by {worst:.2e}")
        return worst

    def wide_check(plan, operands, name, e, logical) -> None:
        """A wide-resident row on ``probe_apply``: the kernel against its
        plain version, then timed in turns against its plain version and
        one ``torch.einsum`` of the logical einsum (into *stats*); none of
        these launches is counted."""
        before = dict(kernels.launch_counts)
        kernel_check(plan, operands, name, launches=before)
        subs = e.get_subscripts().replace(" ", "")
        times = timed_in_turns({
            "kernel": lambda a: plan.run(operands),
            "plain": lambda a: plan.plain(operands),
            "library": lambda a: [torch.einsum(subs, *[a[x.name]
                                                       for x in row])
                                  for row in e.args]},
            {k: logical for k in ("kernel", "plain", "library")})
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        log(f"[time] {plan.kernel} {name} E={E_FULL}: kernel"
            f" {ms['kernel']:.4f} ms, plain version {ms['plain']:.4f} ms,"
            f" torch.einsum {ms['library']:.4f} ms,"
            f" {bound_text(e, E_FULL)} (runs {times}) {label}")
        stats.add(plan.kernel, e, E_FULL, ms["kernel"], ms["plain"],
                  ms["library"])
        kernels.launch_counts.update(before)

    rows = lane_pack_rows()

    # (1) the kernels against their plain versions
    for name, e, space, lgs in rows:
        for split in (False, True):
            program = program_of(space, e, lane_pack_g=LP_TIMED_G,
                                 precision_3x=split)
            arrays = apply_layouts(program, generate_input_arrays(
                e, long_dim_length=E_FULL, seed=1, device=dev))
            plan, operands = planned(program, arrays)
            if plan.kernel not in LP_KERNELS:
                break
            if plan.kernel != LP_KERNELS[split]:
                raise SmokeFailure(f"{name} plans onto {plan.kernel}")
            got = plan.run(operands)
            want = plan.plain(operands)
            terms = plan.plain(magnitudes(operands))
            torch.cuda.synchronize()
            K = max(operands[0].u.shape[2], operands[0].J.shape[2])
            for g_, w, t in zip(got, want, terms):
                _, rel = max_err(g_, w)
                over = note_error(plan.kernel, g_, w, t)
                tol = split_tolerance(K)
                ok = over <= tol if split else rel <= RTOL
                log(f"[compare] {plan.kernel} {name} g ="
                    f" {2 ** LP_TIMED_G} E={E_FULL}: max|kernel-plain| ="
                    f" {rel:.2e} of max|plain|, {over:.2e} of the terms'"
                    f" magnitudes (tolerance"
                    f" {tol if split else RTOL:.2e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"{plan.kernel} disagrees with its"
                                       f" plain version on {name}")
            del got, want, terms, operands, arrays
        torch.cuda.empty_cache()

    # (2) the shipped TPU lane-pack facts replayed as H100 programs
    shipped = HERE / "build" / "chip_smoke" / "tpu_archive.sqlite"
    shipped.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(HERE / "feinsum_tpu" / "data"
                / "transform_archive_v1_tpu.sqlite", shipped)
    tpu = ft.FakeDevice("TPU_v5_lite")
    kernels.reset_launch_counts()
    outcomes = {"built": 0, "fold": 0, "mfold": 0, "shared memory": 0}
    wide: dict = {}
    t0 = time.perf_counter()
    for e in sql_utils.get_timed_einsums_in_db(db_path=str(shipped)):
        facts = sql_utils.query(e, tpu, db_path=str(shipped),
                                err_if_no_results=False)
        packed = [q for q in facts
                  if dict(q.transform_params).get("lane_pack_g")]
        if not packed:
            continue
        champion = sql_utils.aggregate_reconfirmations(facts)[0]
        logical = generate_input_arrays(e, long_dim_length=E_FULL,
                                        device=dev)
        for q in packed:
            params = dict(q.transform_params)
            try:
                program = q.transform(ft.generate_program(e))
                fn = ft.build_executable(program, long_dim_length=E_FULL,
                                         device=dev)
            except ft.InvalidParameterError as err:
                why = next(w for w in ("mfold", "fold", "shared memory")
                           if w in str(err))
                outcomes[why] += 1
                continue
            outcomes["built"] += 1
            before = dict(kernels.launch_counts)
            arrays = apply_layouts(program, logical)
            outs = fn(arrays)
            torch.cuda.synchronize()
            ran = [k for k, n in kernels.launch_counts.items()
                   if n != before[k]]
            rel = per_step_check(e.get_subscripts(), e, program, logical,
                                 outs)
            plan, operands = planned(program, arrays)
            if plan.kernel.startswith("probe_apply"):
                # a kron resident over dg_rows' shared memory (these facts
                # were refused before the probe kernels took them)
                wide[plan.kernel] = wide.get(plan.kernel, 0) + 1
                wide_check(plan, operands, e.get_subscripts(), e, logical)
            del arrays, operands
            is_champion = (q.transform_id, q.transform_params) == (
                champion.transform_id, champion.transform_params)
            log(f"[lane-pack] TPU fact {q.transform_id} {e.get_subscripts()}"
                f" g = {2 ** params['lane_pack_g']}"
                f"{' (the champion)' if is_champion else ''}"
                f"{' bf16_3x' if params.get('precision_3x') else ''}: ran"
                f" {ran} at E={E_FULL}, max|replay-per-step| = {rel:.2e}"
                f" of max|per-step|")
            del outs
        del logical
        torch.cuda.empty_cache()
    launches = {k: kernels.launch_counts[k] for k in LP_KERNELS
                + ("probe_apply_f32",)}
    log(f"[lane-pack] the 104 shipped lane-pack facts: {outcomes}, on"
        f" probe_apply {wide}; launch counts over the replays:"
        f" {dict(kernels.launch_counts)} ({time.perf_counter() - t0:.1f} s)")
    if outcomes != {"built": 95, "fold": 7, "mfold": 2, "shared memory": 0} \
            or sum(wide.values()) != 25:
        raise SmokeFailure(f"the shipped lane-pack facts bound as {outcomes},"
                           f" {wide} on probe_apply")
    for k, n in launches.items():
        if n < 1:
            raise SmokeFailure(f"{k} was not launched by the replays")

    # (3) tune with lane_pack_g searched into a fresh archive
    db = HERE / "build" / "chip_smoke" / "lane_pack_archive.sqlite"
    db.unlink(missing_ok=True)
    chose = {}
    for name, e, space, lgs in rows:
        seeds = [space_point(space, e)] + [
            space_point(space, e, lane_pack_g=lg) for lg in lgs]
        t0 = time.perf_counter()
        ft.autotune(e, space, db_path=str(db), device=dev,
                    long_dim_length=E_FULL, test_limit=len(seeds),
                    seed_configs=seeds)
        facts = sql_utils.aggregate_reconfirmations(
            ft.query(e, dev, db_path=str(db)))
        winner = next(candidate_transforms(name, e, db_path=str(db),
                                           device=dev))
        chose[name] = dict(winner.fact.transform_params)["lane_pack_g"]
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t0:.1f} s, champion lane_pack_g ="
            f" {chose[name]}; " + "; ".join(
                f"g = {2 ** dict(q.transform_params)['lane_pack_g']}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms" for q in facts)
            + f" {label}")
        if len(facts) != len(seeds):
            raise SmokeFailure(f"{name}: expected {len(seeds)} facts")
    log(f"[tune] rows whose champion is a packed point:"
        f" {sorted(k for k, v in chose.items() if v)}; unpacked:"
        f" {sorted(k for k, v in chose.items() if not v)} {label}")

    # (4) each packed point in turns against the unpacked champion and the
    # library call, at the same width; the kernels' times at g = 8
    for name, e, space, lgs in rows:
        unpacked = sql_utils.retrieve(
            e, dev, db_path=str(db),
            filter_in=lambda q: not dict(q.transform_params)["lane_pack_g"])
        base = unpacked(ft.generate_program(e))
        logical = generate_input_arrays(e, long_dim_length=E_FULL,
                                        device=dev)
        subs = e.get_subscripts().replace(" ", "")
        t_bytes, t_ops = row_bound(e, E_FULL)
        flops = 1e9 * sum(evaluate_giga_op_map(get_giga_op_map(e),
                                               E_FULL).values())
        for lg in lgs:
            program = program_of(space, e, lane_pack_g=lg)
            arrays = apply_layouts(program, logical)
            routes = {"packed": ft.build_executable(
                          program, long_dim_length=E_FULL, device=dev),
                      "unpacked": ft.build_executable(
                          base, long_dim_length=E_FULL, device=dev),
                      "library": lambda a, e=e: [
                          torch.einsum(subs, *[a[x.name] for x in row])
                          for row in e.args]}
            args = {"packed": arrays, "unpacked": apply_layouts(base, logical),
                    "library": logical}
            kernel = None
            if lg == LP_TIMED_G and e.n == 3:
                plan, operands = planned(program, arrays)
                split = program_of(space, e, lane_pack_g=lg,
                                   precision_3x=True)
                plan3, _ = planned(split, arrays)
                kernel = plan.kernel
                expanded = expand_residents(program, arrays)
                routes.update({
                    "kernel": lambda a, plan=plan: plan.run(plan.operands(a)),
                    "plain": lambda a, plan=plan: plan.plain(
                        plan.operands(a)),
                    "3x kernel": lambda a, plan=plan3: plan.run(
                        plan.operands(a)),
                    "3x plain": lambda a, plan=plan3: plan.plain(
                        plan.operands(a))})
                args.update({k: expanded for k in ("kernel", "plain",
                                                   "3x kernel", "3x plain")})
                del operands
            times = timed_in_turns(routes, args)
            ms = {k: sum(v) / len(v) for k, v in times.items()}
            log(f"[lane-pack] {name} g = {2 ** lg}: packed point"
                f" {ms['packed']:.4f} ms, unpacked champion"
                f" {ms['unpacked']:.4f} ms, torch.einsum"
                f" {ms['library']:.4f} ms; bound"
                f" {max(t_bytes, t_ops):.4f} ms"
                f" ({'bytes' if t_bytes >= t_ops else 'operations'}) of the"
                f" logical einsum, packed program"
                f" {_packed_flops(program, E_FULL) / 1e9:.1f} GFLOP (dense)"
                f" against the logical {flops / 1e9:.1f} GFLOP (runs"
                f" {times}) {label}")
            if kernel is not None:
                log(f"[lane-pack] {name} g = {2 ** lg}: {kernel}"
                    f" {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms;"
                    f" lane_pack_dg_3xtf32 {ms['3x kernel']:.4f} ms, plain"
                    f" {ms['3x plain']:.4f} ms {label}")
                stats.add("lane_pack_dg_f32", e, E_FULL, ms["kernel"],
                          ms["plain"], ms["library"])
                stats.add("lane_pack_dg_3xtf32", e, E_FULL,
                          ms["3x kernel"], ms["3x plain"], ms["library"],
                          None, "bf16_3x", flops)
            del arrays, args, routes
            torch.cuda.empty_cache()
        del logical
    return launches


# the demo space's points phase 19 measures: log2_block 9 and 11
DEMO_SEEDS = [{"log2_block": 9}, {"log2_block": 11}]


def device_inputs(e, length: int, seed: int, dev) -> dict:
    """Uniform [0, 1) float32 inputs of every operand of *e* in its logical
    shape, made on the card (the numpy oracle checks use the package's own
    seeded inputs)."""
    import torch

    from feinsum_tpu_torch.codegen.program import get_index_lengths
    gen = torch.Generator(device=dev).manual_seed(seed)
    lengths = get_index_lengths(e, length)
    idx = {a.name: s for row in e.args for a, s in zip(row, e.in_idx_sets)}
    return {name: torch.rand(tuple(lengths[ix] for ix in idx[name]),
                             generator=gen, device=dev)
            for name in e.arg_to_shape}


def grid_letter_cases(champion, demo) -> dict:
    """Phase 19's grid-letter cases, ``name -> (einsum, program, length)``,
    each gridded as the reference's K1 grids it: the demo's archived
    champion applied to the demo's own spelling, whose bound grid_index is
    i there (e, another long letter, is then staged whole: 32 elements); a
    einsum with two long letters (an output one is the grid letter; F at
    its bound length, 512); the demo fully concrete at E = 4096 (the grid
    letter is its longest output letter, at least 2048 long) and at E = 32
    (no grid: one block of one element)."""
    import feinsum_tpu_torch as ft

    def a(name, shape):
        return ft.array(name, shape, "float32")

    def concrete(length):
        return ft.einsum("ij,ejk->eik", a("A", (35, 35)),
                         a("B", (length, 35, 35)))
    two = ft.einsum("ij,ejf->eif", a("A", (35, 35)), a("B", ("E", 35, "F")))
    cases = {"demo_other_spelling": (demo, champion(ft.generate_program(
        demo)), 32)}
    for name, e, length in (("two_long_letters", two, 512),
                            ("concrete_4096", concrete(4096), 1),
                            ("concrete_32", concrete(32), 1)):
        cases[name] = (e, ft.generate_program(e).with_descriptor(
            backend="pallas", block_long=512), length)
    return cases


def step_block_path(dev, label: str, stats: KernelStats) -> int:
    """Phase 19, K1's general steps: (1) the demo tuned in
    ``demo_transform_space`` at E = 1M into a fresh archive, its champion
    through ``candidate_transforms`` and ``retrieve``; (2) the demo's
    archived program and phase 19's rows (``tools/step_block_mappings.py``,
    built with ``fused_pallas_program``, dof-major) validated against the
    numpy oracle at E = 2000 and held against ``step_block_plain`` at E = 1M (and 1,000,003
    on the demo and ``ej,j->``) within 2e-5 of the sum of the terms'
    magnitudes; (3) counters reset, each program replayed or built and run
    at E = 1M, and the counters read; (4) each timed in turns against its
    plain version and one ``torch.einsum`` of the logical einsum (into
    *stats*).  An archived fact binds to the canonical einsum, whose long
    letter its ``long_axis`` names, so the demo replays on that einsum's
    program.  Returns the launches of step (3)."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import sql_utils
    from feinsum_tpu_torch.canonicalization import canonicalize_einsum
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.cuda_emitter import grid_letter, \
        plan_cuda_launch
    from feinsum_tpu_torch.ops.layouts import stored_out_letters
    from feinsum_tpu_torch.suite import candidate_transforms
    from feinsum_tpu_torch.tools.step_block_mappings import demo_einsum, \
        programs as layouts_of, step_block_rows

    demo = demo_einsum()
    canon = canonicalize_einsum(demo)

    # (1) the demo space tuned into a fresh archive
    db = HERE / "build" / "chip_smoke" / "demo_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    t0 = time.perf_counter()
    ft.autotune(demo, "demo_transform_space", db_path=str(db), device=dev,
                long_dim_length=E_FULL, test_limit=len(DEMO_SEEDS),
                seed_configs=DEMO_SEEDS)
    facts = sql_utils.aggregate_reconfirmations(
        ft.query(demo, dev, db_path=str(db)))
    log(f"[tune] demo ij,ejk->eik ndof 35: {len(facts)} facts in"
        f" {time.perf_counter() - t0:.1f} s; " + "; ".join(
            f"{dict(q.transform_params)}: {q.runtime_in_sec * 1e3:.4f} ms"
            for q in facts) + f" {label}")
    winner = next(candidate_transforms("demo", demo, db_path=str(db),
                                       device=dev))
    if len(facts) != len(DEMO_SEEDS) or winner.fact is None \
            or winner.fact.transform_id != "demo_transform_space.py":
        raise SmokeFailure(f"the demo archive holds {facts}")
    champion = ft.retrieve(demo, dev, db_path=str(db))
    programs = {"demo_ndof35": (canon, champion(ft.generate_program(canon)))}
    log(f"[tune] demo champion {winner.label} -> block_long"
        f" {programs['demo_ndof35'][1].descriptor.block_long}, replayed on"
        f" the canonical einsum {canon.get_subscripts()}")
    for name, e, hoist in step_block_rows():
        programs[name] = (e, layouts_of(e, hoist)["dof-major"])

    # (2) the oracle at E = 2000, then kernel against plain at full size
    for name, (e, program) in programs.items():
        ft.validate_batched_einsum_transform(
            e, lambda p, program=program: program,
            long_dim_length=E_VALIDATE, device=dev)
        ragged = name in ("demo_ndof35", "resident_reduce_ndof35")
        for length in (E_FULL, E_RAGGED) if ragged else (E_FULL,):
            plan = plan_cuda_launch(program, get_index_lengths(e, length))
            if plan.kernel != "step_block_f32":
                raise SmokeFailure(f"{name} plans onto {plan.kernel}")
            operands = plan.operands(apply_layouts(
                program, device_inputs(e, length, 1, dev)))
            got = plan.run(operands)
            want = plan.plain(operands)
            terms = plan.plain(magnitudes(operands))
            torch.cuda.synchronize()
            for g, w, t in zip(got, want, terms):
                abs_err, rel = max_err(g, w)
                over = note_error("step_block_f32", g, w, t)
                ok = over <= RTOL
                log(f"[compare] step_block_f32 {name} E={length}"
                    f" ({program.schedule.nsteps} steps): max|kernel-plain|"
                    f" {abs_err:.3e} = {rel:.2e} of max|plain|, {over:.2e}"
                    f" of the terms' magnitudes (tolerance {RTOL})"
                    f" {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SmokeFailure(f"step_block_f32 disagrees with its"
                                       f" plain version on {name}")
            del operands, got, want, terms
            torch.cuda.empty_cache()
        log(f"[oracle] {name}: validated on {dev} at E={E_VALIDATE}")

    # (2b) the grid-letter cases: the oracle, then kernel against plain
    grid = grid_letter_cases(champion, demo)
    for name, (e, program, length) in grid.items():
        ft.validate_batched_einsum_transform(
            e, lambda p, program=program: program, long_dim_length=length,
            device=dev)
        plan = plan_cuda_launch(program, get_index_lengths(e, length))
        if plan.kernel != "step_block_f32":
            raise SmokeFailure(f"{name} plans onto {plan.kernel}")
        kernel_check(plan, plan.operands(apply_layouts(
            program, device_inputs(e, length, 1, dev))),
            f"{name} (grid {grid_letter(program, get_index_lengths(e, length))!r},"
            f" length {length})", launches=dict(kernels.launch_counts))
        log(f"[oracle] {name}: validated on {dev} at length {length}")
        torch.cuda.empty_cache()

    # (2c) a dense reduce of more register tiles than a block has threads
    # (the Gram matrix at ndof 165: 21 x 21 tiles of 8 x 8, two rounds)
    e = ft.einsum("ei,ej->ij", ft.array("u", ("E", 165), "float32"),
                  ft.array("v", ("E", 165), "float32"))
    program = layouts_of(e, False)["dof-major"]
    ft.validate_batched_einsum_transform(
        e, lambda p: program, long_dim_length=E_VALIDATE, device=dev)
    plan = plan_cuda_launch(program, get_index_lengths(e, E_FULL))
    if plan.kernel != "step_block_f32":
        raise SmokeFailure(f"gram_ndof165 plans onto {plan.kernel}")
    kernel_check(plan, plan.operands(apply_layouts(
        program, device_inputs(e, E_FULL, 1, dev))),
        f"gram_ndof165 E={E_FULL}", launches=dict(kernels.launch_counts))
    log(f"[oracle] gram_ndof165: validated on {dev} at E={E_VALIDATE}")
    torch.cuda.empty_cache()

    # (3) the main path of this phase, counted
    kernels.reset_launch_counts()
    runs = [(name, e, program, E_FULL)
            for name, (e, program) in programs.items()] + [
        (name, e, program, length)
        for name, (e, program, length) in grid.items()]
    for name, e, program, length in runs:
        fn = ft.build_executable(program, long_dim_length=length, device=dev)
        outs = fn(apply_layouts(program, device_inputs(e, length, 0, dev)))
        torch.cuda.synchronize()
        lengths = get_index_lengths(e, length)
        want = tuple(lengths[ix] for ix in stored_out_letters(program))
        for o in outs:
            if tuple(o.shape) != want or not bool(o.isfinite().all()):
                raise SmokeFailure(f"{name}: output {tuple(o.shape)}, want"
                                   f" {want}, finite")
        del outs
    counts = dict(kernels.launch_counts)
    log(f"[step] launch counts over phase 19's runs: {counts}")
    launches = counts.pop("step_block_f32")
    if launches < len(runs) or any(counts.values()):
        raise SmokeFailure(f"phase 19 ran {launches} step_block_f32 launches"
                           f" and {counts}")

    # (4) times, in turns
    for name, (e, program) in programs.items():
        logical = device_inputs(e, E_FULL, 0, dev)
        arrays = apply_layouts(program, logical)
        plan = plan_cuda_launch(program, get_index_lengths(e, E_FULL))
        subs = e.get_subscripts().replace(" ", "")
        times = timed_in_turns(
            {"kernel": ft.build_executable(program, long_dim_length=E_FULL,
                                           device=dev),
             "plain": lambda a, plan=plan: plan.plain(plan.operands(a)),
             "library": lambda a, e=e, subs=subs: [
                 torch.einsum(subs, *[a[x.name] for x in row])
                 for row in e.args]},
            {"kernel": arrays, "plain": arrays, "library": logical})
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        log(f"[time] step_block_f32 {name} E={E_FULL}"
            f" ({program.schedule.nsteps} steps, block"
            f" {program.descriptor.block_long}): kernel {ms['kernel']:.4f}"
            f" ms, plain version {ms['plain']:.4f} ms, torch.einsum"
            f" {ms['library']:.4f} ms, {bound_text(e, E_FULL, program)}"
            f" (runs {times}) {label}")
        stats.add("step_block_f32", e, E_FULL, ms["kernel"], ms["plain"],
                  ms["library"], program)
        del logical, arrays
        torch.cuda.empty_cache()
    return launches


# phase 20's kernel checks: (subscripts, shapes, grid letters, blocks,
# stored reversed, rows, optimal path)
TS_CHECKS = {
    "ragged_chain": ("abc,cd,de->abe", ((3, 5, 7), (7, 5), (5, 3)), "ab",
                     (("b", 5),), False, 1, True),
    "batch_block_triple": ("eij,ejk,ekl->eil",
                           ((1200, 3, 5), (1200, 5, 7), (1200, 7, 3)), "e",
                           (("e", 4),), False, 1, True),
    "permuted_sumfact": ("ai,bj,ck,eabc->eijk",
                         ((3, 5), (5, 7), (7, 3), (6000, 3, 5, 7)), "ei",
                         (("e", 2),), True, 1, True),
    "b2_two_operators": ("abcd,de,ef->abcf",
                         ((8, 6, 5, 7), (7, 3), (3, 6)), "ab", (("a", 2),),
                         True, 2, True),
    "trivial_four_operands": ("ai,bj,ck,eabc->eijk",
                              ((3, 5), (5, 7), (7, 3), (400, 3, 5, 7)), "e",
                              (), False, 1, False),
}


def ts_check_program(subs, shapes, grid, blocks, permuted, rows, opt):
    """``(einsum, program)`` of a TS_CHECKS row on ``tc_steps_f32``."""
    import feinsum_tpu_torch as ft
    names = [[f"{chr(ord('A') + p)}{r}" for p in range(len(shapes))]
             for r in range(rows)]
    e = ft.batched_einsum(subs, [[ft.array(n, sh, "float32")
                                  for n, sh in zip(row, shapes)]
                                 for row in names])
    prog = (ft.generate_program_with_opt_einsum_schedule(e) if opt
            else ft.generate_program(e)).with_descriptor(
        backend="pallas", grid_index=tuple(grid), grid_blocks=tuple(blocks))
    if permuted:
        prog = prog.with_descriptor(
            arg_layouts=tuple((a.name, tuple(reversed(range(len(idx)))))
                              for row in e.args
                              for a, idx in zip(row, e.in_idx_sets)),
            out_layout=tuple(reversed(range(len(e.out_idx_set)))))
    return e, prog


def tc_steps_path(dev, label: str, stats: KernelStats) -> int:
    """Phase 20, K2's multi-step dense schedules: (a) ``tc_steps_f32``
    against ``tc_steps_plain`` on TS_CHECKS; (b) the rows of
    ``tc_steps_suite()`` tuned in ``tc_pallas_v0`` and ``tc_pallas_v1``
    into a fresh archive, each champion through ``candidate_transforms``
    and validated against the numpy oracle (E = 2000 for the rows with an
    element axis); (c) counters reset, each champion replayed at full size,
    the counters read, each output held to ``tc_steps_plain``; (d) each
    timed in turns against its plain version, one ``torch.einsum`` of the
    whole einsum and, for sum factorization, phase 19's ``step_block_f32``
    route (into *stats*).  Returns the launches of step (c)."""
    import torch

    import feinsum_tpu_torch as ft
    from feinsum_tpu_torch import sql_utils
    from feinsum_tpu_torch.codegen.program import get_index_lengths
    from feinsum_tpu_torch.measure import apply_layouts
    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.ops.layouts import stored_out_letters
    from feinsum_tpu_torch.ops.tc_emitter import plan_tc_launch
    from feinsum_tpu_torch.ops.tc_steps import plan_tc_steps
    from feinsum_tpu_torch.suite import TC_STEPS_SEEDS, \
        candidate_transforms, make_sum_factorization, make_triple_product, \
        tc_steps_suite
    from feinsum_tpu_torch.tools.step_block_mappings import \
        programs as layouts_of, step_block_rows

    def compare(name, plan, operands):
        got = plan.run(operands)
        want = plan.plain(operands)
        terms = plan.plain(magnitudes(operands))
        torch.cuda.synchronize()
        for g, w, t in zip(got, want, terms):
            abs_err, rel = max_err(g, w)
            over = note_error("tc_steps_f32", g, w, t)
            ok = rel <= RTOL
            log(f"[compare] tc_steps_f32 {name}:"
                f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                f" max|plain| (tolerance {RTOL}), {over:.2e} of the terms'"
                f" magnitudes {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"tc_steps_f32 disagrees with its plain"
                                   f" version on {name}")

    # (a) the kernel against its plain version
    for name, spec in TS_CHECKS.items():
        e, prog = ts_check_program(*spec)
        plan = plan_tc_launch(prog, get_index_lengths(e, 1))
        if plan.kernel != "tc_steps_f32":
            raise SmokeFailure(f"{name} plans onto {plan.kernel}")
        operands = plan.operands(apply_layouts(prog, device_inputs(
            e, 1, 3, dev)))
        compare(f"{name} ({prog.schedule.nsteps} steps, b={e.b})", plan,
                operands)

    # (b) tuned into a fresh archive, champions validated
    db = HERE / "build" / "chip_smoke" / "tc_steps_archive.sqlite"
    db.parent.mkdir(parents=True, exist_ok=True)
    db.unlink(missing_ok=True)
    small = {"sumfact_q4": make_sum_factorization(E=E_VALIDATE),
             "triple_product_ndof35": make_triple_product(E=E_VALIDATE)}
    programs = {}
    for name, e in tc_steps_suite():
        t_tune = time.perf_counter()
        for space, seeds in TC_STEPS_SEEDS[name].items():
            ft.autotune(e, space, db_path=str(db), device=dev,
                        test_limit=len(seeds), seed_configs=seeds)
        facts = sql_utils.aggregate_reconfirmations(
            ft.query(e, dev, db_path=str(db)))
        log(f"[tune] {name}: {len(facts)} facts in"
            f" {time.perf_counter() - t_tune:.1f} s; " + "; ".join(
                f"{q.transform_id} {dict(q.transform_params)}:"
                f" {q.runtime_in_sec * 1e3:.4f} ms" for q in facts)
            + f" {label}")
        if len(facts) != sum(map(len, TC_STEPS_SEEDS[name].values())):
            raise SmokeFailure(f"{name}: the archive holds {len(facts)}"
                               " facts")
        winner = next(candidate_transforms(name, e, db_path=str(db),
                                           device=dev))
        log(f"[replay] {winner.label}")
        if winner.fact is None or winner.fact.transform_id not in (
                "tc_pallas_v0.py", "tc_pallas_v1.py"):
            raise SmokeFailure(f"{name}: the winner is not an archived TC"
                               " fact")
        check = small.get(name, e)
        ft.validate_batched_einsum_transform(check, winner.transform,
                                             device=dev)
        log(f"[oracle] {name}: the champion validated on {dev} against the"
            f" numpy oracle at {tuple(int(d) for d in check.shape)}")
        program = winner.transform(ft.generate_program(e))
        table = plan_tc_steps(program, get_index_lengths(e, 1))
        log(f"[replay] {name}: {program.schedule.subscripts}, grid"
            f" {program.descriptor.grid_index} blocks"
            f" {program.descriptor.grid_blocks}: {table.ncells} cells,"
            f" {table.threads} threads, {table.smem_bytes} B of shared"
            f" memory, {table.terms()} terms")
        programs[name] = (e, program)

    # (c) the replays, counted, held to the plain version
    kernels.reset_launch_counts()
    outputs = {}
    for name, (e, program) in programs.items():
        fn = ft.build_executable(program, device=dev)
        arrays = apply_layouts(program, device_inputs(e, 1, 0, dev))
        outputs[name] = fn(arrays)
        torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    log(f"[steps] launch counts over phase 20's replays: {counts}")
    launches = counts.pop("tc_steps_f32")
    if launches < len(programs) or any(counts.values()):
        raise SmokeFailure(f"phase 20 ran {launches} tc_steps_f32 launches"
                           f" and {counts}")
    for name, (e, program) in programs.items():
        arrays = apply_layouts(program, device_inputs(e, 1, 0, dev))
        plan = plan_tc_launch(program, get_index_lengths(e, 1))
        operands = plan.operands(arrays)
        want = tuple(get_index_lengths(e, 1)[ix]
                     for ix in stored_out_letters(program))
        for got, plain, terms in zip(outputs.pop(name), plan.plain(operands),
                                     plan.plain(magnitudes(operands))):
            if tuple(got.shape) != want:
                raise SmokeFailure(f"{name}: output {tuple(got.shape)}, want"
                                   f" {want}")
            abs_err, rel = max_err(got, plain)
            over = note_error("tc_steps_f32", got, plain, terms)
            log(f"[compare] tc_steps_f32 {name} replayed at full size:"
                f" max|kernel-plain| {abs_err:.3e} = {rel:.2e} of"
                f" max|plain|, {over:.2e} of the terms' magnitudes"
                f" (tolerance {RTOL}) {'ok' if rel <= RTOL else 'FAIL'}")
            if rel > RTOL:
                raise SmokeFailure(f"{name}: the replay differs from"
                                   f" tc_steps_plain by {rel:.2e}")
        del arrays, operands
        torch.cuda.empty_cache()

    # (d) times, in turns
    for name, (e, program) in programs.items():
        logical = device_inputs(e, 1, 0, dev)
        arrays = apply_layouts(program, logical)
        plan = plan_tc_launch(program, get_index_lengths(e, 1))
        subs = e.get_subscripts().replace(" ", "")
        routes = {
            "kernel": ft.build_executable(program, device=dev),
            "plain": lambda a, plan=plan: plan.plain(plan.operands(a)),
            "library": lambda a, e=e, subs=subs: [
                torch.einsum(subs, *[a[x.name] for x in row])
                for row in e.args]}
        arrays_of = {"kernel": arrays, "plain": arrays, "library": logical}
        if name == "sumfact_q4":
            (long_e, hoist), = [(le, h) for n, le, h in step_block_rows()
                                if n == "sumfact_q4"]
            long_prog = layouts_of(long_e, hoist)["dof-major"]
            routes["step_block_f32"] = ft.build_executable(
                long_prog, long_dim_length=E_FULL, device=dev)
            arrays_of["step_block_f32"] = apply_layouts(
                long_prog, device_inputs(long_e, E_FULL, 0, dev))
        times = timed_in_turns(routes, arrays_of)
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        extra = (f", step_block_f32 (E a long axis) {ms['step_block_f32']:.4f}"
                 " ms" if "step_block_f32" in ms else "")
        log(f"[time] tc_steps_f32 {name} ({program.schedule.nsteps} steps):"
            f" kernel {ms['kernel']:.4f} ms, plain version"
            f" {ms['plain']:.4f} ms, torch.einsum {ms['library']:.4f} ms"
            f"{extra}, {bound_text(e, 1, program)} (runs {times}) {label}")
        stats.add("tc_steps_f32", e, 1, ms["kernel"], ms["plain"],
                  ms["library"], program)
        del logical, arrays, arrays_of, routes
        torch.cuda.empty_cache()
    return launches


PROBE_KERNELS = ("probe_stream_f32", "probe_apply_f32",
                 "probe_apply_3xtf32")
E_PROBE = 1 << 20


def probe_kernel_checks(dev) -> None:
    """Phase 21 (a): each probe kernel against its plain version at E = 777
    (776 under the folded mapping I) and E = 2**20 on every storage, into
    ERRORS."""
    import numpy as np
    import torch

    from feinsum_tpu_torch.ops import probe_kernels as pk
    from feinsum_tpu_torch.probes import draw, fold, kron_eye, \
        split_tolerance

    def check(kernel, label, got, want, terms, rtol):
        torch.cuda.synchronize()
        for g, w, t in zip(got, want, terms):
            abs_err, rel = max_err(g, w)
            over = note_error(kernel, g, w, t)
            ok = (over if kernel.endswith("3xtf32") else rel) <= rtol
            log(f"[compare] {kernel} {label}: max|kernel-plain| {abs_err:.3e}"
                f" = {rel:.2e} of max|plain|, {over:.2e} of the terms'"
                f" magnitudes (tolerance {rtol:.2e}) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SmokeFailure(f"{kernel} disagrees with its plain"
                                   f" version on {label}")

    rng = np.random.default_rng(21)
    for E in (E_SMALL, E_PROBE):
        # the streams
        streams = {
            "copy (E,35)": ([draw(rng, (E, 35), dev), draw(rng, (E, 35),
                                                            dev)], 1.0),
            "transpose (E,35)->(35,E)": ([draw(rng, (E, 35), dev).t()], 1.0),
            "transpose (35,E)->(E,35)": ([draw(rng, (35, E), dev).t()], 1.0),
            "lane B d=10 g=16": ([draw(rng, (E, 160), dev).view(E, 16, 10),
                                  draw(rng, (E, 16), dev)[:, :, None]
                                  .expand(E, 16, 10)], 1.0),
            "scale 2x (E,64)": ([draw(rng, (E, 64), dev)], 2.0)}
        for label, (ops, alpha) in streams.items():
            got = pk.probe_stream_f32(ops, alpha=alpha)
            want = pk.probe_stream_plain(ops, alpha=alpha)
            terms = pk.probe_stream_plain([o.abs() for o in ops],
                                          alpha=abs(alpha))
            check("probe_stream_f32", f"{label} E={E}", [got], [want],
                  [terms], RTOL)
        del streams
        # the contractions: (label, rows, R, runs, element-major out)
        Ef = E // 8 * 8
        D = draw(rng, (35, 35), dev)
        cases = {
            "matvec dof-major nd 35": (
                [pk.ApplyRow(u=draw(rng, (35, E), dev))], D[None], 1, False),
            "matvec element-major nd 35": (
                [pk.ApplyRow(u=draw(rng, (E, 35), dev).t())], D[None], 1,
                True),
            "matvec folded I nd 35": (
                [pk.ApplyRow(u=draw(rng, (35, Ef), dev))], D[None], 8,
                False),
            "div b=3 S=3": (
                [pk.ApplyRow(u=draw(rng, (35, E), dev),
                             J=draw(rng, (3, E), dev)) for _ in range(3)],
                draw(rng, (3, 35, 35), dev), 1, False),
            "kron 280 with jac": (
                [pk.ApplyRow(u=fold(draw(rng, (35, Ef), dev)).reshape(
                    280, Ef // 8), sigma=draw(rng, (8, Ef // 8), dev)[None]
                    .expand(35, 8, Ef // 8))], kron_eye(D)[None], 1, False),
            "lane C K=640": (
                [pk.ApplyRow(u=draw(rng, (E // 64, 640), dev).t(),
                             sigma=draw(rng, (E // 64, 64), dev).t()[
                                 :, None, :].expand(64, 10, E // 64))],
                draw(rng, (1, 640, 640), dev), 1, True)}
        for label, (rows, R, runs, out_em) in cases.items():
            mags = [replace(r, u=r.u.abs(),
                            J=None if r.J is None else r.J.abs(),
                            sigma=None if r.sigma is None
                            else r.sigma.abs()) for r in rows]
            terms = pk.probe_apply_plain(mags, R.abs(),
                                         out_elem_major=out_em)
            S, _, K = R.shape
            for kernel, plain, tol in (
                    (pk.probe_apply_f32, pk.probe_apply_plain, RTOL),
                    (pk.probe_apply_3xtf32, pk.probe_apply_3x_plain,
                     split_tolerance(S * K))):
                got = kernel(rows, R, runs=runs, out_elem_major=out_em)
                want = plain(rows, R, out_elem_major=out_em)
                check(kernel.__name__, f"{label} E={rows[0].u.shape[1]}",
                      got, want, terms, tol)
            del rows, mags, terms
        torch.cuda.empty_cache()


def probe_path(dev, label: str, stats: KernelStats) -> dict:
    """Phase 21, the TPU probes: (a) :func:`probe_kernel_checks`; (b)
    counters reset, every case of the eight probe modules at its first
    block size driven once, the probe kernels' counters read (the
    checks and timings after each drive are not counted); (c) each case
    checked against its plain version and timed in turns against it and
    its library call (into *stats*).  Returns the launches of (b)."""
    import importlib

    import torch

    from feinsum_tpu_torch.ops import kernels
    from feinsum_tpu_torch.probes import Case

    probe_kernel_checks(dev)
    kernels.reset_launch_counts()
    launches = {k: 0 for k in PROBE_KERNELS}
    # per (the TPU probes' kernel, Hopper kernel): cases, launches, ms,
    # plain ms, library ms, bound ms
    families: dict = {}
    n_cases = 0
    for name in ("layout_probe", "fold_probe", "fold_probe2", "fold_probe3",
                 "fold_probe4", "fold_probe5", "kron_probe",
                 "lane_reshape_probe"):
        module = importlib.import_module(f"feinsum_tpu_torch.probes.{name}")
        t_mod = time.perf_counter()
        for case in module.cases(dev, 0, first_block_only=True):
            if not isinstance(case, Case):
                continue
            before = dict(kernels.launch_counts)
            case.fn(case.arrays)
            torch.cuda.synchronize()
            drive = {k: n - before[k]
                     for k, n in kernels.launch_counts.items()}
            for k in PROBE_KERNELS:
                launches[k] += drive[k]
            res = case.run()
            n_cases += 1
            fam = families.setdefault((case.family, case.kernel),
                                      [0, 0, 0.0, 0.0, 0.0, 0.0])
            for k, v in enumerate((1, drive[case.kernel], res.ms,
                                   res.plain_ms, res.library_ms or 0.0,
                                   res.bound)):
                fam[k] += v
            if case.kernel in PROBE_KERNELS:
                stats.add_bound(case.kernel, res.ms, res.plain_ms,
                                res.library_ms, res.bytes_ms, res.ops_ms)
                err = ERRORS[case.kernel]
                err["abs"] = max(err["abs"], res.max_abs_err)
                if res.over_terms is not None:
                    err["terms"] = max(err["terms"], res.over_terms)
            del case
        log(f"[probe] {name}: {time.perf_counter() - t_mod:.1f} s {label}")
        torch.cuda.empty_cache()
    for (family, kernel), (n, runs, ms, plain_ms, lib_ms, bound) in sorted(
            families.items()):
        log(f"[probe] {family} on {kernel}: {n} cases, {runs} launches,"
            f" {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_ms:.4f}"
            f" ms, bound {bound:.4f} ms {label}")
    log(f"[probe] launch counts over phase 21's {n_cases} drives:"
        f" {launches}")
    for k, n in launches.items():
        if n < 1:
            raise SmokeFailure(f"{k} was not launched on the probe path")
    return launches


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAIL: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
