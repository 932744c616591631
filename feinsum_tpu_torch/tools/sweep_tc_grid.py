"""Kernel time of ``tc_grid_f32`` on the rank >= 3 rows of the TCCG sample,
over a grid of ``tc_pallas_v1`` points, on one NVIDIA card:

    python -m feinsum_tpu_torch.tools.sweep_tc_grid

For each row it prints the host time of the numpy oracle at full size (what
every validation of the row costs), the times of the kernel's plain version
and of the plain per-step route (``tc_xla_v0``), and then every point's
kernel time (median of 20 launches), fastest first; each point's output is
first held to the per-step route's within 2e-5 of its largest value.  The points:
``n_grid`` 1 and 2, ``blk0_idx`` 0, 4 and 9, ``blk1_idx`` 0 and 9 (with
two grid letters), every ``m_pos``.
"""

from __future__ import annotations

import itertools
import time

import torch

from ..codegen.program import build_executable, generate_program
from ..diagnostics import InvalidParameterError
from ..measure import _numpy_oracle, apply_layouts, generate_input_arrays, \
    timeit_cuda
from ..ops.kernels import tc_classify
from ..ops.tc_emitter import plan_tc_launch, tc_step
from ..suite import tccg_suite
from ..tuning import get_transform_func_from_module_path
from . import card_line


def points(e) -> list:
    out = []
    for n_grid, blk0, blk1 in itertools.product((1, 2), (0, 4, 9), (0, 9)):
        if n_grid == 1 and blk1:
            continue
        for m_pos in range(len(e.out_idx_set)):
            out.append(dict(n_grid=n_grid, blk0_idx=blk0, blk1_idx=blk1,
                            m_pos=m_pos, precision_idx=0))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    xla = get_transform_func_from_module_path("tc_xla_v0")
    for name, e in tccg_suite():
        if len(e.out_idx_set) < 3:
            continue
        np_arrays = generate_input_arrays(e, long_dim_length=1,
                                          as_numpy=True)
        t0 = time.perf_counter()
        _numpy_oracle(e, np_arrays)
        print(f"[oracle] {name}: numpy oracle on the host"
              f" {time.perf_counter() - t0:.3f} s", flush=True)
        logical = generate_input_arrays(e, long_dim_length=1, device=dev)
        prog = xla.bind_args(e, use_opt_path=True, precision_idx=0)(
            generate_program(e))
        per_step = timeit_cuda(build_executable(prog, device=dev), logical)
        lengths = {ix: int(ln) for ix, ln in e.index_to_dim_length.items()}
        (want,) = build_executable(prog, device=dev)(logical)
        scale = float(want.abs().max())
        results, plain = [], None
        for params in points(e):
            try:
                prog = v1.bind_args(e, **params)(generate_program(e))
            except InvalidParameterError:
                continue
            arrays = apply_layouts(prog, logical)
            fn = build_executable(prog, device=dev)
            if plain is None:
                plan = plan_tc_launch(prog, lengths)
                plain = timeit_cuda(
                    lambda a, plan=plan: plan.plain(plan.operands(a)),
                    arrays)
            (got,) = fn(arrays)
            err = float((got.double() - want.double()).abs().max()) / scale
            if not err <= 2e-5:
                raise SystemExit(f"{name} {params}: tc_grid_f32 differs from"
                                 f" the per-step route by {err:.2e}")
            del got
            shape = tc_classify(tc_step(prog, lengths)[0])
            results.append((timeit_cuda(fn, arrays), params,
                            f"Mc {shape.Mc} Nc {shape.Nc} K {shape.K}"
                            f" cells {shape.ncells} tile {shape.variant}"))
            del arrays
        print(f"[sweep] {name}: per-step route {per_step:.4f} ms,"
              f" tc_grid_plain {plain:.4f} ms, {len(results)} points",
              flush=True)
        for ms, params, shape in sorted(results, key=lambda r: r[0]):
            print(f"[sweep] {name} {ms:.4f} ms {params} {shape}", flush=True)
        del logical
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
