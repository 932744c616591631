"""Device idle share of each DG-suite row at E = 1M, for the kernel route
and the plain per-step route, on one NVIDIA card:

    python -m feinsum_tpu_torch.tools.profile_suite
    python -m feinsum_tpu_torch.tools.profile_suite tccg

With ``tccg``, the rows are the rank >= 3 TCCG rows at their published
sizes, and the routes are ``tc_grid_f32`` at the row's first tuner seed
(``suite.TCCG_SEEDS``), its plain version and the plain per-step route
(``tc_xla_v0``).

For each row and route, ``CALLS`` back-to-back calls are timed twice: once
on the host clock without the profiler (wall), and once under
``torch.profiler`` to read the device's busy time, the union of the
intervals of its kernel, copy and set events (CPU-side operator events and
the device-side shadows of ``record_function`` spans are left out: they
carry the device time of the kernels they launch, and counting them too
would count that time twice).  The idle share is
``1 - busy / wall``; the host's own time per call (to the return of the
call, before the card finishes) is printed beside the wall time.
"""

from __future__ import annotations

import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..codegen.program import build_executable
from . import LONG_DIM_LENGTH, card_line, suite_inputs

CALLS = 10
WARMUP_CALLS = 3


def is_device_op(ev) -> bool:
    """Whether the profiler ``FunctionEvent`` *ev* is an operation on the
    device: a kernel, copy or set, and not the device-side shadow that a
    ``record_function`` span (the program's ``feinsum.*`` spans among them)
    leaves over the operations it launched."""
    return (ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and not ev.name.startswith("feinsum."))


def device_busy_us(events) -> float:
    """Microseconds in the union of the time ranges of the operations that
    ran on the device (:func:`is_device_op`), among profiler
    ``FunctionEvent``s."""
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if is_device_op(ev))
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _calls(fn, arrays) -> tuple:
    """Host seconds of ``CALLS`` calls: to the return of the last call (the
    host's own time), and to the end of the last on the card (wall)."""
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(arrays)
    t_host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t_host, time.perf_counter() - t0


def report(name: str, route: str, fn, arrays) -> None:
    """Print *fn*'s wall and device-busy time per call on *arrays*."""
    for _ in range(WARMUP_CALLS):
        fn(arrays)
    torch.cuda.synchronize()
    host_ms, wall_ms = (1e3 * t / CALLS for t in _calls(fn, arrays))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _calls(fn, arrays)
    events = prof.events()
    busy_ms = device_busy_us(events) / 1e3 / CALLS
    n_dev = sum(map(is_device_op, events))
    print(f"[profile] {name} {route}: wall {wall_ms:.4f} ms/call (host"
          f" {host_ms:.4f}),"
          f" device busy {busy_ms:.4f} ms/call,"
          f" idle {100 * (1 - busy_ms / wall_ms):.1f}%,"
          f" {n_dev / CALLS:g} device events/call", flush=True)


def tccg_routes(dev):
    """``(name, [(route, fn, arrays), ...])`` of each rank >= 3 TCCG row."""
    from ..codegen.program import generate_program, get_index_lengths
    from ..measure import apply_layouts, generate_input_arrays
    from ..ops.tc_emitter import plan_tc_launch
    from ..suite import TCCG_SEEDS, tccg_suite
    from ..tuning import get_transform_func_from_module_path

    v1 = get_transform_func_from_module_path("tc_pallas_v1")
    xla = get_transform_func_from_module_path("tc_xla_v0")
    for name, e in tccg_suite():
        if name not in TCCG_SEEDS:
            continue
        program = v1.bind_args(e, **TCCG_SEEDS[name][0], precision_idx=0)(
            generate_program(e))
        logical = generate_input_arrays(e, long_dim_length=1, device=dev)
        arrays = apply_layouts(program, logical)
        plan = plan_tc_launch(program, get_index_lengths(e, 1))
        yield name, [
            ("kernel", build_executable(program, device=dev), arrays),
            ("plain version", lambda a, plan=plan: plan.plain(
                plan.operands(a)), arrays),
            ("per-step", build_executable(xla.bind_args(
                e, use_opt_path=True, precision_idx=0)(generate_program(e)),
                device=dev), logical)]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    if sys.argv[1:] == ["tccg"]:
        for name, routes in tccg_routes(dev):
            for route, fn, arrays in routes:
                report(name, route, fn, arrays)
            del routes
            torch.cuda.empty_cache()
        return
    for name, _, program, arrays in suite_inputs(dev):
        for route, p in (("kernel", program),
                         ("per-step", program.with_descriptor(backend="xla"))):
            report(name, route, build_executable(
                p, long_dim_length=LONG_DIM_LENGTH, device=dev), arrays)
        del arrays
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
