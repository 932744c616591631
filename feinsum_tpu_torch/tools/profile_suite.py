"""Device idle share of each DG-suite row at E = 1M, for the kernel route
and the plain per-step route, on one NVIDIA card:

    python -m feinsum_tpu_torch.tools.profile_suite

For each row and route, ``CALLS`` back-to-back calls are timed twice: once
on the host clock without the profiler (wall), and once under
``torch.profiler`` to read the device's busy time, the union of the
intervals of its kernel, copy and set events (CPU-side operator events are
left out: they carry the device time of the kernels they launch, and
counting them too would count that time twice).  The idle share is
``1 - busy / wall``.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..codegen.program import build_executable
from . import LONG_DIM_LENGTH, card_line, suite_inputs

CALLS = 10
WARMUP_CALLS = 3


def device_busy_us(events) -> float:
    """Microseconds in the union of the time ranges of the events that ran
    on the device, among profiler ``FunctionEvent``s."""
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in events
                   if ev.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def _calls(fn, arrays) -> float:
    """Host seconds of ``CALLS`` calls, to the end of the last on the card."""
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn(arrays)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    for name, _, program, arrays in suite_inputs(dev):
        for route, p in (("kernel", program),
                         ("per-step", program.with_descriptor(backend="xla"))):
            fn = build_executable(p, long_dim_length=LONG_DIM_LENGTH,
                                  device=dev)
            for _ in range(WARMUP_CALLS):
                fn(arrays)
            torch.cuda.synchronize()
            wall_ms = 1e3 * _calls(fn, arrays) / CALLS
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                _calls(fn, arrays)
            events = prof.events()
            busy_ms = device_busy_us(events) / 1e3 / CALLS
            n_dev = sum(ev.device_type == DeviceType.CUDA for ev in events)
            print(f"[profile] {name} {route}: wall {wall_ms:.4f} ms/call,"
                  f" device busy {busy_ms:.4f} ms/call,"
                  f" idle {100 * (1 - busy_ms / wall_ms):.1f}%,"
                  f" {n_dev / CALLS:g} device events/call", flush=True)
        del arrays
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
