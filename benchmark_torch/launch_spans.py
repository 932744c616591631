"""Each device operation of the traced steps put down to the launch that
issued it, read from the program's own spans in the profiler's host trace:
one ``feinsum.launch:*`` span around each launch (the call of a kernel's C
entry), and the spans around that one, such as ``feinsum.step:*`` (a
model's step), ``feinsum.exec:*`` (a call of an executable, named by the
model's einsum) and ``feinsum.kernel:*`` (a kernel wrapper).

The program launches onto one stream, so its device operations (those that
are not PyTorch's own) start in the order of its launch spans: the k-th
operation is the k-th launch's.  The profiler puts the device's timestamps
on the host's clock; a device operation that starts before its launch
span began would show that the two do not share one.  This module imports
nothing of the program."""

from __future__ import annotations

import yardstick

LAUNCH = "feinsum.launch:"


def pair(trace, prefixes=()):
    """``[(op, launch, holders)]`` in start order: each of the program's
    device operations, its launch span, and for each of *prefixes* the
    innermost span so named that holds the launch span (``None`` where
    none does), each a ``(name, start, end)``.  ``None`` without a trace,
    or unless the operations, the launch spans and the launches the
    program counted (``trace.launches``) are equally many, and no
    operation starts before its launch span began."""
    if trace is None:
        return None
    launches = sorted((s for s in trace.host if s[0].startswith(LAUNCH)),
                      key=lambda s: s[1])
    ops = sorted((s for s in trace.device
                  if not yardstick.is_pytorch_kernel(s[0])),
                 key=lambda s: s[1])
    if not ops or not len(ops) == len(launches) == trace.launches:
        return None
    if any(op[1] < launch[1] for op, launch in zip(ops, launches)):
        return None
    holders = [_innermost(trace.host, prefix, launches)
               for prefix in prefixes]
    return [(op, launch, {p: h[k] for p, h in zip(prefixes, holders)})
            for k, (op, launch) in enumerate(zip(ops, launches))]


def _innermost(host, prefix: str, launches: list) -> list:
    """For each of *launches* (in start order), the innermost span of
    *host* named with *prefix* that holds it, or ``None``."""
    spans = sorted((s for s in host if s[0].startswith(prefix)),
                   key=lambda s: (s[1], -s[2]))
    out, open_, k = [], [], 0
    for _, lo, hi in launches:
        while k < len(spans) and spans[k][1] <= lo:
            open_.append(spans[k])
            k += 1
        # a span that ends before this launch does holds no later one
        while open_ and open_[-1][2] < hi:
            open_.pop()
        out.append(open_[-1] if open_ else None)
    return out


def seconds_per_step(trace, prefix: str, name=None):
    """Device seconds per traced step of the program's operations whose
    launch lies inside a span named with *prefix* (the innermost, named
    *name* where given); ``None`` where :func:`pair` pairs nothing or no
    operation is so launched."""
    paired = pair(trace, (prefix,))
    if paired is None:
        return None
    busy = sum(op[2] - op[1] for op, _, holders in paired
               if holders[prefix] is not None
               and name in (None, holders[prefix][0]))
    return busy / trace.steps if busy > 0 else None


def idle_gaps(trace):
    """``[(start, end, host_late)]``: each idle gap between the device
    operations, and in seconds the part of it before the launch span of
    the operation that ends it had ended (the device waited on the host);
    the rest of the gap is queued (the launch was issued: its latency,
    with work queued).  A gap that one of PyTorch's operations ends has no
    launch span and is left out.  ``None`` where :func:`pair` pairs
    nothing."""
    paired = pair(trace)
    if paired is None:
        return None
    issued = {op[1]: launch[2] for op, launch, _ in paired}
    return [(lo, hi, min(max(issued[hi] - lo, 0.0), hi - lo))
            for lo, hi in yardstick.idle_gaps((s[1], s[2])
                                              for s in trace.device)
            if hi in issued]
