"""The host time of the traced steps split by layer, read from the
program's own spans in the profiler's host trace: ``feinsum.step:*`` (a
model's step), ``feinsum.exec:*`` (a call of an executable) and
``feinsum.kernel:*`` (a kernel wrapper on its CUDA branch), nested by
containment.  A step span splits into its own time (the model's glue), the
own time of the executable spans inside it, and the kernel spans inside
those.  This module imports nothing of the program."""

from __future__ import annotations

# the layers' span-name prefixes, outermost first
PREFIXES = ("feinsum.step:", "feinsum.exec:", "feinsum.kernel:")


def split(trace):
    """Seconds per traced step ``(model step, executables, kernel
    wrappers)``: each layer's spans, less the spans one layer down inside
    them, summed over the step spans (so the three add up to the step
    spans); ``None`` without a trace, or unless it holds one
    ``feinsum.step`` span per traced step."""
    if trace is None:
        return None
    spans = sorted((lo, -hi, level) for name, lo, hi in trace.host
                   for level, prefix in enumerate(PREFIXES)
                   if name.startswith(prefix))
    own = [0.0] * len(PREFIXES)
    steps = 0
    chain = []  # (end, level) of the counted spans around the next one
    for lo, neg_hi, level in spans:
        hi = -neg_hi
        while chain and chain[-1][0] < hi:
            chain.pop()
        if level == 0:
            steps += 1
        elif chain and chain[-1][1] == level - 1:
            own[level - 1] -= hi - lo
        else:
            continue  # not inside a span one layer up: left in that layer
        own[level] += hi - lo
        chain.append((hi, level))
    if steps == 0 or steps != trace.steps:
        return None
    return tuple(t / steps for t in own)
