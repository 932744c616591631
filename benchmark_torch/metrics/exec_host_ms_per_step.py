"""exec_host_ms_per_step (layer: plan): host time per traced step in the
program's ``feinsum.exec:*`` spans less the ``feinsum.kernel:*`` spans
inside them: the executables' own work on each call (device checks, the
plan's operand and output views) (``host_spans.split``)."""

import host_spans


def read(run):
    split = host_spans.split(run.trace)
    return None if split is None else 1e3 * split[1]
