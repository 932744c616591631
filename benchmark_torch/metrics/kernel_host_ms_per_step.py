"""kernel_host_ms_per_step (layer: host dispatch): host time per traced
step in the program's ``feinsum.kernel:*`` spans, the kernel wrappers'
checks, output allocation, ctypes packing and launches, inside its
executables' spans (``host_spans.split``)."""

import host_spans


def read(run):
    split = host_spans.split(run.trace)
    return None if split is None else 1e3 * split[2]
