"""fp64_glue_ms_per_step (layer: model step): device time per step of
PyTorch's own kernels in a float64 cell's traced segment: the step's
float64 adds and scales and its conversions between float64 and float32
hi/lo pairs, summed from the profiler's device operations."""

import yardstick


def read(run):
    if run.trace is None:
        return None
    glue = sum(hi - lo for name, lo, hi in run.trace.device
               if yardstick.is_pytorch_kernel(name))
    return 1e3 * glue / run.trace.steps
