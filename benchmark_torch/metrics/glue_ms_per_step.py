"""glue_ms_per_step (layer: model step): device time per step of
PyTorch's own kernels (the step's adds, scales and ``torch.stack``) in the
traced segment, summed from the profiler's device operations."""

import yardstick


def read(run):
    if run.trace is None:
        return None
    glue = sum(hi - lo for name, lo, hi in run.trace.device
               if yardstick.is_pytorch_kernel(name))
    return 1e3 * glue / run.trace.steps
