"""kernels_roofline (layer: kernels): the least time of the step's einsums
(each the larger of its operations over the compute peak and its bytes
over the memory peak, data-sheet peaks) over the device time per step of
the program's kernels (every device operation of the traced segment that
is not PyTorch's own), in percent."""

import yardstick


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    kernels = sum(hi - lo for name, lo, hi in run.trace.device
                  if not yardstick.is_pytorch_kernel(name))
    if kernels <= 0:
        return None
    least = yardstick.einsums_least_time(run.cfg, run.n_elements, run.peaks)
    return 100.0 * least / (kernels / run.trace.steps)
