"""dd_rows_roofline (layer: kernels): the least time of the step's einsums
at the configuration's precision (each the larger of its operations over
the data sheet's float64 peak and its bytes, 8 an entry, over the memory
peak) over the device time per step of the ``dd_rows`` launches in the
traced segment, in percent: the float64 pair route's share of its
roofline.  Where no ``dd_rows`` launch ran it reports nothing."""

import yardstick


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    kernel = sum(hi - lo for name, lo, hi in run.trace.device
                 if "dd_rows" in name
                 and not yardstick.is_pytorch_kernel(name))
    if kernel <= 0:
        return None
    least = yardstick.einsums_least_time(run.cfg, run.n_elements, run.peaks)
    return 100.0 * least / (kernel / run.trace.steps)
