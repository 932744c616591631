"""einsums_roofline (layer: kernels): the least time of the step's einsums
(each the larger of its operations over the compute peak and its bytes
over the memory peak, data-sheet peaks: ``kernels_roofline``'s numerator)
over the device time per traced step of the launches made inside the
program's ``feinsum.exec`` spans, each device operation put down to its
launch by ``launch_spans``: the einsums' kernels alone, the state update
(launched outside any executable) left out.  In percent; nothing where
``launch_spans`` pairs nothing, as in a program without launch spans."""

import launch_spans
import yardstick


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    einsums = launch_spans.seconds_per_step(run.trace, "feinsum.exec:")
    if einsums is None:
        return None
    least = yardstick.einsums_least_time(run.cfg, run.n_elements, run.peaks)
    return 100.0 * least / einsums
