"""step_mfu_fp64 (layer: whole step): ``step_mfu``'s arithmetic for the
float64 cells: the whole step's least time over its measured time, in
percent.  The least time counts the step's einsum operations against the
data sheet's float64 peak and its state and geometry read once and its new
state written once, 8 bytes an entry, against the memory peak, whichever
is larger; the measured time is the run's own untraced window per step."""

import yardstick


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    flops, nbytes = yardstick.step_counts(run.cfg, run.n_elements)
    least, _ = yardstick.least_time(flops, nbytes, run.peaks,
                                    run.cfg["dtype"])
    return 100.0 * least / run.step_s
