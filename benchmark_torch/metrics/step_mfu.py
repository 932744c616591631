"""step_mfu (layer: whole step): the whole step's least time over its
measured time, in percent.  The least time counts the step's einsum
operations against the compute peak and its state and geometry read once
and its new state written once against the memory peak, whichever is
larger; the measured time is the run's own untraced window per step.  It
counts the same work whatever kernels implement the step."""

import yardstick


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    flops, nbytes = yardstick.step_counts(run.cfg, run.n_elements)
    least, _ = yardstick.least_time(flops, nbytes, run.peaks,
                                    run.cfg["dtype"])
    return 100.0 * least / run.step_s
