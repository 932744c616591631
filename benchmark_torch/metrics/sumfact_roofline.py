"""sumfact_roofline (layer: kernels): the whole step's least time (its
einsums' operations over the compute peak, or its state and geometry read
once and its new state written once over the memory peak, whichever is
larger, data-sheet peaks) over the device time per step of the program's
einsum launches in the traced segment (every device operation that is not
PyTorch's own and not the state update's ``step_update``), in percent: the
share of its roofline that the kernels doing the step's work reach.  No
fusion of the einsums can beat that least time, which counts no
intermediate.  Where no such launch ran it reports nothing."""

import yardstick


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    kernels = sum(hi - lo for name, lo, hi in run.trace.device
                  if "step_update" not in name
                  and not yardstick.is_pytorch_kernel(name))
    if kernels <= 0:
        return None
    flops, nbytes = yardstick.step_counts(run.cfg, run.n_elements)
    least, _ = yardstick.least_time(flops, nbytes, run.peaks,
                                    run.cfg["dtype"])
    return 100.0 * least / (kernels / run.trace.steps)
