"""update_ms_per_step (layer: model step): device time per step of the
program's state update in the traced segment: the launches of its
``step_update`` kernel (everything between the einsums' outputs and the
new state) and of its ``pairs_split`` kernel (a float64 state split into
float32 hi/lo pairs), found by name among the profiler's device
operations.  Where neither ran, as in a program without them, it reports
nothing."""

import yardstick

KERNELS = ("step_update", "pairs_split")


def read(run):
    if run.trace is None:
        return None
    update = sum(hi - lo for name, lo, hi in run.trace.device
                 if any(k in name for k in KERNELS)
                 and not yardstick.is_pytorch_kernel(name))
    if update <= 0:
        return None
    return 1e3 * update / run.trace.steps
