"""anelastic_ms_per_step (layer: model step): device time per traced step
of the launches made inside the program's ``feinsum.ader:anelastic`` spans
(the viscoelastic ADER step's anelastic source and relaxation products),
each device operation put down to its launch by ``launch_spans``.  Nothing
where ``launch_spans`` pairs nothing or no launch lies in such a span, as
in a program without that span."""

import launch_spans

SPAN = "feinsum.ader:anelastic"


def read(run):
    busy = launch_spans.seconds_per_step(run.trace, SPAN)
    return None if busy is None else 1e3 * busy
