"""flux_ms_per_step (layer: kernels): device time per traced step of the
launches made inside the program's ``feinsum.exec:flux`` spans (the ADER
step's flux term, SeisSol's ``localFlux``), each device operation put down
to its launch by ``launch_spans``.  Nothing where ``launch_spans`` pairs
nothing or no launch lies in such a span, as in a program that names its
executables otherwise."""

import launch_spans


def read(run):
    flux = launch_spans.seconds_per_step(run.trace, "feinsum.exec:",
                                         "feinsum.exec:flux")
    return None if flux is None else 1e3 * flux
