"""anelastic_roofline (layer: kernels): the least time of the
configuration's anelastic einsums (those marked ``"part": "anelastic"``:
the source and relaxation products; each the larger of its operations over
the compute peak and its bytes over the memory peak, data-sheet peaks)
over the device time per traced step of the launches made inside the
program's ``feinsum.ader:anelastic`` spans (``anelastic_ms_per_step``'s),
in percent.  Nothing where the configuration marks no such einsum or
``launch_spans`` puts no launch in such a span."""

import launch_spans
import yardstick

SPAN = "feinsum.ader:anelastic"


def read(run):
    if run.trace is None or run.peaks is None:
        return None
    specs = [s for s in run.cfg["einsums"] if s.get("part") == "anelastic"]
    busy = launch_spans.seconds_per_step(run.trace, SPAN)
    if not specs or busy is None:
        return None
    least = sum(yardstick.least_time(
        *yardstick.einsum_counts(s, run.cfg, run.n_elements), run.peaks,
        run.cfg["dtype"])[0] for s in specs)
    return 100.0 * least / busy
