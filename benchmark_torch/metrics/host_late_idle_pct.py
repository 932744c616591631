"""host_late_idle_pct (layer: host dispatch): the share of the traced
window in which the device sat idle because the host had not yet issued
the next launch: over the idle gaps between device operations, the part
of each before the launch span of the operation that ends it had ended
(``launch_spans.idle_gaps``), summed, over the window, in percent.  It is
at most ``device_idle_pct``; the rest of the idle time is launch latency
with work already queued, or lies before the first operation.  Nothing
where ``launch_spans`` pairs nothing."""

import launch_spans


def read(run):
    gaps = launch_spans.idle_gaps(run.trace)
    if gaps is None:
        return None
    return 100.0 * sum(late for _, _, late in gaps) / run.trace.window_s
