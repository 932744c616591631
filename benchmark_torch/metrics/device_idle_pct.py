"""device_idle_pct (layer: device): the share of the traced window in which
no operation ran on the device: one less the union of the device
operations' intervals over the window, in percent."""

import yardstick


def read(run):
    if run.trace is None:
        return None
    busy = yardstick.busy_seconds((lo, hi) for _, lo, hi in run.trace.device)
    return 100.0 * (1.0 - busy / run.trace.window_s)
