"""step_ms: the measured window's length over the time steps completed in
it (host clock, one synchronise at each end)."""


def read(run):
    return 1e3 * run.window_s / run.steps
