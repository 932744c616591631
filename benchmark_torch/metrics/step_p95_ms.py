"""step_p95_ms: the 95th percentile over the window's steps of the time
between the CUDA events recorded at consecutive step boundaries."""

import statistics


def read(run):
    if len(run.intervals_s) < 20:
        return None
    return 1e3 * statistics.quantiles(run.intervals_s, n=20)[18]
