"""host_ms_per_step (layer: host dispatch): host time from the call of
``step()`` to its return, averaged over calls issued in bursts of a few
right after a synchronise, so the launch queue never fills."""


def read(run):
    if run.trace is None:
        return None
    calls = run.trace.host_calls_s
    return 1e3 * sum(calls) / len(calls)
