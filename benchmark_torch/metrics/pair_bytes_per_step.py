"""pair_bytes_per_step (layer: model step): the bytes that a model step's
conversions between float64 and float32 hi/lo pairs read and write, per
step: the program's counters ``pair_bytes`` over ``model_steps``
(``feinsum_tpu_torch.tracing.counters``) when the run ends.  The geometry
split once counts in it, spread over the run's steps.  A program without
those counters reports nothing."""


def read(run):
    try:
        from feinsum_tpu_torch.tracing import counters
    except ImportError:
        return None
    steps = counters.get("model_steps", 0)
    if "pair_bytes" not in counters or steps <= 0:
        return None
    return counters["pair_bytes"] / steps
