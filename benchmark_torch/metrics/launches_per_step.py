"""launches_per_step (layer: plan): the program's own launch counter,
``feinsum_tpu_torch.ops.kernels.launch_counts``, summed over the traced
steps, per step."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.launches / run.trace.steps
