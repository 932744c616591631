"""predictor_ms_per_step (layer: model step): device time per step of the
ADER step's predictor (its derivatives and time integral) in the traced
segment.  The program counts the launches its step issues inside the
predictor's span (``feinsum_tpu_torch.tracing.counters``:
``ader_predictor_launches`` over ``model_steps``, P a step); the reader
takes the program's device operations in start order (those that are not
PyTorch's own), cuts them into the traced steps at the run's launches per
step, and sums the first P of each step.  It reports nothing where the
program lacks the counter or counts none, or where the device operations
of a step are not as many as its launches, so that which operations are
the predictor's would be a guess."""

import yardstick


def read(run):
    if run.trace is None:
        return None
    try:
        from feinsum_tpu_torch.tracing import counters
    except ImportError:
        return None
    steps = counters.get("model_steps", 0)
    predictor = counters.get("ader_predictor_launches", 0)
    if steps <= 0 or predictor <= 0 or predictor % steps:
        return None
    per_step, launches = predictor // steps, run.trace.launches
    if launches % run.trace.steps:
        return None
    ops = sorted((lo, hi) for name, lo, hi in run.trace.device
                 if not yardstick.is_pytorch_kernel(name))
    stride = launches // run.trace.steps
    if len(ops) != launches or not 0 < per_step <= stride:
        return None
    busy = sum(hi - lo for k in range(0, len(ops), stride)
               for lo, hi in ops[k:k + per_step])
    return 1e3 * busy / run.trace.steps
