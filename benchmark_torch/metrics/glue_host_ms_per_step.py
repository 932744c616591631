"""glue_host_ms_per_step (layer: model step): host time per traced step in
the program's ``feinsum.step:*`` spans less the ``feinsum.exec:*`` spans
inside them: the model's own PyTorch glue (adds, scales, ``torch.stack``)
on the host (``host_spans.split``)."""

import host_spans


def read(run):
    split = host_spans.split(run.trace)
    return None if split is None else 1e3 * split[0]
