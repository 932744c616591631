"""setup_s: from the start of the process to the first timed step: imports,
the CUDA context, the kernels' library (built in a checkout's first run),
the inputs drawn on the card, the operator and its executables, warm-up."""


def read(run):
    return run.setup_s
