"""setup_program_s (layer: set-up): the program's own set-up seconds, read
from its counters (``feinsum_tpu_torch.tracing.counters``) when the run
ends: executable builds, the first load of the kernels' library (without
its build) and archive lookups.  A program without those counters reports
nothing."""


def read(run):
    try:
        from feinsum_tpu_torch.tracing import counters
    except ImportError:
        return None
    return (counters["executable_build_s"] + counters["library_load_s"]
            + counters["archive_query_s"])
