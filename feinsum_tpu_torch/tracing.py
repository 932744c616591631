"""
The port's spans and counters: its only tracing code.

:func:`span` marks a stretch of host time for the torch profiler that the
caller runs.  While a profiler records, it enters
``torch.profiler.record_function``; otherwise it does nothing beyond
checking that, so a span costs a flag check when no one traces.  The
profiler holds the spans, writes them out and puts them on the clock of its
device trace; nothing here exports, stores or switches anything.

The spans, each at one boundary of the package:

* ``feinsum.step:<class>`` — the body of a model's step closure
  (``models/wave.py``, ``models/maxwell.py``, ``models/hexwave.py``,
  ``models/ader.py``);
* ``feinsum.ader:predictor`` and ``feinsum.ader:corrector`` — the two
  halves of the ADER step (``models/ader.py``), inside its ``feinsum.step``
  span: the derivatives and the time integral, then the volume and flux
  terms and the update;
* ``feinsum.exec:<name>`` — each call of an executable that
  :func:`~feinsum_tpu_torch.codegen.program.build_executable` returns,
  under the name its caller gave, else the program's subscripts.  The
  models name theirs by their einsums: wave ``grad``, ``div``,
  ``restrict``, ``face``; Maxwell ``curl`` (called twice a step); the
  hexahedral model ``grad_axes``, ``grad_metric``, ``div_metric``,
  ``div_1``-``div_3``; ADER ``derivative_0``-``derivative_3``, ``volume``,
  ``flux`` (Yateto's kernel names);
* ``feinsum.kernel:<kernel>`` — a kernel wrapper of ``ops/kernels.py`` or
  ``ops/probe_kernels.py`` on its CUDA branch: the checks, the outputs'
  allocation, the ctypes packing and its one or more launches;
* ``feinsum.launch:<kernel>.<path>`` — one launch, the call of the C
  entry, inside its ``feinsum.kernel`` span (:func:`launch_span`, entered
  by the ``launch`` of ``ops.kernels.launch_frame``).  ``<path>`` is the
  path the wrapper chose: ``tiled`` or ``general`` for ``dg_rows_f32``
  and ``dd_rows``; ``stream``, ``lanes``, ``dense`` or ``general`` for
  ``step_block_f32``; any other kernel's span is
  ``feinsum.launch:<kernel>``.  Every launch goes to the device's current
  stream, so a trace's device operations start in the order of these
  spans (one each, where the C entry launches one kernel);
* ``feinsum.executable.build``, ``feinsum.library.load`` and
  ``feinsum.archive.query`` — the set-up work (:func:`setup`).

:data:`counters` holds every counter: ``"launches"``, the launches by
kernel (``ops.kernels.launch_counts`` is the same dict),
``"dg_rows_f32_path"`` and ``"dd_rows_path"``, those kernels' launches by
path, ``"step_block_mode"``, ``step_block_f32``'s launches by the path
they took (``"stream"`` or ``"lanes"``, ``ops.kernels.step_block_path``),
else by the mode of their step table (``"dense"`` when every step is
dense, else ``"general"``), the three counted at each launch
(``ops.kernels.launcher``, :func:`count_launch`) from the path that names
its span, ``"lane_chains"``, the chained pairs of the lanes launches
(``ops.step_block.plan_lanes``), counted at the launch,
``"model_steps"``, the calls of a model's step,
``"ader_predictor_launches"``, the launches issued inside the ADER step's
``feinsum.ader:predictor`` span (``launches`` before and after it), so
that ``ader_predictor_launches / model_steps`` is the predictor's launches
per step, ``"anelastic_launches"``, likewise the launches inside the
viscoelastic ADER step's ``feinsum.ader:anelastic`` spans (its source and
relaxation products),
``"pair_bytes"``, the bytes the steps' pair conversions read and write
(a split 16 an entry: 8 of float64 read, 2 x 4 of pair written; a combine
fused into the update 8 an entry, the pair read), so that ``pair_bytes /
model_steps`` is the conversions' bytes per step, and for each piece of
set-up work a count and its seconds, timed on every call (the paths are
cold):

* ``executable_builds``, ``executable_build_s`` — builds of an executable,
  each a miss of ``build_executable``'s cache;
* ``library_loads``, ``library_load_s`` — the first load of the kernels'
  library, without its ``nvcc`` build (``ops._build.build_info`` keeps
  that);
* ``archive_queries``, ``archive_query_s`` — archive lookups
  (``sql_utils.query``), canonicalisation included.

A count that grows after set-up means something was built or loaded again
on the main path.
"""

from __future__ import annotations

import contextlib
import time

import torch

_recording = torch._C._autograd._profiler_enabled


class _Off:
    """The span while no profiler records.  Its enter and exit are each one
    C call: ``"".format`` takes any arguments and returns the falsy ``""``,
    so an exception leaving the span passes on (a ``nullcontext`` costs two
    Python calls more)."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()

counters = {
    # launches by kernel (the probe kernels too); a ``bf16_3x`` row planned
    # onto a kernel with no 3x variant (``ew_product_f32``, ``ew_flat_f32``,
    # ``row_reduce_f32``, ``long_reduce_f32``, ``step_block_f32``,
    # ``tc_steps_f32``, ``dd_rows``) runs it in f32 and counts under its
    # name
    "launches": {"dg_rows_f32": 0, "ew_product_f32": 0, "ew_flat_f32": 0,
                 "row_reduce_f32": 0, "long_reduce_f32": 0, "dd_rows": 0,
                 "tc_grid_f32": 0, "dg_rows_3xtf32": 0, "tc_grid_3xtf32": 0,
                 "lane_pack_dg_f32": 0, "lane_pack_dg_3xtf32": 0,
                 "step_block_f32": 0, "tc_steps_f32": 0,
                 "probe_stream_f32": 0, "probe_apply_f32": 0,
                 "probe_apply_3xtf32": 0, "step_update": 0,
                 "pairs_split": 0},
    # dg_rows_f32's launches by path: the tiled path (dof-major operands on
    # 16 bytes) or the general one (any other stored layout)
    "dg_rows_f32_path": {"tiled": 0, "general": 0},
    # dd_rows's launches by path, likewise
    "dd_rows_path": {"tiled": 0, "general": 0},
    # step_block_f32's launches by the path they took: the stream or the
    # lanes path (ops/kernels.step_block_path), else the mode of their step
    # table: every step dense (register tiles), or any general one (offset
    # tables)
    "step_block_mode": {"dense": 0, "general": 0, "stream": 0, "lanes": 0},
    # the chained pairs of step_block_f32's lanes launches (ops/step_block.
    # plan_lanes), counted at the launch: 5 an ADER step
    "lane_chains": 0,
    "model_steps": 0, "pair_bytes": 0, "ader_predictor_launches": 0,
    # the launches inside the viscoelastic ADER step's feinsum.ader:anelastic
    # spans (its source and relaxation products): 9 a step
    "anelastic_launches": 0,
    "executable_builds": 0, "executable_build_s": 0.0,
    "library_loads": 0, "library_load_s": 0.0,
    "archive_queries": 0, "archive_query_s": 0.0}

# the kernels whose launches count by path, and their counter's key
PATH_COUNTERS = {"dg_rows_f32": "dg_rows_f32_path",
                 "dd_rows": "dd_rows_path",
                 "step_block_f32": "step_block_mode"}

# each set-up span's count and seconds in :data:`counters`
_SETUP = {"feinsum.executable.build": ("executable_builds",
                                       "executable_build_s"),
          "feinsum.library.load": ("library_loads", "library_load_s"),
          "feinsum.archive.query": ("archive_queries", "archive_query_s")}


def span(name: str):
    """A context manager: ``record_function(name)`` while a torch profiler
    records, else one that does nothing."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(name)


def launch_span(kernel: str, path=None):
    """:func:`span` of one launch of *kernel* on *path*:
    ``feinsum.launch:<kernel>.<path>``, or ``feinsum.launch:<kernel>``
    without a path; its name is built only while a profiler records."""
    if not _recording():
        return _OFF
    return torch.profiler.record_function(
        f"feinsum.launch:{kernel}" if path is None
        else f"feinsum.launch:{kernel}.{path}")


def count_launch(kernel: str, path=None) -> None:
    """Count one launch of *kernel* (a key of ``counters["launches"]``),
    and with *path* one under it in the kernel's path counter."""
    counters["launches"][kernel] += 1
    if path is not None:
        counters[PATH_COUNTERS[kernel]][path] += 1


@contextlib.contextmanager
def setup(name: str):
    """The set-up span *name* (a key of ``_SETUP``): a span, one more in
    its count, and its seconds added to its time."""
    count, seconds = _SETUP[name]
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        counters[count] += 1
        counters[seconds] += time.perf_counter() - t0
