"""
feinsum_tpu_torch — the batched-einsum library of ``feinsum_tpu`` ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (``sm_90a``).

It carries the DG suite's main path (build a batched einsum in the IR,
schedule it, lay it out dof-major, validate it against the numpy oracle and
run it through the fused CUDA kernels of ``ops/cuda_emitter.py``), and the
archive path: canonicalize an einsum to its archive key, tune a transform
space on the device into the sqlite archive (``tuning.autotune``), and
replay the archived champion (``sql_utils``) onto the fp64 DG kernel of
``ops/dd_emitter.py`` or, for the TCCG dense tensor contractions
(``get_tccg_benchmark``), onto the tensor-contraction kernel of
``ops/tc_emitter.py``.  Its consumer entry points are
``compile_fn_with_archive`` (a user's torch function, traced by
``torch.fx``, matched against the grammar and replayed from the archive)
and the DG wave and Maxwell models (``models``).  Public names are those
of ``feinsum_tpu``.  The package imports ``torch`` and never ``jax`` or
``feinsum_tpu``.
"""

from .algebraic import hoist_cses_in_fn
from .apply import compile_fn_with_archive
from .canonicalization import (
    are_einsums_isomorphic,
    canonical_operand_positions,
    canonicalize_einsum,
    get_substitution_mapping_between_isomorphic_batched_einsums,
)
from .cl_utils import FakeCLDevice, FakeDevice

from .codegen import (
    EinsumProgram,
    ScheduleDescriptor,
    build_executable,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from .contraction_schedule import (
    ContractionSchedule,
    EinsumOperand,
    IntermediateResult,
    get_opt_einsum_contraction_schedule,
    get_trivial_contraction_schedule,
)
from .diagnostics import (
    EinsumMatchError,
    EinsumTunitMatchError,
    InvalidParameterError,
    NoDevicePeaksInfoError,
    NoFactInDatabaseError,
    TransformValidationError,
)
from .einsum import (
    Array,
    BatchedEinsum,
    EinsumAxisAccess,
    FreeAxis,
    SizeParam,
    SummationAxis,
)
from .make_einsum import array, batched_einsum, einsum
from .matching import (
    InsnInfo,
    abstract_long_axes,
    get_a_matched_einsum,
    get_call_ids,
    get_matched_einsums,
    identify_as_einsum,
    map_names,
    match_fn_to_einsum,
    match_t_unit_to_einsum,
)
from .measure import (
    apply_layouts,
    get_footprint_gbytes,
    get_giga_op_map,
    get_roofline_flop_rate,
    timeit,
    validate_batched_einsum_transform,
)
from .ops.layouts import unpack_output
from .sql_utils import (
    DEFAULT_DB,
    apply_best_transform,
    get_timed_einsums_in_db,
    query,
    record_facts,
    retrieve,
)
from .models import (
    MaxwellOperator3D,
    WaveOperator3D,
    make_maxwell_state,
    make_wave_state,
)
from .utils import get_tccg_benchmark
from .tuning import (
    BoolParameter,
    IntParameter,
    ParametrizedTransform,
    PermutationParameter,
    TupleParameter,
    autotune,
    einsum_arg,
    transform_param,
)

__version__ = "0.1.0"

__all__ = (
    "Array",
    "BatchedEinsum",
    "BoolParameter",
    "ContractionSchedule",
    "DEFAULT_DB",
    "EinsumAxisAccess",
    "EinsumMatchError",
    "EinsumOperand",
    "EinsumProgram",
    "EinsumTunitMatchError",
    "FakeCLDevice",
    "FakeDevice",
    "FreeAxis",
    "InsnInfo",
    "IntParameter",
    "IntermediateResult",
    "InvalidParameterError",
    "MaxwellOperator3D",
    "NoDevicePeaksInfoError",
    "NoFactInDatabaseError",
    "ParametrizedTransform",
    "PermutationParameter",
    "ScheduleDescriptor",
    "SizeParam",
    "SummationAxis",
    "TransformValidationError",
    "TupleParameter",
    "WaveOperator3D",
    "abstract_long_axes",
    "apply_best_transform",
    "apply_layouts",
    "are_einsums_isomorphic",
    "array",
    "autotune",
    "batched_einsum",
    "build_executable",
    "canonical_operand_positions",
    "canonicalize_einsum",
    "compile_fn_with_archive",
    "einsum",
    "einsum_arg",
    "generate_program",
    "generate_program_with_opt_einsum_schedule",
    "get_a_matched_einsum",
    "get_call_ids",
    "get_footprint_gbytes",
    "get_giga_op_map",
    "get_matched_einsums",
    "get_opt_einsum_contraction_schedule",
    "get_roofline_flop_rate",
    "get_substitution_mapping_between_isomorphic_batched_einsums",
    "get_tccg_benchmark",
    "get_timed_einsums_in_db",
    "get_trivial_contraction_schedule",
    "hoist_cses_in_fn",
    "identify_as_einsum",
    "make_maxwell_state",
    "make_wave_state",
    "map_names",
    "match_fn_to_einsum",
    "match_t_unit_to_einsum",
    "query",
    "record_facts",
    "retrieve",
    "timeit",
    "transform_param",
    "unpack_output",
    "validate_batched_einsum_transform",
)
