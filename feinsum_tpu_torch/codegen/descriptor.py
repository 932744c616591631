"""
Schedule descriptors: schedules as *data*.

The fields and their names are those of ``feinsum_tpu.codegen.descriptor``,
so that a descriptor recorded by either package replays in the other.  Many
fields exist for the TPU's tiling or for routes this package does not carry
yet.  Each field is ruled on below: it has a meaning on the GPU, or a value
other than its default raises :class:`~feinsum_tpu_torch.diagnostics.
InvalidParameterError` when the program is built (see
:func:`check_supported`).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ..diagnostics import InvalidParameterError


def _freeze_mapping(m) -> tuple:
    if isinstance(m, tuple):
        return m
    return tuple(sorted(m.items()))


@dataclass(frozen=True)
class ScheduleDescriptor:
    """How to lower a batched-einsum program onto the device.

    Fields with a meaning here:

    :attr backend: ``"xla"``: the plain route, one ``torch.einsum`` per
        schedule step (what the reference hands to XLA).  ``"pallas"``: the
        hand-written CUDA kernels: with a tuple ``grid_index`` the tensor-
        contraction kernel (``ops/tc_emitter.py``), else the fused DG
        kernels (``ops/cuda_emitter.py``).  The row families' kernels
        compute each row's value, not the schedule's step order: the div
        schedule ``ej,es->ejs; ejs,sij->ei`` and the kernel's direct sum
        ``Σ_s J[e,s] Σ_j R[s,i,j] u[e,j]`` agree up to rounding; a program
        no row family takes runs its schedule step by step on
        ``step_block_f32`` (``ops/step_block.py``).
    :attr grid_index: ``None`` or any letter of the einsum (the fused
        kernels grid over it, as the reference's K1 does; ``None`` picks
        the reference's letter, ``ops/cuda_emitter.py::pick_grid_index``:
        the unique parametric letter, else an output one of several, else
        on a concrete einsum its longest output letter when that is at
        least 2048 long, else no grid, one block of one element).  The row
        families take a program whose every other letter is concrete;
        any other runs on ``step_block_f32``, every other parametric letter
        a short letter at its bound length, and refuses, naming the limit,
        what exceeds a block's shared memory (an operand without the grid
        letter is staged whole).  Or a tuple of concrete output letters: with
        ``backend="pallas"`` the dense tensor-contraction kernels
        (``ops/tc_emitter.py``, the port of K2 in ROADMAP.md).  Their CUDA
        grid walks the combinations of these letters (each combination one
        "cell"), and each output element is computed and written once, in
        place, in the stored layout.  A schedule of one step of two einsum
        operands in the einsum's own letters runs on ``tc_grid_f32``, which
        tiles each cell's remaining output as an M x N matrix of
        thread-block tiles.  Any other schedule (several steps, a step of
        one or of three or more operands, step subscripts that rename
        letters) runs on ``tc_steps_f32`` (``ops/tc_steps.py``): one thread
        block per cell evaluates every step in order, as the reference's
        cell does in VMEM, intermediates in shared memory (a cell whose
        intermediates exceed a Hopper block's 227 KB raises), the last step
        written into the cell's tile; no step may contract a grid letter.
        The plain route (``backend="xla"``) has no grid and ignores the
        tuple, as the reference's XLA route does; ``dd_pairs`` with a tuple
        raises.
    :attr grid_blocks: with a tuple ``grid_index`` only: ``(letter, blk)``
        puts *blk* consecutive indices of the grid letter into one cell
        (default 1; *blk* must divide the length).  On ``tc_grid_f32`` the
        cell's in-cell extent of the letter joins its tile axis, so the
        block decides the cell's M x N shape, the tile shape and the number
        of cells; that kernel walks a batch letter (carried by both
        operands and the output) one index per cell, so a two-operand step
        with a block > 1 on one runs on ``tc_steps_f32``, where a block on
        any grid letter is an in-cell extent of every step.
    :attr grid_m: with a tuple ``grid_index`` only: an output letter with
        in-cell extent > 1 (else it raises, as in the reference).  On
        ``tc_grid_f32`` the operand that carries it is the tile's row (M)
        operand, and the letter runs fastest along the tile's M axis, which
        sets the access order of that operand and of the output.  ``None``:
        the step's first operand gives the rows, and each side's letters
        are ordered by the strides of its larger tensor.  It moves nothing
        on ``tc_steps_f32``, whose steps order their entries by strides.
    :attr mstack: with a tuple ``grid_index`` only; accepted at both values
        and without effect on either kernel (it moves nothing on Hopper).
        It stacked unrolled output slices into the TPU MXU's M dimension,
        in ``_build_multigrid``'s one-step and multi-step lowering alike
        (``ops/kernel_lowering.py::lower_step``); ``tc_grid_f32``'s tile
        already spans all of a cell's M letters, and ``tc_steps_f32`` runs
        each step as threads over all of its entries.
    :attr pre_layouts, pre_out_layout: storage contracts of a rewritten
        program (the TC-as-GEMM rewrite of ``tc_gemm_v0``): per operand,
        and for every output, a grouping of the logical axes into merged
        stored axes (:func:`~feinsum_tpu_torch.ops.layouts.
        apply_nested_layout`).  :func:`~feinsum_tpu_torch.measure.
        apply_layouts` applies ``pre_layouts`` before ``arg_layouts``;
        validation and :func:`~feinsum_tpu_torch.ops.layouts.unpack_output`
        undo ``pre_out_layout`` after ``out_layout``.  Any backend.
    :attr bind_lengths: ``(letter, length)`` pairs that override the
        caller's lengths in :func:`~feinsum_tpu_torch.codegen.program.
        build_executable`: the axes of a rewritten program whose lengths the
        original einsum fixes (the flattened M axis of a TC-as-GEMM
        rewrite).
    :attr block_long: elements of the long axis per CUDA thread block.
    :attr accum_dtype, compute_dtype: ``None`` or ``"float32"``: the kernels
        run IEEE fp32 on the CUDA cores.  Anything else raises.
    :attr arg_layouts, out_layout: per-arg / output axis permutations of the
        stored layout; the kernels take one stride per letter, so any
        permutation works (dof-major, long axis stride 1, is the coalesced
        one).
    :attr precision: ``"default"``, ``"highest"`` or ``"float32"``
        (:data:`FP32_PRECISIONS`), all full fp32 (no TF32), or ``"bf16_3x"``
        (:data:`SPLIT_PRECISIONS`); every other value raises.  The name
        ``bf16_3x`` is the reference's, kept so that its facts bind: there
        each in-kernel dot is three bf16 MXU passes over an f32 hi/lo split
        (``feinsum_tpu/ops/kernel_lowering.py::_dot_bf16_3x``).  On the card
        it means three TF32 tensor-core passes over the same split, ``hi =
        tf32(x)``, ``lo = tf32(x - hi)`` and ``lo·hi + hi·lo + hi·hi``
        (about 2**-21 of each product), for the contraction of a dot step:
        the j-dot of a DG row on ``dg_rows_3xtf32``, the K of a TC step on
        ``tc_grid_3xtf32``, and on the plain route every step that
        contracts two float32 operands (``ops.kernels.einsum_3x``, three
        full-fp32 ``torch.einsum`` passes; TF32 matmul is never switched
        on).  Steps the reference computes without a dot keep full fp32:
        rows on ``ew_product_f32``, ``ew_flat_f32``, ``row_reduce_f32`` and
        ``long_reduce_f32``, the ``Σ_s F t`` combine of a DG row, hoisted
        resident steps (the reference runs them at HIGHEST), and float64
        (``dd_rows``).  A program on ``step_block_f32`` or ``tc_steps_f32``
        (the general step algebra of K1, and K2's schedules other than one
        step of two operands) runs in f32 at ``bf16_3x``, under the
        kernel's f32 name: each step's entries are summed one term at a
        time on the CUDA cores, not as a tiled dot.
    :attr dimension_semantics: both ``"parallel"`` and ``"arbitrary"`` are
        accepted; thread blocks always run in parallel.  ``"parallel"`` with
        a contracted long axis raises, as in the reference.
    :attr multiple_results_in_one_kernel: ``True`` launches all rows of a
        batched einsum together (``blockIdx.y`` = row); ``False`` launches
        once per row.
    :attr hoist_resident_steps: ``True`` (the default): on the fused route
        a schedule step that reads no long-axis operand, transitively, is
        evaluated once per call by ``torch.einsum`` on the card (what the
        reference hands to XLA), rows whose hoisted steps read the same
        operands share one result, and each row is planned on the einsum in
        which the hoisted results replace the operands they consumed (curl
        with ``prereduce``: ``R = Σ_r D`` once, then a mass-shaped
        ``dg_rows_f32`` launch with S = 1).  ``False``: the row families'
        kernels compute each row's value from its own operands, whatever
        the step order, and ``step_block_f32`` runs a resident-only step
        once per thread block.
    :attr flatten: with ``backend="pallas"``, K3's route: a single-step,
        contraction-free program of 1-D operands that all carry the
        output's subscript, with no ``arg_layouts`` or ``out_layout``, runs
        ``ew_flat_f32`` (the ``ew_product_f32`` kernel over a flat stream,
        ``block_long`` elements per thread block); any other program raises
        the reference's message.  The plain route ignores it, as the
        reference's does.
    :attr rowcat, rowcat_args: the row-concatenation rewrite: the program
        is one row over a long axis ``rowcat`` times as long, whose
        streamed operands ``rowcat_args`` (``(stacked, (row0, row1,
        ...))``) are stored stacked end to end along the leading long axis
        (:func:`~feinsum_tpu_torch.measure.apply_layouts`); its one output
        is the rows' outputs stacked the same way
        (:func:`~feinsum_tpu_torch.ops.layouts.unpack_output`).
        :func:`~feinsum_tpu_torch.codegen.program.build_executable`
        stretches the long axis by ``rowcat``.  Any backend.
    :attr xla_block_long: with ``backend="xla"``: the schedule runs chunk by
        chunk over this many elements of the long axis, each chunk's rows
        written into a preallocated output (the last chunk is shorter).  It
        bounds the footprint of the intermediates.  The long axis must be an
        output axis; ``pre_layouts`` do not compose with it.  The fused
        route ignores it, as the reference's does.
    :attr dd_pairs: ``True`` with ``backend="pallas"`` stores every float64
        operand and output as a (2, ...) float32 [hi, lo] pair
        (``ops/dd_emitter.py``) and runs the ``dd_rows`` kernel, which
        computes in native FP64 on the card; every operand must be float64.
        With ``backend="xla"`` it raises.
    :attr interpret: ``None`` or ``False``; ``True`` raises (a CUDA kernel
        has no interpret mode; CPU tensors take the plain versions).
    :attr lane_pack, lane_pack_args, kron_args, lane_pack_expand: the
        lane-pack rewrites' storage contract (``tuning/impls/_common.py::
        rewrite_lane_pack`` and ``rewrite_lane_pack_dg``): the program's
        einsum is rewritten so that ``lane_pack`` = g consecutive elements
        share one packed row.  On the card this means:

        * storage: each ``lane_pack_args`` operand (an entry is a name, or
          ``(name, n_lead)`` with the long axis after *n_lead* leading
          axes) is stored (lead..., E/g, g·rest), a free view of the
          row-major tensor (:func:`~feinsum_tpu_torch.measure.
          apply_layouts`), and so is the output (:func:`~feinsum_tpu_torch.
          ops.layouts.unpack_output`; the vecmat variant's is (E/g, g));
          :func:`~feinsum_tpu_torch.codegen.program.build_executable`
          divides the long axis by g and raises when g does not divide it;
        * residents: each ``kron_args`` operand (a name, or ``(name,
          perm)``) arrives in its logical shape and is expanded on the
          card once per call, transposed by *perm*, to the block-diagonal
          kron(I_g, ·) over its last two axes (a vector x to kron(I_g,
          x[:, None])); each ``lane_pack_expand`` entry ``(name, "P", g,
          d, dtype)`` or ``(name, "A", g, s, d, dtype)`` is a 0/1
          expansion matrix built there too.  Callers never pass them;
        * schedule: the packed matvec and vecmat are two-operand matvecs
          over g·d, rows of ``dg_rows_f32`` (``dg_rows_3xtf32`` at
          ``bf16_3x``); the packed DG program runs its three-step schedule
          (``V = u'·T``, ``W = J'·EXP``, the product summed over the shared
          axes) on ``lane_pack_dg_f32`` (``lane_pack_dg_3xtf32``), which
          does the dense kron dots the TPU kernel does, g times the
          multiply-adds of the unpacked row.
    :attr flags: free-form, carried and ignored.

    Fields that raise at any value but their default: ``fold_long``,
    ``preblock_args``, ``mfold`` and ``vmem_limit_bytes`` describe the
    TPU's (8, 128) tiling, its MXU and its VMEM; a Hopper analog, if one
    pays, is tuner work.

    The DG spaces' knobs (``tuning/impls/_common.py::make_dg_space``) on
    the card: ``log2_block``/``blkc128`` set ``block_long``; ``dofmajor``,
    ``split_rows``, ``prereduce`` and ``rowcat`` are searched (each changes
    the launch); ``parallel_grid`` sets ``dimension_semantics``; ``hoist``,
    ``jfold`` and ``host_hoist`` build the reference's schedule and the
    same launch (pinned); ``vmem_idx`` is accepted and ignored, as in
    ``dd_pallas_v0`` and ``tc_gemm_v0`` (no ``vmem_limit_bytes``);
    ``precision_3x`` sets ``precision="bf16_3x"`` (searched where the row
    reaches ``dg_rows_3xtf32``); ``lane_pack_g`` applies a lane-pack
    rewrite with g = 2**lane_pack_g (searched where the reference searches
    it); ``fold``, ``preblock`` and ``mfold`` raise (pinned off).
    """

    backend: str = "xla"
    pre_layouts: tuple = ()
    pre_out_layout: Optional[tuple] = None
    bind_lengths: tuple = ()
    grid_index: Optional[object] = None    # a letter or a tuple of letters
    grid_blocks: tuple = ()
    grid_m: Optional[str] = None
    mstack: bool = False
    block_long: int = 1024
    accum_dtype: Optional[str] = None
    compute_dtype: Optional[str] = None
    arg_layouts: tuple = ()
    out_layout: Optional[tuple] = None
    flatten: bool = False
    fold_long: int = 1
    preblock_args: tuple = ()
    precision: str = "default"
    dimension_semantics: str = "arbitrary"
    hoist_resident_steps: bool = True
    mfold: bool = False
    lane_pack: int = 1
    lane_pack_args: tuple = ()
    kron_args: tuple = ()
    lane_pack_expand: tuple = ()
    rowcat: int = 1
    rowcat_args: tuple = ()
    dd_pairs: bool = False
    xla_block_long: Optional[int] = None
    vmem_limit_bytes: Optional[int] = None
    interpret: Optional[bool] = None
    multiple_results_in_one_kernel: bool = True
    flags: tuple = field(default_factory=tuple)

    def __post_init__(self):
        for name in ("arg_layouts", "grid_blocks", "pre_layouts",
                     "bind_lengths", "rowcat_args", "flags"):
            object.__setattr__(self, name,
                               _freeze_mapping(getattr(self, name)))
        if self.backend not in ("xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")

    def copy(self, **changes) -> "ScheduleDescriptor":
        return replace(self, **changes)

    @property
    def arg_layouts_map(self) -> dict:
        return dict(self.arg_layouts)


# field -> ROADMAP.md item that will bring a non-default value
_UNPORTED = {
    "fold_long": "North star: a TPU (8, 128) tiling knob",
    "preblock_args": "North star: a TPU (8, 128) tiling knob",
    "mfold": "North star: a TPU MXU row-packing knob",
    "vmem_limit_bytes": "North star: a TPU VMEM cap",
}

# fields with a meaning only beside a tuple grid_index
_MULTIGRID_ONLY = ("grid_blocks", "grid_m", "mstack")

FP32_PRECISIONS = ("default", "highest", "float32")
# the reference's 3-pass split dot: three TF32 tensor-core passes here
SPLIT_PRECISIONS = ("bf16_3x",)


def is_split(desc: ScheduleDescriptor) -> bool:
    """Whether *desc* asks for the 3xTF32 split (``bf16_3x``)."""
    return (desc.precision or "default").lower() in SPLIT_PRECISIONS


def check_supported(desc: ScheduleDescriptor) -> None:
    """Raise :class:`InvalidParameterError` for any field value this package
    does not implement (see the :class:`ScheduleDescriptor` docstring)."""
    defaults = ScheduleDescriptor()
    for name, item in _UNPORTED.items():
        if getattr(desc, name) != getattr(defaults, name):
            raise InvalidParameterError(
                f"descriptor.{name}={getattr(desc, name)!r} is not supported"
                f" by feinsum_tpu_torch (ROADMAP: {item})")
    if isinstance(desc.grid_index, tuple):
        if desc.dd_pairs:
            raise InvalidParameterError(
                "a tuple grid_index (the tc_grid_f32 grid) does not compose"
                " with dd_pairs")
    else:
        for name in _MULTIGRID_ONLY:
            if getattr(desc, name) != getattr(defaults, name):
                raise InvalidParameterError(
                    f"descriptor.{name}={getattr(desc, name)!r} needs a"
                    " tuple grid_index (the tc_grid_f32 grid)")
    for name in ("accum_dtype", "compute_dtype"):
        if getattr(desc, name) not in (None, "float32"):
            raise InvalidParameterError(
                f"descriptor.{name}={getattr(desc, name)!r}: only float32"
                " is supported")
    if (desc.precision or "default").lower() not in FP32_PRECISIONS \
            + SPLIT_PRECISIONS:
        raise InvalidParameterError(
            f"precision {desc.precision!r}: only full fp32"
            f" {FP32_PRECISIONS} and the 3xTF32 split {SPLIT_PRECISIONS} are"
            " supported")
    if desc.dimension_semantics not in ("parallel", "arbitrary"):
        raise InvalidParameterError(
            f"unknown dimension_semantics {desc.dimension_semantics!r}")
    if desc.dd_pairs and desc.backend != "pallas":
        raise InvalidParameterError(
            "dd_pairs=True needs backend='pallas' (the dd_rows kernel)")
    if desc.interpret:
        raise InvalidParameterError(
            "interpret=True: CUDA kernels have no interpret mode")
    if desc.block_long < 1:
        raise InvalidParameterError(
            f"block_long must be positive, got {desc.block_long}")
    if desc.xla_block_long is not None and desc.xla_block_long < 1:
        raise InvalidParameterError(
            f"xla_block_long must be positive, got {desc.xla_block_long}")
    if desc.rowcat < 1 or (desc.rowcat > 1) != bool(desc.rowcat_args):
        raise InvalidParameterError(
            f"rowcat={desc.rowcat} needs rowcat_args (and they need"
            " rowcat > 1)")
    if desc.lane_pack < 1 or (desc.lane_pack > 1) != bool(
            desc.lane_pack_args) or (desc.lane_pack == 1 and (
                desc.kron_args or desc.lane_pack_expand)):
        raise InvalidParameterError(
            f"lane_pack={desc.lane_pack} needs lane_pack_args (and they,"
            " kron_args and lane_pack_expand need lane_pack > 1)")
