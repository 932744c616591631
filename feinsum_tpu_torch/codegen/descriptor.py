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
        fused hand-written CUDA kernels (``ops/cuda_emitter.py``).  The fused
        kernels compute each row's value, not the schedule's step order: the
        div schedule ``ej,es->ejs; ejs,sij->ei`` and the kernel's direct sum
        ``Σ_s J[e,s] Σ_j R[s,i,j] u[e,j]`` agree up to rounding.
    :attr grid_index: ``None`` or the unique parametric letter.  A tuple of
        letters (the multi-axis dense-contraction grid, kernel K2 in
        ROADMAP.md) raises.
    :attr block_long: elements of the long axis per CUDA thread block.
    :attr accum_dtype, compute_dtype: ``None`` or ``"float32"``: the kernels
        run IEEE fp32 on the CUDA cores.  Anything else raises.
    :attr arg_layouts, out_layout: per-arg / output axis permutations of the
        stored layout; the kernels take one stride per letter, so any
        permutation works (dof-major, long axis stride 1, is the coalesced
        one).
    :attr precision: ``"default"``, ``"highest"`` or ``"float32"``, all full
        fp32 (no TF32).  ``"bf16_3x"`` and every other value raise.
    :attr dimension_semantics: both ``"parallel"`` and ``"arbitrary"`` are
        accepted; thread blocks always run in parallel.  ``"parallel"`` with
        a contracted long axis raises, as in the reference.
    :attr multiple_results_in_one_kernel: ``True`` launches all rows of a
        batched einsum together (``blockIdx.y`` = row); ``False`` launches
        once per row.
    :attr hoist_resident_steps: accepted at both values; a schedule step
        that reads no long-axis operand raises on the fused route either way
        (the hoisted-step path is not ported yet).
    :attr dd_pairs: ``True`` with ``backend="pallas"`` stores every float64
        operand and output as a (2, ...) float32 [hi, lo] pair
        (``ops/dd_emitter.py``) and runs the ``dd_rows`` kernel, which
        computes in native FP64 on the card; every operand must be float64.
        With ``backend="xla"`` it raises.
    :attr interpret: ``None`` or ``False``; ``True`` raises (a CUDA kernel
        has no interpret mode; CPU tensors take the plain versions).
    :attr flags: free-form, carried and ignored.

    Fields that raise at any value but their default, with the ROADMAP.md
    item that will bring them: ``pre_layouts``, ``pre_out_layout`` and
    ``bind_lengths`` (the TC-as-GEMM rewrites, queue 1 item 8);
    ``grid_blocks``, ``grid_m``, ``mstack`` (K2); ``flatten`` (K3);
    ``lane_pack``, ``lane_pack_args``, ``kron_args``,
    ``lane_pack_expand`` and ``rowcat``/``rowcat_args`` (the lane-pack and
    row-concatenation rewrites, queue 1 item 3); ``xla_block_long`` (the
    chunked route, queue 1 item 3).  ``fold_long``, ``preblock_args``,
    ``mfold`` and ``vmem_limit_bytes`` describe the TPU's (8, 128) tiling,
    its MXU and its VMEM; a Hopper analog, if one pays, is tuner work.
    """

    backend: str = "xla"
    pre_layouts: tuple = ()
    pre_out_layout: Optional[tuple] = None
    bind_lengths: tuple = ()
    grid_index: Optional[str] = None
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
    "pre_layouts": "queue 1 item 8 (TC-as-GEMM rewrites)",
    "pre_out_layout": "queue 1 item 8 (TC-as-GEMM rewrites)",
    "bind_lengths": "queue 1 item 8 (TC-as-GEMM rewrites)",
    "grid_blocks": "queue 2 K2 (multi-axis grid)",
    "grid_m": "queue 2 K2 (multi-axis grid)",
    "mstack": "queue 2 K2 (multi-axis grid)",
    "flatten": "queue 2 K3 (flat elementwise)",
    "lane_pack": "queue 1 item 3 (lane-pack rewrite)",
    "lane_pack_args": "queue 1 item 3 (lane-pack rewrite)",
    "kron_args": "queue 1 item 3 (lane-pack rewrite)",
    "lane_pack_expand": "queue 1 item 3 (lane-pack rewrite)",
    "rowcat": "queue 1 item 3 (row-concatenation rewrite)",
    "rowcat_args": "queue 1 item 3 (row-concatenation rewrite)",
    "xla_block_long": "queue 1 item 3 (chunked XLA route)",
    "fold_long": "North star: a TPU (8, 128) tiling knob",
    "preblock_args": "North star: a TPU (8, 128) tiling knob",
    "mfold": "North star: a TPU MXU row-packing knob",
    "vmem_limit_bytes": "North star: a TPU VMEM cap",
}

FP32_PRECISIONS = ("default", "highest", "float32")


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
        raise InvalidParameterError(
            "a tuple grid_index (multi-axis grid) is not supported"
            " (ROADMAP: queue 2 K2)")
    for name in ("accum_dtype", "compute_dtype"):
        if getattr(desc, name) not in (None, "float32"):
            raise InvalidParameterError(
                f"descriptor.{name}={getattr(desc, name)!r}: only float32"
                " is supported")
    if (desc.precision or "default").lower() not in FP32_PRECISIONS:
        raise InvalidParameterError(
            f"precision {desc.precision!r}: only full fp32"
            f" {FP32_PRECISIONS} is supported")
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
