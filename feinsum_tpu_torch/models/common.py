"""
What the models share: each einsum's program (the archive's schedule, or
the reference's default, pinned to dof-major storage) and the storage a
step runs on, float32 or, in the DG models, float64 on float32 hi/lo pairs
(``dd_rows``), chosen once per step by :class:`StepStorage`, so that a
model's step body holds its einsums and its update and no storage branch of
its own.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from .. import sql_utils, tracing
from ..codegen.program import (
    EinsumProgram,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from ..diagnostics import InvalidParameterError, NoFactInDatabaseError
from ..ops import kernels
from ..ops.layouts import dofmajor_layouts

# the spaces' storage knobs: how an archived schedule wants its arrays
# stored (the TPU's fold-8 storage and (8, 128) tile blocks)
STORAGE_KNOBS = ("fold", "preblock")


def _default_transform(program: EinsumProgram, *, use_pallas: bool,
                       block_long: int) -> EinsumProgram:
    """The reference's default: the optimal-path schedule on the fused
    kernels (``backend="pallas"``), *block_long* elements per thread block
    and ``"parallel"`` semantics, on pair storage (``dd_pairs``, the
    ``dd_rows`` kernel) when every operand is float64; with
    ``use_pallas=False`` the plain per-step route."""
    p = generate_program_with_opt_einsum_schedule(program.einsum)
    if use_pallas:
        f64 = {str(dt) for dt in p.einsum.arg_to_dtype.values()} \
            == {"float64"}
        p = p.with_descriptor(backend="pallas", block_long=block_long,
                              dimension_semantics="parallel", dd_pairs=f64)
    return p


def archived_or_default(e, *, db_path, device, use_pallas: bool,
                        block_long: int) -> EinsumProgram:
    """*e*'s program: the archive's best schedule for *device* when
    *db_path* holds one, else :func:`_default_transform`; then pinned to the
    models' dof-major storage.  The schedule, backend, block size and
    precision carry over, the archive's storage choices do not: the fact is
    bound with its :data:`STORAGE_KNOBS` off (the reference resets the
    ``fold_long`` and ``preblock_args`` they set), so a fact that sets them
    replays here too.  A lane-pack fact (``lane_pack_g`` > 0) rewrites the
    einsum itself to packed operands, which the models' dof-major state is
    not: it raises :class:`InvalidParameterError` here, where the
    reference's models bind it and fail in their step on the shapes."""
    program = generate_program(e)
    fact = None
    if db_path is not None:
        try:
            fact = sql_utils.aggregate_reconfirmations(
                sql_utils.query(e, device, db_path=db_path))[0]
        except NoFactInDatabaseError:
            fact = None
    if fact is not None:
        params = tuple((k, False if k in STORAGE_KNOBS else v)
                       for k, v in fact.transform_params)
        program = replace(fact, transform_params=params).transform(program)
        if program.descriptor.lane_pack > 1:
            raise InvalidParameterError(
                f"the archived {fact.transform_id} fact for"
                f" {e.get_subscripts()} sets lane_pack_g (g ="
                f" {program.descriptor.lane_pack}): its packed operands do"
                " not fit the model's dof-major state")
    else:
        program = _default_transform(program, use_pallas=use_pallas,
                                     block_long=block_long)
    layouts, out_perm = dofmajor_layouts(e)
    return program.with_descriptor(arg_layouts=layouts, out_layout=out_perm)


def on_pairs(programs) -> bool:
    """Whether a model's programs run on pair storage (``dd_pairs``): all
    of them or none, since a step converts its state at one boundary;
    raises :class:`InvalidParameterError` for a mix (an archive with pair
    facts for only some of the model's einsums)."""
    kinds = {p.descriptor.dd_pairs for p in programs}
    if len(kinds) != 1:
        raise InvalidParameterError(
            "the model's programs mix pair storage (dd_pairs) with other"
            " routes; its step converts the state at one boundary")
    return kinds.pop()


def to_pairs(t: torch.Tensor) -> torch.Tensor:
    """*t* (float64) as its (2, ...) float32 hi/lo pair, one pass of
    :func:`~feinsum_tpu_torch.ops.kernels.pairs_split` on a contiguous
    tensor, and 16 bytes an entry (the float64 read, the pair written)
    added to ``tracing.counters["pair_bytes"]``."""
    out = kernels.pairs_split(t.contiguous())
    tracing.counters["pair_bytes"] += 16 * t.numel()
    return out


def state_update(programs):
    """The step's state update for a model with these programs:
    ``kernels.step_update`` when an einsum runs on the fused kernels, else
    (the plain per-step route) its plain version, so that route runs no
    hand-written kernel."""
    if any(p.descriptor.backend == "pallas" for p in programs):
        return kernels.step_update
    return kernels.step_update_plain


class HeldGeometry:
    """What a step derives from its geometry tensors under *names*
    (``derive(t)``: a tensor's pair on pair storage, the hexahedral
    model's axis factors), derived once: a geometry tensor is derived again
    only when the step is given another tensor under its name, or the same
    one written in place (its ``_version`` moved).  It holds the last
    tensor derived under each name and what came of it."""

    def __init__(self, names: tuple, derive) -> None:
        self.names = names
        self._derive = derive
        self._held: dict = {}

    def __call__(self, geom: dict) -> dict:
        out = {}
        for name in self.names:
            t = geom[name]
            held = self._held.get(name)
            if held is None or held[0] is not t or held[1] != t._version:
                held = self._held[name] = (t, t._version, self._derive(t))
            out[name] = held[2]
        return out


class StepStorage:
    """The storage of one model step, chosen once from its programs
    (:func:`on_pairs`, :func:`state_update`) and read by the step body:
    the geometry and a state tensor as the einsums read them (themselves,
    or on pair storage their pairs, the geometry's split once by
    :class:`HeldGeometry` under *geometry_names*), a state tensor's
    per-component views (``t[x]``, or ``pair[:, x]``), and the update
    (``update(base, terms, dt, signs=None)``), which takes the einsums'
    outputs in either storage."""

    def __init__(self, programs, geometry_names: tuple) -> None:
        programs = list(programs)
        self.pairs = on_pairs(programs)
        self.update = state_update(programs)
        self._geometry = HeldGeometry(geometry_names, to_pairs) \
            if self.pairs else None

    def geometry(self, geom: dict) -> dict:
        return geom if self._geometry is None else self._geometry(geom)

    def state(self, t: torch.Tensor) -> torch.Tensor:
        return to_pairs(t) if self.pairs else t

    def components(self, t: torch.Tensor) -> list:
        """The views of :meth:`state`'s tensor *t* by its leading state
        axis (the component x of a (3, P, E) field)."""
        return list(t.unbind(1 if self.pairs else 0))


def to_device(arrays: dict, dtype, device) -> dict:
    """*arrays* (numpy) as contiguous tensors of *dtype* on *device*."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=dtype)).to(
        device) for k, v in arrays.items()}
