"""
The 3D DG wave operator, the flagship workload (the port of
``feinsum_tpu.models.wave``).

First-order acoustic wave system on E curved tetrahedral elements with P
volume dofs and F faces x Pf face dofs:

    dv/dt = grad(u):   v'[x,e,i] += dt * sum_{r,j} J[x,r,e] D[r,i,j] u[e,j]
    du/dt = div(v):    u'[e,i]   += dt * sum_{x,r,j} J[x,r,e] D[r,i,j] v[x,e,j]
                              + face lift: sum_{f,j} L[e,f,j] flux[f,e,j]
    flux from the state:         flux[f,e,j] = sum_i R[f,j,i] u[e,i]

The face flux is computed from the state each step by the face-restriction
einsum (a matvec whose resident carries both output letters but e,
``dg_rows_f32`` over the merged (f, j)).  Every einsum runs through the
transform-database machinery: the archive is consulted for the best
schedule on the device (``db_path``), with the reference's default on the
fused kernels otherwise (at ``suite.BLOCK_LONG`` elements per thread block,
the H100's), and state and geometry stay dof-major end to end.  Everything
between the einsums' outputs and the new state is one pass per state
tensor written (``ops.kernels.step_update``).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .. import sql_utils, tracing
from ..cl_utils import default_device
from ..codegen.program import (
    EinsumProgram,
    build_executable,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from ..diagnostics import InvalidParameterError, NoFactInDatabaseError
from ..make_einsum import array, batched_einsum, einsum
from ..ops import kernels
from ..ops.layouts import dofmajor_layouts
from ..suite import BLOCK_LONG

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
    """*t* (float64) as its (2, ...) float32 hi/lo pair: the span
    ``feinsum.pairs:split``, and 16 bytes an entry (the float64 read, the
    pair written) added to ``tracing.counters["pair_bytes"]``."""
    # imported here, as ``build_executable`` imports the emitters, so that
    # importing the package does not import them
    from ..ops.dd_emitter import split_to_pairs
    with tracing.span("feinsum.pairs:split"):
        out = split_to_pairs(t)
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


class GeometryPairs:
    """The geometry's pairs for a step on pair storage, split once: a
    geometry tensor is split again only when the step is given another
    tensor under its name, or the same one written in place (its
    ``_version`` moved).  It holds the last tensor split under each name
    and its pair."""

    def __init__(self, names: tuple) -> None:
        self.names = names
        self._held: dict = {}

    def __call__(self, geom: dict) -> dict:
        out = {}
        for name in self.names:
            t = geom[name]
            held = self._held.get(name)
            if held is None or held[0] is not t or held[1] != t._version:
                held = self._held[name] = (t, t._version, to_pairs(t))
            out[name] = held[2]
        return out


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


class WaveOperator3D(torch.nn.Module):
    """DG wave operator over ``n_elements`` elements at the polynomial
    order giving ``ndof`` volume dofs and ``(nfaces, nfacedof)`` face dofs.
    It holds its four programs (grad, div, face lift, face restriction);
    ``make_step`` builds the step on dof-major tensors."""

    def __init__(self, *, ndof: int = 35, nfacedof: int = 15,
                 nfaces: int = 4, dtype: str = "float32",
                 use_pallas: bool = True, block_long: int = BLOCK_LONG,
                 db_path: Optional[str] = None, device=None) -> None:
        super().__init__()
        self.ndof = ndof
        self.nfacedof = nfacedof
        self.nfaces = nfaces
        self.dtype = np.dtype(dtype)
        d = dtype

        self.grad_einsum = einsum(
            "xre,rij,ej->xei",
            array("J", (3, 3, "E"), d),
            array("D", (3, ndof, ndof), d),
            array("u", ("E", ndof), d))
        self.div_einsum = batched_einsum(
            "es,sij,ej->ei",
            [[array(f"J{x}", ("E", 3), d), array("D", (3, ndof, ndof), d),
              array(f"v{x}", ("E", ndof), d)] for x in "xyz"])
        self.face_einsum = einsum(
            "ifj,fe,fej->ei",
            array("L", (ndof, nfaces, nfacedof), d),
            array("Fj", (nfaces, "E"), d),
            array("flux", (nfaces, "E", nfacedof), d))
        self.restrict_einsum = einsum(
            "fji,ei->fej",
            array("R", (nfaces, nfacedof, ndof), d),
            array("u", ("E", ndof), d))
        self.programs = {
            name: archived_or_default(e, db_path=db_path, device=device,
                                      use_pallas=use_pallas,
                                      block_long=block_long)
            for name, e in [("grad", self.grad_einsum),
                            ("div", self.div_einsum),
                            ("face", self.face_einsum),
                            ("restrict", self.restrict_einsum)]}
        self.pairs = on_pairs(self.programs.values())

    def executables(self, n_elements: int) -> dict:
        return {name: build_executable(p, long_dim_length=n_elements)
                for name, p in self.programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing (u, v) one
        explicit-Euler step of the wave system, on dof-major tensors: u
        (P, E), v (3, P, E); geometry as :func:`make_wave_state` lays it
        out.  On pair storage the same, in float64: the einsums read u, v
        and the geometry as pairs (the geometry split once), and the
        update reads their outputs' pairs.  Each state tensor is written
        by one pass of :func:`~feinsum_tpu_torch.ops.kernels.
        step_update` (:func:`state_update`)."""
        fns = self.executables(n_elements)
        name = f"feinsum.step:{type(self).__name__}"
        update = state_update(self.programs.values())
        geom_pairs = GeometryPairs(("J", "Jx", "Jy", "Jz", "D", "L", "Fj",
                                    "Rface")) if self.pairs else None

        def step(state, geom):
            with tracing.span(name):
                tracing.counters["model_steps"] += 1
                u, v = state["u"], state["v"]
                if geom_pairs is None:
                    g, us, vs = geom, u, list(v)
                else:
                    g, us, vp = geom_pairs(geom), to_pairs(u), to_pairs(v)
                    vs = [vp[:, x] for x in range(3)]   # (2, P, E) each
                (grad_u,) = fns["grad"]({"J": g["J"], "D": g["D"], "u": us})
                vx, vy, vz = fns["div"]({
                    "Jx": g["Jx"], "Jy": g["Jy"], "Jz": g["Jz"],
                    "D": g["D"], "vx": vs[0], "vy": vs[1], "vz": vs[2]})
                # the flux from the state, stored (F, Pf, E): the layout the
                # face program streams
                (flux,) = fns["restrict"]({"R": g["Rface"], "u": us})
                (lift,) = fns["face"]({"L": g["L"], "Fj": g["Fj"],
                                       "flux": flux})
                # u + dt * (((vx + vy) + vz) + lift); v + dt * grad_u, the
                # grad out (x, P, E), on pairs (2, x, P, E), split by x
                return {"u": update(u, [vx, vy, vz, lift], dt),
                        "v": update(v, [grad_u.unbind(-3)], dt)}

        return step

    def forward(self, state: dict, geom: dict, dt: float = 1e-3) -> dict:
        """One step at the state's number of elements."""
        return self.make_step(int(state["u"].shape[-1]), dt)(state, geom)

    def layouts(self) -> dict:
        """arg name -> stored-axis permutation, across all programs."""
        out = {}
        for p in self.programs.values():
            out.update(p.descriptor.arg_layouts_map)
        return out


def _to_device(arrays: dict, dtype, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=dtype)).to(
        device) for k, v in arrays.items()}


def state_from_reference(state: dict, geom: dict, device=None) -> tuple:
    """The reference's ``(state, geometry)`` (numpy arrays, or anything
    ``numpy.asarray`` reads) as tensors on *device* (default: the current
    CUDA card; it raises without one unless ``device="cpu"``)."""
    device = default_device(device, caller="state_from_reference")

    def conv(d):
        return {k: torch.from_numpy(np.array(v)).to(device)
                for k, v in d.items()}
    return conv(state), conv(geom)


def make_wave_state(n_elements: int, *, ndof: int = 35, nfacedof: int = 15,
                    nfaces: int = 4, dtype: str = "float32", seed: int = 0,
                    device=None) -> tuple:
    """(state, geometry) dicts of random data in the model's dof-major
    layouts: u (P, E), v (3, P, E), per-component Jacobians (3, E), the
    face-restriction matrix ``Rface`` (F, Pf, P).  The numbers are those of
    ``feinsum_tpu.models.make_wave_state`` for the same seed (numpy's
    ``default_rng(seed)``, drawn in its order), on *device* (default: the
    current CUDA card; it raises without one unless ``device="cpu"``)."""
    device = default_device(device, caller="make_wave_state")
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.random(shape)

    state = {"u": arr(ndof, n_elements),
             "v": arr(3, ndof, n_elements)}
    geom = {"J": arr(3, 3, n_elements),
            "Jx": arr(3, n_elements),
            "Jy": arr(3, n_elements),
            "Jz": arr(3, n_elements),
            "D": arr(3, ndof, ndof),
            "L": arr(nfaces, ndof, nfacedof),
            "Fj": arr(nfaces, n_elements),
            "Rface": arr(nfaces, nfacedof, ndof)}
    return (_to_device(state, dtype, device), _to_device(geom, dtype, device))
