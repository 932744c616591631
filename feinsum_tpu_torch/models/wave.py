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
fused kernels otherwise, and state and geometry stay dof-major end to end.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import sql_utils
from ..cl_utils import default_device
from ..codegen.program import (
    EinsumProgram,
    build_executable,
    generate_program,
    generate_program_with_opt_einsum_schedule,
)
from ..diagnostics import NoFactInDatabaseError
from ..make_einsum import array, batched_einsum, einsum
from ..ops.layouts import dofmajor_layouts


def _default_transform(program: EinsumProgram, *, use_pallas: bool,
                       block_long: int) -> EinsumProgram:
    """The reference's default: the optimal-path schedule on the fused
    kernels (``backend="pallas"``), *block_long* elements per thread block
    and ``"parallel"`` semantics; with ``use_pallas=False`` the plain
    per-step route."""
    p = generate_program_with_opt_einsum_schedule(program.einsum)
    if use_pallas:
        p = p.with_descriptor(backend="pallas", block_long=block_long,
                              dimension_semantics="parallel")
    return p


def archived_or_default(e, *, db_path, device, use_pallas: bool,
                        block_long: int) -> EinsumProgram:
    """*e*'s program: the archive's best schedule for *device* when
    *db_path* holds one, else :func:`_default_transform`; then pinned to the
    models' dof-major storage (the schedule, backend and block size carry
    over, the archive's storage choices do not)."""
    program = generate_program(e)
    transform = None
    if db_path is not None:
        try:
            transform = sql_utils.retrieve(e, device, db_path=db_path)
        except NoFactInDatabaseError:
            transform = None
    if transform is not None:
        program = transform(program)
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
                 use_pallas: bool = True, block_long: int = 4096,
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

    def executables(self, n_elements: int) -> dict:
        return {name: build_executable(p, long_dim_length=n_elements)
                for name, p in self.programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing (u, v) one
        explicit-Euler step of the wave system, on dof-major tensors: u
        (P, E), v (3, P, E); geometry as :func:`make_wave_state` lays it
        out."""
        fns = self.executables(n_elements)

        def step(state, geom):
            u, v = state["u"], state["v"]
            (grad_u,) = fns["grad"]({"J": geom["J"], "D": geom["D"], "u": u})
            vx, vy, vz = fns["div"]({
                "Jx": geom["Jx"], "Jy": geom["Jy"], "Jz": geom["Jz"],
                "D": geom["D"], "vx": v[0], "vy": v[1], "vz": v[2]})
            div_v = vx + vy + vz                      # (P, E)
            # the flux from the state, stored (F, Pf, E): the layout the
            # face program streams
            (flux,) = fns["restrict"]({"R": geom["Rface"], "u": u})
            (lift,) = fns["face"]({"L": geom["L"], "Fj": geom["Fj"],
                                   "flux": flux})
            new_v = v + dt * grad_u                   # grad out: (x, P, E)
            new_u = u + dt * (div_v + lift)
            return {"u": new_u, "v": new_v}

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
