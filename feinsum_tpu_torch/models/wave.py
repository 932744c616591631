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

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..cl_utils import default_device
from ..codegen.program import build_executable
from ..make_einsum import array, batched_einsum, einsum
from ..suite import BLOCK_LONG
from .common import StepStorage, archived_or_default, on_pairs, to_device


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
        return {name: build_executable(p, long_dim_length=n_elements,
                                       name=name)
                for name, p in self.programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing (u, v) one
        explicit-Euler step of the wave system, on dof-major tensors: u
        (P, E), v (3, P, E); geometry as :func:`make_wave_state` lays it
        out.  On pair storage the same, in float64: the einsums read u, v
        and the geometry as pairs (the geometry split once), and the
        update reads their outputs' pairs (:class:`~feinsum_tpu_torch.
        models.common.StepStorage`).  Each state tensor is written by one
        pass of :func:`~feinsum_tpu_torch.ops.kernels.step_update`."""
        fns = self.executables(n_elements)
        name = f"feinsum.step:{type(self).__name__}"
        storage = StepStorage(self.programs.values(),
                              ("J", "Jx", "Jy", "Jz", "D", "L", "Fj",
                               "Rface"))

        def step(state, geom):
            with tracing.span(name):
                tracing.counters["model_steps"] += 1
                u, v = state["u"], state["v"]
                g, us = storage.geometry(geom), storage.state(u)
                vs = storage.components(storage.state(v))
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
                return {"u": storage.update(u, [vx, vy, vz, lift], dt),
                        "v": storage.update(v, [grad_u.unbind(-3)], dt)}

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
    return (to_device(state, dtype, device), to_device(geom, dtype, device))
