"""
3D DG Maxwell (the source-free curl-curl system), the curl-family flagship
(the port of ``feinsum_tpu.models.maxwell``).

Non-dimensionalized source-free Maxwell on E curved tetrahedral elements:

    dE/dt =  curl(H)        dH/dt = -curl(E)

with the DG curl on curved elements (chain rule through the metric columns
J_b[r, e] = d xi_r / d x_b):

    (curl F)_a[e, i] = eps_{abc} * sum_{r,j} J_b[e, r] D[r, i, j] F_c[e, j]

one batched einsum with six div-class rows (+y z, -z y, +z x, -x z, +x y,
-y x) sharing D and the metric columns, so one launch of ``dg_rows_f32``
streams every operand once per curl and the +/- pairing happens on the
outputs.  As in the wave model, the archive is consulted (``db_path``) with
the reference's default otherwise, and state and geometry are dof-major.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..cl_utils import default_device
from ..codegen.program import build_executable
from ..make_einsum import array, batched_einsum
from .wave import _to_device, archived_or_default

# six rows of the cross product: (metric column, source component); rows
# 2k / 2k+1 are the +/- halves of curl component k (x, y, z)
_CURL_ROWS = (("Jy", "Fz"), ("Jz", "Fy"),
              ("Jz", "Fx"), ("Jx", "Fz"),
              ("Jx", "Fy"), ("Jy", "Fx"))


class MaxwellOperator3D(torch.nn.Module):
    """DG Maxwell curl operator over ``n_elements`` curved elements with
    ``ndof`` volume dofs per field component; it holds the curl program."""

    def __init__(self, *, ndof: int = 35, dtype: str = "float32",
                 use_pallas: bool = True, block_long: int = 4096,
                 db_path: Optional[str] = None, device=None) -> None:
        super().__init__()
        self.ndof = ndof
        self.dtype = np.dtype(dtype)
        d = dtype
        self.curl_einsum = batched_einsum(
            "es,sij,ej->ei",
            [[array(jb, ("E", 3), d),
              array("D", (3, ndof, ndof), d),
              array(fc, ("E", ndof), d)]
             for jb, fc in _CURL_ROWS])
        self.program = archived_or_default(
            self.curl_einsum, db_path=db_path, device=device,
            use_pallas=use_pallas, block_long=block_long)

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing (E, H) one
        explicit-Euler step, on dof-major tensors: E/H (3, P, E)."""
        fn = build_executable(self.program, long_dim_length=n_elements)

        def curl(field, geom):
            rows = fn({"Jx": geom["Jx"], "Jy": geom["Jy"],
                       "Jz": geom["Jz"], "D": geom["D"],
                       "Fx": field[0], "Fy": field[1], "Fz": field[2]})
            return torch.stack([rows[0] - rows[1],
                                rows[2] - rows[3],
                                rows[4] - rows[5]])

        def step(state, geom):
            e, h = state["E"], state["H"]
            new_e = e + dt * curl(h, geom)
            new_h = h - dt * curl(e, geom)
            return {"E": new_e, "H": new_h}

        return step

    def forward(self, state: dict, geom: dict, dt: float = 1e-3) -> dict:
        """One step at the state's number of elements."""
        return self.make_step(int(state["E"].shape[-1]), dt)(state, geom)


def make_maxwell_state(n_elements: int, *, ndof: int = 35,
                       dtype: str = "float32", seed: int = 0,
                       device=None) -> tuple:
    """(state, geometry) dicts of random data in the model's dof-major
    layouts: E/H (3, P, E), metric columns (3, E), D (3, P, P); the numbers
    of ``feinsum_tpu.models.make_maxwell_state`` for the same seed, on
    *device* (default: the current CUDA card; it raises without one unless
    ``device="cpu"``)."""
    device = default_device(device, caller="make_maxwell_state")
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.random(shape)

    state = {"E": arr(3, ndof, n_elements), "H": arr(3, ndof, n_elements)}
    geom = {"Jx": arr(3, n_elements), "Jy": arr(3, n_elements),
            "Jz": arr(3, n_elements), "D": arr(3, ndof, ndof)}
    return (_to_device(state, dtype, device), _to_device(geom, dtype, device))
