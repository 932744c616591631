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
the reference's default otherwise (``suite.BLOCK_LONG`` elements per
thread block), and state and geometry are dof-major.  Each field's update,
``F ± dt (rows[2k] - rows[2k+1])`` for its three components, is one launch
of ``ops.kernels.step_update`` writing the new (3, P, E) field (on the
plain per-step route its plain version, ``common.state_update``).  At float64
the curl runs on pair storage (``dd_rows``) as the wave model's einsums do:
the step splits E and H into pairs once each and the update reads the six
rows' pairs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..cl_utils import default_device
from ..codegen.program import build_executable
from ..make_einsum import array, batched_einsum
from ..suite import BLOCK_LONG
from .common import StepStorage, archived_or_default, on_pairs, to_device

# six rows of the cross product: (metric column, source component); rows
# 2k / 2k+1 are the +/- halves of curl component k (x, y, z)
_CURL_ROWS = (("Jy", "Fz"), ("Jz", "Fy"),
              ("Jz", "Fx"), ("Jx", "Fz"),
              ("Jx", "Fy"), ("Jy", "Fx"))


class MaxwellOperator3D(torch.nn.Module):
    """DG Maxwell curl operator over ``n_elements`` curved elements with
    ``ndof`` volume dofs per field component; it holds the curl program."""

    def __init__(self, *, ndof: int = 35, dtype: str = "float32",
                 use_pallas: bool = True, block_long: int = BLOCK_LONG,
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
        self.pairs = on_pairs([self.program])

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing (E, H) one
        explicit-Euler step, on dof-major tensors: E/H (3, P, E); on pair
        storage the same, in float64 (module docstring)."""
        fn = build_executable(self.program, long_dim_length=n_elements,
                              name="curl")
        name = f"feinsum.step:{type(self).__name__}"
        storage = StepStorage([self.program], ("Jx", "Jy", "Jz", "D"))

        def curl_update(base, field, g, dt):
            """``base + dt * curl(field)``: the curl's six rows, then one
            pass over the three components, rows 2k and 2k + 1 the +/-
            terms of component k."""
            fs = storage.components(storage.state(field))
            rows = fn({"Jx": g["Jx"], "Jy": g["Jy"], "Jz": g["Jz"],
                       "D": g["D"], "Fx": fs[0], "Fy": fs[1], "Fz": fs[2]})
            return storage.update(base, [rows[0::2], rows[1::2]], dt,
                                  signs=(1, -1))

        def step(state, geom):
            with tracing.span(name):
                tracing.counters["model_steps"] += 1
                e, h = state["E"], state["H"]
                g = storage.geometry(geom)
                return {"E": curl_update(e, h, g, dt),
                        "H": curl_update(h, e, g, -dt)}

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
    return (to_device(state, dtype, device), to_device(geom, dtype, device))
