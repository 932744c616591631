"""Plain reference and input draw of ``maxwell3d_p4.json``: the Maxwell
step's increments in plain PyTorch, on the model's dof-major tensors.

    curl(F)_a[i,e] = eps_abc sum_{s,j} J_b[s,e] D[s,i,j] F_c[j,e]
    new E = E + dt * curl(H),  new H = H - dt * curl(E)

as six rows (+y z, -z y, +z x, -x z, +x y, -y x) paired on the outputs,
in the order the model pairs them.
"""

from __future__ import annotations

import math

import torch

from plain import einsum

# (metric column, source component) of the six rows; rows 2k, 2k+1 are
# the + and - halves of curl component k
CURL_ROWS = (("Jy", 2), ("Jz", 1), ("Jz", 0), ("Jx", 2), ("Jx", 1),
             ("Jy", 0))


def make_inputs(cfg: dict, n: int, gen: torch.Generator, device) -> tuple:
    """``(state, geometry)`` drawn from *gen* on *device* (the draw that
    ``assumed.draw`` in the configuration states)."""
    P = cfg["ndof"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    g = randn(3, P, P)
    D = (g - g.transpose(1, 2)) / math.sqrt(2 * P)
    J = randn(3, 3, n) / math.sqrt(3)
    geom = {"Jx": J[0].clone(), "Jy": J[1].clone(), "Jz": J[2].clone(),
            "D": D}
    state = {"E": randn(3, P, n), "H": randn(3, P, n)}
    return state, geom


def _curl(field: torch.Tensor, geom: dict, tf32: bool) -> torch.Tensor:
    dfield = [einsum("sij,je->sie", geom["D"], field[c], tf32)
              for c in range(3)]
    rows = [einsum("se,sie->ie", geom[jb], dfield[c], tf32)
            for jb, c in CURL_ROWS]
    return torch.stack([rows[0] - rows[1], rows[2] - rows[3],
                        rows[4] - rows[5]])


def increments(cfg: dict, state: dict, geom: dict, tf32: bool = False
               ) -> dict:
    """The step's float32 increments ``{"E": dt * curl(H), "H": -(dt *
    curl(E))}``; with *tf32*, the control's."""
    dt = cfg["dt"]
    return {"E": dt * _curl(state["H"], geom, tf32),
            "H": -(dt * _curl(state["E"], geom, tf32))}
