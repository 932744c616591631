"""Plain reference and input draw of ``wave3d_p4.json``: the wave step's
increments in plain PyTorch, on the model's dof-major tensors.

    grad:      g[x,i,e] = sum_{r,j} J[x,r,e] D[r,i,j] u[j,e]
    div:       d[i,e]   = sum_x sum_{s,j} Jx[s,e] D[s,i,j] v[x,j,e]
    restrict:  flux[f,j,e] = sum_i R[f,j,i] u[i,e]
    lift:      l[i,e]   = sum_{f,j} L[f,i,j] Fj[f,e] flux[f,j,e]
    new u = u + dt * (d + l),  new v = v + dt * g

The increments are summed in the order the model sums them (its three div
rows first, then the lift), so that a sound step differs from them only
by the einsums' own rounding.
"""

from __future__ import annotations

import math

import torch

from plain import einsum


def make_inputs(cfg: dict, n: int, gen: torch.Generator, device) -> tuple:
    """``(state, geometry)`` drawn from *gen* on *device* (the draw that
    ``assumed.draw`` in the configuration states)."""
    P, Pf, F = cfg["ndof"], cfg["nfacedof"], cfg["nfaces"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    g = randn(3, P, P)
    D = (g - g.transpose(1, 2)) / math.sqrt(2 * P)
    J = randn(3, 3, n) / math.sqrt(3)
    R = randn(F, Pf, P) / math.sqrt(P)
    L = randn(F, P, Pf) / math.sqrt(F * Pf)
    Fj = 0.5 + torch.rand((F, n), generator=gen, device=device)
    for f in range(0, F - 1, 2):
        R[f + 1] = L[f].T
        L[f + 1] = -R[f].T
        Fj[f + 1] = Fj[f]
    geom = {"J": J, "Jx": J[0].clone(), "Jy": J[1].clone(),
            "Jz": J[2].clone(), "D": D, "L": L.contiguous(), "Fj": Fj,
            "Rface": R.contiguous()}
    state = {"u": randn(P, n), "v": randn(3, P, n)}
    return state, geom


def increments(cfg: dict, state: dict, geom: dict, tf32: bool = False
               ) -> dict:
    """The step's float32 increments ``{"u": dt * (d + l), "v": dt * g}``;
    with *tf32*, the control's."""
    dt = cfg["dt"]
    u, v, D = state["u"], state["v"], geom["D"]
    grad = einsum("xre,rie->xie", geom["J"],
                  einsum("rij,je->rie", D, u, tf32), tf32)
    rows = [einsum("se,sie->ie", geom[jx],
                   einsum("sij,je->sie", D, v[x], tf32), tf32)
            for x, jx in enumerate(("Jx", "Jy", "Jz"))]
    flux = einsum("fji,ie->fje", geom["Rface"], u, tf32)
    lift = einsum("fij,fje->ie", geom["L"],
                  einsum("fe,fje->fje", geom["Fj"], flux, tf32), tf32)
    div = rows[0] + rows[1] + rows[2]
    return {"u": dt * (div + lift), "v": dt * grad}
