"""Plain reference and input draw of ``wave3d_p4_f64.json``: the wave
step's increments in plain float64 PyTorch, on the model's dof-major
tensors.

    grad:      g[x,i,e] = sum_{r,j} J[x,r,e] D[r,i,j] u[j,e]
    div:       d[i,e]   = sum_x sum_{s,j} Jx[s,e] D[s,i,j] v[x,j,e]
    restrict:  flux[f,j,e] = sum_i R[f,j,i] u[i,e]
    lift:      l[i,e]   = sum_{f,j} L[f,i,j] Fj[f,e] flux[f,j,e]
    new u = u + dt * (d + l),  new v = v + dt * g

Each einsum runs as ``torch.einsum`` calls of two operands in float64,
summed in the order the model sums them (its three div rows first, then
the lift).  ``tf32=True``, the keyword the harness gives the control,
computes every product in float32 instead, the nearest precision below
the configuration's: the check has to tell it from the program.  This file
is its own copy, importing nothing of the program.
"""

from __future__ import annotations

import math

import torch


def einsum(subscripts: str, a: torch.Tensor, b: torch.Tensor,
           f32: bool) -> torch.Tensor:
    """``torch.einsum`` of two float64 operands; where *f32*, computed in
    float32 (operands rounded, products and sums in float32) and returned
    as float64."""
    if f32:
        return torch.einsum(subscripts, a.float(), b.float()).double()
    return torch.einsum(subscripts, a, b)


def make_inputs(cfg: dict, n: int, gen: torch.Generator, device) -> tuple:
    """``(state, geometry)`` in float64, drawn from *gen* on *device* (the
    draw that ``assumed.draw`` in the configuration states)."""
    P, Pf, F = cfg["ndof"], cfg["nfacedof"], cfg["nfaces"]
    f64 = torch.float64

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=f64)

    g = randn(3, P, P)
    D = (g - g.transpose(1, 2)) / math.sqrt(2 * P)
    J = randn(3, 3, n) / math.sqrt(3)
    R = randn(F, Pf, P) / math.sqrt(P)
    L = randn(F, P, Pf) / math.sqrt(F * Pf)
    Fj = 0.5 + torch.rand((F, n), generator=gen, device=device, dtype=f64)
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
    """The step's float64 increments ``{"u": dt * (d + l), "v": dt *
    g}``; with *tf32*, the control's, every product in float32."""
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
