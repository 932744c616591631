"""Plain reference and input draw of ``hexwave3d_q4.json``: the spectral-
element wave step's increments in plain PyTorch, on the model's dof-major
tensors (u (n, n, n, E), v (3, n, n, n, E), G (3, 3, n, n, n, E)).

    d_1 u[i,j,k,e] = sum_a D[i,a] u[a,j,k,e]    (d_2 along j, d_3 along k)
    grad:  g[x,ijk,e] = sum_r G[x,r,ijk,e] d_r u[ijk,e]
    div:   w[r,ijk,e] = sum_x G[x,r,ijk,e] v[x,ijk,e]
           d[ijk,e]   = sum_r d_r w_r[ijk,e]
    new u = u + dt * d,  new v = v + dt * g

Each einsum runs as a ``torch.einsum`` call of two operands (the one-axis
derivatives at their least arithmetic, no kron-expanded operator), the
three terms of d summed in the order the model sums them, so that a sound
step differs from them only by the einsums' own rounding.  This file
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from plain import einsum

# each axis's one-axis derivative, d_1 to d_3
AXES = ("ia,ajke->ijke", "jb,ibke->ijke", "kc,ijce->ijke")


def make_inputs(cfg: dict, n_elements: int, gen: torch.Generator,
                device) -> tuple:
    """``(state, geometry)`` drawn from *gen* on *device* (the draw that
    ``assumed.draw`` in the configuration states)."""
    n = cfg["n"]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    g = randn(n, n)
    D = (g - g.T) / math.sqrt(2 * n)
    G = randn(3, 3, n, n, n, n_elements) / math.sqrt(3)
    state = {"u": randn(n, n, n, n_elements),
             "v": randn(3, n, n, n, n_elements)}
    return state, {"G": G, "D": D}


def increments(cfg: dict, state: dict, geom: dict, tf32: bool = False
               ) -> dict:
    """The step's float32 increments ``{"u": dt * d, "v": dt * g}``; with
    *tf32*, the control's."""
    dt = cfg["dt"]
    u, v, G, D = state["u"], state["v"], geom["G"], geom["D"]
    du = torch.stack([einsum(subs, D, u, tf32) for subs in AXES])
    grad = einsum("xrijke,rijke->xijke", G, du, tf32)
    w = einsum("xrijke,xijke->rijke", G, v, tf32)
    d = [einsum(subs, D, w[r], tf32) for r, subs in enumerate(AXES)]
    return {"u": dt * ((d[0] + d[1]) + d[2]), "v": dt * grad}
