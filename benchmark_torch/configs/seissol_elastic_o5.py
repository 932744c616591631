"""Plain reference and input draw of ``seissol_elastic_o5.json``: the
increment of one step of SeisSol's elastic ADER-DG element, element-local,
in plain PyTorch on the model's dof-major tensors (Q (B, 9, E), S (3, 9, 9,
E), A (4, 9, 9, E); the reference matrices K_d (3, B_{d+1}, B_d), Kv (3, B,
B_1), R (4, F, B), L (4, B, F)), following the equations as written:

    dQ_0 = Q;  dQ_{d+1}[k,p,e] = sum_x,l,q K_d[x,k,l] dQ_d[l,q,e] S[x,q,p,e]
    I = sum_d dt^(d+1) / (d+1)! dQ_d                  (dQ_d zero beyond B_d)
    V[k,p,e] = sum_x,l,q Kv[x,k,l] I[l,q,e] S[x,q,p,e]          (l < B_1)
    F[k,p,e] = sum_f,m,n,q L[f,k,m] R[f,m,n] I[n,q,e] A[f,q,p,e]
    new Q = Q + V + F

Each product is a ``torch.einsum`` call of two operands, the derivatives
unscaled and the time integral's weights applied as written, so that a
sound step differs from these increments only by rounding.  This file
imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from plain import einsum

# the per-element draw's scale, and the factor on the derivative matrices
# that puts dt times the predictor's norm near 0.5, as in a CFL-limited step
ELEMENT_SCALE = 1 / 3
DERIVATIVE_GAIN = 500.0


def boxes(cfg: dict) -> tuple:
    """B_d, the modal functions of degree < order - d, d = 0 .. order - 1."""
    return tuple(n * (n + 1) * (n + 2) // 6
                 for n in range(cfg["order"], 0, -1))


def make_inputs(cfg: dict, n_elements: int, gen: torch.Generator,
                device) -> tuple:
    """``(state, geometry)`` drawn from *gen* on *device* (the draw that
    ``assumed.draw`` in the configuration states)."""
    B, F, nq, E = boxes(cfg), cfg["F"], cfg["nq"], n_elements

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    state = {"Q": randn(B[0], nq, E)}
    geom = {"S": randn(3, nq, nq, E) * ELEMENT_SCALE,
            "A": randn(4, nq, nq, E) * ELEMENT_SCALE}
    for d in range(cfg["order"] - 1):
        geom[f"K{d}"] = randn(3, B[d + 1], B[d]) * (
            DERIVATIVE_GAIN / math.sqrt(3 * B[d]))
    geom["Kv"] = randn(3, B[0], B[1]) / math.sqrt(3 * B[1])
    geom["R"] = randn(4, F, B[0]) / math.sqrt(B[0])
    geom["L"] = randn(4, B[0], F) / math.sqrt(4 * F)
    return state, geom


def increments(cfg: dict, state: dict, geom: dict, tf32: bool = False
               ) -> dict:
    """The step's float32 increment ``{"Q": V + F}``; with *tf32*, the
    control's."""
    dt = cfg["dt"]
    Q, S, A = state["Q"], geom["S"], geom["A"]
    dQ = [Q]
    for d in range(cfg["order"] - 1):
        t = einsum("xkl,lqe->xkqe", geom[f"K{d}"], dQ[d], tf32)
        dQ.append(einsum("xkqe,xqpe->kpe", t, S, tf32))
    I = torch.zeros_like(Q)
    for d, q in enumerate(dQ):
        I[:q.shape[0]] += dt ** (d + 1) / math.factorial(d + 1) * q
    Kv = geom["Kv"]
    V = einsum("xkqe,xqpe->kpe", einsum("xkl,lqe->xkqe", Kv,
                                        I[:Kv.shape[2]], tf32), S, tf32)
    LR = einsum("fkm,fmn->fkn", geom["L"], geom["R"], tf32)
    F = einsum("fkqe,fqpe->kpe", einsum("fkn,nqe->fkqe", LR, I, tf32), A,
               tf32)
    return {"Q": V + F}
