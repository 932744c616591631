"""Plain reference and input draw of ``seissol_viscoelastic_o5.json``: the
increment of one step of SeisSol's viscoelastic ADER-DG element (three
attenuation mechanisms), element-local, in plain PyTorch, written in the
27-quantity form of Kaeser, Dumbser, de la Puente & Igel (GJI 168, 2007)
and not in the split that SeisSol's viscoelastic2 equations (and the
program) run.

The inputs are the configuration's: Q (B, 9, E), Qane (B, 6, M, E); per
element the star matrices S (3, 9, 15, E) and flux solvers A (4, 9, 15,
E), which map the 9 quantities to 15 (the 9 and 6 strain rates), the
anelastic source Es (6, M, 9, E) and the relaxation frequencies w (M, E);
the reference matrices Kt (3, B_1, B), Kv (3, B, B_1), R (4, F, B) and L
(4, B, F).  Here they become, per element, the 27 quantities Q27 = [Q,
Qane] (column 9 + M j + m is Qane[:, j, m]), S27 (3, 9, 27) and A27 (4, 9,
27) (columns 0-8 S's and A's, column 9 + M j + m the strain rate j scaled
by w[m]) and E27 (27, 27) (rows 9 + M j + m: Es[j, m] in columns 0-8,
-w[m] on the diagonal, zero elsewhere), and the step is

    dQ_0 = Q27;  dQ_{d+1} = X_{d+1} + dQ_d E27,
        X_{d+1}[k, p] = sum_x,l,q Kt[x,k,l] dQ_d[l,q] S27[x,q,p]  (k < B_1;
                                                         zero beyond)
    I = sum_d dt^(d+1) / (d+1)! dQ_d                      (d = 0 .. 4)
    Y[k,p] = sum_x,l,q Kv[x,k,l] I[l,q] S27[x,q,p]  (l < B_1)
             + sum_f,m,n,q L[f,k,m] R[f,m,n] I[n,q] A27[f,q,p]  (q < 9)
    new Q27 = Q27 + Y + I E27

Each product is a ``torch.einsum`` call of two operands, the derivatives
unscaled and the time integral's weights applied as written, so that a
sound step differs from these increments only by rounding.  ``fault``
plants a fault of the mathematics for the calibration of the limit: the
derivatives cut to the elastic element's degree boxes (rows of dQ_d from
the d-th box on zero), Es zeroed, or the relaxation (E27's diagonal) left
out.  This file imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

from plain import einsum

# the per-element draw's scale, the factor on the derivative matrix that
# puts dt times the predictor's norm near 0.5, as in a CFL-limited step,
# and the scales of the anelastic state and of its source Es
ELEMENT_SCALE = 1 / 3
DERIVATIVE_GAIN = 500.0
ANELASTIC_SCALE = 1.0
SOURCE_SCALE = 1 / 3
# SeisSol's FreqCentral and FreqRatio (Hz, ratio): the relaxation
# frequencies, log-spaced from FreqCentral / sqrt(FreqRatio) to FreqCentral
# * sqrt(FreqRatio), times 2 pi
FREQ_CENTRAL = 0.5
FREQ_RATIO = 100.0
# the faults ``increments`` can plant
FAULTS = ("degree_boxes", "source_zeroed", "relaxation_left_out")


def boxes(cfg: dict) -> tuple:
    """B_d, the modal functions of degree < order - d, d = 0 .. order - 1."""
    return tuple(n * (n + 1) * (n + 2) // 6
                 for n in range(cfg["order"], 0, -1))


def frequencies(cfg: dict) -> list:
    """The relaxation frequencies w_m (rad/s) of the mechanisms."""
    M = cfg["mechanisms"]
    lo = math.log(FREQ_CENTRAL / math.sqrt(FREQ_RATIO))
    return [2 * math.pi * math.exp(lo + m / (M - 1) * math.log(FREQ_RATIO))
            for m in range(M)]


def make_inputs(cfg: dict, n_elements: int, gen: torch.Generator,
                device) -> tuple:
    """``(state, geometry)`` drawn from *gen* on *device* (the draw that
    ``assumed.draw`` in the configuration states)."""
    B, F, nq, E = boxes(cfg), cfg["F"], cfg["nq"], n_elements
    na, M = cfg["nane"], cfg["mechanisms"]
    nx = nq + na

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    state = {"Q": randn(B[0], nq, E),
             "Qane": randn(B[0], na, M, E) * ANELASTIC_SCALE}
    geom = {"S": randn(3, nq, nx, E) * ELEMENT_SCALE,
            "A": randn(4, nq, nx, E) * ELEMENT_SCALE,
            "Es": randn(na, M, nq, E) * (SOURCE_SCALE
                                         / math.sqrt(na * M)),
            "w": torch.tensor(frequencies(cfg), device=device)[:, None]
            .expand(M, E).contiguous(),
            "Kt": randn(3, B[1], B[0]) * (DERIVATIVE_GAIN
                                          / math.sqrt(3 * B[0])),
            "Kv": randn(3, B[0], B[1]) / math.sqrt(3 * B[1]),
            "R": randn(4, F, B[0]) / math.sqrt(B[0]),
            "L": randn(4, B[0], F) / math.sqrt(4 * F)}
    return state, geom


def _extended(cfg: dict, geom: dict, fault) -> tuple:
    """``(S27, A27, E27)`` of each element (module docstring)."""
    nq, na, M = cfg["nq"], cfg["nane"], cfg["mechanisms"]
    n27 = nq + na * M
    w, Es = geom["w"], geom["Es"]
    E = w.shape[-1]

    def widen(star):
        """(f, 9, 15, E) -> (f, 9, 27, E): the strain rate j times w[m] in
        column 9 + M j + m."""
        ane = star[:, :, nq:, None, :] * w[None, None, None]
        return torch.cat([star[:, :, :nq], ane.flatten(2, 3)], dim=2)

    E27 = torch.zeros(n27, n27, E, dtype=Es.dtype, device=Es.device)
    if fault != "source_zeroed":
        E27[nq:, :nq] = Es.reshape(na * M, nq, E)
    if fault != "relaxation_left_out":
        diag = torch.arange(nq, n27, device=Es.device)
        E27[diag, diag] = -w.repeat(na, 1)
    return widen(geom["S"]), widen(geom["A"]), E27


def increments(cfg: dict, state: dict, geom: dict, tf32: bool = False,
               fault=None) -> dict:
    """The step's float32 increments ``{"Q": ..., "Qane": ...}``; with
    *tf32*, the control's; with *fault* (one of ``FAULTS``), that fault's."""
    dt, B, nq = cfg["dt"], boxes(cfg), cfg["nq"]
    Q, Qane = state["Q"], state["Qane"]
    S27, A27, E27 = _extended(cfg, geom, fault)
    Kt = geom["Kt"]
    dQ = torch.cat([Q, Qane.flatten(1, 2)], dim=1)
    I = dt * dQ
    for d in range(cfg["order"] - 1):
        t = einsum("xkl,lqe->xkqe", Kt, dQ[:, :nq], tf32)
        nxt = einsum("kce,cpe->kpe", dQ, E27, tf32)
        nxt[:Kt.shape[1]] += einsum("xkqe,xqpe->kpe", t, S27, tf32)
        del t
        if fault == "degree_boxes":
            nxt[B[d + 1]:] = 0
        dQ = nxt
        I += dt ** (d + 2) / math.factorial(d + 2) * dQ
    del dQ
    Kv = geom["Kv"]
    Y = einsum("xkqe,xqpe->kpe", einsum("xkl,lqe->xkqe", Kv,
                                        I[:Kv.shape[2], :nq], tf32),
               S27, tf32)
    LR = einsum("fkm,fmn->fkn", geom["L"], geom["R"], tf32)
    Y += einsum("fkqe,fqpe->kpe", einsum("fkn,nqe->fkqe", LR, I[:, :nq],
                                         tf32), A27, tf32)
    Y += einsum("kce,cpe->kpe", I, E27, tf32)
    return {"Q": Y[:, :nq], "Qane": Y[:, nq:].unflatten(1, Qane.shape[1:3])}
