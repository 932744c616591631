"""
SeisSol's elastic ADER-DG element (Uphoff & Bader, "Yet Another Tensor
Toolbox for Discontinuous Galerkin Methods and Other Applications", ACM
TOMS 46(4), 2020): the Cauchy-Kowalevski predictor and the element-local
corrector of the elastic equations on tetrahedra at convergence order N =
5 (modal basis of degree < N, ordered by degree: B_d functions of degree <
N - d, B = (35, 20, 10, 4, 1)), 9 quantities (6 stress, 3 velocity), 4
faces of F = 15 face functions.

State Q[k, p, e] (B_0, 9, E); per element the three star matrices S[x, q,
p, e] (3, 9, 9, E) and the four flux solvers A[f, q, p, e] (4, 9, 9, E);
the reference matrices K_d[x, k, l] (3, B_{d+1}, B_d, SeisSol's ``kDivMT``
cut to its degree box), Kv[x, k, l] (3, B_0, B_1, ``kDivM``), R[f, m, n]
(4, F, B_0, ``fMrT``) and L[f, k, m] (4, B_0, F, ``rDivM``).  One step:

    dQ_0 = Q;  dQ_{d+1}[k,p,e] = sum_x,l,q K_d[x,k,l] dQ_d[l,q,e] S[x,q,p,e]
    I = sum_d dt^(d+1) / (d+1)! dQ_d                  (dQ_d zero beyond B_d)
    V[k,p,e] = sum_x,l,q Kv[x,k,l] I[l,q,e] S[x,q,p,e]          (l < B_1)
    F[k,p,e] = sum_f,m,n,q L[f,k,m] R[f,m,n] I[n,q,e] A[f,q,p,e]
    new Q = Q + V + F

The model runs the scaled derivatives D_d = dt^d / (d+1)! dQ_d, so that
D_{d+1} = (dt / (d+2)) K_d D_d S and I = dt (D_0 + ... + D_{N-1}): the
factors dt / (d+2) ride in the K_d, and dt in Kv and L, each scaled once
per tensor by :class:`~feinsum_tpu_torch.models.common.HeldGeometry`,
which holds each reference matrix in its program's stored layout.
The step is six einsums of the IR, each planned as the other models' are
(the archive's schedule, or the reference's default on the fused kernels,
pinned to dof-major storage), all on ``step_block_f32``: the N - 1
derivatives, ``xkl,lqe,xqpe->kpe`` of shrinking shape, each reading the
last one's output whole; the volume term, the same subscripts on I's
contiguous prefix I[:B_1]; and the flux, ``fkm,fmn,nqe,fqpe->kpe``.  The
time integral I / dt is one ``ops.kernels.step_update`` pass per band of
degree, rows B_{d+1} to B_d holding Q + D_1 + ... + D_d, written into one
(B_0, 9, E) tensor; the update ``Q + V + F`` one pass more.

Neighbour flux, dynamic rupture, attenuation and local time stepping are
left out: the step is every element's local work.  Float32 only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..cl_utils import default_device
from ..codegen.program import build_executable
from ..make_einsum import array, einsum
from ..measure import apply_layouts
from ..ops.kernels import launch_counts
from ..suite import BLOCK_LONG
from .common import HeldGeometry, StepStorage, archived_or_default, \
    to_device

# quantities (6 stress, 3 velocity), faces, the convergence order; the
# degree boxes B_d, the modal functions of degree < ORDER - d on the
# tetrahedron, and the face basis's size
NQ, NFACES, ORDER = 9, 4, 5
B = tuple((n * (n + 1) * (n + 2)) // 6 for n in range(ORDER, 0, -1))
F = ORDER * (ORDER + 1) // 2


def _rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Basis rows lo:hi of a (b, 9, E) tensor as a ((hi - lo) 9, E) view."""
    return t[lo:hi].view(-1, t.shape[-1])


class AderElasticOperator3D(torch.nn.Module):
    """SeisSol's elastic ADER-DG element at convergence order 5; it holds
    its six programs (module docstring); ``make_step`` builds the step on
    dof-major tensors."""

    def __init__(self, *, use_pallas: bool = True,
                 block_long: int = BLOCK_LONG, db_path: Optional[str] = None,
                 device=None) -> None:
        super().__init__()
        d = "float32"
        S = array("S", (3, NQ, NQ, "E"), d)
        self.einsums = {
            **{f"derivative_{k}": einsum(
                "xkl,lqe,xqpe->kpe", array(f"K{k}", (3, B[k + 1], B[k]), d),
                array(f"dQ{k}", (B[k], NQ, "E"), d), S)
               for k in range(ORDER - 1)},
            "volume": einsum(
                "xkl,lqe,xqpe->kpe", array("Kv", (3, B[0], B[1]), d),
                array("I", (B[1], NQ, "E"), d), S),
            "flux": einsum(
                "fkm,fmn,nqe,fqpe->kpe", array("L", (NFACES, B[0], F), d),
                array("R", (NFACES, F, B[0]), d),
                array("I", (B[0], NQ, "E"), d),
                array("A", (NFACES, NQ, NQ, "E"), d))}
        self.programs = {
            name: archived_or_default(e, db_path=db_path, device=device,
                                      use_pallas=use_pallas,
                                      block_long=block_long)
            for name, e in self.einsums.items()}

    def executables(self, n_elements: int) -> dict:
        """Each program's executable at *n_elements*."""
        return {name: build_executable(p, long_dim_length=n_elements,
                                       name=name)
                for name, p in self.programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing Q one ADER step, on
        contiguous dof-major tensors: Q (B_0, 9, E), geometry S (3, 9, 9,
        E), A (4, 9, 9, E) and the reference matrices K0 .. K3, Kv, R
        and L, as :func:`make_ader_state` lays them out."""
        fns = self.executables(n_elements)
        name = f"feinsum.step:{type(self).__name__}"
        update = StepStorage(self.programs.values(), ()).update
        # each reference matrix: the program that reads it and the factor
        # folded into it, held in that program's stored layout
        factors = {**{f"K{k}": (f"derivative_{k}", dt / (k + 2))
                      for k in range(ORDER - 1)},
                   "Kv": ("volume", dt), "L": ("flux", dt), "R": ("flux", 1.0)}
        held = {m: HeldGeometry((m,), lambda t, m=m, p=self.programs[p], s=s:
                                apply_layouts(p, {m: t * s})[m])
                for m, (p, s) in factors.items()}
        # band d: the rows of degree ORDER - 1 - d, B_{d+1} to B_d (B_5 = 0)
        bands = list(zip(B[1:] + (0,), B))

        def predictor(Q, S, K):
            """I / dt, a new (B_0, 9, E) tensor: band d holds Q + D_1 +
            ... + D_d; the derivatives are freed on return."""
            D = [Q]
            for k in range(ORDER - 1):
                (dk,) = fns[f"derivative_{k}"](
                    {f"K{k}": K[f"K{k}"], f"dQ{k}": D[k], "S": S})
                D.append(dk)
            I = torch.empty_like(Q)
            for d, (lo, hi) in enumerate(bands):
                q = _rows(Q, lo, hi)
                terms = [_rows(t, lo, hi) for t in D[1:d + 1]]
                # the band of Q alone is Q + 0 * Q, a copy: a pass takes
                # one term or more
                update(q, terms or [q], 1.0 if terms else 0.0,
                       out=_rows(I, lo, hi))
            return I

        def step(state, geom):
            with tracing.span(name):
                tracing.counters["model_steps"] += 1
                Q, S = state["Q"], geom["S"]
                K = {m: h(geom)[m] for m, h in held.items()}
                launched = sum(launch_counts.values())
                with tracing.span("feinsum.ader:predictor"):
                    I = predictor(Q, S, K)
                tracing.counters["ader_predictor_launches"] += \
                    sum(launch_counts.values()) - launched
                with tracing.span("feinsum.ader:corrector"):
                    (V,) = fns["volume"]({"Kv": K["Kv"], "I": I[:B[1]],
                                          "S": S})
                    (F,) = fns["flux"]({"L": K["L"], "R": K["R"], "I": I,
                                        "A": geom["A"]})
                    del I
                    E = n_elements
                    new = update(Q.view(-1, E), [V.view(-1, E),
                                                 F.view(-1, E)], 1.0)
                return {"Q": new.view(Q.shape)}

        return step

    def forward(self, state: dict, geom: dict, dt: float = 1e-3) -> dict:
        """One step at the state's number of elements."""
        return self.make_step(int(state["Q"].shape[-1]), dt)(state, geom)


def make_ader_state(n_elements: int, *, seed: int = 0,
                    device=None) -> tuple:
    """(state, geometry) dicts of random data in the model's dof-major
    layouts: Q (B_0, 9, E), S (3, 9, 9, E), A (4, 9, 9, E), K0 .. K3
    (3, B_{d+1}, B_d), Kv (3, B_0, B_1), R (4, F, B_0) and L (4, B_0, F),
    float32, Gaussian from numpy's ``default_rng(seed)`` in that order,
    scaled as the benchmark's draw is (Q standard; S and A over 3; K_d
    times 500 over sqrt(3 B_d); Kv over sqrt(3 B_1), R over sqrt(B_0), L
    over sqrt(4 F)), on *device* (default: the current CUDA card; it
    raises without one unless ``device="cpu"``)."""
    device = default_device(device, caller="make_ader_state")
    rng = np.random.default_rng(seed)

    def arr(scale, *shape):
        return rng.standard_normal(shape) * scale

    state = {"Q": arr(1.0, B[0], NQ, n_elements)}
    geom = {"S": arr(1 / 3, 3, NQ, NQ, n_elements),
            "A": arr(1 / 3, NFACES, NQ, NQ, n_elements),
            **{f"K{k}": arr(500 / np.sqrt(3 * B[k]), 3, B[k + 1], B[k])
               for k in range(ORDER - 1)},
            "Kv": arr(1 / np.sqrt(3 * B[1]), 3, B[0], B[1]),
            "R": arr(1 / np.sqrt(B[0]), NFACES, F, B[0]),
            "L": arr(1 / np.sqrt(NFACES * F), NFACES, B[0], F)}
    return (to_device(state, "float32", device),
            to_device(geom, "float32", device))
