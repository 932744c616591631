"""
SeisSol's viscoelastic ADER-DG element (SeisSol's ``viscoelastic2``
equations; Uphoff & Bader, "Generating high performance matrix kernels for
earthquake simulations with viscoelastic attenuation", HPCS 2016): the
generalized Maxwell body of Kaeser, Dumbser, de la Puente & Igel (GJI 168,
2007) with M = 3 attenuation mechanisms, element-local, on tetrahedra at
convergence order 5 (the elastic element's basis, ``models/ader.py``).

State Q[k, p, e] (B_0, 9, E) and the anelastic state Qane[k, j, m, e]
(B_0, 6, M, E), six anelastic functions a mechanism; per element the star
matrices S[x, q, p, e] (3, 9, 15, E) and the flux solvers A[f, q, p, e]
(4, 9, 15, E), which map the 9 quantities to 15 (the 9 and the 6 strain
rates), the anelastic source Es[j, m, p, e] (6, M, 9, E) and the
relaxation frequencies w[m, e] (M, E); the reference matrices Kt[x, k, l]
(3, B_1, B_0, SeisSol's ``kDivMT`` on its nonzero rows), Kv[x, k, l] (3,
B_0, B_1), R[f, m, n] (4, F, B_0) and L[f, k, m] (4, B_0, F).  One step,
dQ_0 = Q and dQane_0 = Qane, for d = 0 .. 3:

    X_{d+1}[k,p] = sum_x,l,q Kt[x,k,l] dQ_d[l,q] S[x,q,p]      (k < B_1)
    dQ_{d+1}[k,p] = X_{d+1}[k,p] (k < B_1, p < 9)
                    + sum_j,m dQane_d[k,j,m] Es[j,m,p]          (all rows)
    dQane_{d+1}[k,j,m] = w[m] (X_{d+1}[k,9+j] - dQane_d[k,j,m])
                                                (X zero for k >= B_1)
    I = sum_d dt^(d+1)/(d+1)! dQ_d,  Iane likewise         (d = 0 .. 4)
    Y[k,p] = sum Kv[x,k,l] I[l,q] S[x,q,p] (l < B_1)
             + sum L[f,k,m] R[f,m,n] I[n,q] A[f,q,p]
    new Q = Q + Y[:, :9] + sum_j,m Iane[k,j,m] Es[j,m,p]
    new Qane = Qane + w[m] (Y[k,9+j] - Iane[k,j,m])

A source or relaxation term does not lower the degree, so every derivative
keeps all B_0 rows and reads the whole last one: the elastic element's
degree boxes do not apply.  The model runs the scaled derivatives D_d =
dt^d / (d+1)! dQ_d and Dane_d likewise, so that, with s_d = dt / (d+2),

    D_{d+1} = (s_d Kt) D_d S [:, :9] + Dane_d (s_d Es)
    Dane_{d+1} = w (s_d Kt D_d S)[:, 9:] + Dane_d (-s_d w)
    I = dt (D_0 + ... + D_4),  Iane = dt (Dane_0 + ... + Dane_4)

s_d rides in Kt, in Es and in w, each scaled once per tensor by
:class:`~feinsum_tpu_torch.models.common.HeldGeometry` (four copies of the
per-element Es and w, the step's geometry read as often as unscaled).  Each
product is an einsum of the IR, planned as the other models' are (the
archive's schedule, or the reference's default on the fused kernels,
pinned to dof-major storage), all on ``step_block_f32``: the derivatives
``xkl,lqe,xqpe->kpe`` (``derivative_0`` .. ``derivative_3``), the
anelastic sources ``kjme,jmpe->kpe`` (``source_0`` .. ``source_4``, the
last the corrector's on Iane), the relaxations ``kjme,me->kjme``, a
per-element product with -s_d w (``relax_0`` .. ``relax_3``), the volume
term on I's contiguous prefix and the flux (``volume``, ``flux``, 15
columns).  Each weighted sum is one ``ops.kernels.step_update`` pass: the
derivative's first B_1 rows added into the source's output in place (the
derivative's 9 of its 15 columns a view of two row strides), w times the
strain rates added into the relaxation's output in place (one group a
mechanism, each weighted by its w), the two time integrals, and the
update of Q and of Qane (again one group a mechanism).  Spans
``feinsum.ader:predictor`` and ``feinsum.ader:corrector`` as the elastic
element has them, and ``feinsum.ader:anelastic`` around each source and
relaxation executable, whose launches count in
``tracing.counters["anelastic_launches"]``.

Neighbour flux, dynamic rupture and local time stepping are left out: the
step is every element's local work.  Float32 only.
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
from .ader import B, F, NFACES, NQ, ORDER
from .common import HeldGeometry, StepStorage, archived_or_default, \
    to_device

# anelastic functions a mechanism (SeisSol's six strain components), the
# mechanisms, and the quantities the star matrices map to (the 9 and the
# strain rates); SeisSol's FreqCentral (Hz) and FreqRatio, which place the
# relaxation frequencies
NANE, NMECH = 6, 3
NX = NQ + NANE
FREQ_CENTRAL, FREQ_RATIO = 0.5, 100.0

# the executables a step calls of each kind of product but the corrector's
# volume and flux: one a derivative, and the corrector's source besides
_KINDS = {"derivative": ORDER - 1, "source": ORDER, "relax": ORDER - 1}


def relaxation_frequencies() -> list:
    """w_m (rad/s): 2 pi times frequencies log-spaced from FreqCentral /
    sqrt(FreqRatio) to FreqCentral * sqrt(FreqRatio)."""
    lo = np.log(FREQ_CENTRAL / np.sqrt(FREQ_RATIO))
    return [float(2 * np.pi * np.exp(lo + m / (NMECH - 1)
                                     * np.log(FREQ_RATIO)))
            for m in range(NMECH)]


def _kind(name: str) -> str:
    """The kind of product an executable's name (``source_4``) names."""
    return name.rpartition("_")[0] if name[-1].isdigit() else name


class AderViscoelasticOperator3D(torch.nn.Module):
    """SeisSol's viscoelastic ADER-DG element at convergence order 5 with
    three mechanisms; it holds its five programs, one a kind of product,
    under the names of the 15 executables a step calls (module
    docstring); ``make_step`` builds the step on dof-major tensors."""

    def __init__(self, *, use_pallas: bool = True,
                 block_long: int = BLOCK_LONG, db_path: Optional[str] = None,
                 device=None) -> None:
        super().__init__()
        d = "float32"
        S = array("S", (3, NQ, NX, "E"), d)
        dQane = array("dQane", (B[0], NANE, NMECH, "E"), d)
        kinds = {
            "derivative": einsum(
                "xkl,lqe,xqpe->kpe", array("Kt", (3, B[1], B[0]), d),
                array("dQ", (B[0], NQ, "E"), d), S),
            "source": einsum("kjme,jmpe->kpe", dQane,
                             array("Es", (NANE, NMECH, NQ, "E"), d)),
            "relax": einsum("kjme,me->kjme", dQane,
                            array("w", (NMECH, "E"), d)),
            "volume": einsum(
                "xkl,lqe,xqpe->kpe", array("Kv", (3, B[0], B[1]), d),
                array("I", (B[1], NQ, "E"), d), S),
            "flux": einsum(
                "fkm,fmn,nqe,fqpe->kpe", array("L", (NFACES, B[0], F), d),
                array("R", (NFACES, F, B[0]), d),
                array("I", (B[0], NQ, "E"), d),
                array("A", (NFACES, NQ, NX, "E"), d))}
        programs = {
            kind: archived_or_default(e, db_path=db_path, device=device,
                                      use_pallas=use_pallas,
                                      block_long=block_long)
            for kind, e in kinds.items()}
        names = [f"{kind}_{k}" for kind, n in _KINDS.items()
                 for k in range(n)] + ["volume", "flux"]
        self.einsums = {name: kinds[_kind(name)] for name in names}
        self.programs = {name: programs[_kind(name)] for name in names}

    def executables(self, n_elements: int) -> dict:
        """Each executable at *n_elements*, named by its einsum (the
        executables of one kind share a build)."""
        return {name: build_executable(p, long_dim_length=n_elements,
                                       name=name)
                for name, p in self.programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing Q and Qane one ADER
        step, on contiguous dof-major tensors: Q (B_0, 9, E), Qane (B_0, 6,
        3, E), geometry S (3, 9, 15, E), A (4, 9, 15, E), Es (6, 3, 9, E),
        w (3, E) and the reference matrices Kt, Kv, R and L, as
        :func:`make_ader_visco_state` lays them out."""
        fns = self.executables(n_elements)
        name = f"feinsum.step:{type(self).__name__}"
        update = StepStorage(self.programs.values(), ()).update
        E = n_elements
        # each scaled operand: the geometry tensor it comes from, the
        # program that reads it and the factor folded into it, held in
        # that program's stored layout
        scales = [dt / (d + 2) for d in range(ORDER - 1)]
        factors = {**{f"Kt{d}": ("Kt", "derivative_0", s)
                      for d, s in enumerate(scales)},
                   **{f"Es{d}": ("Es", "source_0", s)
                      for d, s in enumerate(scales)},
                   **{f"w{d}": ("w", "relax_0", -s)
                      for d, s in enumerate(scales)},
                   "Es": ("Es", "source_0", 1.0), "Kv": ("Kv", "volume", 1.0),
                   "L": ("L", "flux", 1.0), "R": ("R", "flux", 1.0)}
        held = {key: HeldGeometry(
            (g,), lambda t, g=g, p=self.programs[p], s=s:
            apply_layouts(p, {g: t * s if s != 1.0 else t})[g])
            for key, (g, p, s) in factors.items()}

        def anelastic(fn, arrays):
            """An anelastic product, in its span, its launches counted."""
            launched = sum(launch_counts.values())
            with tracing.span("feinsum.ader:anelastic"):
                (out,) = fn(arrays)
            tracing.counters["anelastic_launches"] += \
                sum(launch_counts.values()) - launched
            return out

        def by_mechanism(t):
            """A (k, j, M, E) tensor's view with the mechanism leading:
            one group of a step_update each."""
            return t.permute(2, 0, 1, 3)

        def predictor(Q, Qane, S, K, w):
            """``(I / dt, Iane / dt)``, new tensors; the derivatives are
            freed on return."""
            D, Dane = [Q], [Qane]
            for d in range(ORDER - 1):
                (X,) = fns[f"derivative_{d}"](
                    {"Kt": K[f"Kt{d}"], "dQ": D[d], "S": S})
                P = anelastic(fns[f"source_{d}"],
                              {"dQane": Dane[d], "Es": K[f"Es{d}"]})
                H = anelastic(fns[f"relax_{d}"],
                              {"dQane": Dane[d], "w": K[f"w{d}"]})
                # D_{d+1}: the derivative's first B_1 rows added into the
                # source's output
                rows = P[:B[1]].unsqueeze(0)
                update(X[:, :NQ].unsqueeze(0), [[P[:B[1]]]], 1.0, out=rows)
                # Dane_{d+1}: w times the strain rates added into the
                # relaxation's output, one group a mechanism
                rows = by_mechanism(H[:B[1]])
                update(rows, [[X[:, NQ:]] * NMECH], 1.0, out=rows, weights=w)
                del X
                D.append(P)
                Dane.append(H)
            I = update(Q.view(-1, E), [t.view(-1, E) for t in D[1:]], 1.0)
            Iane = update(Qane.view(-1, E), [t.view(-1, E) for t in Dane[1:]],
                          1.0)
            return I.view(Q.shape), Iane.view(Qane.shape)

        def step(state, geom):
            with tracing.span(name):
                tracing.counters["model_steps"] += 1
                Q, Qane, S, w = state["Q"], state["Qane"], geom["S"], \
                    geom["w"]
                K = {key: h(geom)[factors[key][0]] for key, h in held.items()}
                launched = sum(launch_counts.values())
                with tracing.span("feinsum.ader:predictor"):
                    I, Iane = predictor(Q, Qane, S, K, w)
                tracing.counters["ader_predictor_launches"] += \
                    sum(launch_counts.values()) - launched
                with tracing.span("feinsum.ader:corrector"):
                    (V,) = fns["volume"]({"Kv": K["Kv"], "I": I[:B[1]],
                                          "S": S})
                    (Fx,) = fns["flux"]({"L": K["L"], "R": K["R"], "I": I,
                                         "A": geom["A"]})
                    P = anelastic(fns[f"source_{ORDER - 1}"],
                                  {"dQane": Iane, "Es": K["Es"]})
                    del I
                    new = update(Q.unsqueeze(0), [[V[:, :NQ]], [Fx[:, :NQ]],
                                                  [P]], dt)[0]
                    del P
                    new_ane = torch.empty_like(Qane)
                    ane = by_mechanism(Iane)
                    update(by_mechanism(Qane),
                           [[V[:, NQ:]] * NMECH, [Fx[:, NQ:]] * NMECH,
                            list(ane)], dt, signs=(1, 1, -1),
                           out=by_mechanism(new_ane), weights=w)
                return {"Q": new, "Qane": new_ane}

        return step

    def forward(self, state: dict, geom: dict, dt: float = 1e-3) -> dict:
        """One step at the state's number of elements."""
        return self.make_step(int(state["Q"].shape[-1]), dt)(state, geom)


def make_ader_visco_state(n_elements: int, *, seed: int = 0,
                          device=None) -> tuple:
    """(state, geometry) dicts in the model's dof-major layouts: Q (B_0, 9,
    E), Qane (B_0, 6, 3, E), S (3, 9, 15, E), A (4, 9, 15, E), Es (6, 3, 9,
    E), Kt (3, B_1, B_0), Kv (3, B_0, B_1), R (4, F, B_0) and L (4, B_0,
    F), float32, Gaussian from numpy's ``default_rng(seed)`` in that order,
    scaled as the benchmark's draw is (Q and Qane standard; S and A over 3;
    Es over 3 sqrt(18); Kt times 500 over sqrt(3 B_0), Kv over sqrt(3
    B_1), R over sqrt(B_0), L over sqrt(4 F)), and w (3, E), every element
    the :func:`relaxation_frequencies`, on *device* (default: the current
    CUDA card; it raises without one unless ``device="cpu"``)."""
    device = default_device(device, caller="make_ader_visco_state")
    rng = np.random.default_rng(seed)

    def arr(scale, *shape):
        return rng.standard_normal(shape) * scale

    E = n_elements
    state = {"Q": arr(1.0, B[0], NQ, E), "Qane": arr(1.0, B[0], NANE, NMECH,
                                                      E)}
    geom = {"S": arr(1 / 3, 3, NQ, NX, E), "A": arr(1 / 3, NFACES, NQ, NX, E),
            "Es": arr(1 / (3 * np.sqrt(NANE * NMECH)), NANE, NMECH, NQ, E),
            "Kt": arr(500 / np.sqrt(3 * B[0]), 3, B[1], B[0]),
            "Kv": arr(1 / np.sqrt(3 * B[1]), 3, B[0], B[1]),
            "R": arr(1 / np.sqrt(B[0]), NFACES, F, B[0]),
            "L": arr(1 / np.sqrt(NFACES * F), NFACES, B[0], F),
            "w": np.repeat(np.array(relaxation_frequencies())[:, None], E,
                           axis=1)}
    return (to_device(state, "float32", device),
            to_device(geom, "float32", device))
