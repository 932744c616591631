"""
The spectral-element wave operator on curved hexahedra: SPECFEM3D's
acoustic element at NGLL = n Gauss-Lobatto-Legendre nodes a direction
(n = 5: degree 4, 125 nodes an element), with sum-factorized derivatives.

First-order acoustic system on E elements, state u (n, n, n, E) and v (3,
n, n, n, E), geometry G[x, r, i, j, k, e] (3, 3, n, n, n, E: the metric
terms d xi_r / d x_x at each node, the node's Jacobian, inverse density and
GLL weights folded in) and the 1-D derivative matrix D (n, n):

    d_1 u[i,j,k,e] = sum_a D[i,a] u[a,j,k,e]     (d_2 along j, d_3 along k)
    grad:  g[x,ijk,e] = sum_r G[x,r,ijk,e] d_r u[ijk,e]
    div:   w[r,ijk,e] = sum_x G[x,r,ijk,e] v[x,ijk,e];
           d[ijk,e]   = sum_r d_r w_r[ijk,e]
    new u = u + dt * d,   new v = v + dt * g

The step is six einsums, each planned as the wave model's are (the
archive's schedule, or the reference's default on the fused kernels, pinned
to dof-major storage) and run on ``step_block_f32``:

* ``grad_axes``, ``ria,rjb,rkc,abce->rijke``: the three derivatives of u
  in one launch, stacked along r, the factors A = (D, I, I), B = (I, D, I),
  C = (I, I, D) made from D once (:func:`axis_factors`, held by
  :class:`~feinsum_tpu_torch.models.common.HeldGeometry`).  The identity
  factors triple the derivatives' arithmetic; what they buy is the stacked
  result, which the metric product reads as one operand;
* ``grad_metric``, ``xrn,rn->xn``, and ``div_metric``, ``xrn,xn->rn``: the
  metric products over the nodes, n the node axis (i, j, k, e) merged, the
  state, G and the results read through views of their (.., n, n, n, E)
  storage.  Each node is an element of the kernel's grid there (one
  register tile of 3 entries), which the kernel runs at several times the
  rate of the same product over (i, j, k) per element;
* ``div_1``, ``div_2``, ``div_3``, ``ia,ajke->ijke`` and its two
  permutations: the one-axis derivative of each w_r, at the least
  arithmetic.

The two updates are one pass each of ``ops.kernels.step_update`` on (n^3,
E) and (3, n^3, E) views of the state: u with the three ``div_r`` terms
summed in order, v with the grad.  No kron-expanded (n^3 x n^3) operator is
built.  Float32 only, so the model takes no precision: ``dd_rows``, the
pair route, takes DG rows alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..cl_utils import default_device
from ..codegen.program import build_executable
from ..make_einsum import array, einsum
from ..suite import BLOCK_LONG
from .common import (HeldGeometry, StepStorage, archived_or_default,
                     to_device)

# each one-axis derivative: its subscripts and the w_r it reads
_DIV_AXES = (("div_1", "ia,ajke->ijke", "w1"),
             ("div_2", "jb,ibke->ijke", "w2"),
             ("div_3", "kc,ijce->ijke", "w3"))
# the programs over the node axis, built at n^3 E
_NODE_PROGRAMS = ("grad_metric", "div_metric")


def axis_factors(D: torch.Tensor) -> tuple:
    """The grad's factors A, B, C (3, n, n) each: the r-th of them D on
    the r-th axis and the identity on the others."""
    eye = torch.eye(D.shape[0], dtype=D.dtype, device=D.device)
    return tuple(torch.stack([D if r == axis else eye for r in range(3)])
                 for axis in range(3))


class HexWaveOperator3D(torch.nn.Module):
    """Spectral-element wave operator on curved hexahedra with ``n`` GLL
    nodes a direction; it holds its six programs (module docstring);
    ``make_step`` builds the step on dof-major tensors."""

    def __init__(self, *, n: int = 5, use_pallas: bool = True,
                 block_long: int = BLOCK_LONG, db_path: Optional[str] = None,
                 device=None) -> None:
        super().__init__()
        self.n = n
        d = "float32"
        state = (n, n, n, "E")
        self.einsums = {
            "grad_axes": einsum(
                "ria,rjb,rkc,abce->rijke",
                *(array(f, (3, n, n), d) for f in "ABC"),
                array("u", state, d)),
            "grad_metric": einsum(
                "xrn,rn->xn", array("G", (3, 3, "N"), d),
                array("du", (3, "N"), d)),
            "div_metric": einsum(
                "xrn,xn->rn", array("G", (3, 3, "N"), d),
                array("v", (3, "N"), d)),
            **{name: einsum(subs, array("D", (n, n), d),
                            array(w, state, d))
               for name, subs, w in _DIV_AXES}}
        self.programs = {
            name: archived_or_default(e, db_path=db_path, device=device,
                                      use_pallas=use_pallas,
                                      block_long=block_long)
            for name, e in self.einsums.items()}

    def executables(self, n_elements: int) -> dict:
        """Each program's executable: the node programs at n^3 E."""
        nodes = self.n ** 3 * n_elements
        return {name: build_executable(
                    p, long_dim_length=nodes if name in _NODE_PROGRAMS
                    else n_elements, name=name)
                for name, p in self.programs.items()}

    def make_step(self, n_elements: int, dt: float = 1e-3):
        """``step(state, geom) -> state`` advancing (u, v) one
        explicit-Euler step, on contiguous dof-major tensors: u (n, n, n,
        E), v (3, n, n, n, E), geometry G (3, 3, n, n, n, E) and D (n, n),
        as :func:`make_hexwave_state` lays them out.  The node programs
        read views of the state and of G; each state tensor is written by
        one pass of :func:`~feinsum_tpu_torch.ops.kernels.step_update` on a
        view of it."""
        fns = self.executables(n_elements)
        name = f"feinsum.step:{type(self).__name__}"
        storage = StepStorage(self.programs.values(), ())
        factors = HeldGeometry(("D",), axis_factors)
        E, P = n_elements, self.n ** 3

        def step(state, geom):
            with tracing.span(name):
                tracing.counters["model_steps"] += 1
                u, v, D = state["u"], state["v"], geom["D"]
                G = geom["G"].view(3, 3, P * E)
                A, B, C = factors(geom)["D"]
                (du,) = fns["grad_axes"]({"A": A, "B": B, "C": C, "u": u})
                (g,) = fns["grad_metric"]({"G": G,
                                           "du": du.view(3, P * E)})
                (w,) = fns["div_metric"]({"G": G, "v": v.view(3, P * E)})
                ws = w.view(3, *u.shape)
                div = [fns[axis]({"D": D, wr: ws[r]})[0].view(P, E)
                       for r, (axis, _, wr) in enumerate(_DIV_AXES)]
                # u + dt * ((d_1 w_1 + d_2 w_2) + d_3 w_3); v + dt * g
                return {"u": storage.update(u.view(P, E), div,
                                            dt).view(u.shape),
                        "v": storage.update(v.view(3, P, E),
                                            [g.view(3, P, E).unbind(0)],
                                            dt).view(v.shape)}

        return step

    def forward(self, state: dict, geom: dict, dt: float = 1e-3) -> dict:
        """One step at the state's number of elements."""
        return self.make_step(int(state["u"].shape[-1]), dt)(state, geom)


def make_hexwave_state(n_elements: int, *, n: int = 5,
                       dtype: str = "float32", seed: int = 0,
                       device=None) -> tuple:
    """(state, geometry) dicts of random data in the model's dof-major
    layouts: u (n, n, n, E), v (3, n, n, n, E), G (3, 3, n, n, n, E), D
    (n, n), uniform in [0, 1) from numpy's ``default_rng(seed)`` in that
    order, on *device* (default: the current CUDA card; it raises without
    one unless ``device="cpu"``)."""
    device = default_device(device, caller="make_hexwave_state")
    rng = np.random.default_rng(seed)

    def arr(*shape):
        return rng.random(shape)

    state = {"u": arr(n, n, n, n_elements),
             "v": arr(3, n, n, n, n_elements)}
    geom = {"G": arr(3, 3, n, n, n, n_elements), "D": arr(n, n)}
    return (to_device(state, dtype, device), to_device(geom, dtype, device))
